"""Flat-list quantization and normative dequantization (spec 8.6.3), plain
PyTorch versions (part of kernel K2's chain), plus the chroma QP table and
the per-CTU QP maps.

The JAX package asks for int64 here but runs with x64 off, so its dequant
wraps in int32 where |level| * scale >= 2^31 (QP 51: 32767 * (57*16 << 8)).
That input is unreachable from `quant` at the same QP; the port computes the
wide, normative result.
"""

from __future__ import annotations

import numpy as np
import torch

QUANT_SCALES = np.array([26214, 23302, 20560, 18396, 16384, 14564],
                        dtype=np.int64)
INV_QUANT_SCALES = np.array([40, 45, 51, 57, 64, 72], dtype=np.int64)

# chroma QP mapping for 4:2:0 (spec Table 8-10)
CHROMA_QP_TAB = np.array([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36,
                          37, 37], dtype=np.int32)


def chroma_qp_np(qp_y) -> np.ndarray:
    """Chroma QP (spec Table 8-10) of a luma QP map."""
    q = np.clip(np.asarray(qp_y, np.int32), 0, 57)
    out = np.where(q < 30, q,
                   np.where(q > 43, q - 6,
                            CHROMA_QP_TAB[np.clip(q - 30, 0, 13)]))
    return out.astype(np.int32)


_TABS: dict = {}


def chroma_qp_t(qp_y):
    """Tensor twin of chroma_qp_np (per-edge chroma QP in deblocking)."""
    q = torch.clamp(qp_y.to(torch.int32), 0, 57)
    if q.device not in _TABS:        # one upload per device, not per call
        _TABS[q.device] = torch.as_tensor(CHROMA_QP_TAB, device=q.device)
    tab = _TABS[q.device]
    return torch.where(q < 30, q, torch.where(
        q > 43, q - 6, tab[torch.clamp(q - 30, 0, 13).long()])) \
        .to(torch.int32)


def quant(coeff, qp, bit_depth: int = 8, intra: bool = True):
    """coeff [..., N, N] int, qp int tensor broadcastable to coeff ->
    levels int32 (offset (171 or 85) << (qbits - 9), clip to 16 bits)."""
    n = coeff.shape[-1]
    log2n = n.bit_length() - 1
    qp = qp.to(torch.int64)
    qbits = 14 + qp // 6 + 15 - bit_depth - log2n
    scale = torch.as_tensor(QUANT_SCALES, device=coeff.device)[qp % 6]
    offset = torch.bitwise_left_shift(
        torch.full_like(qbits, 171 if intra else 85), qbits - 9)
    c = coeff.to(torch.int64)
    level = torch.sign(c) * ((c.abs() * scale + offset) >> qbits)
    return torch.clamp(level, -32768, 32767).to(torch.int32)


def dequant(level, qp, bit_depth: int = 8):
    """Normative scaling (spec 8.6.3, m = 16), computed wide."""
    n = level.shape[-1]
    log2n = n.bit_length() - 1
    qp = qp.to(torch.int64)
    bd_shift = bit_depth + log2n - 5
    scale = (torch.as_tensor(INV_QUANT_SCALES, device=level.device)[qp % 6]
             * 16) << (qp // 6)
    d = (level.to(torch.int64) * scale + (1 << (bd_shift - 1))) >> bd_shift
    return torch.clamp(d, -32768, 32767).to(torch.int32)


def derive_qp_maps(qp: int, offsets, hc: int, wc: int):
    """Per-CTU maps (qp, qp_cb, qp_cr, lambda), each [hc, wc] numpy, for a
    frame QP and an AQ/CU-tree offset map (None: uniform), as the JAX
    `derive_qp_maps` (:149) builds them: qp + rint(offsets) clipped to
    0..51 (rint rounds half to even); lambda is the x265 SSE lambda2 in
    f32."""
    from ..utils.lambdas import lambda2_of
    if offsets is None:
        qp_map = np.full((hc, wc), int(qp), np.int32)
    else:
        qp_map = np.clip(int(qp) + np.rint(np.asarray(offsets)),
                         0, 51).astype(np.int32)
        if qp_map.shape != (hc, wc):
            raise ValueError(f"QP offsets of shape {qp_map.shape}, expected "
                             f"{(hc, wc)}")
    lam = lambda2_of(qp_map).astype(np.float32)
    return qp_map, chroma_qp_np(qp_map), chroma_qp_np(qp_map), lam
