"""Kernel K2 `residual_chain`: forward DCT -> quant -> RDOQ (optional) ->
sign-bit hiding -> dequant -> inverse DCT -> add prediction -> clip, with the
SSD of the reconstruction, for K candidate predictions per block, at bit
depth 8 or 10.

Counterpart of the chain the JAX package spells out in
`models/intra_tree.py:eval_intra_luma/eval_intra_chroma` and in the P and B
trees' `inter_trial`/`coded16`/`coded` (`models/inter_tree.py:239,619,1626`):
`fwd_transform`, `quant` (intra or inter rounding), `rdoq_adjust`,
`sbh_adjust`, `dequant`, `inv_transform`.  The plain version below composes
the plain ops; a CUDA tensor launches `csrc/residual_chain.cu`, whose launches
with RDOQ count as `residual_chain_rdoq`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .quant import dequant, quant
from .rdoq import kernel_table, rdoq_adjust_plain
from .sbh import sbh_adjust
from .transforms import fwd_transform, inv_transform


def residual_chain_plain(orig, pred, qp, sbh: bool, want_recon=True,
                         intra: bool = True, bit_depth: int = 8,
                         rdoq: bool = False, lam=None, st: str = "P",
                         c_idx: int = 0):
    """orig [B, n, n], pred [B, K, n, n], qp [B] (int) -> (levels int16
    [B, K, n, n], recon int32 [B, K, n, n] or None, ssd int32 [B, K]).
    ``intra`` picks the quant rounding offset (171, else 85); ``rdoq``
    runs `rdoq_adjust` with the per-block lambdas lam [B] (f32), the slice
    type ``st``'s tables and those of plane ``c_idx``."""
    orig = orig.to(torch.int32)
    pred = pred.to(torch.int32)
    coeff = fwd_transform(orig[:, None] - pred, bit_depth)
    qpb = qp.to(torch.int64)[:, None, None, None]
    levels = quant(coeff, qpb, bit_depth, intra=intra)
    if rdoq:
        levels = rdoq_adjust_plain(coeff, levels, qp.to(torch.int64)[:, None],
                                   lam.to(torch.float32)[:, None], c_idx, st)
    if sbh:
        levels = sbh_adjust(levels)
    rec = torch.clamp(pred + inv_transform(dequant(levels, qpb, bit_depth),
                                           bit_depth), 0, (1 << bit_depth) - 1)
    ssd = ((rec - orig[:, None]) ** 2).sum((2, 3)).to(torch.int32)
    return (levels.to(torch.int16), rec.to(torch.int32) if want_recon
            else None, ssd)


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _k2():
    lib = cuda_lib.lib("residual_chain")
    if not getattr(lib, "_typed", False):
        lib.residual_chain.argtypes = [_VP] * 3 + [_I] * 6 + [_VP] * 6
        lib.residual_chain.restype = _I
        lib._typed = True
    return lib


_tables: dict = {}


def rdoq_table(n, st, c_idx, dev):
    """K2's RDOQ table (`kernel_table`) of TU size n, slice type st and
    plane c_idx on device dev, uploaded once."""
    key = (n, st, 1 if c_idx else 0, dev)
    if key not in _tables:          # one upload per table and device
        _tables[key] = torch.as_tensor(kernel_table(n, st, key[2]),
                                       device=dev)
    return _tables[key]


def residual_chain(orig, pred, qp, sbh: bool, want_recon=True,
                   intra: bool = True, bit_depth: int = 8, rdoq: bool = False,
                   lam=None, st: str = "P", c_idx: int = 0):
    """See residual_chain_plain.  ``want_recon=False`` skips writing the
    reconstruction (the estimate needs only levels and SSD)."""
    if orig.device.type == "cpu":
        return residual_chain_plain(orig, pred, qp, sbh, want_recon, intra,
                                    bit_depth, rdoq, lam, st, c_idx)
    o = orig.to(torch.int32).contiguous()
    p = pred.to(torch.int32).contiguous()
    q = qp.to(torch.int32).contiguous()
    bsz, k, n, _ = p.shape
    if o.shape != (bsz, n, n) or q.shape != (bsz,) or n not in (8, 16, 32):
        raise ValueError("residual_chain: bad shapes")
    if bit_depth not in (8, 10):
        raise ValueError("residual_chain: bit depth 8 or 10")
    dev = o.device
    tab = lamv = None
    if rdoq:
        lamv = lam.to(torch.float32).contiguous()
        tab = rdoq_table(n, st, c_idx, dev)
        if lamv.shape != (bsz,):
            raise ValueError("residual_chain: lam must be [B]")
        cuda_lib.require_cuda(o, p, q, lamv, tab)
    else:
        cuda_lib.require_cuda(o, p, q)
    levels = torch.empty((bsz, k, n, n), dtype=torch.int16, device=dev)
    rec = torch.empty((bsz, k, n, n), dtype=torch.int32, device=dev) \
        if want_recon else None
    ssd = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz * k:
        rc = _k2().residual_chain(
            cuda_lib.ptr(o), cuda_lib.ptr(p), cuda_lib.ptr(q), bsz, k, n,
            int(sbh), int(intra), int(bit_depth),
            cuda_lib.ptr(tab) if rdoq else _VP(0),
            cuda_lib.ptr(lamv) if rdoq else _VP(0), cuda_lib.ptr(levels),
            cuda_lib.ptr(rec) if rec is not None else _VP(0),
            cuda_lib.ptr(ssd), _VP(cuda_lib.stream_handle(o)))
        cuda_lib.launched("residual_chain_rdoq" if rdoq else "residual_chain",
                          rc)
    return levels, rec, ssd
