"""Kernel K3 `tu_bits`: context-anchored fractional CABAC bits of a TU (role
of the reference's estBit tables, `encoder/entropy.cpp:2220`), the port of
the JAX package's `ops/estbits.py:tu_bits` with per-block QP rows.

Every f32 term the JAX function sums is a multiple of 2^-15 (the entropy
table in 1/32768 bits) or an integer, so the port sums each family in
integers and converts once: the result equals the JAX value wherever the
JAX f32 sums are exact (every partial sum below 512 bits) and is within one
rounding of it beyond that.  The nine family sums are then added in the
JAX expression's order in f32, without FMA contraction, on both devices.
The Golomb-Rice `floor(log2(.))` terms are computed in integers; a CPU test
holds them equal to the JAX f32 forms over every input a coefficient group
can produce (XLA's f32 log2 of 8192 rounds low, at remainders no group with
that Rice parameter can reach).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ..cabac.tables import CTX_OFFSET, ENTROPY_BITS, init_context_states
from . import cuda_lib

_SCALE = 1.0 / 32768.0


def _bits(states: np.ndarray, name: str, idx: int, binval: int) -> float:
    st, mps = states[CTX_OFFSET[name] + idx]
    return float(ENTROPY_BITS[st, 0 if binval == mps else 1]) * _SCALE


@functools.lru_cache(maxsize=None)
def bit_consts(slice_type: str = "P", qp: int = 30, c_idx: int = 0) -> tuple:
    """(cbf0, cbf1, csb0, csb1, sig0_dc, sig1_dc, sig0, sig1, g1_0, g1_1,
    g2_1, last_bin, intra_hdr) at the slice type's init states."""
    st = init_context_states(slice_type, qp)
    chroma = 1 if c_idx else 0
    cbf_idx = 2 if chroma else 0
    csb_idx = 2 if chroma else 0
    sig_dc = 27 if chroma else 0
    sig_mid = 36 if chroma else 12
    g1_idx = 16 if chroma else 1
    g2_idx = 4 if chroma else 0
    base = 18 if chroma else 3
    last_bin = float(np.mean([
        min(_bits(st, "last_sig_coeff_prefix", base + i, 0),
            _bits(st, "last_sig_coeff_prefix", base + i, 1))
        for i in range(4)])) + 0.5
    intra_hdr = (_bits(st, "pred_mode_flag", 0, 1)
                 + _bits(st, "part_mode", 0, 1)
                 + _bits(st, "prev_intra_luma_pred_flag", 0, 1)
                 + 2.0
                 + _bits(st, "intra_chroma_pred_mode", 0, 0))
    return (_bits(st, "qt_cbf", cbf_idx, 0), _bits(st, "qt_cbf", cbf_idx, 1),
            _bits(st, "coded_sub_block_flag", csb_idx, 0),
            _bits(st, "coded_sub_block_flag", csb_idx, 1),
            _bits(st, "sig_coeff_flag", sig_dc, 0),
            _bits(st, "sig_coeff_flag", sig_dc, 1),
            _bits(st, "sig_coeff_flag", sig_mid, 0),
            _bits(st, "sig_coeff_flag", sig_mid, 1),
            _bits(st, "coeff_abs_level_greater1_flag", g1_idx, 0),
            _bits(st, "coeff_abs_level_greater1_flag", g1_idx, 1),
            _bits(st, "coeff_abs_level_greater2_flag", g2_idx, 1),
            last_bin, intra_hdr)


@functools.lru_cache(maxsize=None)
def bit_consts_table(slice_type: str, c_idx: int) -> np.ndarray:
    """[52, 13] f32 bit_consts rows for every QP."""
    return np.asarray([bit_consts(slice_type, q, c_idx) for q in range(52)],
                      np.float32)


@functools.lru_cache(maxsize=None)
def group_idx_bins(maxpos: int = 32) -> np.ndarray:
    """last_sig_coeff prefix + suffix bin count per position value."""
    from ..cabac.syntax import last_prefix_group
    out = np.zeros(maxpos, np.float32)
    for v in range(maxpos):
        gi = last_prefix_group(v)
        out[v] = min(gi + 1, 18) + ((gi >> 1) - 1 if gi > 3 else 0)
    return out


def _bitlen(x):
    """Bit length of a non-negative int64 tensor (0 -> 0)."""
    out = torch.zeros_like(x)
    for s in (16, 8, 4, 2, 1):
        big = x >= (1 << s)
        out = out + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return out + (x > 0).to(x.dtype)


def tu_bits_plain(levels, c_idx: int, qp, slice_type: str = "I"):
    """levels [..., n, n], qp int broadcastable to the lead shape ->
    f32 bits [...] (JAX `tu_bits(levels, c_idx, slice_type, qp=qp)`, priced
    at the slice type's init states)."""
    n = levels.shape[-1]
    lead = levels.shape[:-2]
    dev = levels.device
    a = levels.reshape(-1, n, n).to(torch.int64).abs()
    nb = a.shape[0]
    tab = torch.as_tensor(bit_consts_table(slice_type, 1 if c_idx else 0),
                          device=dev)
    qpf = torch.clamp(torch.broadcast_to(qp, lead).reshape(-1), 0, 51)
    row = tab[qpf.long()]                                   # [nb, 13] f32
    u = torch.round(row.double() * 32768.0).to(torch.int64)  # exact units
    nz = a > 0
    ar = torch.arange(n, device=dev)
    lx = torch.where(nz, ar[None, None, :], 0).amax((1, 2))
    ly = torch.where(nz, ar[:, None][None], 0).amax((1, 2))
    lp = torch.as_tensor(group_idx_bins(32), device=dev)
    last_bits = (lp[lx] + lp[ly]) * row[:, 11]

    cg = a.reshape(nb, n // 4, 4, n // 4, 4).permute(0, 1, 3, 2, 4) \
        .reshape(nb, -1, 16)
    ncg = cg.shape[1]
    cgp = cg > 0
    cg_nz = cgp.any(2)
    n_cod = cg_nz.sum(1)
    csb_u = u[:, 3] * n_cod + u[:, 2] * (ncg - n_cod) - u[:, 3]
    dc = torch.zeros((ncg, 16), dtype=torch.bool, device=dev)
    dc[0, 0] = True
    inside = cg_nz[:, :, None] & ~dc
    n1 = (inside & cgp).sum((1, 2))
    n0 = (inside & ~cgp).sum((1, 2))
    dc_u = torch.where(cg[:, 0, 0] > 0, u[:, 5], u[:, 4])
    sig_u = n1 * u[:, 7] + n0 * u[:, 6] + torch.where(cg_nz[:, 0], dc_u, 0)
    rank = torch.cumsum(cgp.to(torch.int64), 2)
    take = cgp & (rank <= 8)
    g1_u = ((take & (cg > 1)).sum((1, 2)) * u[:, 9]
            + (take & (cg <= 1)).sum((1, 2)) * u[:, 8])
    g2_u = (take & (cg > 1)).any(2).sum(1) * u[:, 10]

    base = torch.where(take, torch.clamp(cg, max=3), 1)
    rem = torch.where(cgp, cg - base, 0)
    k = torch.clamp(_bitlen(cg.sum(2)) - 5, 0, 4)[:, :, None]
    pref = rem >> k
    esc = _bitlen(torch.clamp(rem - (2 << k), min=1)) - k
    rem_len = torch.where(pref < 3, pref + 1 + k, 3 + 2 * esc + k)
    rem_i = torch.where(rem > 0, rem_len, 0).sum((1, 2))
    over8 = torch.where(cgp & (rank > 8), 1 + k, 0).sum((1, 2))
    nnz = nz.sum((1, 2))

    def f(units):
        return units.to(torch.float32) * _SCALE

    csb_bits = torch.clamp(f(csb_u) + 0.0, min=0.0)
    total = row[:, 1] + last_bits
    for term in (csb_bits, f(sig_u), f(g1_u), f(g2_u),
                 rem_i.to(torch.float32), over8.to(torch.float32),
                 nnz.to(torch.float32)):
        total = total + term
    out = torch.where(nz.any((1, 2)), total, row[:, 0])
    return out.reshape(lead).to(torch.float32)


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _k3():
    lib = cuda_lib.lib("tu_bits")
    if not getattr(lib, "_typed", False):
        lib.tu_bits.argtypes = [_VP] * 4 + [_I, _I, _VP]
        lib.tu_bits.restype = _I
        lib._typed = True
    return lib


_tables: dict = {}


def tu_bits(levels, c_idx: int, qp, slice_type: str = "I"):
    """See tu_bits_plain; a CUDA tensor launches `csrc/tu_bits.cu` with the
    slice type's [52, 13] table."""
    if levels.device.type == "cpu":
        return tu_bits_plain(levels, c_idx, qp, slice_type)
    n = levels.shape[-1]
    lead = levels.shape[:-2]
    lv = levels.to(torch.int16).reshape(-1, n, n).contiguous()
    q = torch.broadcast_to(qp, lead).reshape(-1).to(torch.int32) \
        .contiguous()
    key = (slice_type, 1 if c_idx else 0, lv.device)
    if key not in _tables:
        _tables[key] = torch.as_tensor(bit_consts_table(slice_type, key[1]),
                                       device=lv.device)
    tab = _tables[key]
    cuda_lib.require_cuda(lv, q, tab)
    if n not in (8, 16, 32):
        raise ValueError("tu_bits: n must be 8, 16 or 32")
    out = torch.empty(lv.shape[0], dtype=torch.float32, device=lv.device)
    if lv.shape[0]:
        rc = _k3().tu_bits(cuda_lib.ptr(lv), cuda_lib.ptr(q),
                           cuda_lib.ptr(tab), cuda_lib.ptr(out),
                           lv.shape[0], n, _VP(cuda_lib.stream_handle(lv)))
        cuda_lib.launched("tu_bits", rc)
    return out.reshape(lead)


def intra_hdr_bits(slice_type: str = "P") -> float:
    """Header-bin cost of an intra CU inside an inter slice (pred_mode,
    part_mode, MPM bins, chroma DM) at QP 30 init states (JAX
    `ops/estbits.py:222`)."""
    return bit_consts(slice_type, 30, 0)[12]
