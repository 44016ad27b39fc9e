"""Intra prediction for the CTU32 tree: kernel K1 `intra_pred` and its plain
PyTorch versions.

Counterparts in the JAX package (`ops/intra.py`, `models/intra_tree.py`):
`substitute_refs_general`, `predict_all_modes_batch`, `predict_modes_batch`
and `_satd_modes`.  The JAX code builds predictions with one-hot f32 matmuls;
here every angular sample is a two-tap gather from the reference line,
``((32 - f) * a + f * b + 16) >> 5``, which equals the JAX value for 8- and
10-bit samples (the f32 sums stay below 2^24).  Every entry point takes the
bit depth (8 or 10): the mid-grey fill and the clip of the mode 10/26 edge
filters depend on it.

Entry points (each takes RAW refs plus per-sample availability and runs the
spec 8.4.4.2.2 substitution itself):

- `satd35`: substitution, [1 2 1] smoothing, all 35 predictions and their
  8x8 Hadamard SATD against the source block -> [B, 35] int32.  On the card
  the predictions never leave the kernel.
- `predict`: the predictions of K given modes per block -> [B, K, n, n].

A CPU tensor takes the plain version; a CUDA tensor launches the kernel,
which is exact for samples (source and references) in [0, 2^bit_depth - 1]:
its Hadamard runs as f16 products on the tensor cores, exact for such
differences (`csrc/intra_pred.cu`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib
from .intra_ref import ANGLES, INV_ANGLES, filter_flag

# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def substitute_refs_general(top_raw, left_raw, corner_raw, avail_top,
                            avail_left, avail_corner, n: int,
                            bit_depth: int = 8):
    """Spec 8.4.4.2.2 substitution with per-sample availability.

    top_raw/left_raw [B, 2n], corner_raw [B]; avail_* bool of the same
    shapes.  Scan order left[2n-1]..left[0], corner, top[0]..top[2n-1]: an
    unavailable sample takes the previous substituted one, a leading
    unavailable run takes the first available sample, and nothing
    available fills mid-grey.  Returns int32 (top, left, corner)."""
    fill = 1 << (bit_depth - 1)
    seq = torch.cat([left_raw.flip(1), corner_raw[:, None], top_raw],
                    1).to(torch.int32)
    av = torch.cat([avail_left.flip(1), avail_corner[:, None], avail_top], 1)
    m = seq.shape[1]
    iota = torch.arange(m, device=seq.device)[None, :].expand_as(seq)
    prev_idx = torch.cummax(torch.where(av, iota, -1), 1).values
    first_idx = torch.argmax(av.to(torch.int32), 1)
    idx = torch.where(prev_idx >= 0, prev_idx, first_idx[:, None])
    sub = torch.gather(seq, 1, idx)
    sub = torch.where(av.any(1)[:, None], sub, fill)
    return (sub[:, 2 * n + 1:].contiguous(),
            sub[:, :2 * n].flip(1).contiguous(), sub[:, 2 * n].contiguous())


def _smooth(top, left, corner, n):
    """[1 2 1] filter along the reference scan (spec 8.4.4.2.3)."""
    seq = torch.cat([left.flip(1), corner[:, None], top], 1)
    sm = seq.clone()
    sm[:, 1:-1] = (seq[:, :-2] + 2 * seq[:, 1:-1] + seq[:, 2:] + 2) >> 2
    return sm[:, 2 * n + 1:], sm[:, :2 * n].flip(1), sm[:, 2 * n]


@functools.lru_cache(maxsize=None)
def _angular_index(n: int, c_idx: int):
    """Static gather tables for modes 2..34 over the per-block source
    vector S = [top(2n), left(2n), corner, top_f(2n), left_f(2n),
    corner_f] (unfiltered, then [1 2 1]-filtered refs).

    Returns (i0, i1, fact) int64 [33, n, n]: pred[m-2, y, x] =
    ((32 - fact) * S[i0] + fact * S[i1] + 16) >> 5."""
    line = 4 * n + 1
    i0 = np.zeros((33, n, n), np.int64)
    i1 = np.zeros((33, n, n), np.int64)
    fact = np.zeros((33, n, n), np.int64)
    for mode in range(2, 35):
        angle = ANGLES[mode]
        vertical = mode >= 18
        base = line if filter_flag(mode, n, c_idx) else 0
        main0 = 0 if vertical else 2 * n       # offset of main ref in S
        side0 = 2 * n if vertical else 0
        corner = 4 * n

        def src(i):
            # reference line position i in [-n, 2n + 1] -> index into S
            if i == 0:
                return base + corner
            if 1 <= i <= 2 * n:
                return base + main0 + i - 1
            if i == 2 * n + 1:
                return base + main0 + 2 * n - 1
            e = ((i * INV_ANGLES[mode] + 128) >> 8) - 1
            return base + (corner if e < 0 else side0 + min(e, 2 * n - 1))

        for k in range(n):
            pos = (k + 1) * angle
            idx, f = pos >> 5, pos & 31
            for j in range(n):
                y, x = (k, j) if vertical else (j, k)
                i0[mode - 2, y, x] = src(idx + 1 + j)
                i1[mode - 2, y, x] = src(idx + 2 + j) if f else \
                    src(idx + 1 + j)
                fact[mode - 2, y, x] = f
    return i0, i1, fact


def _predict_all_plain(top, left, corner, n: int, c_idx: int = 0,
                       bit_depth: int = 8):
    """All 35 predictions from SUBSTITUTED refs -> [B, 35, n, n] int32
    (the plain version of the JAX `predict_all_modes_batch`)."""
    maxv = (1 << bit_depth) - 1
    dev = top.device
    bsz = top.shape[0]
    log2n = n.bit_length() - 1
    top_f, left_f, corner_f = _smooth(top, left, corner, n)
    s = torch.cat([top, left, corner[:, None], top_f, left_f,
                   corner_f[:, None]], 1).to(torch.int32)
    i0, i1, fc = (torch.as_tensor(a, device=dev)
                  for a in _angular_index(n, c_idx))
    a = s[:, i0.reshape(-1)].reshape(bsz, 33, n, n)
    b = s[:, i1.reshape(-1)].reshape(bsz, 33, n, n)
    fc = fc.to(torch.int32)[None]
    ang = ((32 - fc) * a + fc * b + 16) >> 5

    use_f = filter_flag(0, n, c_idx)
    pt, pl = (top_f, left_f) if use_f else (top, left)
    xx = torch.arange(n, device=dev)[None, None, :]
    yy = torch.arange(n, device=dev)[None, :, None]
    planar = (((n - 1 - xx) * pl[:, :n][:, :, None]
               + (xx + 1) * pt[:, n][:, None, None]
               + (n - 1 - yy) * pt[:, :n][:, None, :]
               + (yy + 1) * pl[:, n][:, None, None] + n) >> (log2n + 1))
    dc = (top[:, :n].sum(1) + left[:, :n].sum(1) + n) >> (log2n + 1)
    dcp = dc[:, None, None].expand(bsz, n, n).clone()
    if c_idx == 0 and n < 32:
        dcp[:, 0, :] = (top[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, :, 0] = (left[:, :n] + 3 * dc[:, None] + 2) >> 2
        dcp[:, 0, 0] = (left[:, 0] + 2 * dc + top[:, 0] + 2) >> 2
    preds = torch.cat([planar[:, None].to(torch.int32),
                       dcp[:, None].to(torch.int32), ang.to(torch.int32)], 1)
    if c_idx == 0 and n < 32:
        # modes 26 / 10: first column / row filtered with UNfiltered refs
        preds[:, 26, :, 0] = torch.clamp(
            top[:, 0][:, None] + ((left[:, :n] - corner[:, None]) >> 1),
            0, maxv).to(torch.int32)
        preds[:, 10, 0, :] = torch.clamp(
            left[:, 0][:, None] + ((top[:, :n] - corner[:, None]) >> 1),
            0, maxv).to(torch.int32)
    return preds.contiguous()


def _hadamard8_sum(d):
    """Sum of |H8 . d . H8| over every 8x8 block of d [..., k*8, k*8],
    each block reduced as (sum + 2) >> 2 and then summed -> [...]."""
    *lead, n, _ = d.shape
    k = n // 8
    t = d.reshape(*lead, k, 8, k, 8)
    for axis in (-3, -1):
        for s in (1, 2, 4):
            t = t.unflatten(axis, (8 // (2 * s), 2, s))
            a, b = t.select(axis - 1, 0), t.select(axis - 1, 1)
            t = torch.stack([a + b, a - b], axis - 1).flatten(axis - 2,
                                                             axis)
    per_blk = (t.abs().sum((-3, -1)) + 2) >> 2
    return per_blk.sum((-2, -1))


def satd35_plain(orig, top_raw, left_raw, corner_raw, avail_top, avail_left,
                 avail_corner, n: int, c_idx: int = 0, bit_depth: int = 8):
    top, left, corner = substitute_refs_general(
        top_raw, left_raw, corner_raw, avail_top, avail_left, avail_corner,
        n, bit_depth)
    preds = _predict_all_plain(top, left, corner, n, c_idx, bit_depth)
    return _hadamard8_sum(orig.to(torch.int32)[:, None] - preds) \
        .to(torch.int32)


def predict_plain(top_raw, left_raw, corner_raw, avail_top, avail_left,
                  avail_corner, modes, n: int, c_idx: int = 0,
                  bit_depth: int = 8):
    top, left, corner = substitute_refs_general(
        top_raw, left_raw, corner_raw, avail_top, avail_left, avail_corner,
        n, bit_depth)
    preds = _predict_all_plain(top, left, corner, n, c_idx, bit_depth)
    idx = modes.to(torch.int64)[:, :, None, None].expand(-1, -1, n, n)
    return torch.gather(preds, 1, idx).contiguous()


# ---------------------------------------------------------------------------
# kernel K1 wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _k1():
    lib = cuda_lib.lib("intra_pred")
    if not getattr(lib, "_typed", False):
        lib.intra_satd35.argtypes = [_VP] * 8 + [_I] * 4 + [_VP]
        lib.intra_satd35.restype = _I
        lib.intra_predict.argtypes = [_VP] * 8 + [_I] * 5 + [_VP]
        lib.intra_predict.restype = _I
        lib._typed = True
    return lib


def _ref_args(top_raw, left_raw, corner_raw, avail_top, avail_left,
              avail_corner):
    return (top_raw.to(torch.int32).contiguous(),
            left_raw.to(torch.int32).contiguous(),
            corner_raw.to(torch.int32).contiguous(),
            avail_top.to(torch.uint8).contiguous(),
            avail_left.to(torch.uint8).contiguous(),
            avail_corner.to(torch.uint8).contiguous())


def _check_bd(bit_depth):
    if bit_depth not in (8, 10):
        raise ValueError("intra prediction: bit depth 8 or 10")


def satd35(orig, top_raw, left_raw, corner_raw, avail_top, avail_left,
           avail_corner, n: int, c_idx: int = 0, counter: str = "intra_pred",
           bit_depth: int = 8):
    """[B, 35] int32 SATD of every intra mode against orig [B, n, n].  A
    launch counts in `cuda_lib.LAUNCHES[counter]` (the lookahead counts
    its own)."""
    if orig.device.type == "cpu":
        return satd35_plain(orig, top_raw, left_raw, corner_raw, avail_top,
                            avail_left, avail_corner, n, c_idx, bit_depth)
    _check_bd(bit_depth)
    refs = _ref_args(top_raw, left_raw, corner_raw, avail_top, avail_left,
                     avail_corner)
    o = orig.to(torch.int32).contiguous()
    cuda_lib.require_cuda(o, *refs)
    bsz = o.shape[0]
    if o.shape != (bsz, n, n) or refs[0].shape != (bsz, 2 * n):
        raise ValueError("satd35: bad shapes")
    out = torch.empty((bsz, 35), dtype=torch.int32, device=o.device)
    if bsz:
        rc = _k1().intra_satd35(*(cuda_lib.ptr(t) for t in (o, *refs, out)),
                                bsz, n, c_idx, bit_depth,
                                _VP(cuda_lib.stream_handle(o)))
        cuda_lib.launched(counter, rc)
    return out


def predict(top_raw, left_raw, corner_raw, avail_top, avail_left,
            avail_corner, modes, n: int, c_idx: int = 0, bit_depth: int = 8):
    """[B, K, n, n] int32 predictions at modes [B, K]."""
    if top_raw.device.type == "cpu":
        return predict_plain(top_raw, left_raw, corner_raw, avail_top,
                             avail_left, avail_corner, modes, n, c_idx,
                             bit_depth)
    _check_bd(bit_depth)
    refs = _ref_args(top_raw, left_raw, corner_raw, avail_top, avail_left,
                     avail_corner)
    m = modes.to(torch.int32).contiguous()
    cuda_lib.require_cuda(m, *refs)
    bsz, k = m.shape
    if refs[0].shape != (bsz, 2 * n):
        raise ValueError("predict: bad shapes")
    out = torch.empty((bsz, k, n, n), dtype=torch.int32, device=m.device)
    if bsz * k:
        rc = _k1().intra_predict(*(cuda_lib.ptr(t) for t in (*refs, m, out)),
                                 bsz, k, n, c_idx, bit_depth,
                                 _VP(cuda_lib.stream_handle(m)))
        cuda_lib.launched("intra_pred", rc)
    return out
