"""Resampler of the ABR ladder (role of x265's `common/scaler.cpp`, used by
the multi-encode app): kernel K16 `resample_plane` beside its plain PyTorch
version, and `resample_frame` for a 4:2:0 frame.

Counterpart in the JAX package: `ops/scaler.py` (`_cubic_weight` :30,
`_resample_matrix` :42, `resample_plane` :74, `resample_frame` :91).  The JAX
package forms ``rint(clip((V @ P) @ H^T))`` in f32 with two dense matrix
products, V [dstH, srcH] and H [dstW, srcW] the interpolation operators
(Catmull-Rom bicubic, a = -0.5, or bilinear, stretched by the scale factor
on a downscale, normalised, edge-clamped).  Each row of V and H has only a
few nonzero taps (up to 13 at a 3x downscale), so the port keeps each
operator as a band (the first nonzero tap of each row and the weights from
there), built once per (src, dst, method) from the same f32 matrix, and runs
two passes: vertical into an f32 intermediate, then horizontal, rint (half
to even), a clip to 0..255 and uint8.

A sum of f32 products rounds by its order.  Adding an exact zero changes no
sum, so a dense product's order reduces to the order of its nonzero taps;
each pass here is one fused multiply-add chain over the taps in increasing
source index.  XLA's CPU matrix product sums in that order at some shapes
(every 2:1 downscale the tests run) and in others at other shapes, as its
GEMM kernel and the host choose; there the unrounded values may differ by
a few ulps (2 measured) and a uint8 sample only where that crosses a .5
boundary (`tests/test_torch_abr.py`, ROADMAP queue 3 n).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib
from .rdoq import fma32

_VP, _I = ctypes.c_void_p, ctypes.c_int


def _cubic_weight(x: np.ndarray, a: float = -0.5) -> np.ndarray:
    """Catmull-Rom bicubic kernel (a = -0.5; JAX `_cubic_weight`)."""
    x = np.abs(x)
    w = np.zeros_like(x)
    m1 = x <= 1
    m2 = (x > 1) & (x < 2)
    w[m1] = (a + 2) * x[m1] ** 3 - (a + 3) * x[m1] ** 2 + 1
    w[m2] = a * x[m2] ** 3 - 5 * a * x[m2] ** 2 + 8 * a * x[m2] - 4 * a
    return w


@functools.lru_cache(maxsize=64)
def _resample_matrix(src: int, dst: int, method: str = "bicubic"
                     ) -> np.ndarray:
    """[dst, src] f32 interpolation operator with edge clamping, built as
    the JAX `_resample_matrix` builds it (the taps of a clamped edge add
    into one entry, in tap order)."""
    if src == dst:
        return np.eye(src, dtype=np.float32)
    scale = src / dst
    stretch = max(scale, 1.0)
    support = (2.0 if method == "bicubic" else 1.0) * stretch
    mat = np.zeros((dst, src), dtype=np.float32)
    for d in range(dst):
        center = (d + 0.5) * scale - 0.5
        lo = int(np.floor(center - support))
        hi = int(np.ceil(center + support))
        taps = np.arange(lo, hi + 1)
        x = (taps - center) / stretch
        if method == "bicubic":
            w = _cubic_weight(x)
        else:
            w = np.clip(1.0 - np.abs(x), 0.0, None)
        s = w.sum()
        if s <= 0:
            w = np.ones_like(w)
            s = w.sum()
        w = w / s
        taps = np.clip(taps, 0, src - 1)
        for t, wv in zip(taps, w):
            mat[d, t] += wv
    return mat


@functools.lru_cache(maxsize=64)
def _band_np(src: int, dst: int, method: str):
    """The operator as a band: (first int32 [dst], weights f32 [dst, n]):
    row d's nonzero taps are weights[d, t] at source first[d] + t, padded
    with zero weights (their sources clamped into the plane by `_band`)."""
    mat = _resample_matrix(src, dst, method)
    nz = mat != 0
    first = np.where(nz.any(1), nz.argmax(1), 0)
    last = np.where(nz.any(1), src - 1 - nz[:, ::-1].argmax(1), 0)
    n = int((last - first).max()) + 1
    idx = np.minimum(first[:, None] + np.arange(n)[None], src - 1)
    w = np.where(np.arange(n)[None] <= (last - first)[:, None],
                 np.take_along_axis(mat, idx, 1), np.float32(0))
    return first.astype(np.int32), w.astype(np.float32)


_BANDS: dict = {}


def _band(src: int, dst: int, method: str, device):
    """The band of `_band_np` on ``device``, uploaded once."""
    key = (src, dst, method, str(device))
    if key not in _BANDS:
        first, w = _band_np(src, dst, method)
        _BANDS[key] = (torch.as_tensor(first, device=device),
                       torch.as_tensor(w, device=device))
    return _BANDS[key]


def _chain(rows_of_tap, first, w, src: int):
    """sum_t w[:, t] * x[first + t] as one FMA chain in increasing t, f32:
    rows_of_tap(idx) gives the source rows (or columns) at idx [dst]."""
    acc = None
    for t in range(w.shape[1]):
        x = rows_of_tap(torch.clamp(first + t, max=src - 1))
        wt = w[:, t].reshape((-1,) + (1,) * (x.dim() - 1))
        acc = x.new_zeros(x.shape) if acc is None else acc
        acc = fma32(wt, x, acc)
    return acc


def resample_plane_plain(plane, dst_w: int, dst_h: int,
                         method: str = "bicubic", unrounded: bool = False):
    """plane [H, W] uint8 -> [dst_h, dst_w] uint8 (or, with ``unrounded``,
    the f32 values before rint and the clip)."""
    src_h, src_w = plane.shape
    fv, wv = _band(src_h, dst_h, method, plane.device)
    fh, wh = _band(src_w, dst_w, method, plane.device)
    p = plane.to(torch.float32)
    mid = _chain(lambda i: p[i], fv, wv, src_h)                # [dst_h, W]
    out = _chain(lambda j: mid[:, j].T, fh, wh, src_w).T       # [dst_h, dst_w]
    if unrounded:
        return out
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


def resample_plane(plane, dst_w: int, dst_h: int, method: str = "bicubic",
                   unrounded: bool = False):
    """See resample_plane_plain; a CUDA tensor launches the two kernels of
    `csrc/resample.cu`, the vertical and the horizontal pass (two launches
    counted)."""
    if plane.device.type != "cuda":
        return resample_plane_plain(plane, dst_w, dst_h, method, unrounded)
    if plane.dtype != torch.uint8 or plane.dim() != 2:
        raise ValueError("K16 resamples one uint8 [H, W] plane")
    plane = plane.contiguous()
    cuda_lib.require_cuda(plane)
    src_h, src_w = plane.shape
    fv, wv = _band(src_h, dst_h, method, plane.device)
    fh, wh = _band(src_w, dst_w, method, plane.device)
    mid = torch.empty((dst_h, src_w), dtype=torch.float32,
                      device=plane.device)
    out = torch.empty((dst_h, dst_w), dtype=torch.uint8, device=plane.device)
    raw = torch.empty((dst_h, dst_w), dtype=torch.float32,
                      device=plane.device) if unrounded else None
    lib = cuda_lib.lib("resample")
    stream = _VP(cuda_lib.stream_handle(plane))
    lib.resample_v.argtypes = [_VP, _I, _I, _VP, _VP, _I, _VP, _I, _VP]
    rc = lib.resample_v(cuda_lib.ptr(plane), src_h, src_w, cuda_lib.ptr(fv),
                        cuda_lib.ptr(wv), wv.shape[1], cuda_lib.ptr(mid),
                        dst_h, stream)
    cuda_lib.launched("resample", rc)
    lib.resample_h.argtypes = [_VP, _I, _VP, _VP, _I, _VP, _VP, _I, _I, _VP]
    rc = lib.resample_h(cuda_lib.ptr(mid), src_w, cuda_lib.ptr(fh),
                        cuda_lib.ptr(wh), wh.shape[1], cuda_lib.ptr(out),
                        _VP(raw.data_ptr() if raw is not None else 0), dst_h,
                        dst_w, stream)
    cuda_lib.launched("resample", rc)
    return raw if unrounded else out


def resample_frame(frame, dst_w: int, dst_h: int, method: str = "bicubic"):
    """(y, cb, cr) 4:2:0 uint8 planes (tensors) resampled to (dst_h, dst_w)
    and half that for chroma."""
    y, cb, cr = frame
    return (resample_plane(y, dst_w, dst_h, method),
            resample_plane(cb, dst_w // 2, dst_h // 2, method),
            resample_plane(cr, dst_w // 2, dst_h // 2, method))
