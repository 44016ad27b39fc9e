"""Quality metrics on the device (the JAX package's `ops/metrics.py`):
8x8-window SSIM with the standard C1/C2 stabilizers, in float32, and the
plane SSE in exact integers; kernel K22 `frame_metrics` gives both for a
frame batch in one launch, beside its plain version."""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib

_VP, _I = ctypes.c_void_p, ctypes.c_int

_C1 = (0.01 * 255) ** 2
_C2 = (0.03 * 255) ** 2


def ssim_plane(orig, rec):
    """Mean SSIM over non-overlapping windows: orig/rec [F, H, W] -> [F]
    float32.  The window means are f32 reductions, so values match the
    JAX package to f32 rounding, not bit for bit."""
    return ssim_windows(orig, rec).mean((1, 2)).to(torch.float32)


def ssim_windows(orig, rec):
    """The SSIM of each non-overlapping 8x8 window: [F, H/8, W/8] f32."""
    win = 8
    f, h, w = orig.shape
    hb, wb = h // win, w // win

    def blocks(p):
        return p[:, :hb * win, :wb * win].to(torch.float32) \
            .reshape(f, hb, win, wb, win).permute(0, 1, 3, 2, 4)
    x, y = blocks(orig), blocks(rec)
    mx = x.mean((3, 4))
    my = y.mean((3, 4))
    vx = (x * x).mean((3, 4)) - mx * mx
    vy = (y * y).mean((3, 4)) - my * my
    cov = (x * y).mean((3, 4)) - mx * my
    return ((2 * mx * my + _C1) * (2 * cov + _C2)) / \
        ((mx * mx + my * my + _C1) * (vx + vy + _C2))


def plane_sse(orig, rec):
    """[F] float32 sum of squared errors (exact below 2^24, as the JAX
    package's f32 sum is)."""
    d = rec.to(torch.int64) - orig.to(torch.int64)
    return (d * d).sum((1, 2)).to(torch.float32)


def frame_metrics_plain(src, rec, ssim: bool = True):
    """SSE of each plane and the luma SSIM of F frames: src and rec = (y [F,
    H, W], cb, cr [F, H/2, W/2]) -> [F, 4] float32 (the trees' ``sse``
    rows); column 3 is 0 without SSIM (Main10)."""
    y = src[0]
    s = ssim_plane(y, rec[0]) if ssim else \
        torch.zeros(y.shape[0], dtype=torch.float32, device=y.device)
    return torch.stack([plane_sse(a, b) for a, b in zip(src, rec)] + [s], 1)


# per device: the per-frame counters and the frames' 64-bit accumulators
# (zeroed once; the kernel's last CTA of a frame resets its own)
_scratch: dict = {}
_ARGS = [_VP] * 6 + [_I] * 4 + [_VP] * 4


def _aligned(t):
    """``t``, copied where its data does not start on 16 bytes (the
    kernel's int4 loads)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def frame_metrics(src, rec, ssim: bool = True):
    """See frame_metrics_plain; CUDA planes launch K22
    (`csrc/frame_metrics.cu`) once for the batch.  SSE is exact; the SSIM
    agrees with the plain version to about 1e-7 (each window's value is
    the plain version's; their mean is an exact fixed-point sum, so two
    runs give the same bits)."""
    y = src[0]
    if y.device.type == "cpu":
        return frame_metrics_plain(src, rec, ssim)
    planes = [_aligned(t.to(torch.int32).contiguous())
              for t in tuple(src) + tuple(rec)]
    f, h, w = planes[0].shape
    if any(t.shape != (f, h, w) for t in (planes[0], planes[3])) or any(
            t.shape != (f, h // 2, w // 2) for t in planes[1:3] + planes[4:]):
        raise ValueError("frame_metrics: bad shapes")
    dev = y.device
    lib = cuda_lib.typed_lib("frame_metrics", "frame_metrics", _ARGS)
    acc, cnt = _scratch.get(dev, (None, None))
    if cnt is None or cnt.shape[0] < f:
        n = max(f, 64)
        acc, cnt = _scratch[dev] = (
            torch.zeros((n, 4), dtype=torch.int64, device=dev),
            torch.zeros(n, dtype=torch.int32, device=dev))
    out = torch.empty((f, 4), dtype=torch.float32, device=dev)
    cuda_lib.require_cuda(*planes, acc, cnt, out)
    rc = lib.frame_metrics(*(cuda_lib.ptr(t) for t in planes), f, h, w,
                           int(ssim), cuda_lib.ptr(acc), cuda_lib.ptr(cnt),
                           cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(y)))
    cuda_lib.launched("frame_metrics", rc)
    return out
