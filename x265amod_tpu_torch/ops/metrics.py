"""Quality metrics on the device (the JAX package's `ops/metrics.py`):
8x8-window SSIM with the standard C1/C2 stabilizers, in float32, and the
plane SSE in exact integers."""

from __future__ import annotations

import torch

_C1 = (0.01 * 255) ** 2
_C2 = (0.03 * 255) ** 2


def ssim_plane(orig, rec):
    """Mean SSIM over non-overlapping windows: orig/rec [F, H, W] -> [F]
    float32.  The window means are f32 reductions, so values match the
    JAX package to f32 rounding, not bit for bit."""
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
    s = ((2 * mx * my + _C1) * (2 * cov + _C2)) / \
        ((mx * mx + my * my + _C1) * (vx + vy + _C2))
    return s.mean((1, 2)).to(torch.float32)


def plane_sse(orig, rec):
    """[F] float32 sum of squared errors (exact below 2^24, as the JAX
    package's f32 sum is)."""
    d = rec.to(torch.int64) - orig.to(torch.int64)
    return (d * d).sum((1, 2)).to(torch.float32)
