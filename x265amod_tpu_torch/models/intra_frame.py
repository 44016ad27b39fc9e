"""The frame result record and the CTU wavefront schedule (the port's copy
of `FrameResult` and `_diag_schedule` from the JAX package's
`models/intra_frame.py`)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


def _diag_schedule(wc: int, hc: int):
    """Wavefront schedule: list of (cx, cy) cells per anti-diagonal
    d = cx + 2 * cy (each CTU sees its left, top, top-left and top-right
    neighbours on earlier diagonals)."""
    diags = []
    for d in range(wc - 1 + 2 * (hc - 1) + 1):
        lo = max(0, -(-(d - wc + 1) // 2))
        hi = min(hc - 1, d // 2)
        cells = [(d - 2 * cy, cy) for cy in range(lo, hi + 1)]
        if cells:
            diags.append(cells)
    return diags


@dataclass
class FrameResult:
    modes: np.ndarray          # [h16, w16]
    levels_y: np.ndarray       # [h16, w16, 16, 16]
    levels_cb: np.ndarray      # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray            # [4] luma/cb/cr SSE, luma SSIM
    recon_y: np.ndarray | None = None   # padded planes (uint8), opt-in
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    # CU-quadtree split map [hc32, wc32]; unsplit CTUs replicate their
    # mode over their four 16-cells and store TU32 coefficient quadrants
    split: np.ndarray | None = None
    # SAO parameters per CTU32 (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None
