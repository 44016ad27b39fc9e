"""The B frame result record: the port's copy of `BFrameResult` from the JAX
package's `models/b_frame.py` (:44), which the B tree's `collect` returns.
The flat CTB16 B pipeline of that module is not ported."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class BFrameResult:
    kinds: np.ndarray        # [h16, w16] 0 skip, 1 inter (AMVP), 2 intra
    merge_idx: np.ndarray    # [h16, w16]
    inter_dir: np.ndarray    # [h16, w16] 1 L0, 2 L1, 3 bi (0 intra)
    mvd0: np.ndarray         # [h16, w16, 2] qpel
    mvp0: np.ndarray         # [h16, w16]
    mvd1: np.ndarray
    mvp1: np.ndarray
    modes: np.ndarray        # [h16, w16] intra modes
    levels_y: np.ndarray     # [h16, w16, 16, 16]
    levels_cb: np.ndarray    # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray          # [4] luma/cb/cr SSE, luma SSIM
    recon_dev: tuple         # device recon planes (post-SAO)
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    split: np.ndarray | None = None      # [hc32, wc32]
    # SAO parameters per CTU32 (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None
