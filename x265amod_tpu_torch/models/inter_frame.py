"""The P frame result record (the port's subset of the JAX package's
`models/inter_frame.py`: `MAX_MERGE` :46 and `InterFrameResult` :50).  Its
rate helpers map onto the port's ops: `_rbits_proxy` (:71) is
`ops.estbits.tu_bits(levels, c_idx, qp, "P")` and `_mvd_bits` (:81) is
`ops.me.mvd_bits`, the same formula as `ops/me.py:_mvd_bits_f`."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

MAX_MERGE = 2   # five_minus_max_num_merge_cand = 3 in the slice header


@dataclass
class InterFrameResult:
    kinds: np.ndarray        # [h16, w16] 0 skip, 1 inter (AMVP), 2 intra
    merge_idx: np.ndarray    # [h16, w16]
    mvd: np.ndarray          # [h16, w16, 2] qpel
    mvp_idx: np.ndarray      # [h16, w16]
    modes: np.ndarray        # [h16, w16] intra modes (1 on inter cells)
    levels_y: np.ndarray     # [h16, w16, 16, 16]
    levels_cb: np.ndarray    # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray          # [4] luma/cb/cr SSE, luma SSIM
    recon_dev: tuple         # device recon planes (the next reference)
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    split: np.ndarray | None = None      # [hc32, wc32]
    ref0: np.ndarray | None = None       # [h16, w16] L0 ref_idx (all 0)
    # SAO parameters per CTU32 (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None

