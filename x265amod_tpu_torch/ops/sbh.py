"""Sign-bit-hiding parity fix (role of reference `common/quant.cpp:247`
signBitHidingHDQ; the JAX package's `ops/sbh.py`), plain PyTorch version,
part of kernel K2's chain.

When a 4x4 group's significant span exceeds 3 diagonal-scan positions, the
decoder infers the first coefficient's sign from the parity of the group's
absolute sum.  Where the parity disagrees, the LAST significant coefficient
moves one step toward zero (|level| >= 2) or away from zero (|level| == 1).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..cabac.scans import diag_scan


@functools.lru_cache(maxsize=None)
def diag_pos4() -> np.ndarray:
    """[4, 4] map from (y, x) to diagonal scan position 0..15."""
    pos = np.zeros((4, 4), np.int32)
    for i, (x, y) in enumerate(diag_scan(4)):
        pos[y, x] = i
    return pos


def sbh_adjust(levels):
    """Force hidden-sign parity on [..., N, N] int levels."""
    *lead, n, _ = levels.shape
    lv = levels.reshape(-1, n // 4, 4, n // 4, 4).permute(0, 1, 3, 2, 4)
    pos = torch.as_tensor(diag_pos4(), device=levels.device)
    nz = lv != 0
    first = torch.where(nz, pos, 16).amin((-2, -1))
    last = torch.where(nz, pos, -1).amax((-2, -1))
    hidden = (last - first) > 3
    parity = lv.abs().sum((-2, -1)) & 1
    first_sel = nz & (pos == first[..., None, None])
    want = (torch.where(first_sel, torch.sign(lv), 0).sum((-2, -1)) < 0) \
        .to(parity.dtype)
    need = hidden & (parity != want)
    last_sel = nz & (pos == last[..., None, None])
    step = torch.where(lv.abs() >= 2, -1, 1) * torch.sign(lv)
    lv = torch.where(need[..., None, None] & last_sel, lv + step, lv)
    return lv.permute(0, 1, 3, 2, 4).reshape(*lead, n, n) \
        .to(levels.dtype)
