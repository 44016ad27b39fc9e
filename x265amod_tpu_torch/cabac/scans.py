"""Up-right diagonal coefficient scan (ITU-T H.265 6.5.3), the one scan the
slice uses (sign-bit hiding groups); the port's copy from the JAX package's
`cabac/scans.py`."""

from __future__ import annotations

import functools

import numpy as np


@functools.lru_cache(maxsize=None)
def diag_scan(size: int) -> np.ndarray:
    """Up-right diagonal scan (spec 6.5.3): [(x,y), ...] DC first."""
    out = []
    x = y = 0
    while len(out) < size * size:
        while y >= 0:
            if x < size and y < size:
                out.append((x, y))
            y -= 1
            x += 1
        y = x
        x = 0
    return np.array(out, dtype=np.int32)
