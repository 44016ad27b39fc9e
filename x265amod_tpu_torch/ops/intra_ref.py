"""Intra angle tables and the reference-smoothing filter flag (spec Tables
8-5 and 8-6, 8.4.4.2.3): the port's copy of the JAX package's
`ops/intra_ref.py` constants."""

from __future__ import annotations

# intraPredAngle per mode 2..34 (spec Table 8-5)
ANGLES = {m: a for m, a in zip(range(2, 35),
          [32, 26, 21, 17, 13, 9, 5, 2, 0, -2, -5, -9, -13, -17, -21, -26,
           -32, -26, -21, -17, -13, -9, -5, -2, 0, 2, 5, 9, 13, 17, 21,
           26, 32])}
# invAngle per mode 11..25 (spec Table 8-6)
INV_ANGLES = {m: ia for m, ia in zip(range(11, 26),
              [-4096, -1638, -910, -630, -482, -390, -315, -256, -315,
               -390, -482, -630, -910, -1638, -4096])}


def filter_flag(mode: int, n: int, c_idx: int) -> bool:
    """Spec 8.4.4.2.3 filterFlag (strong smoothing handled separately)."""
    if c_idx != 0 or n == 4:
        return False
    if mode == 1:  # DC
        return False
    if mode == 0:  # planar
        return n in (8, 16, 32)
    min_dist = min(abs(mode - 26), abs(mode - 10))
    thres = {8: 7, 16: 1, 32: 0}[n]
    return min_dist > thres
