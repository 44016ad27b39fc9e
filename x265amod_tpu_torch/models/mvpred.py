"""Temporal MV scaling (the port's trimmed copy of the JAX package's
`models/mvpred.py`: `dist_scale_factor` :223).  The B tree applies the
factor per neighbour MV with `inter_tree._scale_mv_vec`."""

from __future__ import annotations


def dist_scale_factor(poc_cur: int, poc_target_ref: int,
                      poc_other_ref: int) -> int:
    """Spec 8.5.3.2.8 distance scale factor that rescales an MV pointing at
    poc_other_ref to point at poc_target_ref.  tx divides by |td| and then
    takes td's sign (C division truncates; Python's // floors, so the
    quotient is formed on magnitudes)."""
    tb = min(max(poc_cur - poc_target_ref, -128), 127)
    td = min(max(poc_cur - poc_other_ref, -128), 127)
    if td == 0:
        return 256           # identity (same picture)
    tx = ((16384 + (abs(td) >> 1)) // abs(td)) * (1 if td > 0 else -1)
    return min(max((tb * tx + 32) >> 6, -4096), 4095)
