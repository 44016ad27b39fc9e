"""Temporal MV scaling and reference-index bins (the port's trimmed copy of
the JAX package's `models/mvpred.py`: `ref_idx_bins` :187,
`dist_scale_factor` :223).  The P and B trees apply a factor per neighbour
MV with `inter_tree._scale_mv_vec`."""

from __future__ import annotations

import numpy as np


def ref_idx_bins(idx: int, num_ref: int) -> int:
    """TR bin count of ref_idx_lX (9.3.3.2, cMax = num_ref - 1)."""
    if num_ref <= 1:
        return 0
    return idx + (1 if idx < num_ref - 1 else 0)


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


def ref_list_tables(poc: int, ref_pocs) -> tuple[np.ndarray, np.ndarray]:
    """The P tree's per-list tables for the L0 list ``ref_pocs`` (nearest
    first) of the picture at ``poc`` (JAX `inter_tree.encode_async`
    :1087-1101): dsf [R, R] int32, dsf[j, i] scaling a neighbour's MV on
    reference j to reference i, and the ref_idx bin counts [R] f32."""
    r = len(ref_pocs)
    dsf = np.array([[dist_scale_factor(poc, ref_pocs[i], ref_pocs[j])
                     for i in range(r)] for j in range(r)], np.int32)
    bins = np.array([ref_idx_bins(i, r) for i in range(r)], np.float32)
    return dsf, bins
