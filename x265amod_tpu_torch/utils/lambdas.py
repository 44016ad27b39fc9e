"""x265's SSE lambda (reference `common/constants.cpp:34-95`
x265_lambda2_tab, 8-bit), from its closed form: 0.038 * exp(0.234 * qp) for
QP 0..69 (QP_MAX_MAX, `common/common.h:158`).  The port's copy of the JAX
package's `utils/lambdas.py`, trimmed to what the slice uses."""

from __future__ import annotations

import numpy as np

QP_MAX_MAX = 69

LAMBDA2_TAB_8 = (0.038 * np.exp(0.234 * np.arange(QP_MAX_MAX + 1,
                                                   dtype=np.float64)))


def lambda2_of(qp) -> np.ndarray:
    """lambda2 lookup for integer QP scalars or arrays (clipped to the
    table range like the reference's setQP)."""
    return LAMBDA2_TAB_8[np.clip(np.asarray(qp, np.int32), 0, QP_MAX_MAX)]
