"""Rate control, CQP only (the slice's subset of the JAX package's
`models/ratecontrol.py`): a P frame codes at the configured QP, an I frame
at that QP less the offset of x265's ipFactor, 6 * log2(ip_factor)."""

from __future__ import annotations

import math

from ..utils.params import Param


class RateControl:
    def __init__(self, param: Param):
        if param.rc_mode != "cqp" or param.bitrate > 0:
            raise ValueError("the port runs CQP rate control only")
        self.mode = "cqp"
        self.base_qp = float(param.qp)
        self.ip_offset = 6.0 * math.log2(max(param.ip_factor, 1.01))
        self.frames = 0
        self.actual_bits = 0.0

    def frame_qp(self, slice_type: str) -> int:
        if slice_type not in ("I", "P"):
            raise ValueError("the port codes I and P slices only")
        qp = self.base_qp - (self.ip_offset if slice_type == "I" else 0.0)
        return int(round(min(max(qp, 0.0), 51.0)))

    def update(self, bits: int, slice_type: str, qp: int) -> None:
        self.frames += 1
        self.actual_bits += bits
