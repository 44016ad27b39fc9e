"""Rate control, CQP only (the slices' subset of the JAX package's
`models/ratecontrol.py`): a P frame codes at the configured QP, an I frame
at that QP less the offset of x265's ipFactor, 6 log2(ip_factor), and a B
frame at that QP plus the pbFactor offset 6 log2(pb_factor), half of it for
a referenced B (the pyramid's middle) and all of it for a non-referenced b
(the leaves), as the JAX `frame_qp` does (:232-237).  The lookahead's SATD
feeds `set_complexity` as in the JAX package; CQP does not read it."""

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
        self.pb_offset = 6.0 * math.log2(max(param.pb_factor, 1.01))
        self.frames = 0
        self.actual_bits = 0.0
        self._next_satd = None
        self._satd_blur = None

    def frame_qp(self, slice_type: str) -> int:
        """QP of a frame of type "I", "P", "B" (referenced) or "b"."""
        offset = {"I": -self.ip_offset, "P": 0.0, "B": 0.5 * self.pb_offset,
                  "b": self.pb_offset}.get(slice_type)
        if offset is None:
            raise ValueError(f"unknown slice type {slice_type!r}")
        return int(round(min(max(self.base_qp + offset, 0.0), 51.0)))

    def update(self, bits: int, slice_type: str, qp: int) -> None:
        self.frames += 1
        self.actual_bits += bits

    def set_complexity(self, satd: float) -> None:
        """Feed the lookahead's frame cost (lowres SATD sum) for the next
        frame_qp/update pair, with a 0.5-decay blur over recent frames (JAX
        `set_complexity` :252)."""
        if satd is None or satd <= 0:
            return
        self._next_satd = float(satd)
        if self._satd_blur is None:
            self._satd_blur = float(satd)
        else:
            self._satd_blur = 0.5 * self._satd_blur + 0.5 * float(satd)
