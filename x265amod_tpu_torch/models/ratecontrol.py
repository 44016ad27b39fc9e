"""Rate control: CQP, CRF, ABR, VBV and 2-pass (the port's copy of the JAX
package's `models/ratecontrol.py`, the role of x265's
`encoder/ratecontrol.cpp`).  Host Python, no device work.

Every float expression keeps the reference's order, so that the same calls
give the same QPs and the same state to the last bit:

  - qscale <-> QP: qscale = 0.85 * 2^((qp - 12) / 6) (x265 qp2qscale);
  - an I frame runs at 6 log2(ip_factor) below the P-equivalent QP, a
    referenced B half of 6 log2(pb_factor) above it and a b leaf all of it;
  - ABR: the bits-so-far path (a log2 overshoot correction of the bpp
    heuristic QP) until the lookahead's SATD arrives, then the SATD-driven
    path (qscale = blurred complexity^(1 - qcomp) / rate factor, with a
    bounded overflow compensation); the frame QP is an integer with the
    fractional part carried to the next frame;
  - VBV: a frame-level leaky bucket; the QP is raised until the predicted
    frame keeps the buffer above half a frame's budget and lowered where it
    would overflow (`_clip_qp_vbv`); `update` records the excursion below
    zero before the clamp (`min_fill_preclamp`, `underflow_events`);
  - 2-pass: pass 1 logs (type, QP, bits) per frame (`write_stats`); pass 2
    plans each frame's QP from the blurred complexity by a bisected rate
    factor and corrects the drift against the plan (`_init_pass2`).

The caller's order matters: `frame_qp` of a frame reads the state that the
`update`s before it left, so the encoder reproduces the reference's order of
calls (`models/encoder.py:encode_pipelined`).
"""

from __future__ import annotations

import math
import os

from ..utils.params import Param


def qp_to_qscale(qp: float) -> float:
    return 0.85 * 2.0 ** ((qp - 12.0) / 6.0)


def qscale_to_qp(qs: float) -> float:
    return 12.0 + 6.0 * math.log2(max(qs, 1e-6) / 0.85)


class Predictor:
    """Reference RC predictor (`ratecontrol.cpp` Predictor): damped
    least squares of bits ~ coeff * complexity / qscale."""

    def __init__(self) -> None:
        self.coeff = 0.25
        self.count = 1.0
        self.decay = 0.5
        self.offset = 0.0

    def predict(self, qscale: float, complexity: float) -> float:
        return (self.coeff * complexity + self.offset) / qscale

    def update(self, qscale: float, complexity: float,
               bits: float) -> None:
        if complexity < 1e-3:
            return
        new_coeff = bits * qscale / complexity
        self.count *= self.decay
        self.coeff *= self.count
        self.count += 1.0
        self.coeff = (self.coeff + new_coeff) / self.count


class RateControl:
    def __init__(self, param: Param):
        self.param = param
        self.mode = param.rc_mode
        if param.bitrate > 0 and self.mode not in ("abr",):
            self.mode = "abr"
        elif self.mode not in ("cqp", "crf", "abr"):
            self.mode = "cqp"
        self.fps = param.fps_num / max(param.fps_den, 1)
        self.frames = 0
        self.wanted_bits = 0.0
        self.actual_bits = 0.0
        self.ip_offset = 6.0 * math.log2(max(param.ip_factor, 1.01))
        self.pb_offset = 6.0 * math.log2(max(param.pb_factor, 1.01))
        if self.mode == "abr":
            self.target_per_frame = param.bitrate * 1000.0 / self.fps
            bpp = self.target_per_frame / max(
                param.width * param.height, 1)
            self.base_qp = min(51.0, max(10.0,
                                         21.0 - 5.0 * math.log2(bpp)))
        else:
            self.target_per_frame = 0.0
            self.base_qp = float(param.crf if self.mode == "crf"
                                 else param.qp)
        self.last_qp = self.base_qp
        # ---- VBV state (reference initVBV / updateVbv) ----
        self.vbv = param.vbv_maxrate > 0 and param.vbv_bufsize > 0
        if self.vbv:
            self.buffer_size = param.vbv_bufsize * 1000.0
            self.buffer_rate = param.vbv_maxrate * 1000.0 / self.fps
            self.buffer_fill = self.buffer_size * param.vbv_init
            self.pred = {t: Predictor() for t in "IPBb"}
            # pre-clamp excursion telemetry: the clamp in update() can
            # hide real underflow, so the honest contract is asserted
            # on these (tests/test_vbv_2pass.py)
            self.min_fill_preclamp = self.buffer_fill
            self.underflow_events = 0
        # lookahead SATD complexity for the NEXT frame (reference
        # rateEstimateQscale's SATD window, ratecontrol.cpp:1900);
        # falls back to the bits-so-far proxy when no lookahead runs
        self._next_satd = None
        self._used_satd = None
        self._satd_blur = None
        # SATD-driven ABR state (x265 rateEstimateQscale: qscale =
        # rceq / rate_factor with rate_factor = wanted-bits window /
        # cplxrSum, cbrDecay damping)
        self.cplxr_sum = 0.0
        self.wanted_bits_window = 0.0
        self.cbr_decay = 0.99
        self._last_rceq = None
        self._qp_carry = 0.0
        # ---- 2-pass state ----
        self.pass_num = getattr(param, "pass_num", 0)
        self.stats_path = getattr(param, "stats_file", "") or \
            "x265amod_tpu_2pass.log"
        self._pass1_log: list[dict] = []
        self._plan: list[dict] = []
        self._plan_idx = 0
        self.qcomp = 0.6
        if self.pass_num == 2:
            self._init_pass2()

    # ------------------------------------------------------------------
    def _complexity(self, bits: float, qp: float) -> float:
        return bits * qp_to_qscale(qp)

    def _init_pass2(self) -> None:
        if not os.path.exists(self.stats_path):
            raise FileNotFoundError(
                f"2-pass stats file missing: {self.stats_path}")
        entries = []
        with open(self.stats_path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                kv = dict(tok.split(":", 1) for tok in line.split())
                entries.append(dict(
                    type=kv["type"], qp=float(kv["q"]),
                    bits=int(kv["bits"])))
        assert entries, "empty 2-pass stats file"
        target_total = self.param.bitrate * 1000.0 / self.fps \
            * len(entries)
        # complexity per frame, blurred over a small window (cplxblur)
        cplx = [self._complexity(e["bits"], e["qp"]) for e in entries]
        blurred = []
        for i in range(len(cplx)):
            lo, hi = max(0, i - 2), min(len(cplx), i + 3)
            blurred.append(sum(cplx[lo:hi]) / (hi - lo))
        # solve rate factor: bits_i = cplx_i / qscale_i with
        # qscale_i = cplx_i^(1-qcomp) / rf  ->  bits_i = rf*cplx_i^qcomp
        def total(rf: float) -> float:
            return sum(rf * c ** self.qcomp for c in blurred)
        lo, hi = 1e-6, 1e6
        for _ in range(60):
            mid = math.sqrt(lo * hi)
            if total(mid) > target_total:
                hi = mid
            else:
                lo = mid
        rf = math.sqrt(lo * hi)
        for e, c in zip(entries, blurred):
            qs = c ** (1.0 - self.qcomp) / max(rf, 1e-9)
            qp = qscale_to_qp(qs)
            # per-type offsets are applied at frame_qp time; store the
            # P-equivalent base
            if e["type"] == "I":
                qp += self.ip_offset
            elif e["type"] == "B":
                qp -= 0.5 * self.pb_offset
            elif e["type"] == "b":
                qp -= self.pb_offset
            self._plan.append(dict(qp=qp, type=e["type"],
                                   bits=rf * c ** self.qcomp))
        self.target_per_frame = self.param.bitrate * 1000.0 / self.fps
        self._planned_so_far = 0.0

    # ------------------------------------------------------------------
    def frame_qp(self, slice_type: str) -> int:
        if self.pass_num == 2 and self._plan_idx < len(self._plan):
            qp = self._plan[self._plan_idx]["qp"]
            # feedback against the PLAN's cumulative bits (not the
            # uniform per-frame target): complexity spikes are planned,
            # so any drift here is model error to correct at full gain
            if self._planned_so_far > 0:
                overshoot = self.actual_bits / self._planned_so_far
                # high-gain correction, capped at +-3 QP: drift against
                # the plan is pure model error (complexity spikes are
                # already planned), so correct it aggressively
                qp += min(max(12.0 * math.log2(max(overshoot, 1e-3)),
                              -3.0), 3.0)
        elif self.mode == "abr" and self._satd_blur is not None:
            # SATD-driven ABR (reference rateEstimateQscale,
            # ratecontrol.cpp:1900): qscale tracks blurred complexity
            # ^ (1 - qcomp) scaled by the running rate factor, with
            # multiplicative overflow compensation
            rceq = max(self._satd_blur, 1.0) ** (1.0 - self.qcomp)
            self._last_rceq = rceq
            if self.cplxr_sum <= 0:
                # seed so the first frame lands on the bpp heuristic QP
                qs = qp_to_qscale(self.base_qp)
            else:
                rate_factor = self.wanted_bits_window / self.cplxr_sum
                qs = rceq / max(rate_factor, 1e-9)
                if self.wanted_bits > 0:
                    overflow = self.actual_bits / self.wanted_bits
                    qs *= min(max(overflow, 0.5), 2.0)
            qp = qscale_to_qp(qs)
            qp = min(max(qp, self.last_qp - self.param.qp_step),
                     self.last_qp + self.param.qp_step)
        else:
            qp = self.base_qp
            if self.mode == "abr" and self.wanted_bits > 0:
                overshoot = self.actual_bits / self.wanted_bits
                qp = self.base_qp + 6.0 * math.log2(max(overshoot, 1e-3))
                qp = min(max(qp, self.last_qp - self.param.qp_step),
                         self.last_qp + self.param.qp_step)
        if slice_type == "I":
            qp -= self.ip_offset
        elif slice_type == "B":      # referenced B (pyramid mid-level)
            qp += 0.5 * self.pb_offset
        elif slice_type == "b":      # non-referenced B (pyramid leaf)
            qp += self.pb_offset
        if self.vbv:
            qp = self._clip_qp_vbv(qp, slice_type)
        qpf = min(max(qp, 0.0), 51.0)
        if self.mode == "abr" or self.pass_num == 2:
            # whole-frame QP is integer; error-diffuse the fractional
            # part so the MEAN rate converges (the reference avoids
            # the dead zone with fractional per-row qscale; frame-level
            # dithering is the TPU-shaped equivalent)
            qpi = min(max(int(round(qpf + self._qp_carry)), 0), 51)
            self._qp_carry = max(-1.0, min(
                1.0, self._qp_carry + qpf - qpi))
            return qpi
        return int(round(qpf))

    def set_complexity(self, satd: float) -> None:
        """Feed the lookahead's frame cost (lowres SATD sum) for the
        next frame_qp/update pair — the reference's SATD-driven
        complexity (rateEstimateQscale, ratecontrol.cpp:1900) with a
        0.5-decay blur over recent frames (cplxrsum analog)."""
        if satd is None or satd <= 0:
            return
        self._next_satd = float(satd)
        if self._satd_blur is None:
            self._satd_blur = float(satd)
        else:
            self._satd_blur = 0.5 * self._satd_blur + 0.5 * float(satd)

    def _frame_complexity(self) -> float:
        if self._satd_blur is not None:
            return max(self._satd_blur, 1.0)
        return max(self.actual_bits / max(self.frames, 1), 5000.0)

    def _clip_qp_vbv(self, qp: float, slice_type: str) -> float:
        """Frame-level clipQscale: raise QP until the predicted frame
        size keeps the buffer above 50% of one frame's budget; lower
        bound against overflow (buffer full -> allow lower QP)."""
        pred = self.pred[slice_type if slice_type in "IPb" else "B"]
        cplx = self._frame_complexity()
        self._used_satd = cplx
        for _ in range(16):
            bits = pred.predict(qp_to_qscale(qp), cplx)
            if self.buffer_fill + self.buffer_rate - bits >= \
                    0.5 * self.buffer_rate or qp >= 51.0:
                break
            qp += 1.0
        # overflow guard: if buffer would overflow, drop QP to spend
        for _ in range(16):
            bits = pred.predict(qp_to_qscale(qp), cplx)
            if self.buffer_fill + self.buffer_rate - bits \
                    <= self.buffer_size or qp <= 1.0:
                break
            qp -= 1.0
        return qp

    # ------------------------------------------------------------------
    def update(self, bits: int, slice_type: str, qp: int) -> None:
        self.frames += 1
        self.actual_bits += bits
        if self.pass_num == 2:
            if self._plan_idx < len(self._plan):
                self._planned_so_far += self._plan[self._plan_idx]["bits"]
            self._plan_idx += 1
        if self.mode == "abr" or self.pass_num == 2:
            self.wanted_bits += self.target_per_frame
            if slice_type == "P":
                self.last_qp = qp
            if self._last_rceq is not None:
                # P-equivalent qscale: undo the per-type offset so the
                # rate factor is type-neutral (x265 keeps cplxrSum in
                # P units)
                qpp = qp + {"I": self.ip_offset, "B": -0.5 *
                            self.pb_offset, "b": -self.pb_offset} \
                    .get(slice_type, 0.0)
                self.cplxr_sum = self.cplxr_sum * self.cbr_decay + \
                    bits * qp_to_qscale(qpp) / self._last_rceq
                self.wanted_bits_window = \
                    self.wanted_bits_window * self.cbr_decay + \
                    self.target_per_frame
                self._last_rceq = None
        if self.vbv:
            t = slice_type if slice_type in "IPb" else "B"
            cplx = self._used_satd if self._used_satd is not None \
                else self._frame_complexity()
            self._used_satd = None
            self.pred[t].update(qp_to_qscale(qp), cplx, bits)
            fill_raw = self.buffer_fill + self.buffer_rate - bits
            self.min_fill_preclamp = min(self.min_fill_preclamp,
                                         fill_raw)
            if fill_raw < 0:
                self.underflow_events += 1
            self.buffer_fill = min(max(fill_raw, 0.0),
                                   self.buffer_size)
        if self.pass_num == 1:
            self._pass1_log.append(dict(
                type=slice_type, qp=qp, bits=bits))

    def write_stats(self) -> None:
        """Pass-1 stats file (reference writeRateControlFrameStats)."""
        if self.pass_num != 1:
            return
        with open(self.stats_path, "w") as f:
            for i, e in enumerate(self._pass1_log):
                f.write(f"in:{i} out:{i} type:{e['type']} "
                        f"q:{e['qp']:.2f} bits:{e['bits']}\n")

    def summary(self) -> dict:
        out = {
            "mode": self.mode if self.pass_num == 0
            else f"2pass-p{self.pass_num}",
            "actual_kbps": self.actual_bits * self.fps
            / max(self.frames, 1) / 1000.0,
        }
        if self.vbv:
            out["vbv_fill"] = self.buffer_fill / self.buffer_size
        return out
