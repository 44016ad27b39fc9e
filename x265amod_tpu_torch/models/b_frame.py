"""The flat CTB16 B frame on the card: the port of the JAX package's
`models/b_frame.py:BFrameEncoder` (one reference per list, CTU = CU = TU =
16), with the B frame result record the CTU32 tree shares.

The P frame's phases (`models/inter_frame.py`) with two lists, as the JAX
`_encode` (:124) runs them:

1. ME on both references (:156-172): K5 with the argmin folded in, K6.
2. The L0, L1 and bi trials (:175-191): K7 per list, K9 `mc_bi` for the
   bi-prediction (14-bit combine), K2 with inter rounding and no SBH, K3 at
   B states; the intra trial (:193-217) at B states.
3. The decide scan (:242-390): K25 (`ops/decide_flat.py`, one launch a
   frame) on the card, its plain version on the CPU.
4. The final MC select (:404-439): each list's uni prediction (K7) or the
   bi-prediction (K9), for luma and chroma; K2 with SBH; skip cells code no
   residual.
5. The commit scan (:441-549): K23 with the kinds, at B states.
6. The loop filter with the directions and both lists' MVs (:562-588; K21,
   K4), SAO at CTU 16, metrics, the level pack.

`BFrameResult.modes` holds 1 on inter cells (JAX keeps the commit's argmin
there, which no syntax reads).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.decide_flat import KIND_OF_CHOICE_B, decide_b
from ..ops.estbits import tu_bits
from ..ops.me import check_window, mc_bi, mc_luma_qpel, mc_select
from ..ops.residual import residual_chain
from .inter_frame import FlatInterBase, sao_of_host


@dataclass
class BFrameResult:
    kinds: np.ndarray        # [h16, w16] 0 skip, 1 inter (AMVP), 2 intra
    merge_idx: np.ndarray    # [h16, w16]
    inter_dir: np.ndarray    # [h16, w16] 1 L0, 2 L1, 3 bi (0 intra)
    mvd0: np.ndarray         # [h16, w16, 2] qpel
    mvp0: np.ndarray         # [h16, w16]
    mvd1: np.ndarray
    mvp1: np.ndarray
    modes: np.ndarray        # [h16, w16] intra modes (1 on inter cells)
    levels_y: np.ndarray     # [h16, w16, 16, 16]
    levels_cb: np.ndarray    # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray          # [4] luma/cb/cr SSE, luma SSIM
    recon_dev: tuple         # device recon planes (post-SAO)
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    split: np.ndarray | None = None      # [hc32, wc32]; None: flat CTB16
    # SAO parameters per CTU (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None


class BFrameEncoder(FlatInterBase):
    """Per-resolution flat CTB16 B-frame encoder on one device."""

    ST = "B"

    def _phase1(self, y, refs_y, maps, excess):
        """ME on both lists, the L0, L1 and bi trials and the intra trial
        (JAX :148-217): the decide scan's inputs, raster: grids (grid0,
        grid1) [n, S, S], d and rb [n, 3] (L0, L1, bi), di [n], mv_me (mv0,
        mv1) [n, 2].  K9's window check is appended to ``excess``."""
        oy, oy_flat = self._cur(y)
        lam, qp = maps["lam"].reshape(-1), maps["qp"].reshape(-1)
        (g0, mv0), (g1, mv1) = (self._motion(oy_flat, r, lam)
                                for r in refs_y)
        pred = torch.stack([
            mc_luma_qpel(refs_y[0], mv0, 16), mc_luma_qpel(refs_y[1], mv1, 16),
            mc_bi(refs_y[0], refs_y[1], mv0, mv1, 16, False, self.sr + 2,
                  excess)], 1)
        lv, _, ssd = residual_chain(oy_flat, pred, qp, False,
                                    want_recon=False, intra=False)
        return dict(grids=(g0, g1), d=ssd.to(torch.float32),
                    rb=tu_bits(lv, 0, qp[:, None].expand(-1, 3), "B"),
                    mv_me=(mv0, mv1), di=self._intra_trial(oy, oy_flat, maps))

    def _decide(self, st1, maps, dsf, forced=None, want_costs=False):
        """K25 on the card, its plain version on the CPU."""
        lam = maps["lam"].reshape(-1)
        if forced is not None:
            return decide_b(self.sch, None, None, None, None, None, lam,
                            self.sr, dsf, self.hdr_bits, forced=forced)
        return decide_b(self.sch, st1["grids"], st1["d"], st1["rb"],
                        st1["di"], st1["mv_me"], lam, self.sr, dsf,
                        self.hdr_bits, want_costs=want_costs)

    def _final_mc(self, refs0, refs1, dec, excess):
        """`mc_select` (JAX :407-418) at the decided motion."""
        return mc_select(refs0, refs1, dec["dir"], dec["mv0"], dec["mv1"],
                         self.sr, excess)

    def _step(self, y, cb, cr, ref0, ref1, qp: int, dsf, forced=None,
              want_recon=False, qp_offsets=None):
        """One B frame on the device between ``ref0`` and ``ref1`` (y, cb,
        cr planes) with the scale factors dsf = (dsf0, dsf1)."""
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        ref0 = tuple(t.to(torch.int32) for t in ref0)
        ref1 = tuple(t.to(torch.int32) for t in ref1)
        excess = []             # K9's window checks, read in collect
        st1 = None if forced is not None else self._phase1(
            y, (ref0[0], ref1[0]), maps, excess)
        dec = self._decide(st1, maps, dsf, forced)
        choice = dec["choice"]
        kinds = torch.tensor(KIND_OF_CHOICE_B, device=y.device)[choice]
        rec, lv = self._final_code(y, cb, cr, self._final_mc(
            ref0, ref1, dec, excess), maps, kinds)
        rec, levels, modes, sse, sao = self._commit_and_filter(
            (y, cb, cr), rec, lv, kinds, (dec["dir"], dec["mv0"],
                                          dec["mv1"]), maps, qp)
        hc, wc = self.hc, self.wc
        out, rec8 = self._outputs(rec, levels, modes, sse, sao, want_recon)

        def cells(t, dt, *shape):
            return t.reshape((hc, wc) + shape).to(dt)
        out.update(kinds=cells(kinds, torch.uint8),
                   merge=cells(torch.clamp(choice, max=1), torch.uint8),
                   dir=cells(dec["dir"], torch.uint8),
                   mvd0=cells(dec["mvd0"], torch.int16, 2),
                   mvp0=cells(dec["mvp0"], torch.uint8),
                   mvd1=cells(dec["mvd1"], torch.int16, 2),
                   mvp1=cells(dec["mvp1"], torch.uint8),
                   window_excess=torch.stack(excess).amax())
        return out, rec8

    def encode_async(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                     dsf0: int, dsf1: int, want_recon=False, qp_offsets=None):
        """Dispatch one B frame (numpy uint8 planes) between the references'
        device planes; dsf0 / dsf1 scale a neighbour's other-list MV to list
        0 / 1.  Returns a handle."""
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), ref0_dev, ref1_dev, qp,
                              (int(dsf0), int(dsf1)), want_recon=want_recon,
                              qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def encode_async_load(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                          dsf0: int, dsf1: int, kinds, merge_idx, inter_dir,
                          mvd0, mvp0, mvd1, mvp1, want_recon=False,
                          qp_offsets=None):
        """One B frame under given decisions (as `BFrameResult` carries
        them), replayed by K25's forced mode (the plain scan on the CPU);
        the commit decides the intra modes."""
        def t(a, dt=np.int64):
            return self._upload(np.asarray(a, dt))
        kinds, merge, idir = (t(a).reshape(-1) for a in (kinds, merge_idx,
                                                         inter_dir))
        choice = torch.where(kinds == 0, merge,
                             torch.where(kinds == 1, 1 + idir, 5))
        forced = (choice, t(mvd0, np.int32).reshape(-1, 2),
                  t(mvp0, np.int32).reshape(-1),
                  t(mvd1, np.int32).reshape(-1, 2),
                  t(mvp1, np.int32).reshape(-1))
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), ref0_dev, ref1_dev, qp,
                              (int(dsf0), int(dsf1)), forced=forced,
                              want_recon=want_recon, qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def collect(self, handle) -> BFrameResult:
        h, lv = self._host(handle)
        check_window(h.pop("window_excess"))

        def i32(k):
            return h[k].astype(np.int32)
        res = BFrameResult(
            i32("kinds"), i32("merge"), i32("dir"), i32("mvd0"), i32("mvp0"),
            i32("mvd1"), i32("mvp1"), i32("modes"), *lv, h["sse"],
            recon_dev=handle["recon_dev"], sao=sao_of_host(h))
        if "rec_y" in h:
            res.recon_y, res.recon_cb, res.recon_cr = (
                h["rec_y"], h["rec_cb"], h["rec_cr"])
        return res
