"""The flat CTB16 P frame on the card: the port of the JAX package's
`models/inter_frame.py:InterFrameEncoder` (its `Param` default, `ctu_size`
16, with P frames), with the P frame result record the CTU32 tree shares
and the phases the flat B frame (`models/b_frame.py`) shares.

One device step codes one P frame against one reference, CTU = CU = TU = 16,
as the JAX `_encode` (:137) does:

1. ME (:159-179): the integer SSD grid of every CTU over +-sr and its
   cost argmin (XLA's FMA) in one K5 launch (`me_ssd_grid_mv`, the argmin
   folded into K5's epilogue), the +-2 quarter-pel refinement when subme
   >= 1 (K6).
2. The inter trial at the ME MV (:182-190): K7 `mc_luma_qpel`, K2 with inter
   rounding and no SBH, K3 `tu_bits` at P states.
3. The intra trial on SOURCE references (:193-218): all 35 modes through K1
   `predict`, K2 (intra rounding, no SBH) and K3; the cost
   fma(lam, rb + 6, ssd) (XLA's contraction), its minimum over the modes.
   The 35 x n blocks run as three launches over the whole frame (at 1088p
   about 292 MB of int32 predictions, which the card holds): the trial
   reads no reconstruction, so it needs no wavefront.
4. The decide scan (:220-315): K24 (`ops/decide_flat.py`, one launch a
   frame) on the card, its plain version on the CPU.
5. Final MC and residuals (:324-348): K7 for luma and chroma at the final
   MVs, K2 with inter rounding and SBH; skip cells code no residual.
6. The commit scan (:350-459): K23 with the frame's kinds (only the intra
   CTUs get tickets) re-codes the intra CTUs from the true reconstruction
   (35-mode RD at P states, DM chroma); the inter recon and levels are
   written first, so each intra CTU reads final neighbours.
7. The loop filter (:472-501: K21's flat P/B maps, K4), SAO at CTU 16 (K10,
   K11), SSE and SSIM (K22); the D2H packs the levels (K15).

JAX returns the commit's argmin mode on inter cells too; no syntax reads
it (the serializer gates on kind 2), so `InterFrameResult.modes` holds 1
there.  The forced mode (`encode_async_load`) replays kinds, merge indices,
MVDs and MVP indices through the same candidate derivation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.deblock import deblock_frame_planes
from ..ops.decide_flat import KIND_OF_CHOICE_P, Schedule, decide_p
from ..ops.estbits import intra_hdr_bits, tu_bits
from ..ops.intra import predict
from ..ops.me import (mc_chroma_qpel, mc_luma_qpel, me_ssd_grid_mv,
                      subpel_refine)
from ..ops.metrics import frame_metrics
from ..ops.pack import (levels_for_host, levels_from_host,
                        start_host_copy)
from ..ops.rdoq import fma32
from ..ops.residual import residual_chain
from ..ops.sao import sao_filter_frame
from .intra_frame import IntraFrameEncoder, _blocks, _unblocks, flat_maps

MAX_MERGE = 2   # five_minus_max_num_merge_cand = 3 in the slice header


@dataclass
class InterFrameResult:
    kinds: np.ndarray        # [h16, w16] 0 skip, 1 inter (AMVP), 2 intra
    merge_idx: np.ndarray    # [h16, w16]
    mvd: np.ndarray          # [h16, w16, 2] qpel
    mvp_idx: np.ndarray      # [h16, w16]
    modes: np.ndarray        # [h16, w16] intra modes (1 on inter cells)
    levels_y: np.ndarray     # [h16, w16, 16, 16]
    levels_cb: np.ndarray    # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray          # [4] luma/cb/cr SSE, luma SSIM
    recon_dev: tuple         # device recon planes (the next reference)
    recon_y: np.ndarray | None = None
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    split: np.ndarray | None = None      # [hc32, wc32]; None: flat CTB16
    ref0: np.ndarray | None = None       # [h16, w16] L0 ref_idx (all 0)
    # SAO parameters per CTU (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None


def intra_trial_cost(ssd, rb, lam):
    """The intra trial's estimate [n] from the SSD [n, 35] (int) and rate
    [n, 35] of every mode and lambda [n]: min over modes of ``ssd + lam *
    (rb + 6)`` (JAX :212-216) as XLA's CPU code forms it, the product and
    the add fused, fma(lam, rb + 6, ssd)."""
    return fma32(lam[:, None], rb + 6.0, ssd.to(torch.float32)).amin(1)


def sao_of_host(host):
    """The ten SAO parameter arrays of a collected frame, or None."""
    return tuple(host[f"sao{k}"] for k in range(10)) if "sao0" in host \
        else None


class FlatInterBase:
    """What the flat P and B frames share: geometry and wavefront, the QP
    maps, the ME of one reference, the intra trial, the final coding, the
    commit scan (K23 through an `IntraFrameEncoder` of the same size), the
    loop filter, SAO, metrics and the D2H."""

    ST = "P"

    def __init__(self, width: int, height: int, deblock: bool = True,
                 sao: bool = False, search_range: int = 16, subme: int = 2,
                 sign_hide: bool = True, device="cuda"):
        if width % 16 or height % 16:
            raise ValueError("caller pads to a CTU16 multiple")
        if not 4 <= search_range <= 32:
            raise ValueError("dense-grid ME range must be 4..32")
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                               "plain PyTorch versions of the kernels")
        self.width, self.height = width, height
        self.deblock, self.sao, self.sbh = deblock, sao, sign_hide
        self.sr, self.subme = int(search_range), int(subme)
        self.wc, self.hc = width // 16, height // 16
        self.sch = Schedule(self.wc, self.hc, self.device)
        self.diags = self.sch.diags
        self.hdr_bits = float(np.float32(intra_hdr_bits(self.ST)))
        self._maps_cache: dict = {}
        self._scan = IntraFrameEncoder(width, height, deblock=False,
                                       sign_hide=sign_hide, device=device)

    def _maps(self, qp: int, qp_offsets=None):
        return flat_maps(self._maps_cache, qp, qp_offsets, self.hc, self.wc,
                         self.device)

    def _upload(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _cur(self, y):
        """The frame's CTU16 blocks [hc, wc, 16, 16] and [n, 16, 16]."""
        oy = _blocks(y[None], 16)[0]
        return oy, oy.reshape(-1, 16, 16)

    # ---- phase 1 ---------------------------------------------------------

    def _motion(self, oy_flat, ref_y, lam):
        """ME against one reference (JAX :159-179): the SSD grid [n, S, S]
        and the ME MV [n, 2] in quarter-pel (K5 with the argmin folded in,
        then K6 when subme >= 1)."""
        grid, mvi = me_ssd_grid_mv(oy_flat, ref_y, self.sr, 16, lam)
        mv = subpel_refine(ref_y, oy_flat, mvi, lam, 16)[0] \
            if self.subme >= 1 else mvi * 4
        return grid, mv

    def _intra_trial(self, oy, oy_flat, maps):
        """The intra estimate of every CTU on source references (JAX
        :193-217): frame-border availability, no below-left; all 35 modes
        through K1, K2 (intra rounding, no SBH) and K3 at the slice type's
        states; min over modes of fma(lam, rb + 6, ssd).  Returns [n] f32."""
        hc, wc = self.hc, self.wc
        n = hc * wc
        dev = oy.device
        i = torch.arange(n, device=dev)
        cy, cx = i // wc, i % wc
        cyu = torch.clamp(cy - 1, min=0)
        cxl = torch.clamp(cx - 1, min=0)
        cxr = torch.clamp(cx + 1, max=wc - 1)
        top = torch.cat([oy[cyu, cx, 15, :], oy[cyu, cxr, 15, :]], 1)
        left0 = oy[cy, cxl, :, 15]

        def bc(flag):
            return flag[:, None].expand(-1, 16)
        refs = (top, torch.cat([left0, left0], 1), oy[cyu, cxl, 15, 15],
                torch.cat([bc(cy > 0), bc((cy > 0) & (cx < wc - 1))], 1),
                torch.cat([bc(cx > 0), bc(cx < 0)], 1), (cx > 0) & (cy > 0))
        modes = torch.arange(35, device=dev)[None].expand(n, 35)
        qp = maps["qp"].reshape(-1)
        lv, _, ssd = residual_chain(oy_flat, predict(*refs, modes, 16, 0), qp,
                                    False, want_recon=False)
        rb = tu_bits(lv, 0, qp[:, None].expand(-1, 35), self.ST)
        return intra_trial_cost(ssd, rb, maps["lam"].reshape(-1))

    # ---- phases 5-7 --------------------------------------------------------

    def _final_code(self, y, cb, cr, preds, maps, kinds):
        """Residuals of the final predictions (JAX :328-348): K2 with inter
        rounding and SBH; skip cells code no residual and keep the
        prediction.  Returns (recon planes [1, ...], levels [1, hc, wc,
        ...])."""
        hc, wc = self.hc, self.wc
        n = hc * wc
        qp, qc = maps["qp"].reshape(-1), maps["qc"].reshape(-1)
        skip = (kinds == 0)[:, None, None]
        oy = _blocks(y[None], 16).reshape(n, 16, 16)
        oc = torch.cat([_blocks(cb[None], 8).reshape(n, 8, 8),
                        _blocks(cr[None], 8).reshape(n, 8, 8)])
        pc = torch.cat([preds[1], preds[2]])
        lv_y, rec_y, _ = residual_chain(oy, preds[0][:, None], qp, self.sbh,
                                        intra=False)
        lv_c, rec_c, _ = residual_chain(oc, pc[:, None], torch.cat([qc, qc]),
                                        self.sbh, intra=False)
        lv_y = torch.where(skip, 0, lv_y[:, 0])
        rec_y = torch.where(skip, preds[0], rec_y[:, 0])
        skip2 = torch.cat([skip, skip])
        lv_c = torch.where(skip2, 0, lv_c[:, 0])
        rec_c = torch.where(skip2, pc, rec_c[:, 0])
        rec = (_unblocks(rec_y.reshape(1, hc, wc, 16, 16)),
               _unblocks(rec_c[:n].reshape(1, hc, wc, 8, 8)),
               _unblocks(rec_c[n:].reshape(1, hc, wc, 8, 8)))
        lv = (lv_y.reshape(1, hc, wc, 16, 16).to(torch.int16),
              lv_c[:n].reshape(1, hc, wc, 8, 8).to(torch.int16),
              lv_c[n:].reshape(1, hc, wc, 8, 8).to(torch.int16))
        return rec, lv

    def _commit_and_filter(self, src, rec, lv, kinds, motion, maps, qp):
        """The commit scan (K23 with the kinds) then the loop filter (K21's
        flat P/B maps from kinds and ``motion`` = (dir or None, mv0, mv1 or
        None) [n(, 2)], K4), SAO at CTU 16 and the metrics (K22).  Returns
        the final recon planes [H, W] (int32), the levels [hc, wc, ...], the
        modes [hc, wc], SSE/SSIM [4] and the SAO outputs."""
        y, cb, cr = (t[None] for t in src)
        hc, wc = self.hc, self.wc
        k3 = kinds.reshape(1, hc, wc)
        ry, rcb, rcr, ly, lcb, lcr, modes = self._scan._scan(
            y, cb, cr, maps, inter=(k3, rec, lv, self.ST))
        if self.deblock:
            inter = (k3,) + tuple(None if t is None else t.reshape(
                (1, hc, wc) + t.shape[1:]) for t in motion) + (None,)
            ry, rcb, rcr = deblock_frame_planes(
                ry, rcb, rcr, (ly, lcb, lcr), maps["qp"], qp, inter=inter)
        sao = {}
        if self.sao:
            (r0, r1, r2), par = sao_filter_frame(
                y[0], cb[0], cr[0], ry[0], rcb[0], rcr[0], maps["lam"],
                ctu=16)
            ry, rcb, rcr = r0[None], r1[None], r2[None]
            sao = {f"sao{k}": t for k, t in enumerate(par)}
        sse = frame_metrics((y, cb, cr), (ry, rcb, rcr))[0]
        return ((ry[0], rcb[0], rcr[0]), (ly[0], lcb[0], lcr[0]), modes[0],
                sse, sao)

    def _outputs(self, rec, levels, modes, sse, sao, want_recon):
        out = dict(modes=modes.to(torch.uint8), ly=levels[0], lcb=levels[1],
                   lcr=levels[2], sse=sse, **sao)
        rec8 = tuple(t.to(torch.uint8) for t in rec)
        if want_recon:
            out.update(rec_y=rec8[0], rec_cb=rec8[1], rec_cr=rec8[2])
        return out, rec8

    # ---- host interface ------------------------------------------------------

    def _to_host(self, dev: dict, recon_dev):
        """Pack the frame's levels (K15, cap T / 8, the dense levels kept on
        the device in case the pack overflows), then start the D2H copy of
        every output (pinned memory, non-blocking on the card); the recon
        planes stay on the device as the next reference."""
        dense = [dev.pop(k)[None] for k in ("ly", "lcb", "lcr")]
        dev.update(levels_for_host(dense, 8))
        return dict(recon_dev=recon_dev, dense=dense,
                    **start_host_copy(dev, self.device))

    @staticmethod
    def wait(handle) -> None:
        if handle["event"] is not None:
            handle["event"].synchronize()

    def _host(self, handle):
        self.wait(handle)
        h = {k: v.numpy() for k, v in handle["host"].items()}
        return h, levels_from_host(h, 0, handle["dense"])


class InterFrameEncoder(FlatInterBase):
    """Per-resolution flat CTB16 P-frame encoder on one device."""

    ST = "P"

    def _phase1(self, y, ref_y, maps):
        """ME, inter trial and intra trial (JAX :159-218): the decide scan's
        inputs, raster: grid [n, S, S], d, rb, di [n] f32, mv_me [n, 2]."""
        oy, oy_flat = self._cur(y)
        lam, qp = maps["lam"].reshape(-1), maps["qp"].reshape(-1)
        grid, mv_me = self._motion(oy_flat, ref_y, lam)
        lv, _, ssd = residual_chain(oy_flat, mc_luma_qpel(ref_y, mv_me, 16)
                                    [:, None], qp, False, want_recon=False,
                                    intra=False)
        return dict(grid=grid, d=ssd[:, 0].to(torch.float32),
                    rb=tu_bits(lv[:, 0], 0, qp, "P"), mv_me=mv_me,
                    di=self._intra_trial(oy, oy_flat, maps))

    def _decide(self, st1, maps, forced=None, want_costs=False):
        """K24 on the card, its plain version on the CPU."""
        lam = maps["lam"].reshape(-1)
        if forced is not None:
            return decide_p(self.sch, None, None, None, None, None, lam,
                            self.sr, self.hdr_bits, forced=forced)
        return decide_p(self.sch, st1["grid"], st1["d"], st1["rb"],
                        st1["di"], st1["mv_me"], lam, self.sr, self.hdr_bits,
                        want_costs=want_costs)

    @staticmethod
    def _final_mc(ref, mv):
        """The final uni predictions at the decided MVs (JAX :325-327):
        K7 for luma [n, 16, 16] and both chroma planes [n, 8, 8]."""
        return (mc_luma_qpel(ref[0], mv, 16), mc_chroma_qpel(ref[1], mv, 8),
                mc_chroma_qpel(ref[2], mv, 8))

    def _step(self, y, cb, cr, ref, qp: int, forced=None, want_recon=False,
              qp_offsets=None):
        """One P frame on the device against ``ref`` = (y, cb, cr) planes.
        Returns a dict of device tensors and the recon planes (uint8)."""
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        ref = tuple(t.to(torch.int32) for t in ref)
        st1 = None if forced is not None else self._phase1(y, ref[0], maps)
        dec = self._decide(st1, maps, forced)
        choice, mv = dec["choice"], dec["mv"]
        kinds = torch.tensor(KIND_OF_CHOICE_P, device=y.device)[choice]
        rec, lv = self._final_code(y, cb, cr, self._final_mc(ref, mv), maps,
                                   kinds)
        rec, levels, modes, sse, sao = self._commit_and_filter(
            (y, cb, cr), rec, lv, kinds, (None, mv, None), maps, qp)
        hc, wc = self.hc, self.wc
        out, rec8 = self._outputs(rec, levels, modes, sse, sao, want_recon)
        out.update(kinds=kinds.reshape(hc, wc).to(torch.uint8),
                   merge=torch.clamp(choice, max=1).reshape(hc, wc)
                   .to(torch.uint8),
                   mvd=dec["mvd"].reshape(hc, wc, 2).to(torch.int16),
                   mvp=dec["mvp"].reshape(hc, wc).to(torch.uint8))
        return out, rec8

    def encode_async(self, y, cb, cr, ref_dev, qp: int, want_recon=False,
                     qp_offsets=None):
        """Dispatch one P frame (numpy uint8 planes) against the reference's
        device planes ``ref_dev`` = (y, cb, cr); with optional per-CTU16 QP
        offsets.  Returns a handle."""
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), ref_dev, qp,
                              want_recon=want_recon, qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def encode_async_load(self, y, cb, cr, ref_dev, qp: int, kinds,
                          merge_idx, mvd, mvp_idx, want_recon=False,
                          qp_offsets=None):
        """One P frame under given decisions (kinds, merge_idx, mvp_idx [hc,
        wc]; mvd [hc, wc, 2]), replayed by K24's forced mode (the plain
        scan on the CPU); the commit decides the intra modes."""
        kinds = self._upload(np.asarray(kinds, np.int64)).reshape(-1)
        merge = self._upload(np.asarray(merge_idx, np.int64)).reshape(-1)
        choice = torch.where(kinds == 0, merge,
                             torch.where(kinds == 1, 2, 3))
        forced = (choice, self._upload(np.asarray(mvd, np.int32))
                  .reshape(-1, 2),
                  self._upload(np.asarray(mvp_idx, np.int32)).reshape(-1))
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), ref_dev, qp, forced=forced,
                              want_recon=want_recon, qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def collect(self, handle) -> InterFrameResult:
        h, lv = self._host(handle)
        res = InterFrameResult(
            h["kinds"].astype(np.int32), h["merge"].astype(np.int32),
            h["mvd"].astype(np.int32), h["mvp"].astype(np.int32),
            h["modes"].astype(np.int32), *lv, h["sse"],
            recon_dev=handle["recon_dev"], sao=sao_of_host(h))
        if "rec_y" in h:
            res.recon_y, res.recon_cb, res.recon_cr = (
                h["rec_y"], h["rec_cb"], h["rec_cr"])
        return res
