"""The flat CTB16 all-intra encoder on the card: the port of the JAX
package's `models/intra_frame.py:IntraFrameEncoder` (its `Param` default,
`ctu_size` 16, and the only pipeline of `--lossless`), with the frame result
record and the CTU wavefront schedule the trees share.

One device step codes a batch of F frames (the encoder sends one):

1. The wavefront scan (JAX `_encode_frame` :183-236): CTUs on one
   anti-diagonal d = cx + 2 cy at a time, each from the reconstruction of
   its left, top, top-left and top-right neighbours (earlier diagonals).
   Per CTU: all 35 luma modes through the residual chain, SSD + lambda x
   (tu_bits + MPM bins) at I-slice states, the first minimum, then DM chroma
   at that mode.  On the card K23 `intra16_scan` (two launches a call: a
   ticket list, then clusters that take the CTUs in wavefront order and
   wait on their neighbours' done flags); on the CPU `_scan_plain`, a
   Python loop over the diagonals through K1 `predict`, K2
   `residual_chain` and K3 `tu_bits`.  The object code of
   XLA's argmin fusion for the scan (`iota_reduce_fusion`) has two
   vfmadd231ss: the cost, fma(lam, rbits + mbits, ssd), which the port forms
   the same way, and tu_bits' first step, cbf1 + (last-position bins) *
   last_bin, whose product is exact in f32 on every input, so K3's rounded
   form is the same value.  Under `--lossless` (transquant bypass) the levels
   are the residual, the recon is the source and the SSD 0 (:165-172).
2. The loop filter (:252-277): bS 2 on every CTB16 edge and the decoded QP
   chain per CTB16 (K21 `deblock_maps` on the card), then K4; SAO when
   enabled (:278-290) at CTU 16 luma and 8 chroma (K10, K11); SSE and SSIM
   (:291-296, K22 `frame_metrics`).
3. The D2H: the levels packed (K15), as the trees pack theirs; lossless
   levels copy dense (they overflow the pack).  With ``keep_recon`` (an IDR
   that seeds the P/B frames) the loop-filtered recon stays on the device.

The scan is also the commit scan of the flat P and B frames
(`models/inter_frame.py`, `models/b_frame.py`): given their kinds, only the
intra CTUs are coded, on the inter recon and levels already in place.

The recon lives in raster planes: JAX's block layout with a dummy row is a
TPU device, not a contract.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.commit import intra16_scan
from ..ops.deblock import deblock_frame_planes
from ..ops.estbits import tu_bits
from ..ops.intra import predict
from ..ops.metrics import frame_metrics
from ..ops.pack import (levels_for_host, levels_from_host,
                        start_host_copy)
from ..ops.quant import derive_qp_maps
from ..ops.rdoq import fma32
from ..ops.residual import residual_chain
from ..ops.sao import sao_filter_frame


def _diag_schedule(wc: int, hc: int):
    """Wavefront schedule: list of (cx, cy) cells per anti-diagonal
    d = cx + 2 * cy (each CTU sees its left, top, top-left and top-right
    neighbours on earlier diagonals)."""
    diags = []
    for d in range(wc - 1 + 2 * (hc - 1) + 1):
        lo = max(0, -(-(d - wc + 1) // 2))
        hi = min(hc - 1, d // 2)
        cells = [(d - 2 * cy, cy) for cy in range(lo, hi + 1)]
        if cells:
            diags.append(cells)
    return diags


@dataclass
class FrameResult:
    modes: np.ndarray          # [h16, w16]
    levels_y: np.ndarray       # [h16, w16, 16, 16]
    levels_cb: np.ndarray      # [h16, w16, 8, 8]
    levels_cr: np.ndarray
    sse: np.ndarray            # [4] luma/cb/cr SSE, luma SSIM
    recon_y: np.ndarray | None = None   # padded planes (uint8), opt-in
    recon_cb: np.ndarray | None = None
    recon_cr: np.ndarray | None = None
    # CU-quadtree split map [hc32, wc32] (None for the flat CTB16 frame);
    # unsplit CTUs replicate their mode over their four 16-cells and store
    # TU32 coefficient quadrants
    split: np.ndarray | None = None
    # SAO parameters per CTU (`ops.sao.sao_filter_frame` order), or None
    sao: tuple | None = None


def intra_mode_bits(left_mode):
    """MPM-biased mode signalling cost [B, 35] f32 from the left neighbour's
    mode [B] (JAX `models/intra_frame.py` :202-210 and
    `models/intra_tree.py:88`): 2 bins for the first MPM, 3 for the other
    two, 6 otherwise."""
    small = left_mode < 2
    mpm0 = torch.where(small, 0, left_mode)[:, None]
    mpm2 = torch.where(small, 26, 0)[:, None]
    m = torch.arange(35, device=left_mode.device)[None, :]
    return torch.where(m == mpm0, 2.0, torch.where(
        (m == 1) | (m == mpm2), 3.0, 6.0)).to(torch.float32)


def scan_cost(ssd, lam, mbits, rbits):
    """The scan's RD cost [B, 35] f32 (JAX `intra_frame.py` :211-213,
    ``ssd + lam * (rbits + mbits)``) as XLA's CPU code forms it: one FMA,
    fma(lam, mbits + rbits, ssd).  ssd [B, 35] int, lam [B] f32."""
    return fma32(lam[:, None], mbits + rbits, ssd.to(torch.float32))


def _blocks(plane, bn):
    """[F, H, W] -> [F, H/bn, W/bn, bn, bn] (a view)."""
    f, h, w = plane.shape
    return plane.reshape(f, h // bn, bn, w // bn, bn).permute(0, 1, 3, 2, 4)


def _unblocks(blocks):
    f, hb, wb, bn, _ = blocks.shape
    return blocks.permute(0, 1, 3, 2, 4).reshape(f, hb * bn, wb * bn)


def _bc(flag, n):
    return flag[:, None].expand(-1, n)


def flat_maps(cache: dict, qp: int, qp_offsets, hc: int, wc: int, device):
    """Per-CTU16 QP, chroma QP and lambda [hc, wc] on ``device`` (JAX
    `derive_qp_maps`, QG == CTB16), keys qp, qc, lam; uniform maps (no
    offsets) are kept in ``cache`` per QP."""
    if qp_offsets is None and qp in cache:
        return cache[qp]
    qpm, qc, _, lam = derive_qp_maps(qp, qp_offsets, hc, wc)
    maps = {k: torch.as_tensor(v, device=device)
            for k, v in dict(qp=qpm, qc=qc, lam=lam).items()}
    if qp_offsets is None:
        cache[qp] = maps
    return maps


class IntraFrameEncoder:
    """Per-resolution flat CTB16 wavefront encoder on one device."""

    CTU = 16

    def __init__(self, width: int, height: int, deblock: bool = True,
                 sign_hide: bool = True, sao: bool = False,
                 lossless: bool = False, device="cuda"):
        if width % 16 or height % 16:
            raise ValueError("caller pads to a CTU16 multiple")
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.deblock = deblock
        self.sao = sao
        self.lossless = lossless
        self.sbh = sign_hide and not lossless
        self.wc, self.hc = width // 16, height // 16
        self.diags = _diag_schedule(self.wc, self.hc)
        self._lanes: dict = {}
        self._maps_cache: dict = {}

    # ---- maps -------------------------------------------------------------

    def _maps(self, qp: int, qp_offsets=None):
        """Per-CTU16 QP, chroma QP and lambda [hc, wc] on the device (JAX
        `derive_qp_maps`); uniform maps are kept per QP."""
        return flat_maps(self._maps_cache, qp, qp_offsets, self.hc, self.wc,
                         self.device)

    # ---- the wavefront scan -------------------------------------------------

    def _scan(self, y, cb, cr, maps, inter=None):
        """The scan over F frames (int32 planes): on the card K23, on the CPU
        its plain version.  Returns the recon planes (before the loop
        filter, int32), the raster levels ly [F, hc, wc, 16, 16], lcb, lcr
        [F, hc, wc, 8, 8] (int16) and the modes [F, hc, wc] (int32).
        ``inter`` = (kinds [F, hc, wc], recon planes, levels, slice type):
        the commit scan of flat P/B frames, which codes only the kind-2 CTUs
        on the given inter recon and levels (updated in place on the card)
        and leaves mode 1 on every other CTU."""
        if self.device.type == "cpu":
            return self._scan_plain(y, cb, cr, maps, inter)
        return self._scan_kernel(y, cb, cr, maps, inter)

    def _scan_kernel(self, y, cb, cr, maps, inter=None):
        f = y.shape[0]
        dev = y.device
        if inter is not None:
            kinds, rec, lv, st = inter
            rec = tuple(t.to(torch.int32).contiguous() for t in rec)
            lv = tuple(t.to(torch.int16).contiguous() for t in lv)
            modes = torch.ones((f, self.hc, self.wc), dtype=torch.int32,
                               device=dev)
            intra16_scan((y, cb, cr), rec, lv, modes, maps, sbh=self.sbh,
                         kinds=kinds, st=st)
            return rec + lv + (modes,)
        rec = tuple(torch.empty_like(t, dtype=torch.int32)
                    for t in (y, cb, cr))
        lv = (torch.empty((f, self.hc, self.wc, 16, 16), dtype=torch.int16,
                          device=dev),
              torch.empty((f, self.hc, self.wc, 8, 8), dtype=torch.int16,
                          device=dev),
              torch.empty((f, self.hc, self.wc, 8, 8), dtype=torch.int16,
                          device=dev))
        modes = torch.empty((f, self.hc, self.wc), dtype=torch.int32,
                            device=dev)
        intra16_scan((y, cb, cr), rec, lv, modes, maps, sbh=self.sbh,
                     lossless=self.lossless)
        return rec + lv + (modes,)

    def _diag_lanes(self, f):
        """Per diagonal: (frame, cx, cy) index tensors of its lanes."""
        if f not in self._lanes:
            lanes = []
            for cells in self.diags:
                cxs = torch.as_tensor([c[0] for c in cells]).repeat(f)
                cys = torch.as_tensor([c[1] for c in cells]).repeat(f)
                fis = torch.arange(f).repeat_interleave(len(cells))
                lanes.append(tuple(t.to(self.device)
                                   for t in (fis, cxs, cys)))
            self._lanes[f] = lanes
        return self._lanes[f]

    def _refs(self, blocks, fi, cx, cy, n):
        """Raw refs of the lanes' n x n blocks from a recon state [F, hc,
        wc, n, n] with the flat grid's availability (JAX `gather_refs` and
        `substitute_refs` :144-155: left iff cx > 0, top iff cy > 0,
        top-right iff also cx < wc - 1, below-left never): K1's arguments."""
        wc = self.wc
        cyu = torch.clamp(cy - 1, min=0)
        cxl = torch.clamp(cx - 1, min=0)
        cxr = torch.clamp(cx + 1, max=wc - 1)
        left = blocks[fi, cy, cxl, :, n - 1]
        top = torch.cat([blocks[fi, cyu, cx, n - 1, :],
                         blocks[fi, cyu, cxr, n - 1, :]], 1)
        at_top, at_left = cy > 0, cx > 0
        off = torch.zeros_like(at_top)
        return (top, torch.cat([left, left], 1),
                blocks[fi, cyu, cxl, n - 1, n - 1],
                torch.cat([_bc(at_top, n), _bc(at_top & (cx < wc - 1), n)],
                          1),
                torch.cat([_bc(at_left, n), _bc(off, n)], 1),
                at_top & at_left)

    def _chain(self, orig, pred, qp):
        """Levels [B, K, n, n] int16, recon [B, K, n, n] int32 and SSD [B,
        K] int32 of predictions [B, K, n, n] (lossless: the residual, the
        source, 0)."""
        if self.lossless:
            lv = (orig[:, None] - pred).to(torch.int16)
            return (lv, orig[:, None].expand_as(pred).to(torch.int32),
                    torch.zeros(pred.shape[:2], dtype=torch.int32,
                                device=pred.device))
        return residual_chain(orig, pred, qp, self.sbh)

    def _scan_plain(self, y, cb, cr, maps, inter=None):
        """The scan as a Python loop over the diagonals (the plain version
        of K23); with ``inter``, over each diagonal's intra CTUs."""
        f = y.shape[0]
        dev = y.device
        hc, wc = self.hc, self.wc
        oy, ocb, ocr = _blocks(y, 16), _blocks(cb, 8), _blocks(cr, 8)
        st = "I"
        if inter is None:
            yb = torch.full((f, hc, wc, 16, 16), 128, dtype=torch.int32,
                            device=dev)
            cbb = torch.full((f, hc, wc, 8, 8), 128, dtype=torch.int32,
                             device=dev)
            crb = torch.full_like(cbb, 128)
            ly = torch.zeros((f, hc, wc, 16, 16), dtype=torch.int16,
                             device=dev)
            lcb = torch.zeros((f, hc, wc, 8, 8), dtype=torch.int16,
                              device=dev)
            lcr = torch.zeros_like(lcb)
        else:
            kinds, rec, lv, st = inter
            yb, cbb, crb = (_blocks(t.to(torch.int32), n).clone()
                            for t, n in zip(rec, (16, 8, 8)))
            ly, lcb, lcr = (t.to(torch.int16).clone() for t in lv)
        modes = torch.ones((f, hc, wc), dtype=torch.int32, device=dev)
        all35 = torch.arange(35, device=dev)[None]
        for fi, cx, cy in self._diag_lanes(f):
            if inter is not None:
                m = kinds[fi, cy, cx] == 2
                if not bool(m.any()):
                    continue
                fi, cx, cy = fi[m], cx[m], cy[m]
            nl = fi.shape[0]
            lane = torch.arange(nl, device=dev)
            qp, qc, lam = (maps[k][cy, cx] for k in ("qp", "qc", "lam"))
            orig = oy[fi, cy, cx]
            pred = predict(*self._refs(yb, fi, cx, cy, 16),
                           all35.expand(nl, 35), 16, 0)
            lv, rec, ssd = self._chain(orig, pred, qp)
            rbits = tu_bits(lv, 0, qp[:, None], st)
            left = torch.where(cx > 0, modes[fi, cy, torch.clamp(cx - 1,
                                                                 min=0)], 1)
            best = torch.argmin(scan_cost(ssd, lam, intra_mode_bits(left),
                                          rbits), 1)
            yb[fi, cy, cx] = rec[lane, best]
            ly[fi, cy, cx] = lv[lane, best]
            modes[fi, cy, cx] = best.to(torch.int32)
            for blocks, src, lout in ((cbb, ocb, lcb), (crb, ocr, lcr)):
                cpred = predict(*self._refs(blocks, fi, cx, cy, 8),
                                best[:, None], 8, 1)
                clv, crec, _ = self._chain(src[fi, cy, cx], cpred, qc)
                blocks[fi, cy, cx] = crec[:, 0]
                lout[fi, cy, cx] = clv[:, 0]
        return (_unblocks(yb), _unblocks(cbb), _unblocks(crb), ly, lcb, lcr,
                modes)

    # ---- one device step ------------------------------------------------------

    def _step(self, y, cb, cr, qp: int, want_recon=False, qp_offsets=None):
        """Scan + loop filter + SAO + metrics for y [F, H, W], cb/cr [F, H/2,
        W/2] (uint8) on the device, with the per-CTU16 QP offsets [hc, wc]
        of AQ when given.  Returns a dict of device tensors and the final
        recon planes (uint8)."""
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        rec_y, rec_cb, rec_cr, ly, lcb, lcr, modes = self._scan(y, cb, cr,
                                                                maps)
        if self.deblock:
            rec_y, rec_cb, rec_cr = deblock_frame_planes(
                rec_y, rec_cb, rec_cr, (ly, lcb, lcr), maps["qp"], qp)
        sao = {}
        if self.sao:
            res = [sao_filter_frame(y[i], cb[i], cr[i], rec_y[i], rec_cb[i],
                                    rec_cr[i], maps["lam"], ctu=16)
                   for i in range(y.shape[0])]
            rec_y, rec_cb, rec_cr = (torch.stack([r[0][k] for r in res])
                                     for k in range(3))
            sao = {f"sao{k}": torch.stack([r[1][k] for r in res])
                   for k in range(10)}
        sse = frame_metrics((y, cb, cr), (rec_y, rec_cb, rec_cr))
        out = dict(modes=modes.to(torch.uint8), ly=ly, lcb=lcb, lcr=lcr,
                   sse=sse, **sao)
        rec8 = tuple(t.to(torch.uint8) for t in (rec_y, rec_cb, rec_cr))
        if want_recon:
            out.update(rec_y=rec8[0], rec_cb=rec8[1], rec_cr=rec8[2])
        return out, rec8

    def _to_host(self, dev: dict, recon_dev=None):
        """Pack each frame's levels (K15; lossless levels stay dense), then
        start the D2H copy of every output (pinned memory, non-blocking on
        the card).  Returns a handle for `collect_batch`, with the device
        recon ``recon_dev`` when given (the DPB entry of an IDR)."""
        dense = [dev.pop(k) for k in ("ly", "lcb", "lcr")]
        if self.lossless:
            dev.update(ly=dense[0], lcb=dense[1], lcr=dense[2])
        else:
            dev.update(levels_for_host(dense, 16))
        return dict(dense=dense, recon_dev=recon_dev,
                    **start_host_copy(dev, self.device))

    def encode_batch_async(self, ys, cbs, crs, qp: int, want_recon=False,
                           qp_offsets=None):
        """Dispatch a batch of frames (numpy uint8 [F, H, W] and chroma
        planes) through one device step; returns a handle."""
        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a), device=self.device)
        out, _ = self._step(up(ys), up(cbs), up(crs), qp,
                            want_recon=want_recon, qp_offsets=qp_offsets)
        return self._to_host(out)

    def encode_async(self, y, cb, cr, qp: int, want_recon=False,
                     qp_offsets=None, keep_recon=False):
        """One frame (JAX `encode_async` :314): numpy planes in, a handle
        out; `collect` waits for it.  ``keep_recon`` leaves the recon planes
        (y, cb, cr) on the device as handle["recon_dev"], the reference of
        the P/B frames after an IDR."""
        def up(a):
            return torch.as_tensor(np.ascontiguousarray(a[None]),
                                   device=self.device)
        out, rec8 = self._step(up(y), up(cb), up(cr), qp,
                               want_recon=want_recon, qp_offsets=qp_offsets)
        return self._to_host(out, tuple(t[0] for t in rec8)
                             if keep_recon else None)

    @staticmethod
    def wait(handle) -> None:
        if handle["event"] is not None:
            handle["event"].synchronize()

    def collect_batch(self, handle) -> list[FrameResult]:
        self.wait(handle)
        h = {k: v.numpy() for k, v in handle["host"].items()}
        out = []
        for i in range(h["modes"].shape[0]):
            if self.lossless:
                lv = [h[k][i].astype(np.int32) for k in ("ly", "lcb", "lcr")]
            else:
                lv = levels_from_host(h, i, handle["dense"])
            res = FrameResult(h["modes"][i].astype(np.int32), *lv,
                              h["sse"][i])
            if "sao0" in h:
                res.sao = tuple(h[f"sao{k}"][i] for k in range(10))
            if "rec_y" in h:
                res.recon_y, res.recon_cb, res.recon_cr = (
                    h[k][i] for k in ("rec_y", "rec_cb", "rec_cr"))
            out.append(res)
        return out

    def collect(self, handle) -> FrameResult:
        """JAX `collect` :336."""
        return self.collect_batch(handle)[0]
