"""All-intra CTU32 quadtree encoder on the card: the port of the JAX
package's `models/intra_tree.py:IntraTreeEncoder` fast path.

A batch of F frames goes through two device phases:

1. Parallel estimate (`_estimate`, JAX `_estimate_frame`): on source-pixel
   references, every 16-cell and every CTU32 runs the 35-mode SATD scan
   (kernel K1 `satd35`), a top-4 shortlist, the residual chain of the four
   candidates (K1 `predict`, K2 `residual_chain`) and their bits (K3
   `tu_bits`).  It decides every split and intra mode.
2. Wavefront commit (`_commit`, JAX `_encode_frame` with forced
   `f_split`/`f_modes`): on the card K20 `commit_intra`, one launch per
   anti-diagonal of the CTU32 grid; on the CPU its plain version, a Python
   loop over the diagonals.  Each CTU replays its decisions on true
   reconstructed references: the CU32 chain, or the quadrants q0 -> q1 ->
   q2 -> q3, each on the earlier quadrants' reconstruction.  The plain
   version computes both hypotheses and the forced split selects, as the
   JAX package does; K20 codes only the selected one, whose outputs are
   the same.  With RDOQ on, the luma chains of the commit run K2's RDOQ
   stage (JAX `eval_intra_luma` :129-132 through the commit's partial
   :302-306); the chroma chains and the estimate run none, so RDOQ changes
   levels and recon, never a decision.  The loop filter (K4 `deblock`), SAO when
   enabled (K10 `sao_analyse`, K11 `sao_apply`, JAX `:638-650`) and
   SSE/SSIM follow; on the card the loop filter's maps are K21
   `deblock_maps` and SSE/SSIM K22 `frame_metrics`.

At bit depth 10 (Main10 all-intra, JAX `bit_depth=10`) the same flow runs
K1 and K2 at bit depth 10, the recon state starts at 512, and SSIM is not
computed (0.0, as in JAX :655).  The lambdas stay those of the 8-bit table,
as in the reference (`_maps` :812-815).

The JAX `vmap` over frames is the leading frame dimension here, and each
diagonal's lanes are (frame, CTU) pairs, so no dummy lanes are needed.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.commit import commit_intra
from ..ops.deblock import deblock_frame_planes
from ..ops.estbits import tu_bits
from ..ops.intra import predict, satd35
from ..ops.metrics import frame_metrics
from ..ops.pack import (levels_for_host, levels_from_host,
                        start_host_copy)
from ..ops.quant import chroma_qp_np, derive_qp_maps
from ..ops.residual import residual_chain
from ..ops.sao import sao_filter_frame
from ..utils.lambdas import lambda2_of
from .intra_frame import (FrameResult, _bc, _blocks, _diag_schedule,
                          _unblocks, intra_mode_bits)

# SATD-scan shortlist size for the full RD stage (JAX RD_CANDS)
RD_CANDS = 4


def intra_mode_bits_default() -> np.ndarray:
    """Mode signalling cost [35] with the left neighbour taken as DC (the
    estimate's MPM-biased proxy, JAX `intra_mode_bits(ones)`)."""
    return intra_mode_bits(torch.ones(1, dtype=torch.int32))[0].numpy()


def eval_luma(orig, refs, n, qpv, lamv, mbits, st: str = "I", bd: int = 8):
    """35-mode SATD scan, top-4 shortlist, RD on the shortlist (JAX
    `eval_intra_luma` :101 without SBH or RDOQ; tu_bits at slice type
    ``st``).  refs = raw (top, left, corner) + availability (K1's
    arguments).  Returns (best mode [B] int32, min cost [B] f32)."""
    sat = satd35(orig, *refs, n, 0, bit_depth=bd)
    # two separate rounded ops (no FMA), then a STABLE ascending sort:
    # jax.lax.top_k breaks ties to the lowest index
    scost = sat.to(torch.float32) + lamv[:, None] * mbits
    cand = torch.sort(scost, dim=1, stable=True).indices[:, :RD_CANDS]
    cpred = predict(*refs, cand, n, 0, bit_depth=bd)
    levels, _, ssd = residual_chain(orig, cpred, qpv, False,
                                    want_recon=False, bit_depth=bd)
    rb = tu_bits(levels, 0, qpv[:, None], st)
    mbk = torch.gather(mbits, 1, cand)
    cost = ssd.to(torch.float32) + lamv[:, None] * (rb + mbk)
    k = torch.argmin(cost, 1)
    best = torch.gather(cand, 1, k[:, None])[:, 0]
    return best.to(torch.int32), cost.amin(1)


def forced_chain(orig, refs, n, modes, qpv, c_idx, sbh, bd: int = 8,
                 lam=None, st: str = "I"):
    """Single-mode intra chain (JAX `eval_intra_luma`/`eval_intra_chroma`
    with a forced mode): the prediction at ``modes`` [B], then the residual
    chain with intra rounding, and RDOQ at slice type ``st`` with the
    per-block lambdas ``lam`` [B] when given.  Returns (levels [B,n,n]
    int16, recon [B,n,n] int32)."""
    pred = predict(*refs, modes[:, None], n, c_idx, bit_depth=bd)
    lv, rec, _ = residual_chain(orig, pred, qpv, sbh, bit_depth=bd,
                                rdoq=lam is not None, lam=lam, st=st,
                                c_idx=c_idx)
    return lv[:, 0], rec[:, 0]


def qp32_of(qp16: np.ndarray) -> np.ndarray:
    """CU32 QP from the four 16-cell QPs [h16, w16] -> [h16/2, w16/2] (JAX
    `qp32_of` :177): their mean rounded half to even by np.round (a mean
    of four integers can end in .5)."""
    h16, w16 = qp16.shape
    q = np.asarray(qp16).reshape(h16 // 2, 2, w16 // 2, 2) \
        .transpose(0, 2, 1, 3).reshape(h16 // 2, w16 // 2, 4)
    return np.round(q.mean(-1)).astype(np.int32)


def ctu_maps(qp: int, qp_offsets, h16: int, w16: int) -> dict:
    """Host QP/lambda maps of a CTU32-tree frame (JAX `_maps` of the intra
    and inter trees): the 16-cell QPs from `derive_qp_maps`, the CTU32 QP
    their `qp32_of`, its chroma QP and lambda, and the 16-cell maps as 2x2
    replications of the CTU32 ones (QG == CTB).  numpy, keys qp16, qc16,
    lam16 [h16, w16] and qp32, qc32, lam32 [h16/2, w16/2]."""
    qp16_raw = derive_qp_maps(qp, qp_offsets, h16, w16)[0]
    qp32 = qp32_of(qp16_raw)
    qc32 = chroma_qp_np(qp32)
    lam32 = lambda2_of(qp32).astype(np.float32)

    def rep(m):
        return np.repeat(np.repeat(m, 2, 0), 2, 1)
    return dict(qp16=rep(qp32), qc16=rep(qc32), lam16=rep(lam32), qp32=qp32,
                qc32=qc32, lam32=lam32)


class IntraTreeEncoder:
    """Per-resolution CTU32 quadtree wavefront encoder on one device."""

    CTU = 32

    def __init__(self, width: int, height: int, deblock: bool = True,
                 sign_hide: bool = True, sao: bool = False, device="cuda",
                 bit_depth: int = 8, rdoq: bool = False):
        if width % 32 or height % 32:
            raise ValueError("caller pads to a CTU32 multiple")
        if bit_depth not in (8, 10) or (bit_depth == 10 and (deblock or sao)):
            raise ValueError("bit depth 8, or 10 without loop filters")
        self.device = torch.device(device)
        self.bd = bit_depth
        self.rdoq = rdoq
        self.width, self.height = width, height
        self.deblock = deblock
        self.sao = sao
        self.sbh = sign_hide
        self.wc, self.hc = width // 32, height // 32
        self.w16, self.h16 = width // 16, height // 16
        self.diags = _diag_schedule(self.wc, self.hc)
        self._lanes: dict = {}
        self._maps_cache: dict = {}
        self._mbits = torch.as_tensor(intra_mode_bits_default(),
                                      device=self.device)

    # ---- maps -------------------------------------------------------------

    def _maps(self, qp: int, qp_offsets=None):
        """Per-16-cell and per-CTU32 QP/lambda maps on the device (JAX
        `_maps` :804): QG == CTB, so the 16-cell maps are 2x2 replications
        of the CTU32 maps.  Without offsets (CQP, no AQ) every map is
        uniform and kept per QP."""
        if qp_offsets is None and qp in self._maps_cache:
            return self._maps_cache[qp]
        maps = {k: torch.as_tensor(v, device=self.device) for k, v in
                ctu_maps(qp, qp_offsets, self.h16, self.w16).items()}
        if qp_offsets is None:
            self._maps_cache[qp] = maps
        return maps

    # ---- phase 1: parallel estimate ---------------------------------------

    def _src_refs(self, blocks):
        """Raw refs + availability of every cell of a [F, hg, wg, bn, bn]
        grid from source pixels, flattened frame-major to [F*hg*wg, ...]:
        frame-border availability, below-left taken available inside the
        frame (the commit applies exact z-scan availability)."""
        f, hg, wg, bn, _ = blocks.shape
        dev = blocks.device
        cyc = torch.arange(hg, device=dev)[:, None].expand(hg, wg)
        cxc = torch.arange(wg, device=dev)[None, :].expand(hg, wg)
        cyu = torch.clamp(cyc - 1, min=0)
        cxl = torch.clamp(cxc - 1, min=0)
        cxr = torch.clamp(cxc + 1, max=wg - 1)
        cyd = torch.clamp(cyc + 1, max=hg - 1)
        top = torch.cat([blocks[:, cyu, cxc, bn - 1, :],
                         blocks[:, cyu, cxr, bn - 1, :]], -1)
        left = torch.cat([blocks[:, cyc, cxl, :, bn - 1],
                          blocks[:, cyd, cxl, :, bn - 1]], -1)
        cor = blocks[:, cyu, cxl, bn - 1, bn - 1]
        cy1, cx1 = cyc.reshape(-1), cxc.reshape(-1)
        at = torch.cat([_bc(cy1 > 0, bn), _bc((cy1 > 0) & (cx1 < wg - 1),
                                              bn)], 1)
        al = torch.cat([_bc(cx1 > 0, bn), _bc((cx1 > 0) & (cy1 < hg - 1),
                                              bn)], 1)
        ac = (cx1 > 0) & (cy1 > 0)
        rep = (f, 1)
        return (top.reshape(-1, 2 * bn), left.reshape(-1, 2 * bn),
                cor.reshape(-1), at.repeat(rep), al.repeat(rep),
                ac.repeat(f))

    def _eval_chroma_est(self, ocb, ocr, refs_cb, refs_cr, n, qpv, best):
        """DM chroma chain for cb and cr stacked in one batch (c_idx 1 and
        2 are identical in every op).  Returns (ssd_cb, ssd_cr, bits_cb,
        bits_cr), each [B] f32."""
        b = ocb.shape[0]
        refs = [torch.cat([a, c], 0) for a, c in zip(refs_cb, refs_cr)]
        modes = torch.cat([best, best], 0)[:, None]
        qp2 = torch.cat([qpv, qpv], 0)
        pred = predict(*refs, modes, n, 1, bit_depth=self.bd)
        levels, _, ssd = residual_chain(torch.cat([ocb, ocr], 0), pred, qp2,
                                        False, want_recon=False,
                                        bit_depth=self.bd)
        rb = tu_bits(levels[:, 0], 1, qp2)
        sd = ssd[:, 0].to(torch.float32)
        return sd[:b], sd[b:], rb[:b], rb[b:]

    def _estimate(self, y, cb, cr, maps, want_costs=False):
        """Split [F, hc, wc] and modes16 [F, h16, w16] (int32) for a batch
        of frames y [F, H, W], cb/cr [F, H/2, W/2] (int32)."""
        f = y.shape[0]
        hc, wc, h16, w16 = self.hc, self.wc, self.h16, self.w16
        n16, n32 = f * h16 * w16, f * hc * wc
        mb16 = self._mbits[None].expand(n16, 35)
        mb32 = self._mbits[None].expand(n32, 35)

        # CU16 hypothesis per 16-cell
        oy = _blocks(y, 16)
        q16 = maps["qp16"].reshape(-1).repeat(f)
        qc16 = maps["qc16"].reshape(-1).repeat(f)
        lam16 = maps["lam16"].reshape(-1).repeat(f)
        best16, j16y = eval_luma(oy.reshape(n16, 16, 16),
                                 self._src_refs(oy), 16, q16, lam16, mb16,
                                 bd=self.bd)
        ocb, ocr = _blocks(cb, 8), _blocks(cr, 8)
        sdcb, sdcr, rbcb, rbcr = self._eval_chroma_est(
            ocb.reshape(n16, 8, 8), ocr.reshape(n16, 8, 8),
            self._src_refs(ocb), self._src_refs(ocr), 8, qc16, best16)
        j16 = j16y + sdcb + sdcr + lam16 * (rbcb + rbcr + 4.0)

        # CU32 hypothesis per CTU
        oy32 = _blocks(y, 32)
        q32 = maps["qp32"].reshape(-1).repeat(f)
        qc32 = maps["qc32"].reshape(-1).repeat(f)
        lam32 = maps["lam32"].reshape(-1).repeat(f)
        best32, jay = eval_luma(oy32.reshape(n32, 32, 32),
                                self._src_refs(oy32), 32, q32, lam32, mb32,
                                bd=self.bd)
        ocb16, ocr16 = _blocks(cb, 16), _blocks(cr, 16)
        sdacb, sdacr, rbacb, rbacr = self._eval_chroma_est(
            ocb16.reshape(n32, 16, 16), ocr16.reshape(n32, 16, 16),
            self._src_refs(ocb16), self._src_refs(ocr16), 16, qc32, best32)
        ja = jay + sdacb + sdacr + lam32 * (rbacb + rbacr + 4.0)

        # the four cells of a CTU summed in raster order, left to right
        q = j16.reshape(f, hc, 2, wc, 2)
        j_split = ((q[:, :, 0, :, 0] + q[:, :, 0, :, 1])
                   + q[:, :, 1, :, 0]) + q[:, :, 1, :, 1]
        ja = ja.reshape(f, hc, wc)
        split = (j_split < ja).to(torch.int32)
        b32rep = best32.reshape(f, hc, wc).repeat_interleave(2, 1) \
            .repeat_interleave(2, 2)
        srep = split.repeat_interleave(2, 1).repeat_interleave(2, 2)
        modes16 = torch.where(srep == 1, best16.reshape(f, h16, w16),
                              b32rep).to(torch.int32)
        if want_costs:
            return split, modes16, j_split, ja
        return split, modes16

    # ---- phase 2: wavefront commit ------------------------------------------

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

    def _chroma_pair(self, ocb, ocr, refs_cb, refs_cr, n, mode, qpv):
        b = ocb.shape[0]
        refs = [torch.cat([a, c], 0) for a, c in zip(refs_cb, refs_cr)]
        lv, rec = forced_chain(torch.cat([ocb, ocr], 0), refs, n,
                               torch.cat([mode, mode], 0),
                               torch.cat([qpv, qpv], 0), 1, self.sbh,
                               self.bd)
        return lv[:b], rec[:b], lv[b:], rec[b:]

    def _commit(self, y, cb, cr, maps, f_split, f_modes):
        """Forced-decision wavefront commit over F frames: on the card the
        launches of K20 (`commit_intra`, one a diagonal), on the CPU its
        plain version.  Returns recon planes (pre-loop-filter, int32) and
        the raster level / mode maps."""
        if self.device.type == "cpu":
            return self._commit_plain(y, cb, cr, maps, f_split, f_modes)
        return self._commit_kernel(y, cb, cr, maps, f_split, f_modes)

    def _commit_kernel(self, y, cb, cr, maps, f_split, f_modes):
        """The commit as K20 (`csrc/commit_intra.cu`): every CTU of the
        batch codes its CU32 or its four CU16s in place in raster planes;
        the same outputs as `_commit_plain`."""
        f = y.shape[0]
        h16, w16 = self.h16, self.w16
        dev = y.device
        rec = tuple(torch.empty_like(t, dtype=torch.int32)
                    for t in (y, cb, cr))
        lv = (torch.empty((f, h16, w16, 16, 16), dtype=torch.int16,
                          device=dev),
              torch.empty((f, h16, w16, 8, 8), dtype=torch.int16,
                          device=dev),
              torch.empty((f, h16, w16, 8, 8), dtype=torch.int16,
                          device=dev))
        commit_intra((y, cb, cr), rec, lv, f_modes, maps, split=f_split,
                     sbh=self.sbh, bit_depth=self.bd, rdoq=self.rdoq)
        srep = f_split.repeat_interleave(2, 1).repeat_interleave(2, 2)
        mode_a = f_modes[:, 0::2, 0::2].repeat_interleave(2, 1) \
            .repeat_interleave(2, 2)
        modes_out = torch.where(srep == 1, f_modes, mode_a).to(torch.int32)
        return rec + lv + (modes_out,)

    def _commit_plain(self, y, cb, cr, maps, f_split, f_modes):
        """The commit as a Python loop over the diagonals (the plain version
        of K20)."""
        f = y.shape[0]
        dev = y.device
        hc, wc, h16, w16 = self.hc, self.wc, self.h16, self.w16
        oy, ocb, ocr = _blocks(y, 16), _blocks(cb, 8), _blocks(cr, 8)
        oy32, ocb16, ocr16 = _blocks(y, 32), _blocks(cb, 16), _blocks(cr, 16)
        mid = 1 << (self.bd - 1)
        yb = torch.full((f, h16, w16, 16, 16), mid, dtype=torch.int32,
                        device=dev)
        cbb = torch.full((f, h16, w16, 8, 8), mid, dtype=torch.int32,
                         device=dev)
        crb = torch.full_like(cbb, mid)
        ly = torch.zeros((f, h16, w16, 16, 16), dtype=torch.int16,
                         device=dev)
        lcb = torch.zeros((f, h16, w16, 8, 8), dtype=torch.int16, device=dev)
        lcr = torch.zeros_like(lcb)
        modes_out = torch.zeros((f, h16, w16), dtype=torch.int32, device=dev)
        qp32, qc32 = maps["qp32"], maps["qc32"]
        qp16, qc16 = maps["qp16"], maps["qc16"]
        # RDOQ on the luma chains only (the JAX commit passes no lambda to
        # its chroma chains)
        lam32 = maps["lam32"] if self.rdoq else None
        lam16 = maps["lam16"] if self.rdoq else None

        for fi, cx, cy in self._diag_lanes(f):
            nl = fi.shape[0]
            bx, by = 2 * cx, 2 * cy
            at_top, at_left = cy > 0, cx > 0
            at_tr = (cy > 0) & (cx < wc - 1)
            one = torch.ones(nl, dtype=torch.bool, device=dev)
            zero = ~one
            byu = torch.clamp(by - 1, min=0)
            bxl = torch.clamp(bx - 1, min=0)
            bx2 = torch.clamp(bx + 2, max=w16 - 1)
            bx3 = torch.clamp(bx + 3, max=w16 - 1)

            def bot(s, r, c):           # bottom row of cell (r, c)
                return s[fi, r, c, -1, :]

            def rgt(s, r, c):           # right column of cell (r, c)
                return s[fi, r, c, :, -1]

            def crn(s, r, c):
                return s[fi, r, c, -1, -1]

            # ---- hypothesis A: one CU32 (TU32 luma, TU16 chroma) ----
            ac_a = at_top & at_left
            refs_a = (torch.cat([bot(yb, byu, bx), bot(yb, byu, bx + 1),
                                 bot(yb, byu, bx2), bot(yb, byu, bx3)], 1),
                      torch.cat([rgt(yb, by, bxl)] +
                                [rgt(yb, by + 1, bxl)] * 3, 1),
                      crn(yb, byu, bxl),
                      torch.cat([_bc(at_top, 32), _bc(at_tr, 32)], 1),
                      torch.cat([_bc(at_left, 32), _bc(zero, 32)], 1), ac_a)
            mode_a = f_modes[fi, by, bx]
            lva_y, rca_y = forced_chain(
                oy32[fi, cy, cx], refs_a, 32, mode_a, qp32[cy, cx], 0,
                self.sbh, self.bd,
                None if lam32 is None else lam32[cy, cx])

            def crefs_a(s):
                return (torch.cat([bot(s, byu, bx), bot(s, byu, bx + 1),
                                   bot(s, byu, bx2), bot(s, byu, bx3)], 1),
                        torch.cat([rgt(s, by, bxl)] +
                                  [rgt(s, by + 1, bxl)] * 3, 1),
                        crn(s, byu, bxl),
                        torch.cat([_bc(at_top, 16), _bc(at_tr, 16)], 1),
                        torch.cat([_bc(at_left, 16), _bc(zero, 16)], 1),
                        ac_a)
            lva_cb, rca_cb, lva_cr, rca_cr = self._chroma_pair(
                ocb16[fi, cy, cx], ocr16[fi, cy, cx], crefs_a(cbb),
                crefs_a(crb), 16, mode_a, qc32[cy, cx])

            # ---- hypothesis B: four CU16 quadrants in z-scan order ----
            def quad(r, c, top_y, left_y, cor_y, top_c, left_c, cor_c,
                     avt, avl, avc):
                """top_c/left_c/cor_c: functions of the chroma state
                (cb or cr) giving its raw refs."""
                mode = f_modes[fi, r, c]
                lv_y, rc_y = forced_chain(
                    oy[fi, r, c], (top_y, left_y, cor_y, avt, avl, avc), 16,
                    mode, qp16[r, c], 0, self.sbh, self.bd,
                    None if lam16 is None else lam16[r, c])
                avt8, avl8 = avt[:, ::2], avl[:, ::2]
                out_c = self._chroma_pair(
                    ocb[fi, r, c], ocr[fi, r, c],
                    (top_c(0), left_c(0), cor_c(0), avt8, avl8, avc),
                    (top_c(1), left_c(1), cor_c(1), avt8, avl8, avc), 8,
                    mode, qc16[r, c])
                return (mode, lv_y, rc_y) + out_c

            st = (cbb, crb)
            q0 = quad(by, bx,
                      torch.cat([bot(yb, byu, bx), bot(yb, byu, bx + 1)], 1),
                      torch.cat([rgt(yb, by, bxl), rgt(yb, by + 1, bxl)], 1),
                      crn(yb, byu, bxl),
                      lambda i: torch.cat([bot(st[i], byu, bx),
                                           bot(st[i], byu, bx + 1)], 1),
                      lambda i: torch.cat([rgt(st[i], by, bxl),
                                           rgt(st[i], by + 1, bxl)], 1),
                      lambda i: crn(st[i], byu, bxl),
                      torch.cat([_bc(at_top, 16), _bc(at_top, 16)], 1),
                      torch.cat([_bc(at_left, 16), _bc(at_left, 16)], 1),
                      at_top & at_left)
            rc0 = (q0[2], q0[4], q0[6])        # recon y, cb, cr
            q1 = quad(by, bx + 1,
                      torch.cat([bot(yb, byu, bx + 1), bot(yb, byu, bx2)],
                                1),
                      torch.cat([q0[2][:, :, -1], q0[2][:, :, -1]], 1),
                      crn(yb, byu, bx),
                      lambda i: torch.cat([bot(st[i], byu, bx + 1),
                                           bot(st[i], byu, bx2)], 1),
                      lambda i: torch.cat([rc0[1 + i][:, :, -1],
                                           rc0[1 + i][:, :, -1]], 1),
                      lambda i: crn(st[i], byu, bx),
                      torch.cat([_bc(at_top, 16), _bc(at_tr, 16)], 1),
                      torch.cat([_bc(one, 16), _bc(zero, 16)], 1), at_top)
            rc1 = (q1[2], q1[4], q1[6])
            q2 = quad(by + 1, bx,
                      torch.cat([q0[2][:, -1, :], q1[2][:, -1, :]], 1),
                      torch.cat([rgt(yb, by + 1, bxl),
                                 rgt(yb, by + 1, bxl)], 1),
                      crn(yb, by, bxl),
                      lambda i: torch.cat([rc0[1 + i][:, -1, :],
                                           rc1[1 + i][:, -1, :]], 1),
                      lambda i: torch.cat([rgt(st[i], by + 1, bxl),
                                           rgt(st[i], by + 1, bxl)], 1),
                      lambda i: crn(st[i], by, bxl),
                      torch.cat([_bc(one, 16), _bc(one, 16)], 1),
                      torch.cat([_bc(at_left, 16), _bc(zero, 16)], 1),
                      at_left)
            rc2 = (q2[2], q2[4], q2[6])
            q3 = quad(by + 1, bx + 1,
                      torch.cat([q1[2][:, -1, :], q1[2][:, -1, :]], 1),
                      torch.cat([q2[2][:, :, -1], q2[2][:, :, -1]], 1),
                      q0[2][:, -1, -1],
                      lambda i: torch.cat([rc1[1 + i][:, -1, :],
                                           rc1[1 + i][:, -1, :]], 1),
                      lambda i: torch.cat([rc2[1 + i][:, :, -1],
                                           rc2[1 + i][:, :, -1]], 1),
                      lambda i: rc0[1 + i][:, -1, -1],
                      torch.cat([_bc(one, 16), _bc(zero, 16)], 1),
                      torch.cat([_bc(one, 16), _bc(zero, 16)], 1), one)

            # ---- select by the forced split and scatter the four cells --
            sp = f_split[fi, cy, cx] == 1
            s3 = sp[:, None, None]
            for qi, qd in enumerate((q0, q1, q2, q3)):
                dy, dx = qi >> 1, qi & 1
                r, c = by + dy, bx + dx
                ys, xs = slice(16 * dy, 16 * dy + 16), \
                    slice(16 * dx, 16 * dx + 16)
                cys, cxs = slice(8 * dy, 8 * dy + 8), slice(8 * dx, 8 * dx + 8)
                yb[fi, r, c] = torch.where(s3, qd[2], rca_y[:, ys, xs])
                cbb[fi, r, c] = torch.where(s3, qd[4], rca_cb[:, cys, cxs])
                crb[fi, r, c] = torch.where(s3, qd[6], rca_cr[:, cys, cxs])
                ly[fi, r, c] = torch.where(s3, qd[1], lva_y[:, ys, xs])
                lcb[fi, r, c] = torch.where(s3, qd[3], lva_cb[:, cys, cxs])
                lcr[fi, r, c] = torch.where(s3, qd[5], lva_cr[:, cys, cxs])
                modes_out[fi, r, c] = torch.where(sp, qd[0], mode_a)

        return (_unblocks(yb), _unblocks(cbb), _unblocks(crb), ly, lcb, lcr,
                modes_out)

    # ---- one device step -----------------------------------------------------

    def _step(self, y, cb, cr, qp: int, split=None, modes=None,
              want_recon=False, qp_offsets=None):
        """Estimate (unless split/modes are given) + commit + loop filter +
        metrics for y [F, H, W], cb/cr [F, H/2, W/2] on the device, with
        the per-16-cell QP offsets [h16, w16] of AQ and CU-tree when given
        (one frame).  Returns a dict of device tensors."""
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        if split is None:
            split, modes = self._estimate(y, cb, cr, maps)
        rec_y, rec_cb, rec_cr, ly, lcb, lcr, modes_out = self._commit(
            y, cb, cr, maps, split, modes)
        if self.deblock:
            rec_y, rec_cb, rec_cr = deblock_frame_planes(
                rec_y, rec_cb, rec_cr, (ly, lcb, lcr), maps["qp32"], qp,
                split=split)
        sao = {}
        if self.sao:
            # per frame, on the deblocked recon; the filtered planes are the
            # frame's recon from here on (reference, metrics, output)
            res = [sao_filter_frame(y[i], cb[i], cr[i], rec_y[i], rec_cb[i],
                                    rec_cr[i], maps["lam32"])
                   for i in range(y.shape[0])]
            rec_y, rec_cb, rec_cr = (torch.stack([r[0][k] for r in res])
                                     for k in range(3))
            sao = {f"sao{k}": torch.stack([r[1][k] for r in res])
                   for k in range(10)}
        sse = frame_metrics((y, cb, cr), (rec_y, rec_cb, rec_cr),
                            ssim=self.bd == 8)
        out = dict(split=split.to(torch.int8),
                   modes=modes_out.to(torch.uint8), ly=ly, lcb=lcb, lcr=lcr,
                   sse=sse, **sao)
        if want_recon:
            # 10-bit recon travels as int16 (its values fit), read back on
            # the host as uint16
            odt = torch.uint8 if self.bd == 8 else torch.int16
            out.update(rec_y=rec_y.to(odt), rec_cb=rec_cb.to(odt),
                       rec_cr=rec_cr.to(odt))
        return out

    def _to_host(self, dev: dict):
        """Pack each frame's levels (K15, one launch for the batch; JAX
        :665-674, cap = T / 16), then start the D2H copy of every output but
        the dense levels (pinned memory, non-blocking on the card), which
        stay on the device for a frame whose pack overflows.  Returns a
        handle for `collect_batch`."""
        dense = [dev.pop(k) for k in ("ly", "lcb", "lcr")]
        dev.update(levels_for_host(dense, 16))
        return dict(dense=dense, **start_host_copy(dev, self.device))

    def _upload(self, a):
        """numpy planes to the device; 10-bit uint16 samples go up as int16
        bit patterns (equal values below 2^15), which torch handles
        everywhere."""
        a = np.ascontiguousarray(a)
        if a.dtype == np.uint16:
            a = a.view(np.int16)
        return torch.as_tensor(a, device=self.device)

    def encode_batch_async(self, ys, cbs, crs, qp: int, want_recon=False):
        """Dispatch a batch of frames (numpy uint8 [F, H, W], uint16 at bit
        depth 10, and chroma planes) through one device step; returns a
        handle."""
        return self._to_host(self._step(self._upload(ys), self._upload(cbs),
                                        self._upload(crs), qp,
                                        want_recon=want_recon))

    def encode_async(self, y, cb, cr, qp: int, want_recon=False,
                     keep_recon=False, qp_offsets=None):
        """One frame, estimate + commit.  ``keep_recon`` also leaves the
        loop-filtered recon planes on the device, as handle["recon_dev"]
        (uint8 [H, W], [H/2, W/2] x 2; int16 at bit depth 10): the
        reference of the next P frame (the JAX `_dispatch_entry` keeps
        `dev[4:7]`)."""
        out = self._step(self._upload(y[None]), self._upload(cb[None]),
                         self._upload(cr[None]), qp,
                         want_recon=want_recon or keep_recon,
                         qp_offsets=qp_offsets)
        rec = tuple(out[k][0] for k in ("rec_y", "rec_cb", "rec_cr")) \
            if keep_recon else None
        if not want_recon:
            for k in ("rec_y", "rec_cb", "rec_cr"):
                out.pop(k, None)
        handle = self._to_host(out)
        handle["recon_dev"] = rec
        return handle

    def encode_async_load(self, y, cb, cr, qp: int, split, modes,
                          want_recon=False, qp_offsets=None):
        """One frame's commit with the given split [hc, wc] and modes
        [h16, w16] (the estimate is skipped)."""
        s = self._upload(np.asarray(split, np.int32))[None]
        m = self._upload(np.asarray(modes, np.int32))[None]
        return self._to_host(self._step(
            self._upload(y[None]), self._upload(cb[None]),
            self._upload(cr[None]), qp, split=s, modes=m,
            want_recon=want_recon, qp_offsets=qp_offsets))

    @staticmethod
    def wait(handle) -> None:
        if handle["event"] is not None:
            handle["event"].synchronize()

    def collect_batch(self, handle) -> list[FrameResult]:
        self.wait(handle)
        h = {k: v.numpy() for k, v in handle["host"].items()}
        out = []
        for i in range(h["split"].shape[0]):
            res = FrameResult(h["modes"][i].astype(np.int32),
                              *levels_from_host(h, i, handle["dense"]),
                              h["sse"][i])
            res.split = h["split"][i].astype(np.int32)
            if "sao0" in h:
                res.sao = tuple(h[f"sao{k}"][i] for k in range(10))
            if "rec_y" in h:
                res.recon_y, res.recon_cb, res.recon_cr = (
                    h[k][i] if self.bd == 8 else h[k][i].view(np.uint16)
                    for k in ("rec_y", "rec_cb", "rec_cr"))
            out.append(res)
        return out

    def collect(self, handle) -> FrameResult:
        return self.collect_batch(handle)[0]
