"""P-slice CTU32 quadtree encoder on the card with 1 to 4 L0 references: the
port of the JAX package's `models/inter_tree.py:InterTreeEncoder`.

Four phases per P frame, as in the JAX `_encode` (:171):

1. Parallel ME and trials (:219-297), per reference: the dense SSD grid of
   every 16x16 cell and every CTU32 over +-sr (kernel K5 `me_ssd_grid`), the
   ME cost argmin, the +-2 qpel refinement (K6 `subpel_refine`), and an
   inter trial at each size (K7 `mc_qpel`, K2 `residual_chain` with inter
   rounding, K3 `tu_bits` at P init states); the SSD grids over the half-pel
   plane (K8 `hpel_plane`) that price sub-pel merge candidates.  With
   several references, the best one per CU by trial cost with its ref_idx
   bins (K18 `pick_ref`, :274-290).  The intra trial of every cell on
   source references (`_intra_trial16`, :798: K1, K2, K3).
2. Decide scan (:336-544): over the anti-diagonals of the CTU32 grid, each
   CTU derives its merge and AMVP candidates from the motion and references
   already decided (spec 8.5.3.2, z-scan availability; merge pruning on
   (MV, reference), AMVP scaled to the CU's reference) and picks skip, AMVP
   inter or intra per CU, then split against no split.  On the card one
   launch of K17 (`decide_p`, a thread a CTU32 row); on the CPU its plain
   version, a Python loop over the diagonals.
3. Final MC against each cell's reference (K7, with a reference index over
   the stacked planes when R > 1; JAX `mc_sel` :598-615) and residuals at
   the decided MVs (:616-687): K2.
4. Commit scan (:829-1044): intra cells re-coded from the true neighbouring
   reconstruction at the mode the trial chose.  The inter reconstruction
   of every cell is final after phase 3, so the state starts from it; a
   cell never reads a neighbour that is not final, so the output is the
   JAX scan's.  On the card K20 (`commit_intra`, one launch a diagonal, a
   CTU without an intra cell returning at once, no host read); on the CPU
   its plain version, which runs only the (diagonal, quadrant) steps that
   hold an intra cell (K1, K2).

With RDOQ on, K2 runs its RDOQ stage in phase 3 (luma, and in the P tree
also cb and cr with the luma lambda; the B tree's chroma runs none, as in
JAX :1626-1638) and on the luma and chroma of the intra cells in phase 4;
the trials of phase 1 and the decide scan run none, so no decision moves.

Then the loop filter with the inter bS maps (K4; the L0 reference index per
cell, JAX :735), SSE and SSIM.  The plain scan permutes its per-lane side
data once per frame into scan-slot order (diagonal by diagonal), so each
diagonal reads contiguous views.

`encode_async_load` replays given decisions (split, kinds, merge indices,
MVDs, MVP indices, reference indices, intra modes) through the same
candidate derivation, so the JAX encoder's decisions can drive the port.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.commit import commit_intra
from ..ops.deblock import deblock_frame_planes
from ..ops.decide_flat import B_ORDER, PRUNE_A, PRUNE_B, amvp_b
from ..ops.decide_flat import scale_mv_vec as _scale_mv_vec
from ..ops.estbits import intra_hdr_bits, tu_bits
from ..ops.me import (check_window, hpel_plane, int_mv_argmin, mc_bi,
                      mc_luma_qpel, mc_qpel_ref, mc_select, me_ssd_grid,
                      mvd_bits, pick_ref, subpel_refine)
from ..ops.metrics import frame_metrics
from ..ops.pack import (levels_for_host, levels_from_host,
                        start_host_copy)
from ..ops.rdoq import fma32
from ..ops.residual import residual_chain
from ..ops.sao import sao_filter_frame
from .b_frame import BFrameResult
from .inter_frame import InterFrameResult, sao_of_host
from .intra_frame import _diag_schedule
from .intra_tree import ctu_maps, eval_luma, forced_chain, intra_mode_bits
from .mvpred import ref_list_tables

# header-bin cost of an intra CU inside a P slice, rounded to f32 as the
# JAX weakly-typed scalar is
_INTRA_HDR_BITS = float(np.float32(intra_hdr_bits("P")))
# choice index (skip merge 0, skip merge 1, AMVP, intra) -> kind
_KIND_OF_CHOICE = (0, 0, 1, 2)


_P = ctypes.c_void_p


class _DecideArgs(ctypes.Structure):
    """`DecideArgs` of `csrc/decide_p.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "wc", "hc", "w16", "h16", "sr", "R")]
        + [(k, _P) for k in (
            "grid", "d32", "rb32", "lam32", "mv32", "ref32", "d16", "rb16",
            "di16", "lam16", "mv16", "ref16", "dsf", "refbits")]
        + [("intra_hdr_bits", ctypes.c_float)]
        + [(k, _P) for k in (
            "f_ch16", "f_mvd16", "f_mvp16", "f_ref16", "f_ch32", "f_mvd32",
            "f_mvp32", "f_ref32", "f_split", "split", "ch32", "mvd32",
            "mvp32", "ref32_out", "chq", "mvdq", "mvpq", "refq", "mv_cell",
            "ref_cell", "jsq", "js32", "jsplit", "j32")])


class _DecideBArgs(ctypes.Structure):
    """`DecideBArgs` of `csrc/decide_b.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "wc", "hc", "w16", "h16", "sr", "dsf0", "dsf1")]
        + [(k, _P) for k in (
            "grid0", "grid1", "d32", "rb32", "lam32", "mv0_32", "mv1_32",
            "d16", "rb16", "di16", "lam16", "mv0_16", "mv1_16")]
        + [("intra_hdr_bits", ctypes.c_float)]
        + [(k, _P) for k in (
            "f_ch16", "f_mvd0_16", "f_mvp0_16", "f_mvd1_16", "f_mvp1_16",
            "f_ch32", "f_mvd0_32", "f_mvp0_32", "f_mvd1_32", "f_mvp1_32",
            "f_split", "split", "ch32", "mvd0_32", "mvp0_32", "mvd1_32",
            "mvp1_32", "chq", "mvd0q", "mvp0q", "mvd1q", "mvp1q", "dir",
            "mv0", "mv1", "jsq", "js32", "jsplit", "j32")])


def _launch(name, struct, args, like) -> None:
    """One launch of the decide-scan kernel ``name`` (K17 `decide_p`, K19
    `decide_b`) with its argument struct on the stream of the tensor
    ``like``."""
    f = getattr(cuda_lib.lib(name), name)
    f.argtypes = [ctypes.POINTER(struct), _P]
    f.restype = ctypes.c_int
    cuda_lib.launched(name, f(ctypes.byref(args),
                              _P(cuda_lib.stream_handle(like))))


def _blocks(plane, bn):
    """[H, W] -> [H/bn, W/bn, bn, bn]."""
    h, w = plane.shape
    return plane.reshape(h // bn, bn, w // bn, bn).permute(0, 2, 1, 3)


def _unblocks(blocks):
    hb, wb, bn, _ = blocks.shape
    return blocks.permute(0, 2, 1, 3).reshape(hb * bn, wb * bn)


def _bc(flag, n):
    return flag[:, None].expand(-1, n)


class InterTreeEncoder:
    """Per-resolution P-frame CTU32 quadtree encoder on one device."""

    CTU = 32
    ST = "P"

    def __init__(self, width: int, height: int, deblock: bool = True,
                 search_range: int = 16, subme: int = 2,
                 sign_hide: bool = True, sao: bool = False, device="cuda",
                 rdoq: bool = False):
        if width % 32 or height % 32:
            raise ValueError("caller pads to a CTU32 multiple")
        if not 4 <= search_range <= 32:
            raise ValueError("dense-grid ME range must be 4..32")
        self.device = torch.device(device)
        self.width, self.height = width, height
        self.deblock = deblock
        self.sao = sao
        self.sbh = sign_hide
        self.rdoq = rdoq
        self.sr = int(search_range)
        self.subme = int(subme)
        self.wc, self.hc = width // 32, height // 32
        self.w16, self.h16 = width // 16, height // 16
        self.diags = _diag_schedule(self.wc, self.hc)
        self._maps_cache: dict = {}
        self._build_lanes()
        # constants the decide scan reads (made once: an upload per use
        # would synchronise the stream)
        dev = self.device
        self._inf = torch.tensor(float("inf"), device=dev)
        self._kind_of_choice = torch.tensor(_KIND_OF_CHOICE, device=dev)
        self._one_two = torch.tensor([1, 2], dtype=torch.int32, device=dev)
        # index tensors on the device: indexing a CUDA tensor with a Python
        # list copies the list to the card from pageable memory, which
        # stalls the host until the stream reaches the copy
        self._prune_a = torch.tensor(PRUNE_A, device=dev)
        self._prune_b = torch.tensor(PRUNE_B, device=dev)
        self._skip_bins = torch.tensor([2.0, 3.0], device=dev)
        self._hdr_bits = torch.tensor(_INTRA_HDR_BITS, dtype=torch.float32,
                                      device=dev)
        self._zero_mv = torch.zeros((1, 1, 2), dtype=torch.int32, device=dev)
        self._zero_ref = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        self._no = torch.zeros(1, dtype=torch.bool, device=dev)

    # ---- static schedule ---------------------------------------------------

    def _build_lanes(self):
        """Slot order (CTUs diagonal by diagonal) and, per diagonal, its
        slot range and the neighbour positions its decide step reads."""
        wc, w16, h16 = self.wc, self.w16, self.h16
        dev = self.device
        order = [c for cells in self.diags for c in cells]
        cx = np.array([c[0] for c in order])
        cy = np.array([c[1] for c in order])
        self._perm32 = torch.as_tensor(cy * wc + cx, device=dev)
        # raster CTU -> its top-left 16-cell
        i32 = np.arange(self.hc * wc)
        self._q0_cell = torch.as_tensor(2 * (i32 // wc) * w16 + 2 * (i32 % wc),
                                        device=dev)
        bx, by = 2 * cx, 2 * cy
        cells = np.stack([by * w16 + bx, by * w16 + bx + 1,
                          (by + 1) * w16 + bx, (by + 1) * w16 + bx + 1], 1)
        self._perm16 = torch.as_tensor(cells, device=dev)       # [n32, 4]
        top, left = cy > 0, cx > 0
        tr = top & (cx < wc - 1)
        # external neighbours: c32 A1 B1 B0 B2 | q0 A1 B1 B0 B2 |
        # q1 B1 B0 B2 | q2 A1 B2
        pos = [(bx - 1, by + 1, left), (bx + 1, by - 1, top),
               (bx + 2, by - 1, tr), (bx - 1, by - 1, left & top),
               (bx - 1, by, left), (bx, by - 1, top),
               (bx + 1, by - 1, top), (bx - 1, by - 1, left & top),
               (bx + 1, by - 1, top), (bx + 2, by - 1, tr),
               (bx, by - 1, top),
               (bx - 1, by + 1, left), (bx - 1, by, left)]
        nx = np.clip(np.stack([p[0] for p in pos], 1), 0, w16 - 1)
        ny = np.clip(np.stack([p[1] for p in pos], 1), 0, h16 - 1)
        nok = np.stack([p[2] for p in pos], 1)
        cys = np.stack([by, by, by + 1, by + 1], 1)
        cxs = np.stack([bx, bx + 1, bx, bx + 1], 1)
        self._lanes = []
        off = 0
        for cells_d in self.diags:
            b = len(cells_d)
            sl = slice(off, off + b)
            t = {k: torch.as_tensor(v[sl], device=dev) for k, v in dict(
                nx=nx, ny=ny, nok=nok, cys=cys, cxs=cxs).items()}
            t["sl"] = sl
            self._lanes.append(t)
            off += b

    # ---- maps ----------------------------------------------------------------

    def _maps(self, qp: int, qp_offsets=None):
        """Raster per-cell and per-CTU QP/lambda maps on the device (JAX
        `_maps` :1047; QG == CTB), flattened, plus the [hc, wc] CTU QP map
        of the deblocking QP chain.  Without offsets (CQP, no AQ) every
        map is uniform and kept per QP."""
        if qp_offsets is None and qp in self._maps_cache:
            return self._maps_cache[qp]
        host = ctu_maps(qp, qp_offsets, self.h16, self.w16)
        dev = self.device
        maps = {k: torch.as_tensor(v.reshape(-1), device=dev)
                for k, v in host.items()}
        maps["qp32_map"] = torch.as_tensor(host["qp32"], device=dev)
        if qp_offsets is None:
            self._maps_cache[qp] = maps
        return maps

    # ---- phase 1: parallel ME, trials, grids -----------------------------

    def _intra_trial16(self, oy, oy_flat, qp16, lam16):
        """Intra estimate of every 16-cell on SOURCE references (JAX
        `_intra_trial16` :798): frame-border availability, no below-left.
        Returns (cost [n16] f32, best mode [n16] int32)."""
        h16, w16 = self.h16, self.w16
        dev = oy.device
        i = torch.arange(h16 * w16, device=dev)
        cy, cx = i // w16, i % w16
        cyu = torch.clamp(cy - 1, min=0)
        cxl = torch.clamp(cx - 1, min=0)
        cxr = torch.clamp(cx + 1, max=w16 - 1)
        top = torch.cat([oy[cyu, cx, 15, :], oy[cyu, cxr, 15, :]], 1)
        left0 = oy[cy, cxl, :, 15]
        refs = (top, torch.cat([left0, left0], 1), oy[cyu, cxl, 15, 15],
                torch.cat([_bc(cy > 0, 16), _bc((cy > 0) & (cx < w16 - 1),
                                               16)], 1),
                torch.cat([_bc(cx > 0, 16), _bc(cx < 0, 16)], 1),
                (cx > 0) & (cy > 0))
        mb = intra_mode_bits(torch.ones(h16 * w16, dtype=torch.int32,
                                        device=dev))
        best, j = eval_luma(oy_flat, refs, 16, qp16, lam16, mb, st=self.ST)
        return j, best

    def _phase1(self, y, refs_y, maps, tables):
        """Stage-1 outputs in raster order (JAX :219-296): per reference the
        ME MVs, sub-pel refinement and trials; with R > 1 references the
        best one per CU (K18 `pick_ref`, :274-290); the intra trial; and the
        SSD grids of every reference stacked as JAX flattens them (see
        `_stack_grids`).  refs_y [R, H, W]; tables (dsf, refbits)."""
        per = []
        for r in range(refs_y.shape[0]):
            m = self._motion_search(y, refs_y[r], maps)
            m.update(self._subpel(y, refs_y[r], maps, m))
            per.append(m)
        st1 = dict(grid=self._stack_grids(per))
        st1.update(self._trials(y, refs_y, maps, per))
        self._pick_refs(st1, maps, tables)
        st1["di16"], st1["imode16"] = self._intra_trial16(
            _blocks(y, 16), _blocks(y, 16).reshape(-1, 16, 16),
            maps["qp16"], maps["lam16"])
        return st1

    @staticmethod
    def _pick_refs(st1, maps, tables):
        """The trials' d, rb and MV [nb, R] of each CU size become the best
        reference's [nb] and its index ref{bn} (K18 when R > 1)."""
        for bn, lam in ((16, maps["lam16"]), (32, maps["lam32"])):
            if st1[f"d{bn}"].shape[1] == 1:
                st1[f"ref{bn}"] = torch.zeros_like(st1[f"d{bn}"][:, 0],
                                                   dtype=torch.int32)
                for k in ("d", "rb", "mv"):
                    st1[f"{k}{bn}"] = st1[f"{k}{bn}"][:, 0]
            else:
                (st1[f"ref{bn}"], st1[f"d{bn}"], st1[f"rb{bn}"],
                 st1[f"mv{bn}"]) = pick_ref(st1[f"d{bn}"], st1[f"rb{bn}"],
                                            st1[f"mv{bn}"], lam, tables[1])

    @staticmethod
    def _stack_grids(per):
        """The SSD grids of R references in one tensor, as JAX flattens them
        (:292-296): CU16 grids first, [integer-pel of refs 0..R-1, half-pel
        of refs 0..R-1] x n16 rows, then the CU32 grids likewise, so a
        candidate on reference r reads row base + (sub R + r) n + idx."""
        return torch.cat([p["grids"][k] for k in range(4) for p in per], 0)

    def _motion_search(self, y, ref_y, maps):
        """Integer ME (JAX `best_mv` :227 before the refinement): the SSD
        grids at 16 and 32 over the reference (K5), their cost argmin, and
        the grids over the half-pel plane (K8, K5) that price sub-pel
        merge candidates: grids [g16, g16 half-pel, g32, g32 half-pel].
        The argmin's cost is the FMA XLA forms (`int_mv_argmin`)."""
        out = {}
        grids = []
        rh = hpel_plane(ref_y)
        for bn, lam in ((16, maps["lam16"]), (32, maps["lam32"])):
            cur = _blocks(y, bn).reshape(-1, bn, bn)
            g = me_ssd_grid(cur, ref_y, self.sr, bn)
            out[f"mvi{bn}"] = int_mv_argmin(g, lam, self.sr)
            grids += [g, me_ssd_grid(cur, rh, self.sr, bn)]
        out["grids"] = grids
        return out

    def _subpel(self, y, ref_y, maps, st1):
        """The +-2 qpel refinement of the integer MVs (K6; subme 0 keeps
        the integer MVs)."""
        out = {}
        for bn, lam in ((16, maps["lam16"]), (32, maps["lam32"])):
            mvi = st1[f"mvi{bn}"]
            out[f"mv{bn}"] = subpel_refine(
                ref_y, _blocks(y, bn).reshape(-1, bn, bn), mvi, lam,
                bn)[0] if self.subme >= 1 else mvi * 4
        return out

    def _trials(self, y, refs_y, maps, per):
        """The inter trial of every reference at each CU size (JAX
        `inter_trial` :239): MC (K7, one launch over the stacked planes with
        a reference index per prediction), the residual chain with inter
        rounding and no SBH (K2), its SSD and bits at P init states (K3).
        d{bn}, rb{bn} [nb, R]; mv{bn} [nb, R, 2]."""
        out = {}
        nr = refs_y.shape[0]
        for bn, q in ((16, maps["qp16"]), (32, maps["qp32"])):
            mv = torch.stack([p[f"mv{bn}"] for p in per], 1)
            nb = mv.shape[0]
            ref = torch.arange(nr, dtype=torch.int32, device=y.device) \
                .repeat_interleave(nb)
            pred = mc_qpel_ref(refs_y, mv.transpose(0, 1).reshape(-1, 2),
                               ref, bn, False).reshape(nr, nb, bn, bn) \
                .transpose(0, 1).contiguous()
            lv, _, ssd = residual_chain(_blocks(y, bn).reshape(-1, bn, bn),
                                        pred, q, False, want_recon=False,
                                        intra=False)
            out[f"d{bn}"] = ssd.to(torch.float32)
            out[f"rb{bn}"] = tu_bits(lv, 0, q[:, None].expand(-1, nr),
                                     self.ST)
            out[f"mv{bn}"] = mv
        return out

    # ---- phase 2: decide scan ----------------------------------------------

    def _scale_to(self, mv, rf, cur, dsf):
        """Neighbour MVs [L, 2] on references rf [L] viewed at the CU's
        references cur [L] (JAX `scale_to` :355-361: the same index passes
        through, another is scaled by dsf[rf, cur], spec 8.5.3.2.8)."""
        f = dsf[rf.long(), cur.long()][:, None]
        return torch.where((rf == cur)[:, None], mv, _scale_mv_vec(mv, f))

    def _decide_cu(self, av, mv, rf, dd, rbd, mvme, refme, lamv, di, row,
                   ngrid, tables, forced=None):
        """One CU decision per lane from its candidates av/mv/rf [L, 4(, 2)]
        in the order A1, B1, B0, B2 (JAX `decide_cu` :363-476): the merge
        list pruned on (MV, reference), AMVP A/B scaled to the lane's
        reference, the ref_idx bins of tables = (dsf [R, R], refbits [R]) in
        the inter cost, the skip costs from the SSD grid of the candidate's
        reference (row + (sub R + r) ngrid; row is the lane's base + idx),
        and the three costs XLA contracts into an FMA as one (`fma32`).
        ``forced`` = (choice, mvd, mvp_idx, ref) replays a decision.
        Returns (choice [L] int64, mv [L, 2], ref [L] int32, mvd [L, 2],
        mvp_idx [L] bool, js [L, 4] or None)."""
        dsf, refbits = tables
        nr = refbits.shape[0]
        sr, s = self.sr, 2 * self.sr + 1
        # merge list (spec 8.5.3.2.3): B1 pruned against A1, B0 against B1,
        # B2 against A1 and B1, each against the partner's availability
        pa, pb = self._prune_a, self._prune_b
        eq = (mv[:, pb] == mv[:, pa]).all(-1) & (rf[:, pb] == rf[:, pa]) & \
            av[:, pa]
        avs = av.clone()
        avs[:, 1:3] &= ~eq[:, 0:2]
        avs[:, 3] &= ~(eq[:, 2] | eq[:, 3])
        pos = torch.cumsum(avs.to(torch.int32), 1)
        sel = avs[:, :, None] & (pos[:, :, None] == self._one_two)
        mrg = (mv[:, :, None, :] * sel[..., None]).sum(1, dtype=torch.int32)
        mrf = (rf[:, :, None] * sel).sum(1, dtype=torch.int32)
        # AMVP (8.5.3.2.6): A = A1, B = first of (B0, B1, B2), both viewed
        # at the lane's reference, B pruned against A
        cur = refme if forced is None else forced[3]
        a1, b1, b0 = av[:, 0], av[:, 1], av[:, 2]
        avb = av[:, 1:].any(1)
        mvb = torch.where(b0[:, None], mv[:, 2],
                          torch.where(b1[:, None], mv[:, 1], mv[:, 3]))
        rfb = torch.where(b0, rf[:, 2], torch.where(b1, rf[:, 1], rf[:, 3]))
        sa = self._scale_to(mv[:, 0], rf[:, 0], cur, dsf)
        sb = self._scale_to(mvb, rfb, cur, dsf)
        amvp0 = torch.where(a1[:, None], sa,
                            torch.where(avb[:, None], sb, 0))
        amvp1 = torch.where((a1 & avb & ~(sb == sa).all(-1))[:, None],
                            sb, 0)
        zero = self._zero_mv.expand(mv.shape[0], 1, 2)
        zr = self._zero_ref.expand(mv.shape[0], 1)
        if forced is not None:
            choice, mvd, mvp_idx, ref = forced
            amvp = torch.where((mvp_idx == 1)[:, None], amvp1, amvp0)
            cands = torch.cat([mrg, (amvp + mvd)[:, None], zero], 1)
            rcands = torch.cat([mrf, ref.to(torch.int32)[:, None], zr], 1)
        else:
            mvds = mvme[:, None] - torch.stack([amvp0, amvp1], 1)
            bits = mvd_bits(mvds)
            use1 = bits[:, 1] < bits[:, 0]
            mvd = torch.where(use1[:, None], mvds[:, 1], mvds[:, 0])
            j_inter = fma32(lamv, ((rbd + bits.amin(1))
                                   + refbits[refme.long()]) + 6.0, dd)
            # skip on merge candidate 0 / 1: the SSD grid of the candidate's
            # reference at its integer part, the half-pel grid for a sub-pel
            # one
            sub = ((mrg & 3) != 0).any(-1)                       # [L, 2]
            mi = mrg >> 2
            inside = (mi.abs() <= sr).all(-1)
            mi = torch.clamp(mi + sr, 0, s - 1).long()
            val = self._grid[row[:, None] + (sub * nr + mrf) * ngrid,
                             mi[..., 1], mi[..., 0]]
            skip = fma32(lamv[:, None], self._skip_bins,
                         torch.where(inside, val, 1e18))
            intra = torch.where(torch.isinf(di), di,
                                fma32(lamv, self._hdr_bits, di))
            js = torch.cat([skip, j_inter[:, None], intra[:, None]], 1)
            choice = torch.argmin(js, 1)
            cands = torch.cat([mrg, mvme[:, None], zero], 1)
            rcands = torch.cat([mrf, refme.to(torch.int32)[:, None], zr], 1)
        mv_fin = torch.gather(cands, 1, choice[:, None, None]
                              .expand(-1, 1, 2))[:, 0]
        ref_fin = torch.gather(rcands, 1, choice[:, None])[:, 0]
        if forced is not None:
            return choice, mv_fin, ref_fin, mvd, mvp_idx == 1, None
        return choice, mv_fin, ref_fin, mvd, use1, js

    def _decide(self, st1, maps, tables, forced=None, want_costs=False):
        """The decide scan: on the card one launch of K17 (`decide_p`), on
        the CPU its plain version.  Returns raster maps (see
        `_decide_plain`)."""
        if self.device.type == "cpu":
            return self._decide_plain(st1, maps, tables, forced, want_costs)
        return self._decide_kernel(st1, maps, tables, forced, want_costs)

    def _decide_plain(self, st1, maps, tables, forced=None,
                      want_costs=False):
        """The decide scan over the CTU32 diagonals (JAX `decide_body`
        :336-544), the plain version of K17.  Returns raster maps: split
        [hc, wc] bool, per CTU32 the choice, MVD, MVP index and reference of
        its CU32 hypothesis, per 16-cell its quadrant's choice, MVD, MVP
        index and reference and the committed MV and reference of the cell
        (plus, with want_costs, the cost rows and split costs).  The CU32
        hypothesis and quadrant q0 read committed motion only, so they share
        one call; their per-frame inputs are interleaved per CTU ([n32, 2])
        so that a diagonal's lanes are one contiguous view.  ``forced``
        holds raster (choice, mvd, mvp_idx, ref) per 16-cell (c16) and per
        CTU (c32) and the split [n32]."""
        dev = self.device
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc
        n16, n32 = h16 * w16, hc * wc
        p32, p16 = self._perm32, self._perm16
        nr = tables[1].shape[0]

        def pair(a, b):              # [n32, 2, ...]: (CU32, q0) per CTU
            return torch.stack([a, b], 1)
        # grid rows: CU16 grids first, the CU32 grids after 2 R n16 rows
        row01 = pair(2 * nr * n16 + p32, p16[:, 0])
        ng01 = pair(torch.full_like(p32, n32), torch.full_like(p32, n16))
        if forced is None:
            self._grid = st1["grid"]
            d16, rb16, mv16, ref16, di16, lam16 = (
                t[p16] for t in (st1["d16"], st1["rb16"], st1["mv16"],
                                 st1["ref16"], st1["di16"], maps["lam16"]))
            x01 = [pair(st1[k][p32], c[:, 0]) for k, c in (
                ("d32", d16), ("rb32", rb16), ("mv32", mv16),
                ("ref32", ref16))]
            x01 += [pair(maps["lam32"][p32], lam16[:, 0]),
                    pair(self._inf.expand(n32), di16[:, 0])]
        else:
            f16 = [t[p16] for t in forced["c16"]]
            f01 = [pair(t[p32], c[:, 0]) for t, c in zip(forced["c32"],
                                                         f16)]
            fsplit = forced["split"][p32]
        mv_map = torch.zeros((h16, w16, 2), dtype=torch.int32, device=dev)
        inter_map = torch.zeros((h16, w16), dtype=torch.bool, device=dev)
        ref_map = torch.zeros((h16, w16), dtype=torch.int32, device=dev)
        outs = []
        for lane in self._lanes:
            sl = lane["sl"]
            b = sl.stop - sl.start
            ny, nx = lane["ny"], lane["nx"]
            nav = lane["nok"] & inter_map[ny, nx]
            nmv = torch.where(nav[..., None], mv_map[ny, nx], 0)
            nrf = torch.where(nav, ref_map[ny, nx], 0)
            av01 = nav[:, 0:8].reshape(2 * b, 4)
            mv01 = nmv[:, 0:8].reshape(2 * b, 4, 2)
            rf01 = nrf[:, 0:8].reshape(2 * b, 4)
            row_ = row01[sl].reshape(-1)
            ng_ = ng01[sl].reshape(-1, 1)
            if forced is None:
                r01 = self._decide_cu(
                    av01, mv01, rf01, *(t[sl].reshape((2 * b,) + t.shape[2:])
                                        for t in x01), row_, ng_, tables)

                def q_call(q, av, mv, rf):
                    return self._decide_cu(
                        av, mv, rf, d16[sl, q], rb16[sl, q], mv16[sl, q],
                        ref16[sl, q], lam16[sl, q], di16[sl, q], p16[sl, q],
                        n16, tables)
            else:
                r01 = self._decide_cu(
                    av01, mv01, rf01, None, None, None, None, None, None,
                    row_, ng_, tables,
                    forced=tuple(t[sl].reshape((2 * b,) + t.shape[2:])
                                 for t in f01))

                def q_call(q, av, mv, rf):
                    return self._decide_cu(
                        av, mv, rf, None, None, None, None, None, None, None,
                        None, tables, forced=tuple(c[sl, q] for c in f16))
            c32 = [t[0::2] if t is not None else None for t in r01]
            q0 = [t[1::2] if t is not None else None for t in r01]
            a0, m0, f0 = q0[0] <= 2, q0[1], q0[2]
            q1 = q_call(1, torch.stack([a0, nav[:, 8], nav[:, 9],
                                        nav[:, 10]], 1),
                        torch.stack([m0, nmv[:, 8], nmv[:, 9], nmv[:, 10]],
                                    1),
                        torch.stack([f0, nrf[:, 8], nrf[:, 9], nrf[:, 10]],
                                    1))
            a1, m1, f1 = q1[0] <= 2, q1[1], q1[2]
            q2 = q_call(2, torch.stack([nav[:, 11], a0, a1, nav[:, 12]], 1),
                        torch.stack([nmv[:, 11], m0, m1, nmv[:, 12]], 1),
                        torch.stack([nrf[:, 11], f0, f1, nrf[:, 12]], 1))
            no = self._no.expand(b)
            zr = self._zero_ref[0].expand(b)
            q3 = q_call(3, torch.stack([q2[0] <= 2, a1, no, a0], 1),
                        torch.stack([q2[1], m1, self._zero_mv[0].expand(
                            b, 2), m0], 1),
                        torch.stack([q2[2], f1, zr, f0], 1))
            qs = (q0, q1, q2, q3)
            if forced is None:
                jq = [q[5].amin(1) for q in qs]
                jsplit = ((jq[0] + jq[1]) + jq[2]) + jq[3]
                j32 = c32[5].amin(1)
                split = jsplit < j32
            else:
                split = fsplit[sl]
            chq = torch.stack([q[0] for q in qs], 1)
            mvfq = torch.stack([q[1] for q in qs], 1)
            rffq = torch.stack([q[2] for q in qs], 1)
            cell_mv = torch.where(split[:, None, None], mvfq,
                                  c32[1][:, None, :])
            cell_ref = torch.where(split[:, None], rffq, c32[2][:, None])
            mv_map[lane["cys"], lane["cxs"]] = cell_mv
            ref_map[lane["cys"], lane["cxs"]] = cell_ref
            inter_map[lane["cys"], lane["cxs"]] = (chq <= 2) | \
                ~split[:, None]
            out = [split, c32[0], c32[3], c32[4], c32[2], chq,
                   torch.stack([q[3] for q in qs], 1),
                   torch.stack([q[4] for q in qs], 1), rffq, cell_mv,
                   cell_ref]
            if want_costs:
                out += [torch.stack([q[5] for q in qs], 1), c32[5],
                        jsplit, j32]
            outs.append(out)
        cat = [torch.cat(o, 0) for o in zip(*outs)]

        def to32(t):
            r = torch.empty((n32,) + t.shape[1:], dtype=t.dtype, device=dev)
            r[p32] = t
            return r

        def to16(t):
            r = torch.empty((n16,) + t.shape[2:], dtype=t.dtype, device=dev)
            r[p16.reshape(-1)] = t.reshape((-1,) + t.shape[2:])
            return r
        res = dict(split=to32(cat[0]).reshape(hc, wc), ch32=to32(cat[1]),
                   mvd32=to32(cat[2]), mvp32=to32(cat[3]).to(torch.int32),
                   ref32=to32(cat[4]), chq=to16(cat[5]), mvdq=to16(cat[6]),
                   mvpq=to16(cat[7]).to(torch.int32), refq=to16(cat[8]),
                   mv=to16(cat[9]), ref=to16(cat[10]))
        if want_costs:
            res.update(jsq=to16(cat[11]), js32=to32(cat[12]),
                       jsplit=to32(cat[13]), j32=to32(cat[14]))
        self._grid = None
        return res

    def _decide_kernel(self, st1, maps, tables, forced=None,
                       want_costs=False):
        """The decide scan as one launch of K17 (`csrc/decide_p.cu`), free
        or forced; the same raster outputs as `_decide_plain`."""
        dev = self.device
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc
        n16, n32 = h16 * w16, hc * wc
        dsf, refbits = tables
        nr = refbits.shape[0]
        i32, f32 = torch.int32, torch.float32

        def c(t, dt):
            return t.to(dt).contiguous()
        keep = []                    # the tensors the launch reads

        def p(t):
            if t is None:
                return None
            keep.append(t)
            return cuda_lib.ptr(t)
        a = _DecideArgs(wc=wc, hc=hc, w16=w16, h16=h16, sr=self.sr, R=nr,
                        intra_hdr_bits=_INTRA_HDR_BITS)
        a.dsf, a.refbits = p(c(dsf, i32)), p(c(refbits, f32))
        if forced is None:
            a.grid = p(c(st1["grid"], f32))
            for k, dt in (("d32", f32), ("rb32", f32), ("mv32", i32),
                          ("ref32", i32), ("d16", f32), ("rb16", f32),
                          ("mv16", i32), ("ref16", i32), ("di16", f32)):
                setattr(a, k, p(c(st1[k], dt)))
            a.lam32, a.lam16 = p(c(maps["lam32"], f32)), \
                p(c(maps["lam16"], f32))
        else:
            for pre, vals in (("16", forced["c16"]), ("32", forced["c32"])):
                for k, v in zip(("f_ch", "f_mvd", "f_mvp", "f_ref"), vals):
                    setattr(a, k + pre, p(c(v, i32)))
            a.f_split = p(c(forced["split"], i32))
        out = dict(
            split=torch.empty(n32, dtype=i32, device=dev),
            ch32=torch.empty(n32, dtype=i32, device=dev),
            mvd32=torch.empty((n32, 2), dtype=i32, device=dev),
            mvp32=torch.empty(n32, dtype=i32, device=dev),
            ref32=torch.empty(n32, dtype=i32, device=dev),
            chq=torch.empty(n16, dtype=i32, device=dev),
            mvdq=torch.empty((n16, 2), dtype=i32, device=dev),
            mvpq=torch.empty(n16, dtype=i32, device=dev),
            refq=torch.empty(n16, dtype=i32, device=dev),
            mv=torch.empty((n16, 2), dtype=i32, device=dev),
            ref=torch.empty(n16, dtype=i32, device=dev))
        for k, v in out.items():
            setattr(a, "ref32_out" if k == "ref32" else
                    "mv_cell" if k == "mv" else
                    "ref_cell" if k == "ref" else k, p(v))
        if want_costs and forced is None:
            out.update(jsq=torch.empty((n16, 4), dtype=f32, device=dev),
                       js32=torch.empty((n32, 4), dtype=f32, device=dev),
                       jsplit=torch.empty(n32, dtype=f32, device=dev),
                       j32=torch.empty(n32, dtype=f32, device=dev))
            for k in ("jsq", "js32", "jsplit", "j32"):
                setattr(a, k, p(out[k]))
        cuda_lib.require_cuda(*keep)
        _launch("decide_p", _DecideArgs, a, keep[0])
        out["split"] = out["split"].bool().reshape(hc, wc)
        out["ch32"] = out["ch32"].long()
        out["chq"] = out["chq"].long()
        return out

    def _cell_decisions(self, dec):
        """Per 16-cell kinds, merge index, MVD, MVP index, MV and reference:
        the quadrant's own where its CTU is split, the CU32's replicated
        otherwise (the MV and reference as the scan committed them)."""
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc

        def rep(t):
            t = t.reshape((hc, wc) + t.shape[1:])
            return t.repeat_interleave(2, 0).repeat_interleave(2, 1) \
                .reshape((h16 * w16,) + t.shape[2:])
        sp = rep(dec["split"].reshape(-1))
        kind_tab = self._kind_of_choice
        ch = torch.where(sp, dec["chq"], rep(dec["ch32"]))
        return dict(
            split_cell=sp, kinds=kind_tab[ch],
            merge=torch.clamp(ch, max=1),
            mvd=torch.where(sp[:, None], dec["mvdq"], rep(dec["mvd32"])),
            mvp=torch.where(sp, dec["mvpq"], rep(dec["mvp32"])),
            k32=kind_tab[dec["ch32"]], mv=dec["mv"], ref=dec["ref"])

    # ---- phases 3 and 4 ------------------------------------------------------

    def _coded(self, orig, pred, qpv, lam=None, c_idx=0):
        """Inter residual chain with SBH, and RDOQ at the slice type's
        tables with the per-block lambdas ``lam`` when given: (levels int16,
        recon int32)."""
        lv, rec, _ = residual_chain(orig, pred[:, None], qpv, self.sbh,
                                    intra=False, rdoq=lam is not None,
                                    lam=lam, st=self.ST, c_idx=c_idx)
        return lv[:, 0], rec[:, 0]

    def _rdoq_lams(self, maps, key):
        """(luma, stacked cb+cr) lambdas of the final coding's RDOQ from
        the lambda map ``key``, or None where it runs none: the P tree
        prices its chroma with the luma lambda (JAX :633-637), the B tree
        runs RDOQ on luma only (its cb/cr calls pass no lambda, :1629)."""
        if not self.rdoq:
            return None, None
        lam = maps[key]
        return lam, (torch.cat([lam, lam]) if self.ST == "P" else None)

    def _final_mc(self, refs, cell):
        """Final uni MC of every cell at its decided MV against its decided
        reference (K7 over the stacked planes with the cell's reference
        index, JAX `mc_sel` :598-615): luma, cb, cr predictions [n16, n, n].
        refs: stacked planes [R, H, W] each."""
        mv, ref = cell["mv"], cell["ref"]
        return (mc_qpel_ref(refs[0], mv, ref, 16, False),
                mc_qpel_ref(refs[1], mv, ref, 8, True),
                mc_qpel_ref(refs[2], mv, ref, 8, True))

    def _phase3(self, y, cb, cr, preds, maps, cell):
        """Residuals of the final predictions for both CU sizes (K2);
        returns the per-cell levels and recon of the chosen hypothesis
        (raster cells [n16, ...])."""
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc
        n16, n32 = h16 * w16, hc * wc
        py, pcb, pcr = preds
        oy = _blocks(y, 16).reshape(n16, 16, 16)
        ocb = _blocks(cb, 8).reshape(n16, 8, 8)
        ocr = _blocks(cr, 8).reshape(n16, 8, 8)
        kinds, is_split = cell["kinds"], cell["split_cell"]
        lam_y, lam_c = self._rdoq_lams(maps, "lam16")
        lv_y, rec_y = self._coded(oy, py, maps["qp16"], lam_y)
        lv_c, rec_c = self._coded(torch.cat([ocb, ocr]), torch.cat([pcb,
                                                                   pcr]),
                                  torch.cat([maps["qc16"], maps["qc16"]]),
                                  lam_c, 1)

        def to32(t, bn):        # raster cells -> raster CTUs
            return _blocks(_unblocks(t.reshape(h16, w16, bn, bn)),
                           2 * bn).reshape(n32, 2 * bn, 2 * bn)

        def to16(t, bn):        # raster CTUs -> raster cells
            return _blocks(_unblocks(t.reshape(hc, wc, 2 * bn, 2 * bn)),
                           bn).reshape(n16, bn, bn)
        lam_y, lam_c = self._rdoq_lams(maps, "lam32")
        lv32_y, rec32_y = self._coded(_blocks(y, 32).reshape(n32, 32, 32),
                                      to32(py, 16), maps["qp32"], lam_y)
        lv32_c, rec32_c = self._coded(
            torch.cat([_blocks(cb, 16).reshape(n32, 16, 16),
                       _blocks(cr, 16).reshape(n32, 16, 16)]),
            torch.cat([to32(pcb, 8), to32(pcr, 8)]),
            torch.cat([maps["qc32"], maps["qc32"]]), lam_c, 1)
        skip16 = ((kinds == 0) | ~is_split)[:, None, None]
        skip32 = (cell["k32"] == 0)[:, None, None]
        sk16 = (kinds == 0)[:, None, None]
        isn = is_split[:, None, None]
        p2 = torch.cat([pcb, pcr])
        out = []
        for lv16, rec16, lv32, rec32, pred, bn in (
                (lv_y, rec_y, lv32_y, rec32_y, py, 16),
                (lv_c, rec_c, lv32_c, rec32_c, p2, 8)):
            k = lv16.shape[0] // n16
            lv16 = torch.where(skip16.repeat(k, 1, 1), 0, lv16)
            rec16 = torch.where(sk16.repeat(k, 1, 1), pred, rec16)
            pred32 = torch.cat([to32(pred[i * n16:(i + 1) * n16], bn)
                                for i in range(k)])
            lv32 = torch.where(skip32.repeat(k, 1, 1), 0, lv32)
            rec32 = torch.where(skip32.repeat(k, 1, 1), pred32, rec32)
            lv32c = torch.cat([to16(lv32[i * n32:(i + 1) * n32], bn)
                               for i in range(k)])
            rec32c = torch.cat([to16(rec32[i * n32:(i + 1) * n32], bn)
                                for i in range(k)])
            out.append((torch.where(isn.repeat(k, 1, 1), lv16, lv32c),
                        torch.where(isn.repeat(k, 1, 1), rec16, rec32c)))
        (fly, fry), (flc, frc) = out
        return (fly, flc[:n16], flc[n16:]), (fry, frc[:n16], frc[n16:])

    def _commit(self, y, cb, cr, maps, kinds, imode, lv, rec):
        """Re-code the intra cells from true reconstruction (JAX
        `_commit_scan`); lv/rec are the inter results per raster cell.  On
        the card K20 (`commit_intra`, one launch a diagonal, the intra cells
        found on the device), on the CPU its plain version.  Returns recon
        planes, levels per cell and the mode map."""
        if self.device.type == "cpu":
            return self._commit_plain(y, cb, cr, maps, kinds, imode, lv, rec)
        return self._commit_kernel(y, cb, cr, maps, kinds, imode, lv, rec)

    def _commit_kernel(self, y, cb, cr, maps, kinds, imode, lv, rec):
        """The commit as K20 (`csrc/commit_intra.cu`) over raster recon
        planes made from the inter recon; the levels of the intra cells are
        written into ``lv`` in place.  No host read: a CTU without an intra
        cell returns at once on the card.  The same outputs as
        `_commit_plain`."""
        h16, w16 = self.h16, self.w16
        n16 = h16 * w16
        planes = (_unblocks(rec[0].reshape(h16, w16, 16, 16)),
                  _unblocks(rec[1].reshape(h16, w16, 8, 8)),
                  _unblocks(rec[2].reshape(h16, w16, 8, 8)))
        levels = (lv[0].reshape(1, h16, w16, 16, 16),
                  lv[1].reshape(1, h16, w16, 8, 8),
                  lv[2].reshape(1, h16, w16, 8, 8))
        modes = torch.where(kinds == 2, imode, 1).to(torch.int32) \
            .reshape(h16, w16)
        commit_intra(tuple(t[None] for t in (y, cb, cr)),
                     tuple(t[None] for t in planes), levels, modes[None],
                     maps, kinds=kinds.reshape(1, h16, w16), sbh=self.sbh,
                     rdoq=self.rdoq, st=self.ST)
        return (planes, (levels[0].reshape(n16, 16, 16),
                         levels[1].reshape(n16, 8, 8),
                         levels[2].reshape(n16, 8, 8)), modes)

    def _commit_plain(self, y, cb, cr, maps, kinds, imode, lv, rec):
        """The commit as the plain version of K20: the (diagonal, quadrant)
        steps that hold an intra cell, found with one host read of the
        kinds."""
        h16, w16, wc = self.h16, self.w16, self.wc
        n16 = h16 * w16
        dev = y.device
        yb = rec[0].reshape(h16, w16, 16, 16).clone()
        cbb = rec[1].reshape(h16, w16, 8, 8).clone()
        crb = rec[2].reshape(h16, w16, 8, 8).clone()
        ly = lv[0].reshape(h16, w16, 16, 16).clone()
        lcb = lv[1].reshape(h16, w16, 8, 8).clone()
        lcr = lv[2].reshape(h16, w16, 8, 8).clone()
        modes = torch.ones((h16, w16), dtype=torch.int32, device=dev)
        # the one host sync of the frame: which (diagonal, quadrant) steps
        # hold intra cells, and on which CTUs; their coordinates go up in
        # one copy (a pageable upload per step would sync each time)
        intra = (kinds == 2).reshape(h16, w16).cpu().numpy()
        steps = []
        for cells_d in self.diags:
            cxd = np.array([c[0] for c in cells_d])
            cyd = np.array([c[1] for c in cells_d])
            for q in range(4):
                hit = intra[2 * cyd + (q >> 1), 2 * cxd + (q & 1)]
                if hit.any():
                    steps.append((q, cxd[hit], cyd[hit]))
        if steps:
            oy, ocb, ocr = _blocks(y, 16), _blocks(cb, 8), _blocks(cr, 8)
            qp16 = maps["qp16"].reshape(h16, w16)
            qc16 = maps["qc16"].reshape(h16, w16)
            lam16 = maps["lam16"].reshape(h16, w16) if self.rdoq else None
            im = imode.reshape(h16, w16)
            xy = torch.as_tensor(np.concatenate(
                [np.stack([sx, sy]) for _, sx, sy in steps], 1), device=dev)
            off = 0
            for q, sx, _ in steps:
                k = len(sx)
                self._commit_cells(xy[0, off:off + k], xy[1, off:off + k],
                                   q, wc, (yb, cbb, crb), (ly, lcb, lcr),
                                   modes, (oy, ocb, ocr), qp16, qc16, im,
                                   lam16)
                off += k
        return ((_unblocks(yb), _unblocks(cbb), _unblocks(crb)),
                (ly.reshape(n16, 16, 16), lcb.reshape(n16, 8, 8),
                 lcr.reshape(n16, 8, 8)), modes)

    def _commit_cells(self, cx, cy, q, wc, state, levels, modes, orig,
                      qp16, qc16, im, lam16=None):
        """Intra chains of quadrant q of the CTUs (cx, cy), with z-scan
        availability (spec 6.4.1) and references read from the committed
        state, with RDOQ on luma and chroma (the luma lambda, JAX
        :883-906) when lam16 is given; writes recon, levels and modes in
        place."""
        h16, w16 = self.h16, self.w16
        r, c = 2 * cy + (q >> 1), 2 * cx + (q & 1)
        top, left = cy > 0, cx > 0
        tr = top & (cx < wc - 1)
        one = torch.ones_like(top)
        no = ~one
        avt0, avt1, avl0, avl1, avc = (
            (top, top, left, left, top & left), (top, tr, one, no, top),
            (one, one, left, no, left), (one, no, one, no, one))[q]
        ru = torch.clamp(r - 1, min=0)
        rd = torch.clamp(r + 1, max=h16 - 1)
        cl = torch.clamp(c - 1, min=0)
        cr1 = torch.clamp(c + 1, max=w16 - 1)

        def refs(s, n):
            e = n - 1
            return (torch.cat([s[ru, c, e, :], s[ru, cr1, e, :]], 1),
                    torch.cat([s[r, cl, :, e], s[rd, cl, :, e]], 1),
                    s[ru, cl, e, e],
                    torch.cat([_bc(avt0, n), _bc(avt1, n)], 1),
                    torch.cat([_bc(avl0, n), _bc(avl1, n)], 1), avc)
        yb, cbb, crb = state
        ly, lcb, lcr = levels
        oy, ocb, ocr = orig
        mode = im[r, c]
        lam = None if lam16 is None else lam16[r, c]
        lv_y, rc_y = forced_chain(oy[r, c], refs(yb, 16), 16, mode,
                                  qp16[r, c], 0, self.sbh, lam=lam,
                                  st=self.ST)
        rcb, rcr = refs(cbb, 8), refs(crb, 8)
        lv_c, rc_c = forced_chain(
            torch.cat([ocb[r, c], ocr[r, c]]),
            [torch.cat([a, b_]) for a, b_ in zip(rcb, rcr)], 8,
            torch.cat([mode, mode]), torch.cat([qc16[r, c], qc16[r, c]]),
            1, self.sbh, lam=None if lam is None else torch.cat([lam, lam]),
            st=self.ST)
        k = cx.shape[0]
        yb[r, c], ly[r, c] = rc_y, lv_y
        cbb[r, c], crb[r, c] = rc_c[:k], rc_c[k:]
        lcb[r, c], lcr[r, c] = lv_c[:k], lv_c[k:]
        modes[r, c] = mode

    # ---- loop filter and metrics ----------------------------------------------

    def _filter_and_metrics(self, src, rec, levels, kinds, split, motion,
                            maps, qp, ref0=None):
        """The deblocking filter with the inter bS maps (JAX :709-746: TU
        cbf per cell, a TU32's over its four cells; prediction directions
        and MVs [h16, w16(, 2)] in ``motion`` = (dir, mv0, mv1), 0 on intra
        cells; the L0 reference index per cell ``ref0``, 0 on intra cells
        and when not given), SAO when enabled (:747-760), then SSE and SSIM
        (:762-767) on the final recon.  Returns (recon planes, sse [4], SAO
        outputs {"sao0".."sao9": tensor})."""
        (y, cb, cr), (ry, rcb, rcr), (ly, lcb, lcr) = src, rec, levels
        if self.deblock:
            inter = tuple(None if t is None else t.reshape(
                (1, self.h16, self.w16) + t.shape[2:]) for t in
                (kinds.reshape(self.h16, self.w16),) + tuple(motion) + (ref0,))
            cells = tuple(t.reshape((1, self.h16, self.w16) + t.shape[-2:])
                          for t in (ly, lcb, lcr))
            ry, rcb, rcr = (t[0] for t in deblock_frame_planes(
                ry[None], rcb[None], rcr[None], cells, maps["qp32_map"], qp,
                split=split[None], inter=inter))
        sao = {}
        if self.sao:
            (ry, rcb, rcr), par = sao_filter_frame(y, cb, cr, ry, rcb, rcr,
                                                   maps["lam32"])
            sao = {f"sao{k}": t for k, t in enumerate(par)}
        sse = frame_metrics((y[None], cb[None], cr[None]),
                            (ry[None], rcb[None], rcr[None]))[0]
        return (ry, rcb, rcr), sse, sao

    # ---- one P frame ---------------------------------------------------------

    def _step(self, y, cb, cr, refs, qp: int, tables, forced=None,
              want_recon=False, want_costs=False, qp_offsets=None):
        """The four phases, loop filter and metrics for one frame on the
        device against the L0 list ``refs`` (stacked [R, H, W] luma, cb,
        cr) with its tables (dsf, refbits), with the per-16-cell QP offsets
        [h16, w16] of AQ and CU-tree when given.  Returns a dict of device
        tensors."""
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        h16, w16 = self.h16, self.w16
        if forced is None:
            st1 = self._phase1(y, refs[0], maps, tables)
            dec = self._decide(st1, maps, tables, want_costs=want_costs)
            imode = st1["imode16"]
        else:
            dec = self._decide(None, maps, tables, forced=forced["scan"])
            imode = forced["modes"]
        cell = self._cell_decisions(dec)
        lv, rec = self._phase3(y, cb, cr, self._final_mc(refs, cell), maps,
                               cell)
        kinds = cell["kinds"]
        (ry, rcb, rcr), (ly, lcb, lcr), modes = self._commit(
            y, cb, cr, maps, kinds, imode, lv, rec)
        split = dec["split"]
        intra = (kinds == 2).reshape(h16, w16)
        mv0 = torch.where(intra[..., None], 0, dec["mv"].reshape(h16, w16, 2))
        ref0 = torch.where(intra, 0, cell["ref"].reshape(h16, w16))
        (ry, rcb, rcr), sse, sao = self._filter_and_metrics(
            (y, cb, cr), (ry, rcb, rcr), (ly, lcb, lcr), kinds, split,
            (torch.where(intra, 0, 1), mv0, torch.zeros_like(mv0)), maps, qp,
            ref0)
        out = dict(split=split.to(torch.int8),
                   kinds=kinds.reshape(h16, w16).to(torch.uint8),
                   merge=cell["merge"].reshape(h16, w16).to(torch.uint8),
                   mvd=cell["mvd"].reshape(h16, w16, 2).to(torch.int16),
                   mvp=cell["mvp"].reshape(h16, w16).to(torch.uint8),
                   ref=cell["ref"].reshape(h16, w16).to(torch.uint8),
                   modes=modes.to(torch.uint8),
                   ly=ly.reshape(h16, w16, 16, 16),
                   lcb=lcb.reshape(h16, w16, 8, 8),
                   lcr=lcr.reshape(h16, w16, 8, 8), sse=sse, **sao)
        rec8 = tuple(t.to(torch.uint8) for t in (ry, rcb, rcr))
        if want_recon:
            out.update(rec_y=rec8[0], rec_cb=rec8[1], rec_cr=rec8[2])
        if want_costs:
            out["costs"] = {k: dec[k] for k in ("jsq", "js32", "jsplit",
                                               "j32")}
        return out, rec8

    # ---- host interface --------------------------------------------------

    def _upload(self, a):
        return torch.as_tensor(np.ascontiguousarray(a), device=self.device)

    def _to_host(self, dev: dict, recon_dev):
        """Pack the frame's levels (K15, one launch; JAX `_mux_small`
        :781-795, cap = T / 8), then start the D2H copy of every output but
        the dense levels (pinned memory, non-blocking on the card), which
        stay on the device in case the pack overflows; the recon planes
        stay on the device as the next reference."""
        costs = dev.pop("costs", None)
        dense = [dev.pop(k)[None] for k in ("ly", "lcb", "lcr")]
        dev.update(levels_for_host(dense, 8))
        return dict(recon_dev=recon_dev, costs=costs, dense=dense,
                    **start_host_copy(dev, self.device))

    def _ref_list(self, ref_dev, ref_pocs, poc):
        """The L0 list as stacked int32 planes (luma, cb, cr) [R, H, W] and
        its tables (dsf [R, R] int32, refbits [R] f32; JAX `encode_async`
        :1087-1101) on the device.  ref_dev: a list of (y, cb, cr) tuples of
        device planes, nearest first, or one tuple (a one-picture list);
        ref_pocs default to 0..R-1."""
        if not isinstance(ref_dev, list):
            ref_dev = [ref_dev]
        refs = tuple(torch.stack([r[k].to(torch.int32) for r in ref_dev])
                     for k in range(3))
        pocs = list(range(len(ref_dev))) if ref_pocs is None else ref_pocs
        dsf, bits = ref_list_tables(poc, pocs)
        return refs, (self._upload(dsf), self._upload(bits))

    def encode_async(self, y, cb, cr, ref_dev, qp: int, want_recon=False,
                     want_costs=False, qp_offsets=None, ref_pocs=None,
                     poc: int = 0):
        """Dispatch one P frame (numpy uint8 planes) against ``ref_dev``:
        the reference's device planes (y, cb, cr), or a list of them, the
        L0 list nearest first, whose POCs ``ref_pocs`` and the picture's
        ``poc`` give the MV scale factors; with optional per-16-cell QP
        offsets.  Returns a handle."""
        refs, tables = self._ref_list(ref_dev, ref_pocs, poc)
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), refs, qp, tables,
                              want_recon=want_recon, want_costs=want_costs,
                              qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def encode_async_load(self, y, cb, cr, ref_dev, qp: int, split, kinds,
                          merge_idx, mvd, mvp_idx, modes, want_recon=False,
                          qp_offsets=None, ref_idx=None, ref_pocs=None,
                          poc: int = 0):
        """One P frame under given decisions, as `InterFrameResult` carries
        them (split [hc, wc]; kinds, merge_idx, mvp_idx, modes and, with
        several references, the L0 index ref_idx [h16, w16]; mvd [h16, w16,
        2]).  Phases 1 and 2 are skipped: each cell's MV and reference are
        rebuilt in z-order from the same merge/AMVP derivation (on the card
        by K17's forced mode)."""
        dev = self.device
        refs, tables = self._ref_list(ref_dev, ref_pocs, poc)

        def t(a, dt):
            return torch.as_tensor(np.asarray(a, dt), device=dev)
        kinds, merge = t(kinds, np.int64), t(merge_idx, np.int64)
        choice = torch.where(kinds == 0, merge, torch.where(kinds == 1, 2,
                                                            3)).reshape(-1)
        ref = torch.zeros_like(choice, dtype=torch.int32) \
            if ref_idx is None else t(ref_idx, np.int32).reshape(-1)
        c16 = (choice, t(mvd, np.int32).reshape(-1, 2),
               t(mvp_idx, np.int32).reshape(-1), ref)
        # a CU32's decision is replicated over its cells: read it at q0
        q0 = self._q0_cell
        forced = dict(scan=dict(c16=c16, c32=[v[q0] for v in c16],
                                split=t(split, bool).reshape(-1)),
                      modes=t(modes, np.int32).reshape(-1))
        out, rec = self._step(self._upload(y), self._upload(cb),
                              self._upload(cr), refs, qp, tables,
                              forced=forced, want_recon=want_recon,
                              qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    @staticmethod
    def wait(handle) -> None:
        if handle["event"] is not None:
            handle["event"].synchronize()

    def collect(self, handle) -> InterFrameResult:
        self.wait(handle)
        h = {k: v.numpy() for k, v in handle["host"].items()}
        res = InterFrameResult(
            h["kinds"].astype(np.int32), h["merge"].astype(np.int32),
            h["mvd"].astype(np.int32), h["mvp"].astype(np.int32),
            h["modes"].astype(np.int32),
            *levels_from_host(h, 0, handle["dense"]), h["sse"],
            recon_dev=handle["recon_dev"],
            split=h["split"].astype(np.int32),
            ref0=h["ref"].astype(np.int32), sao=sao_of_host(h))
        if "rec_y" in h:
            res.recon_y, res.recon_cb, res.recon_cr = (
                h["rec_y"], h["rec_cb"], h["rec_cr"])
        return res


# ---------------------------------------------------------------------------
# B slices
# ---------------------------------------------------------------------------

# B choice index (skip merge 0, skip merge 1, AMVP L0, AMVP L1, AMVP bi,
# intra) -> kind and prediction direction (the merge choices take their
# candidate's direction)
_KIND_OF_CHOICE_B = (0, 0, 1, 1, 1, 2)
_DIR_OF_CHOICE_B = (0, 0, 1, 2, 3, 0)


class BTreeEncoder(InterTreeEncoder):
    """B-slice CTU32 quadtree encoder, one reference per list: the port of
    the JAX package's `models/inter_tree.py:BTreeEncoder` (:1186-1818).

    The P tree's phases with two reference lists:

    1. ME at CU16 and CU32 on both references (K5, K6) and the half-pel
       grids (K8, K5); the L0, L1 and bi trials (K7 twice, K9, K2, K3 at
       B init states) and the intra trial (K1-K3).
    2. The decide scan (JAX :1317-1570): merge-B candidates with pruning
       and zero-bi fill, AMVP per list with cross-list scaling, skip
       priced on the SSD grids (the mean of both lists' for a bi
       candidate), the costs with XLA's FMAs.  On the card one launch of
       K19 (`decide_b`: a thread a CTU32 row walking the wavefront, no
       scratch); on the CPU its plain version, a Python loop over the
       CTU32 anti-diagonals with the CU32 and q0 decisions of a diagonal
       in one call.
    3. Final MC (`mc_select` :1610-1624: K7 per list, K9 where both lists
       are used) and residuals (K2), then the shared commit scan of intra
       cells (K20 on the card).
    4. Deblock with both lists' motion (K4), SAO (K10, K11), metrics.

    `encode_async_load` replays given B decisions through the same
    candidate derivation."""

    ST = "B"

    def __init__(self, *args, **kw):
        super().__init__(*args, **kw)
        dev = self.device
        self._kind_of_choice_b = torch.tensor(_KIND_OF_CHOICE_B, device=dev)
        self._dir_of_choice_b = torch.tensor(_DIR_OF_CHOICE_B,
                                             dtype=torch.int32, device=dev)
        self._b_order = torch.tensor(B_ORDER, device=dev)

    # ---- phase 1 -------------------------------------------------------------

    def _phase1_b(self, y, refs, maps, excess):
        """ME on both lists, the trials and the intra trial.  Returns
        raster-order tensors: mv{l}_{bn} [nb, 2], d{bn} and rb{bn} [nb, 3]
        (L0, L1, bi), grid{l} (the stacked SSD grids of list l), di16 and
        imode16."""
        st = self._motion_b(y, refs, maps)
        st.update(self._trials_b(y, refs, maps, st, excess))
        st["di16"], st["imode16"] = self._intra_trial16(
            _blocks(y, 16), _blocks(y, 16).reshape(-1, 16, 16),
            maps["qp16"], maps["lam16"])
        return st

    def _motion_b(self, y, refs, maps):
        """ME on both lists (JAX :1233-1260): the P tree's integer search,
        refinement and half-pel grids per reference (K5, K6, K8), keyed
        mv{l}_{bn} and grid{l}."""
        st = {}
        for li, ref in enumerate(refs):
            m = self._motion_search(y, ref, maps)
            m.update(self._subpel(y, ref, maps, m))
            st.update({f"mv{li}_16": m["mv16"], f"mv{li}_32": m["mv32"],
                       f"grid{li}": self._stack_grids([m])})
        return st

    def _trials_b(self, y, refs, maps, st1, excess):
        """The L0, L1 and bi trials at each CU size (JAX :1265-1285): the
        uni predictions (K7), the bi-prediction (K9, its window check
        appended to ``excess``), the residual chain with inter rounding and
        no SBH (K2), its SSD and bits at B init states (K3)."""
        sr = self.sr
        st = {}
        for bn, q in ((16, maps["qp16"]), (32, maps["qp32"])):
            mv0, mv1 = st1[f"mv0_{bn}"], st1[f"mv1_{bn}"]
            pred = torch.stack([
                mc_luma_qpel(refs[0], mv0, bn), mc_luma_qpel(refs[1], mv1, bn),
                mc_bi(refs[0], refs[1], mv0, mv1, bn, False, sr + 2,
                      excess)], 1)
            lv, _, ssd = residual_chain(_blocks(y, bn).reshape(-1, bn, bn),
                                        pred, q, False, want_recon=False,
                                        intra=False)
            st[f"d{bn}"] = ssd.to(torch.float32)
            st[f"rb{bn}"] = tu_bits(lv, 0, q[:, None].expand(-1, 3), self.ST)
        return st

    # ---- phase 2: decide scan --------------------------------------------------

    def _decide_cu_b(self, av, dirs, mv0s, mv1s, x, row, ngrid, dsf,
                     forced=None):
        """One B CU decision per lane (JAX `decide_cu` :1336) from its
        candidates av, dirs [L, 4], mv0s, mv1s [L, 4, 2] in the order A1,
        B1, B0, B2.  x = (d [L, 3], rb [L, 3], mv0me, mv1me [L, 2], lam [L],
        di [L], inf where the CU has no intra option); row is the lane's
        grid row, ngrid the offset of the half-pel grids.  ``forced`` =
        (choice, mvd0, mvp0, mvd1, mvp1) replays a decision.  Returns
        (choice [L], dir, mv0, mv1, mvd0, mvp0, mvd1, mvp1, js [L, 6] or
        None)."""
        sr, s = self.sr, 2 * self.sr + 1
        pa, pb = self._prune_a, self._prune_b
        eq = ((dirs[:, pb] == dirs[:, pa])
              & (mv0s[:, pb] == mv0s[:, pa]).all(-1)
              & (mv1s[:, pb] == mv1s[:, pa]).all(-1) & av[:, pa])
        avs = av.clone()
        avs[:, 1:3] &= ~eq[:, 0:2]
        avs[:, 3] &= ~(eq[:, 2] | eq[:, 3])
        pos = torch.cumsum(avs.to(torch.int32), 1)
        sel = avs[:, :, None] & (pos[:, :, None] == self._one_two)  # [L,4,2]
        mrg_d = torch.where(sel.any(1), (dirs[:, :, None] * sel).sum(
            1, dtype=torch.int32), 3)                                 # [L,2]
        mrg_v0 = (mv0s[:, :, None, :] * sel[..., None]).sum(
            1, dtype=torch.int32)                                     # [L,2,2]
        mrg_v1 = (mv1s[:, :, None, :] * sel[..., None]).sum(
            1, dtype=torch.int32)
        a0 = amvp_b(av, dirs, mv0s, mv1s, 0, dsf[0], self._b_order)
        a1 = amvp_b(av, dirs, mv1s, mv0s, 1, dsf[1], self._b_order)
        if forced is not None:
            choice, mvd0, mvp0, mvd1, mvp1 = forced
            mv0me = torch.where((mvp0 == 1)[:, None], a0[1], a0[0]) + mvd0
            mv1me = torch.where((mvp1 == 1)[:, None], a1[1], a1[0]) + mvd1
            js = None
        else:
            d, rb, mv0me, mv1me, lamv, di = x

            def pick_mvp(mvq, amvp):
                mvds = mvq[:, None] - torch.stack(amvp, 1)       # [L, 2, 2]
                bits = mvd_bits(mvds)
                use_b = bits[:, 1] < bits[:, 0]
                return (torch.where(use_b[:, None], mvds[:, 1], mvds[:, 0]),
                        use_b.to(torch.int32), bits.amin(1))
            mvd0, mvp0, bits0 = pick_mvp(mv0me, a0)
            mvd1, mvp1, bits1 = pick_mvp(mv1me, a1)

            def lookup(grid, v):
                sub = ((v & 3) != 0).any(-1)
                mi = v >> 2
                inside = (mi.abs() <= sr).all(-1)
                mi = torch.clamp(mi + sr, 0, s - 1).long()
                val = grid[row[:, None] + sub * ngrid, mi[..., 1], mi[..., 0]]
                return torch.where(inside, val, 1e18)
            l0 = lookup(self._grid0, mrg_v0)                          # [L, 2]
            l1 = lookup(self._grid1, mrg_v1)
            # every cost's product has one use, the add after it, and
            # XLA's CPU code fuses the two (the decide fusion's object
            # code): fma32 where JAX writes a + lam * x
            skip = fma32(lamv[:, None], self._skip_bins, torch.where(
                mrg_d == 3, 0.5 * (l0 + l1), torch.where(mrg_d == 1, l0,
                                                         l1)))
            j_l0 = fma32(lamv, (rb[:, 0] + bits0) + 8.0, d[:, 0])
            j_l1 = fma32(lamv, (rb[:, 1] + bits1) + 8.0, d[:, 1])
            j_bi = fma32(lamv, ((rb[:, 2] + bits0) + bits1) + 10.0, d[:, 2])
            intra = torch.where(torch.isinf(di), di,
                                fma32(lamv, self._hdr_bits, di))
            js = torch.cat([skip, torch.stack([j_l0, j_l1, j_bi, intra], 1)],
                           1)
            choice = torch.argmin(js, 1)
        dir_fin = torch.where(choice <= 1, torch.gather(
            mrg_d, 1, torch.clamp(choice, max=1)[:, None])[:, 0],
            self._dir_of_choice_b[choice])

        def fin(mrg, me, bit):
            v = torch.where((choice == 0)[:, None], mrg[:, 0], torch.where(
                (choice == 1)[:, None], mrg[:, 1], me))
            return torch.where(((dir_fin & bit) == bit)[:, None], v, 0)
        return (choice, dir_fin, fin(mrg_v0, mv0me, 1), fin(mrg_v1, mv1me, 2),
                mvd0, mvp0, mvd1, mvp1, js)

    def _decide_b(self, st1, maps, dsf, forced=None, want_costs=False):
        """The B decide scan: on the card one launch of K19 (`decide_b`),
        on the CPU its plain version.  Returns raster maps (see
        `_decide_b_plain`)."""
        if self.device.type == "cpu":
            return self._decide_b_plain(st1, maps, dsf, forced, want_costs)
        return self._decide_b_kernel(st1, maps, dsf, forced, want_costs)

    def _decide_b_plain(self, st1, maps, dsf, forced=None,
                        want_costs=False):
        """The B decide scan over the CTU32 diagonals (JAX :1317-1570; the
        lane layout of the P scan), the plain version of K19.  Returns
        raster maps: split [hc, wc], per CTU the CU32 choice, MVDs and MVP
        indices, per 16-cell the quadrant's, and the cells' final direction
        and MVs (plus, with want_costs, the cost rows [., 6] and the split
        costs).  ``forced`` holds raster (choice, mvd0, mvp0, mvd1, mvp1)
        per 16-cell (c16) and per CTU (c32) and the split [n32]."""
        dev = self.device
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc
        n16, n32 = h16 * w16, hc * wc
        p32, p16 = self._perm32, self._perm16

        def pair(a, b):
            return torch.stack([a, b], 1)
        row01 = pair(2 * n16 + p32, p16[:, 0])
        ng01 = pair(torch.full_like(p32, n32), torch.full_like(p32, n16))
        if forced is None:
            self._grid0, self._grid1 = st1["grid0"], st1["grid1"]
            q16 = [t[p16] for t in (st1["d16"], st1["rb16"], st1["mv0_16"],
                                    st1["mv1_16"], maps["lam16"],
                                    st1["di16"])]
            x01 = [pair(st1[k][p32], c[:, 0]) for k, c in zip(
                ("d32", "rb32", "mv0_32", "mv1_32"), q16)]
            x01 += [pair(maps["lam32"][p32], q16[4][:, 0]),
                    pair(self._inf.expand(n32), q16[5][:, 0])]
        else:
            f16 = [t[p16] for t in forced["c16"]]
            f01 = [pair(t[p32], c[:, 0]) for t, c in zip(forced["c32"],
                                                         f16)]
            fsplit = forced["split"][p32]
        dir_map = torch.zeros((h16, w16), dtype=torch.int32, device=dev)
        mv0_map = torch.zeros((h16, w16, 2), dtype=torch.int32, device=dev)
        mv1_map = torch.zeros((h16, w16, 2), dtype=torch.int32, device=dev)
        zero_mv = self._zero_mv[0]
        outs = []
        for lane in self._lanes:
            sl = lane["sl"]
            b = sl.stop - sl.start
            ny, nx = lane["ny"], lane["nx"]
            ndir = dir_map[ny, nx]
            nav = lane["nok"] & (ndir > 0)
            nm0 = mv0_map[ny, nx]
            nm1 = mv1_map[ny, nx]
            row_ = row01[sl].reshape(-1)
            ng_ = ng01[sl].reshape(-1, 1)

            def flat(t):
                return t[sl].reshape((2 * b,) + t.shape[2:])
            args01 = (nav[:, 0:8].reshape(2 * b, 4),
                      ndir[:, 0:8].reshape(2 * b, 4),
                      nm0[:, 0:8].reshape(2 * b, 4, 2),
                      nm1[:, 0:8].reshape(2 * b, 4, 2))
            if forced is None:
                r01 = self._decide_cu_b(*args01, [flat(t) for t in x01],
                                        row_, ng_, dsf)

                def q_call(q, cand):
                    return self._decide_cu_b(
                        *cand, [t[sl, q] for t in q16], p16[sl, q], n16, dsf)
            else:
                r01 = self._decide_cu_b(*args01, None, row_, ng_, dsf,
                                        forced=[flat(t) for t in f01])

                def q_call(q, cand):
                    return self._decide_cu_b(
                        *cand, None, None, None, dsf,
                        forced=[c[sl, q] for c in f16])
            c32 = [t[0::2] if t is not None else None for t in r01]
            q0 = [t[1::2] if t is not None else None for t in r01]

            def loc(r):               # (available, dir, mv0, mv1)
                return r[0] <= 4, r[1], r[2], r[3]

            def ext(k):
                return nav[:, k], ndir[:, k], nm0[:, k], nm1[:, k]

            def cands(*cs):
                return [torch.stack([c[i] for c in cs], 1) for i in range(4)]
            none = (self._no.expand(b), torch.zeros_like(q0[1]),
                    zero_mv.expand(b, 2), zero_mv.expand(b, 2))
            q1 = q_call(1, cands(loc(q0), ext(8), ext(9), ext(10)))
            q2 = q_call(2, cands(ext(11), loc(q0), loc(q1), ext(12)))
            q3 = q_call(3, cands(loc(q2), loc(q1), none, loc(q0)))
            qs = (q0, q1, q2, q3)
            if forced is None:
                jq = [q[8].amin(1) for q in qs]
                jsplit = ((jq[0] + jq[1]) + jq[2]) + jq[3]
                j32 = c32[8].amin(1)
                split = jsplit < j32
            else:
                split = fsplit[sl]

            def qst(i):
                return torch.stack([q[i] for q in qs], 1)
            sp = split[:, None]
            cell_dir = torch.where(sp, qst(1), c32[1][:, None])
            cell_v0 = torch.where(sp[..., None], qst(2), c32[2][:, None])
            cell_v1 = torch.where(sp[..., None], qst(3), c32[3][:, None])
            dir_map[lane["cys"], lane["cxs"]] = cell_dir
            mv0_map[lane["cys"], lane["cxs"]] = cell_v0
            mv1_map[lane["cys"], lane["cxs"]] = cell_v1
            out = [split, c32[0], c32[4], c32[5], c32[6], c32[7], qst(0),
                   qst(4), qst(5), qst(6), qst(7), cell_dir, cell_v0,
                   cell_v1]
            if want_costs:
                out += [qst(8), c32[8], jsplit, j32]
            outs.append(out)
        cat = [torch.cat(o, 0) for o in zip(*outs)]

        def to32(t):
            r = torch.empty((n32,) + t.shape[1:], dtype=t.dtype, device=dev)
            r[p32] = t
            return r

        def to16(t):
            r = torch.empty((n16,) + t.shape[2:], dtype=t.dtype, device=dev)
            r[p16.reshape(-1)] = t.reshape((-1,) + t.shape[2:])
            return r
        names32 = ("ch32", "mvd0_32", "mvp0_32", "mvd1_32", "mvp1_32")
        names16 = ("chq", "mvd0q", "mvp0q", "mvd1q", "mvp1q", "dir", "mv0",
                   "mv1")
        res = dict(split=to32(cat[0]).reshape(hc, wc))
        res.update({k: to32(t) for k, t in zip(names32, cat[1:6])})
        res.update({k: to16(t) for k, t in zip(names16, cat[6:14])})
        if want_costs:
            res.update(jsq=to16(cat[14]), js32=to32(cat[15]),
                       jsplit=to32(cat[16]), j32=to32(cat[17]))
        self._grid0 = self._grid1 = None
        return res

    def _decide_b_kernel(self, st1, maps, dsf, forced=None,
                         want_costs=False):
        """The B decide scan as one launch of K19 (`csrc/decide_b.cu`), free
        or forced; the same raster outputs as `_decide_b_plain`."""
        dev = self.device
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc
        n16, n32 = h16 * w16, hc * wc
        i32, f32 = torch.int32, torch.float32

        def c(t, dt):
            return t.to(dt).contiguous()
        keep = []                    # the tensors the launch reads

        def p(t):
            keep.append(t)
            return cuda_lib.ptr(t)
        a = _DecideBArgs(wc=wc, hc=hc, w16=w16, h16=h16, sr=self.sr,
                         dsf0=int(dsf[0]), dsf1=int(dsf[1]),
                         intra_hdr_bits=_INTRA_HDR_BITS)
        if forced is None:
            a.grid0, a.grid1 = p(c(st1["grid0"], f32)), p(c(st1["grid1"],
                                                            f32))
            for k, dt in (("d32", f32), ("rb32", f32), ("mv0_32", i32),
                          ("mv1_32", i32), ("d16", f32), ("rb16", f32),
                          ("mv0_16", i32), ("mv1_16", i32), ("di16", f32)):
                setattr(a, k, p(c(st1[k], dt)))
            a.lam32, a.lam16 = p(c(maps["lam32"], f32)), \
                p(c(maps["lam16"], f32))
        else:
            for pre, vals in (("16", forced["c16"]), ("32", forced["c32"])):
                for k, v in zip(("f_ch", "f_mvd0_", "f_mvp0_", "f_mvd1_",
                                 "f_mvp1_"), vals):
                    setattr(a, k + pre, p(c(v, i32)))
            a.f_split = p(c(forced["split"], i32))

        def e(*shape):
            return torch.empty(shape, dtype=i32, device=dev)
        out = dict(split=e(n32), ch32=e(n32), mvd0_32=e(n32, 2),
                   mvp0_32=e(n32), mvd1_32=e(n32, 2), mvp1_32=e(n32),
                   chq=e(n16), mvd0q=e(n16, 2), mvp0q=e(n16),
                   mvd1q=e(n16, 2), mvp1q=e(n16), dir=e(n16),
                   mv0=e(n16, 2), mv1=e(n16, 2))
        if want_costs and forced is None:
            out.update(jsq=torch.empty((n16, 6), dtype=f32, device=dev),
                       js32=torch.empty((n32, 6), dtype=f32, device=dev),
                       jsplit=torch.empty(n32, dtype=f32, device=dev),
                       j32=torch.empty(n32, dtype=f32, device=dev))
        for k, v in out.items():
            setattr(a, k, p(v))
        cuda_lib.require_cuda(*keep)
        _launch("decide_b", _DecideBArgs, a, keep[0])
        out["split"] = out["split"].bool().reshape(hc, wc)
        out["ch32"] = out["ch32"].long()
        out["chq"] = out["chq"].long()
        return out

    def _cell_decisions_b(self, dec):
        """Per 16-cell kinds, merge index, MVDs and MVP indices of both
        lists (the quadrant's where its CTU is split, else the CU32's) and
        the final direction and MVs."""
        h16, w16, hc, wc = self.h16, self.w16, self.hc, self.wc

        def rep(t):
            t = t.reshape((hc, wc) + t.shape[1:])
            return t.repeat_interleave(2, 0).repeat_interleave(2, 1) \
                .reshape((h16 * w16,) + t.shape[2:])
        sp = rep(dec["split"].reshape(-1))
        kind_tab = self._kind_of_choice_b
        ch = torch.where(sp, dec["chq"], rep(dec["ch32"]))
        out = dict(split_cell=sp, kinds=kind_tab[ch],
                   merge=torch.clamp(ch, max=1), k32=kind_tab[dec["ch32"]],
                   dir=dec["dir"], mv0=dec["mv0"], mv1=dec["mv1"])
        for k in ("mvd0", "mvp0", "mvd1", "mvp1"):
            q, c = dec[k + "q"], rep(dec[k + "_32"])
            out[k] = torch.where(sp[:, None] if q.dim() == 2 else sp, q, c)
        return out

    # ---- phase 3 ---------------------------------------------------------------

    def _final_mc_b(self, refs0, refs1, cell, excess):
        """`mc_select` (JAX :1610-1624) at the cells' final motion."""
        return mc_select(refs0, refs1, cell["dir"], cell["mv0"], cell["mv1"],
                         self.sr, excess)

    # ---- one B frame -------------------------------------------------------------

    def _step_b(self, y, cb, cr, refs0, refs1, qp: int, dsf, forced=None,
                want_recon=False, want_costs=False, qp_offsets=None):
        maps = self._maps(qp, qp_offsets)
        y, cb, cr = (t.to(torch.int32) for t in (y, cb, cr))
        refs0 = tuple(t.to(torch.int32) for t in refs0)
        refs1 = tuple(t.to(torch.int32) for t in refs1)
        h16, w16 = self.h16, self.w16
        excess = []             # K9's window checks, read in collect
        if forced is None:
            st1 = self._phase1_b(y, (refs0[0], refs1[0]), maps, excess)
            dec = self._decide_b(st1, maps, dsf, want_costs=want_costs)
            imode = st1["imode16"]
        else:
            dec = self._decide_b(None, maps, dsf, forced=forced["scan"])
            imode = forced["modes"]
        cell = self._cell_decisions_b(dec)
        lv, rec = self._phase3(y, cb, cr, self._final_mc_b(
            refs0, refs1, cell, excess), maps, cell)
        kinds = cell["kinds"]
        (ry, rcb, rcr), (ly, lcb, lcr), modes = self._commit(
            y, cb, cr, maps, kinds, imode, lv, rec)
        split = dec["split"]
        motion = (cell["dir"].reshape(h16, w16),
                  cell["mv0"].reshape(h16, w16, 2),
                  cell["mv1"].reshape(h16, w16, 2))
        (ry, rcb, rcr), sse, sao = self._filter_and_metrics(
            (y, cb, cr), (ry, rcb, rcr), (ly, lcb, lcr), kinds, split,
            motion, maps, qp)

        def cells(t, dt, *shape):
            return t.reshape((h16, w16) + shape).to(dt)
        out = dict(split=split.to(torch.int8),
                   kinds=cells(kinds, torch.uint8),
                   merge=cells(cell["merge"], torch.uint8),
                   dir=cells(cell["dir"], torch.uint8),
                   mvd0=cells(cell["mvd0"], torch.int16, 2),
                   mvp0=cells(cell["mvp0"], torch.uint8),
                   mvd1=cells(cell["mvd1"], torch.int16, 2),
                   mvp1=cells(cell["mvp1"], torch.uint8),
                   modes=modes.to(torch.uint8),
                   ly=ly.reshape(h16, w16, 16, 16),
                   lcb=lcb.reshape(h16, w16, 8, 8),
                   lcr=lcr.reshape(h16, w16, 8, 8), sse=sse,
                   window_excess=torch.stack(excess).amax(), **sao)
        rec8 = tuple(t.to(torch.uint8) for t in (ry, rcb, rcr))
        if want_recon:
            out.update(rec_y=rec8[0], rec_cb=rec8[1], rec_cr=rec8[2])
        if want_costs:
            out["costs"] = {k: dec[k] for k in ("jsq", "js32", "jsplit",
                                               "j32")}
        return out, rec8

    # ---- host interface ------------------------------------------------------

    def encode_async(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                     dsf0: int, dsf1: int, want_recon=False,
                     want_costs=False, qp_offsets=None):
        """Dispatch one B frame (numpy uint8 planes) between the reference
        device planes ``ref0_dev`` (L0) and ``ref1_dev`` (L1); dsf0 / dsf1
        scale a neighbour's other-list MV to list 0 / 1 (`mvpred.
        dist_scale_factor`); optional per-16-cell QP offsets.  Returns a
        handle."""
        out, rec = self._step_b(
            self._upload(y), self._upload(cb), self._upload(cr), ref0_dev,
            ref1_dev, qp, (dsf0, dsf1), want_recon=want_recon,
            want_costs=want_costs, qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def encode_async_load(self, y, cb, cr, ref0_dev, ref1_dev, qp: int,
                          dsf0: int, dsf1: int, split, kinds, merge_idx,
                          inter_dir, mvd0, mvp0, mvd1, mvp1, modes,
                          want_recon=False, qp_offsets=None):
        """One B frame under given decisions, as `BFrameResult` carries
        them; each cell's MVs are rebuilt in z-order from the same
        merge/AMVP derivation."""
        dev = self.device

        def t(a, dt=np.int64):
            return torch.as_tensor(np.asarray(a, dt), device=dev)
        kinds, merge, idir = t(kinds), t(merge_idx), t(inter_dir)
        choice = torch.where(kinds == 0, merge, torch.where(
            kinds == 1, 1 + idir, 5)).reshape(-1)
        vals = (choice, t(mvd0, np.int32).reshape(-1, 2),
                t(mvp0, np.int32).reshape(-1),
                t(mvd1, np.int32).reshape(-1, 2),
                t(mvp1, np.int32).reshape(-1))
        # a CU32's decision is replicated over its cells: read it at q0
        q0 = self._q0_cell
        forced = dict(scan=dict(c32=[v[q0] for v in vals], c16=vals,
                                split=t(split, bool).reshape(-1)),
                      modes=t(modes, np.int32).reshape(-1))
        out, rec = self._step_b(
            self._upload(y), self._upload(cb), self._upload(cr), ref0_dev,
            ref1_dev, qp, (dsf0, dsf1), forced=forced, want_recon=want_recon,
            qp_offsets=qp_offsets)
        return self._to_host(out, rec)

    def collect(self, handle) -> BFrameResult:
        """The frame's result; raises if an MV given to K9 broke the window
        contract (`ops.me.check_window`)."""
        self.wait(handle)
        h = {k: v.numpy() for k, v in handle["host"].items()}
        check_window(h["window_excess"])

        def i32(k):
            return h[k].astype(np.int32)
        res = BFrameResult(
            i32("kinds"), i32("merge"), i32("dir"), i32("mvd0"), i32("mvp0"),
            i32("mvd1"), i32("mvp1"), i32("modes"),
            *levels_from_host(h, 0, handle["dense"]), h["sse"], recon_dev=handle["recon_dev"],
            split=i32("split"), sao=sao_of_host(h))
        if "rec_y" in h:
            res.recon_y, res.recon_cb, res.recon_cr = (
                h["rec_y"], h["rec_cb"], h["rec_cr"])
        return res
