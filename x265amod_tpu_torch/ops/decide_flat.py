"""The decide scans of the flat CTB16 P and B frames: kernels K24 and K25
(`csrc/decide_flat.cu`), each beside its plain PyTorch version.

Counterparts in the JAX package: the `lax.scan` of `decide_body` in
`models/inter_frame.py` (:240-315, P) and `models/b_frame.py` (:242-390, B).
Each CTU16 of an anti-diagonal d = cx + 2 cy derives its merge and AMVP
candidates from its left (A1), top (B1), top-right (B0) and top-left (B2)
CTUs, which earlier diagonals decided, and picks the first minimum of its RD
costs:

- P: [skip on merge candidate 0, skip on candidate 1, AMVP inter, intra];
  the merge list prunes on MVs and fills with the zero MV;
- B: [skip 0, skip 1, AMVP L0, AMVP L1, AMVP bi, intra]; the merge list
  prunes on (direction, MV0, MV1) and fills with zero bi; each list's AMVP
  pair takes a neighbour's own-list MV or its other-list MV scaled by that
  list's dsf (spec 8.5.3.2.8).

A skip candidate is priced in the integer SSD grid at its MV >> 2 (an
arithmetic shift, so a negative quarter-pel MV floors), 1e18 outside +-sr;
a bi candidate at the mean of both lists'.  Every cost whose product has one
use takes an FMA, as XLA's CPU code contracts it (the object code of both
decide fusions: a vfmadd for each): skip fma(lam, 2 or 3, grid value), P
inter fma(lam, (rb + min(b0, b1)) + 6, d), B uni fma(lam, (rb + bits) + 8,
d), bi fma(lam, ((rb + bits0) + bits1) + 10, d), intra fma(lam, header bins,
intra trial cost).

Every input and output is raster [n] over the CTB16 grid.  A ``forced``
decision (choice, MVDs and MVP indices) replays through the same candidate
derivation: an AMVP cell's MV is its predictor plus its MVD.  A CPU tensor
takes the plain version (a Python loop over the diagonals); a CUDA tensor
launches the kernel (one launch a frame), `LAUNCHES["decide_flat"]` (K24)
and `LAUNCHES["decide_flat_b"]` (K25) counting them.  Both walk the grid a
thread a CTU row (CTU (t - 2 r, r) at step t, the same wavefront), their
neighbours' commits in registers and one shared-memory slot, their inputs
loaded a step ahead, no scratch (`csrc/decide_flat.cu`).
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .me import mvd_bits
from .rdoq import fma32

# P choice (skip 0, skip 1, AMVP, intra) -> kind; B choice (skip 0, skip 1,
# L0, L1, bi, intra) -> kind and AMVP direction
KIND_OF_CHOICE_P = (0, 0, 1, 2)
KIND_OF_CHOICE_B = (0, 0, 1, 1, 1, 2)
DIR_OF_CHOICE_B = (0, 0, 1, 2, 3, 0)
# merge pruning over (A1, B1, B0, B2): B1 vs A1, B0 vs B1, B2 vs A1, B2 vs B1
PRUNE_B = [1, 2, 3, 3]
PRUNE_A = [0, 1, 0, 1]
# the AMVP B candidates in spec order (B0, B1, B2) among (A1, B1, B0, B2)
B_ORDER = [2, 1, 3]


def scale_mv_vec(mv, dsf):
    """Spec 8.5.3.2.8 MV scaling (JAX `b_frame.py:_scale_mv_vec` :68):
    ``sign(x) ((|x| + 127) >> 8)`` of x = dsf mv, clipped to 16 bits; mv
    [..., 2] int32 qpel; dsf an int or an int32 tensor that broadcasts
    against mv."""
    x = mv.to(torch.int32) * (dsf.to(torch.int32)
                              if isinstance(dsf, torch.Tensor) else int(dsf))
    mag = (x.abs() + 127) >> 8
    return torch.clamp(torch.sign(x) * mag, -32768, 32767).to(torch.int32)


def amvp_b(av, dirs, own, other, li: int, dsf, order):
    """AMVP pair of list ``li`` (JAX `b_frame.py:amvp` :293-325, and the B
    tree's `inter_tree.py:amvp` :1370) per lane from the candidates av,
    dirs [L, 4], own/other [L, 4, 2] (the lane's list-li and other-list
    MVs) in the order A1, B1, B0, B2: A from A1 (its own MV, or its other
    list's scaled by dsf), B the first of B0, B1, B2 (``order``, a device
    tensor of `B_ORDER`) holding list li unscaled, else the first
    available scaled; pruned and zero-filled.  Returns (c0, c1) [L, 2]."""
    has = ((dirs >> li) & 1) == 1
    mvp = torch.where(has[..., None], own, scale_mv_vec(other, dsf))
    a1v = av[:, 0]
    bav, bhas = av[:, order], has[:, order]
    hasx = bav & bhas
    ownx, mvpx = own[:, order], mvp[:, order]
    bp1_v = hasx.any(1)
    bp1 = torch.where(hasx[:, 0, None], ownx[:, 0], torch.where(
        hasx[:, 1, None], ownx[:, 1], ownx[:, 2]))
    bs_v = bav.any(1)
    bs = torch.where(bav[:, 0, None], mvpx[:, 0], torch.where(
        bav[:, 1, None], mvpx[:, 1], mvpx[:, 2]))
    c0 = torch.where(a1v[:, None], mvp[:, 0], torch.where(
        bp1_v[:, None], bp1, torch.where(bs_v[:, None], bs, 0)))
    c1raw = torch.where(a1v[:, None],
                        torch.where(bp1_v[:, None], bp1, 0),
                        torch.where((bp1_v & bs_v)[:, None], bs, 0))
    c1_v = torch.where(a1v, bp1_v, bp1_v & bs_v)
    dup = c1_v & (c1raw == c0).all(-1)
    return c0, torch.where((c1_v & ~dup)[:, None], c1raw, 0)


class Schedule:
    """The wavefront of a wc x hc CTB16 grid on one device: per diagonal
    the raster index of each lane and of its four neighbours (A1, B1, B0,
    B2, clamped into the grid, as the JAX `nb` reads them) with their
    availability, and the plain scans' index constants on the device (made
    once: an upload per diagonal would stall the card)."""

    _cache: dict = {}

    def __new__(cls, wc: int, hc: int, device):
        key = (wc, hc, torch.device(device))
        if key not in cls._cache:
            self = super().__new__(cls)
            self._build(wc, hc, torch.device(device))
            cls._cache[key] = self
        return cls._cache[key]

    def _build(self, wc, hc, dev):
        from ..models.intra_frame import _diag_schedule
        self.wc, self.hc, self.device = wc, hc, dev
        self.diags = _diag_schedule(wc, hc)
        self.prune_a, self.prune_b, self.b_order, self.one_two = (
            torch.tensor(v, device=dev) for v in (PRUNE_A, PRUNE_B,
                                                   B_ORDER, [1, 2]))
        self.skip_bins = torch.tensor([2.0, 3.0], device=dev)
        self.lanes = []
        for cells in self.diags:
            cx = np.array([c[0] for c in cells])
            cy = np.array([c[1] for c in cells])
            pos = [(cx - 1, cy, cx > 0), (cx, cy - 1, cy > 0),
                   (cx + 1, cy - 1, (cy > 0) & (cx < wc - 1)),
                   (cx - 1, cy - 1, (cx > 0) & (cy > 0))]
            nb = np.stack([np.clip(py, 0, hc - 1) * wc + np.clip(px, 0,
                                                                 wc - 1)
                           for px, py, _ in pos], 1)
            ok = np.stack([p[2] for p in pos], 1)
            self.lanes.append(tuple(torch.as_tensor(a, device=dev) for a in (
                cy * wc + cx, nb, ok)))


def _merge_select(sch, av, same):
    """The merge list's first two candidates: ``same`` [L, 4] compares the
    pairs (B1, A1), (B0, B1), (B2, A1), (B2, B1); the pruned candidates'
    [L, 4, 2] selectors of merge candidates 0 and 1."""
    eq = same & av[:, sch.prune_a]
    avs = av.clone()
    avs[:, 1:3] &= ~eq[:, 0:2]
    avs[:, 3] &= ~(eq[:, 2] | eq[:, 3])
    pos = torch.cumsum(avs.to(torch.int32), 1)
    return avs[:, :, None] & (pos[:, :, None] == sch.one_two)


def _lookup(grid, idx, mv, sr: int):
    """SSD-grid entries [L, K] of lanes idx [L] at qpel MVs mv [L, K, 2]:
    the integer grid at mv >> 2, 1e18 outside +-sr (JAX `grid_lookup`)."""
    s = 2 * sr + 1
    mi = mv >> 2
    inside = (mi.abs() <= sr).all(-1)
    mi = torch.clamp(mi + sr, 0, s - 1).long()
    val = grid[idx[:, None], mi[..., 1], mi[..., 0]]
    return torch.where(inside, val, 1e18)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def decide_p_plain(sch, grid, d, rb, di, mv_me, lam, sr: int, hdr: float,
                   forced=None, want_costs=False):
    """The P decide scan over the diagonals (JAX `decide_body` :240-311).
    grid [n, S, S] f32; d, rb, di, lam [n] f32; mv_me [n, 2] qpel; hdr the
    intra header bins (f32).  ``forced`` = (choice [n], mvd [n, 2], mvp
    [n]).  Returns raster dict: choice, mv (final, qpel), mvd, mvp (and js
    [n, 4] with want_costs)."""
    n = sch.wc * sch.hc
    dev = lam.device
    i32 = torch.int32
    mv_map = torch.zeros((n, 2), dtype=i32, device=dev)
    inter_map = torch.zeros(n, dtype=torch.bool, device=dev)
    out = dict(choice=torch.zeros(n, dtype=torch.int64, device=dev),
               mv=torch.zeros((n, 2), dtype=i32, device=dev),
               mvd=torch.zeros((n, 2), dtype=i32, device=dev),
               mvp=torch.zeros(n, dtype=i32, device=dev))
    if want_costs:
        out["js"] = torch.zeros((n, 4), dtype=torch.float32, device=dev)
    pa, pb = sch.prune_a, sch.prune_b
    for idx, nb, ok in sch.lanes:
        av = ok & inter_map[nb]                              # [L, 4]
        mv = mv_map[nb]                                      # [L, 4, 2]
        sel = _merge_select(sch, av, (mv[:, pb] == mv[:, pa]).all(-1))
        mrg = (mv[:, :, None, :] * sel[..., None]).sum(1, dtype=i32)
        # AMVP: A = A1; B = the first of B0, B1, B2, pruned against A
        a1, b1, b0 = av[:, 0], av[:, 1], av[:, 2]
        avb = av[:, 1:].any(1)
        mvb = torch.where(b0[:, None], mv[:, 2],
                          torch.where(b1[:, None], mv[:, 1], mv[:, 3]))
        avb2 = avb & ~(a1 & (mvb == mv[:, 0]).all(-1))
        amvp0 = torch.where(a1[:, None], mv[:, 0],
                            torch.where(avb2[:, None], mvb, 0))
        amvp1 = torch.where((a1 & avb2)[:, None], mvb, 0)
        if forced is None:
            mvq = mv_me[idx]
            lamv = lam[idx]
            mvds = mvq[:, None] - torch.stack([amvp0, amvp1], 1)
            bits = mvd_bits(mvds)
            use1 = bits[:, 1] < bits[:, 0]
            mvd = torch.where(use1[:, None], mvds[:, 1], mvds[:, 0])
            mvp = use1.to(i32)
            j_inter = fma32(lamv, (rb[idx] + bits.amin(1)) + 6.0, d[idx])
            skip = fma32(lamv[:, None], sch.skip_bins,
                         _lookup(grid, idx, mrg, sr))
            j_intra = fma32(lamv, lamv.new_full((), hdr), di[idx])
            js = torch.cat([skip, j_inter[:, None], j_intra[:, None]], 1)
            choice = torch.argmin(js, 1)
            if want_costs:
                out["js"][idx] = js
        else:
            choice, mvd, mvp = (t[idx] for t in forced)
            amvp = torch.where((mvp == 1)[:, None], amvp1, amvp0)
            mvq = amvp + mvd
        cands = torch.cat([mrg, mvq[:, None]], 1)
        mv_fin = torch.gather(cands, 1, torch.clamp(choice, max=2)[
            :, None, None].expand(-1, 1, 2))[:, 0]
        is_inter = choice <= 2
        mv_map[idx] = torch.where(is_inter[:, None], mv_fin, 0)
        inter_map[idx] = is_inter
        out["choice"][idx] = choice
        out["mv"][idx] = mv_fin
        out["mvd"][idx] = mvd.to(i32)
        out["mvp"][idx] = mvp.to(i32)
    return out


def decide_b_plain(sch, grids, d, rb, di, mv_me, lam, sr: int, dsf,
                   hdr: float, forced=None, want_costs=False):
    """The B decide scan over the diagonals (JAX `decide_body` :242-386).
    grids = (grid0, grid1) [n, S, S]; d, rb [n, 3] (L0, L1, bi); di, lam
    [n]; mv_me = (mv0, mv1) [n, 2] qpel; dsf = (dsf0, dsf1).  ``forced`` =
    (choice, mvd0, mvp0, mvd1, mvp1).  Returns raster dict: choice, dir,
    mv0, mv1 (final; an unused list zeroed), mvd0, mvp0, mvd1, mvp1 (and js
    [n, 6] with want_costs)."""
    n = sch.wc * sch.hc
    dev = lam.device
    i32 = torch.int32
    dir_map = torch.zeros(n, dtype=i32, device=dev)
    mv0_map = torch.zeros((n, 2), dtype=i32, device=dev)
    mv1_map = torch.zeros((n, 2), dtype=i32, device=dev)
    out = dict(choice=torch.zeros(n, dtype=torch.int64, device=dev),
               dir=torch.zeros(n, dtype=i32, device=dev))
    for k in ("mv0", "mv1", "mvd0", "mvd1"):
        out[k] = torch.zeros((n, 2), dtype=i32, device=dev)
    for k in ("mvp0", "mvp1"):
        out[k] = torch.zeros(n, dtype=i32, device=dev)
    if want_costs:
        out["js"] = torch.zeros((n, 6), dtype=torch.float32, device=dev)
    pa, pb = sch.prune_a, sch.prune_b
    dir_of = torch.tensor(DIR_OF_CHOICE_B, dtype=i32, device=dev)
    for idx, nb, ok in sch.lanes:
        dirs = dir_map[nb]
        av = ok & (dirs > 0)
        mv0s, mv1s = mv0_map[nb], mv1_map[nb]
        same = ((dirs[:, pb] == dirs[:, pa])
                & (mv0s[:, pb] == mv0s[:, pa]).all(-1)
                & (mv1s[:, pb] == mv1s[:, pa]).all(-1))
        sel = _merge_select(sch, av, same)                   # [L, 4, 2]
        got = sel.any(1)
        mrg_d = torch.where(got, (dirs[:, :, None] * sel).sum(1, dtype=i32),
                            3)
        mrg_v0 = (mv0s[:, :, None, :] * sel[..., None]).sum(1, dtype=i32)
        mrg_v1 = (mv1s[:, :, None, :] * sel[..., None]).sum(1, dtype=i32)
        a0 = amvp_b(av, dirs, mv0s, mv1s, 0, dsf[0], sch.b_order)
        a1 = amvp_b(av, dirs, mv1s, mv0s, 1, dsf[1], sch.b_order)
        if forced is None:
            lamv = lam[idx]
            me0, me1 = mv_me[0][idx], mv_me[1][idx]

            def pick_mvp(mvq, amvp):
                mvds = mvq[:, None] - torch.stack(amvp, 1)
                bits = mvd_bits(mvds)
                use_b = bits[:, 1] < bits[:, 0]
                return (torch.where(use_b[:, None], mvds[:, 1], mvds[:, 0]),
                        use_b.to(i32), bits.amin(1))
            mvd0, mvp0, bits0 = pick_mvp(me0, a0)
            mvd1, mvp1, bits1 = pick_mvp(me1, a1)
            l0 = _lookup(grids[0], idx, mrg_v0, sr)
            l1 = _lookup(grids[1], idx, mrg_v1, sr)
            skip = fma32(lamv[:, None], sch.skip_bins, torch.where(
                mrg_d == 3, 0.5 * (l0 + l1), torch.where(mrg_d == 1, l0,
                                                         l1)))
            dd, rr = d[idx], rb[idx]
            j_l0 = fma32(lamv, (rr[:, 0] + bits0) + 8.0, dd[:, 0])
            j_l1 = fma32(lamv, (rr[:, 1] + bits1) + 8.0, dd[:, 1])
            j_bi = fma32(lamv, ((rr[:, 2] + bits0) + bits1) + 10.0,
                         dd[:, 2])
            j_intra = fma32(lamv, lamv.new_full((), hdr), di[idx])
            js = torch.cat([skip, torch.stack([j_l0, j_l1, j_bi, j_intra],
                                              1)], 1)
            choice = torch.argmin(js, 1)
            if want_costs:
                out["js"][idx] = js
        else:
            choice, mvd0, mvp0, mvd1, mvp1 = (t[idx] for t in forced)
            me0 = torch.where((mvp0 == 1)[:, None], a0[1], a0[0]) + mvd0
            me1 = torch.where((mvp1 == 1)[:, None], a1[1], a1[0]) + mvd1
        m = torch.clamp(choice, max=1)
        dir_fin = torch.where(choice <= 1, torch.gather(
            mrg_d, 1, m[:, None])[:, 0], dir_of[choice])

        def fin(mrg, me, bit):
            v = torch.where((choice <= 1)[:, None], torch.gather(
                mrg, 1, m[:, None, None].expand(-1, 1, 2))[:, 0], me)
            return torch.where(((dir_fin & bit) == bit)[:, None], v, 0)
        v0, v1 = fin(mrg_v0, me0, 1), fin(mrg_v1, me1, 2)
        dir_map[idx], mv0_map[idx], mv1_map[idx] = dir_fin, v0, v1
        out["choice"][idx] = choice
        out["dir"][idx], out["mv0"][idx], out["mv1"][idx] = dir_fin, v0, v1
        for k, v in (("mvd0", mvd0), ("mvp0", mvp0), ("mvd1", mvd1),
                     ("mvp1", mvp1)):
            out[k][idx] = v.to(i32)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_P = ctypes.c_void_p


class FlatArgs(ctypes.Structure):
    """`FlatArgs` of `csrc/decide_flat.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in ("wc", "hc", "sr", "dsf0",
                                             "dsf1")]
        + [(k, _P) for k in ("grid0", "grid1", "d", "rb", "di", "lam",
                             "me0", "me1")]
        + [("intra_hdr_bits", ctypes.c_float)]
        + [(k, _P) for k in (
            "f_ch", "f_mvd0", "f_mvp0", "f_mvd1", "f_mvp1", "choice", "dir",
            "mv0", "mv1", "mvd0", "mvp0", "mvd1", "mvp1", "js")])


def _launch(sch, bidir: bool, ins: dict, forced, want_costs, sr, dsf, hdr):
    n = sch.wc * sch.hc
    dev = sch.device
    i32, f32 = torch.int32, torch.float32
    keep = []

    def p(t, dt=None):
        if t is None:
            return None
        t = t.contiguous() if dt is None else t.to(dt).contiguous()
        keep.append(t)
        return cuda_lib.ptr(t)
    a = FlatArgs(wc=sch.wc, hc=sch.hc, sr=int(sr), dsf0=int(dsf[0]),
                 dsf1=int(dsf[1]), intra_hdr_bits=float(np.float32(hdr)))
    if forced is None:
        s = 2 * int(sr) + 1
        for k, dt, shape in (("grid0", f32, (n, s, s)),
                             ("grid1", f32, (n, s, s)),
                             ("d", f32, (n, 3) if bidir else (n,)),
                             ("rb", f32, (n, 3) if bidir else (n,)),
                             ("di", f32, (n,)), ("lam", f32, (n,)),
                             ("me0", i32, (n, 2)), ("me1", i32, (n, 2))):
            t = ins.get(k)
            if t is None and (bidir or k not in ("grid1", "me1")):
                raise ValueError(f"decide_flat: missing {k}")
            if t is not None and tuple(t.shape) != shape:
                raise ValueError(f"decide_flat: {k} of shape "
                                 f"{tuple(t.shape)}, expected {shape}")
            setattr(a, k, p(t, dt))
    else:
        names = ("f_ch", "f_mvd0", "f_mvp0", "f_mvd1", "f_mvp1")
        for k, t in zip(names, forced):
            setattr(a, k, p(t, i32))
    out = dict(choice=torch.empty(n, dtype=i32, device=dev),
               mv0=torch.empty((n, 2), dtype=i32, device=dev),
               mvd0=torch.empty((n, 2), dtype=i32, device=dev),
               mvp0=torch.empty(n, dtype=i32, device=dev))
    if bidir:
        out.update(dir=torch.empty(n, dtype=i32, device=dev),
                   mv1=torch.empty((n, 2), dtype=i32, device=dev),
                   mvd1=torch.empty((n, 2), dtype=i32, device=dev),
                   mvp1=torch.empty(n, dtype=i32, device=dev))
    if want_costs and forced is None:
        out["js"] = torch.empty((n, 6 if bidir else 4), dtype=f32,
                                device=dev)
    for k, v in out.items():
        setattr(a, k, p(v))
    cuda_lib.require_cuda(*keep)
    name = "decide_flat_b" if bidir else "decide_flat"
    f = cuda_lib.lib("decide_flat").decide_flat
    f.argtypes = [ctypes.POINTER(FlatArgs), ctypes.c_int, _P]
    f.restype = ctypes.c_int
    cuda_lib.launched(name, f(ctypes.byref(a), int(bidir),
                              _P(cuda_lib.stream_handle(keep[0]))))
    out["choice"] = out["choice"].long()
    return out


def decide_p(sch, grid, d, rb, di, mv_me, lam, sr: int, hdr: float,
             forced=None, want_costs=False):
    """See decide_p_plain; CUDA inputs launch K24 once."""
    like = lam if forced is None else forced[0]
    if like.device.type == "cpu":
        return decide_p_plain(sch, grid, d, rb, di, mv_me, lam, sr, hdr,
                              forced, want_costs)
    f = None if forced is None else (forced[0], forced[1], forced[2], None,
                                     None)
    out = _launch(sch, False, dict(grid0=grid, d=d, rb=rb, di=di, lam=lam,
                                   me0=mv_me), f, want_costs, sr, (0, 0),
                  hdr)
    return dict(choice=out["choice"], mv=out["mv0"], mvd=out["mvd0"],
                mvp=out["mvp0"], **({"js": out["js"]} if "js" in out
                                    else {}))


def decide_b(sch, grids, d, rb, di, mv_me, lam, sr: int, dsf, hdr: float,
             forced=None, want_costs=False):
    """See decide_b_plain; CUDA inputs launch K25 once."""
    like = lam if forced is None else forced[0]
    if like.device.type == "cpu":
        return decide_b_plain(sch, grids, d, rb, di, mv_me, lam, sr, dsf,
                              hdr, forced, want_costs)
    ins = {} if forced is None else None
    if forced is None:
        ins = dict(grid0=grids[0], grid1=grids[1], d=d, rb=rb, di=di,
                   lam=lam, me0=mv_me[0], me1=mv_me[1])
    return _launch(sch, True, ins, forced, want_costs, sr, dsf, hdr)
