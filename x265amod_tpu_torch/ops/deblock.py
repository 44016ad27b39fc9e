"""Deblocking (spec 8.7.2) for the CTU32 trees and the flat CTB16 intra
frame: kernel K21 `deblock_maps` (the boundary strength maps, the decoded QP
chain and the per-edge luma and chroma QPs, in one call of two launches) and
kernel K4 `deblock` (the luma bS 1/2 filter and the chroma bS == 2 filter,
vertical edges then horizontal), each beside its plain version.

Counterparts in the JAX package's `ops/deblock.py`: `luma_params`,
`intra_tree_bs_maps`, `_bs_pair`, `bs_maps`, `inter_tree_bs_maps`,
`effective_qp_map`, `effective_qp16_tree`, `edge_qp_maps`,
`deblock_luma_bs` and `deblock_chroma_bs`, and the maps of the flat frames
(all bS 2 on the intra frame, `models/intra_frame.py` :252-277; `bs_maps`
on the P and B frames, `models/inter_frame.py` :472-501, `models/b_frame.py`
:562-588).  Every function here takes a
leading frame dimension F.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .quant import chroma_qp_t

# spec Table 8-12
BETA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 6, 7, 8, 9, 10, 11,
    12, 13, 14, 15, 16, 17, 18, 20, 22, 24, 26, 28, 30, 32, 34, 36, 38,
    40, 42, 44, 46, 48, 50, 52, 54, 56, 58, 60, 62, 64], dtype=np.int32)
TC_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1,
    1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 5, 5, 6, 6, 7, 8,
    9, 10, 11, 13, 14, 16, 18, 20, 22, 24], dtype=np.int32)


def luma_params(qp: int, beta_offset: int = 0, tc_offset: int = 0,
                bs: int = 2):
    beta_idx = int(np.clip(qp + beta_offset, 0, 51))
    tc_idx = int(np.clip(qp + 2 * (bs - 1) + tc_offset, 0, 53))
    return int(BETA_TABLE[beta_idx]), int(TC_TABLE[tc_idx])


# ---- boundary strength and QP maps: the plain versions of K21 -------------

def intra_tree_bs_maps(split32, h16: int, w16: int):
    """split32 [F, hc, wc] -> (bs_v [F, h16, w16-1], bs_h [F, h16-1, w16]):
    bS 2 on every TU edge, 0 on the internal 16-edges of an unsplit CTU."""
    dev = split32.device
    s = split32.to(torch.int32)
    jv = torch.arange(w16 - 1, device=dev)
    rows32 = torch.arange(h16, device=dev) // 2
    split_v = s[:, rows32[:, None], ((jv + 1) // 2)[None, :]]
    bs_v = torch.where((jv % 2 == 0)[None, None, :], 2 * split_v, 2)
    ji = torch.arange(h16 - 1, device=dev)
    cols32 = torch.arange(w16, device=dev) // 2
    split_h = s[:, ((ji + 1) // 2)[:, None], cols32[None, :]]
    bs_h = torch.where((ji % 2 == 0)[None, :, None], 2 * split_h, 2)
    return bs_v.to(torch.int32), bs_h.to(torch.int32)


def _bs_pair(intra_a, intra_b, cbf_a, cbf_b, dir_a, dir_b, mv0_a, mv0_b,
             mv1_a, mv1_b, ref_a, ref_b):
    """Spec 8.7.2.4 bS of the edges between cells a and b (JAX
    `ops/deblock.py:296`): 2 if either is intra; 1 if either codes luma
    residual, the prediction directions or references differ, or a used
    list's MVs differ by 4 qpel or more; else 0."""
    big0 = ((mv0_a - mv0_b).abs() >= 4).any(-1)
    big1 = ((mv1_a - mv1_b).abs() >= 4).any(-1)
    use0 = (dir_a & 1) == 1
    use1 = (dir_a & 2) == 2
    mm = (dir_a != dir_b) | (use0 & big0) | (use1 & big1) | (ref_a != ref_b)
    bs1 = cbf_a | cbf_b | mm
    return torch.where(intra_a | intra_b, 2,
                       torch.where(bs1, 1, 0)).to(torch.int32)


def bs_maps(intra, cbf, dir_, mv0, mv1, ref0):
    """Vertical and horizontal bS maps from per-cell coding state (JAX
    `ops/deblock.py:310`), with a leading frame dimension: intra/cbf/dir_/
    ref0 [F, h, w], mv0/mv1 [F, h, w, 2] -> ([F, h, w-1], [F, h-1, w])."""
    def pair(a, b):
        return _bs_pair(intra[a], intra[b], cbf[a], cbf[b], dir_[a],
                        dir_[b], mv0[a], mv0[b], mv1[a], mv1[b], ref0[a],
                        ref0[b])
    all_ = slice(None)
    return (pair((all_, all_, slice(None, -1)), (all_, all_, slice(1, None))),
            pair((all_, slice(None, -1)), (all_, slice(1, None))))


def inter_tree_bs_maps(intra16, cbf16, dir16, mv0, mv1, split32, ref0):
    """bS maps of a P/B CTU32 quadtree frame (JAX `ops/deblock.py:356`):
    `bs_maps` on the 16-cell grid with the internal 16-edges of an unsplit
    CTU zeroed (a CU32 with a TU32 has no edge there).  cbf16 carries the
    TU's luma cbf (a TU32's over its four cells)."""
    bs_v, bs_h = bs_maps(intra16, cbf16, dir16, mv0, mv1, ref0)
    split_v, split_h = (b // 2 for b in intra_tree_bs_maps(
        split32, intra16.shape[1], intra16.shape[2]))
    # intra_tree_bs_maps gives 2 * split on the CTU-internal edges and 2 on
    # the CTU boundaries, so split_* is 0 exactly where an edge is internal
    # to an unsplit CTU
    return (torch.where(split_v == 0, 0, bs_v).to(torch.int32),
            torch.where(split_h == 0, 0, bs_h).to(torch.int32))


def effective_qp_map(qp_sig, coded, slice_qp: int):
    """Decoded QpY per CTB (spec 8.6.1, QG == CTB): the signalled QP where
    the CTB codes coefficients, else the previous CTB's in decode order,
    starting from SliceQpY.  qp_sig [hc, wc], coded [F, hc, wc]."""
    f, hc, wc = coded.shape
    idx = torch.arange(hc * wc, device=coded.device).expand(f, -1)
    marked = torch.where(coded.reshape(f, -1), idx, -1)
    last = torch.cummax(marked, 1).values
    eff = torch.where(last >= 0,
                      qp_sig.reshape(-1)[torch.clamp(last, min=0)], slice_qp)
    return eff.reshape(f, hc, wc).to(torch.int32)


def effective_qp16_tree(qp32, split, coded16, slice_qp: int):
    """Decoded per-16-cell QpY inside each CTB32 (the decoder's per-CU
    assignment): CUs before the first coded CU in z-order keep the carry-in
    qPY_PREV.  qp32 [hc, wc], split [F, hc, wc], coded16 [F, h16, w16]."""
    f, hc, wc = split.shape
    qp32 = qp32.to(torch.int32)
    c = coded16.reshape(f, hc, 2, wc, 2).permute(0, 1, 3, 2, 4) \
        .reshape(f, hc, wc, 4)
    anyc = c.any(-1)
    eff32 = effective_qp_map(qp32, anyc, slice_qp)
    carry = torch.cat([torch.full((f, 1), slice_qp, dtype=torch.int32,
                                  device=split.device),
                       eff32.reshape(f, -1)[:, :-1]], 1).reshape(f, hc, wc)
    firstz = torch.where(split.bool(), torch.argmax(c.to(torch.int32), -1),
                         0)
    firstz = torch.where(anyc, firstz, 4)
    k = torch.arange(4, device=split.device)
    cell = torch.where(k[None, None, None, :] < firstz[..., None],
                       carry[..., None], qp32[None, :, :, None])
    return cell.reshape(f, hc, wc, 2, 2).permute(0, 1, 3, 2, 4) \
        .reshape(f, hc * 2, wc * 2).to(torch.int32)


def edge_qp_maps(qp_eff):
    """Per-edge luma QP, (QpQ + QpP + 1) >> 1, on the bS edge grids."""
    qp_v = (qp_eff[:, :, :-1] + qp_eff[:, :, 1:] + 1) >> 1
    qp_h = (qp_eff[:, :-1, :] + qp_eff[:, 1:, :] + 1) >> 1
    return qp_v.to(torch.int32), qp_h.to(torch.int32)


def coded_cells(levels):
    """Per-16-cell flags of a frame batch's levels (ly [F, h16, w16, 16,
    16], lcb, lcr [F, h16, w16, 8, 8]): (luma coded, any plane coded)."""
    ly, lcb, lcr = levels
    nz_y = (ly != 0).flatten(-2).any(-1)
    return nz_y, nz_y | (lcb != 0).flatten(-2).any(-1) | \
        (lcr != 0).flatten(-2).any(-1)


def deblock_maps_plain(levels, slice_qp: int, qp_sig, split=None,
                       inter=None):
    """The loop filter's maps of F frames from their levels: (bs_v, qp_v,
    qpc_v [F, h16, w16-1], bs_h, qp_h, qpc_h [F, h16-1, w16]) int32.

    - ``split`` [F, hc, wc] given, ``inter`` None: the intra CTU32 tree
      (`intra_tree_bs_maps`, `effective_qp16_tree` of qp_sig [hc, wc]);
    - ``inter`` = (kinds, dir, mv0, mv1, ref0) too: the P/B trees
      (`inter_tree_bs_maps` with the TU luma cbf, a TU32's over its four
      cells); kinds [F, h16, w16] (2 = intra), dir None for L0 only, mv1
      and ref0 None for zeros.  The motion of intra cells is never read
      (their edges are bS 2 whatever it is);
    - ``split`` None: the flat CTB16 frame, `effective_qp_map` of qp_sig
      [h16, w16]; bS 2 on every edge of the intra frame (``inter`` None),
      else `bs_maps` on every 16-edge with each cell's luma cbf (the flat
      P/B frame)."""
    nz_y, coded = coded_cells(levels)
    f, h16, w16 = coded.shape
    dev = coded.device
    if split is None and inter is not None:
        kinds, dir_, mv0, mv1, ref0 = inter
        zeros = torch.zeros_like(coded, dtype=torch.int32)
        mv0 = mv0.to(torch.int32)
        bs_v, bs_h = bs_maps(
            kinds == 2, nz_y, zeros + 1 if dir_ is None else dir_, mv0,
            torch.zeros_like(mv0) if mv1 is None else mv1,
            zeros if ref0 is None else ref0)
        eff = effective_qp_map(qp_sig, coded, slice_qp)
    elif split is None:
        bs_v = torch.full((f, h16, w16 - 1), 2, dtype=torch.int32,
                          device=dev)
        bs_h = torch.full((f, h16 - 1, w16), 2, dtype=torch.int32,
                          device=dev)
        eff = effective_qp_map(qp_sig, coded, slice_qp)
    else:
        eff = effective_qp16_tree(qp_sig, split, coded, slice_qp)
        if inter is None:
            bs_v, bs_h = intra_tree_bs_maps(split, h16, w16)
        else:
            kinds, dir_, mv0, mv1, ref0 = inter
            hc, wc = h16 // 2, w16 // 2
            cbf32 = nz_y.reshape(f, hc, 2, wc, 2).any(4).any(2)
            sp = split.bool().repeat_interleave(2, 1).repeat_interleave(2, 2)
            cbf = torch.where(sp, nz_y, cbf32.repeat_interleave(2, 1)
                              .repeat_interleave(2, 2))
            zeros = torch.zeros_like(coded, dtype=torch.int32)
            mv0 = mv0.to(torch.int32)
            bs_v, bs_h = inter_tree_bs_maps(
                kinds == 2, cbf, zeros + 1 if dir_ is None else dir_,
                mv0, torch.zeros_like(mv0) if mv1 is None else mv1, split,
                zeros if ref0 is None else ref0)
    qp_v, qp_h = edge_qp_maps(eff)
    return bs_v, qp_v, chroma_qp_t(qp_v), bs_h, qp_h, chroma_qp_t(qp_h)


class MapsArgs(ctypes.Structure):
    """`MapsArgs` of `csrc/deblock_maps.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in ("F", "h16", "w16", "mode",
                                             "slice_qp")]
                + [(k, ctypes.c_void_p) for k in (
                    "ly", "lcb", "lcr", "split", "qp_sig", "kinds", "dir",
                    "mv0", "mv1", "ref0", "bs_v", "bs_h", "qp_v", "qp_h",
                    "qpc_v", "qpc_h", "scratch")])


def _pad16(n: int) -> int:
    return (n + 15) & ~15


def deblock_maps(levels, slice_qp: int, qp_sig, split=None, inter=None):
    """See deblock_maps_plain; CUDA levels launch K21
    (`csrc/deblock_maps.cu`) once for the batch: two kernels, the cells'
    flags, then the QP chain and the edges.  Each call allocates one int32
    buffer that holds the six outputs and one byte buffer of flags (a byte
    a cell and, for the CTU32 trees, a byte a CTB32), both from PyTorch's
    caching allocator."""
    if levels[0].device.type == "cpu":
        return deblock_maps_plain(levels, slice_qp, qp_sig, split, inter)
    ly = levels[0]
    f, h16, w16 = ly.shape[:3]
    dev = ly.device
    keep = []

    def p(t, dt=torch.int32):
        if t is None:
            return None
        t = t.to(dt).contiguous()
        if t.data_ptr() % 16:          # the levels are read 16 bytes a load
            t = t.clone()
        keep.append(t)
        return cuda_lib.ptr(t)
    mode = (2 if inter is None else 3) if split is None else \
        (0 if inter is None else 1)
    grid = (h16, w16) if split is None else (h16 // 2, w16 // 2)
    bad = [t.shape for t, shp in zip(levels, ((16, 16), (8, 8), (8, 8)))
           if tuple(t.shape) != (f, h16, w16) + shp]
    if split is not None and tuple(split.shape) != (f,) + grid:
        bad.append(split.shape)
    if tuple(qp_sig.shape) != grid:
        bad.append(qp_sig.shape)
    for t, tail in zip(inter or (), ((), (), (2,), (2,), ())):
        if t is not None and tuple(t.shape) != (f, h16, w16) + tail:
            bad.append(t.shape)
    if bad or (inter is not None and (inter[0] is None or inter[2] is None)):
        raise ValueError(f"deblock_maps: bad shapes {bad}")
    a = MapsArgs(F=f, h16=h16, w16=w16, mode=mode, slice_qp=int(slice_qp))
    a.ly, a.lcb, a.lcr = (p(t, torch.int16) for t in levels)
    a.split, a.qp_sig = p(split), p(qp_sig)
    if inter is not None:
        a.kinds, a.dir, a.mv0, a.mv1, a.ref0 = (p(t) for t in inter)
    nv, nh = f * h16 * (w16 - 1), f * (h16 - 1) * w16
    buf = torch.empty(3 * (nv + nh), dtype=torch.int32, device=dev)
    outs = [buf[k * nv:(k + 1) * nv].view(f, h16, w16 - 1) for k in range(3)]
    outs += [buf[3 * nv + k * nh:3 * nv + (k + 1) * nh].view(f, h16 - 1, w16)
             for k in range(3)]
    n16 = h16 * w16
    scratch = torch.empty(f * (_pad16(n16) + (_pad16(n16 // 4) if mode < 2
                                              else 0)),
                          dtype=torch.uint8, device=dev)
    a.bs_v, a.qp_v, a.qpc_v, a.bs_h, a.qp_h, a.qpc_h = (
        cuda_lib.ptr(t) for t in outs)
    a.scratch = cuda_lib.ptr(scratch)
    cuda_lib.require_cuda(*keep, buf, scratch)
    fn = cuda_lib.lib("deblock_maps").deblock_maps
    fn.argtypes = [ctypes.POINTER(MapsArgs), ctypes.c_void_p]
    fn.restype = ctypes.c_int
    rc = fn(ctypes.byref(a), ctypes.c_void_p(cuda_lib.stream_handle(ly)))
    cuda_lib.launched("deblock_maps", rc, 2)
    return tuple(outs)


# ---- plain filters ----------------------------------------------------------

def _filter_luma(p, q, beta, tc):
    """Spec 8.7.2.5 luma edge filter over [..., 4 lines, 4 taps]; p taps
    are p3, p2, p1, p0 and q taps q0..q3; beta/tc are [..., 1]."""
    p0, p1, p2, p3 = p[..., 3], p[..., 2], p[..., 1], p[..., 0]
    q0, q1, q2, q3 = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    beta_s, tc_s = beta[..., 0], tc[..., 0]
    dp = (p2 - 2 * p1 + p0).abs()
    dq = (q2 - 2 * q1 + q0).abs()
    dp0, dp3, dq0, dq3 = dp[..., 0], dp[..., 3], dq[..., 0], dq[..., 3]
    on = ((dp0 + dq0 + dp3 + dq3) < beta_s)[..., None]

    def strong_at(i):
        return ((2 * (dp[..., i] + dq[..., i]) < (beta_s >> 2))
                & ((p3[..., i] - p0[..., i]).abs()
                   + (q0[..., i] - q3[..., i]).abs() < (beta_s >> 3))
                & ((p0[..., i] - q0[..., i]).abs() < ((5 * tc_s + 1) >> 1)))
    strong = (strong_at(0) & strong_at(3))[..., None]

    def c2(v, ref):
        return torch.minimum(torch.maximum(v, ref - 2 * tc), ref + 2 * tc)
    sp0 = c2((p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3, p0)
    sp1 = c2((p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = c2((2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = c2((p1 + 2 * p0 + 2 * q0 + 2 * q1 + q2 + 4) >> 3, q0)
    sq1 = c2((p0 + q0 + q1 + q2 + 2) >> 2, q1)
    sq2 = c2((p0 + q0 + q1 + 3 * q2 + 2 * q3 + 4) >> 3, q2)

    delta0 = (9 * (q0 - p0) - 3 * (q1 - p1) + 8) >> 4
    wk_on = delta0.abs() < tc * 10
    delta = torch.minimum(torch.maximum(delta0, -tc), tc)
    wp0 = torch.clamp(p0 + delta, 0, 255)
    wq0 = torch.clamp(q0 - delta, 0, 255)
    side = (beta_s + (beta_s >> 1)) >> 3
    dep = ((dp0 + dp3) < side)[..., None]
    deq = ((dq0 + dq3) < side)[..., None]
    half = tc >> 1
    dpv = torch.minimum(torch.maximum(
        (((p2 + p0 + 1) >> 1) - p1 + delta) >> 1, -half), half)
    dqv = torch.minimum(torch.maximum(
        (((q2 + q0 + 1) >> 1) - q1 - delta) >> 1, -half), half)
    wp1 = torch.clamp(p1 + dpv, 0, 255)
    wq1 = torch.clamp(q1 + dqv, 0, 255)

    np0 = torch.where(strong, sp0, torch.where(wk_on, wp0, p0))
    np1 = torch.where(strong, sp1, torch.where(wk_on & dep, wp1, p1))
    np2 = torch.where(strong, sp2, p2)
    nq0 = torch.where(strong, sq0, torch.where(wk_on, wq0, q0))
    nq1 = torch.where(strong, sq1, torch.where(wk_on & deq, wq1, q1))
    nq2 = torch.where(strong, sq2, q2)
    fp = torch.stack([p3, torch.where(on, np2, p2), torch.where(on, np1, p1),
                      torch.where(on, np0, p0)], -1)
    fq = torch.stack([torch.where(on, nq0, q0), torch.where(on, nq1, q1),
                      torch.where(on, nq2, q2), q3], -1)
    return fp, fq


def _luma_vertical_pass(x, bs, qp):
    """x [F, H, W]; bs/qp [F, H/16, E] for the vertical edges at x = 16,
    32, ...; filters in place and returns x."""
    f, h, w = x.shape
    xs = np.arange(16, w, 16)
    if len(xs) == 0:
        return x
    cols = torch.as_tensor(np.concatenate([np.arange(x0 - 4, x0 + 4)
                                           for x0 in xs]), device=x.device)
    seg = x[:, :, cols].reshape(f, h, len(xs), 8).permute(0, 2, 1, 3) \
        .reshape(f, len(xs), h // 4, 4, 8)
    bs_e = bs.permute(0, 2, 1).repeat_interleave(4, 2)   # [F, E, H/4]
    qp_e = qp.permute(0, 2, 1).repeat_interleave(4, 2)
    beta_t = torch.as_tensor(BETA_TABLE, device=x.device)
    tc_t = torch.as_tensor(TC_TABLE, device=x.device)
    beta = torch.where(bs_e > 0, beta_t[torch.clamp(qp_e, 0, 51).long()], 0)
    tc = torch.where(bs_e > 0, tc_t[torch.clamp(qp_e + 2 * (bs_e - 1), 0,
                                                53).long()], 0)
    fp, fq = _filter_luma(seg[..., :4], seg[..., 4:], beta[..., None],
                          tc[..., None])
    out = torch.cat([fp, fq], -1).reshape(f, len(xs), h, 8) \
        .permute(0, 2, 1, 3).reshape(f, h, -1)
    x[:, :, cols] = out.to(x.dtype)
    return x


def _chroma_vertical_pass(x, bs, qpc):
    """x [F, Hc, Wc]; bs/qpc [F, Hc/8, E] (chroma-mapped QP) for the
    vertical edges at x = 8, 16, ...; bS == 2 edges only."""
    f, h, w = x.shape
    xs = np.arange(8, w, 8)
    if len(xs) == 0:
        return x
    cols = torch.as_tensor(np.concatenate([np.arange(x0 - 2, x0 + 2)
                                           for x0 in xs]), device=x.device)
    win = x[:, :, cols].reshape(f, h, len(xs), 4)
    tc_t = torch.as_tensor(TC_TABLE, device=x.device)
    tc = torch.where(bs == 2, tc_t[torch.clamp(qpc + 2, 0, 53).long()], 0)
    tc = tc.repeat_interleave(8, 1)                      # [F, Hc, E]
    p1, p0, q0, q1 = win[..., 0], win[..., 1], win[..., 2], win[..., 3]
    delta = torch.minimum(torch.maximum(
        (((q0 - p0) << 2) + p1 - q1 + 4) >> 3, -tc), tc)
    out = torch.stack([p1, torch.clamp(p0 + delta, 0, 255),
                       torch.clamp(q0 - delta, 0, 255), q1], -1)
    x[:, :, cols] = out.reshape(f, h, -1).to(x.dtype)
    return x


def deblock_luma_plain(plane, bs_v, bs_h, qp_v, qp_h):
    x = plane.to(torch.int32).clone()
    x = _luma_vertical_pass(x, bs_v, qp_v)
    xt = _luma_vertical_pass(x.transpose(1, 2).contiguous(),
                             bs_h.transpose(1, 2), qp_h.transpose(1, 2))
    return xt.transpose(1, 2).contiguous()


def deblock_chroma_plain(plane, bs_v, bs_h, qpc_v, qpc_h):
    x = plane.to(torch.int32).clone()
    x = _chroma_vertical_pass(x, bs_v, qpc_v)
    xt = _chroma_vertical_pass(x.transpose(1, 2).contiguous(),
                               bs_h.transpose(1, 2), qpc_h.transpose(1, 2))
    return xt.transpose(1, 2).contiguous()


# ---- kernel K4 wrappers -----------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _k4():
    lib = cuda_lib.lib("deblock")
    if not getattr(lib, "_typed", False):
        for fn in (lib.deblock_luma, lib.deblock_chroma):
            fn.argtypes = [_VP] * 5 + [_I] * 3 + [_VP]
            fn.restype = _I
        lib._typed = True
    return lib


def _deblock(entry, plain, plane, bs_v, bs_h, qv, qh):
    if plane.device.type == "cpu":
        return plain(plane, bs_v, bs_h, qv, qh)
    x = plane.to(torch.int32).clone()
    args = [t.to(torch.int32).contiguous() for t in (bs_v, bs_h, qv, qh)]
    cuda_lib.require_cuda(x, *args)
    f, h, w = x.shape
    if f:
        rc = getattr(_k4(), entry)(
            cuda_lib.ptr(x), *(cuda_lib.ptr(t) for t in args), f, h, w,
            _VP(cuda_lib.stream_handle(x)))
        cuda_lib.launched("deblock", rc)
    return x


def deblock_luma(plane, bs_v, bs_h, qp_v, qp_h):
    """plane [F, H, W] -> deblocked int32 copy (bS 1/2 luma filter)."""
    return _deblock("deblock_luma", deblock_luma_plain, plane, bs_v, bs_h,
                    qp_v, qp_h)


def deblock_chroma(plane, bs_v, bs_h, qpc_v, qpc_h):
    """plane [F, H/2, W/2] -> deblocked int32 copy (bS 2 chroma filter);
    qpc_* are the chroma-mapped per-edge QPs."""
    return _deblock("deblock_chroma", deblock_chroma_plain, plane, bs_v,
                    bs_h, qpc_v, qpc_h)


def deblock_frame_planes(rec_y, rec_cb, rec_cr, levels, qp_sig,
                         slice_qp: int, split=None, inter=None):
    """The loop filter over F frames (the tail of the JAX trees'
    `_encode_frame`/`_encode` and of the flat `_encode_frame`): the maps
    (`deblock_maps`: K21 on the card), then luma and both chroma planes
    (K4).  ``levels``, ``qp_sig``, ``split`` and ``inter`` as in
    `deblock_maps_plain`."""
    bs_v, qp_v, qpc_v, bs_h, qp_h, qpc_h = deblock_maps(
        levels, slice_qp, qp_sig, split, inter)
    return (deblock_luma(rec_y, bs_v, bs_h, qp_v, qp_h),
            deblock_chroma(rec_cb, bs_v, bs_h, qpc_v, qpc_h),
            deblock_chroma(rec_cr, bs_v, bs_h, qpc_v, qpc_h))
