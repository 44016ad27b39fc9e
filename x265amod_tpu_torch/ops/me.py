"""Motion estimation and motion compensation for the P and B trees: kernels
K5 `me_ssd_grid`, K6 `subpel_refine`, K7 `mc_qpel` (also over stacked
reference planes with a per-block reference index, `mc_qpel_ref`, and
from the lists each block's direction names, `mc_qpel_sel`), K8
`hpel_plane`, K9 `mc_bi` (bi-prediction; its device code also runs in
K7's select entry) and K18 `pick_ref` (the best reference per CU of a
multi-reference P frame), each beside its plain PyTorch version.

Counterparts in the JAX package: `ops/me.py` (`me_ssd_grid` :33,
`subpel_refine` :385, `mc_luma_qpel` :315 / `mc_luma_qpel14` :262,
`mc_chroma_qpel` :377 / `mc_chroma_qpel14` :331, `bi_combine` :323,
`LUMA_FILTERS` and `CHROMA_FILTERS` :230-247, `_mvd_bits_f` :450) and
`models/inter_tree.py:_hpel_plane` (:51), `pick_ref` (:274) and `mc_sel`
(:598).

The JAX package fetches each block's reference window with one-hot f32
matmuls (`ops/me.py:_block_windows`), the TPU's stand-in for a gather.  Here
every reference read is a gather at coordinates clamped to the plane, which
is what the JAX edge padding gives for every MV the encoder produces.  The
JAX `me_ssd_grid` forms ``w2 - 2 corr + c2`` in f32 (exact while every term
stays below 2^24: always at bn 16 on 8-bit planes); the port sums the SSD in
int32 and converts once.

Each block of a plane is addressed by its raster index: block i of an
[H, W] plane at block size n has its origin at ((i % (W/n)) n, (i // (W/n)) n).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .rdoq import fma32

# luma 8-tap filters per quarter phase (spec Table 8-11)
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# chroma 4-tap filters per eighth phase (spec Table 8-13)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def mvd_bits(mvd):
    """MVD bin count [...] f32 of qpel vectors [..., 2] (the JAX
    `inter_frame._mvd_bits` and `me._mvd_bits_f`, one formula): a component
    of magnitude a costs 1 + 2 bitlen(a) bins, and bitlen(a) is the
    exponent `frexp` returns for a (exact: a < 2^24 is exact in f32).  The
    JAX f32 form ``3 + 2 (floor(log2((a - 2) / 2 + 1)) + 1)`` equals it for
    every |a| < 16384; XLA's f32 log2 rounds low at a = 16384 and 65536, far
    beyond the 4 (2 sr + 4) the encoder can produce."""
    e = torch.frexp(mvd.abs().to(torch.float32)).exponent
    return (e.sum(-1) * 2 + 2).to(torch.float32)


def _plane_blocks(h, w, n, dev):
    """Origins (bx, by) of the n x n raster blocks of an [h, w] plane."""
    wb = w // n
    i = torch.arange((h // n) * wb, device=dev)
    return (i % wb) * n, (i // wb) * n


def _gather_windows(plane, x0, y0, size):
    """[nb, size, size] windows of ``plane`` starting at (x0, y0) per block,
    read at clamped coordinates (= edge padding)."""
    h, w = plane.shape
    ar = torch.arange(size, device=plane.device)
    rows = torch.clamp(y0[:, None] + ar[None], 0, h - 1)
    cols = torch.clamp(x0[:, None] + ar[None], 0, w - 1)
    return plane[rows[:, :, None], cols[:, None, :]]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def me_ssd_grid_plain(cur, ref, sr: int, bn: int = 16):
    """cur [nb, bn, bn] int (the raster blocks of a frame), ref [H, W] int
    -> [nb, S, S] f32 SSD, S = 2 sr + 1: grid[i, dy, dx] is the SSD of block
    i against the reference at MV (dx - sr, dy - sr)."""
    h, w = ref.shape
    s = 2 * sr + 1
    ref = ref.to(torch.int32)
    cur = cur.to(torch.int32)
    bx, by = _plane_blocks(h, w, bn, ref.device)
    win = _gather_windows(ref, bx - sr, by - sr, bn + 2 * sr)
    out = torch.empty((cur.shape[0], s, s), dtype=torch.float32,
                      device=ref.device)
    for dy in range(s):
        rows = win[:, dy:dy + bn]                         # [nb, bn, bn+2sr]
        cand = rows.unfold(2, bn, 1)                      # [nb, bn, S, bn]
        d = cand - cur[:, :, None, :]
        out[:, dy] = (d * d).sum((1, 3)).to(torch.float32)
    return out


def mc14(plane, mv, n, chroma, blk=None):
    """14-bit intermediate uni prediction [nb, n, n] int32 of the raster
    blocks of ``plane`` at qpel luma MVs mv [nb, 2] (chroma: the same value
    in eighth-pel chroma units); ``blk`` [nb] names each prediction's block
    when it is not block i for prediction i.  Phase 0 of each filter table
    is a single 64 tap, so one formula covers every phase: horizontal taps,
    then vertical taps and >> 6 (spec 8.5.3.3.3, 8-bit: first shift 0)."""
    h, w = plane.shape
    filt, sh, margin = (CHROMA_FILTERS, 3, 1) if chroma else \
        (LUMA_FILTERS, 2, 3)
    t = filt.shape[1]
    taps = torch.as_tensor(filt, device=plane.device)
    mv = mv.to(torch.int32)
    bx, by = _plane_blocks(h, w, n, plane.device)
    if blk is not None:
        bx, by = bx[blk], by[blk]
    mask = (1 << sh) - 1
    win = _gather_windows(plane.to(torch.int32), bx + (mv[:, 0] >> sh)
                          - margin, by + (mv[:, 1] >> sh) - margin,
                          n + t - 1)
    tx = taps[(mv[:, 0] & mask).long()]                   # [nb, t]
    ty = taps[(mv[:, 1] & mask).long()]
    hor = (win.unfold(2, t, 1) * tx[:, None, None, :]).sum(-1)
    ver = (hor.unfold(1, t, 1) * ty[:, None, None, :]).sum(-1)
    return (ver >> 6).to(torch.int32)


def _uni(pred14):
    return torch.clamp((pred14 + 32) >> 6, 0, 255).to(torch.int32)


def mc_luma_qpel_plain(plane, mv, n: int = 16):
    """Quarter-pel luma uni MC (JAX `mc_luma_qpel`): [nb, n, n] int32."""
    return _uni(mc14(plane, mv, n, False))


def mc_chroma_qpel_plain(plane, mv, n: int = 8):
    """Eighth-pel chroma uni MC (JAX `mc_chroma_qpel`) at luma qpel MVs."""
    return _uni(mc14(plane, mv, n, True))


def mc_ref_plain(planes, mv, ref, n: int, chroma: bool):
    """Uni MC of prediction k from plane ``ref[k]`` of the stacked planes
    [R, H, W], at mv[k], for the raster block k mod (blocks per plane):
    [K, n, n] int32.  Every plane's prediction, then the pick: the JAX
    per-reference MC and one-hot sum (`models/inter_tree.py:mc_sel`
    :598-615)."""
    h, w = planes.shape[1:]
    blk = torch.arange(mv.shape[0], device=mv.device) % ((h // n) * (w // n))
    preds = torch.stack([_uni(mc14(planes[r], mv, n, chroma, blk))
                         for r in range(planes.shape[0])])
    return torch.gather(preds, 0, ref.long()[None, :, None, None].expand(
        1, -1, n, n))[0]


def mc_sel_plain(ref0, ref1, mv0, mv1, dir_, n: int, chroma: bool, bi):
    """The prediction of every raster block from the lists its direction
    names (JAX `mc_select`, `models/b_frame.py:407-415`): the rows of ``bi``
    [nb, n, n] (the bi-prediction) where ``dir_ & 3`` is 3, else the uni
    prediction from ref0 at mv0 where ``dir_ & 1``, else from ref1 at mv1.
    [nb, n, n] int32."""
    u0 = ((dir_ & 1) == 1)[:, None, None]
    both = ((dir_ & 3) == 3)[:, None, None]
    return torch.where(both, bi, torch.where(
        u0, _uni(mc14(ref0, mv0, n, chroma)),
        _uni(mc14(ref1, mv1, n, chroma))))


def mc_luma_qpel14(plane, mv, n: int = 16):
    """The 14-bit luma prediction before uni rounding (JAX
    `mc_luma_qpel14`)."""
    return mc14(plane, mv, n, False)


def mc_chroma_qpel14(plane, mv, n: int = 8):
    """The 14-bit chroma prediction before uni rounding (JAX
    `mc_chroma_qpel14`)."""
    return mc14(plane, mv, n, True)


def bi_combine(pred14_a, pred14_b):
    """Default bi-prediction (spec 8.5.3.3.4.3, 8-bit): Clip((a + b + 64)
    >> 7) on the two 14-bit predictions; the shift is arithmetic, so a
    negative sum rounds toward minus infinity as in JAX."""
    return torch.clamp((pred14_a + pred14_b + 64) >> 7, 0, 255) \
        .to(torch.int32)


def mc_bi_plain(ref0, ref1, mv0, mv1, n: int = 16, chroma: bool = False):
    """Bi-prediction of every n x n raster block from ref0 at mv0 and ref1
    at mv1 (JAX `bi_combine(mc_*_qpel14(ref0, mv0), mc_*_qpel14(ref1,
    mv1))`): [nb, n, n] int32."""
    return bi_combine(mc14(ref0, mv0, n, chroma), mc14(ref1, mv1, n, chroma))


# candidate order of the JAX subpel_refine: dy outer, dx inner, -2..2 each
_SUBPEL_D = torch.tensor([[dx, dy] for dy in range(-2, 3)
                          for dx in range(-2, 3)], dtype=torch.int32)


def int_mv_argmin_plain(grid, lam, sr: int):
    """The integer MV of each block from its SSD grid [nb, S, S] (S = 2 sr +
    1, dy-major) and lambda [nb] f32 (JAX `models/inter_tree.py:best_mv`
    :227): the first minimum of ``fma(lam, mvd_bits(4 d), grid)``, the FMA
    XLA's CPU code forms of JAX's ``grid + lam * mvbits`` (the product's
    one use is the add).  Returns [nb, 2] int32 (dx, dy)."""
    s = 2 * sr + 1
    off = torch.arange(s, device=grid.device, dtype=torch.int32) - sr
    mvbits = mvd_bits(torch.stack(torch.meshgrid(off * 4, off * 4,
                                                 indexing="xy"), -1))
    cost = fma32(lam.to(torch.float32)[:, None, None], mvbits[None], grid)
    flat = torch.argmin(cost.reshape(cost.shape[0], -1), 1)
    return torch.stack([flat % s - sr, flat // s - sr], 1).to(torch.int32)


def subpel_pick(ssd, lam, cand):
    """The refinement's choice among its candidates (JAX `ops/me.py:
    subpel_refine` :444): ssd [nb, K] f32, lam [nb] f32, cand [nb, K, 2]
    qpel MVs; the first minimum of ``fma(lam, mvd_bits(cand), ssd)``."""
    return torch.argmin(fma32(lam.to(torch.float32)[:, None],
                              mvd_bits(cand), ssd), 1)


def subpel_refine_plain(ref, cur, mv_int, lam, n: int = 16):
    """Exhaustive +-2 qpel refinement around integer MVs: ref [H, W], cur
    [nb, n, n], mv_int [nb, 2], lam [nb] f32 -> (mv_q [nb, 2] int32,
    ssd [nb] f32).  Cost ``fma(lam, mvd_bits(mv), ssd)`` in f32, the FMA
    XLA's CPU code forms of JAX's ``cost + lam * rate`` (the product's one
    use is the add), first minimum in the JAX candidate order."""
    nb = cur.shape[0]
    dev = ref.device
    cand = mv_int.to(torch.int32)[:, None, :] * 4 + _SUBPEL_D.to(dev)[None]
    # the 25 candidates of block i are blocks of a plane with the same
    # origins: run the MC once per candidate column
    ssd = torch.empty((nb, 25), dtype=torch.float32, device=dev)
    cur = cur.to(torch.int32)
    for k in range(25):
        pred = mc_luma_qpel_plain(ref, cand[:, k], n)
        d = pred - cur
        ssd[:, k] = (d * d).sum((1, 2)).to(torch.float32)
    best = subpel_pick(ssd, lam, cand)
    mv_q = torch.gather(cand, 1, best[:, None, None].expand(nb, 1, 2))[:, 0]
    return mv_q.contiguous(), torch.gather(ssd, 1, best[:, None])[:, 0]


def pick_ref_plain(d, rb, mv, lam, refbits):
    """Per-CU best reference of the trials (JAX `models/inter_tree.py:
    pick_ref` :274-290): d, rb [n, R] f32, mv [n, R, 2] int32, lam [n] f32,
    refbits [R] f32.  j_r = d_r + lam ((rb_r + mvd_bits(mv_r)) + refbits_r)
    with the last step one FMA, as XLA's CPU code contracts it (the
    product's one use); JAX prices `mvd_bits` of the absolute MV, and so
    does this.  First minimum over r.  Returns (ref [n] int32, d [n],
    rb [n], mv [n, 2])."""
    j = fma32(lam.to(torch.float32)[:, None],
              (rb + mvd_bits(mv)) + refbits.to(rb.device)[None], d)
    best = torch.argmin(j, 1)
    take = best[:, None]
    return (best.to(torch.int32), torch.gather(d, 1, take)[:, 0],
            torch.gather(rb, 1, take)[:, 0],
            torch.gather(mv, 1, take[..., None].expand(-1, 1, 2))[:, 0])


def hpel_plane_plain(ref):
    """(1/2, 1/2)-phase 8-tap plane of ref [H, W] on the integer grid,
    ``(v + 2048) >> 12`` without clipping (JAX `inter_tree._hpel_plane`)."""
    h, w = ref.shape
    t = torch.as_tensor(LUMA_FILTERS[2], device=ref.device)
    rows = torch.clamp(torch.arange(-3, h + 4, device=ref.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-3, w + 4, device=ref.device), 0, w - 1)
    p = ref.to(torch.int32)[rows[:, None], cols[None, :]]
    hor = (p.unfold(1, 8, 1) * t).sum(-1)                 # [h+7, w]
    ver = (hor.unfold(0, 8, 1) * t).sum(-1)               # [h, w]
    return ((ver + 2048) >> 12).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


_lib = cuda_lib.typed_lib


def _plane_arg(plane):
    p = plane.to(torch.int32).contiguous()
    if p.dim() != 2:
        raise ValueError("expected one [H, W] plane")
    return p


def me_ssd_grid(cur, ref, sr: int, bn: int = 16):
    """See me_ssd_grid_plain; a CUDA tensor launches `csrc/me_ssd.cu`.

    The kernel's SSD is the exact sum modulo 2^32 read as an int32 (equal
    to the plain version wherever the sum stays below 2^31: always for
    8-bit samples, at most 1024 * 255^2), converted to f32 once.  Its
    correlation runs on the tensor cores as 8-bit products for blocks in
    [0, 255] against windows in [-2048, 2047] (an 8-bit plane: one
    product; K8's half-pel plane of one, in [-263, 518]: two, through the
    byte split); a block whose samples or window lie beyond takes the
    kernel's exact int32 loop."""
    if ref.device.type == "cpu":
        return me_ssd_grid_plain(cur, ref, sr, bn)
    return _me_ssd(cur, ref, sr, bn, None)[0]


def me_ssd_grid_mv(cur, ref, sr: int, bn: int, lam):
    """The SSD grid of `me_ssd_grid` and the integer MV of each block,
    `int_mv_argmin_plain(grid, lam, sr)`: (grid [nb, S, S] f32, mv [nb, 2]
    int32 (dx, dy)).  A CUDA tensor launches `csrc/me_ssd.cu`'s
    `me_ssd_grid_argmin`, the argmin folded into K5's epilogue (one launch,
    counted as `me_ssd_argmin`); a CPU tensor takes both plain versions."""
    if ref.device.type == "cpu":
        grid = me_ssd_grid_plain(cur, ref, sr, bn)
        return grid, int_mv_argmin_plain(grid, lam, sr)
    return _me_ssd(cur, ref, sr, bn, lam)


def _me_ssd(cur, ref, sr, bn, lam):
    """K5 on CUDA tensors: the grid, and with ``lam`` the folded argmin's
    MVs (else None)."""
    r = _plane_arg(ref)
    c = cur.to(torch.int32).contiguous()
    cuda_lib.require_cuda(r, c)
    h, w = r.shape
    nb = (h // bn) * (w // bn)
    if c.shape != (nb, bn, bn) or bn not in (16, 32) or not 1 <= sr <= 32:
        raise ValueError("me_ssd_grid: bad shapes")
    s = 2 * sr + 1
    out = torch.empty((nb, s, s), dtype=torch.float32, device=r.device)
    stream = _VP(cuda_lib.stream_handle(r))
    if lam is None:
        if nb:
            rc = _lib("me_ssd", "me_ssd_grid",
                      [_VP] * 2 + [_I] * 4 + [_VP] * 2).me_ssd_grid(
                cuda_lib.ptr(c), cuda_lib.ptr(r), h, w, bn, sr,
                cuda_lib.ptr(out), stream)
            cuda_lib.launched("me_ssd", rc)
        return out, None
    la = lam.to(torch.float32).reshape(-1).contiguous()
    cuda_lib.require_cuda(r, la)
    if la.shape != (nb,):
        raise ValueError("me_ssd_grid_mv: lam must hold one value a block")
    mv = torch.empty((nb, 2), dtype=torch.int32, device=r.device)
    if nb:
        rc = _lib("me_ssd", "me_ssd_grid_argmin",
                  [_VP] * 2 + [_I] * 4 + [_VP] * 4).me_ssd_grid_argmin(
            cuda_lib.ptr(c), cuda_lib.ptr(r), h, w, bn, sr, cuda_lib.ptr(la),
            cuda_lib.ptr(out), cuda_lib.ptr(mv), stream)
        cuda_lib.launched("me_ssd_argmin", rc)
    return out, mv


def subpel_refine(ref, cur, mv_int, lam, n: int = 16):
    """See subpel_refine_plain; a CUDA tensor launches `csrc/subpel.cu`."""
    if ref.device.type == "cpu":
        return subpel_refine_plain(ref, cur, mv_int, lam, n)
    r = _plane_arg(ref)
    c = cur.to(torch.int32).contiguous()
    m = mv_int.to(torch.int32).contiguous()
    la = lam.to(torch.float32).contiguous()
    cuda_lib.require_cuda(r, c, m, la)
    h, w = r.shape
    nb = (h // n) * (w // n)
    if c.shape != (nb, n, n) or m.shape != (nb, 2) or la.shape != (nb,) \
            or n not in (16, 32):
        raise ValueError("subpel_refine: bad shapes")
    mv_q = torch.empty((nb, 2), dtype=torch.int32, device=r.device)
    ssd = torch.empty(nb, dtype=torch.float32, device=r.device)
    if nb:
        rc = _lib("subpel", "subpel_refine", [_VP, _I, _I] + [_VP] * 3
                  + [_I] + [_VP] * 3).subpel_refine(
            cuda_lib.ptr(r), h, w, cuda_lib.ptr(c), cuda_lib.ptr(m),
            cuda_lib.ptr(la), n, cuda_lib.ptr(mv_q), cuda_lib.ptr(ssd),
            _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("subpel", rc)
    return mv_q, ssd


def _mc(plane, mv, n, chroma):
    if plane.device.type == "cpu":
        return (mc_chroma_qpel_plain if chroma else mc_luma_qpel_plain)(
            plane, mv, n)
    p = _plane_arg(plane)
    m = mv.to(torch.int32).contiguous()
    cuda_lib.require_cuda(p, m)
    h, w = p.shape
    nb = (h // n) * (w // n)
    if m.shape != (nb, 2) or n not in (8, 16, 32):
        raise ValueError("mc_qpel: bad shapes")
    out = torch.empty((nb, n, n), dtype=torch.int32, device=p.device)
    if nb:
        rc = _lib("mc_qpel", "mc_qpel", [_VP, _I, _I, _VP, _I, _I, _I, _VP,
                                         _VP]).mc_qpel(
            cuda_lib.ptr(p), h, w, cuda_lib.ptr(m), nb, n, int(chroma),
            cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(p)))
        cuda_lib.launched("mc_qpel", rc)
    return out


def mc_luma_qpel(plane, mv, n: int = 16):
    """See mc_luma_qpel_plain; a CUDA tensor launches `csrc/mc_qpel.cu`."""
    return _mc(plane, mv, n, False)


def mc_qpel_ref(planes, mv, ref, n: int, chroma: bool):
    """See mc_ref_plain: the uni MC of K predictions, each from the plane
    ``ref[k]`` of the stacked planes [R, H, W] for the raster block k mod
    (blocks per plane).  A CUDA tensor launches `csrc/mc_qpel.cu` with its
    per-block reference index (one launch for the K predictions)."""
    if planes.device.type == "cpu":
        return mc_ref_plain(planes, mv, ref, n, chroma)
    p = planes.to(torch.int32).contiguous()
    m = mv.to(torch.int32).contiguous()
    r = ref.to(torch.int32).contiguous()
    cuda_lib.require_cuda(p, m, r)
    if p.dim() != 3 or n not in (8, 16, 32):
        raise ValueError("mc_qpel_ref: planes must be [R, H, W], n 8/16/32")
    nr, h, w = p.shape
    k = m.shape[0]
    if m.shape != (k, 2) or r.shape != (k,):
        raise ValueError("mc_qpel_ref: bad shapes")
    out = torch.empty((k, n, n), dtype=torch.int32, device=p.device)
    if k:
        rc = _lib("mc_qpel", "mc_qpel_ref", [_VP, _I, _I, _I, _VP, _VP, _I,
                                             _I, _I, _VP, _VP]).mc_qpel_ref(
            cuda_lib.ptr(p), nr, h, w, cuda_lib.ptr(m), cuda_lib.ptr(r), k, n,
            int(chroma), cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(p)))
        cuda_lib.launched("mc_qpel", rc)
    return out


def mc_qpel_sel(ref0, ref1, mv0, mv1, dir_, n: int, chroma: bool, bi=None,
                max_mv=None, excess=None):
    """See mc_sel_plain; a CUDA tensor launches `csrc/mc_qpel.cu`'s select
    entry (one launch: each block predicted once, from the list its
    direction names).  Where both lists are used it copies the rows of
    ``bi`` or, without ``bi``, bi-predicts the block itself with K9's device
    code (`mc_qpel_sel_bi`); then every block's two MVs must lie within
    the window contract +-``max_mv``, measured and checked as `mc_bi` does
    (``excess`` as there)."""
    fold = bi is None
    if ref0.device.type == "cpu":
        if fold:
            bi = mc_bi(ref0, ref1, mv0, mv1, n, chroma, max_mv, excess)
        return mc_sel_plain(ref0, ref1, mv0, mv1, dir_, n, chroma, bi)
    r0, r1 = _plane_arg(ref0), _plane_arg(ref1)
    m0 = mv0.to(torch.int32).contiguous()
    m1 = mv1.to(torch.int32).contiguous()
    d = dir_.to(torch.int32).contiguous()
    h, w = r0.shape
    nb = (h // n) * (w // n)
    b = None if fold else bi.to(torch.int32).contiguous()
    if b is not None and b.data_ptr() % 16:   # its rows are read as vectors
        b = b.clone()
    cuda_lib.require_cuda(r0, r1, m0, m1, d, *([] if fold else [b]))
    if r1.shape != r0.shape or m0.shape != (nb, 2) or m1.shape != (nb, 2) \
            or d.shape != (nb,) or n not in (8, 16, 32) or \
            (not fold and b.shape != (nb, n, n)):
        raise ValueError("mc_qpel_sel: bad shapes")
    out = torch.empty((nb, n, n), dtype=torch.int32, device=r0.device)
    ex = torch.zeros((), dtype=torch.int32, device=r0.device) if fold \
        else None
    stream = _VP(cuda_lib.stream_handle(r0))
    if nb and fold:
        rc = _lib("mc_qpel", "mc_qpel_sel_bi", [_VP] * 2 + [_I] * 2
                  + [_VP] * 3 + [_I] * 4 + [_VP] * 3).mc_qpel_sel_bi(
            cuda_lib.ptr(r0), cuda_lib.ptr(r1), h, w, cuda_lib.ptr(m0),
            cuda_lib.ptr(m1), cuda_lib.ptr(d), nb, n, int(chroma),
            int(max_mv), cuda_lib.ptr(out), cuda_lib.ptr(ex), stream)
        cuda_lib.launched("mc_qpel", rc)
    elif nb:
        rc = _lib("mc_qpel", "mc_qpel_sel", [_VP] * 2 + [_I] * 2 + [_VP] * 4
                  + [_I] * 3 + [_VP] * 2).mc_qpel_sel(
            cuda_lib.ptr(r0), cuda_lib.ptr(r1), h, w, cuda_lib.ptr(m0),
            cuda_lib.ptr(m1), cuda_lib.ptr(d), cuda_lib.ptr(b), nb, n,
            int(chroma), cuda_lib.ptr(out), stream)
        cuda_lib.launched("mc_qpel", rc)
    if not fold:
        return out
    if excess is None:
        check_window(ex)
    else:
        excess.append(ex)
    return out


def pick_ref(d, rb, mv, lam, refbits):
    """See pick_ref_plain; a CUDA tensor launches `csrc/pick_ref.cu`."""
    if d.device.type == "cpu":
        return pick_ref_plain(d, rb, mv, lam, refbits)
    d_ = d.to(torch.float32).contiguous()
    rb_ = rb.to(torch.float32).contiguous()
    mv_ = mv.to(torch.int32).contiguous()
    la = lam.to(torch.float32).contiguous()
    bits = refbits.to(device=d.device, dtype=torch.float32).contiguous()
    cuda_lib.require_cuda(d_, rb_, mv_, la, bits)
    n, nr = d_.shape
    if rb_.shape != (n, nr) or mv_.shape != (n, nr, 2) or \
            la.shape != (n,) or bits.shape != (nr,) or not 1 <= nr <= 4:
        raise ValueError("pick_ref: bad shapes")
    best = torch.empty(n, dtype=torch.int32, device=d.device)
    d_out = torch.empty(n, dtype=torch.float32, device=d.device)
    rb_out = torch.empty(n, dtype=torch.float32, device=d.device)
    mv_out = torch.empty((n, 2), dtype=torch.int32, device=d.device)
    if n:
        rc = _lib("pick_ref", "pick_ref", [_VP] * 5 + [_I, _I] + [_VP] * 5) \
            .pick_ref(cuda_lib.ptr(d_), cuda_lib.ptr(rb_), cuda_lib.ptr(mv_),
                      cuda_lib.ptr(la), cuda_lib.ptr(bits), n, nr,
                      cuda_lib.ptr(best), cuda_lib.ptr(d_out),
                      cuda_lib.ptr(rb_out), cuda_lib.ptr(mv_out),
                      _VP(cuda_lib.stream_handle(d_)))
        cuda_lib.launched("pick_ref", rc)
    return best, d_out, rb_out, mv_out


def mc_chroma_qpel(plane, mv, n: int = 8):
    """See mc_chroma_qpel_plain; a CUDA tensor launches `csrc/mc_qpel.cu`."""
    return _mc(plane, mv, n, True)


def window_excess(mv, max_mv: int, chroma: bool):
    """How far the largest integer MV part lies beyond +-max_mv (0 inside),
    as a scalar tensor: the JAX window fetch reads zeros beyond it, so a
    clamped read would differ (K9 measures the same on the card)."""
    mvi = (mv.to(torch.int32) >> (3 if chroma else 2)).abs()
    top = mvi.amax() if mvi.numel() else mvi.new_zeros(())
    return torch.clamp(top - max_mv, min=0)


def check_window(excess) -> None:
    """Raise if a window excess (or the maximum of several) is not 0."""
    if int(excess) > 0:
        raise ValueError(f"MV outside the window contract (by {int(excess)}"
                         " integer samples)")


def mc_bi(ref0, ref1, mv0, mv1, n: int, chroma: bool, max_mv: int,
          excess=None):
    """See mc_bi_plain; a CUDA tensor launches `csrc/mc_bi.cu`.  Every MV's
    integer part must lie within +-max_mv.  The kernel (on the CPU,
    `window_excess`) measures how far the MVs lie beyond it; the wrapper
    raises at once, or, given a list ``excess``, appends that scalar for
    the caller to read with its own device-to-host copy and pass to
    `check_window`, so that the card's queue is not drained here."""
    if ref0.device.type == "cpu":
        out = mc_bi_plain(ref0, ref1, mv0, mv1, n, chroma)
        ex = torch.maximum(window_excess(mv0, max_mv, chroma),
                           window_excess(mv1, max_mv, chroma))
    else:
        r0, r1 = _plane_arg(ref0), _plane_arg(ref1)
        m0 = mv0.to(torch.int32).contiguous()
        m1 = mv1.to(torch.int32).contiguous()
        cuda_lib.require_cuda(r0, r1, m0, m1)
        h, w = r0.shape
        nb = (h // n) * (w // n)
        if r1.shape != r0.shape or m0.shape != (nb, 2) or \
                m1.shape != (nb, 2) or n not in (8, 16, 32):
            raise ValueError("mc_bi: bad shapes")
        out = torch.empty((nb, n, n), dtype=torch.int32, device=r0.device)
        ex = torch.zeros((), dtype=torch.int32, device=r0.device)
        if nb:
            rc = _lib("mc_bi", "mc_bi", [_VP, _VP, _I, _I, _VP, _VP, _I, _I,
                                         _I, _I, _VP, _VP, _VP]).mc_bi(
                cuda_lib.ptr(r0), cuda_lib.ptr(r1), h, w, cuda_lib.ptr(m0),
                cuda_lib.ptr(m1), nb, n, int(chroma), int(max_mv),
                cuda_lib.ptr(out), cuda_lib.ptr(ex),
                _VP(cuda_lib.stream_handle(r0)))
            cuda_lib.launched("mc_bi", rc)
    if excess is None:
        check_window(ex)
    else:
        excess.append(ex)
    return out


def mc_select(refs0, refs1, dir_, mv0, mv1, sr: int, excess):
    """The final prediction of a B frame's blocks, per plane (y, cb, cr of
    the two references' planes): the bi-prediction where ``dir_`` uses
    both lists, else the used list's uni prediction, list 1's where it
    uses none (JAX `mc_select`, `models/inter_tree.py:1610-1624` and
    `models/b_frame.py:407-418`); every block's two MVs within the window
    contract +-(sr + 2) luma and sr / 2 + 2 chroma, its check appended to
    ``excess``.  One K7 launch a plane (`mc_qpel_sel` without bi rows)
    predicts each block once, from the lists it uses."""
    out = []
    for r0, r1, n, chroma in ((refs0[0], refs1[0], 16, False),
                              (refs0[1], refs1[1], 8, True),
                              (refs0[2], refs1[2], 8, True)):
        mm = sr // 2 + 2 if chroma else sr + 2
        out.append(mc_qpel_sel(r0, r1, mv0, mv1, dir_, n, chroma, None, mm,
                               excess))
    return tuple(out)


def hpel_plane(ref):
    """See hpel_plane_plain; a CUDA tensor launches `csrc/hpel.cu`."""
    if ref.device.type == "cpu":
        return hpel_plane_plain(ref)
    r = _plane_arg(ref)
    cuda_lib.require_cuda(r)
    h, w = r.shape
    out = torch.empty((h, w), dtype=torch.int32, device=r.device)
    if h * w:
        rc = _lib("hpel", "hpel_plane", [_VP, _I, _I, _VP, _VP]).hpel_plane(
            cuda_lib.ptr(r), h, w, cuda_lib.ptr(out),
            _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("hpel", rc)
    return out
