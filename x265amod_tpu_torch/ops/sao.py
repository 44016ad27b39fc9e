"""SAO, sample adaptive offset: kernels K10 `sao_analyse` (per-CTU
statistics and the RD choice of the offsets, luma and joint chroma) and K11
`sao_apply`, each beside its plain PyTorch version.

Counterparts in the JAX package: `ops/sao.py` (`_eo_cat_map` :42,
`sao_analyse` :75, `sao_apply` :168, `sao_analyse_chroma` :257).

Classification always reads the deblocked, pre-SAO reconstruction: every
CTU's parameters are chosen, and applied, against that one plane.  A sample
whose edge-offset neighbour lies outside the picture takes category 0.

The JAX analysis forms its per-CTU statistics as f32 block sums of integer
values; each sum stays below 2^24 (at most 1024 samples of |orig - rec| <=
255 at CTU 32), so it is exact in any order, and the port sums in integers
and converts once.  The RD choice is f32 arithmetic in the JAX expression's
order, as XLA's CPU backend evaluates it (`tests/test_torch_sao.py` holds
every output, gain included, against the JAX function): the offset cost
``cnt h^2 - 2 h (sign E) + lam (h + 1)`` over h = 0..7, the four category
costs added in order, the band costs summed four at a time from the left,
and first minima everywhere.  XLA contracts the last product and sum of the
offset cost into one fused multiply-add for the edge-offset categories, and
not for the bands (crafted near-ties in the tests show both); every other
operation rounds on its own.  The plain version forms the fused value in
float64 and rounds once: exact, since ``cnt h^2 - 2 h E`` is an integer below
2^24 and ``lam (h + 1)`` has at most 28 significant bits.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

SAO_OFF_MAX = 7
N_BANDS = 32

# EO class neighbour offsets: (dy0, dx0, dy1, dx1)
EO_NEIGHBORS = ((0, -1, 0, 1), (-1, 0, 1, 0), (-1, -1, 1, 1), (-1, 1, 1, -1))


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def eo_categories(rec, klass: int):
    """Edge-offset category [H, W] int32 (0..4) of one class (spec 8.7.3:
    edgeIdx 2 + sign + sign, remapped {0: 1, 1: 2, 2: 0, 3: 3, 4: 4}); 0
    where a neighbour is outside the picture."""
    h, w = rec.shape
    dy0, dx0, dy1, dx1 = EO_NEIGHBORS[klass]
    r = rec.to(torch.int32)
    p = torch.nn.functional.pad(r[None, None].float(), (1, 1, 1, 1),
                                mode="replicate")[0, 0].to(torch.int32)

    def sh(dy, dx):
        return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    edge = 2 + torch.sign(r - sh(dy0, dx0)) + torch.sign(r - sh(dy1, dx1))
    cat = torch.where(edge == 2, 0, torch.where(edge < 2, edge + 1, edge))
    ys = torch.arange(h, device=rec.device)[:, None]
    xs = torch.arange(w, device=rec.device)[None, :]
    ok = torch.ones((h, w), dtype=torch.bool, device=rec.device)
    for dy, dx in ((dy0, dx0), (dy1, dx1)):
        if dy:
            ok = ok & (ys + dy >= 0) & (ys + dy < h)
        if dx:
            ok = ok & (xs + dx >= 0) & (xs + dx < w)
    return torch.where(ok, cat, 0).to(torch.int32)


def _ctu_sums(x, ctu):
    """[H, W] (or [H, W, C]) integers -> per-CTU raster sums [n(, C)]."""
    h, w = x.shape[:2]
    t = x.reshape((h // ctu, ctu, w // ctu, ctu) + x.shape[2:])
    return t.sum((1, 3)).reshape((-1,) + x.shape[2:])


def sao_stats_plain(orig, rec, ctu: int):
    """Per-CTU statistics of one plane: (eo_e [n, 4, 4], eo_c [n, 4, 4],
    bo_e [n, 32], bo_c [n, 32]) int32, the sums of (orig - rec) and the
    sample counts per EO class and category 1..4, and per band."""
    o = orig.to(torch.int32)
    r = rec.to(torch.int32)
    diff = o - r
    eo_e, eo_c = [], []
    for klass in range(4):
        cat = eo_categories(r, klass)
        onehot = torch.stack([cat == c for c in range(1, 5)], -1) \
            .to(torch.int32)
        eo_e.append(_ctu_sums(diff[..., None] * onehot, ctu))
        eo_c.append(_ctu_sums(onehot, ctu))
    band = torch.nn.functional.one_hot((r >> 3).long(), N_BANDS) \
        .to(torch.int32)
    return (torch.stack(eo_e, 1).to(torch.int32),
            torch.stack(eo_c, 1).to(torch.int32),
            _ctu_sums(diff[..., None] * band, ctu).to(torch.int32),
            _ctu_sums(band, ctu).to(torch.int32))


def _best_offset(e, cnt, sign: int, lam, fused: bool):
    """|h| in 0..7 minimising ``cnt h^2 - 2 h (sign E) + lam (h + 1)`` in
    f32; lam broadcasts to e.  ``fused``: the last product and sum round
    once (a fused multiply-add), else each operation rounds.  Returns
    (signed offset int32, minimum cost f32)."""
    cand = torch.arange(SAO_OFF_MAX + 1, dtype=torch.float32,
                        device=e.device)
    es = e * float(sign)
    a = cnt[..., None] * (cand * cand)
    b = (2.0 * cand) * es[..., None]
    if fused:
        d = ((a - b).double() + lam[..., None].double()
             * (cand + 1.0).double()).to(torch.float32)
    else:
        d = (a - b) + lam[..., None] * (cand + 1.0)
    k = torch.argmin(d, -1)
    return (k.to(torch.int32) * sign), d.amin(-1)


def _plane_rd(stats, lam):
    """The RD choices of one plane from its statistics: per EO class the
    summed category cost [n, 4] and offsets [n, 4, 4]; the best band window
    cost [n], position [n] and offsets [n, 4]."""
    eo_e, eo_c, bo_e, bo_c = (t.to(torch.float32) for t in stats)
    n = eo_e.shape[0]
    dist = torch.zeros((n, 4), dtype=torch.float32, device=eo_e.device)
    offs = []
    for c in range(4):
        off, d = _best_offset(eo_e[:, :, c], eo_c[:, :, c],
                              1 if c <= 1 else -1, lam[:, None], True)
        offs.append(off)
        dist = dist + d
    lam2 = lam[:, None]
    off_p, d_p = _best_offset(bo_e, bo_c, 1, lam2, False)
    off_n, d_n = _best_offset(bo_e, bo_c, -1, lam2, False)
    use_neg = d_n < d_p
    off_band = torch.where(use_neg, off_n, off_p)
    d_band = torch.minimum(d_p, d_n)
    wins = ((d_band[:, 0:29] + d_band[:, 1:30]) + d_band[:, 2:31]) \
        + d_band[:, 3:32]
    pos = torch.argmin(wins, 1)
    bo_off = torch.gather(off_band, 1, pos[:, None] + torch.arange(
        4, device=pos.device)[None])
    return dist, torch.stack(offs, 2), wins.amin(1), pos.to(torch.int32), \
        bo_off


def _eo_pick(offs, cls):
    return torch.gather(offs, 1, cls.long()[:, None, None].expand(
        -1, 1, 4))[:, 0]


def sao_analyse_plain(orig, rec, lam, ctu: int = 32):
    """One plane's SAO choice per CTU (JAX `sao_analyse`): orig, rec [H, W]
    integer planes, lam [n] f32 per CTU (raster).  Returns (type [n] int32:
    0 off, 1 band, 2 edge; eo_class [n]; band_pos [n]; offsets [n, 4]
    int32; gain [n] f32, the cost of 'off' less the chosen cost)."""
    lam = lam.to(torch.float32).reshape(-1)
    dist, eo_offs, bo_min, pos, bo_off = _plane_rd(
        sao_stats_plain(orig, rec, ctu), lam)
    eo_dist = dist + lam[:, None] * 5.0
    cls = torch.argmin(eo_dist, 1)
    eo_best = torch.gather(eo_dist, 1, cls[:, None])[:, 0]
    bo_d = bo_min + lam * 8.0
    off_d = lam * 1.0
    costs = torch.stack([off_d, bo_d, eo_best], 1)
    ty = torch.argmin(costs, 1).to(torch.int32)
    gain = off_d - costs.amin(1)
    offsets = torch.where((ty == 1)[:, None], bo_off,
                          torch.where((ty == 2)[:, None],
                                      _eo_pick(eo_offs, cls), 0))
    return ty, cls.to(torch.int32), pos, offsets.to(torch.int32), gain


def sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, lam, ctu: int = 16):
    """Joint chroma SAO choice (JAX `sao_analyse_chroma`): cb and cr share
    the type and EO class, each has its own band position and offsets.
    Returns (type, eo_class, band_pos_cb, offsets_cb, band_pos_cr,
    offsets_cr)."""
    lam = lam.to(torch.float32).reshape(-1)
    cb = _plane_rd(sao_stats_plain(ocb, rcb, ctu), lam)
    cr = _plane_rd(sao_stats_plain(ocr, rcr, ctu), lam)
    return _chroma_choice(cb, cr, lam)


def _chroma_choice(cb, cr, lam):
    eo_joint = (cb[0] + cr[0]) + lam[:, None] * 10.0
    cls = torch.argmin(eo_joint, 1)
    eo_best = torch.gather(eo_joint, 1, cls[:, None])[:, 0]
    bo_joint = (cb[2] + cr[2]) + lam * 16.0
    off_d = lam * 1.0
    ty = torch.argmin(torch.stack([off_d, bo_joint, eo_best], 1), 1) \
        .to(torch.int32)

    def pick(rd):
        return torch.where((ty == 1)[:, None], rd[4], torch.where(
            (ty == 2)[:, None], _eo_pick(rd[1], cls), 0)).to(torch.int32)
    return ty, cls.to(torch.int32), cb[3], pick(cb), cr[3], pick(cr)


def sao_apply_plain(rec, ty, eo_class, band_pos, offsets, ctu: int = 32):
    """Apply per-CTU SAO parameters to one plane (JAX `sao_apply`), each
    sample classified against the input plane; returns int32 [H, W]."""
    r = rec.to(torch.int32)
    h, w = r.shape
    dev = r.device
    wc = w // ctu
    ctu_map = (torch.arange(h, device=dev)[:, None] // ctu) * wc + \
        torch.arange(w, device=dev)[None, :] // ctu
    cats = torch.stack([eo_categories(r, k) for k in range(4)], 0)
    cls_pix = eo_class.long()[ctu_map]
    cat_pix = torch.gather(cats, 0, cls_pix[None])[0]
    lut_eo = torch.cat([torch.zeros((offsets.shape[0], 1), dtype=torch.int32,
                                    device=dev),
                        offsets.to(torch.int32)], 1).reshape(-1)
    eo_off = lut_eo[ctu_map * 5 + cat_pix]
    rel = (r >> 3) - band_pos.to(torch.int32)[ctu_map]
    in_win = (rel >= 0) & (rel < 4)
    bo_off = torch.where(in_win, offsets.to(torch.int32).reshape(-1)[
        ctu_map * 4 + torch.clamp(rel, 0, 3)], 0)
    t_pix = ty.to(torch.int32)[ctu_map]
    off = torch.where(t_pix == 2, eo_off, torch.where(t_pix == 1, bo_off, 0))
    return torch.clamp(r + off, 0, 255).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib(fn, argtypes):
    lib = cuda_lib.lib(fn)
    if not getattr(lib, "_typed", False):
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = _I
        lib._typed = True
    return lib


def _analyse_k10(planes, lam, ctu):
    """Launch K10 on one plane (orig, rec) or on cb and cr together (ocb,
    rcb, ocr, rcr).  Returns its int32 rows [n, 12] (type, eo_class,
    band_pos, offsets[4], band_pos and offsets[4] of the second plane) and
    the gain [n] f32 (0 for the joint chroma choice)."""
    ps = [p.to(torch.int32).contiguous() for p in planes]
    la = lam.to(torch.float32).reshape(-1).contiguous()
    cuda_lib.require_cuda(*ps, la)
    h, w = ps[0].shape
    if any(p.shape != (h, w) for p in ps) or h % ctu or w % ctu \
            or ctu not in (8, 16, 32):
        raise ValueError("sao_analyse: bad shapes")
    n = (h // ctu) * (w // ctu)
    if la.shape != (n,):
        raise ValueError("sao_analyse: lam needs one value per CTU")
    rows = torch.empty((n, 12), dtype=torch.int32, device=la.device)
    gain = torch.empty(n, dtype=torch.float32, device=la.device)
    if n:
        two = len(ps) == 4
        rc = _lib("sao_analyse", [_VP] * 4 + [_I] * 4 + [_VP] * 4) \
            .sao_analyse(cuda_lib.ptr(ps[0]), cuda_lib.ptr(ps[1]),
                         cuda_lib.ptr(ps[2 if two else 0]),
                         cuda_lib.ptr(ps[3 if two else 1]), h, w, ctu,
                         int(two), cuda_lib.ptr(la), cuda_lib.ptr(rows),
                         cuda_lib.ptr(gain),
                         _VP(cuda_lib.stream_handle(la)))
        cuda_lib.launched("sao_analyse", rc)
    return rows, gain


def sao_analyse(orig, rec, lam, ctu: int = 32):
    """See sao_analyse_plain; a CUDA tensor launches `csrc/sao_analyse.cu`."""
    if rec.device.type == "cpu":
        return sao_analyse_plain(orig, rec, lam, ctu)
    rows, gain = _analyse_k10((orig, rec), lam, ctu)
    return rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:7], gain


def sao_analyse_chroma(ocb, rcb, ocr, rcr, lam, ctu: int = 16):
    """See sao_analyse_chroma_plain; a CUDA tensor launches
    `csrc/sao_analyse.cu` with cb and cr in one block per CTU."""
    if rcb.device.type == "cpu":
        return sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, lam, ctu)
    rows, _ = _analyse_k10((ocb, rcb, ocr, rcr), lam, ctu)
    return (rows[:, 0], rows[:, 1], rows[:, 2], rows[:, 3:7], rows[:, 7],
            rows[:, 8:12])


def sao_apply(rec, ty, eo_class, band_pos, offsets, ctu: int = 32):
    """See sao_apply_plain; a CUDA tensor launches `csrc/sao_apply.cu`."""
    if rec.device.type == "cpu":
        return sao_apply_plain(rec, ty, eo_class, band_pos, offsets, ctu)
    r = rec.to(torch.int32).contiguous()
    h, w = r.shape
    n = (h // ctu) * (w // ctu)
    params = torch.cat([ty.reshape(n, 1), eo_class.reshape(n, 1),
                        band_pos.reshape(n, 1), offsets.reshape(n, 4)],
                       1).to(torch.int32).contiguous()
    cuda_lib.require_cuda(r, params)
    if h % ctu or w % ctu or ctu not in (8, 16, 32):
        raise ValueError("sao_apply: bad shapes")
    out = torch.empty((h, w), dtype=torch.int32, device=r.device)
    if h * w:
        rc = _lib("sao_apply", [_VP, _I, _I, _I, _VP, _VP, _VP]).sao_apply(
            cuda_lib.ptr(r), h, w, ctu, cuda_lib.ptr(params),
            cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("sao_apply", rc)
    return out


def sao_filter_frame(y, cb, cr, ry, rcb, rcr, lam, ctu: int = 32):
    """The SAO step of the trees (JAX `intra_tree.py:638-650`,
    `inter_tree.py:747-760`; ``ctu`` 32) and of the flat CTB16 frame (JAX
    `intra_frame.py:278-290`; ``ctu`` 16): luma analysed and applied at the
    CTU size, cb and cr jointly at half of it, against the deblocked planes
    ry, rcb, rcr; lam is the per-CTU lambda [n].  Returns the filtered
    planes and the ten parameter arrays (luma type, class, band position,
    offsets; chroma type, class, cb band position and offsets, cr band
    position and offsets)."""
    lam = lam.reshape(-1)
    half = ctu // 2
    s_ty, s_cls, s_bp, s_off, _ = sao_analyse(y, ry, lam, ctu)
    ry = sao_apply(ry, s_ty, s_cls, s_bp, s_off, ctu)
    c = sao_analyse_chroma(cb, rcb, cr, rcr, lam, half)
    rcb = sao_apply(rcb, c[0], c[1], c[2], c[3], half)
    rcr = sao_apply(rcr, c[0], c[1], c[4], c[5], half)
    return (ry, rcb, rcr), (s_ty, s_cls, s_bp, s_off) + tuple(c)


def sao_pack(params):
    """The ten parameter arrays as the native serializer's rows (JAX
    `encoder.py:_sao_pack` :1018): luma [n, 7] (type, class, band_pos,
    offsets[4]); chroma [n, 14] (type, class, band_pos_cb, offsets_cb[4],
    band_pos_cr, offsets_cr[4], 0, 0).  Numpy in, numpy out."""
    import numpy as np
    if params is None:
        return None, None
    ty, cls, bp, off, cty, ccls, bcb, ocb, bcr, ocr = (
        np.asarray(a) for a in params)
    n = ty.size
    sl = np.zeros((n, 7), np.int32)
    sl[:, 0], sl[:, 1], sl[:, 2] = ty.reshape(-1), cls.reshape(-1), \
        bp.reshape(-1)
    sl[:, 3:7] = off.reshape(n, 4)
    sc = np.zeros((n, 14), np.int32)
    sc[:, 0], sc[:, 1], sc[:, 2] = cty.reshape(-1), ccls.reshape(-1), \
        bcb.reshape(-1)
    sc[:, 3:7] = ocb.reshape(n, 4)
    sc[:, 7] = bcr.reshape(-1)
    sc[:, 8:12] = ocr.reshape(n, 4)
    return sl, sc
