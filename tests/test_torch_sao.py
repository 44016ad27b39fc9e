"""The port's SAO (`x265amod_tpu_torch/ops/sao.py`, plain versions of
kernels K10 and K11) against the JAX package's `ops/sao.py` on the CPU, at
96x64 luma (CTU 32) and 48x32 chroma (CTU 16): random planes and edge
inputs (flat 0 and 255 regions, rec == orig, lam 0 and large, structure on
the picture borders), and crafted near-ties of the f32 offset costs that
show where XLA fuses a multiply-add (edge offsets) and where it does not
(bands).  Parameters must be exact; the luma gain is held to 1e-6
relative (it is bit-equal on every input here)."""

import numpy as np
import pytest
import torch

from x265amod_tpu.ops import sao as jsao
from x265amod_tpu_torch.ops import sao as tsao
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

F32 = np.float32


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _planes(kind, h, w, rng):
    orig = rng.integers(0, 256, (h, w)).astype(np.int32)
    rec = np.clip(orig + rng.integers(-9, 10, (h, w)), 0, 255) \
        .astype(np.int32)
    if kind == "flat":
        rec[:, : w // 2] = 0
        orig[:, : w // 2] = rng.integers(0, 6, (h, w // 2))
        rec[:, w // 2:] = 255
        orig[:, w // 2:] = 255 - rng.integers(0, 6, (h, w - w // 2))
    elif kind == "same":
        rec = orig.copy()
    elif kind == "borders":
        # stripes and steps that reach every picture edge
        rec[0, :] = 255
        rec[-1, :] = 0
        rec[:, 0] = np.arange(h) * 3 % 256
        rec[:, -1] = 255 - np.arange(h) * 5 % 256
        rec[::2, 1::2] = np.clip(rec[::2, 1::2] + 40, 0, 255)
    elif kind == "small_error":
        rec = np.clip(orig + rng.integers(-2, 3, (h, w)), 0, 255) \
            .astype(np.int32)
    return orig, rec


def _lam(kind, n, rng):
    return {"random": rng.uniform(0, 400, n), "zero": np.zeros(n),
            "large": np.full(n, 5e5)}[kind].astype(F32)


def _check_luma(orig, rec, lam):
    want = [np.asarray(a) for a in jsao.sao_analyse(orig, rec, lam, 32)]
    got = [a.numpy() for a in tsao.sao_analyse_plain(*_t(orig, rec, lam),
                                                     32)]
    for name, g, w in zip(("type", "eo_class", "band_pos", "offsets"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=0)
    return want


def _check_chroma(ocb, rcb, ocr, rcr, lam):
    want = [np.asarray(a) for a in jsao.sao_analyse_chroma(
        ocb, rcb, ocr, rcr, lam, 16)]
    got = [a.numpy() for a in tsao.sao_analyse_chroma_plain(
        *_t(ocb, rcb, ocr, rcr, lam), 16)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, f"output {i}")
    return want


@pytest.mark.parametrize("kind", ["random", "flat", "same", "borders",
                                  "small_error"])
@pytest.mark.parametrize("lam_kind", ["random", "zero", "large"])
def test_sao_analyse_and_apply_match_jax(kind, lam_kind):
    rng = np.random.default_rng(len(kind) * 7 + len(lam_kind))
    orig, rec = _planes(kind, 64, 96, rng)
    lam = _lam(lam_kind, 6, rng)
    want = _check_luma(orig, rec, lam)
    np.testing.assert_array_equal(
        tsao.sao_apply_plain(*_t(rec, *want[:4]), 32).numpy(),
        np.asarray(jsao.sao_apply(rec, *want[:4], 32)))
    ocb, rcb = _planes(kind, 32, 48, rng)
    ocr, rcr = _planes("random", 32, 48, rng)
    cw = _check_chroma(ocb, rcb, ocr, rcr, lam)
    for r, bp, off in ((rcb, cw[2], cw[3]), (rcr, cw[4], cw[5])):
        np.testing.assert_array_equal(
            tsao.sao_apply_plain(*_t(r, cw[0], cw[1], bp, off), 16).numpy(),
            np.asarray(jsao.sao_apply(r, cw[0], cw[1], bp, off, 16)))


def test_sao_random_sweep_matches_jax():
    """Many random planes and lambdas: every CTU type occurs, every
    parameter and the gain match."""
    rng = np.random.default_rng(123)
    types = set()
    for t in range(12):
        orig = rng.integers(0, 256, (64, 96)).astype(np.int32)
        k = (1, 2, 4, 12)[t % 4]
        rec = np.clip(orig + rng.integers(-k, k + 1, (64, 96))
                      + 3 * (t % 3 - 1), 0, 255).astype(np.int32)
        if t % 4 == 3:                      # a narrow value range: bands
            orig = 100 + orig % 24
            rec = np.clip(orig - 2 + rng.integers(-1, 2, (64, 96)), 0, 255) \
                .astype(np.int32)
        lam = rng.uniform(0, 300, 6).astype(F32)
        types |= set(_check_luma(orig, rec, lam)[0].tolist())
        _check_chroma(orig[:32, :48], rec[:32, :48], orig[32:, 48:],
                      rec[32:, 48:], lam)
    assert types == {0, 1, 2}


def _fused_differs(cnt, e, lam):
    """Whether the best offset of one category differs between the fused
    and the unfused last multiply-add (both in f32)."""
    cand = np.arange(8, dtype=F32)
    a = F32(cnt) * cand * cand - (F32(2) * cand) * F32(e)
    fused = (a.astype(np.float64) + np.float64(lam)
             * (cand + 1).astype(np.float64)).astype(F32)
    plain = (a + F32(lam) * (cand + F32(1))).astype(F32)
    return int(np.argmin(fused)), int(np.argmin(plain))


def _near_ties(rng, count, max_cnt):
    """(cnt, E, lam) whose best offset depends on the fused multiply-add:
    lam within a few ulps of a tie between offsets h and h + 1."""
    out = []
    while len(out) < count:
        cnt = int(rng.integers(max_cnt // 2, max_cnt + 1))
        h = int(rng.integers(1, 4))
        e = int(rng.integers(cnt * h // 2, cnt * (h + 1)))
        lam0 = 2 * e - cnt * (2 * h + 1)
        if lam0 <= 1:
            continue
        lam = F32(lam0) + F32(rng.integers(-4, 5)) * np.spacing(F32(lam0))
        f, p = _fused_differs(cnt, e, lam)
        if f != p:
            out.append((cnt, e, lam, f, p))
    return out


@pytest.mark.parametrize("ctu", [32, 16])
def test_edge_offsets_use_the_fused_multiply_add(ctu):
    """A column pattern L H L H... makes every interior L sample a local
    minimum (edge category 1): its count and error sum pick the offset, at
    a lam where fused and unfused f32 disagree.  JAX takes the fused one,
    and so does the port."""
    rng = np.random.default_rng(ctu)
    pos = [(y, x) for y in range(ctu) for x in range(2, ctu - 1, 2)]
    for cnt, e, lam, fused, _ in _near_ties(rng, 3, len(pos)):
        rec = np.full((ctu, ctu), 101, np.int32)
        rec[:, 0::2] = 100
        for y, x in pos[cnt:]:
            rec[y, x] = 101
        orig = rec.copy()
        q, m = divmod(e, cnt)
        for i, (y, x) in enumerate(pos[:cnt]):
            orig[y, x] = 100 + q + (1 if i < m else 0)
        lam_a = np.array([lam], F32)
        if ctu == 32:
            want = _check_luma(orig, rec, lam_a)
        else:
            want = _check_chroma(orig, rec, orig, rec, lam_a)
        assert want[0][0] == 2 and want[1][0] == 0
        assert want[3][0, 0] == fused


@pytest.mark.parametrize("ctu", [32, 16])
def test_band_offsets_do_not_fuse(ctu):
    """cnt samples in one band with error sum E, the rest of the CTU
    exact: the band's offset follows the unfused f32 order in JAX and in
    the port."""
    rng = np.random.default_rng(100 + ctu)
    for cnt, e, lam, _, plain in _near_ties(rng, 3, min(ctu * ctu, 256)):
        rec = np.full((ctu, ctu), 200, np.int32).reshape(-1)
        orig = rec.copy()
        rec[:cnt] = 84
        q, m = divmod(e, cnt)
        orig[:cnt] = 84 + q
        orig[:m] += 1
        rec, orig = rec.reshape(ctu, ctu), orig.reshape(ctu, ctu)
        lam_a = np.array([lam], F32)
        if ctu == 32:
            want = _check_luma(orig, rec, lam_a)
        else:
            want = _check_chroma(orig, rec, orig, rec, lam_a)
        assert want[0][0] == 1
        assert want[3][0, 84 // 8 - want[2][0]] == plain


def test_sao_pack_rows():
    rng = np.random.default_rng(5)
    n = 6
    params = tuple(rng.integers(-7, 30, s).astype(np.int32) for s in (
        (n,), (n,), (n,), (n, 4), (n,), (n,), (n,), (n, 4), (n,), (n, 4)))
    sl, sc = tsao.sao_pack(params)
    np.testing.assert_array_equal(sl[:, 3:7], params[3])
    np.testing.assert_array_equal(sc[:, 8:12], params[9])
    assert sl.shape == (n, 7) and sc.shape == (n, 14)
    assert (sc[:, 12:] == 0).all()
    assert tsao.sao_pack(None) == (None, None)


# ---- K10's decomposition on the card, modelled ------------------------------


def _k10_totals(orig, rec, c, g, base, cnt, half=None):
    """One plane's CTU totals as K10 (`csrc/sao_analyse.cu`) forms them:
    lane l of a warp takes P adjacent samples (P = 2 at a CTU side c of 8,
    else 4) of row l // (c / P) of its step, the group's g warps take the
    steps in turn from ``base`` (the steps of the planes before), every
    sample adds (1 << 20) + (orig - rec) into its lane's counter of each
    edge class (4 k + category - 1, or the discard counter 48 at category
    0 or a neighbour outside the picture) and of its band (16 + v >> 3);
    the counters ``cnt`` [n, g, 49, 32] go on from the planes before; each
    warp sums its lanes, less its sums after the plane before, and the
    warps' differences are added.  With ``half`` (0: cb, 1: cr, at c 8)
    the plane shares one step with the other chroma plane: lanes 16 half
    .. 16 half + 15 take 4 adjacent samples each, two lanes a row, and its
    totals are those lanes' sums.  Returns the totals [n, 48], checking
    int32 bounds and that each sample was taken once, and the steps so
    far."""
    h, w = rec.shape
    p = 4 if half is not None else 2 if c == 8 else 4
    lr = c // p
    rs = 32 // lr if half is None else 8
    o, r = np.asarray(orig, np.int64), np.asarray(rec, np.int64)
    pad = np.pad(r, 1)                       # the kernel loads 0 outside
    ys, xs = np.mgrid[0:h, 0:w]
    horz, vert = (xs > 0) & (xs + 1 < w), (ys > 0) & (ys + 1 < h)

    def nb(dy, dx):
        return pad[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]
    rows = []
    for k, (a, b, ok) in enumerate((((0, -1), (0, 1), horz),
                                    ((-1, 0), (1, 0), vert),
                                    ((-1, -1), (1, 1), horz & vert),
                                    ((-1, 1), (1, -1), horz & vert))):
        edge = 2 + np.sign(r - nb(*a)) + np.sign(r - nb(*b))
        cat = np.where(edge == 2, 0, np.where(edge < 2, edge + 1, edge))
        rows.append(np.where(ok & (cat > 0), 4 * k + cat - 1, 48))
    rows.append(16 + (r >> 3))
    pk = (1 << 20) + (o - r)
    iy, ix = ys % c, xs % c
    ctu = (ys // c) * (w // c) + xs // c
    step = iy // rs
    lane = (iy % rs) * lr + ix // p + (0 if half is None else 16 * half)
    warp = (base + step) % g
    lanes = slice(None) if half is None else slice(16 * half, 16 * half + 16)
    seen = np.zeros(((h // c) * (w // c), g, 32), np.int64)
    before = cnt[:, :, :48, lanes].sum(3)
    for rr in rows:
        np.add.at(cnt, (ctu, warp, rr, lane), pk)
    np.add.at(seen, (ctu, warp, lane), 1)
    assert (seen.sum((1, 2)) == c * c).all() and seen.max() <= p * (
        (c // rs + g - 1) // g)
    after = cnt[:, :, :48, lanes].sum(3)
    assert np.abs(cnt[:, :, :48]).max() < 2 ** 31
    assert np.abs(cnt[:, :, :48].sum(3)).max() < 2 ** 31
    tot = (after - before).sum(1)
    assert np.abs(tot).max() < 2 ** 31
    return tot, base + (c * c // (rs * lr * p) if half is None else 1)


def _k10_best(e, cnt, sign, lam, fused):
    """K10's `best_eo` / `best_band` on a lane each: h = 0..7 in order, the
    first strict minimum; cnt h^2 - 2 h (sign E) formed in integers and
    converted once (checked below 2^24 and equal to the f32 products'
    difference); the edge categories' last product and sum fused."""
    from x265amod_tpu_torch.ops.rdoq import fma32
    es = e.to(torch.float32) * sign
    cf = cnt.to(torch.float32)
    for h in range(8):
        c = float(h)
        ab_int = cnt * h * h - 2 * h * e * sign
        assert ab_int.abs().max() < 2 ** 24
        ab = ab_int.to(torch.float32)
        assert torch.equal(ab, cf * (c * c) - (2.0 * c) * es)
        d = fma32(lam, torch.full_like(ab, c + 1.0), ab) if fused \
            else ab + lam * (c + 1.0)
        if h == 0:
            best, bk = d, torch.zeros_like(e)
        else:
            take = d < best
            best, bk = torch.where(take, d, best), torch.where(take, h, bk)
    return best, bk * sign


def _k10_plane_rd(tot, lam):
    """One plane's RD choice on a warp, as K10's lanes make it: lane 4 k +
    c prices class k's category c, lane b band b at both signs; each class
    sums its lanes in order c = 0..3; lane p sums window p from its
    successors (a shuffle down past lane 31 reads the lane's own value,
    windows 29-31 are +inf); a butterfly of (value, lane) minima, ties to
    the lower lane, leaves the first minimum in every lane."""
    t = torch.as_tensor(tot)
    cnt = (t + (1 << 19)) >> 20
    e = t - (cnt << 20)
    lam = lam[:, None]
    lanes = torch.arange(32)
    eo = torch.zeros((t.shape[0], 32), dtype=torch.float32)
    sign = torch.where((lanes[:16] & 3) <= 1, 1, -1)
    eo[:, :16], eo_off = _k10_best(e[:, :16], cnt[:, :16], sign, lam, True)
    dp, op = _k10_best(e[:, 16:], cnt[:, 16:], 1, lam, False)
    dn, on = _k10_best(e[:, 16:], cnt[:, 16:], -1, lam, False)
    ob, db = torch.where(dn < dp, on, op), torch.where(dn < dp, dn, dp)
    dist = torch.zeros_like(eo)
    for c in range(4):
        dist = dist + eo[:, (lanes & 12) + c]

    def down(x, d):
        return x[:, torch.where(lanes + d < 32, lanes + d, lanes)]
    w = ((db + down(db, 1)) + down(db, 2)) + down(db, 3)
    w[:, 29:] = float("inf")
    pos = lanes.expand(t.shape[0], 32).clone()
    for m in (16, 8, 4, 2, 1):
        ow, oi = w[:, lanes ^ m], pos[:, lanes ^ m]
        take = (ow < w) | ((ow == w) & (oi < pos))
        w, pos = torch.where(take, ow, w), torch.where(take, oi, pos)
    assert (pos == pos[:, :1]).all() and torch.equal(w, w[:, :1].expand(
        -1, 32))
    bo = torch.gather(ob, 1, (pos[:, :4] + lanes[:4]) & 31)
    return dist[:, 0:16:4], eo_off, w[:, 0], pos[:, 0], bo


def _k10_rows(a, b, lam):
    """K10's `write_rows`: the class, then the type, in sequence."""
    def pick(rd, ty, cls):
        eo_off = torch.gather(rd[1], 1, 4 * cls[:, None] + torch.arange(4))
        return torch.where((ty == 1)[:, None], rd[4], torch.where(
            (ty == 2)[:, None], eo_off, 0)).to(torch.int32)
    if b is None:
        eo = [a[0][:, k] + lam * 5.0 for k in range(4)]
        bo = a[2] + lam * 8.0
    else:
        eo = [(a[0][:, k] + b[0][:, k]) + lam * 10.0 for k in range(4)]
        bo = (a[2] + b[2]) + lam * 16.0
    cls, best_eo = torch.zeros_like(a[3]), eo[0]
    for k in range(1, 4):
        take = eo[k] < best_eo
        cls, best_eo = torch.where(take, k, cls), torch.where(take, eo[k],
                                                               best_eo)
    off_d = lam * 1.0
    ty, best = torch.zeros_like(cls), off_d
    for t_, cost in ((1, bo), (2, best_eo)):
        take = cost < best
        ty, best = torch.where(take, t_, ty), torch.where(take, cost, best)
    luma = (ty.to(torch.int32), cls.to(torch.int32), a[3].to(torch.int32),
            pick(a, ty, cls))
    if b is None:
        return luma + (off_d - best,)
    return luma + (b[3].to(torch.int32), pick(b, ty, cls))


def k10_model(planes, lam, ctu, chroma=None):
    """K10 as its warps compute it: ``planes`` (orig, rec) of luma at
    ``ctu``, or (ocb, rcb, ocr, rcr) at ``ctu``, or with ``chroma`` (ocb,
    rcb, ocr, rcr) the frame entry (luma at ctu, chroma at ctu / 2); a
    group of 4 warps a CTU where the largest CTU side is 32, else 1; cb
    and cr of side 8 in one step, a half-warp each.
    Returns the luma outputs (type, class, band position, offsets, gain)
    and / or the chroma outputs (type, class, cb band position and
    offsets, cr band position and offsets), as the plain versions."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    jobs = []
    if chroma is not None:
        jobs = [(planes, ctu), (chroma[:2], ctu // 2),
                (chroma[2:], ctu // 2)]
    elif len(planes) == 2:
        jobs = [(planes, ctu)]
    else:
        jobs = [(planes[:2], ctu), (planes[2:], ctu)]
    g = 4 if ctu == 32 else 1
    h, w = jobs[0][0][1].shape
    cnt = np.zeros(((h // ctu) * (w // ctu), g, 49, 32), np.int64)
    base, rds = 0, []
    paired = len(jobs) > 1 and jobs[-1][1] == 8
    for i, ((o, r), c) in enumerate(jobs):
        half = i - len(jobs) + 2 if paired and i >= len(jobs) - 2 else None
        tot, nxt = _k10_totals(o, r, c, g, base, cnt, half)
        if half != 0:                   # cb and cr share one step
            base = nxt
        rds.append(_k10_plane_rd(tot, lam))
    if chroma is not None:
        return _k10_rows(rds[0], None, lam), _k10_rows(rds[1], rds[2], lam)
    if len(planes) == 2:
        return _k10_rows(rds[0], None, lam)
    return _k10_rows(rds[0], rds[1], lam)


def _k10_planes(kind, h, w, c, rng):
    """Planes whose CTUs (side c) are, in turn: flat (one value, so one
    band and every edge category 0), rec == orig (all errors 0: equal
    costs everywhere), every sample in one band with errors of 1-3, and
    noise; "borders" adds stripes and steps on every picture edge."""
    orig, rec = _planes("borders" if kind == "borders" else "random", h, w,
                        rng)
    for i in range((h // c) * (w // c)):
        y, x = (i // (w // c)) * c, (i % (w // c)) * c
        sl = (slice(y, y + c), slice(x, x + c))
        if i % 4 == 0:
            rec[sl] = 40 + 8 * (i % 3)
            orig[sl] = rec[sl] + rng.integers(-3, 4, (c, c))
        elif i % 4 == 1:
            orig[sl] = rec[sl]
        elif i % 4 == 2:
            rec[sl] = 88 + rng.integers(0, 8, (c, c))
            orig[sl] = rec[sl] + rng.integers(1, 4, (c, c))
    return orig.astype(np.int32), np.clip(rec, 0, 255).astype(np.int32)


@pytest.mark.parametrize("kind", ["ties", "borders"])
@pytest.mark.parametrize("ctu", [8, 16, 32])
def test_k10_model_equals_the_plain_analyses(ctu, kind):
    """`k10_model` (the lane assignment, cb and cr of side 8 in one step,
    packed counters summed over lanes and warps and kept across a CTU's
    planes, ordered category and window sums, the shuffle-tree first
    minimum with ties to the lower lane) equals `sao_analyse_plain` and
    `sao_analyse_chroma_plain` exactly at CTU 8, 16 and 32, and the frame
    entry at 16 and 32: flat CTUs, rec == orig CTUs (equal class costs and
    equal windows), all samples in one band, noise; lam 0 on every third
    CTU (every cost tied), mid-range and large; 64x96 planes, so every CTU
    at 32 and the outer ring at 8 and 16 lie on a picture border."""
    rng = np.random.default_rng(ctu + len(kind))
    h, w = 64, 96
    n = (h // ctu) * (w // ctu)
    lam = rng.uniform(0, 400, n).astype(F32)
    lam[::3] = 0.0
    lam[1::5] = 5e5
    y = _k10_planes(kind, h, w, ctu, rng)
    c = _k10_planes(kind, h, w, ctu, rng) + _k10_planes("ties", h, w, ctu,
                                                        rng)
    lt = torch.as_tensor(lam)

    def same(got, want):
        for g, p in zip(got, want):
            assert torch.equal(g.to(p.dtype), p)
    same(k10_model(y, lam, ctu), tsao.sao_analyse_plain(*_t(*y), lt, ctu))
    same(k10_model(c, lam, ctu),
         tsao.sao_analyse_chroma_plain(*_t(*c), lt, ctu))
    if ctu > 8:
        half = tuple(p[: h // 2, : w // 2] for p in c)
        got = k10_model(y, lam, ctu, half)
        same(got[0], tsao.sao_analyse_plain(*_t(*y), lt, ctu))
        same(got[1], tsao.sao_analyse_chroma_plain(*_t(*half), lt,
                                                   ctu // 2))
    # the crafted content reaches every choice: off, band and edge
    ty = k10_model(y, lam, ctu)[0]
    assert set(ty.tolist()) == {0, 1, 2}
