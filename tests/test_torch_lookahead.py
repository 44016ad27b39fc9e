"""The port's lookahead (`x265amod_tpu_torch/models/lookahead.py`: plain
versions of kernels K12 `lowres_aq`, K13 `lowres_me`, K14 `cutree_prop` and
K1 on lowres blocks, and the host `Lookahead`) against the JAX package's
`models/lookahead.py` on the CPU, at 128x64 and 256x128 luma:

- `lowres_half`, `lowres_intra_cost`, `lowres_inter_cost` and
  `cutree_propagate_step` are exact (bit for bit), on numpy-seeded random
  planes and on edge inputs: flat 0 and 255, a 0/255 step, a reference
  equal to the block (zero SSD), MVs of -8 and +8 that point off the frame,
  and a scatter pile-up (many sources clipped onto the border blocks, with
  propagate amounts 10^-5 to 10^7 apart) that pins XLA's scatter order;
- `aq_offsets` is within 1e-5 absolute (JAX sums rounded f32 squares and
  takes an f32 mean; the port's energies are exact), and the per-16-cell
  QP maps `qp + rint(offset)` are equal except where JAX's offset lies
  within 1e-5 of a .5 boundary; such cases are counted and printed;
- the whole `Lookahead` (depth 4, CU-tree on, scene cuts at bias 0.4) on a
  10-frame clip with a cut at frame 6: the same frames leave in the same
  order with equal scene-cut flags, prediction ratios and CU-tree offsets
  (exact), and per-CTU QP offsets within 1e-5 whose QP maps are equal under
  the same .5 rule;
- `derive_qp_maps` with offsets and `qp32_of` (including .5 means, which
  round half to even) equal the JAX host helpers.

Only the five small lookahead jits compile here, at two shapes."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265amod_tpu.models import intra_tree as jit_tree
from x265amod_tpu.models import lookahead as jla
from x265amod_tpu.ops import quant as jq
from x265amod_tpu_torch.models import intra_tree as tit_tree
from x265amod_tpu_torch.models import lookahead as tla
from x265amod_tpu_torch.ops import quant as tq
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

SIZES = [(128, 64), (256, 128)]
AQ_TOL = 1e-5


def _t(*arrays):
    return [torch.as_tensor(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _planes(kind, w, h, rng):
    """Luma [h, w] and chroma [h/2, w/2] uint8 planes of one kind."""
    y = rng.integers(0, 256, (h, w))
    cb = rng.integers(0, 256, (h // 2, w // 2))
    cr = rng.integers(0, 256, (h // 2, w // 2))
    if kind == "clip":
        y, cb, cr = clip(w, h, 1, seed=w)[0]
    elif kind == "flat0":
        y, cb, cr = y * 0, cb * 0, cr * 0
    elif kind == "flat255":
        y, cb, cr = y * 0 + 255, cb * 0 + 255, cr * 0 + 255
    elif kind == "step":
        y[:, : w // 3] = 0
        y[:, w // 3:] = 255
        y[: h // 4] = rng.integers(0, 256, (h // 4, w))
        cb[:, : w // 6] = 0
        cr[:, w // 6:] = 255
    return tuple(np.asarray(a, np.uint8) for a in (y, cb, cr))


def _near_half(off, tol=AQ_TOL):
    """Offsets within tol of a .5 boundary, where rint may round either
    way between the two implementations."""
    off = np.asarray(off, np.float64)
    return np.abs(off - np.floor(off) - 0.5) <= tol


def _assert_qp_maps_equal(t_off, j_off, label):
    qp = 32
    tmap = tq.derive_qp_maps(qp, t_off, *t_off.shape)[0]
    jmap = jq.derive_qp_maps(qp, j_off, *j_off.shape)[0]
    near = _near_half(j_off)
    print(f"{label}: {int(near.sum())} of {near.size} offsets within "
          f"{AQ_TOL} of a .5 boundary")
    np.testing.assert_array_equal(tmap[~near], jmap[~near])


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["random", "clip", "flat0", "flat255",
                                  "step"])
def test_lowres_and_aq_match_jax(w, h, kind):
    rng = np.random.default_rng(w + len(kind))
    y, cb, cr = _planes(kind, w, h, rng)
    for strength in (1.0, 0.5):
        lr, off = tla.lowres_aq(*_t(y, cb, cr), strength)
        assert lr.dtype == torch.uint8 and off.dtype == torch.float32
        np.testing.assert_array_equal(
            lr.numpy(), np.asarray(jla.lowres_half(jnp.asarray(y))))
        joff = np.asarray(jla.aq_offsets(*_j(y, cb, cr), strength))
        assert off.shape == joff.shape == (h // 16, w // 16)
        np.testing.assert_allclose(off.numpy(), joff, rtol=0, atol=AQ_TOL)
        _assert_qp_maps_equal(off.numpy(), joff, f"aq {kind} {w}x{h}")
    if kind.startswith("flat"):
        assert not off.numpy().any()          # no energy, no offset


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["random", "clip", "flat0", "flat255",
                                  "step"])
def test_lowres_intra_cost_matches_jax(w, h, kind):
    rng = np.random.default_rng(2 * w + len(kind))
    lr = np.asarray(jla.lowres_half(jnp.asarray(
        _planes(kind, w, h, rng)[0])), np.uint8)
    got = tla.lowres_intra_cost(torch.as_tensor(lr))
    want = np.asarray(jla.lowres_intra_cost(jnp.asarray(lr)))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["shifted", "random", "flat", "step",
                                  "same"])
def test_lowres_inter_cost_matches_jax(w, h, kind):
    rng = np.random.default_rng(3 * w + len(kind))
    y = _planes("clip", w, h, rng)[0]
    cur = np.asarray(jla.lowres_half(jnp.asarray(y)), np.uint8)
    ref = np.roll(cur, (3, -5), (0, 1))          # content moving in
    if kind == "random":
        cur = rng.integers(0, 256, cur.shape).astype(np.uint8)
        ref = rng.integers(0, 256, cur.shape).astype(np.uint8)
    elif kind == "flat":                         # every candidate ties
        cur = np.full_like(cur, 77)
        ref = np.full_like(cur, 77)
    elif kind == "step":                         # the largest SSDs
        cur[:, : cur.shape[1] // 2] = 0
        cur[:, cur.shape[1] // 2:] = 255
        ref = 255 - cur
    elif kind == "same":
        ref = cur.copy()
    cost, mv = tla.lowres_inter_cost(*_t(cur, ref))
    jcost, jmv = (np.asarray(a) for a in jla.lowres_inter_cost(
        *_j(cur, ref)))
    np.testing.assert_array_equal(cost.numpy(), jcost)
    np.testing.assert_array_equal(mv.numpy(), jmv)
    assert mv.dtype == torch.int32 and int(mv.abs().max()) <= 8
    if kind == "flat":
        assert (mv.numpy() == -8).all()          # the first candidate
    if kind == "same":
        assert not cost.numpy().any() and not mv.numpy().any()


@pytest.mark.parametrize("w,h", SIZES)
@pytest.mark.parametrize("kind", ["random", "left_up", "right_down",
                                  "pileup", "costs"])
def test_cutree_propagate_step_matches_jax(w, h, kind):
    rng = np.random.default_rng(4 * w + len(kind))
    hb, wb = h // 16, w // 16
    prop = (rng.random((hb, wb)) * 10.0 ** rng.integers(0, 5, (hb, wb))) \
        .astype(np.float32)
    intra = (rng.random((hb, wb)) * 2000).astype(np.float32)
    inter = (rng.random((hb, wb)) * 2400).astype(np.float32)
    mv = rng.integers(-8, 9, (hb, wb, 2)).astype(np.int32)
    if kind == "left_up":                        # off the top-left edges
        mv[:] = -8
    elif kind == "right_down":                   # off the bottom-right
        mv[:] = 8
    elif kind == "pileup":
        # sources on the two border rows/columns all land on the border
        # blocks, with amounts far apart, so the add order shows
        mv[:2, :, 1] = -8
        mv[:, :2, 0] = -8
        mv[-2:, :, 1] = 8
        prop[:2] = 10.0 ** rng.integers(-5, 8, (2, wb))
        prop[:, :2] = 10.0 ** rng.integers(-5, 8, (hb, 2))
        inter[:3] = intra[:3] * 0.01
    elif kind == "costs":
        intra[::3, ::2] = 0.0                    # no intra cost: ratio 0
        intra[1::3, ::2] = 0.5                   # below the max(., 1)
        inter[::2] = intra[::2] * 1.5            # inter worse than intra
    got = tla.cutree_propagate_step(*_t(prop, intra, inter, mv))
    want = np.asarray(jla.cutree_propagate_step(*_j(prop, intra, inter,
                                                    mv)))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.numpy().any()


def _scene(w, h, n, cut):
    """The bench clip with a different scene from frame ``cut`` on."""
    first = clip(w, h, cut, seed=1)
    rng = np.random.default_rng(7)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    second = []
    for t in range(n - cut):
        y = (128 + 100 * np.cos((xx - 2 * t) / 5.0) * np.sin((yy + t) / 3.0)
             + rng.normal(0, 12, (h, w))).clip(0, 255).astype(np.uint8)
        c = rng.integers(40, 216, (h // 2, w // 2)).astype(np.uint8)
        second.append((y, c, 255 - c))
    return first + second


def test_lookahead_matches_jax():
    w, h, n, cut = 128, 64, 10, 6
    frames = _scene(w, h, n, cut)
    kw = dict(strength=1.0, depth=4, scenecut_bias=0.4, cutree=True,
              min_keyint=2)
    tlook = tla.Lookahead(w, h, device="cpu", **kw)
    jlook = jla.Lookahead(w, h, **kw)
    tout, jout = [], []
    for f in frames:
        tout += tlook.push(*f)
        jout += jlook.push(*f)
        assert len(tout) == len(jout)
    tout += tlook.flush()
    jout += jlook.flush()
    assert [a.display for a in tout] == [a.display for a in jout] == \
        list(range(n))
    assert [a.is_scenecut for a in tout] == [a.is_scenecut for a in jout]
    assert [a.display for a in tout if a.is_scenecut] == [0, cut]
    for a, b in zip(tout, jout):
        assert a.pred_ratio == b.pred_ratio
        np.testing.assert_array_equal(a.intra_cost, b.intra_cost)
        if b.inter_cost is None:
            assert a.inter_cost is None and a.mv is None
        else:
            np.testing.assert_array_equal(a.inter_cost, b.inter_cost)
            np.testing.assert_array_equal(a.mv, b.mv)
        np.testing.assert_array_equal(a.cutree, b.cutree)
        toff, joff = tlook.ctu_qp_offsets(a), jlook.ctu_qp_offsets(b)
        np.testing.assert_allclose(toff, joff, rtol=0, atol=AQ_TOL)
        _assert_qp_maps_equal(toff, joff, f"lookahead frame {a.display}")
    # CU-tree lowered the QP somewhere, and not only by AQ
    assert min(float(a.cutree.min()) for a in tout) < -0.5


def test_qp_maps_and_qp32_match_jax():
    rng = np.random.default_rng(11)
    off = rng.uniform(-14, 14, (4, 6)).astype(np.float32)
    off[0, :4] = [0.5, -0.5, 1.5, 2.5]           # rint: half to even
    for qp in (0, 3, 32, 49, 51):
        for a, b in zip(tq.derive_qp_maps(qp, off, 4, 6),
                        jq.derive_qp_maps(qp, off, 4, 6)):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(tq.derive_qp_maps(qp, None, 4, 6),
                        jq.derive_qp_maps(qp, None, 4, 6)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="QP offsets of shape"):
        tq.derive_qp_maps(32, off, 6, 4)
    qp16 = rng.integers(20, 45, (6, 8)).astype(np.int32)
    qp16[:2, :2] = [[30, 31], [30, 31]]          # mean 30.5 -> 30
    qp16[:2, 2:4] = [[31, 32], [31, 32]]         # mean 31.5 -> 32
    got = tit_tree.qp32_of(qp16)
    np.testing.assert_array_equal(got, jit_tree.qp32_of(qp16))
    assert got[0, 0] == 30 and got[0, 1] == 32


# ---- K13's design on the card, modelled -----------------------------------

# bytes K13 never stages: a lane may read them, but only into the bits its
# funnel shifts drop
_K13_UNSET = 0xA5


def _bytes_of(words):
    """[..., 4] bytes of uint32 words (little-endian, as the card)."""
    words = np.ascontiguousarray(words, np.uint32)
    return words.view(np.uint8).reshape(words.shape + (4,))


def _word_of(b):
    """uint32 words [...] of [..., 4] bytes."""
    return np.ascontiguousarray(b, np.uint8).view(np.uint32)[..., 0]


def _vabsdiffu4(a, b):
    """__vabsdiffu4: the four bytes' absolute differences, as a word."""
    return _word_of(np.abs(_bytes_of(a).astype(np.int16)
                           - _bytes_of(b).astype(np.int16)))


def _dp4a(a, b, acc):
    """__dp4a (unsigned): acc + the four bytes' products, modulo 2^32."""
    return (acc + (_bytes_of(a).astype(np.uint32)
                   * _bytes_of(b).astype(np.uint32)).sum(-1,
                                                         dtype=np.uint32))


def _funnelshift_r(lo, hi, sh):
    """__funnelshift_r: the 32 bits at ``sh`` (mod 32) of hi:lo."""
    v = (hi.astype(np.uint64) << 32) | lo.astype(np.uint64)
    return (v >> (np.asarray(sh, np.uint64) & 31)).astype(np.uint32)


def k13_model(cur, ref, rng):
    """K13 (`csrc/lowres_me.cu`) as its CTAs compute it: NB = 256 // S
    blocks of a block row a CTA, their window staged once as bytes (16-byte
    pieces from the aligned column at or before its first where the window
    lies inside the plane's columns and w % 16 == 0, else a byte a column
    at clamped columns; rows clamped; bytes never staged hold a marker);
    thread t is lane (block t // S, dx t % S), its block's 8 rows as 16
    words, each window row's 8 bytes at its dx from three aligned words
    through two funnel shifts; each row adds into the ring slot (r - y) & 7
    of every dy = r - y it reaches (block row 0 starts the slot), each word
    pair as __vabsdiffu4 then __dp4a; dy = r - 7 complete after row r and
    kept on a strict less; then the 64-bit key (ssd << 16) | (dy S + dx),
    a segmented shuffle tree in each warp, the segments' heads storing
    their warp's part, the least of a block's two parts.  Returns (cost
    f32 [hb, wb], mv int32 [hb, wb, 2]) as the wrapper does; asserts that
    every byte a block needs was staged."""
    cur, ref = (np.asarray(a, np.uint8) for a in (cur, ref))
    h, w = cur.shape
    s_, ws = 2 * rng + 1, 8 + 2 * rng
    nbc = 256 // s_
    pitch = (8 * nbc + 2 * rng + 15 + 12 + 15) & ~15
    hb, wb = h // 8, w // 8
    per_row = -(-wb // nbc)
    threads = -(-nbc * s_ // 32) * 32
    ctas = [(br, c * nbc) for br in range(hb) for c in range(per_row)]
    win = np.full((len(ctas), ws, pitch), _K13_UNSET, np.uint8)
    staged = np.zeros(win.shape, bool)
    lane_o = np.zeros((len(ctas), threads), np.int64)
    tid = np.arange(threads)
    nbv = np.array([min(nbc, wb - b0) for _, b0 in ctas])
    blk = np.minimum(tid[None] // s_, nbv[:, None] - 1)
    dx = tid % s_
    for k, (br, b0) in enumerate(ctas):
        x0, y0 = 8 * b0 - rng, 8 * br - rng
        wv = 8 * nbv[k] + 2 * rng
        rows = np.clip(y0 + np.arange(ws), 0, h - 1)
        s = 0
        if w % 16 == 0 and x0 >= 0 and x0 + wv <= w:
            s = x0 & 15
            n16 = ((s + wv - 1) >> 4) + 1
            win[k, :, :16 * n16] = ref[rows][:, x0 - s:x0 - s + 16 * n16]
            staged[k, :, :16 * n16] = True
        else:
            cols = np.clip(x0 + np.arange(wv), 0, w - 1)
            win[k, :, :wv] = ref[rows][:, cols]
            staged[k, :, :wv] = True
        lane_o[k] = s + 8 * blk[k] + dx
    valid = tid[None] < (nbv * s_)[:, None]
    # every byte a valid lane's row needs was staged
    need = lane_o[:, :, None] + np.arange(8)
    ck = np.broadcast_to(np.arange(len(ctas))[:, None, None], need.shape)
    assert staged[ck, :, need].transpose(0, 1, 3, 2)[valid].all()
    words = win.view("<u4")                              # [cta, ws, pitch/4]
    q = lane_o >> 2
    shift = 8 * (lane_o & 3)
    # the block's rows: 8 rows x 2 words a lane
    cw = np.ascontiguousarray(cur).view("<u4")
    brow = np.array([br for br, _ in ctas])[:, None]
    b0s = np.array([b0 for _, b0 in ctas])[:, None]
    col = 2 * (b0s + blk)
    c = np.stack([np.stack([cw[8 * brow + y, col + i] for i in range(2)],
                           -1) for y in range(8)], -2)   # [cta, t, 8, 2]
    acc = np.zeros((8,) + lane_o.shape, np.uint32)
    best = np.full(lane_o.shape, 0xFFFFFFFF, np.uint32)
    bdy = np.zeros(lane_o.shape, np.int64)
    ci = np.arange(len(ctas))[:, None]
    for r in range(ws):
        w0, w1, w2 = (words[:, r][ci, q + i] for i in range(3))
        a0 = _funnelshift_r(w0, w1, shift)
        a1 = _funnelshift_r(w1, w2, shift)
        for y in range(8):
            m = (r - y) & 7
            start = np.zeros_like(best) if y == 0 else acc[m]
            acc[m] = _dp4a(*(2 * (_vabsdiffu4(a1, c[:, :, y, 1]),)),
                           _dp4a(*(2 * (_vabsdiffu4(a0, c[:, :, y, 0]),)),
                                 start))
        if r >= 7:
            v = acc[(r + 1) & 7]
            better = v < best
            best = np.where(better, v, best)
            bdy = np.where(better, r - 7, bdy)
    assert (best < 2 ** 31).all()
    key = np.where(valid, (best.astype(np.uint64) << 16)
                   | (bdy * s_ + dx).astype(np.uint64),
                   np.uint64(2 ** 64 - 1))
    seg = np.where(valid, blk, -1 - (tid % 32))
    nw = threads // 32
    key, seg = key.reshape(-1, nw, 32), seg.reshape(-1, nw, 32)
    lane = np.arange(32)
    for off in (1, 2, 4, 8, 16):
        src = np.minimum(lane + off, 31)
        k2, s2 = key[..., src], seg[..., src]
        take = (lane + off < 32) & (s2 == seg) & (k2 < key)
        key = np.where(take, k2, key)
    up = np.concatenate([seg[..., :1], seg[..., :-1]], -1)
    head = (lane == 0) | (up != seg)
    part = np.full((len(ctas), nbc, 2), 2 ** 64 - 1, np.uint64)
    key, head = key.reshape(len(ctas), -1), head.reshape(len(ctas), -1)
    for k in range(len(ctas)):
        for t in np.nonzero(head[k] & valid[k])[0]:
            part[k, blk[k, t], int(dx[t] != 0)] = key[k, t]
    kmin = part.min(-1)
    cost = np.empty((hb, wb), np.float32)
    mv = np.empty((hb, wb, 2), np.int32)
    for k, (br, b0) in enumerate(ctas):
        for b in range(nbv[k]):
            ssd, idx = int(kmin[k, b] >> 16), int(kmin[k, b] & 0xFFFF)
            cost[br, b0 + b] = np.float32(np.sqrt(np.float64(ssd) * 64.0))
            mv[br, b0 + b] = (idx % s_ - rng, idx // s_ - rng)
    return cost, mv


@pytest.mark.parametrize("rng_", [1, 8, 16])
@pytest.mark.parametrize("kind", ["flat", "step", "random", "shifted"])
def test_k13_model_equals_the_plain_search(rng_, kind):
    """`k13_model` equals `lowres_inter_cost_plain` exactly at rng 1, 8
    and 16 on flat planes (every offset ties: MV (-rng, -rng)), 0/255
    steps (the largest SSDs), random content and content moving in, on
    planes whose every block row and column lies on a border: 256x32 (the
    window staged 16 bytes a piece in the CTAs that lie inside the
    columns, at unaligned starts at rng 16), 72x24 (a width not a
    multiple of 16: a byte a column), and at rng 1 1440x16 (85 blocks a
    CTA, a 16-byte staged window starting 7 bytes in)."""
    g = np.random.default_rng(13 * rng_ + len(kind))
    sizes = [(32, 256), (24, 72)] + ([(16, 1440)] if rng_ == 1 else [])
    for h, w in sizes:
        cur = g.integers(0, 256, (h, w))
        ref = g.integers(0, 256, (h, w))
        if kind == "flat":
            cur[:], ref[:] = 77, 77
        elif kind == "step":
            cur[:, : w // 2], cur[:, w // 2:] = 0, 255
            cur[: h // 3] = 255 - cur[: h // 3]
            ref = 255 - cur
        elif kind == "shifted":
            ref = np.roll(cur, (3, -5), (0, 1))
        cur, ref = cur.astype(np.uint8), ref.astype(np.uint8)
        want = tla.lowres_inter_cost_plain(*_t(cur, ref), rng_)
        got = k13_model(cur, ref, rng_)
        np.testing.assert_array_equal(got[0], want[0].numpy())
        np.testing.assert_array_equal(got[1], want[1].numpy())
        if kind == "flat":
            assert (got[1] == -rng_).all()
