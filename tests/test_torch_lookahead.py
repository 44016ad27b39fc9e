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
