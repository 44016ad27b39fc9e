"""Op parity of the port's P-slice ops against the JAX package on the CPU:
motion search, sub-pel refinement, motion compensation, the half-pel
plane, MVD bin counts, the inter residual chain, tu_bits at P-slice init
states and the inter bS maps.  The same numpy inputs, made from a seed, go
through each JAX function and the port's plain PyTorch version (the version
a CPU tensor takes).  Exact unless a test states its tolerance and why.
`k6_model` holds the card's decomposition of K6 (`csrc/subpel.cu`) to the
plain refinement and `k8_model` K8's tiles (`csrc/hpel.cu`) to the plain
half-pel plane, in plain numpy and PyTorch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.models.inter_frame import _mvd_bits as j_mvd_bits
from x265amod_tpu.models.inter_tree import _hpel_plane as j_hpel
from x265amod_tpu.ops import deblock as jdb
from x265amod_tpu.ops import estbits as jeb
from x265amod_tpu.ops import me as jme
from x265amod_tpu.ops import quant as jq
from x265amod_tpu.ops.sbh import sbh_adjust as j_sbh
from x265amod_tpu.ops.transforms import fwd_transform as j_fwd
from x265amod_tpu.ops.transforms import inv_transform as j_inv
from x265amod_tpu_torch.ops import deblock as tdb
from x265amod_tpu_torch.ops import estbits as teb
from x265amod_tpu_torch.ops import me as tme
from x265amod_tpu_torch.ops.rdoq import fma32
from x265amod_tpu_torch.ops.residual import residual_chain
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

SR = 8      # config 2's search range (preset superfast)

# the JAX tu_bits under jit, as the JAX trees run it: one compile a shape
# for the file instead of one for each of its eager operations
_j_tu_bits = jax.jit(jeb.tu_bits, static_argnames=("c_idx", "slice_type",
                                                   "sbh"))
# likewise the inter bS maps, which the JAX package leaves unjitted (its
# trees call them inside their own jit)
_j_inter_bs = jax.jit(jdb.inter_tree_bs_maps)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def blocks(plane, bn):
    h, w = plane.shape
    return plane.reshape(h // bn, bn, w // bn, bn).transpose(0, 2, 1, 3)


def test_filter_tables_equal_the_jax_packages():
    np.testing.assert_array_equal(tme.LUMA_FILTERS, jme.LUMA_FILTERS)
    np.testing.assert_array_equal(tme.CHROMA_FILTERS, jme.CHROMA_FILTERS)


@pytest.mark.parametrize("bn,hi", [
    (16, 256), (32, 121),
    pytest.param(32, 256, marks=pytest.mark.xfail(strict=True, reason=(
        "JAX's f32 grid is inexact at bn 32 on full-range content (energies "
        "past 2^24) and XLA's CPU order for its grouped convolutions is "
        "Eigen's GEMM blocking, which depends on the host's vector width "
        "and caches; the port computes the exact SSD (ROADMAP queue 3 k)")))])
def test_me_ssd_grid_parity(bn, hi):
    """Row 13.  The JAX grid is w2 - 2 corr + c2 in f32: exact at bn 16 on
    any 8-bit content, and at bn 32 while block energies stay below 2^24
    (pixels 0..120).  The port's grid is the exact integer SSD.  Also the
    grid over the half-pel plane, whose samples reach about 1.45x the
    input range, on content where JAX stays exact.  On full-range content
    at bn 32 (the integer and the unclipped half-pel plane), JAX's grid is
    off by up to 4 and the port does not reproduce it: that case is the
    standing record of ROADMAP queue 3 k."""
    rng = np.random.default_rng(bn)
    h, w = 64, 96
    ref = rng.integers(0, hi, (h, w)).astype(np.int32)
    ref[:, :8] = 0                  # flat borders, including the clamp
    ref[-8:] = hi - 1
    cur = np.clip(np.roll(ref, (2, -3), (0, 1))
                  + rng.integers(-6, 7, (h, w)), 0, hi - 1).astype(np.int32)
    cb = blocks(cur, bn)
    jg = np.asarray(jme.me_ssd_grid(jnp.asarray(cb), jnp.asarray(ref), SR,
                                    bn=bn))
    tg = tme.me_ssd_grid(T(cb.reshape(-1, bn, bn)), T(ref), SR, bn).numpy()
    np.testing.assert_array_equal(tg, jg)
    lo = np.clip(ref, 0, 120) if bn == 16 else ref
    curl = np.clip(cur, 0, 120) if bn == 16 else cur
    hp = np.asarray(j_hpel(jnp.asarray(lo)))
    jg = np.asarray(jme.me_ssd_grid(jnp.asarray(blocks(curl, bn)),
                                    jnp.asarray(hp), SR, bn=bn))
    tg = tme.me_ssd_grid(T(blocks(curl, bn).reshape(-1, bn, bn)),
                         tme.hpel_plane(T(lo)), SR, bn).numpy()
    np.testing.assert_array_equal(tg, jg)


def test_hpel_plane_parity():
    """Row 16a, at 0/255 extremes and across the clamped borders."""
    rng = np.random.default_rng(2)
    ref = rng.integers(0, 256, (64, 96)).astype(np.int32)
    ref[::7] = 0
    ref[:, ::5] = 255
    np.testing.assert_array_equal(tme.hpel_plane(T(ref)).numpy(),
                                  np.asarray(j_hpel(jnp.asarray(ref))))


@pytest.mark.parametrize("n", [16, 32])
def test_subpel_refine_parity(n):
    """Row 14: MVs and SSD exact, with integer MVs at +-sr on the frame
    borders, flat blocks (all 25 candidates tie on SSD, the rate and then
    the first index decide) and lambda 0 (pure SSD ties)."""
    rng = np.random.default_rng(30 + n)
    h, w = 64, 96
    ref = np.clip(128 + 60 * np.sin(np.arange(w)[None] / 5.0)
                  * np.cos(np.arange(h)[:, None] / 4.0)
                  + rng.normal(0, 3, (h, w)), 0, 255).astype(np.int32)
    ref[:16, :16] = 77
    cur = np.clip(np.roll(ref, (1, 2), (0, 1)) + rng.integers(-3, 4, (h, w)),
                  0, 255).astype(np.int32)
    cur[:16, :16] = 77
    cb = blocks(cur, n)
    nb = cb.shape[0] * cb.shape[1]
    mv = rng.integers(-SR, SR + 1, (nb, 2)).astype(np.int32)
    mv[0] = (-SR, -SR)
    mv[-1] = (SR, SR)
    mv[1] = (0, 0)
    lam = rng.uniform(5, 400, nb).astype(np.float32)
    lam[2] = 0.0
    jmv, jssd = jme.subpel_refine(jnp.asarray(ref), jnp.asarray(cb),
                                  jnp.asarray(mv), jnp.asarray(lam)[:, None],
                                  n, max_mv=SR)
    tmv, tssd = tme.subpel_refine(T(ref), T(cb.reshape(nb, n, n)), T(mv),
                                  T(lam), n)
    np.testing.assert_array_equal(tmv.numpy(), np.asarray(jmv))
    np.testing.assert_array_equal(tssd.numpy(), np.asarray(jssd))


@pytest.mark.parametrize("n", [16, 32])
def test_mc_luma_qpel_parity(n):
    """Row 15, luma at every quarter phase, with integer parts up to the
    encoder's window bound (sr + 2, `inter_tree.py:241`) on border blocks."""
    rng = np.random.default_rng(40 + n)
    h, w = 64, 96
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    nb = (h // n) * (w // n)
    m = SR + 2
    mv = rng.integers(-4 * m, 4 * m + 4, (nb, 2)).astype(np.int32)
    mv[:16] = np.stack([np.arange(16) % 4 - 4 * m,
                        np.arange(16) // 4 + 4 * m], 1)[:nb]
    got = tme.mc_luma_qpel(T(ref), T(mv), n).numpy()
    want = np.asarray(jme.mc_luma_qpel(jnp.asarray(ref), jnp.asarray(mv), n,
                                       max_mv=m))
    np.testing.assert_array_equal(got, want)


def test_mc_chroma_qpel_parity():
    """Row 15, chroma at every eighth phase, integer parts up to the
    encoder's bound sr // 2 + 2 (`inter_tree.py:612`)."""
    rng = np.random.default_rng(50)
    h, w, n = 32, 48, 8
    ref = rng.integers(0, 256, (h, w)).astype(np.int32)
    nb = (h // n) * (w // n)
    m = SR // 2 + 2
    mv = rng.integers(-8 * m, 8 * m + 8, (nb, 2)).astype(np.int32)
    ph = np.arange(nb)
    mv[:, 0] = (mv[:, 0] & ~7) | (ph % 8)
    mv[:, 1] = (mv[:, 1] & ~7) | ((ph // 8 + 3 * ph) % 8)
    mv[0] = (-8 * m, -8 * m)
    mv[-1] = (8 * m + 7, 8 * m + 7)
    got = tme.mc_chroma_qpel(T(ref), T(mv), n).numpy()
    want = np.asarray(jme.mc_chroma_qpel(jnp.asarray(ref), jnp.asarray(mv),
                                         n, max_mv=m))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n,chroma", [(16, False), (8, True)])
def test_mc_select_entry_equals_jax_mc_select(n, chroma):
    """K7's select entry (`mc_sel_plain`, what `mc_qpel_sel` computes) is
    JAX's `mc_select` composition (`models/b_frame.py:407-415`): the uni
    prediction of list 0 where ``dir & 1``, else of list 1, and the bi rows
    where both lists are used, for dir 0, 1, 2 and 3 at n 16 luma and n 8
    chroma.  JAX's uni predictions are the calls (same shapes and bounds)
    that the two parity tests above compile, and its selection is done in
    numpy, so no JAX program is compiled here; the bi rows, the same on
    both sides, are K9's plain version (held to JAX's `bi_combine` in
    `tests/test_torch_b.py`)."""
    rng = np.random.default_rng(60 + n)
    h, w = (32, 48) if chroma else (64, 96)
    m = SR // 2 + 2 if chroma else SR + 2
    unit = 8 if chroma else 4
    planes = [rng.integers(0, 256, (h, w)).astype(np.int32)
              for _ in range(2)]
    nb = (h // n) * (w // n)
    mv0, mv1 = (rng.integers(-unit * m, unit * m + unit, (nb, 2))
                .astype(np.int32) for _ in range(2))
    mv0[0], mv1[-1] = (-unit * m, -unit * m), (unit * m, unit * m)
    dirs = (np.arange(nb) % 4).astype(np.int32)
    rng.shuffle(dirs)
    jfn = jme.mc_chroma_qpel if chroma else jme.mc_luma_qpel
    uni = [np.asarray(jfn(jnp.asarray(p), jnp.asarray(v), n, max_mv=m))
           for p, v in zip(planes, (mv0, mv1))]
    tt = [T(a) for a in (planes[0], planes[1], mv0, mv1)]
    bi = tme.mc_bi_plain(*tt, n, chroma)
    u0 = ((dirs & 1) == 1)[:, None, None]
    both = ((dirs & 3) == 3)[:, None, None]
    sel = np.where(u0, uni[0], uni[1])
    got = tme.mc_qpel_sel(*tt, T(dirs), n, chroma, bi).numpy()
    np.testing.assert_array_equal(got, np.where(both, bi.numpy(), sel))


def test_mvd_bits_over_the_reachable_domain():
    """`_mvd_bits` and `_mvd_bits_f` (f32 floor(log2)) against the port's
    integer form 1 + 2 bitlen(|v|) per component, for every component up
    to 4 (2 sr + 4) qpel at the largest range the port takes (sr 32),
    powers of two included, and for random pairs."""
    top = 4 * (2 * 32 + 4)
    a = np.arange(-top - 8, top + 9, dtype=np.int32)
    rng = np.random.default_rng(6)
    pairs = np.concatenate([
        np.stack([a, np.zeros_like(a)], 1), np.stack([np.zeros_like(a), a],
                                                     1),
        rng.integers(-top, top + 1, (4000, 2)).astype(np.int32)])
    got = tme.mvd_bits(T(pairs)).numpy()
    np.testing.assert_array_equal(got, np.asarray(j_mvd_bits(
        jnp.asarray(pairs))))
    np.testing.assert_array_equal(got, np.asarray(jme._mvd_bits_f(
        jnp.asarray(pairs))))


def test_mvd_bits_jax_f32_log2_rounds_low_far_outside_the_domain():
    """Documents the divergence: XLA's f32 log2 rounds 8192 below 13, so the
    JAX form gives 2 bins fewer at |v| = 16384; the encoder's MVDs stay
    below 300 qpel."""
    v = np.array([[16384, 0], [16383, 0]], np.int32)
    port = tme.mvd_bits(T(v)).numpy()
    assert port[0] == 1 + 2 * 15 + 1 and port[1] == 1 + 2 * 14 + 1
    jax_v = np.asarray(j_mvd_bits(jnp.asarray(v)))
    assert jax_v[0] != port[0] and jax_v[1] == port[1]


@pytest.mark.parametrize("n", [8, 16, 32])
def test_inter_residual_chain_parity(n):
    """K2 with intra=False: quant at the inter rounding offset 85 <<
    (qbits - 9) (`ops/quant.py:100`), as the P tree's trials (no SBH) and
    final residuals (SBH) call it, at QP 0, 32 and 51."""
    rng = np.random.default_rng(60 + n)
    b = 6
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-30, 31, (b, 1, n, n)), 0,
                   255).astype(np.int32)
    orig[0], pred[0] = 0, 255
    qpv = np.array([0, 32, 51, 32, 22, 37], np.int32)
    qpb = jnp.asarray(qpv)[:, None, None, None]
    coeff = j_fwd(jnp.asarray(orig[:, None] - pred))
    for sbh in (False, True):
        jlv = jq.quant(coeff, qpb, intra=False)
        if sbh:
            jlv = j_sbh(jlv)
        jrec = np.clip(pred + np.asarray(j_inv(jq.dequant(jlv, qpb))), 0, 255)
        lv, rec, ssd = residual_chain(T(orig), T(pred), T(qpv), sbh,
                                      intra=False)
        np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
        np.testing.assert_array_equal(rec.numpy(), jrec)
        np.testing.assert_array_equal(
            ssd.numpy(), ((jrec - orig[:, None]) ** 2).sum((2, 3)))
    intra_lv = residual_chain(T(orig), T(pred), T(qpv), False)[0]
    assert (intra_lv.numpy() != lv.numpy()).any()


@pytest.mark.parametrize("n", [8, 16, 32])
def test_tu_bits_p_table(n):
    """K3 at P-slice init states: exact on sparse TUs, rtol 1e-5 on dense
    ones (the tolerance and its reason are those of the I-table test in
    test_torch_ops.py)."""
    rng = np.random.default_rng(70 + n)
    qp = rng.integers(0, 52, 10).astype(np.int32)
    sparse = (rng.integers(-6, 7, (10, n, n))
              * (rng.random((10, n, n)) < 0.05)).astype(np.int32)
    sparse[0] = 0
    dense = (rng.integers(-40, 41, (10, n, n))
             * (rng.random((10, n, n)) < 0.7)).astype(np.int32)
    for c_idx in (0, 1):
        for lv, exact in ((sparse, True), (dense, False)):
            jb = np.asarray(_j_tu_bits(jnp.asarray(lv), c_idx=c_idx,
                                       slice_type="P", qp=jnp.asarray(qp)))
            tb = teb.tu_bits(T(lv), c_idx, T(qp), "P").numpy()
            if exact:
                np.testing.assert_array_equal(tb, jb)
            else:
                np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=0)
    assert teb.intra_hdr_bits("P") == jeb.intra_hdr_bits("P")


@pytest.mark.parametrize("seed", [0, 1])
def test_inter_tree_bs_maps_parity(seed):
    """Row 16c: bS 0/1/2 from intra, luma cbf, MV differences of 4 qpel and
    the split, on a 4x6 cell grid (2x3 CTUs)."""
    rng = np.random.default_rng(80 + seed)
    h16, w16 = 4, 6
    intra = rng.random((h16, w16)) < 0.2
    cbf = rng.random((h16, w16)) < 0.4
    dir_ = np.where(intra, 0, 1).astype(np.int32)
    mv0 = np.where(intra[..., None], 0,
                   rng.integers(-6, 7, (h16, w16, 2))).astype(np.int32)
    mv1 = np.zeros_like(mv0)
    ref0 = np.zeros((h16, w16), np.int32)
    split = rng.integers(0, 2, (h16 // 2, w16 // 2)).astype(np.int32)
    jv, jh = (np.asarray(a) for a in _j_inter_bs(
        jnp.asarray(intra), jnp.asarray(cbf), jnp.asarray(dir_),
        jnp.asarray(mv0), jnp.asarray(mv1), jnp.asarray(split),
        ref0=jnp.asarray(ref0)))
    tv, th = tdb.inter_tree_bs_maps(
        T(intra)[None], T(cbf)[None], T(dir_)[None], T(mv0)[None],
        T(mv1)[None], T(split)[None], T(ref0)[None])
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(th[0].numpy(), jh)
    assert set(np.unique(jv)) | set(np.unique(jh)) >= {0, 1}


def _near_ties(rng, n, bits_a, bits_b, base, integer=False):
    """f32 lanes (lam, cost_a, cost_b) of two candidates, a before b, whose
    costs ``c + lam * bits`` tie within a few ulps: candidate b's value is
    candidate a's cost less its own product, rounded and jittered by up to
    3 ulps; with ``integer`` both values are integers (SSDs) and lambda is
    drawn within 1e-3 of a multiple of 1 / (bits_a - bits_b), so that the
    two costs still tie within an ulp."""
    ca = rng.integers(*base, n).astype(np.float32)
    if integer:
        k = rng.integers(200, 80000, n)
        lam = ((k + rng.uniform(-1e-3, 1e-3, n)) / (bits_a - bits_b)) \
            .astype(np.float32)
        cb = (ca + k).astype(np.float32)
        return lam, ca, cb
    lam = rng.uniform(1, 400, n).astype(np.float32)
    ca = (ca + rng.random(n)).astype(np.float32)
    want = (ca.astype(np.float64) + lam.astype(np.float64)
            * (bits_a - bits_b)).astype(np.float32)
    jit = rng.integers(-3, 4, n)
    cb = want.copy()
    for _ in range(3):
        step = np.abs(jit) > _
        cb = np.where(step, np.nextafter(cb, np.where(
            jit > 0, np.inf, -np.inf).astype(np.float32)), cb)
    return lam, ca, cb.astype(np.float32)


def _fused_first(lam, ca, cb, bits_a, bits_b):
    """Whether the FMA forms pick candidate a (the first minimum), and
    whether the rounded forms do."""
    l64 = lam.astype(np.float64)
    fa = (ca + l64 * bits_a).astype(np.float32)
    fb = (cb + l64 * bits_b).astype(np.float32)
    ra = ca + lam * np.float32(bits_a)
    rb = cb + lam * np.float32(bits_b)
    return fa <= fb, ra <= rb


def test_int_mv_argmin_pins_xla_fma():
    """The integer ME's argmin (JAX `models/inter_tree.py:best_mv` :227;
    XLA's CPU code computes ``grid + lam * mvbits`` as one FMA, the
    argmin fusion's object code): on crafted grids where two MVs tie
    within a few ulps, the port's `int_mv_argmin_plain` equals a jitted JAX
    function of JAX's formula, and the rounded form picks otherwise on at
    least 10 lanes."""
    rng = np.random.default_rng(41)
    sr, n = 4, 20000
    s = 2 * sr + 1
    # candidate a at (dx, dy) = (-sr, -sr), candidate b at (0, 0)
    bits_a = float(j_mvd_bits(jnp.asarray([-4 * sr, -4 * sr])))
    bits_b = 2.0
    lam, ca, cb = _near_ties(rng, n, bits_a, bits_b, (1000, 1000000))
    fused, rounded = _fused_first(lam, ca, cb, bits_a, bits_b)
    keep = np.nonzero(fused != rounded)[0]
    assert keep.size >= 10
    keep = np.concatenate([keep, np.arange(64)])
    lam, ca, cb = lam[keep], ca[keep], cb[keep]
    grid = np.full((keep.size, s, s), 3e7, np.float32)
    grid[:, 0, 0] = ca
    grid[:, sr, sr] = cb

    @jax.jit
    def jax_best(grid, lam):
        off = jnp.arange(s) - sr
        mygrid, mxgrid = jnp.meshgrid(off, off, indexing="ij")
        mvbits = j_mvd_bits(jnp.stack([mxgrid * 4, mygrid * 4], -1))
        cost = grid + lam[:, None, None] * mvbits[None]
        flat = jnp.argmin(cost.reshape(cost.shape[0], -1), axis=1)
        return jnp.stack([flat % s - sr, flat // s - sr], 1)
    want = np.asarray(jax_best(grid, lam))
    got = tme.int_mv_argmin_plain(T(grid), T(lam), sr).numpy()
    np.testing.assert_array_equal(got, want)
    rounded_mv = np.where(rounded[keep][:, None], -sr, 0)
    assert (rounded_mv != want).any(1).sum() >= 10


def test_subpel_pick_pins_xla_fma():
    """The sub-pel refinement's choice (JAX `ops/me.py:subpel_refine`
    :444, ``cost + lam * rate`` one FMA in XLA's CPU code): on integer
    SSDs where candidate 0 and candidate 12 (the integer MV) tie within a
    few ulps, the port's `subpel_pick` (the choice of K6's plain version)
    equals a jitted JAX function of JAX's formula, and the rounded form
    picks otherwise on at least 10 lanes."""
    rng = np.random.default_rng(43)
    n = 12000
    mv_int = np.zeros((n, 2), np.int32)
    d = np.array([[dx, dy] for dy in range(-2, 3) for dx in range(-2, 3)],
                 np.int32)
    cand = mv_int[:, None] * 4 + d[None]
    rate = np.asarray(jme._mvd_bits_f(jnp.asarray(cand)))
    lam, ca, cb = _near_ties(rng, n, float(rate[0, 0]), float(rate[0, 12]),
                             (1000, 300000), integer=True)
    fused, rounded = _fused_first(lam, ca, cb, float(rate[0, 0]),
                                  float(rate[0, 12]))
    keep = np.nonzero(fused != rounded)[0]
    assert keep.size >= 10
    keep = np.concatenate([keep, np.arange(64)])
    lam, ca, cb = lam[keep], ca[keep], cb[keep]
    ssd = np.full((keep.size, 25), 3e7, np.float32)
    ssd[:, 0] = ca
    ssd[:, 12] = cb

    @jax.jit
    def jax_pick(cost, lam, cand):
        return jnp.argmin(cost + lam * jme._mvd_bits_f(cand), axis=1)
    want = np.asarray(jax_pick(ssd, lam[:, None], cand[keep]))
    got = tme.subpel_pick(T(ssd), T(lam), T(cand[keep])).numpy()
    np.testing.assert_array_equal(got, want)
    assert (np.where(rounded[keep], 0, 12) != want).sum() >= 10


# ---- K6's decomposition on the card, modelled ------------------------------

# dx + 2 of K6's five horizontal columns (`csrc/subpel.cu:hrow`): a copy,
# phase 1, phase 2 (offset 0), phase 3 and phase 2 at offset -1
_K6_DX = (2, 3, 4, 1, 0)


def k6_model(ref, cur, mv_int, lam, n):
    """K6 (`csrc/subpel.cu:subpel_warp`) as a warp computes it, in exact
    integers, asserting the bounds under which its f32 arithmetic is exact
    (every value below 2^24): the clamped (n+8)^2 window; lane j of row
    segment s (n 16: two segments of eight rows; n 32: one of 32) filters
    its column horizontally into the five columns a delta needs, each
    sum started at 32 (so that the vertical sums start at 2048: the taps
    sum to 64); down its rows it filters each column vertically at phases
    1, 2 and 3, takes phase 0 as the row itself and phase 2 at offset -1
    as the row above's phase 2 (kept: the row-shift sharing), rounds
    floor(v / 4096), clamps, and adds the squared differences into 25
    partials; a transposing butterfly leaves candidate k's SSD in lane k;
    lane k's cost is the FMA of lambda and the rate onto the SSD, and a
    shuffle minimum on (cost, k) picks the first minimum.  Returns
    (mv_q [nb, 2] int32, ssd [nb] f32), as `subpel_refine_plain`, and the
    25 SSDs [nb, 25] lanes 0-24 hold."""
    from x265amod_tpu_torch.ops.rdoq import fma32
    taps = tme.LUMA_FILTERS.astype(np.int64)
    ref = np.asarray(ref, np.int64)
    cur = np.asarray(cur, np.int64)
    mv = np.asarray(mv_int, np.int64)
    h, w = ref.shape
    nb, wn = cur.shape[0], n + 8
    bx = (np.arange(nb) % (w // n)) * n
    by = (np.arange(nb) // (w // n)) * n
    ys = np.clip(by[:, None] + mv[:, 1:2] - 4 + np.arange(wn), 0, h - 1)
    xs = np.clip(bx[:, None] + mv[:, 0:1] - 4 + np.arange(wn), 0, w - 1)
    win = ref[ys[:, :, None], xs[:, None, :]]               # [nb, wn, wn]
    lanes = np.arange(32)
    j = lanes % n
    rows = n // (32 // n)
    r0 = (lanes // n) * rows
    x = win[:, :, j[:, None] + np.arange(9)]             # [nb, wn, 32, 9]
    hs = np.stack([64 * x[..., 4] + 32,
                   32 + x[..., 1:9] @ taps[1],
                   32 + x[..., 1:9] @ taps[2],
                   32 + x[..., 0:8] @ taps[3],
                   32 + x[..., 0:8] @ taps[2]], -1)     # [nb, wn, 32, 5]
    assert np.abs(hs).max() < 2 ** 24

    def vert(p, top):
        """Phase p over window rows top .. top + 7 of each lane's column."""
        rr = top[:, None] + np.arange(8)                  # [32, 8]
        col = hs[:, rr, lanes[:, None], :]                # [nb, 32, 8, 5]
        v = np.einsum("nlkc,k->nlc", col, taps[p])
        assert np.abs(v).max() < 2 ** 24
        return v

    def clip(v):
        return np.clip(v, 0, 255)
    up2 = clip(vert(2, r0) >> 12)                   # the row above r0's
    acc = np.zeros((nb, 32, 25), np.int64)
    for i in range(rows):
        o = r0 + i
        same = hs[:, o + 4, lanes, :]                     # [nb, 32, 5]
        p = [up2, clip(vert(3, o) >> 12), clip(same >> 6),
             clip(vert(1, o + 1) >> 12), clip(vert(2, o + 1) >> 12)]
        up2 = p[4]
        pix = cur[:, o, j][..., None]                     # [nb, 32, 1]
        for dy in range(5):
            d = p[dy] - pix
            for c in range(5):
                acc[:, :, dy * 5 + _K6_DX[c]] += d[..., c] ** 2
    assert acc.max() < 2 ** 24
    v = np.zeros((nb, 32, 32), np.int64)
    v[..., :25] = acc
    for m in (16, 8, 4, 2, 1):
        hi = ((lanes & m) != 0)[None, :, None]
        keep = np.where(hi, v[..., m:2 * m], v[..., :m])
        send = np.where(hi, v[..., :m], v[..., m:2 * m])
        v = keep + send[:, lanes ^ m]
    ssd = v[..., 0]                                       # [nb, 32]
    k = torch.as_tensor(lanes[:25])
    vq = torch.as_tensor(4 * mv)[:, None, :] + torch.stack(
        [k % 5 - 2, k // 5 - 2], -1)[None]
    cost = torch.full((nb, 32), float("inf"))
    cost[:, :25] = fma32(torch.as_tensor(lam)[:, None], tme.mvd_bits(vq),
                         torch.as_tensor(ssd[:, :25]).to(torch.float32))
    best = torch.as_tensor(lanes).expand(nb, 32).clone()
    for m in (16, 8, 4, 2, 1):
        oc, ob = cost[:, lanes ^ m], best[:, lanes ^ m]
        take = (oc < cost) | ((oc == cost) & (ob < best))
        cost, best = torch.where(take, oc, cost), torch.where(take, ob, best)
    assert (best == best[:, :1]).all()
    b = best[:, 0]
    mv_q = torch.stack([4 * torch.as_tensor(mv[:, 0]) + b % 5 - 2,
                        4 * torch.as_tensor(mv[:, 1]) + b // 5 - 2], 1)
    return (mv_q.to(torch.int32),
            torch.as_tensor(ssd)[torch.arange(nb), b].to(torch.float32),
            torch.as_tensor(ssd[:, :25]))


@pytest.mark.parametrize("plane", ["noise", "flat0", "flat255"])
@pytest.mark.parametrize("n", [16, 32])
def test_k6_model_equals_the_plain_refinement(n, plane):
    """`k6_model` equals `subpel_refine_plain` exactly (MVs and SSDs) at
    n 16 and 32: on a textured plane with MVs at +-sr on the border blocks
    (the window clamps at every edge) and beyond, and on flat 0 and 255
    planes where all 25 SSDs tie (so lambda 0 leaves all 25 costs tied and
    the first minimum decides); lambdas 0, mid-range and large."""
    rng = np.random.default_rng(n + len(plane))
    h, w = 96, 128
    if plane == "noise":
        yy, xx = np.mgrid[0:h, 0:w]
        ref = np.clip(128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
                      + rng.normal(0, 20, (h, w)), 0, 255)
    else:
        ref = np.full((h, w), 0 if plane == "flat0" else 255)
    ref = ref.astype(np.int32)
    nb, wb = (h // n) * (w // n), w // n
    near = np.clip(np.roll(ref, (1, -2), (0, 1))
                   + rng.integers(-3, 4, (h, w)), 0, 255)
    cur = np.where(np.arange(nb)[:, None, None] % 2 == 0,
                   blocks(near, n).reshape(nb, n, n),
                   rng.integers(0, 256, (nb, n, n))).astype(np.int32)
    mv = rng.integers(-SR, SR + 1, (nb, 2)).astype(np.int32)
    mv[:wb] = (-SR, -SR)
    mv[-wb:] = (SR, SR)
    mv[::wb] = (-SR - 3, SR)
    lam = rng.uniform(0, 300, nb).astype(np.float32)
    lam[::3] = 0.0
    lam[1::4] = 4.0e5
    want = tme.subpel_refine_plain(T(ref), T(cur), T(mv), T(lam), n)
    got = k6_model(ref, cur, mv, lam, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    cand = T(mv)[:, None, :] * 4 + tme._SUBPEL_D[None]
    for k in range(25):
        d = tme.mc_luma_qpel_plain(T(ref), cand[:, k], n) - T(cur)
        assert torch.equal(got[2][:, k], (d.long() ** 2).sum((1, 2))), k
    if plane != "noise":
        tied = lam == 0
        assert (want[0][T(tied)] == T(4 * mv[tied] - 2)).all()


# ---- K9's decomposition on the card, modelled ------------------------------

# a shared-memory entry K9 never writes
_K9_UNSET = np.iinfo(np.int64).min // 4


def _k9_source(plane, mv, n, chroma):
    """One list's 14-bit predictions [nb, n, n] as K9's groups (the kernel
    of `csrc/mc_common.cuh`) form them: the (n + T - 1)^2 window staged
    with clamped rows, 16-byte pieces from x0 & ~3 where the window lies
    inside the plane's columns (the row starting s = x0 & 3 in, only the
    pieces up to the last one it needs), else a sample a column at clamped
    columns; the rows the vertical pass reads filtered horizontally once
    (all n + T - 1 at a vertical phase, else the n middle ones; phase 0:
    64 x the sample); the vertical taps (phase 0: 64 x the row), >> 6.
    Every entry read must have been written (checked) and every sum stays
    in int32."""
    taps, sh = (CHROMA, 3) if chroma else (LUMA, 2)
    t = taps.shape[1]
    m = t // 2 - 1
    ww = n + t - 1
    ch = (ww + 6) // 4
    p = np.asarray(plane, np.int64)
    h, w = p.shape
    mv = np.asarray(mv, np.int64)
    nb, wb = mv.shape[0], w // n
    win = np.full((nb, ww, 4 * ch), _K9_UNSET, np.int64)
    s = np.zeros(nb, np.int64)
    x0 = (np.arange(nb) % wb) * n + (mv[:, 0] >> sh) - m
    y0 = (np.arange(nb) // wb) * n + (mv[:, 1] >> sh) - m
    fx, fy = mv[:, 0] & ((1 << sh) - 1), mv[:, 1] & ((1 << sh) - 1)
    for k in range(nb):
        rows = np.clip(y0[k] + np.arange(ww), 0, h - 1)
        if w % 4 == 0 and x0[k] >= 0 and x0[k] + ww <= w:
            s[k] = x0[k] & 3
            last = (s[k] + ww - 1) >> 2
            c0 = x0[k] - s[k]
            win[k, :, :4 * (last + 1)] = p[rows][:, c0:c0 + 4 * (last + 1)]
        else:
            cols = np.clip(x0[k] + np.arange(ww), 0, w - 1)
            win[k, :, :ww] = p[rows][:, cols]
    hor = np.full((nb, ww, n), _K9_UNSET, np.int64)
    for k in range(nb):
        r0, nr = (0, ww) if fy[k] else (m, n)
        x = win[k, r0:r0 + nr, s[k]:]
        if fx[k]:
            seg = np.stack([x[:, q:q + n] for q in range(t)], -1)
            assert (seg != _K9_UNSET).all()
            hor[k, r0:r0 + nr] = seg @ taps[fx[k]]
        else:
            assert (x[:, m:m + n] != _K9_UNSET).all()
            hor[k, r0:r0 + nr] = 64 * x[:, m:m + n]
    out = np.empty((nb, n, n), np.int64)
    for k in range(nb):
        if fy[k]:
            seg = np.stack([hor[k, q:q + n] for q in range(t)], -1)
            assert (seg != _K9_UNSET).all()
            out[k] = seg @ taps[fy[k]]
        else:
            assert (hor[k, m:m + n] != _K9_UNSET).all()
            out[k] = 64 * hor[k, m:m + n]
    assert np.abs(hor[hor != _K9_UNSET]).max() < 2 ** 31
    assert np.abs(out).max() < 2 ** 31
    return out >> 6


def k9_model(ref0, ref1, mv0, mv1, n, chroma):
    """K9 as its groups compute it: each list's window staged and filtered
    once (`_k9_source`), the two 14-bit values combined as (a + c + 64)
    >> 7 with arithmetic shifts (their sum checked within int32) and
    clipped to 0..255.  [nb, n, n] int32."""
    a = _k9_source(ref0, mv0, n, chroma)
    c = _k9_source(ref1, mv1, n, chroma)
    assert np.abs(a + c + 64).max() < 2 ** 31
    return np.clip((a + c + 64) >> 7, 0, 255).astype(np.int32)


LUMA = tme.LUMA_FILTERS.astype(np.int64)
CHROMA = tme.CHROMA_FILTERS.astype(np.int64)


@pytest.mark.parametrize("n,chroma", [(8, False), (16, False), (32, False),
                                      (8, True), (16, True), (32, True)])
def test_k9_model_equals_the_plain_bi_prediction(n, chroma):
    """`k9_model` equals `mc_bi_plain` exactly at n 8, 16 and 32, luma and
    chroma, on planes with 0/255 steps (negative 14-bit lobes) at 64x96
    and 64x100 (a width not a multiple of 4: every window read a sample a
    column): MVs at +-(sr + 2) integer samples (sr 16, the window
    contract's edge) on the border blocks, pointing past the four plane
    edges, every phase pair in turn, the rest at random."""
    rng = np.random.default_rng(9 * n + chroma)
    unit, m = (8, 10) if chroma else (4, 18)
    for h, w in ((64, 96), (64, 100)):
        planes = []
        for _ in range(2):
            p = rng.integers(0, 256, (h, w))
            p[:, : w // 3] = 0
            p[:, w // 3: w // 2] = 255
            p[h // 2:, w // 2: w // 2 + 5] = 255
            planes.append(p.astype(np.int32))
        wb = w // n
        nb = (h // n) * wb
        mvs = []
        for _ in range(2):
            mv = rng.integers(-m, m + 1, (nb, 2)) * unit
            mv[:wb, 1], mv[-wb:, 1] = -m * unit, m * unit
            mv[::wb, 0], mv[wb - 1::wb, 0] = -m * unit, m * unit
            i = np.arange(nb)
            mvs.append((mv + np.stack([i % unit, (i // unit + 3 * i) % unit],
                                      1)).astype(np.int32))
        got = k9_model(planes[0], planes[1], mvs[0], mvs[1], n, chroma)
        want = tme.mc_bi_plain(T(planes[0]), T(planes[1]), T(mvs[0]),
                               T(mvs[1]), n, chroma).numpy()
        np.testing.assert_array_equal(got, want)


# ---- the ME argmin on the card, modelled -----------------------------------

_INF = np.float32(np.inf)


def _keep_min(c, i, c2, i2):
    """The kernels' keep_min on arrays: the least (cost, index), ties to
    the lower index."""
    take = (c2 < c) | ((c2 == c) & (i2 < i))
    return np.where(take, c2, c), np.where(take, i2, i)


def _shuffle_min(c, i):
    """A warp's shuffle tree (shfl_down 16, 8, 4, 2, 1; a lane beyond the
    warp reads its own value) on [..., 32] lanes: lane 0's result."""
    lane = np.arange(32)
    for off in (16, 8, 4, 2, 1):
        src = np.where(lane + off < 32, lane + off, lane)
        c, i = _keep_min(c, i, c[..., src], i[..., src])
    return c[..., 0], i[..., 0]


def _mv_cost(lam, bits, g):
    """__fmaf_rn(lam, bits, g) in f32."""
    return fma32(torch.as_tensor(lam), torch.as_tensor(bits),
                 torch.as_tensor(g)).numpy()


def _lane_mins(cost, seqs, n):
    """Each thread's first minimum (keep_min in its visiting order) of
    cost [nb, n] over its flat indices ``seqs`` (a list a thread):
    ([nb, threads] costs, indices)."""
    k = max(map(len, seqs))
    idx = np.array([list(q) + [n] * (k - len(q)) for q in seqs])
    padded = np.concatenate([cost, np.full((cost.shape[0], 1), _INF,
                                           np.float32)], 1)
    c = np.full((cost.shape[0], len(seqs)), _INF, np.float32)
    i = np.full(c.shape, n, np.int64)
    for j in range(k):
        c, i = _keep_min(c, i, padded[:, idx[:, j]], idx[None, :, j])
    return c, i


def argmin_model(grid, lam, sr):
    """The ME argmin as the card runs it: folded into K5's epilogue
    (`csrc/me_ssd.cu`'s `me_ssd_grid_argmin`).  K5's fast-path epilogue
    order: (S + 7) // 8 warps, the S x 4 column runs (dx, a run of
    ceil(S / 4) dy) dealt to the threads in turn, dy increasing within a
    run (a run's strict first minimum, then the thread's keep_min); the
    bits (2 + X[dx]) + X[dy] in f32 adds from the table X[d] = 2 bitlen(4
    |d - sr|); the cost fma(lam, bits, g); a thread's minimum, the shuffle
    tree in each warp, then the least of the warps' keys (cost bits << 32)
    | index (a shared atomicMin: the costs are non-negative, so their bits
    order as they do); and the order of its exact int32 loop (offset t to
    thread t % T, T threads).

    Returns the two results, each [nb, 2] int32 (dx, dy)."""
    grid = np.asarray(grid, np.float32)
    lam = np.asarray(lam, np.float32)
    nb, s, _ = grid.shape
    n = s * s
    d = np.arange(s)
    bl = np.where(d == sr, 0, np.frexp(4.0 * np.abs(d - sr))[1])
    xt = (2 * bl).astype(np.float32)                # the table X
    bits = (np.float32(2.0) + xt)[None, :] + xt[:, None]      # [dy, dx]
    cost = _mv_cost(lam[:, None, None], bits[None], grid).reshape(nb, n)
    warps = (s + 7) // 8
    threads = 32 * warps
    run = -(-s // 4)
    fast = [[] for _ in range(threads)]
    for task in range(s * 4):
        dx, dy0 = task % s, (task // s) * run
        fast[task % threads] += [dy * s + dx
                                 for dy in range(dy0, min(dy0 + run, s))]
    wide = [list(range(t, n, threads)) for t in range(threads)]
    out = []
    for seqs in (fast, wide):
        tc, ti = _lane_mins(cost, seqs, n)
        wc, wi = _shuffle_min(tc.reshape(nb, warps, 32),
                              ti.reshape(nb, warps, 32))
        assert (wc >= 0).all()
        key = (wc.view(np.uint32).astype(np.uint64) << 32) | wi.astype(
            np.uint64)
        out.append((key.min(1) & 0xFFFFFFFF).astype(np.int64))
    return [np.stack([i % s - sr, i // s - sr], 1).astype(np.int32)
            for i in out]


@pytest.mark.parametrize("sr", [4, 8, 16, 32])
def test_argmin_model_equals_the_plain_argmin(sr):
    """`argmin_model` (the two orders of K5's epilogue) equals
    `int_mv_argmin_plain` at sr 4, 8, 16 and 32 on the crafted FMA near-ties of `_near_ties` (candidate a at
    (-sr, -sr) within ulps of candidate b at (0, 0)), exact ties (a copy
    of the first candidate at (-sr + 1, -sr + 1) and on the last offset:
    the first index wins), a grid of equal values (every cost of one bit
    count ties: the argmin is (0, 0), the fewest bits) and random grids."""
    rng = np.random.default_rng(77 + sr)
    s = 2 * sr + 1
    bits_a = float(tme.mvd_bits(torch.tensor([-4 * sr, -4 * sr])))
    lam, ca, cb = _near_ties(rng, 48, bits_a, 2.0, (1000, 1000000))
    grid = rng.uniform(2e6, 3e7, (lam.size, s, s)).astype(np.float32)
    grid[:, 0, 0], grid[:, sr, sr] = ca, cb
    grid[::3, 1, 1] = grid[::3, 0, 0]
    grid[1::3, -1, -1] = grid[1::3, 0, 0]
    grid[2::6] = 5e5
    lam[::5] = 0.0
    want = tme.int_mv_argmin_plain(T(grid), T(lam), sr).numpy()
    for got in argmin_model(grid, lam, sr):
        np.testing.assert_array_equal(got, want)
    assert (want[2::6][lam[2::6] > 0] == 0).all()
    assert (want[lam == 0] == -sr).all()


# ---- K8 (`csrc/hpel.cu`): 64 x 32 tiles, the window staged once, the
# horizontal pass once a staged row, the vertical pass a thread a 4 x 4
# block ---------------------------------------------------------------------

K8_TW, K8_TH = 64, 32                  # output tile
K8_SW, K8_SH = K8_TW + 8, K8_TH + 7    # staged columns x0-4.., rows y0-3..
# the horizontal values of an 8-bit plane: -24 x 255 .. 88 x 255
K8_H_RANGE = (-6120, 22440)


def _tap8(a):
    """The symmetric (1/2) taps over the last axis of ``a`` [..., 8]."""
    return (40 * (a[..., 3] + a[..., 4]) - 11 * (a[..., 2] + a[..., 5])
            + 4 * (a[..., 1] + a[..., 6]) - (a[..., 0] + a[..., 7]))


def k8_model(ref):
    """K8 tile by tile as the kernel forms it: each CTA stages rows y0-3..
    y0+35 (clamped) and columns x0-4..x0+67, unclamped in 16-byte pieces
    where the window lies inside the plane's columns (W a multiple of 4),
    else clamped one sample at a time; the horizontal pass a thread 4
    outputs from three aligned 4-sample pieces (staged columns c+1..c+8
    for output c); the vertical pass a thread a 4 x 4 block from the 11
    filtered rows under it; writes masked to the plane.  Returns the plane
    and the horizontal values' range over the tiles."""
    h, w = ref.shape
    ref = ref.astype(np.int64)
    out = np.zeros((h, w), np.int64)
    writes = np.zeros((h, w), np.int64)
    lo, hi = 0, 0
    vec_ok = w % 4 == 0
    for y0 in range(0, h, K8_TH):
        rows = np.clip(y0 - 3 + np.arange(K8_SH), 0, h - 1)
        for x0 in range(0, w, K8_TW):
            cols = x0 - 4 + np.arange(K8_SW)
            if vec_ok and x0 >= 4 and x0 + K8_TW + 4 <= w:
                assert (x0 - 4) % 4 == 0 and 0 <= cols.min() \
                    and cols.max() < w
            else:
                cols = np.clip(cols, 0, w - 1)
            s_in = ref[rows][:, cols]                          # [39, 72]
            g = 4 * np.arange(K8_TW // 4)
            piece = s_in[:, g[:, None] + np.arange(12)]         # [39, 16, 12]
            hh = np.stack([_tap8(piece[..., j + 1:j + 9]) for j in range(4)],
                          -1).reshape(K8_SH, K8_TW)
            lo, hi = min(lo, int(hh.min())), max(hi, int(hh.max()))
            v = hh[4 * np.arange(K8_TH // 4)[:, None] + np.arange(11)]
            o = np.stack([_tap8(np.moveaxis(v[:, j:j + 8], 1, -1))
                          for j in range(4)], 1).reshape(K8_TH, K8_TW)
            o = (o + 2048) >> 12
            ys, xs = y0 + np.arange(K8_TH), x0 + np.arange(K8_TW)
            my, mx = ys < h, xs < w
            out[np.ix_(ys[my], xs[mx])] = o[my][:, mx]
            writes[np.ix_(ys[my], xs[mx])] += 1
    assert (writes == 1).all()
    return out.astype(np.int32), (lo, hi)


def test_k8_model_equals_the_plain_plane():
    """`k8_model` equals `hpel_plane_plain` on `k8_planes`: tiles on every
    border and inside, sides that are no multiple of the tile or of 4,
    planes smaller than one tile, 0/255 checkerboards and steps, the
    patches of the plane's extremes (518, -263) and rows that reach the
    horizontal pass's extremes; those values stay in K8_H_RANGE, which the
    taps' sign rows reach."""
    from test_torch_kernel_models import k8_planes
    lo, hi = 0, 0
    for name, ref in k8_planes():
        got, (a, b) = k8_model(ref)
        np.testing.assert_array_equal(
            got, tme.hpel_plane_plain(T(ref)).numpy(), err_msg=name)
        lo, hi = min(lo, a), max(hi, b)
    assert (lo, hi) == K8_H_RANGE
