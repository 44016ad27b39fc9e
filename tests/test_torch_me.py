"""Op parity of the port's P-slice ops against the JAX package on the CPU:
motion search, sub-pel refinement, motion compensation, the half-pel
plane, MVD bin counts, the inter residual chain, tu_bits at P-slice init
states and the inter bS maps.  The same numpy inputs, made from a seed, go
through each JAX function and the port's plain PyTorch version (the version
a CPU tensor takes).  Exact unless a test states its tolerance and why."""

import numpy as np
import pytest
import torch

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
from x265amod_tpu_torch.ops.residual import residual_chain
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

SR = 8      # config 2's search range (preset superfast)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def blocks(plane, bn):
    h, w = plane.shape
    return plane.reshape(h // bn, bn, w // bn, bn).transpose(0, 2, 1, 3)


def test_filter_tables_equal_the_jax_packages():
    np.testing.assert_array_equal(tme.LUMA_FILTERS, jme.LUMA_FILTERS)
    np.testing.assert_array_equal(tme.CHROMA_FILTERS, jme.CHROMA_FILTERS)


@pytest.mark.parametrize("bn,hi", [(16, 256), (32, 121)])
def test_me_ssd_grid_parity(bn, hi):
    """Row 13.  The JAX grid is w2 - 2 corr + c2 in f32: exact at bn 16 on
    any 8-bit content, and at bn 32 while block energies stay below 2^24
    (pixels 0..120).  The port's grid is the exact integer SSD.  Also the
    grid over the half-pel plane, whose samples reach about 1.45x the
    input range, on content where JAX stays exact."""
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
            jb = np.asarray(jeb.tu_bits(jnp.asarray(lv), c_idx=c_idx,
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
    jv, jh = (np.asarray(a) for a in jdb.inter_tree_bs_maps(
        jnp.asarray(intra), jnp.asarray(cbf), jnp.asarray(dir_),
        jnp.asarray(mv0), jnp.asarray(mv1), jnp.asarray(split),
        ref0=jnp.asarray(ref0)))
    tv, th = tdb.inter_tree_bs_maps(
        T(intra)[None], T(cbf)[None], T(dir_)[None], T(mv0)[None],
        T(mv1)[None], T(split)[None], T(ref0)[None])
    np.testing.assert_array_equal(tv[0].numpy(), jv)
    np.testing.assert_array_equal(th[0].numpy(), jh)
    assert set(np.unique(jv)) | set(np.unique(jh)) >= {0, 1}
