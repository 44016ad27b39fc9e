"""Op parity of the PyTorch port (x265amod_tpu_torch) against the JAX package
on the CPU: the same numpy inputs, made from a seed, go through each JAX
device function and through the port's plain PyTorch version (the version a
CPU tensor takes).  Exact unless a test states its tolerance and why."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265amod_tpu.models.intra_tree import _satd_modes
from x265amod_tpu.ops import deblock as jdb
from x265amod_tpu.ops import estbits as jeb
from x265amod_tpu.ops import intra as jintra
from x265amod_tpu.ops import metrics as jmet
from x265amod_tpu.ops import quant as jq
from x265amod_tpu.ops.sbh import sbh_adjust as j_sbh
from x265amod_tpu.ops.transforms import fwd_transform as j_fwd
from x265amod_tpu.ops.transforms import inv_transform as j_inv
from x265amod_tpu_torch.ops import deblock as tdb
from x265amod_tpu_torch.ops import estbits as teb
from x265amod_tpu_torch.ops import intra as tintra
from x265amod_tpu_torch.ops import metrics as tmet
from x265amod_tpu_torch.ops import quant as tq
from x265amod_tpu_torch.ops.residual import residual_chain
from x265amod_tpu_torch.ops.sbh import sbh_adjust as t_sbh
from x265amod_tpu_torch.ops.transforms import fwd_transform as t_fwd
from x265amod_tpu_torch.ops.transforms import inv_transform as t_inv
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def raw_refs(rng, b, n):
    """Raw refs with availability patterns: none available, top-right or
    below-left missing, random holes, flat 0 and 255 references."""
    top = rng.integers(0, 256, (b, 2 * n)).astype(np.int32)
    left = rng.integers(0, 256, (b, 2 * n)).astype(np.int32)
    cor = rng.integers(0, 256, b).astype(np.int32)
    at = rng.random((b, 2 * n)) < 0.8
    al = rng.random((b, 2 * n)) < 0.8
    ac = rng.random(b) < 0.7
    at[0], al[0], ac[0] = False, False, False
    at[1, n:], al[1, n:] = False, False
    top[2], left[2], cor[2] = 0, 0, 0
    top[3], left[3], cor[3] = 255, 255, 255
    return top, left, cor, at, al, ac


def residual_inputs(rng, b, k, n):
    """Source blocks and K predictions near them (the path's domain), with
    flat 0 / 255 blocks and a zero residual."""
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-24, 25, (b, k, n, n)), 0,
                   255).astype(np.int32)
    orig[0], pred[0] = 0, 255
    orig[1], pred[1] = 255, 255
    return orig, pred


@pytest.mark.parametrize("n,c_idx", [(8, 0), (16, 0), (32, 0), (8, 1),
                                     (16, 1)])
def test_intra_pred_parity(n, c_idx):
    """Rows 1-4: substitution, all 35 predictions, single-mode
    predictions and the 8x8 Hadamard SATD."""
    rng = np.random.default_rng(10 * n + c_idx)
    b = 6
    refs = raw_refs(rng, b, n)
    jt, jl, jc = (np.asarray(a) for a in
                  jintra.substitute_refs_general(*refs, n))
    tt, tl, tc = (a.numpy() for a in
                  tintra.substitute_refs_general(*map(T, refs), n))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    jp = np.asarray(jintra.predict_all_modes_batch(jt, jl, jc, n, c_idx))
    np.testing.assert_array_equal(
        tintra._predict_all_plain(T(jt), T(jl), T(jc), n, c_idx).numpy(), jp)
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    orig[2] = 0
    orig[3] = 255
    np.testing.assert_array_equal(
        tintra.satd35(T(orig), *map(T, refs), n, c_idx).numpy(),
        np.asarray(_satd_modes(jnp.asarray(orig), jnp.asarray(jp))))
    modes = rng.integers(0, 35, (b, 2)).astype(np.int32)
    got = tintra.predict(*map(T, refs), T(modes), n, c_idx).numpy()
    for k in range(2):
        np.testing.assert_array_equal(got[:, k], np.asarray(
            jintra.predict_modes_batch(jt, jl, jc, modes[:, k], n, c_idx)))


@pytest.mark.parametrize("qp", [0, 22, 30, 51])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_residual_chain_parity(n, qp):
    """Rows 5-7 and the chain of kernel K2: forward DCT, quant, SBH,
    dequant, inverse DCT, recon and SSD at per-block QPs."""
    rng = np.random.default_rng(100 * n + qp)
    b, k = 4, 2
    orig, pred = residual_inputs(rng, b, k, n)
    qpv = np.full(b, qp, np.int32)
    qpv[3] = max(qp - 5, 0)
    coeff = j_fwd(jnp.asarray(orig[:, None] - pred))
    np.testing.assert_array_equal(
        t_fwd(T(orig[:, None] - pred)).numpy(), np.asarray(coeff))
    qpb = jnp.asarray(qpv)[:, None, None, None]
    jlv = jq.quant(coeff, qpb)
    tlv = tq.quant(T(np.asarray(coeff)), T(qpv)[:, None, None, None])
    np.testing.assert_array_equal(tlv.numpy(), np.asarray(jlv))
    jlv = j_sbh(jlv)
    np.testing.assert_array_equal(t_sbh(tlv).numpy(), np.asarray(jlv))
    jdq = jq.dequant(jlv, qpb)
    np.testing.assert_array_equal(
        tq.dequant(T(np.asarray(jlv)), T(qpv)[:, None, None, None]).numpy(),
        np.asarray(jdq))
    np.testing.assert_array_equal(t_inv(T(np.asarray(jdq))).numpy(),
                                  np.asarray(j_inv(jdq)))
    jrec = np.clip(pred + np.asarray(j_inv(jdq)), 0, 255)
    lv, rec, ssd = residual_chain(T(orig), T(pred), T(qpv), True)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jlv))
    np.testing.assert_array_equal(rec.numpy(), jrec)
    np.testing.assert_array_equal(
        ssd.numpy(), ((jrec - orig[:, None]) ** 2).sum((2, 3)))


def test_dequant_wraps_in_jax_beyond_the_path_domain():
    """Documents the one known divergence: with x64 off the JAX dequant
    computes |level| * scale in int32 and wraps at QP 51 for |level| =
    32767 (about 7.6e9); the port computes the normative wide value.
    `quant` never yields such a level at QP 51 (|coeff| < 2^17)."""
    lv = np.array([[[32767] * 8] * 8], np.int32)
    qp = np.array([51], np.int32)[:, None, None]
    port = tq.dequant(T(lv), T(qp)).numpy()
    assert (port == 32767).all()                    # normative clip
    jax_v = np.asarray(jq.dequant(jnp.asarray(lv), jnp.asarray(qp)))
    assert (jax_v != port).any()                    # int32 wrap in JAX
    c = np.full((1, 8, 8), (1 << 17) - 1, np.int32)
    reach = tq.quant(T(c), T(qp)).numpy()
    assert np.abs(reach).max() * (57 * 16 << 8) < 2 ** 31


@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("qp", [0, 22, 30, 51])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_tu_bits_parity(n, qp, c_idx):
    """Row 8 on the levels of the residual chain (noisy residuals, so the
    TUs are dense).  The port sums each fractional family exactly in units
    of 2^-15 bit, so it equals the JAX value wherever JAX's f32 sums are
    exact (every partial sum below 512 bits, see the sparse test below).
    Past 512 bits XLA rounds each partial sum in its own order: up to 1024
    terms of relative error 2^-24 each; 4.2e-6 was the largest seen, so the
    tolerance is rtol 1e-5."""
    rng = np.random.default_rng(1000 * n + 10 * qp + c_idx)
    b, k = 6, 2
    orig, pred = residual_inputs(rng, b, k, n)
    qpv = np.full(b, qp, np.int32)
    lv, _, _ = residual_chain(T(orig), T(pred), T(qpv), False)
    lv = lv.numpy()
    jb = np.asarray(jeb.tu_bits(jnp.asarray(lv.astype(np.int32)),
                                c_idx=c_idx, slice_type="I",
                                qp=jnp.asarray(qpv)[:, None]))
    tb = teb.tu_bits(T(lv), c_idx, T(qpv)[:, None]).numpy()
    assert tb.dtype == np.float32
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=0)


def test_tu_bits_sparse_blocks_exact():
    """Sparse blocks (every JAX partial sum below 512 bits): bit-exact."""
    rng = np.random.default_rng(5)
    for n in (8, 16, 32):
        lv = (rng.integers(-6, 7, (12, n, n))
              * (rng.random((12, n, n)) < 0.05)).astype(np.int32)
        lv[0] = 0
        qp = rng.integers(0, 52, 12).astype(np.int32)
        for c_idx in (0, 1):
            jb = np.asarray(jeb.tu_bits(jnp.asarray(lv), c_idx=c_idx,
                                        slice_type="I", qp=jnp.asarray(qp)))
            tb = teb.tu_bits(T(lv), c_idx, T(qp)).numpy()
            np.testing.assert_array_equal(tb, jb)


def test_tu_bits_integer_log2_matches_f32_form():
    """The Golomb-Rice floor(log2(.)) terms are integers in the port.  Over
    the domain tu_bits can see they equal the JAX f32 forms: k from every
    cg_sum in 0..16*32767, and esc for every remainder the CG sum allows
    (rem <= cg_sum, and k <= 3 holds only while cg_sum < 256).  The JAX
    f32 log2 of 8192.0 rounds below 13, which would matter only for
    rem = 8194 at k = 0 or rem = 16388 at k = 1: unreachable."""
    s = np.arange(0, 16 * 32767 + 1, dtype=np.int32)
    kj = np.asarray(jnp.clip(jnp.floor(jnp.log2(jnp.maximum(
        jnp.asarray(s).astype(jnp.float32) / 16.0, 1.0))), 0, 4))
    kt = torch.clamp(teb._bitlen(T(s).long()) - 5, 0, 4).numpy()
    np.testing.assert_array_equal(kt, kj)
    for k in range(5):
        top = 32767 if k == 4 else (32 << k) - 1
        rem = np.arange(0, top + 1, dtype=np.int32)
        kf = jnp.float32(k)
        ej = np.asarray(jnp.floor(jnp.log2(jnp.maximum(
            jnp.asarray(rem).astype(jnp.float32) - (3.0 * (2.0 ** kf))
            + (2.0 ** kf), 1.0) / (2.0 ** kf))) + 1.0)
        et = (teb._bitlen(torch.clamp(T(rem).long() - (2 << k), min=1))
              - k).numpy()
        np.testing.assert_array_equal(et, ej)


@pytest.mark.parametrize("seed", [0, 1])
def test_deblock_parity(seed):
    """Rows 9-10: bS maps, the decoded QP chain, edge QPs and both filters
    over two frames at 128x64, with random splits and coded cells."""
    rng = np.random.default_rng(seed)
    f, h, w = 2, 64, 128
    h16, w16 = h // 16, w // 16
    split = rng.integers(0, 2, (f, h16 // 2, w16 // 2)).astype(np.int32)
    coded = rng.random((f, h16, w16)) < 0.6
    qp32 = rng.integers(20, 40, (h16 // 2, w16 // 2)).astype(np.int32)
    sq = 30
    bs_v, bs_h = tdb.intra_tree_bs_maps(T(split), h16, w16)
    eff = tdb.effective_qp16_tree(T(qp32), T(split), T(coded), sq)
    qp_v, qp_h = tdb.edge_qp_maps(eff)
    smooth = (np.arange(w)[None, :] * 2 + np.arange(h)[:, None]) % 256
    y = np.clip(smooth[None] + rng.integers(-5, 6, (f, h, w)), 0, 255)
    cb = rng.integers(100, 160, (f, h // 2, w // 2))
    for i in range(f):
        jv, jh = (np.asarray(a) for a in
                  jdb.intra_tree_bs_maps(jnp.asarray(split[i]), h16, w16))
        np.testing.assert_array_equal(bs_v[i].numpy(), jv)
        np.testing.assert_array_equal(bs_h[i].numpy(), jh)
        je = np.asarray(jdb.effective_qp16_tree(
            jnp.asarray(qp32), jnp.asarray(split[i]), jnp.asarray(coded[i]),
            sq))
        np.testing.assert_array_equal(eff[i].numpy(), je)
        jqv, jqh = (np.asarray(a) for a in jdb.edge_qp_maps(jnp.asarray(je)))
        jy = np.asarray(jdb.deblock_luma_bs(
            jnp.asarray(y[i], jnp.int32), sq, jnp.asarray(jv),
            jnp.asarray(jh), 16, qp_v=jnp.asarray(jqv),
            qp_h=jnp.asarray(jqh)))
        jc = np.asarray(jdb.deblock_chroma_bs(
            jnp.asarray(cb[i], jnp.int32), sq, jnp.asarray(jv),
            jnp.asarray(jh), 8, qpc_v=jq.chroma_qp_jnp(jnp.asarray(jqv)),
            qpc_h=jq.chroma_qp_jnp(jnp.asarray(jqh))))
        ty = tdb.deblock_luma(T(y), bs_v, bs_h, qp_v, qp_h)[i].numpy()
        tc = tdb.deblock_chroma(T(cb), bs_v, bs_h, tq.chroma_qp_t(qp_v),
                                tq.chroma_qp_t(qp_h))[i].numpy()
        np.testing.assert_array_equal(ty, jy)
        np.testing.assert_array_equal(tc, jc)
        assert (ty != y[i]).any()


def test_ssim_and_sse_parity():
    """Row 11.  SSE is an exact integer sum; SSIM is f32 window means, so
    it agrees to f32 rounding (atol 1e-6), not bit for bit."""
    rng = np.random.default_rng(3)
    a = rng.integers(0, 256, (2, 64, 96)).astype(np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-9, 10, a.shape), 0,
                255).astype(np.uint8)
    for i in range(2):
        js = float(jmet.ssim_plane(jnp.asarray(a[i]), jnp.asarray(b[i])))
        assert abs(float(tmet.ssim_plane(T(a), T(b))[i]) - js) < 1e-6
        jsse = float(jnp.sum((jnp.asarray(b[i], jnp.int32)
                              - jnp.asarray(a[i], jnp.int32))
                             .astype(jnp.float32) ** 2))
        assert float(tmet.plane_sse(T(a), T(b))[i]) == jsse
