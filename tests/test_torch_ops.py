"""Op parity of the PyTorch port (x265amod_tpu_torch) against the JAX package
on the CPU: the same numpy inputs, made from a seed, go through each JAX
device function and through the port's plain PyTorch version (the version a
CPU tensor takes).  Exact unless a test states its tolerance and why.
`k22_model` holds K22's lanes and reduction (`csrc/frame_metrics.cu`) to
the plain metrics, in plain numpy and PyTorch."""

import numpy as np
import pytest
import torch

import jax
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

# the JAX tu_bits under jit, as the JAX trees run it: one compile a shape
# for the file instead of one for each of its eager operations
_j_tu_bits = jax.jit(jeb.tu_bits, static_argnames=("c_idx", "slice_type",
                                                   "sbh"))
# likewise the deblocking maps and the SATD, which the JAX package leaves
# unjitted (its trees call them inside their own jit)
_j_intra_bs = jax.jit(jdb.intra_tree_bs_maps, static_argnames=("h16",
                                                               "w16"))
_j_inter_bs = jax.jit(jdb.inter_tree_bs_maps)
_j_eff_qp = jax.jit(jdb.effective_qp_map, static_argnames=("slice_qp",
                                                          "wpp"))
_j_eff_qp16 = jax.jit(jdb.effective_qp16_tree, static_argnames=("slice_qp",
                                                               "wpp"))
_j_edge_qp = jax.jit(jdb.edge_qp_maps)
_j_satd = jax.jit(_satd_modes)

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
        np.asarray(_j_satd(jnp.asarray(orig), jnp.asarray(jp))))
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
    jb = np.asarray(_j_tu_bits(jnp.asarray(lv.astype(np.int32)),
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
            jb = np.asarray(_j_tu_bits(jnp.asarray(lv), c_idx=c_idx,
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
                  _j_intra_bs(jnp.asarray(split[i]), h16, w16))
        np.testing.assert_array_equal(bs_v[i].numpy(), jv)
        np.testing.assert_array_equal(bs_h[i].numpy(), jh)
        je = np.asarray(_j_eff_qp16(
            jnp.asarray(qp32), jnp.asarray(split[i]), jnp.asarray(coded[i]),
            sq))
        np.testing.assert_array_equal(eff[i].numpy(), je)
        jqv, jqh = (np.asarray(a) for a in _j_edge_qp(jnp.asarray(je)))
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


@pytest.mark.parametrize("shape", ["intra_tree", "inter_p", "inter_b",
                                   "flat"])
def test_deblock_maps_parity(shape):
    """Row 10 as K21's plain version computes it, from a frame batch's
    levels: against the JAX functions the encoders call (the intra tree:
    `intra_tree_bs_maps` and `effective_qp16_tree`; the P/B trees:
    `inter_tree_bs_maps` with the TU luma cbf and `effective_qp16_tree`;
    the flat CTB16 frame: bS 2 everywhere and `effective_qp_map`), then
    `edge_qp_maps` and the chroma mapping; two frames at 128x64, one of
    them with nothing coded."""
    rng = np.random.default_rng(40 + len(shape))
    f, h16, w16 = 2, 4, 8
    lv = []
    for n in (16, 8, 8):
        v = rng.integers(-3, 4, (f, h16, w16, n, n)) * (
            rng.random((f, h16, w16, 1, 1)) < 0.4) * (
            rng.random((f, h16, w16, n, n)) < 0.1)
        v[1] = 0
        lv.append(v.astype(np.int16))
    flat = shape == "flat"
    grid = (h16, w16) if flat else (h16 // 2, w16 // 2)
    qp_sig = rng.integers(22, 40, grid).astype(np.int32)
    split = None if flat else rng.integers(0, 2, (f,) + grid).astype(
        np.int32)
    kinds = rng.integers(0, 3, (f, h16, w16)).astype(np.int32)
    b = shape == "inter_b"
    dirs = rng.integers(1, 4, (f, h16, w16)).astype(np.int32) if b else None
    mv0, mv1 = (rng.integers(-9, 10, (f, h16, w16, 2)).astype(np.int32)
                for _ in range(2))
    ref0 = None if b else rng.integers(0, 2, (f, h16, w16)).astype(np.int32)
    inter = None
    if shape.startswith("inter"):
        inter = (T(kinds), None if dirs is None else T(dirs), T(mv0),
                 T(mv1) if b else None, None if ref0 is None else T(ref0))
    got = tdb.deblock_maps_plain(tuple(T(a) for a in lv), 30, T(qp_sig),
                                 None if flat else T(split), inter)
    for i in range(f):
        nz_y = (lv[0][i] != 0).any((2, 3))
        coded = nz_y | (lv[1][i] != 0).any((2, 3)) | \
            (lv[2][i] != 0).any((2, 3))
        if flat:
            bs = (np.full((h16, w16 - 1), 2), np.full((h16 - 1, w16), 2))
            eff = _j_eff_qp(jnp.asarray(qp_sig),
                                       jnp.asarray(coded), 30)
        else:
            eff = _j_eff_qp16(jnp.asarray(qp_sig),
                                          jnp.asarray(split[i]),
                                          jnp.asarray(coded), 30)
            if inter is None:
                bs = _j_intra_bs(jnp.asarray(split[i]), h16, w16)
            else:
                intra = kinds[i] == 2
                cbf32 = nz_y.reshape(h16 // 2, 2, w16 // 2, 2).any((1, 3))
                sp = np.repeat(np.repeat(split[i], 2, 0), 2, 1) == 1
                cbf = np.where(sp, nz_y, np.repeat(np.repeat(cbf32, 2, 0),
                                                   2, 1))
                # the JAX trees zero the motion of intra cells
                d_ = np.where(intra, 0, dirs[i] if b else 1)
                m0 = np.where(intra[..., None], 0, mv0[i])
                m1 = np.where(intra[..., None], 0, mv1[i]) if b else \
                    np.zeros_like(m0)
                r0 = np.zeros_like(kinds[i]) if b else \
                    np.where(intra, 0, ref0[i])
                bs = _j_inter_bs(
                    jnp.asarray(intra), jnp.asarray(cbf), jnp.asarray(d_),
                    jnp.asarray(m0), jnp.asarray(m1), jnp.asarray(split[i]),
                    ref0=jnp.asarray(r0))
        qv, qh = _j_edge_qp(eff)
        want = (bs[0], qv, jq.chroma_qp_jnp(qv), bs[1], qh,
                jq.chroma_qp_jnp(qh))
        for g, w_ in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w_))


def test_frame_metrics_parity():
    """Row 11 as K22's plain version gives it, [F, 4] per frame batch:
    the SSE of each plane equal to the JAX encoders' f32 sums (exact at
    this size), the SSIM within 1e-6 of `ssim_plane`."""
    rng = np.random.default_rng(5)
    src = [rng.integers(0, 256, s).astype(np.int32)
           for s in ((2, 64, 96), (2, 32, 48), (2, 32, 48))]
    rec = [np.clip(a + rng.integers(-9, 10, a.shape), 0, 255) for a in src]
    got = tmet.frame_metrics_plain(tuple(T(a) for a in src),
                                   tuple(T(a) for a in rec)).numpy()
    for i in range(2):
        for k in range(3):
            assert got[i, k] == float(jnp.sum((jnp.asarray(rec[k][i])
                                               - jnp.asarray(src[k][i]))
                                              .astype(jnp.float32) ** 2))
        js = float(jmet.ssim_plane(jnp.asarray(src[0][i]),
                                   jnp.asarray(rec[0][i])))
        assert abs(got[i, 3] - js) <= 1e-6


# ---- K22 (`csrc/frame_metrics.cu`): a warp a band of 8 rows x a strip of
# 64 columns, four warps a CTA, exact integer sums in any order -----------

K22_WARPS, K22_STRIP = 4, 64
K22_SCALE = 2.0 ** 40           # a window's SSIM in fixed point
_LANE = np.arange(32)


def _xor_tree(v):
    """A warp's xor-shuffle sum over its lanes (the last axis): v += v[l ^
    o] for o = 16, 8, 4, 2, 1, as `warp_sum` adds (every lane ends with
    the same value; lane 0's is returned)."""
    for o in (16, 8, 4, 2, 1):
        v = v + v[..., _LANE ^ o]
    return v[..., 0]


def _window_ssim32(sx, sy, sxx, syy, sxy):
    """`window_ssim` in float32, one rounding an operation, no FMA, in the
    kernel's order."""
    f = np.float32
    c1, c2, n = f(6.5025), f(58.5225), f(64)
    mx, my = f(sx) / n, f(sy) / n       # exact, as the kernel's x (1/64)
    vx = f(sxx) / n - mx * mx
    vy = f(syy) / n - my * my
    cov = f(sxy) / n - mx * my
    num = (f(2) * mx * my + c1) * (f(2) * cov + c2)
    den = (mx * mx + my * my + c1) * (vx + vy + c2)
    return num / den


def _k22_lanes(src, rec, fi, ssim):
    """Frame ``fi``'s warps as the kernel runs them: per CTA and warp its
    SSEs and SSIM (the xor tree over its windows' f32 values in fixed
    point, x 2^40 rounded to nearest even), int64, and the windows' SSIM
    [H/8, W/8] f32."""
    sy, scb, scr = (p[fi] for p in src)
    ry, rcb, rcr = (p[fi] for p in rec)
    h, w = sy.shape
    strips = -(-w // K22_STRIP)
    units = (h // 8) * strips
    ctas = -(-units // K22_WARPS)
    u = np.arange(ctas * K22_WARPS)
    band, strip = u // strips, u % strips
    valid = (u < units)[:, None]
    # luma: lane (rp, g) reads columns 4g..4g+3 of rows rp + 2 it
    g, rp = _LANE & 15, _LANE >> 4
    col = strip[:, None] * K22_STRIP + 4 * g
    on = valid & (col < w)
    rows = band[:, None, None] * 8 + rp[None, :, None] + 2 * np.arange(4)
    r_ = np.where(on[..., None], rows, 0)[..., None]
    c_ = np.where(on, col, 0)[..., None, None] + np.arange(4)
    a = np.where(on[..., None, None], sy[r_, c_], 0).astype(np.int64)
    b = np.where(on[..., None, None], ry[r_, c_], 0).astype(np.int64)
    lane_sse = ((a - b) ** 2).sum((2, 3))
    assert lane_sse.max() < 2 ** 31             # the lane's int32
    ss = np.zeros(lane_sse.shape, np.int64)
    win = np.full((h // 8, w // 8), np.nan, np.float32)
    if ssim:
        mom = [a.sum((2, 3)), b.sum((2, 3)), (a * a).sum((2, 3)),
               (b * b).sum((2, 3)), (a * b).sum((2, 3))]
        for k in range(5):                      # shfl_xor 1, then 16
            mom[k] = mom[k] + mom[k][:, _LANE ^ 1]
            mom[k] = mom[k] + mom[k][:, _LANE ^ 16]
            assert mom[k].max() < 2 ** 31
        s32 = _window_ssim32(*(m.astype(np.int32) for m in mom))
        own = on & ((_LANE & 17) == 0)
        fx = np.rint((s32 * np.float32(K22_SCALE)).astype(np.float64))
        ss = np.where(own, fx, 0).astype(np.int64)
        uu, ll = np.nonzero(own)
        win[band[uu], strip[uu] * 8 + g[ll] // 2] = s32[uu, ll]
        assert not np.isnan(win).any()          # each window once
    # chroma: lane l reads row l / 8 of the band's 4, columns 4 (l % 8)
    ccol = strip[:, None] * (K22_STRIP // 2) + 4 * (_LANE & 7)
    con = valid & (ccol < w // 2)
    crow = np.where(con, band[:, None] * 4 + (_LANE >> 3), 0)[..., None]
    cc = np.where(con, ccol, 0)[..., None] + np.arange(4)
    lane_c = [np.where(con[..., None], (p[crow, cc].astype(np.int64)
                                        - q[crow, cc]) ** 2, 0).sum(-1)
              for p, q in ((scb, rcb), (scr, rcr))]
    warps = np.stack([_xor_tree(lane_sse), _xor_tree(lane_c[0]),
                      _xor_tree(lane_c[1])], -1).reshape(ctas, K22_WARPS, 3)
    wss = _xor_tree(ss).reshape(ctas, K22_WARPS)
    return warps, wss, win


def k22_model(src, rec, ssim, orders):
    """K22 on numpy planes as the kernel forms it: `_k22_lanes`, each CTA's
    4 warps added, then the CTAs' atomic adds to the frame's four 64-bit
    accumulators in an order of ``orders`` (each a permutation of the CTAs
    a frame), the one whose count reaches the frame's CTAs taking the
    sums: SSIM = sum / 2^40 / windows in f64, then f32.  Returns out [F,
    4] f32 for each order and the windows' SSIM [F, H/8, W/8]."""
    f, h, w = src[0].shape
    lanes = [_k22_lanes(src, rec, fi, ssim) for fi in range(f)]
    outs = []
    for order in orders:
        out = np.zeros((f, 4), np.float32)
        for fi, (warps, wss, _) in enumerate(lanes):
            cta = np.concatenate([warps, wss[..., None]], -1).sum(1)
            acc, counter = np.zeros(4, np.int64), 0
            for c in order[fi]:
                acc += cta[c]
                counter += 1
            assert counter == cta.shape[0]
            out[fi, :3] = acc[:3].astype(np.float32)
            out[fi, 3] = np.float32(np.float64(acc[3]) / K22_SCALE
                                    / ((h // 8) * (w // 8))) if ssim else 0
        outs.append(out)
    return outs, np.stack([win for _, _, win in lanes])


@pytest.mark.parametrize("kind", ["random", "identical", "checker",
                                  "ten_bit"])
def test_k22_model_equals_the_plain_metrics(kind):
    """`k22_model` against `frame_metrics_plain` at 640x384 x 2 frames,
    1280x736 and 1920x1088 (`K22_SHAPES`; the strips' masked tail at
    1280 and 640 is none, at the 96-column frame of the card tests one),
    on random content, identical planes (SSE 0, SSIM 1), 0/255
    checkerboards and 10-bit samples without SSIM: SSEs equal, each
    window's SSIM equal to the plain version's bit for bit, the frame's
    within 1e-6 and the same bits under four CTA completion orders."""
    from test_torch_kernel_models import K22_SHAPES, k22_frames
    for f, h, w in K22_SHAPES + ((1, 64, 96),):
        src, rec, ssim = k22_frames(kind, f, h, w, seed=h + f)
        want = tmet.frame_metrics_plain(tuple(T(p) for p in src),
                                        tuple(T(p) for p in rec),
                                        ssim).numpy()
        rng = np.random.default_rng(w)
        ctas = -(-(h // 8) * -(-w // K22_STRIP) // K22_WARPS)
        orders = [[np.arange(ctas)] * f, [np.arange(ctas)[::-1]] * f] + [
            [rng.permutation(ctas) for _ in range(f)] for _ in range(2)]
        outs, win = k22_model(src, rec, ssim, orders)
        got = outs[0]
        for o in outs[1:]:
            assert o.tobytes() == got.tobytes()
        np.testing.assert_array_equal(got[:, :3], want[:, :3])
        if ssim:
            pw = tmet.ssim_windows(T(src[0]), T(rec[0])).numpy()
            assert win.tobytes() == pw.tobytes(), (f, h, w)
            assert np.abs(got[:, 3] - want[:, 3]).max() <= 1e-6
        else:
            assert (got[:, 3] == 0).all()
        if kind == "identical":
            assert (got[:, :3] == 0).all() and (got[:, 3] == 1).all()
