"""Main10 (10-bit) all-intra in the PyTorch port against the JAX package on
the CPU:

- kernel K1's plain versions at bit depth 10 (substitution with its
  mid-grey fill of 512, all 35 predictions, single-mode predictions, the
  8x8 Hadamard SATD) against JAX's `substitute_refs_general`,
  `predict_all_modes_batch`, `predict_modes_batch` and `_satd_modes` at
  `bit_depth=10`, with flat 0 and 1023 references;
- kernel K2's plain chain at bit depth 10 (its shifts and clip) against the
  JAX chain at `bit_depth=10`, at QP 0 and 51, on flat 0 / 1023 blocks;
- kernel K3 on the bit-depth-10 chain's levels (up to 4x the 8-bit ones):
  its integer Golomb-Rice forms still equal the JAX f32 forms;
- a free-running 96x64 Main10 stream (QP 30, CTU32, no loop filters, 3
  frames) equal to the JAX `Encoder`'s, decoded bit-exactly, with uint16
  recon above 255, profile 2 and bit depth 10 in the SPS and PSNR at the
  10-bit peak;
- the slice gate: Main10 under the reference's gate, RDOQ levels 1-2, and
  the refusal of Main10 with RDOQ.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.bitstream.nal import split_annexb
from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.intra_tree import _satd_modes
from x265amod_tpu.ops import estbits as jeb
from x265amod_tpu.ops import intra as jintra
from x265amod_tpu.ops.quant import dequant as j_deq
from x265amod_tpu.ops.quant import quant as j_quant
from x265amod_tpu.ops.sbh import sbh_adjust as j_sbh
from x265amod_tpu.ops.transforms import fwd_transform as j_fwd
from x265amod_tpu.ops.transforms import inv_transform as j_inv
from x265amod_tpu.utils.params import Param as JaxParam
from x265amod_tpu.verify.decoder import decode_stream, parse_sps
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.ops import estbits as teb
from x265amod_tpu_torch.ops import intra as tintra
from x265amod_tpu_torch.ops.residual import residual_chain
from x265amod_tpu_torch.utils.params import Param, check_params
from test_torch_slice import config1, yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

MAX10 = 1023
# the JAX tu_bits under jit, as the JAX trees run it: one compile a shape
# for the file instead of one for each of its eager operations
_j_tu_bits = jax.jit(jeb.tu_bits, static_argnames=("c_idx", "slice_type",
                                                   "sbh"))
_j_satd = jax.jit(_satd_modes)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def frames10(w, h, n, seed=7):
    """The 10-bit clip of the JAX package's Main10 test (a copy)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for t in range(n):
        y = (512 + 320 * np.sin((xx + 3 * t) / 11.0)
             * np.cos((yy - 2 * t) / 7.0)
             + rng.normal(0, 12, (h, w))).clip(0, 1023).astype(np.uint16)
        cb = (512 + 120 * np.sin((xx[::2, ::2] + t) / 19.0)) \
            .clip(0, 1023).astype(np.uint16)
        cr = (512 - 120 * np.cos((yy[::2, ::2] + t) / 23.0)) \
            .clip(0, 1023).astype(np.uint16)
        out.append((y, cb, cr))
    return out


def main10(w, h, **kw):
    d = dict(width=w, height=h, qp=30, keyint=1, ctu_size=32,
             internal_bit_depth=10, deblock=False, sao=False, info=False)
    d.update(kw)
    return d


# ---- K1 and K2 at bit depth 10 --------------------------------------------------


@pytest.mark.parametrize("n,c_idx", [(8, 0), (16, 0), (32, 0), (8, 1),
                                     (16, 1)])
def test_intra_pred_at_bit_depth_10_matches_jax(n, c_idx):
    rng = np.random.default_rng(20 * n + c_idx)
    b = 8
    top = rng.integers(0, MAX10 + 1, (b, 2 * n)).astype(np.int32)
    left = rng.integers(0, MAX10 + 1, (b, 2 * n)).astype(np.int32)
    cor = rng.integers(0, MAX10 + 1, b).astype(np.int32)
    at = rng.random((b, 2 * n)) < 0.8
    al = rng.random((b, 2 * n)) < 0.8
    ac = rng.random(b) < 0.7
    at[0], al[0], ac[0] = False, False, False       # no refs: fill 512
    at[1, n:], al[1, n:] = False, False
    top[2], left[2], cor[2] = 0, 0, 0
    top[3], left[3], cor[3] = MAX10, MAX10, MAX10
    top[4, :], cor[4] = MAX10, 0                      # steep edges: clip
    left[4, :] = 0
    refs = (top, left, cor, at, al, ac)
    jt, jl, jc = (np.asarray(a) for a in jintra.substitute_refs_general(
        *refs, n, bit_depth=10))
    tt, tl, tc = (a.numpy() for a in tintra.substitute_refs_general(
        *map(T, refs), n, 10))
    np.testing.assert_array_equal(tt, jt)
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tc, jc)
    assert (jt[0] == 512).all()
    jp = np.asarray(jintra.predict_all_modes_batch(jt, jl, jc, n, c_idx, 10))
    np.testing.assert_array_equal(tintra._predict_all_plain(
        T(jt), T(jl), T(jc), n, c_idx, 10).numpy(), jp)
    assert jp.max() > 255
    orig = rng.integers(0, MAX10 + 1, (b, n, n)).astype(np.int32)
    orig[2], orig[3] = 0, MAX10
    np.testing.assert_array_equal(
        tintra.satd35(T(orig), *map(T, refs), n, c_idx,
                      bit_depth=10).numpy(),
        np.asarray(_j_satd(jnp.asarray(orig), jnp.asarray(jp))))
    modes = rng.integers(0, 35, (b, 3)).astype(np.int32)
    modes[:, 1], modes[:, 2] = 10, 26
    got = tintra.predict(*map(T, refs), T(modes), n, c_idx,
                         bit_depth=10).numpy()
    for k in range(3):
        np.testing.assert_array_equal(got[:, k], np.asarray(
            jintra.predict_modes_batch(jt, jl, jc, modes[:, k], n, c_idx,
                                       10)))


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("qp", [0, 30, 51])
def test_residual_chain_at_bit_depth_10_matches_jax(n, qp):
    """K2's plain chain at bit depth 10 (forward shift log2n + 1, quant
    qbits 14 + qp/6 + 5 - log2n, dequant shift 5 + log2n, inverse shift 10,
    clip 1023) against the JAX chain; then K3 on its levels."""
    rng = np.random.default_rng(7 * n + qp)
    b, k = 6, 2
    orig = rng.integers(0, MAX10 + 1, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-160, 161, (b, k, n, n)), 0,
                   MAX10).astype(np.int32)
    orig[0], pred[0] = 0, MAX10
    orig[1], pred[1] = MAX10, MAX10
    pred[2, 0] = 0
    qpv = np.full(b, qp, np.int32)
    co = j_fwd(jnp.asarray(orig[:, None] - pred), bit_depth=10)
    q4 = jnp.asarray(qpv)[:, None, None, None]
    jl = j_sbh(j_quant(co, q4, bit_depth=10))
    jr = np.clip(pred + np.asarray(j_inv(j_deq(jl, q4, bit_depth=10),
                                         bit_depth=10)), 0, MAX10)
    lv, rec, ssd = residual_chain(T(orig), T(pred), T(qpv), True,
                                  bit_depth=10)
    np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(rec.numpy(), jr)
    np.testing.assert_array_equal(ssd.numpy(),
                                  ((jr - orig[:, None]) ** 2).sum((2, 3)))
    # K3 on the 10-bit levels: exact where JAX's f32 sums are (below 512
    # bits), within rtol 1e-5 on dense TUs (tests/test_torch_ops.py)
    lvn = lv.numpy()
    jb = np.asarray(_j_tu_bits(jnp.asarray(lvn.astype(np.int32)), c_idx=0,
                               slice_type="I", qp=jnp.asarray(qpv)[:, None]))
    tb = teb.tu_bits(T(lvn), 0, T(qpv)[:, None]).numpy()
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=0)
    small = jb < 512
    np.testing.assert_array_equal(tb[small], jb[small])


def test_tu_bits_golomb_forms_hold_for_10_bit_levels():
    """Levels at bit depth 10 reach 4x the 8-bit ones, but quant clips
    every level to 16 bits at any bit depth, so K3's domain is unchanged:
    its integer Golomb-Rice forms equal the JAX f32 forms at every group
    sum and remainder a group can hold
    (`test_torch_ops.py::test_tu_bits_integer_log2_matches_f32_form`).
    Here: 10-bit levels of a flat 0 / 1023 step at QP 0, the largest the
    chain makes, priced by both."""
    n = 32
    orig = np.zeros((2, n, n), np.int32)
    orig[1, :, : n // 2] = MAX10
    pred = np.full((2, 1, n, n), MAX10, np.int32)
    pred[1] = 0
    lv, _, _ = residual_chain(T(orig), T(pred), T(np.zeros(2, np.int32)),
                              False, bit_depth=10)
    lv8, _, _ = residual_chain(T(orig >> 2), T(pred >> 2),
                               T(np.zeros(2, np.int32)), False)
    assert np.abs(lv.numpy()).max() > 3 * np.abs(lv8.numpy()).max()
    jb = np.asarray(_j_tu_bits(jnp.asarray(lv.numpy().astype(np.int32)),
                               c_idx=0, slice_type="I",
                               qp=jnp.zeros((2, 1), jnp.int32)))
    tb = teb.tu_bits(lv, 0, torch.zeros((2, 1), dtype=torch.int32)).numpy()
    np.testing.assert_array_equal(tb, jb)


# ---- free running ------------------------------------------------------------------


def test_main10_stream_equals_jax_and_decodes():
    w, h, nf = 96, 64, 3
    frames = frames10(w, h, nf)
    jenc = JaxEncoder(JaxParam(**main10(w, h)))
    jouts = [jenc.encode_frame(*f) for f in frames]
    tenc = Encoder(Param(**main10(w, h)), device="cpu")
    touts = [tenc.encode_frame(*f, return_recon=True) for f in frames]
    assert [o.nals for o in touts] == [o.nals for o in jouts]
    # the batched path codes the same stream
    tb = Encoder(Param(**main10(w, h)), device="cpu")
    tb.BATCH_FRAMES = 2
    assert [o.nals for o in tb.encode_pipelined(frames)] == \
        [o.nals for o in jouts]
    for a, b in zip(touts, jouts):
        assert a.stats.psnr_y == pytest.approx(b.stats.psnr_y, abs=1e-6)
        assert a.stats.psnr_y > 40.0 and a.stats.ssim_y == 0.0
    dec = decode_stream(b"".join(o.nals for o in touts))
    assert len(dec) == nf
    for d, o in zip(dec, touts):
        assert o.recon[0].dtype == np.uint16
        np.testing.assert_array_equal(np.asarray(d.y)[:h, :w], o.recon[0])
        np.testing.assert_array_equal(np.asarray(d.cb)[:h // 2, :w // 2],
                                      o.recon[1])
        np.testing.assert_array_equal(np.asarray(d.cr)[:h // 2, :w // 2],
                                      o.recon[2])
    assert max(int(o.recon[0].max()) for o in touts) > 255
    assert tenc.sps.profile_idc == 2 and tenc.sps.bit_depth == 10
    sps = [parse_sps(rbsp) for t, _, rbsp in split_annexb(tenc.headers())
           if t == 33]
    assert len(sps) == 1 and sps[0].bit_depth == 10


# ---- the slice gate ------------------------------------------------------------------


def test_check_params_admits_main10_all_intra_and_rdoq():
    check_params(Param(**main10(1920, 1080)))
    for level in (1, 2):
        p = config1(64, 64)
        p.rdoq_level = level
        check_params(p)
        check_params(Param(width=1920, height=1080, keyint=60, bframes=3,
                           ctu_size=32, sao=True, aq_mode=2, cutree=True,
                           rc_lookahead=4, rdoq_level=level))


@pytest.mark.parametrize("kw", [dict(deblock=True), dict(sao=True),
                                dict(keyint=250), dict(ctu_size=16),
                                dict(internal_bit_depth=12)])
def test_check_params_refuses_main10_outside_the_reference_gate(kw):
    with pytest.raises(ValueError, match="not wired in this port"):
        check_params(Param(**main10(64, 64, **kw)))


@pytest.mark.parametrize("level", [1, 2])
def test_check_params_refuses_main10_with_rdoq(level):
    """The reference's RDOQ prices at bit depth 8 whatever the input
    (JAX ops/rdoq.py:106,110); under Main10 its PSNR collapses, so the
    port refuses the pair, naming why."""
    with pytest.raises(ValueError, match="RDOQ is 8-bit only"):
        check_params(Param(**main10(64, 64, rdoq_level=level)))


def test_main10_encoder_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(Param(**main10(64, 64)))
    enc = Encoder(Param(**main10(64, 64)), device="cpu")
    assert enc.frame_encoder.bd == 10 and not enc.frame_encoder.rdoq
    jp = dataclasses.asdict(JaxParam(**main10(64, 64)))
    assert dataclasses.asdict(Param(**main10(64, 64))) == jp
