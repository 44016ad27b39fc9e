"""The flat CTB16 P and B frames of the port (the JAX package's default
`Param(width, height)` and `--preset medium` without `--ctu`) against the
JAX package on the CPU:

- (a) one P frame and one B frame at 96x64 through the port's
  `InterFrameEncoder` / `BFrameEncoder` on `device="cpu"` (K24's and K25's
  plain versions, K23's plain commit, K21's flat P/B maps) and through the
  JAX `_encode` of the module's own JAX encoders: kinds, merge indices,
  directions, MVDs, MVP indices, levels and recon exact, SSE exact, SSIM
  within 1e-6 (f32 means in another order), modes exact where kind == 2;
- (b) the JAX decisions replayed through `encode_async_load`: levels,
  recon and the slice payload byte-identical;
- (c) free-running streams of the port's `Encoder(..., device="cpu")`
  byte-identical to the JAX `Encoder`'s and decoded by the JAX decoder:
  `Param(width=96, height=64)` (an IDR and 7 flat P frames) and preset
  medium at 96x64 with CRF 28 and lookahead 4 (bframes 4, SAO, AQ 2,
  CU-tree; 10 frames);
- (d) the f32 costs XLA's CPU code contracts into FMAs (the object code of
  both decide fusions has a vfmadd for each cost; the intra trial's
  multiply-add fusion forms fma(lam, rb + 6, ssd)), pinned on crafted
  lanes against jitted JAX formulas;
- (e) the flat encoders raise without a card unless given `device="cpu"`;
  lossless with P frames is refused by the port's gate (the JAX `Encoder`
  asserts on it).

One module fixture builds the two JAX `Encoder`s and codes their streams;
the frame-level checks reuse those encoders' own compiled P and B encoders,
so the file compiles no JAX encoder of its own.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.utils import params as jparams
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models.b_frame import BFrameEncoder
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.inter_frame import (InterFrameEncoder,
                                                   intra_trial_cost)
from x265amod_tpu_torch.models.mvpred import dist_scale_factor
from x265amod_tpu_torch.ops import decide_flat as dfl
from x265amod_tpu_torch.ops.estbits import intra_hdr_bits
from x265amod_tpu_torch.utils import params as tparams
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

W, H = 96, 64


def _params(mod, preset):
    """Param(96, 64) (the JAX default: CTU16, keyint 250, bframes 0), or
    preset medium at 96x64 with CRF 28 and lookahead 4."""
    if not preset:
        return mod.Param(width=W, height=H, info=False)
    p = mod.param_default_preset("medium")
    p.width, p.height, p.info = W, H, False
    p.rc_mode, p.crf, p.rc_lookahead = "crf", 28.0, 4
    return p


def _frames(n):
    """bench.py's clip at 96x64 with a flat patch that intra codes best."""
    out = []
    for t, (y, cb, cr) in enumerate(clip(W, H, n, seed=3)):
        y = y.copy()
        y[16:32, 48:80] = 30 + 25 * t
        out.append((y, cb, cr))
    return out


@pytest.fixture(scope="module")
def jax_runs():
    """The two JAX encoders and their streams: default Param, 8 frames
    (I + 7 P); preset medium, 10 frames (I, P, 4 B, P, 3 B)."""
    frames = _frames(10)
    runs = {}
    for preset, n in ((False, 8), (True, 10)):
        enc = JaxEncoder(_params(jparams, preset))
        stream = b"".join(o.nals for o in enc.encode_pipelined(frames[:n]))
        runs[preset] = dict(enc=enc, stream=stream, frames=frames[:n])
    return runs


def _ref(rng):
    """Reference planes (uint8) made from a seed: a frame of the clip moved
    by a few pixels, with noise."""
    y, cb, cr = _frames(1)[0]
    sh = int(rng.integers(1, 4))
    return tuple(np.clip(np.roll(p, sh, 1).astype(np.int32)
                         + rng.integers(-4, 5, p.shape), 0, 255)
                 .astype(np.uint8) for p in (y, cb, cr))


def _j(planes):
    return tuple(jnp.asarray(p) for p in planes)


def _t(planes):
    return tuple(torch.as_tensor(np.ascontiguousarray(p)) for p in planes)


P_KEYS = ("kinds", "merge_idx", "mvd", "mvp_idx")
B_KEYS = ("kinds", "merge_idx", "inter_dir", "mvd0", "mvp0", "mvd1", "mvp1")
LEVELS = ("levels_y", "levels_cb", "levels_cr", "recon_y", "recon_cb",
          "recon_cr")


def _same(got, want, keys):
    for k in keys + LEVELS:
        np.testing.assert_array_equal(np.asarray(getattr(got, k)),
                                      np.asarray(getattr(want, k)),
                                      err_msg=k)
    intra = np.asarray(want.kinds) == 2
    np.testing.assert_array_equal(got.modes[intra],
                                  np.asarray(want.modes)[intra])
    assert (got.modes[~intra] == 1).all()
    np.testing.assert_array_equal(got.sse[:3], np.asarray(want.sse)[:3])
    assert abs(float(got.sse[3]) - float(want.sse[3])) <= 1e-6


def _jax_p(jenc, y, ref, qp, off):
    outs = jenc.encode_async(*_j(y), _j(ref), qp, qp_offsets=off)
    return jenc.collect(outs, want_recon=True)


def _jax_b(jenc, y, refs, qp, dsf, off):
    outs = jenc.encode_async(*_j(y), _j(refs[0]), _j(refs[1]), qp, *dsf,
                             qp_offsets=off)
    return jenc.collect(outs, want_recon=True)


def _port(cls, jenc):
    return cls(W, H, deblock=jenc.deblock, sao=jenc.sao,
               search_range=jenc.sr, subme=jenc.subme, sign_hide=jenc.sbh,
               device="cpu")


@pytest.mark.parametrize("preset,qp,aq", [(False, 22, False),
                                          (False, 30, True),
                                          (False, 51, False),
                                          (True, 32, True)])
def test_p_frame_equals_jax(jax_runs, preset, qp, aq):
    """(a) and (b) for a P frame: free, then under JAX's decisions."""
    rng = np.random.default_rng(qp + 7 * aq + preset)
    jenc = jax_runs[preset]["enc"].inter_encoder
    y = _frames(3)[2]
    ref = _ref(rng)
    off = rng.uniform(-6, 6, (H // 16, W // 16)) if aq else None
    want = _jax_p(jenc, y, ref, qp, off)
    enc = _port(InterFrameEncoder, jenc)
    got = enc.collect(enc.encode_async(*y, _t(ref), qp, want_recon=True,
                                       qp_offsets=off))
    _same(got, want, P_KEYS)
    forced = enc.collect(enc.encode_async_load(
        *y, _t(ref), qp, want.kinds, want.merge_idx, want.mvd, want.mvp_idx,
        want_recon=True, qp_offsets=off))
    _same(forced, want, P_KEYS)
    tenc = Encoder(_params(tparams, preset), device="cpu")
    assert tenc._cabac_inter(forced, qp)[0] == \
        jax_runs[preset]["enc"]._cabac_inter(want, qp)[0]


@pytest.mark.parametrize("qp,aq,pocs", [(32, True, (2, 0, 4)),
                                        (27, False, (1, 0, 4)),
                                        (40, True, (3, 2, 4))])
def test_b_frame_equals_jax(jax_runs, qp, aq, pocs):
    """(a) and (b) for a B frame of the preset-medium encoder (SAO, sign
    hiding), at three distance scale factor pairs."""
    rng = np.random.default_rng(100 + qp)
    jenc = jax_runs[True]["enc"].b_encoder
    y = _frames(3)[1]
    refs = (_ref(rng), _ref(rng))
    poc, p0, p1 = pocs
    dsf = (dist_scale_factor(poc, p0, p1), dist_scale_factor(poc, p1, p0))
    off = rng.uniform(-6, 6, (H // 16, W // 16)) if aq else None
    want = _jax_b(jenc, y, refs, qp, dsf, off)
    enc = _port(BFrameEncoder, jenc)
    got = enc.collect(enc.encode_async(*y, _t(refs[0]), _t(refs[1]), qp,
                                       *dsf, want_recon=True, qp_offsets=off))
    _same(got, want, B_KEYS)
    assert len(set(np.asarray(want.kinds).ravel().tolist())) >= 2
    forced = enc.collect(enc.encode_async_load(
        *y, _t(refs[0]), _t(refs[1]), qp, *dsf, want.kinds, want.merge_idx,
        want.inter_dir, want.mvd0, want.mvp0, want.mvd1, want.mvp1,
        want_recon=True, qp_offsets=off))
    _same(forced, want, B_KEYS)
    tenc = Encoder(_params(tparams, True), device="cpu")
    assert tenc._cabac_b(forced, qp)[0] == \
        jax_runs[True]["enc"]._cabac_b(want, qp)[0]


@pytest.mark.parametrize("preset", [False, True], ids=["default", "medium"])
def test_stream_equals_the_jax_encoder(jax_runs, preset):
    """(c) The port's `Encoder(..., device="cpu")` through
    `encode_pipelined`: the stream equals the JAX `Encoder`'s byte for byte
    and decodes (JAX decoder) to the port's recon."""
    run = jax_runs[preset]
    enc = Encoder(_params(tparams, preset), device="cpu")
    assert enc.ctu == 16 and enc.sps.log2_ctb_size == 4
    outs = list(enc.encode_pipelined(run["frames"], return_recon=True))
    stream = b"".join(o.nals for o in outs)
    assert stream == run["stream"]
    types = [o.stats.slice_type for o in outs]
    assert types[0] == "I" and "P" in types and ("B" in types) == preset
    dec = decode_stream(stream)
    assert len(dec) == len(outs)
    by_display = sorted(outs, key=lambda o: o.stats.display_order)
    for dfr, o in zip(dec, by_display):
        assert dfr.poc == o.stats.poc
        for plane, rec in zip((dfr.y, dfr.cb, dfr.cr), o.recon):
            np.testing.assert_array_equal(np.asarray(plane), rec)


# ---- (d) the FMAs ------------------------------------------------------------

def _differ(fused, lam, x, c):
    """Lanes where fma(lam, x, c) and c + round(lam * x) differ."""
    return int(np.sum(fused != c + lam * x))


def _zero_motion_inputs(rng, n, bidir):
    """Lanes whose candidates all carry zero MVs (zero ME MVs): every merge
    candidate reads the grid at the zero MV, every MVD costs 2 bins, so the
    cost rows are closed-form functions of the inputs.  The grids are
    constant per CTU (and equal across lists)."""
    sr = 4
    s = 2 * sr + 1
    lam = rng.uniform(1, 400, n).astype(np.float32)
    # costs of a few thousand, where a product rounded first often moves
    # the sum by an ulp
    g = rng.uniform(10, 5000, n).astype(np.float32)
    g[::2] = rng.uniform(1e4, 2e4, n)[::2]
    grid = np.broadcast_to(g[:, None, None], (n, s, s)).copy()
    k = 3 if bidir else 1
    rb = rng.uniform(0, 300, (n, k)).astype(np.float32)
    rb[::2, 0] = rng.uniform(0, 10, n)[::2]
    d = rng.uniform(10, 5000, (n, k)).astype(np.float32)
    # near ties between skip 0 and the first AMVP cost: d within a few
    # ulps of g + 2 lam - lam (rb + 2 + 6 or 8)
    extra = np.float32(8.0 if bidir else 6.0)
    x0 = (rb[:, 0] + np.float32(2.0)) + extra
    tie = (g.astype(np.float64) + 2.0 * lam - lam.astype(np.float64) * x0)
    d[::2, 0] = (tie[::2] * (1 + rng.integers(-3, 4, n)[::2] * 2.0 ** -23)) \
        .astype(np.float32)
    di = rng.uniform(10, 5000, n).astype(np.float32)
    di[::2] = 1e6                       # the tie lanes: intra loses
    return sr, lam, g, grid, d, rb, di


@pytest.mark.parametrize("bidir", [False, True], ids=["P", "B"])
def test_decide_costs_pin_xla_fma(bidir):
    """The decide scans' costs (P :288-292, B :345-350) on a 32x16 CTB16
    frame of crafted lanes: the plain scans' cost rows equal, bit for bit,
    a jitted JAX function of JAX's formulas (XLA's CPU code fuses each
    product with the add after it), the costs with the product rounded
    first differ on at least 10 lanes of each fused cost but skip 0 (lam *
    2 is exact), and the choices are the first minimum of JAX's rows on
    lanes tuned to near-ties."""
    rng = np.random.default_rng(11 + bidir)
    wc, hc = 32, 16
    n = wc * hc
    sch = dfl.Schedule(wc, hc, "cpu")
    sr, lam, g, grid, d, rb, di = _zero_motion_inputs(rng, n, bidir)
    T = torch.as_tensor
    zero = T(np.zeros((n, 2), np.int32))
    st = "B" if bidir else "P"
    hdr = float(np.float32(intra_hdr_bits(st)))
    if bidir:
        out = dfl.decide_b_plain(sch, (T(grid), T(grid)), T(d), T(rb),
                                 T(di), (zero, zero), T(lam), sr, (-256, 256),
                                 hdr, want_costs=True)
    else:
        out = dfl.decide_p_plain(sch, T(grid), T(d[:, 0]), T(rb[:, 0]),
                                 T(di), zero, T(lam), sr, hdr,
                                 want_costs=True)
    js = out["js"].numpy()
    two = np.full(n, 2.0, np.float32)

    @jax.jit
    def jax_costs(g, lamv, d, rb, b0, b1, di):
        rows = [g + lamv * 2.0, g + lamv * 3.0]
        if bidir:
            rows += [d[:, 0] + lamv * (rb[:, 0] + b0 + 8.0),
                     d[:, 1] + lamv * (rb[:, 1] + b1 + 8.0),
                     d[:, 2] + lamv * (rb[:, 2] + b0 + b1 + 10.0)]
        else:
            rows += [d[:, 0] + lamv * (rb[:, 0] + jnp.minimum(b0, b1)
                                       + 6.0)]
        return jnp.stack(rows + [di + lamv * jnp.float32(hdr)], 1)
    want = np.asarray(jax_costs(g, lam, d, rb, two, two, di))
    np.testing.assert_array_equal(js, want)
    np.testing.assert_array_equal(out["choice"].numpy(), np.argmin(want, 1))
    assert _differ(want[:, 1], lam, np.float32(3.0), g) >= 10
    x0 = (rb[:, 0] + np.float32(2.0)) + np.float32(8.0 if bidir else 6.0)
    assert _differ(want[:, 2], lam, x0, d[:, 0]) >= 10
    assert _differ(want[:, -1], lam, np.float32(hdr), di) >= 10
    if bidir:
        xb = ((rb[:, 2] + np.float32(2.0)) + np.float32(2.0)) \
            + np.float32(10.0)
        assert _differ(want[:, 4], lam, xb, d[:, 2]) >= 10
    # the near ties split both ways
    assert 0 < int(np.sum(out["choice"].numpy()[::2] == 0)) < n // 2


def test_intra_trial_cost_pins_xla_fma():
    """The intra trial's estimate (JAX :212-216, min over the 35 modes of
    ``ssd + lam * (rb + 6)``) on crafted modes whose costs lie a few ulps
    apart: `intra_trial_cost` equals a jitted JAX function of JAX's formula
    bit for bit, and the product rounded first gives another minimum on at
    least 10 lanes."""
    rng = np.random.default_rng(13)
    n = 512
    lam = rng.uniform(1, 400, n).astype(np.float32)
    rb = rng.uniform(0, 400, (n, 35)).astype(np.float32)
    ssd = rng.integers(1000, 200000, (n, 35)).astype(np.int32)
    x = rb + np.float32(6.0)
    # mode 7 within an ulp or two of mode 3 after the fused add
    c3 = ssd[:, 3].astype(np.float64) + lam.astype(np.float64) * x[:, 3]
    ssd[:, 7] = np.round(c3 - lam.astype(np.float64) * x[:, 7]).astype(
        np.int32)
    got = intra_trial_cost(torch.as_tensor(ssd), torch.as_tensor(rb),
                           torch.as_tensor(lam)).numpy()

    @jax.jit
    def jax_min(ssd, rb, lamv):
        return jnp.min(ssd.astype(jnp.float32) + lamv[:, None] * (rb + 6.0),
                       axis=1)
    want = np.asarray(jax_min(ssd, rb, lam))
    np.testing.assert_array_equal(got, want)
    rounded = (ssd.astype(np.float32) + lam[:, None] * x).min(1)
    assert int(np.sum(rounded != want)) >= 10


# ---- (e) the device and the gate -----------------------------------------------

@pytest.mark.parametrize("cls", [InterFrameEncoder, BFrameEncoder])
def test_flat_encoders_need_a_card_or_the_cpu(cls):
    """Without a card the flat encoders raise unless given device='cpu';
    so does the port's `Encoder` with the JAX defaults."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cls(W, H)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(tparams.Param(width=W, height=H))
    assert cls(W, H, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("kw", [dict(ref=3), dict(rdoq_level=1)],
                         ids=["ref3", "rdoq"])
def test_both_gates_refuse_at_ctu16(kw):
    """CTU16 with P frames and several references, or with RDOQ: the
    JAX gate and the port's gate both refuse it."""
    d = dict(width=W, height=H, keyint=250, **kw)
    for mod in (tparams, jparams):
        with pytest.raises(ValueError, match="not wired"):
            mod.check_params(mod.Param(**d))


def test_lossless_needs_keyint_1():
    """Lossless with P frames (keyint 250): the port's gate refuses it; the
    JAX gate admits it and the JAX `Encoder` then asserts (lossless is
    wired for all-intra)."""
    d = dict(width=W, height=H, lossless=True, keyint=250)
    with pytest.raises(ValueError, match="not wired"):
        tparams.check_params(tparams.Param(**d))
    jparams.check_params(jparams.Param(**d))
    with pytest.raises(AssertionError):
        JaxEncoder(jparams.Param(**d))
