"""The flat CTB16 all-intra slice of the port (the JAX package's `Param`
default, `ctu_size` 16, and its `--lossless` pipeline) against the JAX
package on the CPU:

- the port's `IntraFrameEncoder` (its plain scan, `_scan_plain`) against
  the JAX `IntraFrameEncoder._encode_frame` on the same frames at 64x48:
  modes, levels, recon and SSE exact, SSIM within 1e-6 (f32 means in
  another order); QP 0, 22 and 51, flat 0 and 255, random and smooth
  content, AQ offsets, deblocking with SAO, lossless;
- the two f32 steps XLA's CPU code contracts into FMAs in the scan's
  argmin fusion, pinned against jitted JAX formulas;
- the lossless decisions on random 64x48 content, counted;
- free-running streams of the port's `Encoder(..., device="cpu")` at
  96x64 byte-identical to the JAX `Encoder`'s (AQ 2 with SAO, CRF 28,
  lossless; 3 frames), decoded by the JAX decoder; lossless recon equal to
  the source;
- the gate: what the flat path runs admitted (CTU16 P/B frames too), CTU16
  with several references or RDOQ, and lossless at CTU32, refused.

One module fixture compiles the JAX encoders the file needs (lossy with
deblocking and SAO, lossless; AQ rides the same jits through the QP maps).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.intra_frame import IntraFrameEncoder as JaxFrame
from x265amod_tpu.ops.quant import derive_qp_maps as j_maps
from x265amod_tpu.utils import params as jparams
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.intra_frame import (IntraFrameEncoder,
                                                   scan_cost)
from x265amod_tpu_torch.ops.estbits import bit_consts_table, group_idx_bins
from x265amod_tpu_torch.utils import params as tparams
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

W, H = 64, 48


def _frame(kind, rng, w=W, h=H):
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "random":
        y = rng.integers(0, 256, (h, w))
        cb = rng.integers(0, 256, (h // 2, w // 2))
        cr = rng.integers(0, 256, (h // 2, w // 2))
    elif kind in ("flat0", "flat255"):
        v = 0 if kind == "flat0" else 255
        y = np.full((h, w), v)
        cb = cr = np.full((h // 2, w // 2), v)
    else:
        y = (xx * 3 + yy * 2 + rng.integers(0, 8, (h, w))) % 256
        cb, cr = y[::2, ::2] // 2, 255 - y[::2, ::2]
    return tuple(np.asarray(a, np.uint8) for a in (y, cb, cr))


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX flat encoders at 64x48: lossy with deblocking, SAO and sign
    hiding, and lossless (each compiles its recon jit once)."""
    return {False: JaxFrame(W, H, deblock=True, sao=True, sign_hide=True),
            True: JaxFrame(W, H, lossless=True, sign_hide=True)}


CASES = [("random", 0, False, False), ("random", 22, False, False),
         ("random", 51, False, False), ("flat0", 30, False, False),
         ("flat255", 30, False, False), ("smooth", 22, False, False),
         ("smooth", 27, True, False), ("random", 37, True, False),
         ("random", 22, False, True), ("smooth", 51, False, True),
         ("random", 30, True, True)]


@pytest.mark.parametrize("kind,qp,aq,lossless", CASES)
def test_frame_equals_the_jax_scan(jax_frames, kind, qp, aq, lossless):
    """One frame through the port's `IntraFrameEncoder` on the CPU (the
    plain scan, K21/K22's plain versions, SAO) and the JAX `_encode_frame`:
    modes, levels, recon planes and SSE equal, SSIM within 1e-6."""
    rng = np.random.default_rng(qp + 100 * aq + len(kind))
    y, cb, cr = _frame(kind, rng)
    off = rng.uniform(-6, 6, (H // 16, W // 16)) if aq else None
    jf = jax_frames[lossless]
    qp_map, qcb, qcr, lam = j_maps(qp, off, H // 16, W // 16)
    outs = jf._step_recon(jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr),
                          jnp.asarray(qp_map), jnp.asarray(qcb),
                          jnp.asarray(qcr), jnp.asarray(lam),
                          jnp.asarray(qp, jnp.int32))
    want = jf.collect(outs, want_recon=True)
    enc = IntraFrameEncoder(W, H, deblock=not lossless, sao=not lossless,
                            lossless=lossless, device="cpu")
    got = enc.collect(enc.encode_async(y, cb, cr, qp, want_recon=True,
                                       qp_offsets=off))
    for k in ("modes", "levels_y", "levels_cb", "levels_cr", "recon_y",
              "recon_cb", "recon_cr"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k),
                                      err_msg=k)
    np.testing.assert_array_equal(got.sse[:3], np.asarray(want.sse)[:3])
    assert abs(float(got.sse[3]) - float(want.sse[3])) <= 1e-6
    if not lossless:
        ref = (want.sao_type, want.sao_eo_class, want.sao_band_pos,
               want.sao_offsets) + tuple(want.sao_c)
        for g, w_ in zip(got.sao, ref):
            np.testing.assert_array_equal(np.asarray(g).reshape(-1),
                                          np.asarray(w_).reshape(-1))
    else:
        np.testing.assert_array_equal(got.recon_y, y)


def test_scan_costs_pin_xla_fma():
    """The scan's cost (JAX :211-213, ``ssd + lam * (rbits + mbits)``, one
    vfmadd231ss in XLA's argmin fusion) on crafted lanes where the FMA and
    the product rounded first differ: the port's `scan_cost` equals a jitted
    JAX function of JAX's formula bit for bit, and the rounded form differs
    on at least 10 lanes.  The fusion's other FMA, tu_bits' first step cbf1
    + (last-position bins) * last_bin, is exact on every QP row and
    position pair, so the rounded form K3 keeps is the same value there."""
    rng = np.random.default_rng(9)
    n = 20000
    lam = rng.uniform(0.5, 400.0, n).astype(np.float32)
    ssd = rng.integers(0, 1 << 20, (n, 35)).astype(np.int32)
    mb = rng.choice(np.float32([2.0, 3.0, 6.0]), (n, 35))
    rb = (rng.uniform(1.0, 900.0, (n, 35)) * 32768).round() / 32768
    rb = rb.astype(np.float32)

    @jax.jit
    def jax_cost(ssd, lam, rb, mb):
        return ssd.astype(jnp.float32) + lam[:, None] * (rb + mb)
    want = np.asarray(jax_cost(ssd, lam, rb, mb))
    got = scan_cost(torch.as_tensor(ssd), torch.as_tensor(lam),
                    torch.as_tensor(mb), torch.as_tensor(rb)).numpy()
    np.testing.assert_array_equal(got, want)
    rounded = ssd.astype(np.float32) + lam[:, None] * (rb + mb)
    assert (rounded != want).sum() >= 10

    tab = bit_consts_table("I", 0)
    lp = group_idx_bins(32)
    q, lx, ly = (a.reshape(-1) for a in np.meshgrid(
        np.arange(52), np.arange(16), np.arange(16), indexing="ij"))
    s = (lp[lx] + lp[ly]).astype(np.float32)

    @jax.jit
    def jax_first(r1, s, r11):
        return r1 + s * r11
    first = np.asarray(jax_first(tab[q, 1], s, tab[q, 11]))
    np.testing.assert_array_equal(first, tab[q, 1] + s * tab[q, 11])
    fused = (tab[q, 1].astype(np.float64)
             + s.astype(np.float64) * tab[q, 11]).astype(np.float32)
    np.testing.assert_array_equal(first, fused)


def test_lossless_decisions_agree(jax_frames, capsys):
    """Under lossless the RD cost is lam * (rbits + mbits) of the densest TUs
    the encoder prices (levels up to 255 everywhere): the port's modes
    against the JAX scan's on 12 random frames at random QPs, counted
    (printed) and required to agree everywhere."""
    jf = jax_frames[True]
    enc = IntraFrameEncoder(W, H, deblock=False, lossless=True, device="cpu")
    same = total = 0
    for s in range(12):
        rng = np.random.default_rng(300 + s)
        y, cb, cr = _frame("random", rng)
        qp = int(rng.integers(0, 52))
        want = jf.collect(jf._step_recon(
            *(jnp.asarray(a) for a in (y, cb, cr)),
            *(jnp.asarray(a) for a in j_maps(qp, None, H // 16, W // 16)),
            jnp.asarray(qp, jnp.int32)), want_recon=True)
        got = enc.collect(enc.encode_async(y, cb, cr, qp))
        same += int((got.modes == want.modes).sum())
        total += got.modes.size
    with capsys.disabled():
        print(f"\nlossless mode decisions equal to JAX's: {same}/{total}")
    assert same == total


def _clip(rng, n=3, w=96, h=64):
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for k in range(n):
        y = (xx * 2 + yy + 7 * k) % 256 + rng.integers(0, 24, (h, w))
        out.append((np.clip(y, 0, 255).astype(np.uint8),
                    rng.integers(90, 160, (h // 2, w // 2)).astype(np.uint8),
                    rng.integers(80, 170, (h // 2, w // 2)).astype(np.uint8)))
    return out


@pytest.mark.parametrize("kw", [dict(aq_mode=2, sao=True),
                                dict(rc_mode="crf", crf=28.0),
                                dict(lossless=True)],
                         ids=["aq2_sao", "crf28", "lossless"])
def test_stream_equals_the_jax_encoders(kw):
    """`Encoder(Param(width, height, keyint=1, ...), device="cpu")` at its
    CTU16 default, 3 frames through `encode_pipelined`: the stream equals
    the JAX `Encoder`'s byte for byte and decodes (JAX decoder) to the
    port's recon; lossless recon equals the source."""
    frames = _clip(np.random.default_rng(5))
    d = dict(width=96, height=64, keyint=1, info=False, **kw)
    jout = list(JaxEncoder(jparams.Param(**d)).encode_pipelined(frames))
    enc = Encoder(tparams.Param(**d), device="cpu")
    assert enc.ctu == 16 and enc.sps.log2_ctb_size == 4
    tout = list(enc.encode_pipelined(frames, return_recon=True))
    stream = b"".join(o.nals for o in tout)
    assert stream == b"".join(o.nals for o in jout)
    dec = decode_stream(stream)
    assert len(dec) == len(frames)
    for dfr, o, src in zip(dec, tout, frames):
        for plane, rec in zip((dfr.y, dfr.cb, dfr.cr), o.recon):
            np.testing.assert_array_equal(np.asarray(plane), rec)
        if kw.get("lossless"):
            for rec, s in zip(o.recon, src):
                np.testing.assert_array_equal(rec, s)


@pytest.mark.parametrize("kw,admitted", [
    (dict(keyint=1), True),
    (dict(keyint=1, sao=True, aq_mode=1), True),
    (dict(keyint=1, rc_mode="abr", bitrate=800), True),
    (dict(keyint=1, lossless=True), True),
    (dict(keyint=250), True),
    (dict(keyint=250, ref=3), False),
    (dict(keyint=250, rdoq_level=1), False),
    (dict(keyint=1, rdoq_level=1), False),
    (dict(keyint=1, lossless=True, ctu_size=32), False),
    (dict(keyint=1, internal_bit_depth=10, deblock=False), False),
    (dict(keyint=1, wpp=True), False),
])
def test_the_gate(kw, admitted):
    """The port admits the settings the flat CTB16 path runs, which the
    JAX gate admits too: all-intra, lossless, and since the flat P and B
    frames are ported, CTU16 with P/B frames (keyint 250); as the JAX gate
    does, it refuses several references, RDOQ and Main10 at CTU16, and
    lossless at CTU32."""
    d = dict(width=96, height=64, **kw)
    p = tparams.Param(**d)
    assert p.ctu_size == (kw.get("ctu_size") or 16)
    if admitted:
        tparams.check_params(p)
        jparams.check_params(jparams.Param(**d))
    else:
        with pytest.raises(ValueError, match="not wired"):
            tparams.check_params(p)
