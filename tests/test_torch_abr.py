"""The ABR ladder of the port against the JAX package on the CPU:

- `resample_plane_plain` (row 22, kernel K16) against the JAX
  `resample_plane`, on the unrounded f32 values and on the uint8 output:
  bicubic and bilinear, down and up, luma and chroma sizes, constant and
  full-range planes.  The port sums each pass as one FMA chain over the taps
  in increasing source index.  XLA's CPU matrix product sums in that order
  at some shapes (every exact 2:1 downscale here, the ladder's included,
  gives equal values) and in others at others (two interleaved chains,
  lanes of its GEMM kernel, chosen by the shapes), so elsewhere an unrounded
  value may differ by the order's rounding (held within 8 ulps of a sample
  at 256), and a uint8 sample only where JAX's value lies that close to a
  .5 boundary.  The counts are printed and recorded in
  ROADMAP queue 3;
- the port's `abr.main([..., "--device", "cpu"])` against the JAX
  `abr.main` on a 96x64 y4m with two rungs (96x64 and 48x32, ctu 32, no B
  frames, preset ultrafast, ABR): the streams are byte-identical and decode
  to the rung's size.
"""

import os

import numpy as np
import pytest
import torch

from x265amod_tpu import abr as jabr
from x265amod_tpu.ops import scaler as jsc
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch import abr as tabr
from x265amod_tpu_torch.io.y4m import Y4mHeader, Y4mReader, Y4mWriter
from x265amod_tpu_torch.ops import scaler as tsc
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

# 8 ulps of an f32 sample at 256: the spread two summation orders of at
# most 13 taps leave (2 ulps measured)
ORDER_TOL = 8 * 2.0 ** -15


def plane(kind, h, w, seed):
    rng = np.random.default_rng(seed)
    if kind == "constant":
        return np.full((h, w), 77 + seed % 100, np.uint8)
    if kind == "full":
        return rng.integers(0, 256, (h, w)).astype(np.uint8)
    p = rng.integers(0, 256, (h, w)).astype(np.uint8)   # 0/255 extremes
    p[::3] = 0
    p[:, ::4] = 255
    return p


def jax_raw(p, dw, dh, method):
    import jax.numpy as jnp
    v = jsc._resample_matrix(p.shape[0], dh, method)
    hm = jsc._resample_matrix(p.shape[1], dw, method)
    return np.asarray(jnp.asarray(v) @ p.astype(np.float32)
                      @ jnp.asarray(hm).T)


SIZES = [
    (64, 96, 32, 48),     # the ladder's 2:1 luma rung
    (32, 48, 16, 24),     # its chroma
    (64, 96, 96, 144),    # 1.5x up
    (32, 48, 48, 72),     # its chroma
    (96, 160, 64, 96),    # 1.5:1 down (1080p -> 720p's ratio)
    (48, 80, 32, 48),     # its chroma
    (96, 192, 32, 64),    # 3:1 down (1080p -> 360p's ratio)
    (64, 96, 64, 96),     # same size (identity)
]


@pytest.mark.parametrize("kind", ["constant", "full", "extremes"])
@pytest.mark.parametrize("method", ["bicubic", "bilinear"])
@pytest.mark.parametrize("size", SIZES, ids=lambda s: "%dx%d-%dx%d" % (
    s[1], s[0], s[3], s[2]))
def test_resample_plane_parity(size, method, kind):
    sh, sw, dh, dw = size
    p = plane(kind, sh, sw, sh + dw)
    t = torch.as_tensor(p)
    traw = tsc.resample_plane_plain(t, dw, dh, method, unrounded=True)
    tu8 = tsc.resample_plane(t, dw, dh, method).numpy()
    traw = traw.numpy()
    jraw = jax_raw(p, dw, dh, method)
    ju8 = jsc.resample_plane(p, dw, dh, method)
    np.testing.assert_array_equal(
        tu8, np.clip(np.rint(traw), 0, 255).astype(np.uint8))
    if (sh == 2 * dh and sw == 2 * dw) or (sh, sw) == (dh, dw):
        np.testing.assert_array_equal(traw, jraw)
        np.testing.assert_array_equal(tu8, ju8)
        return
    diff = np.abs(traw.astype(np.float64) - jraw)
    assert diff.max() <= ORDER_TOL
    off = tu8 != ju8
    tie = np.abs(np.abs(jraw - np.floor(jraw)) - 0.5)
    assert (tie[off] <= ORDER_TOL).all()
    print(f"{size} {method} {kind}: unrounded differ at {(diff > 0).sum()} "
          f"of {diff.size} (max {diff.max():.3g}); uint8 at {off.sum()} "
          f"(max |jax - k.5| {tie[off].max() if off.any() else 0:.3g})")


def test_frame_and_band_layout():
    """resample_frame halves the chroma size; the band holds every nonzero
    tap of the JAX matrix (so the dense order reduces to it)."""
    fr = clip(96, 64, 1, seed=3)[0]
    y, cb, cr = tsc.resample_frame(tuple(torch.as_tensor(a) for a in fr),
                                   48, 32)
    assert y.shape == (32, 48) and cb.shape == cr.shape == (16, 24)
    for src, dst, m in ((1080, 720, "bicubic"), (1920, 640, "bicubic"),
                        (360, 540, "bilinear"), (96, 48, "bicubic")):
        mat = jsc._resample_matrix(src, dst, m)
        np.testing.assert_array_equal(tsc._resample_matrix(src, dst, m), mat)
        first, w = tsc._band_np(src, dst, m)
        dense = np.zeros_like(mat)
        for d in range(dst):
            for t in range(w.shape[1]):
                if w[d, t]:
                    dense[d, first[d] + t] = w[d, t]
        np.testing.assert_array_equal(dense, mat)
        assert w.shape[1] <= 13


@pytest.fixture(scope="module")
def ladder(tmp_path_factory):
    d = tmp_path_factory.mktemp("ladder")
    src = str(d / "in.y4m")
    with open(src, "wb") as f:
        wr = Y4mWriter(f, Y4mHeader(96, 64, 25, 1))
        for fr in clip(96, 64, 5, seed=21):
            wr.write_frame(*fr)
    cfg = str(d / "ladder.txt")
    with open(cfg, "w") as f:
        f.write("# name:WxH:kbps[:opts]\n"
                "hi:96x64:400:ctu=32 bframes=0 no-info\n"
                "lo:48x32:120:ctu=32 bframes=0 no-info\n")
    return d, src, cfg


def test_abr_ladder_equals_the_jax_packages(ladder):
    d, src, cfg = ladder
    jpre, tpre = str(d / "jax"), str(d / "port")
    assert jabr.main([src, "--ladder", cfg, "--output-prefix", jpre,
                      "--preset", "ultrafast"]) == 0
    assert tabr.main([src, "--ladder", cfg, "--output-prefix", tpre,
                      "--preset", "ultrafast", "--device", "cpu"]) == 0
    for name, (w, h) in (("hi", (96, 64)), ("lo", (48, 32))):
        t = open(f"{tpre}_{name}.hevc", "rb").read()
        j = open(f"{jpre}_{name}.hevc", "rb").read()
        assert t == j, name
        dec = decode_stream(t)
        assert len(dec) == 5
        assert dec[0].y.shape == (h, w)


def test_ladder_config_and_reader(ladder, tmp_path):
    d, src, cfg = ladder
    rungs = tabr.parse_ladder_config(cfg)
    assert [(r.name, r.width, r.height, r.bitrate) for r in rungs] == \
        [(r.name, r.width, r.height, r.bitrate)
         for r in jabr.parse_ladder_config(cfg)]
    p = tabr.rung_param(rungs[1], "medium", 30, 1)
    assert (p.rc_mode, p.bitrate, p.bframes, p.ctu_size, p.info) == \
        ("abr", 120, 0, 32, False)
    frames = list(Y4mReader(src))
    assert len(frames) == 5 and frames[0][0].shape == (64, 96)
    np.testing.assert_array_equal(frames[2][1], clip(96, 64, 5, 21)[2][1])
    bad = str(tmp_path / "bad.txt")
    with open(bad, "w") as f:
        f.write("only:two\n")
    with pytest.raises(ValueError, match="bad ladder line"):
        tabr.parse_ladder_config(bad)
    with pytest.raises(ValueError, match="not wired in this port"):
        tabr.rung_param(tabr.Rung("x", 96, 64, 100, ["ref=2"]), "medium",
                        25, 1)
    assert os.path.exists(src)
