"""The port's SAO (`x265amod_tpu_torch/ops/sao.py`, plain versions of
kernels K10 and K11) against the JAX package's `ops/sao.py` on the CPU, at
96x64 luma (CTU 32) and 48x32 chroma (CTU 16): random planes and edge
inputs (flat 0 and 255 regions, rec == orig, lam 0 and large, structure on
the picture borders), and crafted near-ties of the f32 offset costs that
show where XLA fuses a multiply-add (edge offsets) and where it does not
(bands).  Parameters must be exact; the luma gain is held to 1e-6
relative (it is bit-equal on every input here)."""

import numpy as np
import pytest
import torch

from x265amod_tpu.ops import sao as jsao
from x265amod_tpu_torch.ops import sao as tsao
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

F32 = np.float32


def _t(*arrays):
    return [torch.as_tensor(np.asarray(a)) for a in arrays]


def _planes(kind, h, w, rng):
    orig = rng.integers(0, 256, (h, w)).astype(np.int32)
    rec = np.clip(orig + rng.integers(-9, 10, (h, w)), 0, 255) \
        .astype(np.int32)
    if kind == "flat":
        rec[:, : w // 2] = 0
        orig[:, : w // 2] = rng.integers(0, 6, (h, w // 2))
        rec[:, w // 2:] = 255
        orig[:, w // 2:] = 255 - rng.integers(0, 6, (h, w - w // 2))
    elif kind == "same":
        rec = orig.copy()
    elif kind == "borders":
        # stripes and steps that reach every picture edge
        rec[0, :] = 255
        rec[-1, :] = 0
        rec[:, 0] = np.arange(h) * 3 % 256
        rec[:, -1] = 255 - np.arange(h) * 5 % 256
        rec[::2, 1::2] = np.clip(rec[::2, 1::2] + 40, 0, 255)
    elif kind == "small_error":
        rec = np.clip(orig + rng.integers(-2, 3, (h, w)), 0, 255) \
            .astype(np.int32)
    return orig, rec


def _lam(kind, n, rng):
    return {"random": rng.uniform(0, 400, n), "zero": np.zeros(n),
            "large": np.full(n, 5e5)}[kind].astype(F32)


def _check_luma(orig, rec, lam):
    want = [np.asarray(a) for a in jsao.sao_analyse(orig, rec, lam, 32)]
    got = [a.numpy() for a in tsao.sao_analyse_plain(*_t(orig, rec, lam),
                                                     32)]
    for name, g, w in zip(("type", "eo_class", "band_pos", "offsets"),
                          got[:4], want[:4]):
        np.testing.assert_array_equal(g, w, name)
    np.testing.assert_allclose(got[4], want[4], rtol=1e-6, atol=0)
    return want


def _check_chroma(ocb, rcb, ocr, rcr, lam):
    want = [np.asarray(a) for a in jsao.sao_analyse_chroma(
        ocb, rcb, ocr, rcr, lam, 16)]
    got = [a.numpy() for a in tsao.sao_analyse_chroma_plain(
        *_t(ocb, rcb, ocr, rcr, lam), 16)]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_array_equal(g, w, f"output {i}")
    return want


@pytest.mark.parametrize("kind", ["random", "flat", "same", "borders",
                                  "small_error"])
@pytest.mark.parametrize("lam_kind", ["random", "zero", "large"])
def test_sao_analyse_and_apply_match_jax(kind, lam_kind):
    rng = np.random.default_rng(len(kind) * 7 + len(lam_kind))
    orig, rec = _planes(kind, 64, 96, rng)
    lam = _lam(lam_kind, 6, rng)
    want = _check_luma(orig, rec, lam)
    np.testing.assert_array_equal(
        tsao.sao_apply_plain(*_t(rec, *want[:4]), 32).numpy(),
        np.asarray(jsao.sao_apply(rec, *want[:4], 32)))
    ocb, rcb = _planes(kind, 32, 48, rng)
    ocr, rcr = _planes("random", 32, 48, rng)
    cw = _check_chroma(ocb, rcb, ocr, rcr, lam)
    for r, bp, off in ((rcb, cw[2], cw[3]), (rcr, cw[4], cw[5])):
        np.testing.assert_array_equal(
            tsao.sao_apply_plain(*_t(r, cw[0], cw[1], bp, off), 16).numpy(),
            np.asarray(jsao.sao_apply(r, cw[0], cw[1], bp, off, 16)))


def test_sao_random_sweep_matches_jax():
    """Many random planes and lambdas: every CTU type occurs, every
    parameter and the gain match."""
    rng = np.random.default_rng(123)
    types = set()
    for t in range(12):
        orig = rng.integers(0, 256, (64, 96)).astype(np.int32)
        k = (1, 2, 4, 12)[t % 4]
        rec = np.clip(orig + rng.integers(-k, k + 1, (64, 96))
                      + 3 * (t % 3 - 1), 0, 255).astype(np.int32)
        if t % 4 == 3:                      # a narrow value range: bands
            orig = 100 + orig % 24
            rec = np.clip(orig - 2 + rng.integers(-1, 2, (64, 96)), 0, 255) \
                .astype(np.int32)
        lam = rng.uniform(0, 300, 6).astype(F32)
        types |= set(_check_luma(orig, rec, lam)[0].tolist())
        _check_chroma(orig[:32, :48], rec[:32, :48], orig[32:, 48:],
                      rec[32:, 48:], lam)
    assert types == {0, 1, 2}


def _fused_differs(cnt, e, lam):
    """Whether the best offset of one category differs between the fused
    and the unfused last multiply-add (both in f32)."""
    cand = np.arange(8, dtype=F32)
    a = F32(cnt) * cand * cand - (F32(2) * cand) * F32(e)
    fused = (a.astype(np.float64) + np.float64(lam)
             * (cand + 1).astype(np.float64)).astype(F32)
    plain = (a + F32(lam) * (cand + F32(1))).astype(F32)
    return int(np.argmin(fused)), int(np.argmin(plain))


def _near_ties(rng, count, max_cnt):
    """(cnt, E, lam) whose best offset depends on the fused multiply-add:
    lam within a few ulps of a tie between offsets h and h + 1."""
    out = []
    while len(out) < count:
        cnt = int(rng.integers(max_cnt // 2, max_cnt + 1))
        h = int(rng.integers(1, 4))
        e = int(rng.integers(cnt * h // 2, cnt * (h + 1)))
        lam0 = 2 * e - cnt * (2 * h + 1)
        if lam0 <= 1:
            continue
        lam = F32(lam0) + F32(rng.integers(-4, 5)) * np.spacing(F32(lam0))
        f, p = _fused_differs(cnt, e, lam)
        if f != p:
            out.append((cnt, e, lam, f, p))
    return out


@pytest.mark.parametrize("ctu", [32, 16])
def test_edge_offsets_use_the_fused_multiply_add(ctu):
    """A column pattern L H L H... makes every interior L sample a local
    minimum (edge category 1): its count and error sum pick the offset, at
    a lam where fused and unfused f32 disagree.  JAX takes the fused one,
    and so does the port."""
    rng = np.random.default_rng(ctu)
    pos = [(y, x) for y in range(ctu) for x in range(2, ctu - 1, 2)]
    for cnt, e, lam, fused, _ in _near_ties(rng, 3, len(pos)):
        rec = np.full((ctu, ctu), 101, np.int32)
        rec[:, 0::2] = 100
        for y, x in pos[cnt:]:
            rec[y, x] = 101
        orig = rec.copy()
        q, m = divmod(e, cnt)
        for i, (y, x) in enumerate(pos[:cnt]):
            orig[y, x] = 100 + q + (1 if i < m else 0)
        lam_a = np.array([lam], F32)
        if ctu == 32:
            want = _check_luma(orig, rec, lam_a)
        else:
            want = _check_chroma(orig, rec, orig, rec, lam_a)
        assert want[0][0] == 2 and want[1][0] == 0
        assert want[3][0, 0] == fused


@pytest.mark.parametrize("ctu", [32, 16])
def test_band_offsets_do_not_fuse(ctu):
    """cnt samples in one band with error sum E, the rest of the CTU
    exact: the band's offset follows the unfused f32 order in JAX and in
    the port."""
    rng = np.random.default_rng(100 + ctu)
    for cnt, e, lam, _, plain in _near_ties(rng, 3, min(ctu * ctu, 256)):
        rec = np.full((ctu, ctu), 200, np.int32).reshape(-1)
        orig = rec.copy()
        rec[:cnt] = 84
        q, m = divmod(e, cnt)
        orig[:cnt] = 84 + q
        orig[:m] += 1
        rec, orig = rec.reshape(ctu, ctu), orig.reshape(ctu, ctu)
        lam_a = np.array([lam], F32)
        if ctu == 32:
            want = _check_luma(orig, rec, lam_a)
        else:
            want = _check_chroma(orig, rec, orig, rec, lam_a)
        assert want[0][0] == 1
        assert want[3][0, 84 // 8 - want[2][0]] == plain


def test_sao_pack_rows():
    rng = np.random.default_rng(5)
    n = 6
    params = tuple(rng.integers(-7, 30, s).astype(np.int32) for s in (
        (n,), (n,), (n,), (n, 4), (n,), (n,), (n,), (n, 4), (n,), (n, 4)))
    sl, sc = tsao.sao_pack(params)
    np.testing.assert_array_equal(sl[:, 3:7], params[3])
    np.testing.assert_array_equal(sc[:, 8:12], params[9])
    assert sl.shape == (n, 7) and sc.shape == (n, 14)
    assert (sc[:, 12:] == 0).all()
    assert tsao.sao_pack(None) == (None, None)
