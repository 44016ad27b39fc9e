"""RDOQ level 1 in the PyTorch port (row 21: `ops/rdoq.py:rdoq_adjust`, the
RDOQ stage of kernel K2) against the JAX package on the CPU:

- the tables: the step SSD of n 8, 16 and 32 and the rate of every level
  0..32767 at every QP, slice type I/P/B and plane, equal to JAX's (XLA's
  f32 log2 rounds 8192 low; the port copies that);
- the plain `rdoq_adjust_plain` equal to the jitted JAX `rdoq_adjust` bit
  for bit on random blocks (n 8/16/32, c_idx 0/1, st I/P/B, QP 0-51,
  lambdas 10^-2..10^6 and 0), with and without the group pass, and on
  crafted near-ties that separate a fused multiply-add from two roundings
  (the coefficient cost, the group's j_code) and one summation order from
  another (the group sums), including ties at the 8192 escape;
- `residual_chain_plain` with RDOQ equal to JAX's chain (fwd_transform,
  quant, rdoq_adjust, sbh_adjust, dequant, inv_transform), intra and inter
  rounding;
- one free-running run: a JAX `Encoder` at 64x64 with `bframes=3,
  keyint=60, sao=True, aq_mode=0, cutree=False, rdoq_level=1`, 5 frames
  (IDR, P, B, b, b: RDOQ in all three JAX trees in one compile set), and
  the port's stream equal to it NAL for NAL, decoded bit-exactly, with the
  reference's per-plane wiring of RDOQ recorded call by call.

The module runs at the lowest CPU priority (`test_torch_slice.yield_cpu`).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.ops import rdoq as jrdoq
from x265amod_tpu.ops.quant import dequant as j_deq
from x265amod_tpu.ops.quant import quant as j_quant
from x265amod_tpu.ops.sbh import sbh_adjust as j_sbh
from x265amod_tpu.ops.transforms import fwd_transform as j_fwd
from x265amod_tpu.ops.transforms import inv_transform as j_inv
from x265amod_tpu.utils.params import Param as JaxParam
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models import intra_tree, inter_tree
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.ops import rdoq
from x265amod_tpu_torch.ops.residual import residual_chain_plain
from x265amod_tpu_torch.utils.params import Param
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

QS = [26214, 23302, 20560, 18396, 16384, 14564]
W = H = 64
NF = 5

_jax_rdoq = jax.jit(jrdoq.rdoq_adjust, static_argnames=("c_idx", "st",
                                                        "cg_pass"))


@functools.partial(jax.jit, static_argnames=("intra", "c_idx", "st"))
def _jax_rdoq_chain(orig, pred, qp, lam, intra, c_idx, st):
    """The JAX residual chain with RDOQ and SBH under jit, as the trees run
    it (one compile a configuration instead of one for each eager
    operation): (levels, recon)."""
    co = j_fwd(orig[:, None] - pred)
    q4 = qp[:, None, None, None]
    jl = j_quant(co, q4, intra=intra)
    jl = jrdoq.rdoq_adjust(co, jl, qp[:, None], lam[:, None], c_idx, st)
    jl = j_sbh(jl)
    return jl, jnp.clip(pred + j_inv(j_deq(jl, q4)), 0, 255)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def jax_rdoq(co, lv, qp, lam, c_idx, st, cg=True):
    return np.asarray(_jax_rdoq(co, lv, qp, lam, c_idx=c_idx, st=st,
                                cg_pass=cg))


def port_rdoq(co, lv, qp, lam, c_idx, st, cg=True):
    return rdoq.rdoq_adjust_plain(T(co), T(lv), T(qp), T(lam), c_idx, st,
                                  cg).numpy()


def qbits_of(qp, n):
    return 14 + qp // 6 + 7 - (n.bit_length() - 1)


def quantize(co, qp, n):
    """Intra-rounded flat quant of co [B, n, n] at per-block qp."""
    qb = qbits_of(qp, n).astype(np.int64)[:, None, None]
    sc = np.asarray(QS, np.int64)[qp % 6][:, None, None]
    mag = (np.abs(co).astype(np.int64) * sc + (171 << (qb - 9))) >> qb
    return np.clip(np.sign(co) * mag, -32768, 32767).astype(np.int32)


# ---- tables ------------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16, 32])
def test_step_table_matches_jax(n):
    np.testing.assert_array_equal(
        rdoq.pixel_step_sse(n), jrdoq._pixel_step_sse(n).astype(np.float32))


@pytest.mark.parametrize("st,c_idx", [("I", 0), ("I", 1), ("P", 0),
                                      ("P", 1), ("B", 0), ("B", 1)])
def test_rate_of_every_level_matches_jax(st, c_idx):
    """Every level 0..32767 at every QP: the rate tables and the Golomb
    escape, whose XLA f32 floor(log2(8192)) is 12 (level 8197)."""
    np.testing.assert_array_equal(rdoq.rate_consts(st, c_idx),
                                  jrdoq._rate_of_level_consts(st, c_idx))
    lv = np.broadcast_to(np.arange(32768, dtype=np.int32), (52, 32768))
    qp = np.broadcast_to(np.arange(52, dtype=np.int32)[:, None], lv.shape)
    tab = jrdoq._rate_of_level_consts(st, c_idx)
    want = np.asarray(jax.jit(jrdoq._rate)(jnp.asarray(lv), jnp.asarray(qp),
                                           jnp.asarray(tab)))
    got = rdoq.level_rate(T(lv).long(), T(qp).long(),
                          T(rdoq.rate_consts(st, c_idx))).numpy()
    np.testing.assert_array_equal(got, want)
    exact = np.floor(np.log2(np.arange(1, 32764)))
    low = np.nonzero(rdoq.floor_log2_xla(T(np.arange(1, 32764)).long())
                     .numpy() != exact)[0] + 1
    assert low.tolist() == [8192]


# ---- rdoq_adjust ---------------------------------------------------------------


@pytest.mark.parametrize("n", [8, 16, 32])
@pytest.mark.parametrize("st", ["I", "P", "B"])
def test_rdoq_matches_jax_on_random_blocks(n, st):
    rng = np.random.default_rng(n + ord(st))
    b = 48
    co = rng.integers(-20000, 20001, (b, n, n)) * (rng.random((b, n, n))
                                                   < 0.5)
    co[0] = 0                                          # an all-zero block
    co[1] = rng.integers(-80, 81, (n, n))              # small levels
    co = co.astype(np.int32)
    qp = rng.integers(0, 52, b).astype(np.int32)
    qp[:4] = (0, 51, 0, 51)
    lv = quantize(co, qp, n)
    lv[2, 0, :2] = (32767, -32767)                     # the level bound
    lam = (10.0 ** rng.uniform(-2, 6, b)).astype(np.float32)
    lam[3], lam[5] = 0.0, 1e6
    for c_idx in (0, 1):
        for cg in (True, False):
            np.testing.assert_array_equal(
                port_rdoq(co, lv, qp, lam, c_idx, st, cg),
                jax_rdoq(co, lv, qp, lam, c_idx, st, cg),
                f"c_idx {c_idx} cg {cg}")
    out = port_rdoq(co, lv, qp, lam, 0, st)
    assert (np.abs(out) <= np.abs(lv)).all()
    assert not (np.sign(out) * np.sign(lv) < 0).any()
    assert (out != lv).any()


def _ulps(x, k):
    x = np.float32(x)
    for _ in range(abs(k)):
        x = np.nextafter(x, np.float32(np.inf if k > 0 else -np.inf))
    return x


@pytest.mark.parametrize("n,st,c_idx", [(16, "P", 0), (8, "I", 1),
                                        (32, "B", 0)])
def test_coefficient_near_ties_match_jax(n, st, c_idx):
    """One coefficient per block at lambdas within a few ulps of its
    hi/lo tie, so that the decision turns on the last bit of each cost:
    XLA fuses ``(q - l)^2 step + lam R`` into one FMA of the distortion
    product.  Levels 8196-8198 put the 8192 escape quirk on a tie."""
    rng = np.random.default_rng(7 + n)
    log2n = n.bit_length() - 1
    step = rdoq.pixel_step_sse(n).astype(np.float64)
    rtab = torch.as_tensor(rdoq.rate_consts(st, c_idx))
    draws = []
    for i in range(6000):
        qp = int(rng.integers(0, 52))
        a = int(rng.integers(1, 40)) if i % 10 else int(rng.integers(8196,
                                                                     8199))
        qb, sc = 14 + qp // 6 + 7 - log2n, QS[qp % 6]
        c = int((a - 1 + rng.random()) * 2 ** qb / sc)
        if 0 < c < 2 ** 24:
            draws.append((qp, a, c, qb, sc))
    # the rates of a and a - 1 of every draw, in one call
    qa = torch.tensor([[d[0], d[0]] for d in draws])
    la = torch.tensor([[d[1], d[1] - 1] for d in draws])
    rates = rdoq.level_rate(la, qa, rtab).double().numpy()
    cases = []
    for (qp, a, c, qb, sc), r in zip(draws, rates):
        q = float(np.float32(np.float32(c) * np.float32(sc))
                  / np.float32(2.0 ** qb))
        if r[0] == r[1]:
            continue
        lam0 = step[qp] * ((q - a + 1) ** 2 - (q - a) ** 2) / (r[0] - r[1])
        if 0 < lam0 < 1e7:
            cases += [(qp, a, c, _ulps(lam0, k)) for k in range(-3, 4)]
    b = len(cases)
    co = np.zeros((b, n, n), np.int32)
    lv = np.zeros((b, n, n), np.int32)
    pos = rng.integers(0, n, (b, 2))
    sgn = np.where(np.arange(b) % 2, 1, -1)
    for i, (_, a, c, _) in enumerate(cases):
        co[i, pos[i, 0], pos[i, 1]] = sgn[i] * c
        lv[i, pos[i, 0], pos[i, 1]] = sgn[i] * a
    qp = np.array([x[0] for x in cases], np.int32)
    lam = np.array([x[3] for x in cases], np.float32)
    got = port_rdoq(co, lv, qp, lam, c_idx, st, False)
    np.testing.assert_array_equal(got, jax_rdoq(co, lv, qp, lam, c_idx, st,
                                                False))
    # both outcomes occur among the ties
    moved = (got != lv).any((1, 2))
    assert 0 < moved.sum() < b


@pytest.mark.parametrize("n,st,c_idx", [(16, "P", 0), (8, "B", 1),
                                        (32, "I", 0)])
def test_group_near_ties_match_jax(n, st, c_idx):
    """Groups with lambdas within a few ulps of the kill tie j_zero ==
    j_code: the decision turns on the last bit of the group sums, so these
    pin XLA's order (eight lanes of k and k + 8 with an FMA each, then a
    halving tree, for the coded distortion and rate; one FMA chain for the
    zero distortion) and its fusion (j_code fused, j_zero not)."""
    rng = np.random.default_rng(11 + n)
    csb0, csb1 = (float(x) for x in rdoq.group_csb(st, c_idx))
    step = rdoq.pixel_step_sse(n).astype(np.float64)
    rtab = torch.as_tensor(rdoq.rate_consts(st, c_idx))
    cand = []
    for _ in range(700):
        qp = int(rng.integers(0, 52))
        qb, sc = qbits_of(np.int64(qp), n), QS[qp % 6]
        co = np.zeros((n, n), np.int64)
        k = int(rng.integers(1, 6))
        co[rng.integers(0, 4, k), rng.integers(0, 4, k)] = \
            (rng.uniform(0.5, 3.0, k) * 2 ** qb / sc).astype(np.int64)
        lv = np.round(co * sc / 2 ** qb).astype(np.int32)
        q = (np.float32(co[:4, :4]) * np.float32(sc)) / np.float32(2 ** qb)
        cand.append((co.astype(np.int32), lv, qp, q))
    # the tie lambda of each candidate, at the hi/lo choice: three rounds,
    # each one batched plain RDOQ over the candidates still searching (a
    # block's result does not depend on the batch around it)
    lam = [1.0] * len(cand)
    alive = list(range(len(cand)))
    for _ in range(3):
        l1s = np.abs(port_rdoq(
            np.stack([cand[i][0] for i in alive]),
            np.stack([cand[i][1] for i in alive]),
            np.array([cand[i][2] for i in alive], np.int32),
            np.array([lam[i] for i in alive], np.float32), c_idx, st,
            False)[:, :4, :4]).astype(np.int64)
        keep = []
        for i, l1 in zip(alive, l1s):
            _, _, qp, q = cand[i]
            if not l1.any():
                continue
            r = rdoq.level_rate(T(l1), torch.full((4, 4), qp), rtab)
            den = float(r.double().sum()) + csb1 - csb0
            lam_t = step[qp] * float(((q.astype(np.float64) ** 2)
                                      - (q - l1) ** 2).sum()) / den \
                if den > 0 else -1.0
            if not 1e-3 < lam_t < 1e7:
                continue
            lam[i] = lam_t
            keep.append(i)
        alive = keep
    cases = [(cand[i][0], cand[i][1], cand[i][2], _ulps(lam[i], j))
             for i in alive for j in range(-4, 5)]
    co = np.stack([x[0] for x in cases])
    lv = np.stack([x[1] for x in cases])
    qp = np.array([x[2] for x in cases], np.int32)
    lam = np.array([x[3] for x in cases], np.float32)
    got = port_rdoq(co, lv, qp, lam, c_idx, st)
    np.testing.assert_array_equal(got, jax_rdoq(co, lv, qp, lam, c_idx, st))
    killed = ~got[:, :4, :4].any((1, 2)) & lv[:, :4, :4].any((1, 2))
    assert len(cases) >= 2000 and 0 < killed.sum() < len(cases)


@pytest.mark.parametrize("n,intra", [(8, True), (16, False), (32, True),
                                     (32, False)])
def test_residual_chain_with_rdoq_matches_jax_chain(n, intra):
    """K2's plain version with RDOQ and SBH against the JAX chain, with
    flat 0 / 255 blocks, a zero residual and QP 0 and 51."""
    rng = np.random.default_rng(3 * n + intra)
    b, k = 10, 2
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-60, 61, (b, k, n, n)), 0,
                   255).astype(np.int32)
    orig[0], pred[0] = 0, 255
    orig[1], pred[1] = 255, 255
    qp = rng.integers(0, 52, b).astype(np.int32)
    qp[:3] = (0, 51, 0)
    lam = (10.0 ** rng.uniform(-1, 4, b)).astype(np.float32)
    st = "I" if intra else "B"
    for c_idx in (0, 1):
        lv, rec, ssd = residual_chain_plain(T(orig), T(pred), T(qp), True,
                                            intra=intra, rdoq=True,
                                            lam=T(lam), st=st, c_idx=c_idx)
        jl, jr = _jax_rdoq_chain(orig, pred, qp, lam, intra=intra,
                                 c_idx=c_idx, st=st)
        np.testing.assert_array_equal(lv.numpy(), np.asarray(jl))
        np.testing.assert_array_equal(rec.numpy(), np.asarray(jr))
        np.testing.assert_array_equal(
            ssd.numpy(), ((np.asarray(jr) - orig[:, None]) ** 2).sum((2, 3)))


# ---- free running: RDOQ in the I, P and B trees ----------------------------------


def config3_rdoq(**kw):
    d = dict(width=W, height=H, keyint=60, bframes=3, ctu_size=32, sao=True,
             aq_mode=0, cutree=False, rc_lookahead=4, info=False, qp=32,
             rdoq_level=1)
    d.update(kw)
    return d


@pytest.fixture(scope="module")
def runs():
    """The JAX `Encoder`'s stream and the port's (CPU), with every K2 call
    the port's trees made (slice type, plane, RDOQ on or off), and the
    port's stream without RDOQ."""
    frames = clip(W, H, NF, seed=5)
    jenc = JaxEncoder(JaxParam(**config3_rdoq()))
    jouts = [o for f in frames for o in jenc.encode_push(*f)] + jenc.flush()
    calls = []

    def spy(module):
        inner = module.residual_chain

        def chain(orig, pred, qp, sbh, *a, **k):
            calls.append((module.__name__.rsplit(".", 1)[1],
                          k.get("rdoq", False), k.get("st"),
                          k.get("c_idx", 0), tuple(pred.shape[-2:]),
                          k.get("intra", True)))
            return inner(orig, pred, qp, sbh, *a, **k)
        return inner, chain
    saved = {}
    for m in (intra_tree, inter_tree):
        saved[m], m.residual_chain = spy(m)
    try:
        tenc = Encoder(Param(**config3_rdoq()), device="cpu")
        touts = list(tenc.encode_pipelined(frames, return_recon=True))
    finally:
        for m, inner in saved.items():
            m.residual_chain = inner
    off = Encoder(Param(**config3_rdoq(rdoq_level=0)), device="cpu")
    off_bytes = sum(len(o.nals) for o in off.encode_pipelined(frames))
    return frames, jouts, touts, calls, off_bytes


def test_free_running_rdoq_stream_equals_jax_and_decodes(runs):
    frames, jouts, touts, _, off_bytes = runs
    assert [o.stats.slice_type for o in touts] == ["I", "P", "B", "B", "B"]
    assert [(o.stats.poc, o.stats.qp) for o in touts] == \
        [(o.stats.poc, o.stats.qp) for o in jouts]
    assert [o.nals for o in touts] == [o.nals for o in jouts]
    # RDOQ pays: fewer bytes than the same port run without it
    assert sum(len(o.nals) for o in touts) < off_bytes
    decoded = decode_stream(b"".join(o.nals for o in touts))
    by_display = sorted(touts, key=lambda o: o.stats.display_order)
    assert len(decoded) == NF
    for fr, out in zip(decoded, by_display):
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])
        np.testing.assert_array_equal(fr.cr, out.recon[2])


def test_rdoq_runs_where_the_reference_runs_it(runs):
    """The reference's uneven wiring, call by call: the intra tree's
    commit on luma only (st I); the P tree's final coding on luma and
    chroma (st P); the B tree's final coding on luma only (st B); the
    intra cells of the P/B commit scan on luma and chroma; never in the
    estimate or the trials (which code with the plain chain)."""
    calls = runs[3]
    on = {(m, st, c_idx, shape, intra)
          for m, r, st, c_idx, shape, intra in calls if r}
    off = {(m, st, c_idx, shape, intra)
           for m, r, st, c_idx, shape, intra in calls if not r}
    assert {c for c in on if c[1] == "I"} == {
        ("intra_tree", "I", 0, (32, 32), True),
        ("intra_tree", "I", 0, (16, 16), True)}
    final = {c for c in on if not c[4]}           # inter rounding
    assert final == {("inter_tree", "P", 0, (16, 16), False),
                     ("inter_tree", "P", 0, (32, 32), False),
                     ("inter_tree", "P", 1, (8, 8), False),
                     ("inter_tree", "P", 1, (16, 16), False),
                     ("inter_tree", "B", 0, (16, 16), False),
                     ("inter_tree", "B", 0, (32, 32), False)}
    assert {("inter_tree", "B", 1, (8, 8), False),
            ("inter_tree", "B", 1, (16, 16), False)} <= off
    # intra cells of the P/B commit scan (`forced_chain`): luma and chroma
    for st in ("P", "B"):
        if ("intra_tree", st, 0, (16, 16), True) in on:
            assert ("intra_tree", st, 1, (8, 8), True) in on
    # nothing else runs RDOQ: not the estimate, not the trials
    cells = {("intra_tree", st, c, shape, True) for st in ("P", "B")
             for c, shape in ((0, (16, 16)), (1, (8, 8)))}
    assert on <= final | cells | {("intra_tree", "I", 0, (32, 32), True),
                                  ("intra_tree", "I", 0, (16, 16), True)}
