"""The port's B pyramid with SAO (the config-3 slice: bench.py's config 3 with
AQ and CU-tree off, so `rc_lookahead` runs nothing; CQP 32; keyint 60,
bframes 3, CTU32, one reference per list) against the JAX package on the
CPU:

- ops: the 14-bit MC and `bi_combine` (kernel K9's plain version) at MVs on
  the window contract's bound and over 0/255 steps; `_scale_mv_vec` and
  `dist_scale_factor` over POC distances -8..8;
- the GOP plan (POC, slice type, references, RPS, display index of every
  entry) for bframes 1, 2 and 3 across a keyint 4 boundary, host only;
- forced decisions: the JAX B tree's decisions replayed through the port's
  `BTreeEncoder.encode_async_load` give byte-identical levels, recon, SAO
  parameters and slice payloads at 64x64, QP 32 and 40; the cells' final
  MVs stay inside the window contract (|mv >> 2| <= sr + 2, |mv >> 3| <=
  sr // 2 + 2);
- free running: the port's `Encoder` stream equals the JAX `Encoder`'s NAL
  for NAL (a frame may differ only on an f32 near-tie of the B costs,
  whose relative gap the test reports) and decodes bit-exactly with the
  JAX package's conformance decoder;
- config 3 as bench.py builds it (`aq_mode=2, cutree=True,
  rc_lookahead=4`: the lookahead, AQ and CU-tree QP offsets, `cu_qp_delta`)
  on a clip with a scene cut at frame 6 (a new IDR, then short mini-GOPs):
  the JAX run's I, P and B decisions replayed with its per-16-cell QP
  offsets give byte-identical levels, recon, SAO parameters and payloads,
  and the free-running port stream equals the JAX `Encoder`'s NAL for NAL,
  with equal per-CTU QP maps, and decodes bit-exactly;
- the slice gate and the device rule.

One JAX `Encoder` run per QP (IDR + two mini-GOPs at 64x64, its trees
shared, so JAX compiles them once), and one of config 3 with AQ and
CU-tree on the same trees, serve the replay and free-running tests.  Its
three compiles take most of this file's time (the module runs at the lowest
CPU priority, `test_torch_slice.yield_cpu`).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.models import mvpred as jmvpred
from x265amod_tpu.models.inter_frame import _mvd_bits as jax_mvd_bits
from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.inter_tree import _scale_mv_vec as jax_scale
from x265amod_tpu.models.ratecontrol import RateControl as JaxRC
from x265amod_tpu.ops import me as jme
from x265amod_tpu.utils.params import Param as JaxParam
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models import mvpred
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
from x265amod_tpu_torch.models.inter_tree import (BTreeEncoder,
                                                  InterTreeEncoder,
                                                  _scale_mv_vec)
from x265amod_tpu_torch.models.ratecontrol import RateControl
from x265amod_tpu_torch.ops import me
from x265amod_tpu_torch.utils.params import Param, check_params
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

W, H, NF = 64, 64, 9
SR = 16
CUT = 6             # the scene cut of the AQ run's clip


def config3(w=W, h=H, qp=32, **kw):
    """bench.py's config 3 (`bench.py:114`) with AQ and CU-tree off; its
    crf is never read (rc_mode stays "cqp"), so frames code at QP 32 and
    its B/b offsets."""
    d = dict(width=w, height=h, keyint=60, bframes=3, ctu_size=32, sao=True,
             aq_mode=0, cutree=False, rc_lookahead=4, info=False, qp=qp)
    d.update(kw)
    return Param(**d)


def cut_clip(w, h, n, cut, seed):
    """The bench clip with a different scene from frame ``cut`` on."""
    rng = np.random.default_rng(seed + 1)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    second = []
    for t in range(n - cut):
        y = (128 + 100 * np.cos((xx - 2 * t) / 5.0) * np.sin((yy + t) / 3.0)
             + rng.normal(0, 12, (h, w))).clip(0, 255).astype(np.uint8)
        c = rng.integers(40, 216, (h // 2, w // 2)).astype(np.uint8)
        second.append((y, c, 255 - c))
    return clip(w, h, cut, seed=seed) + second


def config3_aq(**kw):
    """bench.py's config 3 exactly as it builds it: AQ mode 2, CU-tree,
    rc-lookahead 4."""
    return config3(**dict(dict(aq_mode=2, cutree=True), **kw))


@pytest.fixture(scope="module")
def jax_runs():
    """{qp: (frames, outputs, results in decode order, JAX encoder,
    dispatched plan entries)}, and under "aq" the same for config 3 with AQ
    and CU-tree at QP 32: each tree's collect is wrapped to keep the
    results it returns, the encoder's dispatch to keep its entries (with
    their QP offsets and signalled QP maps)."""
    runs, trees = {}, None
    for qp in (32, 40, "aq"):
        p = config3_aq() if qp == "aq" else config3(qp=qp)
        frames = cut_clip(W, H, NF, CUT, 5) if qp == "aq" else \
            clip(W, H, NF, seed=5)
        jenc = JaxEncoder(JaxParam(**dataclasses.asdict(p)))
        if trees is None:
            trees = (jenc.frame_encoder, jenc.inter_encoder, jenc.b_encoder)
        else:
            jenc.frame_encoder, jenc.inter_encoder, jenc.b_encoder = trees
        results = []

        def keep(inner):
            def collect(*a, **k):
                results.append(inner(*a, **k))
                return results[-1]
            return collect
        for t in trees:
            t.collect = keep(type(t).collect.__get__(t))
        entries = []
        inner = jenc._dispatch_entry

        def dispatch(e, *a, **k):
            entries.append(e)
            return inner(e, *a, **k)
        jenc._dispatch_entry = dispatch
        try:
            outs = [o for f in frames
                    for o in jenc.encode_push(*f, return_recon=True)]
            outs += jenc.flush(return_recon=True)
        finally:
            for t in trees:
                del t.collect
        runs[qp] = (frames, outs, results, jenc, entries)
    return runs


# ---- ops ---------------------------------------------------------------------


def _step_plane(rng, h, w):
    p = rng.integers(0, 256, (h, w)).astype(np.int32)
    p[:, : w // 4] = 0
    p[:, w // 4: w // 2] = 255          # a 0/255 step: negative 14-bit lobes
    p[h // 2:, :] = np.clip(p[h // 2:, :] // 8 * 8, 0, 255)
    return p


@pytest.mark.parametrize("n,chroma", [(16, False), (32, False), (8, True)])
def test_mc14_and_bi_combine_match_jax(n, chroma):
    rng = np.random.default_rng(n + 3 * chroma)
    h, w = (32, 48) if chroma else (64, 96)
    mm = SR // 2 + 2 if chroma else SR + 2
    unit = 8 if chroma else 4
    r0, r1 = _step_plane(rng, h, w), _step_plane(rng, h, w)
    nb = (h // n) * (w // n)
    mvs = []
    for _ in range(2):
        mv = rng.integers(-unit * mm, unit * mm + unit, (nb, 2)) \
            .astype(np.int32)
        mv[0] = (-unit * mm, -unit * mm)          # the contract's bounds
        mv[-1] = (unit * mm + unit - 1, unit * mm + unit - 1)
        mvs.append(mv)
    jfn = jme.mc_chroma_qpel14 if chroma else jme.mc_luma_qpel14
    tfn = me.mc_chroma_qpel14 if chroma else me.mc_luma_qpel14
    p14 = []
    for r, mv in zip((r0, r1), mvs):
        want = np.asarray(jfn(jnp.asarray(r), jnp.asarray(mv), n,
                              max_mv=mm))
        got = tfn(torch.as_tensor(r), torch.as_tensor(mv), n).numpy()
        np.testing.assert_array_equal(got, want)
        p14.append(want)
    assert min(a.min() for a in p14) < 0       # the lobes went negative
    want_bi = np.asarray(jme.bi_combine(jnp.asarray(p14[0]),
                                        jnp.asarray(p14[1])))
    tt = [torch.as_tensor(a) for a in (r0, r1, *mvs)]
    np.testing.assert_array_equal(
        me.bi_combine(*(torch.as_tensor(a) for a in p14)).numpy(), want_bi)
    np.testing.assert_array_equal(me.mc_bi(*tt, n, chroma, mm).numpy(),
                                  want_bi)
    with pytest.raises(ValueError, match="window contract"):
        me.mc_bi(tt[0], tt[1], tt[2] - unit, tt[3], n, chroma, mm)
    # deferred: the excess is kept for the caller's check (the B tree's
    # collect), which raises there
    excess = []
    me.mc_bi(*tt, n, chroma, mm, excess)
    me.mc_bi(tt[0], tt[1], tt[2], tt[3] + unit, n, chroma, mm, excess)
    assert [int(e) for e in excess] == [0, 1]
    with pytest.raises(ValueError, match="window contract"):
        me.check_window(torch.stack(excess).amax())


def test_scale_mv_and_dist_scale_factor_match_jax():
    rng = np.random.default_rng(9)
    mv = rng.integers(-300, 301, (64, 2)).astype(np.int32)
    mv[:4] = [(0, 0), (-1, 1), (1, -1), (-255, 255)]
    for cur in range(-8, 9):
        for t in range(-8, 9):
            for o in range(-8, 9):
                dsf = mvpred.dist_scale_factor(cur, t, o)
                assert dsf == jmvpred.dist_scale_factor(cur, t, o)
        for dsf in (mvpred.dist_scale_factor(cur, 0, 8),
                    mvpred.dist_scale_factor(cur, 8, 0)):
            np.testing.assert_array_equal(
                _scale_mv_vec(torch.as_tensor(mv), dsf).numpy(),
                np.asarray(jax_scale(jnp.asarray(mv), dsf)))


def test_rate_control_codes_b_and_b_leaves_at_the_jax_qps():
    p = config3()
    jp = JaxParam(**dataclasses.asdict(p))
    for st, qp in (("I", 29), ("P", 32), ("B", 33), ("b", 34)):
        assert RateControl(p).frame_qp(st) == JaxRC(jp).frame_qp(st) == qp


# ---- the GOP plan --------------------------------------------------------------


def _plan(enc, n):
    z = np.zeros((32, 64), np.uint8)
    c = np.zeros((16, 32), np.uint8)
    entries = []
    for _ in range(n):
        entries += enc._push_display_frame(z, c, c)
    entries += enc._flush_gop()
    return [(e["poc"], e["stype"], e["ref0"], e["ref1"], e["is_ref"],
             e["rps_neg"], e["rps_pos"], e["display"], e["last_in_gop"])
            for e in entries]


@pytest.mark.parametrize("bframes", [1, 2, 3])
def test_gop_plan_matches_jax(bframes):
    p = config3(64, 32, keyint=4, bframes=bframes)
    tplan = _plan(Encoder(p, device="cpu"), 11)
    jplan = _plan(JaxEncoder(JaxParam(**dataclasses.asdict(p))), 11)
    assert tplan == jplan
    assert sorted(e[7] for e in tplan) == list(range(11))
    assert [e[1] for e in tplan].count("I") == 3        # keyint 4 IDRs


# ---- forced decisions ------------------------------------------------------------


def _refs_of(outs, results):
    """POC of every decode-order output and its recon planes, per CVS."""
    return {o.stats.poc: (r.recon_y, r.recon_cb, r.recon_cr)
            for o, r in zip(outs, results)}


@pytest.mark.parametrize("qp", [32, 40])
def test_forced_b_decisions_byte_identical(jax_runs, qp):
    frames, outs, results, jenc, _ = jax_runs[qp]
    plan = {e[0]: e for e in _plan(Encoder(config3(), device="cpu"), NF)
            if e[1] == "B"}
    recon = _refs_of(outs, results)
    ttree = BTreeEncoder(W, H, deblock=True, search_range=SR, subme=2,
                         sign_hide=True, sao=True, device="cpu")
    tenc = Encoder(config3(qp=qp), device="cpu")
    dirs, n_b = set(), 0
    for o, jres in zip(outs, results):
        if o.stats.slice_type != "B":
            continue
        n_b += 1
        poc = o.stats.poc
        _, _, r0, r1, _, _, _, disp, _ = plan[poc]
        dsf0 = mvpred.dist_scale_factor(poc, r0, r1)
        dsf1 = mvpred.dist_scale_factor(poc, r1, r0)
        args = (*frames[disp], tuple(torch.as_tensor(a) for a in recon[r0]),
                tuple(torch.as_tensor(a) for a in recon[r1]), o.stats.qp,
                dsf0, dsf1)
        dec = (jres.split, jres.kinds, jres.merge_idx, jres.inter_dir,
               jres.mvd0, jres.mvp0, jres.mvd1, jres.mvp1, jres.modes)
        tres = ttree.collect(ttree.encode_async_load(*args, *dec,
                                                     want_recon=True))
        for name in ("split", "kinds", "merge_idx", "inter_dir", "mvd0",
                     "mvp0", "mvd1", "mvp1", "modes", "levels_y",
                     "levels_cb", "levels_cr", "recon_y", "recon_cb",
                     "recon_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name), name)
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        jsao = (jres.sao_type, jres.sao_eo_class, jres.sao_band_pos,
                jres.sao_offsets) + tuple(jres.sao_c)
        for i, (g, w) in enumerate(zip(tres.sao, jsao)):
            np.testing.assert_array_equal(g, w, f"sao{i}")
        assert tenc._cabac_b_tree(tres, o.stats.qp) == \
            jenc._cabac_b_tree(jres, o.stats.qp)
        # the final MVs these decisions imply stay inside the window
        # contract of the JAX MC (|mv_int| <= sr + 2 luma, sr // 2 + 2
        # chroma)
        cells = _final_mvs(ttree, args, dec)
        for mv in cells:
            assert int((mv >> 2).abs().max()) <= SR + 2
            assert int((mv >> 3).abs().max()) <= SR // 2 + 2
        dirs |= set(np.unique(jres.inter_dir[jres.kinds == 1]).tolist())
    assert n_b == 6
    assert 3 in dirs or qp == 40          # bi-prediction was replayed
    # SAO is not trivially off in the run (at QP 40 its lambda turns it off
    # on this clip)
    assert qp == 40 or any((r.sao_type != 0).any() or (r.sao_c[0] != 0).any()
                           for r in results)


def _final_mvs(ttree, args, dec):
    """The cells' final L0 and L1 MVs under the given decisions (the
    replay's derivation, read before MC)."""
    captured = {}
    inner = ttree._final_mc_b

    def spy(refs0, refs1, cell, excess):
        captured.update(mv0=cell["mv0"], mv1=cell["mv1"])
        return inner(refs0, refs1, cell, excess)
    ttree._final_mc_b = spy
    try:
        ttree.collect(ttree.encode_async_load(*args, *dec))
    finally:
        del ttree._final_mc_b
    return captured["mv0"], captured["mv1"]


# ---- free running ------------------------------------------------------------------


@pytest.mark.parametrize("qp", [32, 40])
def test_free_running_stream_equals_jax_and_decodes(jax_runs, qp):
    frames, jouts, jresults, _, _ = jax_runs[qp]
    tenc = Encoder(config3(qp=qp), device="cpu")
    touts = list(tenc.encode_pipelined(frames, return_recon=True))
    assert [(o.stats.poc, o.stats.slice_type, o.stats.qp) for o in touts] \
        == [(o.stats.poc, o.stats.slice_type, o.stats.qp) for o in jouts]
    assert [o.stats.slice_type for o in touts[:5]] == ["I", "P", "B", "B",
                                                       "B"]
    differ = [i for i, (a, b) in enumerate(zip(touts, jouts))
              if a.nals != b.nals]
    if differ:
        # a frame may differ only where the port's B costs nearly tie; the
        # first differing frame sees the same references on both sides
        i = differ[0]
        assert touts[i].stats.slice_type == "B", differ
        gap = _b_cost_gap(tenc, frames, touts, jresults, i)
        print(f"frame {i} differs on a near-tie, relative gap {gap:.3g}")
        assert gap < 1e-5
    decoded = decode_stream(b"".join(o.nals for o in touts))
    by_display = sorted(touts, key=lambda o: o.stats.display_order)
    assert len(decoded) == NF
    for fr, out in zip(decoded, by_display):
        assert fr.poc == out.stats.poc
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])
        np.testing.assert_array_equal(fr.cr, out.recon[2])


def _b_cost_gap(tenc, frames, touts, jresults, i):
    """Smallest relative gap between the two best costs of a cell whose
    decision differs from the JAX run's, on frame i's inputs."""
    plan = {e[0]: e for e in _plan(Encoder(config3(), device="cpu"), NF)}
    poc = touts[i].stats.poc
    _, _, r0, r1, _, _, _, disp, _ = plan[poc]
    recon = {o.stats.poc: o.recon for o in touts[:i]}
    tree = tenc.b_encoder
    h = tree.encode_async(
        *frames[disp], tuple(torch.as_tensor(a) for a in recon[r0]),
        tuple(torch.as_tensor(a) for a in recon[r1]), touts[i].stats.qp,
        mvpred.dist_scale_factor(poc, r0, r1),
        mvpred.dist_scale_factor(poc, r1, r0), want_costs=True)
    costs = h["costs"]
    tres = tree.collect(h)
    jres = jresults[i]
    same = (tres.kinds == jres.kinds) & (tres.merge_idx == jres.merge_idx) \
        & (tres.inter_dir == jres.inter_dir)
    js = torch.sort(costs["jsq"], -1).values.numpy()
    rel = (js[:, 1] - js[:, 0]) / np.maximum(np.abs(js[:, 0]), 1e-9)
    gaps = list(rel.reshape(same.shape)[~same])
    sp = tres.split != jres.split
    if sp.any():
        g = np.abs(costs["jsplit"] - costs["j32"]).numpy() / np.maximum(
            np.abs(costs["j32"].numpy()), 1e-9)
        gaps += list(g.reshape(sp.shape)[sp])
    return max(gaps) if gaps else 0.0


# ---- config 3 with AQ and CU-tree ------------------------------------------


def test_config3_aq_forced_decisions_byte_identical(jax_runs):
    """The JAX run's decisions and per-16-cell QP offsets replayed through
    the port's I, P and B trees: the same levels, recon, SAO parameters
    and payloads (with cu_qp_delta from the same QP maps)."""
    frames, outs, results, jenc, entries = jax_runs["aq"]
    tenc = Encoder(config3_aq(), device="cpu")
    kw = dict(deblock=True, sign_hide=True, sao=True, device="cpu")
    trees = {"I": IntraTreeEncoder(W, H, **kw),
             "P": InterTreeEncoder(W, H, search_range=SR, subme=2, **kw),
             "B": BTreeEncoder(W, H, search_range=SR, subme=2, **kw)}
    off_qp, recon = 0, {}
    assert [e["poc"] for e in entries] == [o.stats.poc for o in outs]
    for o, jres, e in zip(outs, results, entries):
        st, qp, poc = e["stype"], o.stats.qp, e["poc"]
        if st == "I":
            recon = {}            # a new CVS: POCs restart
        planes = frames[e["display"]]
        qp_off, qp_map = e["qp_off"], e["qp_map"]
        assert qp_off is not None and qp_map.shape == (H // 16, W // 16)
        off_qp += int((qp_map != qp).sum())

        def ref(p):
            return tuple(torch.as_tensor(a) for a in recon[p])
        if st == "I":
            tres = trees["I"].collect(trees["I"].encode_async_load(
                *planes, qp, jres.split, jres.modes, want_recon=True,
                qp_offsets=qp_off))
            pay = (tenc._cabac_intra_tree(tres, qp, qp_map),
                   jenc._cabac_intra_tree(jres, qp, qp_map))
        elif st == "P":
            tres = trees["P"].collect(trees["P"].encode_async_load(
                *planes, ref(e["ref0"]), qp, jres.split, jres.kinds,
                jres.merge_idx, jres.mvd, jres.mvp_idx, jres.modes,
                want_recon=True, qp_offsets=qp_off))
            pay = (tenc._cabac_inter_tree(tres, qp, qp_map),
                   jenc._cabac_inter_tree(jres, qp, qp_map))
        else:
            tres = trees["B"].collect(trees["B"].encode_async_load(
                *planes, ref(e["ref0"]), ref(e["ref1"]), qp,
                mvpred.dist_scale_factor(poc, e["ref0"], e["ref1"]),
                mvpred.dist_scale_factor(poc, e["ref1"], e["ref0"]),
                jres.split, jres.kinds, jres.merge_idx, jres.inter_dir,
                jres.mvd0, jres.mvp0, jres.mvd1, jres.mvp1, jres.modes,
                want_recon=True, qp_offsets=qp_off))
            pay = (tenc._cabac_b_tree(tres, qp, qp_map),
                   jenc._cabac_b_tree(jres, qp, qp_map))
        for name in ("levels_y", "levels_cb", "levels_cr", "recon_y",
                     "recon_cb", "recon_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name),
                                          f"{st} poc {poc} {name}")
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        jsao = (jres.sao_type, jres.sao_eo_class, jres.sao_band_pos,
                jres.sao_offsets) + tuple(jres.sao_c)
        for i, (g, w) in enumerate(zip(tres.sao, jsao)):
            np.testing.assert_array_equal(g, w, f"{st} poc {poc} sao{i}")
        assert pay[0] == pay[1], f"{st} poc {poc}"
        recon[poc] = (jres.recon_y, jres.recon_cb, jres.recon_cr)
    # the cut at frame 6 starts a new IDR; frame 5 closes the first CVS as
    # a P, and frames 7-8 make a short mini-GOP (P 8, B 7)
    assert [(o.stats.slice_type, o.stats.display_order) for o in outs] == \
        [("I", 0), ("P", 4), ("B", 2), ("B", 1), ("B", 3), ("P", 5),
         ("I", CUT), ("P", 8), ("B", 7)]
    assert off_qp > 0           # the offsets moved some CTUs off the QP


def test_config3_aq_free_running_stream_equals_jax_and_decodes(jax_runs):
    """The port's `Encoder` on config 3 as bench builds it: the same NAL
    units as the JAX `Encoder`'s, the same signalled QP map for every
    frame, and a stream the conformance decoder reconstructs bit-exactly."""
    frames, jouts, _, _, jentries = jax_runs["aq"]
    tenc = Encoder(config3_aq(), device="cpu")
    assert tenc.pps.cu_qp_delta_enabled and tenc.lookahead is not None
    assert tenc.lookahead.depth == 4 and tenc.lookahead.cutree
    tentries = []
    inner = tenc._dispatch_entry

    def dispatch(e, *a, **k):
        tentries.append(e)
        return inner(e, *a, **k)
    tenc._dispatch_entry = dispatch
    touts = list(tenc.encode_pipelined(frames, return_recon=True))
    assert [(o.stats.poc, o.stats.slice_type, o.stats.qp) for o in touts] \
        == [(o.stats.poc, o.stats.slice_type, o.stats.qp) for o in jouts]
    assert [a.nals for a in touts] == [b.nals for b in jouts]
    assert len(tentries) == len(jentries) == NF
    for a, b in zip(tentries, jentries):
        np.testing.assert_array_equal(a["qp_map"], b["qp_map"])
        np.testing.assert_allclose(a["qp_off"], b["qp_off"], rtol=0,
                                   atol=1e-5)
    decoded = decode_stream(b"".join(o.nals for o in touts))
    by_display = sorted(touts, key=lambda o: o.stats.display_order)
    assert len(decoded) == NF
    for fr, out in zip(decoded, by_display):
        assert fr.poc == out.stats.poc
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])
        np.testing.assert_array_equal(fr.cr, out.recon[2])


# ---- the slice gate and the device rule ------------------------------------------


def _fma_lanes(rng, n):
    """(d, lam, x) f32 lanes where fma(lam, x, d), the FMA XLA's CPU code
    forms, differs from d + round(lam x), the product rounded first."""
    d = rng.uniform(1e3, 1e5, 16 * n).astype(np.float32)
    lam = rng.uniform(1, 400, 16 * n).astype(np.float32)
    x = rng.uniform(8, 300, 16 * n).astype(np.float32)
    fused = (d.astype(np.float64) + lam.astype(np.float64)
             * x.astype(np.float64)).astype(np.float32)
    keep = np.nonzero(fused != d + lam * x)[0][:n]
    return d[keep], lam[keep], x[keep]


def test_b_decide_costs_pin_xla_fma():
    """The B decide body's six costs (JAX :1420-1435) on lanes with no
    neighbour, so that both merge candidates are the zero-bi fill (skip
    reads 0.5 (grid0 + grid1) at [row, sr, sr]) and both AMVP candidates
    of each list are zero: the port's `_decide_cu_b` cost rows equal, bit
    for bit, a jitted JAX function of JAX's formulas (XLA's CPU code fuses
    each product with the add after it: the decide fusion's object code
    has an FMA for the two skip costs, the three AMVP costs and the intra
    cost), and the costs with the product rounded first differ on at least
    10 lanes.  Only the formulas are jitted."""
    rng = np.random.default_rng(8)
    tree = BTreeEncoder(64, 64, search_range=4, subme=1, device="cpu")
    d, lam, x = _fma_lanes(rng, 256)
    n = d.shape[0]
    mv0 = rng.integers(-16, 17, (n, 2)).astype(np.int32)
    mv1 = rng.integers(-16, 17, (n, 2)).astype(np.int32)
    b0 = me.mvd_bits(torch.as_tensor(mv0)).numpy()
    b1 = me.mvd_bits(torch.as_tensor(mv1)).numpy()
    # the L0 cost's x is the crafted one; L1 and bi take random d, rb
    dd = np.stack([d, rng.uniform(1e3, 1e5, n), rng.uniform(1e3, 1e5, n)],
                  1).astype(np.float32)
    rb = np.stack([x - b0 - np.float32(8.0), rng.uniform(0, 300, n),
                   rng.uniform(0, 300, n)], 1).astype(np.float32)
    di = rng.uniform(1e3, 1e5, n).astype(np.float32)
    di[::17] = np.inf                      # a CU without the intra option
    g0 = rng.uniform(1e3, 1e5, (2 * 16, 9, 9)).astype(np.float32)
    g1 = rng.uniform(1e3, 1e5, (2 * 16, 9, 9)).astype(np.float32)
    row = rng.integers(0, 16, n)
    tree._grid0, tree._grid1 = torch.as_tensor(g0), torch.as_tensor(g1)
    T = torch.as_tensor
    out = tree._decide_cu_b(
        T(np.zeros((n, 4), bool)), T(np.zeros((n, 4), np.int32)),
        T(np.zeros((n, 4, 2), np.int32)), T(np.zeros((n, 4, 2), np.int32)),
        (T(dd), T(rb), T(mv0), T(mv1), T(lam), T(di)), T(row), T([16]),
        (256, 256))
    js = out[8].numpy()
    hdr = np.float32(tree._hdr_bits)

    @jax.jit
    def jax_costs(dd, rb, mv0, mv1, lamv, l0, l1, di):
        bits0 = jax_mvd_bits(mv0)
        bits1 = jax_mvd_bits(mv1)
        skip = 0.5 * (l0 + l1)
        return jnp.stack([
            skip + lamv * 2.0, skip + lamv * 3.0,
            dd[:, 0] + lamv * (rb[:, 0] + bits0 + 8.0),
            dd[:, 1] + lamv * (rb[:, 1] + bits1 + 8.0),
            dd[:, 2] + lamv * (rb[:, 2] + bits0 + bits1 + 10.0),
            di + lamv * hdr], 1)
    want = np.asarray(jax_costs(dd, rb, mv0, mv1, lam, g0[row, 4, 4],
                                g1[row, 4, 4], di))
    np.testing.assert_array_equal(js, want)
    np.testing.assert_array_equal(out[0].numpy(), np.argmin(want, 1))
    rounded = dd[:, 0] + lam * ((rb[:, 0] + b0) + np.float32(8.0))
    assert (rounded != js[:, 2]).sum() >= 10


def test_check_params_admits_the_config3_slice():
    check_params(config3(1920, 1080))
    check_params(config3_aq(w=1920, h=1080))      # as bench.py builds it
    for bf in (1, 2, 16):
        check_params(config3(bframes=bf))
        check_params(config3_aq(bframes=bf, aq_mode=1))
    check_params(config3(cutree=True))            # CU-tree on its own


@pytest.mark.parametrize("field,value", [
    ("aq_mode", 3), ("wpp", True), ("ref", 2), ("rdoq_level", 3),
    ("b_adapt", 1), ("bframes", 17), ("rc_mode", "vbr"),
    ("vbv_maxrate", 1000)])
def test_check_params_refuses_what_the_b_slice_does_not_run(field, value):
    p = config3()
    setattr(p, field, value)
    with pytest.raises(ValueError, match="not wired in this port"):
        check_params(p)


@pytest.mark.parametrize("bframes", [2, 3, 16])
def test_check_params_refuses_no_b_pyramid(bframes):
    """ROADMAP queue 3 q: the JAX gate admits ``b_pyramid=False`` with B
    frames, but the JAX package reads `b_pyramid` nowhere and codes the
    pyramid all the same; the port refuses the setting for bframes > 1
    rather than ignore it.  One B frame makes no pyramid: both gates admit
    it."""
    from x265amod_tpu.utils.params import check_params as jax_check
    kw = dict(width=W, height=H, keyint=60, ctu_size=32, sao=True,
              aq_mode=0, cutree=False, rc_lookahead=4, info=False, qp=32,
              b_pyramid=False)
    with pytest.raises(ValueError, match="--no-b-pyramid"):
        check_params(Param(bframes=bframes, **kw))
    jax_check(JaxParam(bframes=bframes, **kw))
    check_params(Param(bframes=1, **kw))
    jax_check(JaxParam(bframes=1, **kw))


@pytest.mark.parametrize("kw", [dict(keyint=1, bframes=0),
                                dict(bframes=0), dict(bframes=0, aq_mode=0)])
def test_check_params_admits_the_lookahead_without_b_frames(kw):
    """All-intra and low-delay P run a depth-1 lookahead (AQ and scene cuts,
    no CU-tree), as the reference does; tests/test_torch_ratecontrol.py
    holds their streams against the JAX Encoder's."""
    check_params(config3_aq(**kw))


def test_b_encoder_needs_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    for p in (config3(), config3_aq()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Encoder(p)
    enc = Encoder(config3(), device="cpu")
    assert enc.b_encoder.device.type == "cpu" and enc.b_encoder.sao
    assert enc.lookahead is None
    enc = Encoder(config3_aq(), device="cpu")
    assert enc.lookahead.device.type == "cpu"
