"""Multi-reference P (`--ref 2..4`, low-delay, CTU32) in the port against the
JAX package on the CPU:

- the tables: `ref_idx_bins` and the dsf matrix of a list for R = 1..4,
  repeated POCs (the cyclic fill) included; exact;
- the gate: the port admits `ref` exactly where JAX does for CTU32, over
  ref 1..5 x bframes 0/3 x ctu 16/32 (CTU16 the port refuses whatever the
  ref);
- the f32 order of the costs: `pick_ref` and the decide costs on crafted
  near-ties, held bit for bit against jitted JAX functions of the same
  formulas (XLA's CPU code contracts each product whose one use is the add
  into an FMA, as in the decide body's optimized HLO and LLVM IR), with
  ties where the product rounded before the add would decide otherwise;
- forced decisions: the JAX P tree's decisions at R = 2 and R = 4 (kinds,
  merge index, MVD, MVP index, reference per cell) replayed through
  `InterTreeEncoder.encode_async_load` give byte-identical levels, recon
  and slice payloads; exact;
- free running: `Encoder(param, device="cpu")` at 96x64 on the period-2
  flicker clip of `tests/test_multiref.py` gives the JAX `Encoder`'s stream
  NAL for NAL at ref 2 and 4, decoded bit-exactly by the JAX package's
  decoder, with the same share of inter cells on an older reference as
  JAX, above 25 %; the slice headers parse back to the active count and
  the inline RPS of the last R anchors;
- bS on reference indices (ROADMAP queue 3 o): two inter cells on indices
  that name the same picture get bS 1, in the port as in JAX;
- the half-pel plane once a reference picture (the DPB's `RefPicture`),
  on the port alone: K8's calls counted, the stream equal to the run
  without the cache, no plane outliving its DPB entry.

One module fixture runs the JAX `Encoder` once per R on one JAX intra tree
and one JAX P tree per R (about 60 s of JAX compiles), and records every
P frame's inputs and results; the tests reuse them.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from x265amod_tpu.bitstream.bitio import BitReader
from x265amod_tpu.bitstream.nal import split_annexb
from x265amod_tpu.models import mvpred as jmvpred
from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.inter_frame import _mvd_bits as jax_mvd_bits
from x265amod_tpu.models.inter_tree import InterTreeEncoder as JaxPTree
from x265amod_tpu.models.intra_tree import IntraTreeEncoder as JaxITree
from x265amod_tpu.ops.deblock import bs_maps as jax_bs_maps
from x265amod_tpu.utils.params import Param as JaxParam
from x265amod_tpu.utils.params import check_params as jax_check_params
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models import mvpred
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.inter_tree import InterTreeEncoder
from x265amod_tpu_torch.ops.deblock import inter_tree_bs_maps
from x265amod_tpu_torch.ops.me import mvd_bits, pick_ref_plain
from x265amod_tpu_torch.utils.params import check_params, param_from_dict
from test_multiref import _flicker_frames
from test_torch_slice import yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

W, H, NF = 96, 64, 8


def _param(ref, w=W, h=H):
    return JaxParam(width=w, height=h, qp=30, keyint=250, bframes=0,
                    ctu_size=32, ref=ref, aq_mode=0, cutree=False,
                    info=False)


@pytest.fixture(scope="module")
def jax_runs():
    """Per R in (2, 4): the JAX `Encoder`'s NAL units on the flicker clip,
    and per P frame its padded planes, the L0 list (host planes, POCs), the
    picture's POC and QP, and the JAX P tree's result."""
    frames = _flicker_frames(W, H, NF)
    itree = JaxITree(W, H, deblock=True, sign_hide=True)
    runs = {}
    for nr in (2, 4):
        jenc = JaxEncoder(_param(nr))
        ptree = JaxPTree(W, H, deblock=True, search_range=jenc.param.me_range,
                         subme=jenc.param.subme, sign_hide=True)
        jenc.frame_encoder, jenc.inter_encoder = itree, ptree
        calls = []
        encode_async, collect = ptree.encode_async, ptree.collect

        def spy_encode(y, cb, cr, ref_dev, qp, **kw):
            calls.append(dict(planes=(y, cb, cr), qp=qp, refs=[
                tuple(np.asarray(a) for a in r) for r in ref_dev],
                ref_pocs=kw["ref_pocs"], poc=kw["poc"]))
            return encode_async(y, cb, cr, ref_dev, qp, **kw)

        def spy_collect(outs, want_recon=False):
            res = collect(outs, want_recon)
            calls[len([c for c in calls if "res" in c])]["res"] = res
            return res
        ptree.encode_async, ptree.collect = spy_encode, spy_collect
        outs = [o for f in frames for o in jenc.encode_push(*f)] + \
            jenc.flush()
        del ptree.encode_async, ptree.collect
        runs[nr] = dict(nals=[o.nals for o in outs], calls=calls,
                        frames=frames, enc=jenc)
    return runs


# ---- tables, gate ------------------------------------------------------------

@pytest.mark.parametrize("nr", [1, 2, 3, 4])
def test_ref_idx_bins_and_dsf_matrix(nr):
    """Bins of every index and the dsf matrix of lists with distinct and
    with repeated POCs (the cyclic fill while fewer anchors exist), built as
    JAX's `encode_async` builds them (:1087-1101)."""
    for idx in range(nr):
        assert mvpred.ref_idx_bins(idx, nr) == jmvpred.ref_idx_bins(idx, nr)
    poc = 9
    for anchors in ([8, 7, 6, 5], [8], [8, 7], [8, 2, 1]):
        pocs = [anchors[i % len(anchors)] for i in range(nr)]
        dsf, bits = mvpred.ref_list_tables(poc, pocs)
        want = np.array([[jmvpred.dist_scale_factor(poc, pocs[i], pocs[j])
                          for i in range(nr)] for j in range(nr)], np.int32)
        np.testing.assert_array_equal(dsf, want)
        assert dsf.dtype == np.int32 and bits.dtype == np.float32
        np.testing.assert_array_equal(bits, [jmvpred.ref_idx_bins(r, nr)
                                             for r in range(nr)])
        # a repeated picture scales by the identity
        for j in range(nr):
            for i in range(nr):
                if pocs[i] == pocs[j]:
                    assert dsf[j, i] == 256


@pytest.mark.parametrize("ref", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("bframes", [0, 3])
@pytest.mark.parametrize("ctu", [16, 32])
def test_gate_admits_ref_where_jax_does(ref, bframes, ctu):
    p = JaxParam(width=64, height=64, ref=ref, bframes=bframes,
                 ctu_size=ctu, keyint=250, aq_mode=0, cutree=False)

    def admits(fn, param):
        try:
            fn(param)
            return True
        except ValueError:
            return False
    jax_ok = admits(jax_check_params, p)
    port_ok = admits(check_params, param_from_dict(dataclasses.asdict(p)))
    if ctu == 32:
        assert port_ok == jax_ok == (ref == 1 or (ref <= 4 and bframes == 0))
    else:
        # the flat CTB16 P and B frames take one reference per list
        assert port_ok == jax_ok == (ref == 1)


def test_all_intra_admits_and_ignores_ref():
    """keyint 1 with ref 2 and no B frames: admitted, one reference (JAX
    :183-185)."""
    p = _param(2)
    p.keyint, p.bframes = 1, 0
    jax_check_params(p)
    enc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    assert enc.num_ref_p == 1 and enc.inter_encoder is None


# ---- f32 order ---------------------------------------------------------------

def _fma_lanes(rng, n):
    """(d, lam, x, d + round(lam x)) f32 lanes where fma(lam, x, d), the FMA
    XLA's CPU code forms, lies above d + round(lam x), the product rounded
    first."""
    d = rng.uniform(1e3, 1e5, 8 * n).astype(np.float32)
    lam = rng.uniform(1, 400, 8 * n).astype(np.float32)
    x = rng.uniform(8, 300, 8 * n).astype(np.float32)
    fused = (d.astype(np.float64) + lam.astype(np.float64)
             * x.astype(np.float64)).astype(np.float32)
    plain = d + lam * x
    keep = np.nonzero(fused > plain)[0][:n]
    return d[keep], lam[keep], x[keep], plain[keep]


def test_pick_ref_order_pins_xla_fma():
    """pick_ref's j = d + lam ((rb + mvd_bits(mv)) + refbits) at R = 2:
    reference 1 costs exactly reference 0's j with the product rounded
    first, so the FMA (XLA's order, and the port's) picks reference 1 and
    the rounded form would keep reference 0 on the tie."""
    rng = np.random.default_rng(3)
    d, lam, x, plain = _fma_lanes(rng, 64)
    rb0 = x - np.float32(2.0)                 # mvd_bits of MV 0 is 2
    ok = (rb0 + np.float32(2.0)) + np.float32(0.0) == x
    d, lam, rb0, plain = d[ok], lam[ok], rb0[ok], plain[ok]
    n = d.shape[0]
    assert n >= 32
    # reference 1: rb + bits + refbits = -3 + 2 + 1 = 0, so j_1 = d_1
    d2 = np.stack([d, plain], 1)
    rb2 = np.stack([rb0, np.full(n, -3.0, np.float32)], 1)
    mv = np.zeros((n, 2, 2), np.int32)
    refbits = np.array([0.0, 1.0], np.float32)

    @jax.jit
    def jax_pick(d, rb, mv, lam, refbits):
        j = jnp.stack([d[:, r] + lam * (rb[:, r] + jax_mvd_bits(mv[:, r])
                                         + refbits[r]) for r in range(2)], 1)
        return jnp.argmin(j, 1)
    want = np.asarray(jax_pick(d2, rb2, mv, lam, refbits))
    best, dsel, _, _ = pick_ref_plain(
        *(torch.as_tensor(a) for a in (d2, rb2, mv, lam, refbits)))
    np.testing.assert_array_equal(best.numpy(), want)
    assert (want == 1).all()
    np.testing.assert_array_equal(dsel.numpy(), plain)


def test_decide_costs_pin_xla_fma():
    """The decide body's costs (JAX :413-432) on lanes with no neighbour,
    so that every merge and AMVP candidate is zero and the skip costs read
    grid[row, sr, sr]: the port's `_decide_cu` cost rows equal, bit for
    bit, a jitted JAX function of JAX's formulas, and the inter cost with
    the product rounded first differs on some of them."""
    rng = np.random.default_rng(5)
    tree = InterTreeEncoder(64, 64, search_range=4, subme=1, device="cpu")
    d, lam, x, _ = _fma_lanes(rng, 256)
    n = d.shape[0]
    rbd = (x - np.float32(20.0)).astype(np.float32)
    di = rng.uniform(1e3, 1e5, n).astype(np.float32)
    grid = rng.uniform(1e3, 1e5, (2 * 2 * 16, 9, 9)).astype(np.float32)
    refme = rng.integers(0, 2, n).astype(np.int32)
    mvme = rng.integers(-16, 17, (n, 2)).astype(np.int32)
    row = rng.integers(0, 16, n)
    dsf, bits = mvpred.ref_list_tables(5, [4, 3])
    tree._grid = torch.as_tensor(grid)
    T = torch.as_tensor
    out = tree._decide_cu(
        T(np.zeros((n, 4), bool)), T(np.zeros((n, 4, 2), np.int32)),
        T(np.zeros((n, 4), np.int32)), T(d), T(rbd), T(mvme), T(refme),
        T(lam), T(di), T(row), T([16]), (T(dsf), T(bits)))
    js = out[5].numpy()
    hdr = np.float32(tree._hdr_bits)

    @jax.jit
    def jax_costs(dd, lam, rbd, mvme, rr, look, di):
        m = jnp.minimum(jax_mvd_bits(mvme), jax_mvd_bits(mvme))
        j_inter = dd + lam * (rbd + m + rr + 6.0)
        return jnp.stack([look + lam * 2.0, look + lam * 3.0, j_inter,
                          di + lam * hdr], 1)
    look = grid[row, 4, 4]
    want = np.asarray(jax_costs(d, lam, rbd, mvme, bits[refme], look, di))
    np.testing.assert_array_equal(js, want)
    np.testing.assert_array_equal(out[0].numpy(), np.argmin(want, 1))
    m = mvd_bits(T(mvme)).numpy()
    rounded = d + lam * (((rbd + m) + bits[refme]) + np.float32(6.0))
    assert (rounded != js[:, 2]).sum() >= 10


def test_mvd_bits_of_absolute_mvs_match_jax():
    """pick_ref prices mvd_bits of the absolute MV: over the MVs the trials
    can produce (+-4 (sr + 2), sr up to 32) the port's bins equal JAX's."""
    v = np.arange(-136, 137, dtype=np.int32)
    mv = np.stack(np.meshgrid(v, v), -1).reshape(-1, 2)
    np.testing.assert_array_equal(
        mvd_bits(torch.as_tensor(mv)).numpy(),
        np.asarray(jax_mvd_bits(jnp.asarray(mv))))


# ---- forced decisions and free running ----------------------------------------

def _slices(stream):
    """(poc, [(dist, used)], num_ref_idx_l0_active) of every P slice."""
    out = []
    for nal_type, _, rbsp in split_annexb(stream):
        if nal_type not in (0, 1):             # TRAIL_N, TRAIL_R
            continue
        r = BitReader(rbsp)
        assert r.read_flag() == 1 and r.read_ue() == 0
        assert r.read_ue() == 1                # P
        poc = r.read(8)
        assert r.read_flag() == 0              # inline RPS
        nneg, npos = r.read_ue(), r.read_ue()
        neg, prev = [], 0
        for _ in range(nneg):
            prev += r.read_ue() + 1
            neg.append((prev, r.read_flag()))
        assert npos == 0
        active = r.read_ue() + 1 if r.read_flag() else 1
        out.append((poc, neg, active))
    return out


@pytest.mark.parametrize("nr", [2, 4])
def test_forced_decisions_byte_identical(jax_runs, nr):
    run = jax_runs[nr]
    jenc = run["enc"]
    ttree = InterTreeEncoder(W, H, search_range=jenc.param.me_range,
                             subme=jenc.param.subme, device="cpu")
    tenc = Encoder(param_from_dict(dataclasses.asdict(_param(nr))),
                   device="cpu")
    refs_seen = set()
    for c in run["calls"]:
        jres = c["res"]
        tres = ttree.collect(ttree.encode_async_load(
            *c["planes"], [tuple(torch.as_tensor(a) for a in r)
                           for r in c["refs"]], c["qp"], jres.split,
            jres.kinds, jres.merge_idx, jres.mvd, jres.mvp_idx, jres.modes,
            want_recon=True, ref_idx=jres.ref0, ref_pocs=c["ref_pocs"],
            poc=c["poc"]))
        for name in ("split", "kinds", "merge_idx", "mvd", "mvp_idx",
                     "modes", "ref0", "levels_y", "levels_cb", "levels_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name), name)
        for got, want in zip((tres.recon_y, tres.recon_cb, tres.recon_cr),
                             jres.recon_dev):
            np.testing.assert_array_equal(got, np.asarray(want))
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        assert tenc._cabac_inter_tree(tres, c["qp"]) == \
            jenc._cabac_inter_tree(jres, c["qp"])
        inter = jres.kinds <= 1
        refs_seen |= set(np.unique(jres.ref0[inter]).tolist())
    assert len(run["calls"]) == NF - 1
    assert refs_seen >= {0, 1}


@pytest.mark.parametrize("nr", [2, 4])
def test_free_running_stream_equals_jax_and_decodes(jax_runs, nr):
    run = jax_runs[nr]
    tenc = Encoder(param_from_dict(dataclasses.asdict(_param(nr))),
                   device="cpu")
    results = []
    collect = tenc.inter_encoder.collect

    def spy(handle):
        results.append(collect(handle))
        return results[-1]
    tenc.inter_encoder.collect = spy
    touts = [o for f in run["frames"] for o in tenc.encode_push(
        *f, return_recon=True)] + tenc.flush(return_recon=True)
    assert [o.nals for o in touts] == run["nals"]
    decoded = decode_stream(b"".join(o.nals for o in touts))
    assert len(decoded) == NF
    for fr, out in zip(decoded, touts):
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])
        np.testing.assert_array_equal(fr.cr, out.recon[2])

    def older_share(res_list):
        inter = older = 0
        for res in res_list[1:]:                  # P frames from POC 2 on
            m = res.kinds <= 1
            inter += int(m.sum())
            older += int((res.ref0[m] >= 1).sum())
        return older / inter
    share = older_share(results)
    assert share == older_share([c["res"] for c in run["calls"]])
    assert share > 0.25, share
    # the slice headers: R active references once the DPB holds them (the
    # list is filled cyclically before), the RPS the last R anchors
    for poc, neg, active in _slices(b"".join(run["nals"])):
        assert active == nr
        assert neg == [(k, 1) for k in range(1, min(poc, nr) + 1)]


def test_bs_compares_reference_indices_not_pictures():
    """Two inter cells with equal MVs and no residual, on L0 indices 0 and
    2 of a cyclic-filled list [p, q, p]: the same picture.  Spec 8.7.2.4
    compares the pictures (bS 0); JAX compares the indices (bS 1), and its
    decoder does the same, so the port copies it (ROADMAP queue 3 o)."""
    intra = np.zeros((2, 2), bool)
    cbf = np.zeros((2, 2), bool)
    dirs = np.ones((2, 2), np.int32)
    mv0 = np.zeros((2, 2, 2), np.int32)
    ref0 = np.array([[0, 2], [0, 2]], np.int32)
    jv, _ = jax_bs_maps(intra, cbf, dirs, mv0, mv0.copy(), xp=np, ref0=ref0)
    tv, _ = inter_tree_bs_maps(*(torch.as_tensor(a)[None] for a in (
        intra, cbf, dirs, mv0, mv0)), torch.ones((1, 1, 1), dtype=bool),
        torch.as_tensor(ref0)[None])
    assert (jv == 1).all()
    np.testing.assert_array_equal(tv[0].numpy(), jv)


# ---- the half-pel plane, once a reference picture ---------------------------

def _hpel_run(param, frames, cache=True):
    """The port's stream of ``frames`` under ``param`` on the CPU, with K8's
    calls counted (the tree's `hpel_plane` wrapped): their number, the NAL
    units, and after each push the planes still alive that no DPB entry
    holds (freed by reference counts, no garbage collection).  With
    ``cache`` False every motion search makes its own plane
    (`RefPicture.hpel_of` bypassed)."""
    import weakref

    from x265amod_tpu_torch.models import inter_tree
    made = []
    real = inter_tree.hpel_plane

    def counted(ref):
        out = real(ref)
        made.append(weakref.ref(out))
        return out
    saved = inter_tree.hpel_plane, inter_tree.RefPicture.hpel_of
    inter_tree.hpel_plane = counted
    if not cache:
        inter_tree.RefPicture.hpel_of = lambda self, ref_y: counted(ref_y)
    try:
        enc = Encoder(param, device="cpu")
        nals, stray = [], []
        for f in frames:
            nals += [o.nals for o in enc.encode_push(*f)]
            kept = {id(p.hpel) for p in enc._dpb.values()}
            stray += [r for r in made if r() is not None
                      and id(r()) not in kept]
        nals += [o.nals for o in enc.flush()]
    finally:
        inter_tree.hpel_plane, inter_tree.RefPicture.hpel_of = saved
    return len(made), nals, stray


@pytest.mark.parametrize("gop", ["p_ref3", "mini_gop"])
def test_hpel_plane_once_a_reference_picture(gop):
    """K8 runs once a reference picture while the DPB keeps it, at 64x64:
    three P frames at `--ref 3` (the list filled cyclically from one
    picture, then two, then three) make 3 planes, not 9; an IDR and a
    mini-GOP (P + 3 B, the pyramid's middle B referenced) make 3 (I0, P4,
    B2), not 7; the stream equals the same run with the cache off, and no
    plane outlives its picture's DPB entry."""
    if gop == "p_ref3":
        param = param_from_dict(dataclasses.asdict(_param(3, 64, 64)))
        frames, want = _flicker_frames(64, 64, 4), (3, 9)
    else:
        param = param_from_dict(dict(dataclasses.asdict(_param(1, 64, 64)),
                                     bframes=3, sao=True))
        frames, want = _flicker_frames(64, 64, 5), (3, 7)
    n, nals, stray = _hpel_run(param, frames)
    n_off, nals_off, _ = _hpel_run(param, frames, cache=False)
    assert (n, n_off) == want
    assert nals == nals_off
    assert not stray
