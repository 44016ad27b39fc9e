"""The port's low-delay P path (BASELINE config 2 settings: superfast, QP 32,
keyint 250, no B frames, CTU32, one reference) against the JAX package on
the CPU:

- forced decisions: the JAX P tree's decisions (split, kinds, merge
  indices, MVDs, MVP indices, intra modes) replayed by the port's
  `InterTreeEncoder.encode_async_load` give byte-identical levels, recon
  and slice payloads, for I + 2 P frames at 96x64 and 64x64, two QPs each;
- free running: the port's `Encoder` stream decodes bit-exactly with the
  JAX package's conformance decoder, and its decisions are held against
  the JAX encoder's (a decision may differ only on an f32 near-tie);
- the slice gate and the device rule for inter configs.

One JAX intra tree and one JAX P tree per size serve every test here (JAX
compiles once per tree), and the JAX `Encoder` of the free-running test
runs on them.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.inter_tree import InterTreeEncoder as JaxPTree
from x265amod_tpu.models.intra_tree import IntraTreeEncoder as JaxITree
from x265amod_tpu.utils.params import param_default_preset
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.inter_tree import InterTreeEncoder
from x265amod_tpu_torch.utils.params import check_params, param_from_dict
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)


def config2(w, h, qp=32):
    """bench.py's config 2 settings (`bench.py:68-100`) at a small size."""
    p = param_default_preset("superfast")
    p.width, p.height, p.qp = w, h, qp
    p.keyint, p.bframes, p.ctu_size = 250, 0, 32
    p.aq_mode, p.cutree, p.info = 0, False, False
    return p


_TREES = {}


def jax_trees(w, h):
    """(intra tree, P tree) of the JAX package with the settings its
    `Encoder` gives config 2, one pair per size for the module."""
    if (w, h) not in _TREES:
        _TREES[(w, h)] = (
            JaxITree(w, h, deblock=True, sign_hide=True),
            JaxPTree(w, h, deblock=True, search_range=8, subme=1,
                     sign_hide=True))
    return _TREES[(w, h)]


def host(planes):
    return tuple(np.asarray(a) for a in planes)


@pytest.mark.parametrize("w,h,qp", [(96, 64, 32), (96, 64, 24),
                                    (64, 64, 32), (64, 64, 40)])
def test_forced_decisions_byte_identical(w, h, qp):
    frames = clip(w, h, 3, seed=qp + w)
    jit, jpt = jax_trees(w, h)
    ttree = InterTreeEncoder(w, h, deblock=True, search_range=8, subme=1,
                             sign_hide=True, device="cpu")
    jenc = JaxEncoder(config2(w, h, qp))
    tenc = Encoder(param_from_dict(dataclasses.asdict(config2(w, h, qp))),
                   device="cpu")
    ires = jit.collect(jit.encode_async(*frames[0], qp - 3, want_recon=True),
                       want_recon=True)
    ref = (ires.recon_y, ires.recon_cb, ires.recon_cr)
    kinds_seen = set()
    for y, cb, cr in frames[1:]:
        jres = jpt.collect(jpt.encode_async(
            y, cb, cr, tuple(jnp.asarray(a) for a in ref), qp))
        jrec = host(jres.recon_dev)
        tres = ttree.collect(ttree.encode_async_load(
            y, cb, cr, tuple(torch.as_tensor(a) for a in ref), qp,
            jres.split, jres.kinds, jres.merge_idx, jres.mvd, jres.mvp_idx,
            jres.modes, want_recon=True))
        for name in ("split", "kinds", "merge_idx", "mvd", "mvp_idx",
                     "modes", "levels_y", "levels_cb", "levels_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name), name)
        for got, want in zip((tres.recon_y, tres.recon_cb, tres.recon_cr),
                             jrec):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        assert tenc._cabac_inter_tree(tres, qp) == \
            jenc._cabac_inter_tree(jres, qp)
        kinds_seen |= set(np.unique(jres.kinds).tolist())
        ref = jrec
    assert len(kinds_seen) >= 2          # the replay meets several kinds


def test_free_running_parity_and_decode():
    """I + 3 P frames through `Encoder(param, device="cpu")` and the JAX
    `Encoder`: identical NAL units frame by frame unless a decision
    differs on an f32 near-tie; the port's stream decodes to its recon."""
    w, h, nf = 96, 64, 4
    frames = clip(w, h, nf, seed=2)
    p = config2(w, h)
    jenc = JaxEncoder(p.copy())
    jenc.frame_encoder, jenc.inter_encoder = jax_trees(w, h)
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    jouts = [o for f in frames for o in jenc.encode_push(*f)] + jenc.flush()
    touts = list(tenc.encode_pipelined(frames, return_recon=True))
    assert [o.stats.slice_type for o in touts] == ["I", "P", "P", "P"]
    assert [o.stats.qp for o in touts] == [o.stats.qp for o in jouts] \
        == [29, 32, 32, 32]

    # decisions, P frame by P frame, on the same reference
    _, jpt = jax_trees(w, h)
    ttree = tenc.inter_encoder
    ref = touts[0].recon
    agree = []
    for i in range(1, nf):
        pads = frames[i]
        jres = jpt.collect(jpt.encode_async(
            *pads, tuple(jnp.asarray(a) for a in ref), 32))
        handle = ttree.encode_async(*pads, tuple(torch.as_tensor(a)
                                                 for a in ref), 32,
                                    want_costs=True)
        costs = handle["costs"]
        tres = ttree.collect(handle)
        same = ((tres.kinds == jres.kinds) & (tres.merge_idx ==
                                              jres.merge_idx)
                & (tres.mvd == jres.mvd).all(-1)
                & (tres.mvp_idx == jres.mvp_idx))
        agree.append(float(same.mean()))
        if not same.all() or (tres.split != jres.split).any():
            # a decision may differ only on a near-tie of the f32 costs
            js = torch.sort(costs["jsq"], -1).values.numpy()
            rel = (js[:, 1] - js[:, 0]) / np.maximum(np.abs(js[:, 0]), 1e-9)
            assert (rel.reshape(same.shape)[~same] < 1e-5).all()
            gap = np.abs(costs["jsplit"] - costs["j32"]).numpy() / \
                np.maximum(np.abs(costs["j32"].numpy()), 1e-9)
            assert (gap.reshape(tres.split.shape)[
                tres.split != jres.split] < 1e-5).all()
        else:
            assert touts[i].nals == jouts[i].nals
        ref = touts[i].recon
    assert touts[0].nals == jouts[0].nals
    print("decision agreement per P frame:", agree)

    decoded = decode_stream(b"".join(o.nals for o in touts))
    assert len(decoded) == nf
    for fr, out in zip(decoded, touts):
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])
        np.testing.assert_array_equal(fr.cr, out.recon[2])


def test_encode_frame_and_push_match_the_pipeline():
    """encode_frame / encode_push + flush give the same stream as
    encode_pipelined (the per-frame path on the CPU at 64x32)."""
    w, h = 64, 32
    frames = clip(w, h, 3, seed=11)
    p = param_from_dict(dataclasses.asdict(config2(w, h)))
    a = Encoder(p.copy(), device="cpu")
    b = Encoder(p.copy(), device="cpu")
    piped = [o.nals for o in a.encode_pipelined(frames)]
    pushed = [b.encode_frame(*frames[0]).nals] + \
        [o.nals for f in frames[1:] for o in b.encode_push(*f)] + \
        [o.nals for o in b.flush()]
    assert piped == pushed
    assert a.summary()["frames"] == b.summary()["frames"] == 3


@pytest.mark.parametrize("field,value", [
    ("bframes", 17), ("ref", 2), ("me_range", 2), ("b_adapt", 1),
    ("aq_mode", 3), ("rdoq_level", 3), ("internal_bit_depth", 10),
    ("rc_mode", "vbr"), ("wpp", True),
    ("qpfile", "q.txt"), ("analysis_load", "a.dat"),
    ("decoded_picture_hash", 1)])
def test_check_params_refuses_what_the_p_slice_does_not_run(field, value):
    p = param_from_dict(dataclasses.asdict(config2(64, 64)))
    check_params(p)
    setattr(p, field, value)
    with pytest.raises(ValueError, match="not wired in this port"):
        check_params(p)


def test_inter_encoder_needs_a_card_unless_asked_for_the_cpu():
    p = param_from_dict(dataclasses.asdict(config2(64, 64)))
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(p)
    enc = Encoder(p, device="cpu")
    assert enc.inter_encoder.device.type == "cpu"
