"""Rate control beyond CQP in the port (CRF, ABR, VBV with its HRD
signalling, 2-pass) against the JAX package on the CPU:

- the port's `RateControl` against the JAX one on scripted call sequences:
  every mode and slice type, the SATD feed, VBV with a tight buffer, and
  2-pass from a written stats file.  The QPs are equal and the state agrees
  to the last bit (no compile needed);
- the two parameter gates over a grid of settings: where the port admits a
  setting, the JAX package admits it too, and where the JAX package refuses
  one, the port refuses it too;
- free-running streams of the port's `Encoder(param, device="cpu")` against
  the JAX `Encoder` at 96x64, CTU32, byte for byte, and decoded with the
  JAX package's conformance decoder: ABR with AQ on low-delay P (through
  `encode_push` and through `encode_pipelined`, whose orders of rate-control
  calls differ), VBV with HRD SEI, CRF all-intra with AQ, and 2-pass.

One JAX intra tree and one JAX P tree serve every JAX `Encoder` here (the
settings of preset superfast at 96x64, which all four streams share), so
JAX compiles once.
"""

import dataclasses
import itertools
import zlib

import numpy as np
import pytest
import torch

from x265amod_tpu.models import ratecontrol as jrc
from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.utils import params as jparams
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models import ratecontrol as trc
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.utils import params as tparams
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

W, H = 96, 64


# ---- RateControl on scripted call sequences ---------------------------------


def _state(rc) -> dict:
    """Every attribute of a RateControl but its Param, the VBV predictors
    as their own attributes; floats compared bit for bit."""
    out = {k: v for k, v in vars(rc).items() if k not in ("param", "pred")}
    if hasattr(rc, "pred"):
        out["pred"] = {t: vars(p) for t, p in rc.pred.items()}
    return out


def _script(seed: int, n: int, types: str):
    """(slice type, bits, lookahead SATD or None) per frame, from a seed:
    types cycled, bits and SATD spread over two decades."""
    rng = np.random.default_rng(seed)
    return [(types[i % len(types)],
             int(rng.integers(2_000, 200_000)),
             None if rng.random() < 0.2 else float(rng.uniform(1e3, 1e5)))
            for i in range(n)]


def _drive(rc, script, lag: int):
    """frame_qp / set_complexity / update in the encoder's orders: lag 0 is
    `encode_push` (each frame updated before the next one's QP), lag 1 is
    `encode_pipelined` (frame n's QP before frame n-1's update)."""
    qps, pending = [], []
    for st, bits, satd in script:
        rc.set_complexity(satd)
        qp = rc.frame_qp(st)
        qps.append(qp)
        pending.append((bits, st, qp))
        while len(pending) > lag:
            rc.update(*pending.pop(0))
    for args in pending:
        rc.update(*args)
    return qps


RC_CASES = {
    "cqp": dict(qp=30),
    "crf": dict(rc_mode="crf", crf=23.5),
    "abr": dict(rc_mode="abr", bitrate=800),
    "abr_bitrate_only": dict(bitrate=2500, qp_step=2),
    "vbv_cqp_tight": dict(qp=20, vbv_maxrate=400, vbv_bufsize=200,
                          vbv_init=0.5),
    "vbv_abr_tight": dict(rc_mode="abr", bitrate=600, vbv_maxrate=600,
                          vbv_bufsize=300),
    "vbv_crf": dict(rc_mode="crf", crf=18, vbv_maxrate=1500,
                    vbv_bufsize=3000),
    "pass1": dict(rc_mode="abr", bitrate=900, pass_num=1),
}


@pytest.mark.parametrize("types", ["IPPPPPP", "IPBbbPBbbPBbbI", "IIII"])
@pytest.mark.parametrize("case", sorted(RC_CASES))
@pytest.mark.parametrize("lag", [0, 1])
def test_rate_control_equals_the_jax_packages(case, types, lag, tmp_path):
    kw = dict(RC_CASES[case], width=1280, height=720, fps_num=30)
    stats = str(tmp_path / "stats.log")
    if kw.get("pass_num"):
        kw["stats_file"] = stats
    j = jrc.RateControl(jparams.Param(**kw))
    t = trc.RateControl(tparams.Param(**kw))
    script = _script(zlib.crc32(f"{case}{types}".encode()), 40, types)
    assert _drive(t, script, lag) == _drive(j, script, lag)
    assert _state(t) == _state(j)
    assert t.summary() == j.summary()
    if kw.get("pass_num"):
        j.write_stats()
        jtext = open(stats).read()
        t.write_stats()
        assert open(stats).read() == jtext


@pytest.mark.parametrize("lag", [0, 1])
@pytest.mark.parametrize("bitrate", [300, 3000])
def test_two_pass_plan_equals_the_jax_packages(tmp_path, lag, bitrate):
    """Pass 2 from a pass-1 stats file: the same plan, QPs and state."""
    stats = str(tmp_path / "stats.log")
    kw = dict(width=640, height=360, rc_mode="abr", bitrate=bitrate,
              stats_file=stats)
    p1 = trc.RateControl(tparams.Param(pass_num=1, **kw))
    script = _script(7, 30, "IPBbbPBbbP")
    _drive(p1, script, lag)
    p1.write_stats()
    j = jrc.RateControl(jparams.Param(pass_num=2, **kw))
    t = trc.RateControl(tparams.Param(pass_num=2, **kw))
    assert t._plan == j._plan
    script2 = [(st, int(b * 0.8), s) for st, b, s in script]
    assert _drive(t, script2, lag) == _drive(j, script2, lag)
    assert _state(t) == _state(j)


def test_conversions_equal_the_jax_packages():
    for qp in np.linspace(-5, 60, 131):
        assert trc.qp_to_qscale(qp) == jrc.qp_to_qscale(qp)
        qs = jrc.qp_to_qscale(qp)
        assert trc.qscale_to_qp(qs) == jrc.qscale_to_qp(qs)


# ---- the two gates ----------------------------------------------------------

GRID = dict(
    keyint=[1, 250], bframes=[0, 3], aq_mode=[0, 2], cutree=[False, True],
    rc=["cqp", "crf", "abr", "abr0", "vbv", "vbv_half", "hrd", "hrd_only",
        "pass1", "pass2", "pass2_nobitrate", "rcx"],
    bit_depth=[8, 10],
    me_range=[3, 8, 33],
    subme=[-1, 2, 8],
    rc_lookahead=[20, 251],
)

_RC = {
    "cqp": {}, "crf": dict(rc_mode="crf", crf=23.0),
    "abr": dict(rc_mode="abr", bitrate=1000),
    "abr0": dict(rc_mode="abr"),
    "vbv": dict(bitrate=1000, vbv_maxrate=1000, vbv_bufsize=2000),
    "vbv_half": dict(vbv_maxrate=1000),
    "hrd": dict(bitrate=1000, vbv_maxrate=1000, vbv_bufsize=2000, hrd=True),
    "hrd_only": dict(hrd=True),
    "pass1": dict(bitrate=1000, pass_num=1),
    "pass2": dict(bitrate=1000, pass_num=2),
    "pass2_nobitrate": dict(pass_num=2),
    "rcx": dict(rc_mode="vbr"),
}


def _gate(mod, d):
    try:
        mod.check_params(mod.Param(**d))
        return True
    except ValueError:
        return False


def _grid():
    keys = list(GRID)
    for vals in itertools.product(*(GRID[k] for k in keys)):
        c = dict(zip(keys, vals))
        d = dict(width=96, height=64, ctu_size=32, keyint=c["keyint"],
                 bframes=c["bframes"], aq_mode=c["aq_mode"],
                 cutree=c["cutree"], internal_bit_depth=c["bit_depth"],
                 me_range=c["me_range"], subme=c["subme"],
                 rc_lookahead=c["rc_lookahead"], **_RC[c["rc"]])
        if c["bit_depth"] == 10:
            d.update(deblock=False, sao=False)
        yield d


def test_the_port_gate_refuses_whatever_the_jax_gate_refuses():
    """Over 6912 settings: port admits => JAX admits.  The three settings
    the port used to admit (subme outside 0..7, a lookahead deeper than
    250, me_range outside 4..32 on all-intra) are in the grid, and so is
    every rate-control setting this slice admits."""
    admitted = refused_by_both = 0
    for d in _grid():
        t, j = _gate(tparams, d), _gate(jparams, d)
        assert j or not t, d
        admitted += t
        refused_by_both += not t and not j
    assert admitted > 100 and refused_by_both > 1000


@pytest.mark.parametrize("kw", [dict(subme=8), dict(subme=-1),
                                dict(rc_lookahead=251),
                                dict(keyint=1, me_range=3),
                                dict(keyint=1, me_range=33),
                                dict(hrd=True)])
def test_the_port_refuses_what_the_jax_package_refuses(kw):
    d = dict(width=96, height=64, ctu_size=32, **kw)
    with pytest.raises(ValueError):
        jparams.check_params(jparams.Param(**d))
    with pytest.raises(ValueError):
        tparams.check_params(tparams.Param(**d))


@pytest.mark.parametrize("rc", ["crf", "abr", "vbv", "hrd", "pass1", "pass2"])
@pytest.mark.parametrize("keyint,bframes,aq", [(1, 0, 2), (250, 0, 2),
                                               (250, 3, 2), (250, 0, 0)])
def test_the_port_admits_rate_control_and_the_shallow_lookahead(
        rc, keyint, bframes, aq):
    """param_from_dict carries a JAX Param with ABR, VBV and 2-pass fields
    across; both gates admit it."""
    jp = jparams.Param(width=1280, height=720, ctu_size=32, keyint=keyint,
                       bframes=bframes, aq_mode=aq, cutree=aq > 0,
                       **_RC[rc])
    jparams.check_params(jp)
    tp = tparams.param_from_dict(dataclasses.asdict(jp))
    tparams.check_params(tp)
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)


def test_param_parse_equals_the_jax_packages():
    opts = [("bitrate", "2400"), ("vbv-maxrate", "2400"),
            ("vbv-bufsize", "4800"), ("hrd", None), ("ctu", "32"),
            ("bframes", "0"), ("no-sao", None), ("merange", "24"),
            ("fps", "30000/1001"), ("input-res", "640x360"),
            ("aq-mode", "1"), ("pass", "2"), ("stats", "s.log")]
    j, t = jparams.Param(), tparams.Param()
    for name, value in opts:
        jparams.param_parse(j, name, value)
        tparams.param_parse(t, name, value)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    with pytest.raises(ValueError, match="unknown option"):
        tparams.param_parse(t, "no-such-option", "1")


def test_main10_with_rate_control_stays_refused():
    d = dict(width=96, height=64, ctu_size=32, keyint=1, deblock=False,
             internal_bit_depth=10)
    tparams.check_params(tparams.Param(**d))
    for rc in ("crf", "abr", "vbv", "pass1"):
        with pytest.raises(ValueError, match="not wired in this port"):
            tparams.check_params(tparams.Param(**d, **_RC[rc]))


# ---- free-running streams against the JAX Encoder ---------------------------


def superfast(**kw):
    """Low-delay P at 96x64 (preset superfast: AQ 2, CU-tree, me_range 8,
    subme 1), CTU32, info SEI off; kw overrides."""
    p = jparams.param_default_preset("superfast")
    p.width, p.height, p.ctu_size, p.info = W, H, 32, False
    p.keyint, p.bframes = 250, 0
    for k, v in kw.items():
        setattr(p, k, v)
    return p


@pytest.fixture(scope="module")
def jax_trees():
    """The JAX intra and P trees every JAX Encoder of this module runs on."""
    enc = JaxEncoder(superfast())
    return enc.frame_encoder, enc.inter_encoder


def run_jax(trees, p, frames, pipelined):
    enc = JaxEncoder(p.copy())
    enc.frame_encoder = trees[0]
    if enc.inter_encoder is not None:
        enc.inter_encoder = trees[1]
    if pipelined:
        outs = list(enc.encode_pipelined(frames))
    else:
        outs = [o for f in frames for o in enc.encode_push(*f)] + enc.flush()
    enc.close()
    return enc, outs


def run_port(p, frames, pipelined, return_recon=False):
    enc = Encoder(tparams.param_from_dict(dataclasses.asdict(p)),
                  device="cpu")
    if pipelined:
        outs = list(enc.encode_pipelined(frames, return_recon=return_recon))
    else:
        outs = [o for f in frames for o in enc.encode_push(
            *f, return_recon=return_recon)] + enc.flush(return_recon)
    enc.close()
    return enc, outs


def assert_same_stream(touts, jouts):
    assert [o.stats.qp for o in touts] == [o.stats.qp for o in jouts]
    assert [o.stats.bits for o in touts] == [o.stats.bits for o in jouts]
    for i, (a, b) in enumerate(zip(touts, jouts)):
        assert a.nals == b.nals, f"frame {i} differs"
    assert len(touts) == len(jouts)


def assert_decodes(outs, n):
    decoded = decode_stream(b"".join(o.nals for o in outs))
    assert len(decoded) == n
    for fr, out in zip(decoded, outs):
        np.testing.assert_array_equal(fr.y, out.recon[0])
        np.testing.assert_array_equal(fr.cb, out.recon[1])


def nal_types(stream: bytes) -> list[int]:
    """NAL unit types of an Annex B stream, in order."""
    parts = stream.split(b"\x00\x00\x01")[1:]
    return [(p[0] >> 1) & 0x3F for p in parts]


def sei_payload_types(stream: bytes) -> list[int]:
    """The payload type of every message of every prefix SEI NAL unit."""
    types = []
    for nal in stream.split(b"\x00\x00\x01")[1:]:
        if (nal[0] >> 1) & 0x3F != 39:
            continue
        rbsp = nal[2:].replace(b"\x00\x00\x03", b"\x00\x00")
        i = 0
        while i < len(rbsp) and rbsp[i] != 0x80:
            t = s = 0
            while rbsp[i] == 0xFF:
                t, i = t + 255, i + 1
            t, i = t + rbsp[i], i + 1
            while rbsp[i] == 0xFF:
                s, i = s + 255, i + 1
            s, i = s + rbsp[i], i + 1
            types.append(t)
            i += s
    return types


@pytest.mark.parametrize("pipelined", [False, True])
def test_abr_with_aq_on_low_delay_p(jax_trees, pipelined):
    """ABR at 300 kb/s with AQ through the depth-1 lookahead: the SATD-fed
    QPs, cu_qp_delta and the stream equal JAX's, through encode_push and
    through encode_pipelined (their QPs differ from each other)."""
    frames = clip(W, H, 7, seed=5)
    p = superfast(rc_mode="abr", bitrate=300)
    jenc, jouts = run_jax(jax_trees, p, frames, pipelined)
    tenc, touts = run_port(p, frames, pipelined, return_recon=True)
    assert_same_stream(touts, jouts)
    assert tenc.pps.cu_qp_delta_enabled and jenc.pps.cu_qp_delta_enabled
    assert _state(tenc.rc) == _state(jenc.rc)
    assert_decodes(touts, len(frames))
    other = run_port(p, frames, not pipelined)[1]
    assert [o.stats.qp for o in other] != [o.stats.qp for o in touts]


def test_vbv_with_hrd_sei(jax_trees):
    """ABR + VBV (a buffer of one second at the max rate) with --hrd: the
    SPS carries hrd_parameters, every access unit a pic-timing SEI and the
    IDR a buffering period, all equal to JAX's; the excursion telemetry
    agrees."""
    frames = clip(W, H, 6, seed=6)
    p = superfast(rc_mode="abr", bitrate=250, vbv_maxrate=250,
                  vbv_bufsize=250, hrd=True)
    jenc, jouts = run_jax(jax_trees, p, frames, True)
    tenc, touts = run_port(p, frames, True, return_recon=True)
    assert_same_stream(touts, jouts)
    stream = b"".join(o.nals for o in touts)
    assert sei_payload_types(stream).count(0) == 1       # buffering period
    assert sei_payload_types(stream).count(1) == len(frames)  # pic timing
    assert tenc.rc.min_fill_preclamp == jenc.rc.min_fill_preclamp
    assert tenc.rc.underflow_events == jenc.rc.underflow_events
    assert_decodes(touts, len(frames))


def test_crf_all_intra_with_aq(jax_trees):
    """CRF 26 all-intra with AQ through the depth-1 lookahead: the per-frame
    path (not the batched one), equal to JAX's."""
    frames = clip(W, H, 4, seed=8)
    p = superfast(keyint=1, rc_mode="crf", crf=26.0, aq_mode=2)
    jenc, jouts = run_jax(jax_trees, p, frames, True)
    tenc, touts = run_port(p, frames, True, return_recon=True)
    assert_same_stream(touts, jouts)
    assert [o.stats.slice_type for o in touts] == ["I"] * 4
    assert tenc.lookahead is not None and tenc.pps.cu_qp_delta_enabled
    assert_decodes(touts, len(frames))


def test_two_pass_on_low_delay_p(jax_trees, tmp_path):
    """Pass 1 (ABR, no AQ) writes the same stats file as JAX's; pass 2 from
    it gives the same stream."""
    frames = clip(W, H, 6, seed=9)
    js, ts = str(tmp_path / "j.log"), str(tmp_path / "t.log")
    kw = dict(rc_mode="abr", bitrate=200, aq_mode=0, cutree=False)
    run_jax(jax_trees, superfast(pass_num=1, stats_file=js, **kw), frames,
            True)
    run_port(superfast(pass_num=1, stats_file=ts, **kw), frames, True)
    assert open(ts).read() == open(js).read()
    jenc, jouts = run_jax(jax_trees, superfast(pass_num=2, stats_file=js,
                                               **kw), frames, True)
    tenc, touts = run_port(superfast(pass_num=2, stats_file=ts, **kw),
                           frames, True, return_recon=True)
    assert_same_stream(touts, jouts)
    assert tenc.rc.summary() == jenc.rc.summary()
    assert_decodes(touts, len(frames))
