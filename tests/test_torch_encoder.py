"""End-to-end checks of the PyTorch port on the CPU: free-running parity
with the JAX package and conformance of the port's stream, the batched
step, the device rule, the slice gate, the constant tables and import
hygiene (the port imports neither jax nor the JAX package)."""

import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.verify.decoder import decode_stream
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
from x265amod_tpu_torch.utils.params import (check_params, param_from_dict,
                                             param_default_preset)
from test_torch_slice import clip, config1, yield_cpu  # noqa: F401 (autouse)

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_free_running_parity_and_decode():
    w, h, nf = 96, 64, 3
    frames = clip(w, h, nf)
    p = config1(w, h)
    jenc = JaxEncoder(p.copy())
    jenc.BATCH_FRAMES = 2
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    tenc.BATCH_FRAMES = 2
    jstream = [o.nals for o in jenc.encode_pipelined(frames)]
    tstream = [o.nals for o in tenc.encode_pipelined(frames)]
    qp = tenc.frame_stats[0].qp
    assert qp == jenc.frame_stats[0].qp == 27      # 30 - 6 log2(1.4)

    jtree = jenc.frame_encoder
    ttree = tenc.frame_encoder
    pads = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, (-a.shape[1]) % s)),
                    mode="edge") for a, s in zip(fr, (32, 16, 16))]
            for fr in frames]
    recons = []
    for i, (y, cb, cr) in enumerate(pads):
        jres = jtree.collect(jtree.encode_async(y, cb, cr, qp))
        tres = ttree.collect(ttree.encode_async(y, cb, cr, qp,
                                                want_recon=True))
        recons.append(tres)
        diff = (tres.split != jres.split)
        if diff.any() or (tres.modes != jres.modes).any():
            # a decision may differ only on a near-tie of the f32 costs
            import torch
            maps = ttree._maps(qp)
            planes = [torch.as_tensor(a)[None].to(torch.int32)
                      for a in (y, cb, cr)]
            _, _, js, ja = ttree._estimate(*planes, maps, want_costs=True)
            js, ja = js[0].numpy(), ja[0].numpy()
            rel = np.abs(js - ja) / np.maximum(np.abs(ja), 1e-9)
            assert (rel[diff] < 1e-5).all(), rel[diff]
        assert tstream[i] == jstream[i]

    decoded = decode_stream(b"".join(tstream))
    assert len(decoded) == nf
    for fr, res in zip(decoded, recons):
        np.testing.assert_array_equal(fr.y, res.recon_y[:h, :w])
        np.testing.assert_array_equal(fr.cb, res.recon_cb[:h // 2, :w // 2])
        np.testing.assert_array_equal(fr.cr, res.recon_cr[:h // 2, :w // 2])


def test_batched_step_equals_per_frame_steps():
    """The leading frame dimension (the JAX vmap) changes nothing: a
    3-frame batch gives each frame's single-frame result."""
    w, h = 64, 64
    frames = clip(w, h, 3, seed=7)
    tree = IntraTreeEncoder(w, h, device="cpu")
    batch = tree.collect_batch(tree.encode_batch_async(
        *(np.stack([f[i] for f in frames]) for i in range(3)), 30))
    for fr, res in zip(frames, batch):
        one = tree.collect(tree.encode_async(*fr, 30))
        for name in ("split", "modes", "levels_y", "levels_cb",
                     "levels_cr", "sse"):
            np.testing.assert_array_equal(getattr(res, name),
                                          getattr(one, name), name)


def test_encoder_needs_a_card_unless_asked_for_the_cpu():
    p = config1(64, 64)
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a CUDA card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(p)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Encoder(p, device="cuda")
    assert Encoder(p, device="cpu").device.type == "cpu"


@pytest.mark.parametrize("field,value", [
    ("ref", 2), ("ctu_size", 16), ("lossless", True), ("bframes", 17),
    ("aq_mode", 2), ("cutree", True), ("rdoq_level", 1),
    ("internal_bit_depth", 10), ("rc_mode", "crf"), ("bitrate", 1000),
    ("vbv_maxrate", 1000), ("pass_num", 2), ("wpp", True),
    ("decoded_picture_hash", 1), ("analysis_load", "a.dat"),
    ("analysis_save", "a.dat"), ("qpfile", "q.txt")])
def test_check_params_refuses_what_the_slice_does_not_run(field, value):
    p = config1(64, 64)
    check_params(p)
    setattr(p, field, value)
    with pytest.raises(ValueError, match="not wired in this port"):
        check_params(p)


def test_param_from_dict_takes_the_jax_param():
    from x265amod_tpu.utils.params import \
        param_default_preset as jax_preset
    jp = jax_preset("ultrafast")
    tp = param_from_dict(dataclasses.asdict(jp))
    assert dataclasses.asdict(tp) == dataclasses.asdict(jp)
    assert tp == param_default_preset("ultrafast")
    with pytest.raises(ValueError, match="unknown Param fields"):
        param_from_dict(dict(dataclasses.asdict(jp), bogus=1))


def test_constant_tables_equal_the_jax_packages():
    from x265amod_tpu.cabac import tables as jt
    from x265amod_tpu.ops import deblock as jdb
    from x265amod_tpu.ops import estbits as jeb
    from x265amod_tpu.ops import intra_ref as jir
    from x265amod_tpu.ops import quant as jq
    from x265amod_tpu.ops import transforms as jtr
    from x265amod_tpu_torch.cabac import tables as tt
    from x265amod_tpu_torch.ops import deblock as tdb
    from x265amod_tpu_torch.ops import estbits as teb
    from x265amod_tpu_torch.ops import intra_ref as tir
    from x265amod_tpu_torch.ops import quant as tq
    from x265amod_tpu_torch.ops import transforms as ttr
    for n in (4, 8, 16, 32):
        np.testing.assert_array_equal(ttr.dct_matrix(n), jtr.dct_matrix(n))
    np.testing.assert_array_equal(tq.QUANT_SCALES, jq.QUANT_SCALES)
    np.testing.assert_array_equal(tq.INV_QUANT_SCALES, jq.INV_QUANT_SCALES)
    np.testing.assert_array_equal(tq.CHROMA_QP_TAB, jq._CHROMA_QP_TAB)
    np.testing.assert_array_equal(tq.chroma_qp_np(np.arange(58)),
                                  jq.chroma_qp_np(np.arange(58)))
    assert tir.ANGLES == jir.ANGLES and tir.INV_ANGLES == jir.INV_ANGLES
    for n in (4, 8, 16, 32):
        for c in (0, 1):
            assert [tir.filter_flag(m, n, c) for m in range(35)] == \
                [jir.filter_flag(m, n, c) for m in range(35)]
    for st in ("I", "P", "B"):
        for c in (0, 1):
            np.testing.assert_array_equal(teb.bit_consts_table(st, c),
                                          jeb._bit_consts_table(st, c))
    np.testing.assert_array_equal(teb.group_idx_bins(32),
                                  jeb._group_idx_bins(32))
    np.testing.assert_array_equal(tdb.BETA_TABLE, jdb.BETA_TABLE)
    np.testing.assert_array_equal(tdb.TC_TABLE, jdb.TC_TABLE)
    for qp in range(52):
        for bs in (1, 2):
            assert tdb.luma_params(qp, bs=bs) == jdb.luma_params(qp, bs=bs)
        for m_t, m_j in zip(tq.derive_qp_maps(qp, None, 2, 3),
                            jq.derive_qp_maps(qp, None, 2, 3)):
            np.testing.assert_array_equal(m_t, m_j)
    for name in ("RANGE_TAB_LPS", "TRANS_IDX_LPS", "TRANS_IDX_MPS",
                 "ENTROPY_BITS"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(jt, name))
    assert tt.INIT_VALUES == jt.INIT_VALUES
    assert tt.CTX_OFFSET == jt.CTX_OFFSET and tt.NUM_CTX == jt.NUM_CTX
    for st in ("I", "P", "B"):
        for qp in (0, 22, 27, 51):
            np.testing.assert_array_equal(tt.init_context_states(st, qp),
                                          jt.init_context_states(st, qp))


_IMPORT_RE = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+x265amod_tpu(\.|\s|$)"
    r"|from\s+x265amod_tpu(\.|\s))", re.M)


def test_port_sources_import_neither_jax_nor_the_jax_package():
    files = [os.path.join(REPO, "chip_smoke.py"),
             os.path.join(REPO, "profile_port.py")]
    for root, _, names in os.walk(os.path.join(REPO, "x265amod_tpu_torch")):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    offenders = [f for f in files if _IMPORT_RE.search(open(f).read())]
    assert not offenders, offenders


def test_port_runs_without_jax_in_the_process():
    code = (
        "import sys, numpy as np\n"
        "import x265amod_tpu_torch\n"
        "from x265amod_tpu_torch.models.encoder import Encoder\n"
        "from x265amod_tpu_torch.utils.params import param_default_preset\n"
        "p = param_default_preset('ultrafast')\n"
        "p.width, p.height, p.qp, p.keyint, p.ctu_size = 64, 32, 30, 1, 32\n"
        "e = Encoder(p, device='cpu')\n"
        "z = np.full((32, 64), 90, np.uint8)\n"
        "c = np.full((16, 32), 128, np.uint8)\n"
        "out = list(e.encode_pipelined([(z, c, c)]))\n"
        "assert len(out) == 1 and out[0].nals\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'x265amod_tpu' or m.startswith('x265amod_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().endswith("clean")
