"""Forced-decision slice parity of the PyTorch port against the JAX package
on the CPU, for the all-intra CTU32 tree (BASELINE config 1) at 96x64 and
64x64: given the JAX estimate's split and modes, the port's commit gives
byte-identical levels, modes and recon, and the same NAL bytes (info SEI
off on both sides, since its text names each encoder)."""

import dataclasses

import numpy as np
import pytest
import torch

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.intra_tree import IntraTreeEncoder as JaxTree
from x265amod_tpu.utils.params import param_default_preset
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
from x265amod_tpu_torch.utils.params import param_from_dict

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)


def clip(w, h, n, seed=0):
    """bench.py's synthetic clip (sinusoid luma + noise, smooth chroma)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for t in range(n):
        y = (128 + 80 * np.sin((xx + 3 * t) / 11.0) * np.cos((yy - 2 * t)
                                                             / 7.0)
             + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 30 * np.sin((xx[::2, ::2] + t) / 19.0)).clip(
            0, 255).astype(np.uint8)
        cr = (128 - 30 * np.cos((yy[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def config1(w, h, qp=30):
    p = param_default_preset("ultrafast")
    p.width, p.height, p.qp = w, h, qp
    p.keyint, p.ctu_size, p.info = 1, 32, False
    return p


@pytest.mark.parametrize("w,h,qp", [(96, 64, 22), (64, 64, 30)])
def test_forced_decisions_byte_identical(w, h, qp):
    frames = clip(w, h, 2, seed=qp)
    jtree = JaxTree(w, h, deblock=True, sign_hide=True)
    ttree = IntraTreeEncoder(w, h, deblock=True, sign_hide=True,
                             device="cpu")
    p = config1(w, h, qp)
    jenc = JaxEncoder(p.copy())
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    for y, cb, cr in frames:
        dec = jtree.collect(jtree.encode_async(y, cb, cr, qp))
        jres = jtree.collect(jtree.encode_async_load(
            y, cb, cr, qp, dec.split, dec.modes, want_recon=True),
            want_recon=True)
        tres = ttree.collect(ttree.encode_async_load(
            y, cb, cr, qp, dec.split, dec.modes, want_recon=True))
        np.testing.assert_array_equal(tres.split, jres.split)
        np.testing.assert_array_equal(tres.modes, jres.modes)
        for name in ("levels_y", "levels_cb", "levels_cr", "recon_y",
                     "recon_cb", "recon_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name), name)
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        jnal = jenc._assemble_intra_nal(
            jres, qp, *jenc._cabac_intra(jres, qp), 0.0).nals
        tnal = tenc._assemble_intra_nal(
            tres, qp, *tenc._cabac_intra_tree(tres, qp), 0.0).nals
        assert tnal == jnal
