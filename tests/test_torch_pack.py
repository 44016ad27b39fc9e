"""The sparse level pack of the port's device-to-host copy (row 12, kernel
K15) against the JAX package on the CPU: `pack_levels_plain` equals the JAX
`pack_levels` byte for byte (bitmap, values, nnz, fits) on sparse, dense and
empty levels, at the int16 extremes, past the capacity (the dropped values
and the zero tail) and over a batch (the JAX function under `vmap`, as the
batched intra step runs it); the host `unpack_levels` inverts it; and each
tree's stream is unchanged when a frame overflows and its dense levels are
copied instead."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from x265amod_tpu.ops import pack as jpack
from x265amod_tpu.utils.params import Param, param_default_preset
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.ops import pack as tpack
from x265amod_tpu_torch.utils.params import param_from_dict
from test_torch_slice import clip, yield_cpu  # noqa: F401 (autouse)

torch.set_num_threads(1)

N16 = 24                       # a 96x64 frame's 16x16 cells
SHAPES = [(N16, 16, 16), (N16, 8, 8), (N16, 8, 8)]
TOTAL = N16 * 384


def levels(seed, density, lo=-40, hi=41):
    rng = np.random.default_rng(seed)
    return [np.where(rng.random(s) < density, rng.integers(lo, hi, s), 0)
            .astype(np.int16) for s in SHAPES]


def jax_pack(arrs, cap):
    return [np.asarray(a) for a in jpack.pack_levels(
        [jnp.asarray(a) for a in arrs], cap)]


def port_pack(arrs, cap):
    return [a[0].numpy() for a in tpack.pack_levels_plain(
        [torch.as_tensor(a[None]) for a in arrs], cap)]


def assert_bytes_equal(t, j):
    for a, b in zip(t, j):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("density", [0.0, 0.01, 0.06, 0.3, 1.0])
@pytest.mark.parametrize("frac", [16, 8])
def test_pack_equals_the_jax_packages(density, frac):
    arrs = levels(int(density * 100) + frac, density)
    cap = tpack.pack_cap(TOTAL, frac)
    assert cap == jpack.pack_cap(TOTAL, frac)
    t = port_pack(arrs, cap)
    assert_bytes_equal(t, jax_pack(arrs, cap))
    assert bool(t[3]) == (int(t[2]) <= cap)
    if t[3]:
        out = tpack.unpack_levels(t[0], t[1], int(t[2]), SHAPES)
        for o, a in zip(out, arrs):
            np.testing.assert_array_equal(o, a)
        for o, r in zip(out, jpack.unpack_levels(t[0], t[1], int(t[2]),
                                                 SHAPES)):
            np.testing.assert_array_equal(o, r)


@pytest.mark.parametrize("cap", [128, 256, 1152])
def test_overflow_drops_past_cap_and_zeroes_the_tail(cap):
    """nnz counts every nonzero level; the values past cap are dropped (the
    first cap stay, in flat order); a frame that fits leaves zeros from nnz
    to cap."""
    arrs = levels(3, 0.2)
    t = port_pack(arrs, cap)
    assert_bytes_equal(t, jax_pack(arrs, cap))
    flat = np.concatenate([a.reshape(-1) for a in arrs])
    nz = flat[flat != 0]
    assert int(t[2]) == nz.size
    assert bool(t[3]) == (nz.size <= cap)
    np.testing.assert_array_equal(t[1][:min(cap, nz.size)], nz[:cap])
    assert not t[1][nz.size:].any()


def test_int16_extremes_and_an_odd_length():
    arrs = levels(4, 0.5, lo=-32768, hi=32768)
    arrs[0][0, 0, :4] = [-32768, 32767, -1, 1]
    t = port_pack(arrs, TOTAL)
    assert_bytes_equal(t, jax_pack(arrs, TOTAL))
    odd = [np.arange(-6, 7, dtype=np.int16)]          # 13 levels, padded
    assert_bytes_equal(port_pack(odd, 128), jax_pack(odd, 128))


def test_a_batch_equals_the_jax_vmap():
    b = 5
    per = [levels(10 + i, d) for i, d in enumerate((0, .02, .1, .5, 1.))]
    cap = tpack.pack_cap(TOTAL, 16)
    j = jax.vmap(lambda *a: jpack.pack_levels(list(a), cap))(
        *[jnp.asarray(np.stack([p[k] for p in per])) for k in range(3)])
    t = tpack.pack_levels_plain(
        [torch.as_tensor(np.stack([p[k] for p in per])) for k in range(3)],
        cap)
    assert_bytes_equal([a.numpy() for a in t], [np.asarray(a) for a in j])
    assert t[0].shape[0] == b and not bool(t[3][-1])


def _stream(p, frames, small_cap, monkeypatch):
    """The port's stream, every frame's pack capacity cut to 128 when
    small_cap, with the count of frames collected through their dense
    levels."""
    dense = []
    real = tpack.levels_from_host

    def spy(host, i, d):
        dense.append(not bool(host["fits"][i]))
        return real(host, i, d)
    with monkeypatch.context() as m:
        m.setattr("x265amod_tpu_torch.models.intra_tree.levels_from_host",
                  spy)
        m.setattr("x265amod_tpu_torch.models.inter_tree.levels_from_host",
                  spy)
        if small_cap:
            m.setattr(tpack, "pack_cap", lambda total, frac=16: 128)
        enc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
        nals = [o.nals for o in enc.encode_pipelined(frames)]
    return nals, sum(dense), len(dense)


@pytest.mark.parametrize("config", ["all_intra", "low_delay_p", "b"])
def test_an_overflowing_frame_codes_the_same_stream(config, monkeypatch):
    """The dense copy is the reference's overflow contract: a frame whose
    pack overflows gives the same stream through its dense levels."""
    if config == "all_intra":
        p = param_default_preset("ultrafast")
        p.keyint, p.qp = 1, 34
    elif config == "low_delay_p":
        p = param_default_preset("superfast")
        p.keyint, p.bframes, p.aq_mode, p.cutree, p.qp = 250, 0, 0, False, 34
    else:
        p = Param(keyint=60, bframes=2, sao=True, qp=34)
    p.width, p.height, p.ctu_size, p.info = 64, 64, 32, False
    frames = clip(64, 64, 3, seed=12)
    ref, n_dense, n = _stream(p, frames, False, monkeypatch)
    assert n >= 3 and n_dense == 0      # all-intra: a 16-frame batch
    got, n_dense, n = _stream(p, frames, True, monkeypatch)
    assert n >= 3 and n_dense > 0       # the I frames at least
    assert got == ref
