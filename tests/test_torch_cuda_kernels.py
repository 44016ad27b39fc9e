"""The port's CUDA kernels against their plain PyTorch versions at small
shapes.  These need the card: each test takes the `cuda_dev` fixture, which
skips when no CUDA device is present.  On the GPU machine:

    python -m pytest tests/test_torch_cuda_kernels.py -m cuda -q
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _refs(rng, b, n, dev):
    top = rng.integers(0, 256, (b, 2 * n))
    left = rng.integers(0, 256, (b, 2 * n))
    cor = rng.integers(0, 256, b)
    at = rng.random((b, 2 * n)) < 0.8
    al = rng.random((b, 2 * n)) < 0.8
    ac = rng.random(b) < 0.8
    at[0], al[0], ac[0] = False, False, False
    return [torch.as_tensor(a, device=dev) for a in (
        top.astype(np.int32), left.astype(np.int32), cor.astype(np.int32),
        at, al, ac)]


@pytest.mark.parametrize("n,c_idx", [(8, 1), (16, 0), (32, 0)])
def test_intra_pred_kernel(cuda_dev, n, c_idx):
    from x265amod_tpu_torch.ops import intra
    rng = np.random.default_rng(n)
    b = 9
    refs = _refs(rng, b, n, cuda_dev)
    orig = torch.as_tensor(rng.integers(0, 256, (b, n, n)).astype(np.int32),
                           device=cuda_dev)
    assert torch.equal(intra.satd35(orig, *refs, n, c_idx),
                       intra.satd35_plain(orig, *refs, n, c_idx))
    modes = torch.as_tensor(rng.integers(0, 35, (b, 3)).astype(np.int32),
                            device=cuda_dev)
    assert torch.equal(intra.predict(*refs, modes, n, c_idx),
                       intra.predict_plain(*refs, modes, n, c_idx))


@pytest.mark.parametrize("n", [8, 16, 32])
def test_residual_chain_and_tu_bits_kernels(cuda_dev, n):
    from x265amod_tpu_torch.ops import estbits, residual
    rng = np.random.default_rng(100 + n)
    b, k = 7, 2
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-30, 31, (b, k, n, n)), 0,
                   255).astype(np.int32)
    qp = np.array([0, 12, 22, 27, 30, 40, 51], np.int32)
    orig, pred, qp = (torch.as_tensor(a, device=cuda_dev)
                      for a in (orig, pred, qp))
    for sbh in (False, True):
        for intra in (True, False):
            got = residual.residual_chain(orig, pred, qp, sbh, intra=intra)
            want = residual.residual_chain_plain(orig, pred, qp, sbh,
                                                 intra=intra)
            for g, w in zip(got, want):
                assert torch.equal(g, w)
    lv = got[0]
    for c_idx in (0, 1):
        for st in ("I", "P"):
            assert torch.equal(
                estbits.tu_bits(lv, c_idx, qp[:, None], st),
                estbits.tu_bits_plain(lv, c_idx, qp[:, None], st))


def test_deblock_kernel(cuda_dev):
    from x265amod_tpu_torch.ops import deblock
    from x265amod_tpu_torch.ops.quant import chroma_qp_t
    rng = np.random.default_rng(3)
    f, h, w = 2, 64, 96
    h16, w16 = h // 16, w // 16
    split = torch.as_tensor(rng.integers(0, 2, (f, h16 // 2, w16 // 2)),
                            device=cuda_dev)
    bs_v, bs_h = deblock.intra_tree_bs_maps(split, h16, w16)
    q = torch.as_tensor(rng.integers(20, 52, (f, h16, w16)).astype(np.int32),
                        device=cuda_dev)
    qv, qh = deblock.edge_qp_maps(q)
    smooth = (np.arange(w)[None, :] + np.arange(h)[:, None]) % 256
    y = torch.as_tensor(np.clip(smooth + rng.integers(-4, 5, (f, h, w)), 0,
                                255).astype(np.int32), device=cuda_dev)
    assert torch.equal(deblock.deblock_luma(y, bs_v, bs_h, qv, qh),
                       deblock.deblock_luma_plain(y, bs_v, bs_h, qv, qh))
    c = y[:, ::2, ::2].contiguous()
    cv, ch = chroma_qp_t(qv), chroma_qp_t(qh)
    assert torch.equal(deblock.deblock_chroma(c, bs_v, bs_h, cv, ch),
                       deblock.deblock_chroma_plain(c, bs_v, bs_h, cv, ch))


def test_deblock_kernel_on_inter_bs_maps(cuda_dev):
    """bS 1 edges (inter frames): luma tC at QP + 0, chroma untouched."""
    from x265amod_tpu_torch.ops import deblock
    from x265amod_tpu_torch.ops.quant import chroma_qp_t
    rng = np.random.default_rng(4)
    f, h, w = 2, 64, 96
    h16, w16 = h // 16, w // 16
    bs_v = torch.as_tensor(rng.integers(0, 3, (f, h16, w16 - 1)),
                           device=cuda_dev)
    bs_h = torch.as_tensor(rng.integers(0, 3, (f, h16 - 1, w16)),
                           device=cuda_dev)
    q = torch.as_tensor(rng.integers(20, 52, (f, h16, w16)).astype(np.int32),
                        device=cuda_dev)
    qv, qh = deblock.edge_qp_maps(q)
    smooth = (np.arange(w)[None, :] + np.arange(h)[:, None]) % 256
    y = torch.as_tensor(np.clip(smooth + rng.integers(-4, 5, (f, h, w)), 0,
                                255).astype(np.int32), device=cuda_dev)
    assert torch.equal(deblock.deblock_luma(y, bs_v, bs_h, qv, qh),
                       deblock.deblock_luma_plain(y, bs_v, bs_h, qv, qh))
    c = y[:, ::2, ::2].contiguous()
    cv, ch = chroma_qp_t(qv), chroma_qp_t(qh)
    assert torch.equal(deblock.deblock_chroma(c, bs_v, bs_h, cv, ch),
                       deblock.deblock_chroma_plain(c, bs_v, bs_h, cv, ch))


def _plane(rng, h, w, dev, hi=256):
    return torch.as_tensor(rng.integers(0, hi, (h, w)).astype(np.int32),
                           device=dev)


@pytest.mark.parametrize("bn,sr", [(16, 8), (32, 8), (16, 4), (32, 16)])
def test_me_ssd_grid_kernel(cuda_dev, bn, sr):
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(bn + sr)
    h, w = 64, 96
    ref = _plane(rng, h, w, cuda_dev)
    cur = _plane(rng, h, w, cuda_dev).reshape(h // bn, bn, w // bn, bn) \
        .permute(0, 2, 1, 3).reshape(-1, bn, bn)
    assert torch.equal(me.me_ssd_grid(cur, ref, sr, bn),
                       me.me_ssd_grid_plain(cur, ref, sr, bn))


@pytest.mark.parametrize("n", [16, 32])
def test_subpel_refine_kernel(cuda_dev, n):
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(n)
    h, w, sr = 64, 96, 8
    ref = _plane(rng, h, w, cuda_dev)
    nb = (h // n) * (w // n)
    cur = torch.as_tensor(rng.integers(0, 256, (nb, n, n)).astype(np.int32),
                          device=cuda_dev)
    mv = rng.integers(-sr, sr + 1, (nb, 2)).astype(np.int32)
    mv[0] = (-sr, -sr)
    mv[-1] = (sr, sr)
    mv = torch.as_tensor(mv, device=cuda_dev)
    lam = torch.as_tensor(rng.uniform(0, 300, nb).astype(np.float32),
                          device=cuda_dev)
    got = me.subpel_refine(ref, cur, mv, lam, n)
    want = me.subpel_refine_plain(ref, cur, mv, lam, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n,chroma", [(16, False), (32, False), (8, True)])
def test_mc_qpel_kernel(cuda_dev, n, chroma):
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(n + chroma)
    h, w = (32, 48) if chroma else (64, 96)
    plane = _plane(rng, h, w, cuda_dev)
    nb = (h // n) * (w // n)
    mv = rng.integers(-4 * 8 - 2, 4 * 8 + 3, (nb, 2)).astype(np.int32)
    mv[0] = (-34, -34)
    mv[-1] = (34, 34)
    mv = torch.as_tensor(mv, device=cuda_dev)
    fn, plain = ((me.mc_chroma_qpel, me.mc_chroma_qpel_plain) if chroma
                 else (me.mc_luma_qpel, me.mc_luma_qpel_plain))
    assert torch.equal(fn(plane, mv, n), plain(plane, mv, n))


def test_hpel_plane_kernel(cuda_dev):
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(8)
    ref = _plane(rng, 64, 96, cuda_dev)
    assert torch.equal(me.hpel_plane(ref), me.hpel_plane_plain(ref))


def test_kernels_count_their_launches(cuda_dev):
    from x265amod_tpu_torch.ops import cuda_lib, estbits
    cuda_lib.reset_launches()
    lv = torch.zeros((3, 8, 8), dtype=torch.int16, device=cuda_dev)
    estbits.tu_bits(lv, 0, torch.full((3,), 30, device=cuda_dev))
    assert cuda_lib.LAUNCHES["tu_bits"] == 1
