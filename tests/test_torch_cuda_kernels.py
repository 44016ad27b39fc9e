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
        got = residual.residual_chain(orig, pred, qp, sbh)
        want = residual.residual_chain_plain(orig, pred, qp, sbh)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    lv = got[0]
    for c_idx in (0, 1):
        assert torch.equal(estbits.tu_bits(lv, c_idx, qp[:, None]),
                           estbits.tu_bits_plain(lv, c_idx, qp[:, None]))


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


def test_kernels_count_their_launches(cuda_dev):
    from x265amod_tpu_torch.ops import cuda_lib, estbits
    cuda_lib.reset_launches()
    lv = torch.zeros((3, 8, 8), dtype=torch.int16, device=cuda_dev)
    estbits.tu_bits(lv, 0, torch.full((3,), 30, device=cuda_dev))
    assert cuda_lib.LAUNCHES["tu_bits"] == 1
