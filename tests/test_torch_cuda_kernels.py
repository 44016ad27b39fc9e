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


def test_tu_bits_kernel_b_table(cuda_dev):
    """K3 priced at B-slice init states (initType 2)."""
    from x265amod_tpu_torch.ops import estbits
    rng = np.random.default_rng(21)
    for n in (8, 16, 32):
        lv = torch.as_tensor((rng.integers(-40, 41, (6, n, n))
                              * (rng.random((6, n, n)) < 0.3)).astype(
                                  np.int16), device=cuda_dev)
        qp = torch.as_tensor(np.array([0, 22, 30, 33, 34, 51], np.int32),
                             device=cuda_dev)
        for c_idx in (0, 1):
            got = estbits.tu_bits(lv, c_idx, qp, "B")
            assert torch.equal(got, estbits.tu_bits_plain(lv, c_idx, qp, "B"))
            assert not torch.equal(got, estbits.tu_bits(lv, c_idx, qp, "P"))


def _step_plane(rng, h, w, dev):
    """Random content with a 0/255 step (negative 14-bit lobes)."""
    p = rng.integers(0, 256, (h, w)).astype(np.int32)
    p[:, : w // 3] = 0
    p[:, w // 3: w // 2] = 255
    return torch.as_tensor(p, device=dev)


@pytest.mark.parametrize("n,chroma", [(16, False), (32, False), (8, True)])
def test_mc_bi_kernel(cuda_dev, n, chroma):
    """K9 at MVs up to the window contract's bound on border blocks."""
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(40 + n + chroma)
    h, w = (32, 48) if chroma else (64, 96)
    sr = 8
    mm = sr // 2 + 2 if chroma else sr + 2
    r0, r1 = _step_plane(rng, h, w, cuda_dev), _step_plane(rng, h, w,
                                                            cuda_dev)
    nb = (h // n) * (w // n)
    unit = 8 if chroma else 4
    lim = unit * mm + unit - 1
    mvs = []
    for _ in range(2):
        mv = rng.integers(-unit * mm, lim + 1, (nb, 2)).astype(np.int32)
        mv[0] = (-unit * mm, -unit * mm)
        mv[-1] = (lim, lim)
        mvs.append(torch.as_tensor(mv, device=cuda_dev))
    got = me.mc_bi(r0, r1, *mvs, n, chroma, mm)
    assert torch.equal(got, me.mc_bi_plain(r0, r1, *mvs, n, chroma))
    with pytest.raises(ValueError, match="window contract"):
        me.mc_bi(r0, r1, mvs[0] + unit, mvs[1], n, chroma, mm)
    excess = []                 # the kernel's own measure, read later
    me.mc_bi(r0, r1, mvs[0], mvs[1] + unit, n, chroma, mm, excess)
    assert int(excess[0]) == 1


def _sao_planes(rng, h, w, dev):
    orig = rng.integers(0, 256, (h, w)).astype(np.int32)
    rec = np.clip(orig + rng.integers(-6, 7, (h, w)), 0, 255).astype(np.int32)
    rec[: h // 2, : w // 3] = 0             # flat 0
    orig[: h // 2, : w // 3] = 3
    rec[h // 2:, w // 3: w // 2] = 255      # flat 255
    rec[:, w // 2: w // 2 + 16] = orig[:, w // 2: w // 2 + 16]  # rec == orig
    return (torch.as_tensor(orig, device=dev),
            torch.as_tensor(rec, device=dev))


@pytest.mark.parametrize("lam_kind", ["random", "zero", "large"])
def test_sao_analyse_kernel(cuda_dev, lam_kind):
    """K10, luma (CTU 32) and joint chroma (CTU 16)."""
    from x265amod_tpu_torch.ops import sao
    rng = np.random.default_rng(50 + len(lam_kind))
    h, w = 96, 160
    n = (h // 32) * (w // 32)
    lam = {"random": rng.uniform(0, 300, n), "zero": np.zeros(n),
           "large": np.full(n, 1e6)}[lam_kind].astype(np.float32)
    lam = torch.as_tensor(lam, device=cuda_dev)
    o, r = _sao_planes(rng, h, w, cuda_dev)
    for g, p in zip(sao.sao_analyse(o, r, lam, 32),
                    sao.sao_analyse_plain(o, r, lam, 32)):
        assert torch.equal(g, p)
    ocb, rcb = _sao_planes(rng, h // 2, w // 2, cuda_dev)
    ocr, rcr = _sao_planes(rng, h // 2, w // 2, cuda_dev)
    for g, p in zip(sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, lam, 16),
                    sao.sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, lam,
                                                 16)):
        assert torch.equal(g, p)


def test_sao_apply_kernel(cuda_dev):
    from x265amod_tpu_torch.ops import sao
    rng = np.random.default_rng(60)
    for h, w, ctu in ((96, 160, 32), (48, 80, 16)):
        _, r = _sao_planes(rng, h, w, cuda_dev)
        n = (h // ctu) * (w // ctu)

        def t(a):
            return torch.as_tensor(a.astype(np.int32), device=cuda_dev)
        ty, cls, bp = (t(rng.integers(0, 3, n)), t(rng.integers(0, 4, n)),
                       t(rng.integers(0, 29, n)))
        off = t(rng.integers(-7, 8, (n, 4)))
        assert torch.equal(sao.sao_apply(r, ty, cls, bp, off, ctu),
                           sao.sao_apply_plain(r, ty, cls, bp, off, ctu))


@pytest.mark.parametrize("w,h", [(128, 64), (1920, 1088)])
def test_lowres_aq_kernel(cuda_dev, w, h):
    from x265amod_tpu_torch.models import lookahead as la
    rng = np.random.default_rng(w)
    planes = [rng.integers(0, 256, s).astype(np.uint8)
              for s in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    planes[0][: h // 4, : w // 4] = 0             # flat and stepped regions
    planes[0][: h // 4, w // 4: w // 2] = 255
    planes[1][h // 4:] = 128
    y, cb, cr = (torch.as_tensor(a, device=cuda_dev) for a in planes)
    for strength in (1.0, 0.5):
        lr, off = la.lowres_aq(y, cb, cr, strength)
        plr, poff = la.lowres_aq_plain(y, cb, cr, strength)
        assert torch.equal(lr, plr)
        assert torch.equal(off, poff)


@pytest.mark.parametrize("kind", ["random", "flat", "shifted"])
def test_lowres_me_kernel(cuda_dev, kind):
    from x265amod_tpu_torch.models import lookahead as la
    rng = np.random.default_rng(len(kind))
    cur = rng.integers(0, 256, (544, 960)).astype(np.uint8)
    ref = rng.integers(0, 256, (544, 960)).astype(np.uint8)
    if kind == "flat":
        cur[:], ref[:] = 77, 77
    elif kind == "shifted":
        ref = np.roll(cur, (5, -7), (0, 1))
    cur, ref = (torch.as_tensor(a, device=cuda_dev) for a in (cur, ref))
    cost, mv = la.lowres_inter_cost(cur, ref)
    pcost, pmv = la.lowres_inter_cost_plain(cur, ref)
    assert torch.equal(cost, pcost) and torch.equal(mv, pmv)
    if kind == "flat":
        assert bool((mv == -8).all())


@pytest.mark.parametrize("kind", ["random", "pileup"])
def test_cutree_prop_kernel_is_deterministic(cuda_dev, kind):
    from x265amod_tpu_torch.models import lookahead as la
    rng = np.random.default_rng(7 + len(kind))
    hb, wb = 68, 120
    prop = (rng.random((hb, wb)) * 10.0 ** rng.integers(-3, 7, (hb, wb))) \
        .astype(np.float32)
    intra = (rng.random((hb, wb)) * 3000).astype(np.float32)
    intra[::5, ::3] = 0.0
    inter = (rng.random((hb, wb)) * 3500).astype(np.float32)
    mv = rng.integers(-8, 9, (hb, wb, 2)).astype(np.int32)
    if kind == "pileup":
        mv[:2, :, 1], mv[:, :2, 0], mv[-2:, :, 1] = -8, -8, 8
    args = [torch.as_tensor(a, device=cuda_dev)
            for a in (prop, intra, inter, mv)]
    got = la.cutree_propagate_step(*args)
    assert torch.equal(got, la.cutree_propagate_step_plain(*args))
    assert torch.equal(got, la.cutree_propagate_step(*args))


def test_lowres_intra_cost_kernel(cuda_dev):
    from x265amod_tpu_torch.models import lookahead as la
    from x265amod_tpu_torch.ops import cuda_lib, intra
    rng = np.random.default_rng(5)
    lr = torch.as_tensor(rng.integers(0, 256, (64, 96)).astype(np.uint8),
                         device=cuda_dev)
    before = dict(cuda_lib.LAUNCHES)
    got = la.lowres_intra_cost(lr)
    assert cuda_lib.LAUNCHES["intra_pred_lowres"] == \
        before["intra_pred_lowres"] + 1
    assert cuda_lib.LAUNCHES["intra_pred"] == before["intra_pred"]
    orig, refs = la.lowres_intra_refs(lr)
    want = intra.satd35_plain(orig, *refs, 8, 0).amin(1).float()
    assert torch.equal(got, want.reshape(8, 12))


def test_lookahead_on_the_card_equals_the_cpu(cuda_dev):
    from x265amod_tpu_torch.models import lookahead as la
    rng = np.random.default_rng(9)
    w, h = 256, 128
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    frames = []
    for t in range(7):
        y = np.roll(base, (t, 2 * t), (0, 1)) if t < 5 else \
            rng.integers(0, 256, (h, w)).astype(np.uint8)
        c = rng.integers(60, 200, (h // 2, w // 2)).astype(np.uint8)
        frames.append((y, c, 255 - c))
    outs = {}
    for dev in ("cuda", "cpu"):
        look = la.Lookahead(w, h, depth=4, device=dev)
        fas = [fa for f in frames for fa in look.push(*f)] + look.flush()
        outs[dev] = [(fa.display, fa.is_scenecut, fa.pred_ratio,
                      look.ctu_qp_offsets(fa)) for fa in fas]
    for a, b in zip(outs["cuda"], outs["cpu"]):
        assert a[:3] == b[:3]
        np.testing.assert_array_equal(a[3], b[3])


@pytest.mark.parametrize("n", [8, 16, 32])
def test_residual_chain_rdoq_stage(cuda_dev, n):
    """K2's RDOQ stage against the plain `rdoq_adjust` chain: QP 0 and 51,
    lambda 0 and 1e6, all-zero blocks, levels at +-32767 (a flat 0 block
    against a flat 255 prediction at QP 0), every slice type and plane,
    intra and inter rounding; its launches count apart."""
    from x265amod_tpu_torch.ops import cuda_lib, residual
    rng = np.random.default_rng(200 + n)
    b, k = 9, 2
    orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
    pred = np.clip(orig[:, None] + rng.integers(-40, 41, (b, k, n, n)), 0,
                   255).astype(np.int32)
    orig[0], pred[0] = 0, 255
    orig[1], pred[1] = 128, 128                   # all-zero levels
    qp = np.array([0, 51, 0, 22, 27, 30, 37, 45, 51], np.int32)
    lam = (10.0 ** rng.uniform(-1, 4, b)).astype(np.float32)
    lam[2], lam[3] = 0.0, 1e6
    orig, pred, qp, lam = (torch.as_tensor(a, device=cuda_dev)
                           for a in (orig, pred, qp, lam))
    before = dict(cuda_lib.LAUNCHES)
    for st, c_idx, intra in (("I", 0, True), ("P", 1, False),
                             ("B", 0, False), ("P", 0, True)):
        got = residual.residual_chain(orig, pred, qp, True, intra=intra,
                                      rdoq=True, lam=lam, st=st, c_idx=c_idx)
        want = residual.residual_chain_plain(orig, pred, qp, True,
                                             intra=intra, rdoq=True, lam=lam,
                                             st=st, c_idx=c_idx)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert cuda_lib.LAUNCHES["residual_chain_rdoq"] == \
        before["residual_chain_rdoq"] + 4
    assert cuda_lib.LAUNCHES["residual_chain"] == before["residual_chain"]


@pytest.mark.parametrize("n,c_idx", [(8, 1), (16, 0), (32, 0)])
def test_intra_pred_and_residual_chain_at_bit_depth_10(cuda_dev, n, c_idx):
    """K1 and K2 at bit depth 10 against their plain versions, with flat 0
    and 1023 blocks and QP 0 and 51."""
    from x265amod_tpu_torch.ops import intra, residual
    rng = np.random.default_rng(300 + n)
    b = 9
    refs = _refs(rng, b, n, cuda_dev)
    refs[:3] = [r * 4 + 3 for r in refs[:3]]          # 10-bit samples
    refs[0][1], refs[1][1], refs[2][1] = 0, 0, 0
    refs[0][2], refs[1][2], refs[2][2] = 1023, 1023, 1023
    orig = rng.integers(0, 1024, (b, n, n)).astype(np.int32)
    orig[1], orig[2] = 0, 1023
    orig = torch.as_tensor(orig, device=cuda_dev)
    assert torch.equal(intra.satd35(orig, *refs, n, c_idx, bit_depth=10),
                       intra.satd35_plain(orig, *refs, n, c_idx, 10))
    modes = torch.as_tensor(rng.integers(0, 35, (b, 3)).astype(np.int32),
                            device=cuda_dev)
    modes[:, 1], modes[:, 2] = 10, 26
    pred = intra.predict(*refs, modes, n, c_idx, bit_depth=10)
    assert torch.equal(pred, intra.predict_plain(*refs, modes, n, c_idx, 10))
    qp = torch.as_tensor(np.array([0, 51, 0, 22, 27, 30, 37, 45, 51],
                                  np.int32), device=cuda_dev)
    for sbh in (False, True):
        got = residual.residual_chain(orig, pred, qp, sbh, bit_depth=10)
        want = residual.residual_chain_plain(orig, pred, qp, sbh,
                                             bit_depth=10)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
    assert int(got[1].max()) > 255


@pytest.mark.parametrize("density,cap", [(0.0, 128), (0.03, 1152),
                                         (0.5, 1152), (1.0, 9216)])
def test_pack_levels_kernel(cuda_dev, density, cap):
    """K15 against its plain version over a batch of 3 frames of 24 cells:
    empty, sparse, past cap (dropped values, overflow) and dense, with the
    int16 extremes."""
    from x265amod_tpu_torch.ops import pack
    rng = np.random.default_rng(int(density * 100) + cap)
    lv = []
    for n in (16, 8, 8):
        v = rng.integers(-32768, 32768, (3, 24, n, n))
        v[rng.random(v.shape) >= density] = 0
        lv.append(torch.as_tensor(v.astype(np.int16), device=cuda_dev))
    for g, w in zip(pack.pack_levels(lv, cap), pack.pack_levels_plain(lv,
                                                                      cap)):
        assert g.dtype == w.dtype and torch.equal(g, w)


@pytest.mark.parametrize("src,dst,method", [
    ((64, 96), (32, 48), "bicubic"), ((64, 96), (96, 144), "bilinear"),
    ((96, 192), (32, 64), "bicubic"), ((36, 64), (24, 40), "bilinear")])
def test_resample_kernel(cuda_dev, src, dst, method):
    """K16 against its plain version on the unrounded f32 values and the
    uint8 output."""
    from x265amod_tpu_torch.ops import scaler
    rng = np.random.default_rng(src[0] + dst[1])
    p = torch.as_tensor(rng.integers(0, 256, src).astype(np.uint8),
                        device=cuda_dev)
    for raw in (True, False):
        assert torch.equal(
            scaler.resample_plane(p, dst[1], dst[0], method, unrounded=raw),
            scaler.resample_plane_plain(p, dst[1], dst[0], method,
                                        unrounded=raw))


@pytest.mark.parametrize("n,chroma", [(16, False), (32, False), (8, True)])
def test_mc_qpel_ref_kernel(cuda_dev, n, chroma):
    """K7 with a per-block reference index over 3 stacked planes, for the
    final MC (one prediction per block) and the trials (every block on
    every plane), MVs at the window bound on border blocks."""
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(40 + n + chroma)
    h, w = (32, 48) if chroma else (64, 96)
    planes = torch.stack([_plane(rng, h, w, cuda_dev) for _ in range(3)])
    nb = (h // n) * (w // n)
    bound = 8 * (8 // 2 + 2) if chroma else 4 * (8 + 2)
    for k in (nb, 3 * nb):
        mv = rng.integers(-bound, bound + 1, (k, 2)).astype(np.int32)
        mv[0], mv[-1] = (-bound, -bound), (bound, bound)
        ref = rng.integers(0, 3, k).astype(np.int32)
        mv, ref = (torch.as_tensor(a, device=cuda_dev) for a in (mv, ref))
        assert torch.equal(me.mc_qpel_ref(planes, mv, ref, n, chroma),
                           me.mc_ref_plain(planes, mv, ref, n, chroma))


@pytest.mark.parametrize("nr", [2, 3, 4])
def test_pick_ref_kernel(cuda_dev, nr):
    """K18 against its plain version, with exact ties between references
    (the first wins) and costs whose FMA rounding differs from the product
    rounded before the add."""
    from x265amod_tpu_torch.models.mvpred import ref_list_tables
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(nr)
    n = 999
    d = rng.uniform(0, 1e5, (n, nr)).astype(np.float32)
    rb = rng.uniform(0, 300, (n, nr)).astype(np.float32)
    mv = rng.integers(-40, 41, (n, nr, 2)).astype(np.int32)
    lam = rng.uniform(0, 400, n).astype(np.float32)
    d[::3, 1] = d[::3, 0]
    rb[::3, 1] = rb[::3, 0]
    mv[::3, 1] = mv[::3, 0]
    bits = ref_list_tables(nr, list(range(nr - 1, -1, -1)))[1]
    args = [torch.as_tensor(a, device=cuda_dev)
            for a in (d, rb, mv, lam, bits)]
    for g, w in zip(me.pick_ref(*args), me.pick_ref_plain(*args)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("nr", [1, 3, 4])
def test_decide_p_kernel(cuda_dev, nr):
    """K17 against the plain scan on the card on a 128x96 P frame's phase-1
    outputs: free (decisions, MVs, references and cost rows bit-equal) and
    forced with the plain scan's decisions, at R = 1, 3 and 4."""
    from x265amod_tpu_torch.models.inter_tree import InterTreeEncoder
    from x265amod_tpu_torch.models.mvpred import ref_list_tables
    rng = np.random.default_rng(70 + nr)
    w, h = 128, 96
    tree = InterTreeEncoder(w, h, search_range=8, subme=1, device=cuda_dev)
    y = _plane(rng, h, w, cuda_dev)
    refs = torch.stack([torch.roll(y, (r + 1, -r), (0, 1)) + r
                        for r in range(nr)]).clamp(0, 255).to(torch.int32)
    dsf, bits = ref_list_tables(nr, [nr - 1 - r for r in range(nr)])
    tables = (torch.as_tensor(dsf, device=cuda_dev),
              torch.as_tensor(bits, device=cuda_dev))
    maps = tree._maps(30)
    st1 = tree._phase1(y, refs, maps, tables)
    got = tree._decide_kernel(st1, maps, tables, want_costs=True)
    want = tree._decide_plain(st1, maps, tables, want_costs=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    cells = tree._cell_decisions(want)
    kinds = cells["kinds"]
    forced = dict(c16=(torch.where(kinds == 0, cells["merge"],
                                   torch.where(kinds == 1, 2, 3)),
                       cells["mvd"], cells["mvp"], cells["ref"]),
                  split=want["split"].reshape(-1))
    forced["c32"] = [v[tree._q0_cell] for v in forced["c16"]]
    fk = tree._decide_kernel(None, maps, tables, forced=forced)
    fp = tree._decide_plain(None, maps, tables, forced=forced)
    for k in ("split", "mv", "ref"):
        assert torch.equal(fk[k], fp[k]), k
        assert torch.equal(fk[k], want[k]), k
