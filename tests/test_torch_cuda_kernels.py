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


def _step_plane8(rng, h, w, dev):
    """An 8-bit plane of 0 / 255 steps with texture between them."""
    p = rng.integers(0, 256, (h, w))
    p[: h // 2, : w // 3] = 0
    p[h // 2:, w // 3: 2 * w // 3] = 255
    p[:, -5:] = 255
    p[-3:, :] = 0
    return torch.as_tensor(p.astype(np.int32), device=dev)


@pytest.mark.parametrize("sr", [1, 8, 16, 32])
@pytest.mark.parametrize("bn", [16, 32])
def test_me_ssd_grid_tensor_core_kernel(cuda_dev, bn, sr):
    """K5's tensor-core correlation, bit for bit: on a plane of 0 / 255
    steps (one u8 product), on K8's half-pel plane of it (the byte split,
    two products), on a 10-bit window (the split with h up to 3), with a
    10-bit block (the exact int32 loop); at sr 32 S^2 = 4225 offsets; and
    on a frame smaller than the window (one block)."""
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(10 * bn + sr)
    h, w = 96, 128
    ref = _step_plane8(rng, h, w, cuda_dev)
    cur8 = _step_plane8(rng, h, w, cuda_dev)

    def blocks(p, hh, ww):
        return p.reshape(hh // bn, bn, ww // bn, bn).permute(0, 2, 1, 3) \
            .reshape(-1, bn, bn).contiguous()
    hp = me.hpel_plane(ref)
    assert int(hp.min()) < 0 and int(hp.max()) > 255
    ref10 = _plane(rng, h, w, cuda_dev, hi=1024)
    cur10 = blocks(_plane(rng, h, w, cuda_dev, hi=1024), h, w)
    for cur, plane in ((blocks(cur8, h, w), ref), (blocks(cur8, h, w), hp),
                       (blocks(cur8, h, w), ref10), (cur10, ref10)):
        assert torch.equal(me.me_ssd_grid(cur, plane, sr, bn),
                           me.me_ssd_grid_plain(cur, plane, sr, bn))
    small = ref[:bn, :bn].contiguous()
    cur = blocks(cur8[:bn, :bn], bn, bn)
    for plane in (small, me.hpel_plane(small)):
        assert torch.equal(me.me_ssd_grid(cur, plane, sr, bn),
                           me.me_ssd_grid_plain(cur, plane, sr, bn))


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


def _k1_refs(rng, b, n, maxv, dev):
    """Raw refs with availability: random, nothing present, the corner
    only, the left only, and flat 0 and maxv content."""
    top = rng.integers(0, maxv + 1, (b, 2 * n))
    left = rng.integers(0, maxv + 1, (b, 2 * n))
    cor = rng.integers(0, maxv + 1, b)
    at = rng.random((b, 2 * n)) < 0.7
    al = rng.random((b, 2 * n)) < 0.7
    ac = rng.random(b) < 0.7
    at[0], al[0], ac[0] = False, False, False          # nothing
    at[1], al[1], ac[1] = False, False, True           # the corner only
    at[2], al[2], ac[2] = False, True, False           # the left only
    at[3, n:], al[3, n:] = False, False                # no top-right, below
    for i, v in ((4, 0), (5, maxv)):                   # flat 0, flat maxv
        top[i], left[i], cor[i] = v, v, v
        at[i], al[i], ac[i] = True, True, True
    return [torch.as_tensor(a, device=dev) for a in (
        top.astype(np.int32), left.astype(np.int32), cor.astype(np.int32),
        at, al, ac)]


@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("c_idx", [0, 1])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_intra_pred_kernel_every_mode(cuda_dev, n, c_idx, bd):
    """Both entry points of K1 against their plain versions, bit for bit:
    37 CUs (a partial last thread block at every n), all 35 modes through
    satd35, and predict at K 1, 4 and 35 (every mode of every CU, in a
    random order), with flat blocks at 0 and at the largest sample."""
    from x265amod_tpu_torch.ops import intra
    rng = np.random.default_rng(1000 * bd + 10 * n + c_idx)
    maxv = (1 << bd) - 1
    b = 37
    refs = _k1_refs(rng, b, n, maxv, cuda_dev)
    orig = rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32)
    orig[4], orig[5], orig[6] = 0, maxv, maxv
    orig = torch.as_tensor(orig, device=cuda_dev)
    assert torch.equal(intra.satd35(orig, *refs, n, c_idx, bit_depth=bd),
                       intra.satd35_plain(orig, *refs, n, c_idx, bd))
    every = np.stack([rng.permutation(35) for _ in range(b)])
    for k in (1, 4, 35):
        modes = every[:, :k].astype(np.int32)
        if k == 4:
            modes[:, 1], modes[:, 2] = 10, 26      # the clipped edge filters
        modes = torch.as_tensor(modes, device=cuda_dev)
        assert torch.equal(
            intra.predict(*refs, modes, n, c_idx, bit_depth=bd),
            intra.predict_plain(*refs, modes, n, c_idx, bd))


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


def _b_forced(tree, want):
    """The forced inputs of a B decide scan that replay the decisions
    ``want`` (raster, as `BTreeEncoder.encode_async_load` builds them)."""
    cells = tree._cell_decisions_b(want)
    kinds = cells["kinds"]
    choice = torch.where(kinds == 0, cells["merge"],
                         torch.where(kinds == 1, 1 + cells["dir"].long(), 5))
    c16 = (choice, cells["mvd0"], cells["mvp0"], cells["mvd1"],
           cells["mvp1"])
    return dict(c16=c16, c32=[v[tree._q0_cell] for v in c16],
                split=want["split"].reshape(-1))


@pytest.mark.parametrize("poc,p0,p1", [(2, 0, 4), (1, 0, 4)])
def test_decide_b_kernel(cuda_dev, poc, p0, p1):
    """K19 against the plain B scan on the card on a 128x96 B frame's
    phase-1 outputs: free (decisions, directions, MVs and cost rows
    bit-equal) and forced with the plain scan's decisions, with dsf 256 in
    the middle of the pyramid and unequal distances (POC 1 between 0 and
    4)."""
    from x265amod_tpu_torch.models.inter_tree import BTreeEncoder
    from x265amod_tpu_torch.models.mvpred import dist_scale_factor
    rng = np.random.default_rng(80 + poc)
    w, h = 128, 96
    tree = BTreeEncoder(w, h, search_range=8, subme=1, device=cuda_dev)
    y = _plane(rng, h, w, cuda_dev)
    r0 = torch.roll(y, (1, -2), (0, 1))
    r1 = (torch.roll(y, (-2, 1), (0, 1)) + 3).clamp(0, 255)
    r1[:32, :48] = _plane(rng, 32, 48, cuda_dev)     # intra wins there
    dsf = (dist_scale_factor(poc, p0, p1), dist_scale_factor(poc, p1, p0))
    maps = tree._maps(30)
    st1 = tree._phase1_b(y, (r0, r1), maps, [])
    got = tree._decide_b_kernel(st1, maps, dsf, want_costs=True)
    want = tree._decide_b_plain(st1, maps, dsf, want_costs=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k
    forced = _b_forced(tree, want)
    fk = tree._decide_b_kernel(None, maps, dsf, forced=forced)
    fp = tree._decide_b_plain(None, maps, dsf, forced=forced)
    for k in fp:
        assert torch.equal(fk[k], fp[k]), k
    for k in ("split", "dir", "mv0", "mv1"):
        assert torch.equal(fk[k], want[k]), k


def _frames(rng, f, h, w, dev, hi=256):
    return tuple(torch.as_tensor(rng.integers(0, hi, s).astype(np.int32),
                                 device=dev)
                 for s in ((f, h, w), (f, h // 2, w // 2), (f, h // 2,
                                                            w // 2)))


@pytest.mark.parametrize("bd,rdoq", [(8, False), (8, True), (10, False),
                                     (10, True)])
def test_commit_intra_kernel_intra_tree(cuda_dev, bd, rdoq):
    """K20 against the intra tree's plain commit on the card: 64x64, two
    frames, a random forced split and random modes, bit depth 8 and 10,
    RDOQ off and on (recon, levels and modes bit-equal)."""
    from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
    rng = np.random.default_rng(90 + bd + rdoq)
    tree = IntraTreeEncoder(64, 64, deblock=False, device=cuda_dev,
                            bit_depth=bd, rdoq=rdoq)
    y, cb, cr = _frames(rng, 2, 64, 64, cuda_dev, 1 << bd)
    split = torch.as_tensor(rng.integers(0, 2, (2, 2, 2)).astype(np.int32),
                            device=cuda_dev)
    split[0, 0, 0], split[1, 0, 0] = 0, 1
    modes = torch.as_tensor(rng.integers(0, 35, (2, 4, 4)).astype(np.int32),
                            device=cuda_dev)
    maps = tree._maps(30 if bd == 8 else 22)
    got = tree._commit_kernel(y, cb, cr, maps, split, modes)
    want = tree._commit_plain(y, cb, cr, maps, split, modes)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g, wt)


@pytest.mark.parametrize("b_tree,rdoq", [(False, False), (False, True),
                                         (True, False), (True, True)])
def test_commit_intra_kernel_inter_tree(cuda_dev, b_tree, rdoq):
    """K20 against the P/B trees' plain commit on the card: a 64x64 frame
    whose cells are inter (their recon and levels given) or intra (kind 2,
    about a third, re-coded), RDOQ off and on (on luma and chroma)."""
    from x265amod_tpu_torch.models.inter_tree import (BTreeEncoder,
                                                      InterTreeEncoder)
    rng = np.random.default_rng(95 + 2 * b_tree + rdoq)
    cls = BTreeEncoder if b_tree else InterTreeEncoder
    tree = cls(64, 64, device=cuda_dev, rdoq=rdoq)
    y, cb, cr = (t[0] for t in _frames(rng, 1, 64, 64, cuda_dev))
    n16 = 16
    kinds = torch.as_tensor(rng.integers(0, 3, n16), device=cuda_dev)
    kinds[:4] = 0                        # a CTU without intra cells
    imode = torch.as_tensor(rng.integers(0, 35, n16).astype(np.int32),
                            device=cuda_dev)
    rec = tuple(torch.as_tensor(rng.integers(0, 256, (n16, n, n))
                                .astype(np.int32), device=cuda_dev)
                for n in (16, 8, 8))
    lv = tuple(torch.as_tensor(rng.integers(-3, 4, (n16, n, n))
                               .astype(np.int16), device=cuda_dev)
               for n in (16, 8, 8))
    maps = tree._maps(30)
    got = tree._commit_kernel(y, cb, cr, maps, kinds, imode,
                              tuple(t.clone() for t in lv), rec)
    want = tree._commit_plain(y, cb, cr, maps, kinds, imode, lv, rec)
    for g, wt in zip(got[0] + got[1] + (got[2],),
                     want[0] + want[1] + (want[2],)):
        assert g.dtype == wt.dtype and torch.equal(g, wt)


def _levels(rng, f, h16, w16, dev, density=0.3):
    """Random sparse levels of F frames: ly [F, h16, w16, 16, 16], lcb,
    lcr [F, h16, w16, 8, 8] int16, a cell coded with probability density."""
    out = []
    for n in (16, 8, 8):
        coded = rng.random((f, h16, w16, 1, 1)) < density
        v = rng.integers(-3, 4, (f, h16, w16, n, n)) * (rng.random(
            (f, h16, w16, n, n)) < 0.1) * coded
        out.append(torch.as_tensor(v.astype(np.int16), device=dev))
    return tuple(out)


@pytest.mark.parametrize("shape", ["intra_tree", "inter_p", "inter_b",
                                   "flat"])
def test_deblock_maps_kernel(cuda_dev, shape):
    """K21 against its plain version: the three shapes of the maps (the
    inter trees with and without directions, L1 MVs and reference indices),
    QP maps with offsets, sparse and empty frames, bit for bit."""
    from x265amod_tpu_torch.ops import deblock
    rng = np.random.default_rng(200 + len(shape))
    f, h16, w16 = 3, 6, 10
    lv = _levels(rng, f, h16, w16, cuda_dev)
    for t in lv:
        t[1].zero_()                      # a frame with nothing coded
    flat = shape == "flat"
    qp_sig = torch.as_tensor(rng.integers(20, 45, (h16, w16) if flat else
                                          (h16 // 2, w16 // 2))
                             .astype(np.int32), device=cuda_dev)
    split = None if flat else torch.as_tensor(
        rng.integers(0, 2, (f, h16 // 2, w16 // 2)).astype(np.int32),
        device=cuda_dev)
    inter = None
    if shape.startswith("inter"):
        def r(lo, hi, *s):
            return torch.as_tensor(rng.integers(lo, hi, (f, h16, w16) + s)
                                   .astype(np.int32), device=cuda_dev)
        b = shape == "inter_b"
        inter = (r(0, 3), r(1, 4) if b else None, r(-9, 10, 2),
                 r(-9, 10, 2) if b else None, None if b else r(0, 3))
    got = deblock.deblock_maps(lv, 30, qp_sig, split, inter)
    want = deblock.deblock_maps_plain(lv, 30, qp_sig, split, inter)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt.to(torch.int32))


@pytest.mark.parametrize("ssim", [True, False])
def test_frame_metrics_kernel(cuda_dev, ssim):
    """K22 against its plain version: SSE exact, SSIM within 1e-6."""
    from x265amod_tpu_torch.ops import metrics
    rng = np.random.default_rng(210 + ssim)
    src = _frames(rng, 3, 64, 96, cuda_dev, 1024 if not ssim else 256)
    rec = tuple(torch.clamp(t + torch.as_tensor(
        rng.integers(-6, 7, t.shape).astype(np.int32), device=cuda_dev), 0,
        255 if ssim else 1023) for t in src)
    got = metrics.frame_metrics(src, rec, ssim)
    want = metrics.frame_metrics_plain(src, rec, ssim)
    assert torch.equal(got[:, :3], want[:, :3])
    assert (got[:, 3] - want[:, 3]).abs().max().item() <= 1e-6


def test_mv_argmin_kernel_on_crafted_ties(cuda_dev):
    """The ME argmin kernel against `int_mv_argmin_plain`: grids with two
    MVs within a few ulps of each other (where the FMA and the rounded
    cost pick differently) and exact ties (the first index wins)."""
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(220)
    sr, n = 8, 4096
    s = 2 * sr + 1
    lam = rng.uniform(1.0, 300.0, n).astype(np.float32)
    grid = rng.uniform(1e3, 1e6, (n, s, s)).astype(np.float32)
    # candidate a at (-sr, -sr), b at (0, 0): cost b - cost a within ulps
    bits_a = float(me.mvd_bits(torch.tensor([-4 * sr, -4 * sr])))
    cb = rng.uniform(1e3, 1e5, n).astype(np.float32)
    ca = (cb.astype(np.float64) + lam * 2.0 - lam.astype(np.float64)
          * bits_a)
    ca = (ca * (1 + rng.integers(-3, 4, n) * 2.0 ** -23)).astype(np.float32)
    grid[:, 0, 0], grid[:, sr, sr] = ca, cb
    grid[::7, 1, 1] = grid[::7, 0, 0]       # exact ties elsewhere
    g = torch.as_tensor(grid, device=cuda_dev)
    la = torch.as_tensor(lam, device=cuda_dev)
    assert torch.equal(me.int_mv_argmin(g, la, sr),
                       me.int_mv_argmin_plain(g, la, sr))


@pytest.mark.parametrize("lossless,aq,f", [(False, False, 1), (False, True, 2),
                                           (True, False, 1), (True, True, 2)])
def test_intra16_scan_kernel(cuda_dev, lossless, aq, f):
    """K23 against the flat encoder's plain scan on the card: 96x64, one
    frame or a batch of two, random content, AQ offsets or not, lossy and
    lossless (recon, levels and modes bit-equal)."""
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    rng = np.random.default_rng(240 + 2 * lossless + aq)
    enc = IntraFrameEncoder(96, 64, deblock=False, lossless=lossless,
                            device=cuda_dev)
    y, cb, cr = _frames(rng, f, 64, 96, cuda_dev)
    y[:, :16] = 200                        # a flat strip
    off = rng.uniform(-6, 6, (4, 6)) if aq else None
    maps = enc._maps(27, off)
    got = enc._scan_kernel(y, cb, cr, maps)
    want = enc._scan_plain(y, cb, cr, maps)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g, wt)


def _moving(rng, f, h, w, dev, step=3):
    """F frames of smooth content moving by ``step`` pixels a frame, with
    noise and a flat patch (where intra wins): [F, H, W] and chroma."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = [[], [], []]
    for t in range(f):
        y = 128 + 70 * np.sin((xx + step * t) / 9.0) * np.cos((yy - t) / 7.0)
        y = y + rng.normal(0, 3, (h, w))
        y[h // 2:h // 2 + 16, w // 4:w // 4 + 32] = 40 + 20 * t
        out[0].append(np.clip(y, 0, 255))
        c = 128 + 30 * np.sin((xx[::2, ::2] + step * t) / 13.0)
        out[1].append(c)
        out[2].append(255 - c)
    return tuple(torch.as_tensor(np.stack(p).astype(np.int32), device=dev)
                 for p in out)


@pytest.mark.parametrize("bidir,dsf", [(False, (0, 0)), (True, (-256, 256)),
                                       (True, (-85, -768))])
def test_decide_flat_kernels(cuda_dev, bidir, dsf):
    """K24 (P) and K25 (B) against their plain versions on the card at
    128x96 (sr 8, AQ offsets): free (choices, MVs, MVDs, MVP indices and
    the cost rows) and forced with the plain scan's decisions."""
    from x265amod_tpu_torch.models.b_frame import BFrameEncoder
    from x265amod_tpu_torch.models.inter_frame import InterFrameEncoder
    from x265amod_tpu_torch.ops import decide_flat as dfl
    rng = np.random.default_rng(250 + bidir + abs(dsf[0]))
    w, h = 128, 96
    y, cb, cr = _moving(rng, 3, h, w, cuda_dev)
    cls = BFrameEncoder if bidir else InterFrameEncoder
    enc = cls(w, h, search_range=8, device=cuda_dev)
    maps = enc._maps(30, rng.uniform(-6, 6, (h // 16, w // 16)))
    lam = maps["lam"].reshape(-1)
    if bidir:
        st1 = enc._phase1(y[1], (y[0], y[2]), maps, [])
        args = (enc.sch, st1["grids"], st1["d"], st1["rb"], st1["di"],
                st1["mv_me"], lam, enc.sr, dsf, enc.hdr_bits)
        run, plain = dfl.decide_b, dfl.decide_b_plain
        fkeys = ("choice", "mvd0", "mvp0", "mvd1", "mvp1")
    else:
        st1 = enc._phase1(y[1], y[0], maps)
        args = (enc.sch, st1["grid"], st1["d"], st1["rb"], st1["di"],
                st1["mv_me"], lam, enc.sr, enc.hdr_bits)
        run, plain = dfl.decide_p, dfl.decide_p_plain
        fkeys = ("choice", "mvd", "mvp")
    got = run(*args, want_costs=True)
    want = plain(*args, want_costs=True)
    assert set(got) == set(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert len(set(want["choice"].tolist())) >= 3
    forced = tuple(want[k] for k in fkeys)
    nones = (None,) * 5
    fargs = args[:1] + nones + (lam,) + args[7:]
    got = run(*fargs, forced=forced)
    want_f = plain(*fargs, forced=forced)
    for k in want_f:
        assert torch.equal(got[k], want_f[k]), k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("st", ["P", "B"])
def test_intra16_scan_commit_kernel(cuda_dev, st):
    """K23 as the commit of a flat P/B frame against the plain scan on the
    card: 96x64, random kinds (about 40 % intra), inter recon and levels
    given; recon, levels and modes bit-equal (inter cells untouched, mode
    1 there)."""
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    rng = np.random.default_rng(260 + (st == "B"))
    enc = IntraFrameEncoder(96, 64, deblock=False, device=cuda_dev)
    y, cb, cr = _frames(rng, 1, 64, 96, cuda_dev)
    rec = tuple(torch.clamp(t + torch.as_tensor(
        rng.integers(-9, 10, t.shape).astype(np.int32), device=cuda_dev), 0,
        255) for t in (y, cb, cr))
    lv = tuple(torch.as_tensor(rng.integers(-3, 4, s).astype(np.int16),
                               device=cuda_dev)
               for s in ((1, 4, 6, 16, 16), (1, 4, 6, 8, 8), (1, 4, 6, 8, 8)))
    kinds = torch.as_tensor(np.where(rng.random((1, 4, 6)) < 0.4, 2,
                                     rng.integers(0, 2, (1, 4, 6)))
                            .astype(np.int32), device=cuda_dev)
    maps = enc._maps(27, rng.uniform(-6, 6, (4, 6)))
    # the kernel updates its recon and levels in place: give it copies
    got = enc._scan_kernel(y, cb, cr, maps, (
        kinds, tuple(t.clone() for t in rec), tuple(t.clone() for t in lv),
        st))
    want = enc._scan_plain(y, cb, cr, maps, (kinds, rec, lv, st))
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g, wt)
    inter_cells = (kinds[0] != 2)
    assert torch.equal(got[3][0][inter_cells], lv[0][0][inter_cells])
    assert (got[6][0][inter_cells] == 1).all()


@pytest.mark.parametrize("bidir", [False, True])
def test_deblock_maps_kernel_flat_inter(cuda_dev, bidir):
    """K21's fourth shape (the flat CTB16 P/B frame: bS from kinds,
    directions and MVs with each cell's luma cbf, the QP chain per CTB16)
    against its plain version: 3 frames of 96x64 cells, random motion."""
    from x265amod_tpu_torch.ops import deblock
    rng = np.random.default_rng(270 + bidir)
    f, h16, w16 = 3, 6, 8
    lv = [torch.as_tensor((rng.random((f, h16, w16, n, n)) < 0.01)
                          .astype(np.int16), device=cuda_dev)
          for n in (16, 8, 8)]
    qp_sig = torch.as_tensor(rng.integers(20, 45, (h16, w16))
                             .astype(np.int32), device=cuda_dev)

    def r(lo, hi, *s):
        return torch.as_tensor(rng.integers(lo, hi, (f, h16, w16) + s)
                               .astype(np.int32), device=cuda_dev)
    inter = (r(0, 3), r(1, 4) if bidir else None, r(-9, 10, 2),
             r(-9, 10, 2) if bidir else None, None)
    got = deblock.deblock_maps(lv, 30, qp_sig, None, inter)
    want = deblock.deblock_maps_plain(lv, 30, qp_sig, None, inter)
    for g, wt in zip(got, want):
        assert torch.equal(g, wt.to(torch.int32))


@pytest.mark.parametrize("preset", [False, True])
def test_flat_inter_stream_card_equals_cpu(cuda_dev, preset):
    """`Encoder(Param(width, height))` (IDR + flat P) and preset medium
    without --ctu (the flat B pyramid, SAO, AQ, CU-tree) at 96x64: the
    card's stream equals the CPU's byte for byte."""
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.utils import params
    rng = np.random.default_rng(280)
    y, cb, cr = (t.cpu().numpy().astype(np.uint8)
                 for t in _moving(rng, 6, 64, 96, "cpu"))
    frames = list(zip(y, cb, cr))
    streams = []
    for dev in (cuda_dev, "cpu"):
        if preset:
            p = params.param_default_preset("medium")
            p.width, p.height, p.rc_lookahead, p.info = 96, 64, 4, False
        else:
            p = params.Param(width=96, height=64, info=False)
        streams.append(b"".join(o.nals for o in Encoder(
            p, device=dev).encode_pipelined(frames)))
    assert streams[0] == streams[1]


def _texture(rng, f, h, w, dev):
    """F frames of smooth texture with noise, a flat band and a hard edge,
    so that the 35 modes and the QPs spread the decisions."""
    yy, xx = np.mgrid[0:h, 0:w]
    out = [[], [], []]
    for t in range(f):
        y = 128 + 90 * np.sin((xx + 5 * t) / (7.0 + t)) * np.cos(yy / 9.0)
        y = y + rng.normal(0, 6, (h, w))
        y[h // 3:h // 3 + 32] = 30 + 7 * t
        y[:, w // 2:w // 2 + 3] = 255
        out[0].append(np.clip(y, 0, 255))
        c = 128 + 40 * np.sin((xx[::2, ::2] - 3 * t) / 11.0)
        out[1].append(np.clip(c + rng.normal(0, 3, c.shape), 0, 255))
        out[2].append(255 - c)
    return tuple(torch.as_tensor(np.stack(p).astype(np.int32), device=dev)
                 for p in out)


def _check_tickets(sched, kinds, f, wc, hc):
    from x265amod_tpu_torch.ops.commit import scan_tickets
    want = scan_tickets(None if kinds is None else kinds.cpu().numpy(), f,
                        wc, hc)
    s = sched.cpu().numpy()
    assert s[0] == len(want) and s[1] >= len(want)
    assert s[2:2 + len(want)].tolist() == want


@pytest.mark.parametrize("w,h,f,qp,lossless", [
    (1920, 1088, 1, 32, False), (1920, 1088, 1, 0, False),
    (1920, 1088, 1, 51, False), (1920, 1088, 1, 32, True),
    (640, 368, 16, 32, False)])
def test_intra16_scan_ticketed_kernel(cuda_dev, w, h, f, qp, lossless):
    """K23 at the main path's shapes against the plain scan on the card: a
    1920x1088 frame at QP 32, 0 and 51 and lossless, and a 16-frame batch
    at 640x368; two launches a call, the ticket list equal to
    `scan_tickets`."""
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    from x265amod_tpu_torch.ops import commit, cuda_lib
    rng = np.random.default_rng(qp + 7 * f + lossless)
    enc = IntraFrameEncoder(w, h, deblock=False, lossless=lossless,
                            device=cuda_dev)
    y, cb, cr = _texture(rng, f, h, w, cuda_dev)
    maps = enc._maps(qp)
    before = cuda_lib.LAUNCHES["intra16_scan"]
    got = enc._scan_kernel(y, cb, cr, maps)
    assert cuda_lib.LAUNCHES["intra16_scan"] == before + 2
    want = enc._scan_plain(y, cb, cr, maps)
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g, wt)
    rec = tuple(torch.empty_like(t) for t in (y, cb, cr))
    lv = tuple(torch.empty_like(t) for t in got[3:6])
    sched = commit.intra16_scan((y, cb, cr), rec, lv,
                                torch.empty_like(got[6]), maps,
                                lossless=lossless)
    _check_tickets(sched, None, f, w // 16, h // 16)


def _commit_kinds(name, rng, hc, wc):
    k = rng.integers(0, 2, (1, hc, wc))
    yy, xx = np.mgrid[0:hc, 0:wc]
    if name == "all":
        k[:] = 2
    elif name == "column":
        k[0, :, wc // 3] = 2
    elif name == "diagonal":            # a chain through top-right links
        k[0, (xx + yy) == wc // 2] = 2
    elif name == "checker":
        k[0, (xx + yy) % 2 == 0] = 2
    elif name == "patch":               # 336 of 8160 CTUs at 1920x1088
        k[0, 27:41, 48:72] = 2
    return k.astype(np.int32)


@pytest.mark.parametrize("name", ["all", "none", "column", "diagonal",
                                  "checker", "patch"])
def test_intra16_scan_ticketed_commit(cuda_dev, name):
    """K23 as the commit of a flat P frame (1920x1088) against the plain
    scan on the card, on adversarial kinds maps: all intra, no intra, one
    intra column, one intra diagonal chain, a checkerboard, and PERF.md's
    336-CTU patch; inter recon and levels in place, untouched."""
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    from x265amod_tpu_torch.ops import commit
    rng = np.random.default_rng(len(name))
    w, h = 1920, 1088
    hc, wc = h // 16, w // 16
    enc = IntraFrameEncoder(w, h, deblock=False, device=cuda_dev)
    y, cb, cr = _texture(rng, 1, h, w, cuda_dev)
    rec = tuple(torch.clamp(t + torch.as_tensor(
        rng.integers(-9, 10, t.shape).astype(np.int32), device=cuda_dev), 0,
        255) for t in (y, cb, cr))
    lv = tuple(torch.as_tensor(rng.integers(-3, 4, s).astype(np.int16),
                               device=cuda_dev)
               for s in ((1, hc, wc, 16, 16), (1, hc, wc, 8, 8),
                         (1, hc, wc, 8, 8)))
    kinds = torch.as_tensor(_commit_kinds(name, rng, hc, wc),
                            device=cuda_dev)
    maps = enc._maps(32, rng.uniform(-6, 6, (hc, wc)))
    got = enc._scan_kernel(y, cb, cr, maps, (
        kinds, tuple(t.clone() for t in rec), tuple(t.clone() for t in lv),
        "P"))
    want = enc._scan_plain(y, cb, cr, maps, (kinds, rec, lv, "P"))
    for g, wt in zip(got, want):
        assert g.dtype == wt.dtype and torch.equal(g, wt)
    inter_cells = kinds[0] != 2
    assert torch.equal(got[3][0][inter_cells], lv[0][0][inter_cells])
    sched = commit.intra16_scan(
        (y, cb, cr), tuple(t.clone() for t in rec),
        tuple(t.clone() for t in lv), torch.ones_like(got[6]), maps,
        kinds=kinds, st="P")
    _check_tickets(sched, kinds, 1, wc, hc)


@pytest.mark.parametrize("rdoq", [False, True])
@pytest.mark.parametrize("bd", [8, 10])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_residual_chain_lane_groups(cuda_dev, n, bd, rdoq):
    """K2's lane-group design against the plain chain: n 8, 16 and 32, bit
    depth 8 and 10, RDOQ off and on, intra and inter rounding, QP 0 and
    51, residuals at +-255 / +-1023 (flat 0 against a flat peak and back),
    and the candidate counts the path uses (1, 3, 4 and 35: several blocks
    a thread block, and several rounds of groups) over a block count that
    no thread block size divides."""
    from x265amod_tpu_torch.ops import residual
    rng = np.random.default_rng(n + bd + rdoq)
    peak = (1 << bd) - 1
    b = 37
    for k in (1, 3, 4, 35):
        orig = rng.integers(0, peak + 1, (b, n, n)).astype(np.int32)
        pred = np.clip(orig[:, None] + rng.integers(
            -60, 61, (b, k, n, n)) * (peak // 255), 0, peak).astype(np.int32)
        orig[0], pred[0] = 0, peak            # residual -peak
        orig[1], pred[1] = peak, 0            # residual +peak
        orig[2], pred[2] = 77, 77             # all-zero levels
        qp = rng.choice(np.array([0, 51, 12, 22, 27, 32, 37, 45], np.int32),
                        b)
        qp[:4] = (0, 51, 0, 51)
        lam = (10.0 ** rng.uniform(-1, 4, b)).astype(np.float32)
        o, p, q, la = (torch.as_tensor(a, device=cuda_dev)
                       for a in (orig, pred, qp, lam))
        for intra in (True, False):
            for sbh in (False, True):
                kw = dict(intra=intra, bit_depth=bd, rdoq=rdoq,
                          lam=la if rdoq else None, st="P" if intra else "B")
                got = residual.residual_chain(o, p, q, sbh, **kw)
                want = residual.residual_chain_plain(o, p, q, sbh, **kw)
                for g, wt in zip(got, want):
                    assert g.dtype == wt.dtype and torch.equal(g, wt)
                lv, _, ssd = residual.residual_chain(o, p, q, sbh,
                                                     want_recon=False, **kw)
                assert torch.equal(lv, want[0]) and torch.equal(ssd, want[2])
        assert int(want[0].abs().max()) > 0


def _flat_p_inputs(rng, wc, hc, sr, dev):
    """Synthetic flat P decide inputs: MVs that repeat (the merge pruning
    bites), some beyond the +-sr window (1e18 lookups), costs that let
    every choice win somewhere."""
    n, s = wc * hc, 2 * sr + 1
    mv = rng.integers(-2, 3, (n, 2)) * 4 + rng.integers(0, 2, (n, 2)) * 2
    far = rng.random(n) < 0.1
    mv[far] = rng.integers(-8 * sr, 8 * sr + 1, (int(far.sum()), 2))
    return [torch.as_tensor(a, device=dev) for a in (
        rng.uniform(0, 3000, (n, s, s)).astype(np.float32),
        rng.uniform(0, 3000, n).astype(np.float32),
        rng.uniform(0, 60, n).astype(np.float32),
        rng.uniform(500, 4000, n).astype(np.float32), mv.astype(np.int32),
        rng.uniform(2, 40, n).astype(np.float32))]


@pytest.mark.parametrize("wc,hc", [(120, 68), (1, 32), (32, 1), (9, 35)])
def test_decide_flat_p_row_walk(cuda_dev, wc, hc):
    """K24 (a thread a CTU row) against `decide_p_plain` on synthetic
    inputs passed straight to `decide_p`: 1920x1088 (68 rows across two
    warp boundaries) and grids of one column, one row and 9 x 35; free
    (choices, MVs, MVDs, MVP indices, cost rows) and forced with the
    plain scan's decisions."""
    from x265amod_tpu_torch.ops import cuda_lib
    from x265amod_tpu_torch.ops import decide_flat as dfl
    rng = np.random.default_rng(wc * 1000 + hc)
    sr, hdr = 16, 9.5
    grid, d, rb, di, me, lam = _flat_p_inputs(rng, wc, hc, sr, cuda_dev)
    sch = dfl.Schedule(wc, hc, cuda_dev)
    cuda_lib.reset_launches()
    got = dfl.decide_p(sch, grid, d, rb, di, me, lam, sr, hdr,
                       want_costs=True)
    assert cuda_lib.LAUNCHES["decide_flat"] == 1
    want = dfl.decide_p_plain(sch, grid, d, rb, di, me, lam, sr, hdr,
                              want_costs=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    if wc * hc > 100:
        assert len(set(want["choice"].tolist())) == 4
    forced = (want["choice"], want["mvd"], want["mvp"])
    got_f = dfl.decide_p(sch, None, None, None, None, None, lam, sr, hdr,
                         forced=forced)
    want_f = dfl.decide_p_plain(sch, None, None, None, None, None, lam, sr,
                                hdr, forced=forced)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k]), k
        assert torch.equal(got_f[k], want[k]), k


def _mv_palette(rng, sr):
    """MVs that repeat (the merge pruning bites), two at the +-sr edge (4 sr
    + 3 inside, 4 sr + 4 outside: 1e18) and sub-pel ones."""
    pal = rng.integers(-3, 4, (6, 2)) * 4
    pal[0] = (4 * sr + 3, -4 * sr - 4)
    pal[1] = (-4 * sr, 4 * sr + 4)

    def mvs(n, dev):
        mv = pal[rng.integers(0, 6, n)]
        mv = mv + (rng.random((n, 2)) < 0.3) * rng.integers(1, 4, (n, 2))
        return torch.as_tensor(mv.astype(np.int32), device=dev)
    return mvs


def _intra_costs(rng, n, dev):
    di = rng.uniform(500, 4000, n)
    di[rng.random(n) < 0.15] = rng.uniform(0, 50)
    return torch.as_tensor(di.astype(np.float32), device=dev)


def _uniform(rng, dev, *shape, lo=0.0, hi=3000.0):
    return torch.as_tensor(rng.uniform(lo, hi, shape).astype(np.float32),
                           device=dev)


_B_ROW_GRIDS = [(1, 1), (1, 6), (6, 1), (7, 5), (9, 3)]


@pytest.mark.parametrize("wc,hc", [(120, 68)] + _B_ROW_GRIDS)
def test_decide_flat_b_row_walk(cuda_dev, wc, hc):
    """K25 (a thread a CTU row) against `decide_b_plain` on synthetic
    inputs passed straight to `decide_b`: 1920x1088 (sr 16) and grids of
    one CTU, one column, one row, 7 x 5 and 9 x 3; free (choices,
    directions, MVs, MVDs, MVP indices, cost rows) and forced with the
    plain scan's decisions, bit for bit."""
    from x265amod_tpu_torch.ops import cuda_lib
    from x265amod_tpu_torch.ops import decide_flat as dfl
    rng = np.random.default_rng(wc * 1000 + hc + 7)
    sr, hdr, dsf = 16, 9.5, (-85, -768)
    n, s = wc * hc, 2 * sr + 1
    mvs = _mv_palette(rng, sr)
    grids = (_uniform(rng, cuda_dev, n, s, s), _uniform(rng, cuda_dev, n, s,
                                                         s))
    d, rb = _uniform(rng, cuda_dev, n, 3), _uniform(rng, cuda_dev, n, 3,
                                                     hi=60.0)
    di, lam = _intra_costs(rng, n, cuda_dev), _uniform(rng, cuda_dev, n,
                                                        lo=2.0, hi=40.0)
    me = (mvs(n, cuda_dev), mvs(n, cuda_dev))
    sch = dfl.Schedule(wc, hc, cuda_dev)
    cuda_lib.reset_launches()
    got = dfl.decide_b(sch, grids, d, rb, di, me, lam, sr, dsf, hdr,
                       want_costs=True)
    assert cuda_lib.LAUNCHES["decide_flat_b"] == 1
    want = dfl.decide_b_plain(sch, grids, d, rb, di, me, lam, sr, dsf, hdr,
                              want_costs=True)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    if n > 100:
        assert len(set(want["choice"].tolist())) == 6
    forced = tuple(want[k] for k in ("choice", "mvd0", "mvp0", "mvd1",
                                     "mvp1"))
    nones = (None,) * 5
    got_f = dfl.decide_b(sch, *nones, lam, sr, dsf, hdr, forced=forced)
    want_f = dfl.decide_b_plain(sch, *nones, lam, sr, dsf, hdr,
                                forced=forced)
    for k in want_f:
        assert torch.equal(got_f[k], want_f[k]), k
        assert torch.equal(got_f[k], want[k]), k


@pytest.mark.parametrize("wc,hc", [(60, 34)] + _B_ROW_GRIDS)
def test_decide_b_row_walk(cuda_dev, wc, hc):
    """K19 (a thread a CTU32 row, every grid entry a step can price copied
    as it starts) against `_decide_b_plain` on synthetic inputs: 1920x1088
    (sr 16) and grids of one CTU, one column, one row, 7 x 5 and 9 x 3;
    MVs that repeat, sub-pel ones (the half-pel grid rows) and at the +-sr
    edge, cells where intra wins; free (every output and cost row) and
    forced with the plain scan's decisions, bit for bit."""
    from x265amod_tpu_torch.models.inter_tree import BTreeEncoder
    from x265amod_tpu_torch.ops import cuda_lib
    rng = np.random.default_rng(wc * 100 + hc)
    sr, dsf = 16, (128, -384)
    tree = BTreeEncoder(32 * wc, 32 * hc, search_range=sr, subme=1,
                        device=cuda_dev)
    n32, n16, s = wc * hc, 4 * wc * hc, 2 * sr + 1
    mvs = _mv_palette(rng, sr)
    st1 = dict(
        grid0=torch.cat([_uniform(rng, cuda_dev, 2 * n16, s, s),
                         _uniform(rng, cuda_dev, 2 * n32, s, s, hi=12000.0)]),
        grid1=torch.cat([_uniform(rng, cuda_dev, 2 * n16, s, s),
                         _uniform(rng, cuda_dev, 2 * n32, s, s, hi=12000.0)]),
        d16=_uniform(rng, cuda_dev, n16, 3),
        rb16=_uniform(rng, cuda_dev, n16, 3, hi=60.0),
        di16=_intra_costs(rng, n16, cuda_dev), mv0_16=mvs(n16, cuda_dev),
        mv1_16=mvs(n16, cuda_dev), d32=_uniform(rng, cuda_dev, n32, 3,
                                                hi=12000.0),
        rb32=_uniform(rng, cuda_dev, n32, 3, hi=120.0),
        mv0_32=mvs(n32, cuda_dev), mv1_32=mvs(n32, cuda_dev))
    maps = dict(lam16=_uniform(rng, cuda_dev, n16, lo=2.0, hi=40.0),
                lam32=_uniform(rng, cuda_dev, n32, lo=2.0, hi=40.0))
    cuda_lib.reset_launches()
    got = tree._decide_b_kernel(st1, maps, dsf, want_costs=True)
    assert cuda_lib.LAUNCHES["decide_b"] == 1
    want = tree._decide_b_plain(st1, maps, dsf, want_costs=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    if n32 > 100:
        assert len(set(want["chq"].tolist())) == 6
        assert want["split"].any() and not want["split"].all()
    forced = _b_forced(tree, want)
    fk = tree._decide_b_kernel(None, maps, dsf, forced=forced)
    fp = tree._decide_b_plain(None, maps, dsf, forced=forced)
    for k in fp:
        assert torch.equal(fk[k], fp[k]), k
    for k in ("split", "dir", "mv0", "mv1"):
        assert torch.equal(fk[k], want[k]), k


@pytest.mark.parametrize("wc,hc,nr", [
    (40, 23, 1), (40, 23, 3), (60, 34, 1), (60, 34, 4), (1, 9, 2),
    (9, 1, 2), (1, 40, 3), (40, 1, 1), (7, 5, 4)])
def test_decide_p_row_walk(cuda_dev, wc, hc, nr):
    """K17 (a thread a CTU32 row, the 36 grid entries a step can price
    copied as it starts) against `InterTreeEncoder._decide_plain` on
    synthetic phase-1 outputs: 1280x736 at R 1 and 3, 1920x1088 at R 1
    and 4 (34 rows across two warps), one-row and one-column grids; MVs
    that repeat, sub-pel ones, at +-sr and beyond (1e18), references drawn
    from all R so that neighbours lie on other references; free (every
    output and cost row) and forced with the plain scan's decisions, bit
    for bit."""
    from x265amod_tpu_torch.models.inter_tree import InterTreeEncoder
    from x265amod_tpu_torch.models.mvpred import ref_list_tables
    from x265amod_tpu_torch.ops import cuda_lib
    rng = np.random.default_rng(wc * 100 + hc + nr)
    sr = 16 if hc > 30 else 8
    tree = InterTreeEncoder(32 * wc, 32 * hc, search_range=sr, subme=1,
                            device=cuda_dev)
    n32, n16, s = wc * hc, 4 * wc * hc, 2 * sr + 1
    mvs = _mv_palette(rng, sr)

    def refs(n):
        return torch.as_tensor(rng.integers(0, nr, n).astype(np.int32),
                               device=cuda_dev)
    st1 = dict(
        grid=torch.cat([_uniform(rng, cuda_dev, 2 * nr * n16, s, s),
                        _uniform(rng, cuda_dev, 2 * nr * n32, s, s,
                                 hi=12000.0)]),
        d16=_uniform(rng, cuda_dev, n16),
        rb16=_uniform(rng, cuda_dev, n16, hi=60.0),
        di16=_intra_costs(rng, n16, cuda_dev), mv16=mvs(n16, cuda_dev),
        ref16=refs(n16), d32=_uniform(rng, cuda_dev, n32, hi=12000.0),
        rb32=_uniform(rng, cuda_dev, n32, hi=120.0),
        mv32=mvs(n32, cuda_dev), ref32=refs(n32))
    maps = dict(lam16=_uniform(rng, cuda_dev, n16, lo=2.0, hi=40.0),
                lam32=_uniform(rng, cuda_dev, n32, lo=2.0, hi=40.0))
    dsf, bits = ref_list_tables(9, [8, 5, 3, 0][:nr])
    tables = (torch.as_tensor(dsf, device=cuda_dev),
              torch.as_tensor(bits, device=cuda_dev))
    cuda_lib.reset_launches()
    got = tree._decide_kernel(st1, maps, tables, want_costs=True)
    assert cuda_lib.LAUNCHES["decide_p"] == 1
    want = tree._decide_plain(st1, maps, tables, want_costs=True)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k],
                                                             want[k]), k
    if n32 > 100:
        assert len(set(want["chq"].tolist())) == 4
        assert want["split"].any() and not want["split"].all()
        assert (want["js32"][:, :2] >= 1e18).any()
    cells = tree._cell_decisions(want)
    kinds = cells["kinds"]
    forced = dict(c16=(torch.where(kinds == 0, cells["merge"],
                                   torch.where(kinds == 1, 2, 3)),
                       cells["mvd"], cells["mvp"], cells["ref"]),
                  split=want["split"].reshape(-1))
    forced["c32"] = [v[tree._q0_cell] for v in forced["c16"]]
    fk = tree._decide_kernel(None, maps, tables, forced=forced)
    fp = tree._decide_plain(None, maps, tables, forced=forced)
    assert fk.keys() == fp.keys()
    for k in fp:
        assert torch.equal(fk[k], fp[k]), k
    for k in ("split", "mv", "ref"):
        assert torch.equal(fk[k], want[k]), k


@pytest.mark.parametrize("w,h,n,plane", [
    (1920, 1088, 16, "noise"), (1920, 1088, 32, "noise"),
    (1280, 736, 16, "noise"), (1280, 736, 32, "noise"),
    (256, 128, 16, "flat0"), (256, 128, 32, "flat255")])
def test_subpel_refine_warp_kernel(cuda_dev, w, h, n, plane):
    """K6 (a warp a block, the 25 candidates' partial SSDs in registers, a
    transposing butterfly, a shuffle minimum) against
    `subpel_refine_plain`: 1920x1088 and 1280x736 at n 16 and 32 with MVs
    at +-sr on the border blocks (the window clamps) and beyond; flat 0
    and 255 planes where all 25 SSDs tie; lambda 0 (all 25 costs tied on
    the flat planes: the first minimum decides), mid-range and large; MVs
    and SSDs bit for bit."""
    from x265amod_tpu_torch.ops import cuda_lib, me
    rng = np.random.default_rng(w + n + len(plane))
    sr = 16
    if plane == "noise":
        yy, xx = np.mgrid[0:h, 0:w]
        ref = np.clip(128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
                      + rng.normal(0, 20, (h, w)), 0, 255)
    else:
        ref = np.full((h, w), 0 if plane == "flat0" else 255)
    ref = torch.as_tensor(ref.astype(np.int32), device=cuda_dev)
    nb, wb = (h // n) * (w // n), w // n
    near = torch.clamp(torch.roll(ref, (1, -2), (0, 1)) + torch.as_tensor(
        rng.integers(-3, 4, (h, w)).astype(np.int32), device=cuda_dev),
        0, 255)
    cur = near.reshape(h // n, n, wb, n).permute(0, 2, 1, 3) \
        .reshape(nb, n, n).contiguous()
    cur[1::2] = _plane(rng, n * (nb // 2), n, cuda_dev).reshape(-1, n, n)
    mv = rng.integers(-sr, sr + 1, (nb, 2)).astype(np.int32)
    mv[:wb] = (-sr, -sr)
    mv[-wb:] = (sr, sr)
    mv[::wb] = (-sr - 3, sr)
    mv[wb - 1::wb] = (sr, -sr)
    mv = torch.as_tensor(mv, device=cuda_dev)
    lam = rng.uniform(0, 300, nb).astype(np.float32)
    lam[::3] = 0.0
    lam[1::4] = 4.0e5
    lam = torch.as_tensor(lam, device=cuda_dev)
    cuda_lib.reset_launches()
    got = me.subpel_refine(ref, cur, mv, lam, n)
    assert cuda_lib.LAUNCHES["subpel"] == 1
    want = me.subpel_refine_plain(ref, cur, mv, lam, n)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    if plane != "noise":
        tied = lam == 0
        assert torch.equal(got[0][tied], 4 * mv[tied] - 2)


def _k3_levels(rng, t, n):
    """TUs of every kind K3 meets: zero, a DC level, dense with more than 8
    nonzeros a group, remainders past the escape, +-32767."""
    lv = (rng.integers(-40, 41, (t, n, n))
          * (rng.random((t, n, n)) < 0.3)).astype(np.int64)
    lv[0::5] = 0
    lv[1::5] = 0
    lv[1::5, 0, 0] = rng.integers(1, 4, lv[1::5].shape[0])
    lv[2::5, :4, :4] = rng.integers(1, 4, (lv[2::5].shape[0], 4, 4))
    lv[3::5, 1, 2] = rng.choice([300, -2000, 9000], lv[3::5].shape[0])
    lv[4::7] = rng.choice([32767, -32767, 0, 1], (lv[4::7].shape[0], n, n))
    return torch.as_tensor(lv.astype(np.int16))


@pytest.mark.parametrize("st", ["I", "P", "B"])
@pytest.mark.parametrize("n,t", [(8, 2053), (16, 1031), (32, 517)])
def test_tu_bits_lane_groups(cuda_dev, n, t, st):
    """K3 (a lane a 4x4 group, warp reductions, persistent blocks) against
    `tu_bits_plain` bit for bit, at TU counts that fill no whole block
    (64, 32 and 8 TUs a block), luma and chroma, on QPs 0..51 and past."""
    from x265amod_tpu_torch.ops import estbits
    rng = np.random.default_rng(n * 10 + len(st))
    lv = _k3_levels(rng, t, n).to(cuda_dev)
    qp = torch.as_tensor(rng.integers(-3, 56, t).astype(np.int32),
                         device=cuda_dev)
    for c_idx in (0, 1):
        got = estbits.tu_bits(lv, c_idx, qp, st)
        want = estbits.tu_bits_plain(lv, c_idx, qp, st)
        assert got.dtype == want.dtype and torch.equal(got, want)
    # a view that starts 2 bytes into a TU: the wrapper realigns it
    odd = lv.reshape(-1)[1:1 + (t - 1) * n * n].reshape(t - 1, n, n)
    assert torch.equal(estbits.tu_bits(odd, 0, qp[:t - 1], st),
                       estbits.tu_bits_plain(odd, 0, qp[:t - 1], st))


def test_tu_bits_flat_intra_trial_count(cuda_dev):
    """K3 at the flat intra trial's 8160 x 35 TUs of 16x16 (many trips of
    the grid-stride loop), the qp broadcast over the 35 modes."""
    from x265amod_tpu_torch.ops import estbits
    rng = np.random.default_rng(35)
    lv = torch.as_tensor((rng.integers(-9, 10, (8160, 35, 16, 16))
                          * (rng.random((8160, 35, 16, 16)) < 0.1)).astype(
                              np.int16), device=cuda_dev)
    qp = torch.as_tensor(rng.integers(22, 40, 8160).astype(np.int32),
                         device=cuda_dev)[:, None].expand(-1, 35)
    got = estbits.tu_bits(lv, 0, qp, "P")
    assert got.shape == (8160, 35)
    assert torch.equal(got, estbits.tu_bits_plain(lv, 0, qp, "P"))


def _mc_plane(kind, rng, h, w, dev):
    """A plane for K7: texture with noise, or flat 0 / flat 255 (the two
    ends of the sample range)."""
    if kind == "flat0":
        p = np.zeros((h, w))
    elif kind == "flat255":
        p = np.full((h, w), 255)
    else:
        yy, xx = np.mgrid[0:h, 0:w]
        p = np.clip(128 + 90 * np.sin(xx / 5.0) * np.cos(yy / 3.0)
                    + rng.normal(0, 30, (h, w)), 0, 255)
    return torch.as_tensor(p.astype(np.int32), device=dev)


@pytest.mark.parametrize("plane", ["texture", "flat0", "flat255"])
@pytest.mark.parametrize("chroma", [False, True])
@pytest.mark.parametrize("n", [8, 16, 32])
def test_mc_qpel_kernel_1080p(cuda_dev, n, chroma, plane):
    """K7 against its plain version at the main path's sizes: a 1920x1088
    luma plane or a 960x544 chroma plane, n 8, 16 and 32, MVs at the
    window bound +-(sr + 2) luma pels or +-(sr / 2 + 2) chroma pels (sr
    16) past all four frame edges, every phase pair; textured, flat 0 and
    flat 255 planes; also through `mc_qpel_ref` at R 3 (one prediction a
    block, and every block on every plane)."""
    from chip_smoke import window_mvs
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(16 * n + chroma)
    h, w = (544, 960) if chroma else (1088, 1920)
    unit, m = (8, 16 // 2 + 2) if chroma else (4, 16 + 2)
    p = _mc_plane(plane, rng, h, w, cuda_dev)
    nb, wb = (h // n) * (w // n), w // n
    mv = torch.as_tensor(window_mvs(rng, nb, wb, unit, m), device=cuda_dev)
    fn, plain = ((me.mc_chroma_qpel, me.mc_chroma_qpel_plain) if chroma
                 else (me.mc_luma_qpel, me.mc_luma_qpel_plain))
    assert torch.equal(fn(p, mv, n), plain(p, mv, n))
    planes = torch.stack([p, _mc_plane("texture", rng, h, w, cuda_dev),
                          255 - p])
    for k in (nb, 3 * nb):
        mvk = torch.as_tensor(window_mvs(rng, k, wb, unit, m),
                              device=cuda_dev)
        ref = torch.as_tensor(rng.integers(0, 3, k).astype(np.int32),
                              device=cuda_dev)
        assert torch.equal(me.mc_qpel_ref(planes, mvk, ref, n, chroma),
                           me.mc_ref_plain(planes, mvk, ref, n, chroma))


@pytest.mark.parametrize("plane", ["texture", "flat0", "flat255"])
@pytest.mark.parametrize("n,chroma", [(16, False), (8, True)])
def test_mc_qpel_select_entry(cuda_dev, n, chroma, plane):
    """K7's select entry against its plain version at a flat B frame's
    final MC (1920x1088 luma n 16, 960x544 chroma n 8): directions 0-3,
    K9's rows copied for the blocks that use both lists, and, without
    them, those blocks bi-predicted in the same launch with every block's
    two MVs held to the window contract; `mc_select` launches K7 once a
    plane and K9 not at all."""
    from chip_smoke import window_mvs
    from x265amod_tpu_torch.ops import cuda_lib, me
    rng = np.random.default_rng(40 + n + len(plane))
    h, w = (544, 960) if chroma else (1088, 1920)
    unit, m = (8, 10) if chroma else (4, 18)
    r0 = _mc_plane(plane, rng, h, w, cuda_dev)
    r1 = _mc_plane("texture", rng, h, w, cuda_dev)
    nb, wb = (h // n) * (w // n), w // n
    mv0, mv1 = (torch.as_tensor(window_mvs(rng, nb, wb, unit, m),
                                device=cuda_dev) for _ in range(2))
    d = torch.as_tensor(rng.integers(0, 4, nb).astype(np.int32),
                        device=cuda_dev)
    bi = me.mc_bi(r0, r1, mv0, mv1, n, chroma, m)
    want = me.mc_sel_plain(r0, r1, mv0, mv1, d, n, chroma, bi)
    assert torch.equal(me.mc_qpel_sel(r0, r1, mv0, mv1, d, n, chroma, bi),
                       want)
    # without bi rows: the both-list blocks bi-predicted in the same launch
    cuda_lib.reset_launches()
    excess = []
    assert torch.equal(me.mc_qpel_sel(r0, r1, mv0, mv1, d, n, chroma, None,
                                      m, excess), want)
    assert int(excess[0]) == 0
    assert cuda_lib.LAUNCHES["mc_qpel"] == 1
    assert cuda_lib.LAUNCHES["mc_bi"] == 0
    # the window contract covers every block, whatever its direction: one
    # sample beyond it on a list-1 MV of a list-0 block
    k = int(torch.nonzero(d == 1)[0])
    mv1x = mv1.clone()
    mv1x[k, 0] = unit * (m + 1)
    me.mc_qpel_sel(r0, r1, mv0, mv1x, d, n, chroma, None, m, excess)
    assert int(excess[1]) == 1
    with pytest.raises(ValueError, match="window contract"):
        me.mc_qpel_sel(r0, r1, mv0, mv1x, d, n, chroma, None, m)
    if not chroma:
        cr0, cr1 = r0[::2, ::2].contiguous(), r1[::2, ::2].contiguous()
        cuda_lib.reset_launches()
        got = me.mc_select((r0, cr0, cr0), (r1, cr1, cr1), d, mv0, mv1, 16,
                           [])
        assert cuda_lib.LAUNCHES["mc_qpel"] == 3
        assert cuda_lib.LAUNCHES["mc_bi"] == 0
        u0 = ((d & 1) == 1)[:, None, None]
        both = ((d & 3) == 3)[:, None, None]
        for g, (a0, a1, nn, ch) in zip(got, ((r0, r1, 16, False),
                                             (cr0, cr1, 8, True),
                                             (cr0, cr1, 8, True))):
            mc = me.mc_chroma_qpel_plain if ch else me.mc_luma_qpel_plain
            want = torch.where(both, me.mc_bi_plain(a0, a1, mv0, mv1, nn, ch),
                               torch.where(u0, mc(a0, mv0, nn),
                                           mc(a1, mv1, nn)))
            assert torch.equal(g, want)


@pytest.mark.parametrize("plane", ["texture", "flat0", "flat255", "step"])
@pytest.mark.parametrize("n,chroma", [(16, False), (32, False), (8, True)])
def test_mc_bi_kernel_1080p(cuda_dev, n, chroma, plane):
    """K9 against its plain version at the main path's sizes: 1920x1088
    luma at n 16 (the flat B trial, a final MC) and 32 (the CTU32 trial),
    960x544 chroma at n 8; MVs at the window bound +-(sr + 2) luma pels or
    +-(sr / 2 + 2) chroma pels (sr 16) past all four frame edges, every
    phase pair; textured, flat 0, flat 255 and 0/255-step planes as list
    0's against a textured list 1; the window check one sample beyond."""
    from chip_smoke import window_mvs
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(90 + n + len(plane))
    h, w = (544, 960) if chroma else (1088, 1920)
    unit, m = (8, 10) if chroma else (4, 18)
    r0 = (_step_plane(rng, h, w, cuda_dev) if plane == "step"
          else _mc_plane(plane, rng, h, w, cuda_dev))
    r1 = _mc_plane("texture", rng, h, w, cuda_dev)
    nb, wb = (h // n) * (w // n), w // n
    mv0, mv1 = (torch.as_tensor(window_mvs(rng, nb, wb, unit, m),
                                device=cuda_dev) for _ in range(2))
    excess = []
    got = me.mc_bi(r0, r1, mv0, mv1, n, chroma, m, excess)
    assert torch.equal(got, me.mc_bi_plain(r0, r1, mv0, mv1, n, chroma))
    assert int(excess[0]) == 0
    me.mc_bi(r0, r1, mv0, mv1 - unit, n, chroma, m, excess)
    assert int(excess[1]) == 1


def _sao_frame(rng, h, w, dev):
    """Luma and chroma planes for K10's frame entry: `_sao_planes`'s flat
    0, flat 255 and rec == orig regions, a band-narrow stripe (every
    sample of its CTUs in one band) and stripes that reach the picture
    borders."""
    out = []
    for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)):
        o, r = (t.clone() for t in _sao_planes(rng, hh, ww, dev))
        r[hh // 4: hh // 2, ww // 2:] = 84
        o[hh // 4: hh // 2, ww // 2:] = torch.as_tensor(rng.integers(
            82, 88, (hh // 2 - hh // 4, ww - ww // 2)).astype(np.int32),
            device=dev)
        r[0, :], r[-1, :] = 255, 0
        r[:, 0] = torch.arange(hh, device=dev) * 3 % 256
        out.append((o.contiguous(), r.contiguous()))
    return out


@pytest.mark.parametrize("w,h,ctu", [(1920, 1088, 16), (1920, 1088, 32),
                                     (160, 96, 32), (96, 64, 16)])
def test_sao_analyse_frame_kernel(cuda_dev, w, h, ctu):
    """K10's frame entry (luma at ctu, cb + cr at ctu / 2, one launch) and
    its two single entries against the plain versions at a 1080p flat
    CTB16 frame's and a config-3 frame's shapes and at small ones, lam 0
    on every fifth CTU, bit for bit (the gain too)."""
    from x265amod_tpu_torch.ops import cuda_lib, sao
    rng = np.random.default_rng(w + ctu)
    (oy, ry), (ocb, rcb), (ocr, rcr) = _sao_frame(rng, h, w, cuda_dev)
    n = (h // ctu) * (w // ctu)
    lam = rng.uniform(0, 600, n).astype(np.float32)
    lam[::5] = 0.0
    lam = torch.as_tensor(lam, device=cuda_dev)
    want_y = sao.sao_analyse_plain(oy, ry, lam, ctu)
    want_c = sao.sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, lam, ctu // 2)
    cuda_lib.reset_launches()
    got_y, got_c = sao.sao_analyse_frame(oy, ocb, ocr, ry, rcb, rcr, lam,
                                         ctu)
    assert cuda_lib.LAUNCHES["sao_analyse"] == 1
    for g, p in zip(got_y + got_c, want_y + want_c):
        assert torch.equal(g, p)
    for g, p in zip(sao.sao_analyse(oy, ry, lam, ctu), want_y):
        assert torch.equal(g, p)
    for g, p in zip(sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, lam,
                                           ctu // 2), want_c):
        assert torch.equal(g, p)
    # the filter step: one analysis launch and three applications
    cuda_lib.reset_launches()
    planes, par = sao.sao_filter_frame(oy, ocb, ocr, ry, rcb, rcr, lam, ctu)
    assert cuda_lib.LAUNCHES["sao_analyse"] == 1
    assert cuda_lib.LAUNCHES["sao_apply"] == 3
    assert torch.equal(planes[0], sao.sao_apply_plain(ry, *want_y[:4], ctu))


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
@pytest.mark.parametrize("f,h16,w16", [(1, 68, 120), (16, 24, 40)])
def test_deblock_maps_two_launches(cuda_dev, f, h16, w16, mode):
    """K21's two launches against the plain maps at 1920x1088 (one frame)
    and 640x384 (a config-1 batch of 16 frames), in all four modes, on the
    coded patterns of `tests/test_torch_scan_schedule.py` that cross the
    CTAs' CTB rows (nothing coded, only the last or the first CTB, every
    other CTB, one a row, split CTB32s whose first coded cell is z = 1, 2
    or 3, random), bit for bit; the levels also at an offset that is not
    16-byte aligned."""
    from test_torch_scan_schedule import _K21_PATTERNS, _k21_coded, \
        _k21_levels
    from x265amod_tpu_torch.ops import deblock
    rng = np.random.default_rng(500 + 10 * mode + f)
    s_ = 1 if mode >= 2 else 2
    grid = (h16 // s_, w16 // s_)
    for pattern in _K21_PATTERNS:
        if pattern == "z123" and s_ == 1:
            continue
        cells = _k21_coded(pattern, f, h16, w16, s_, rng)
        lv = tuple(t.to(cuda_dev) for t in _k21_levels(cells, rng))
        qp_sig = torch.as_tensor(rng.integers(20, 45, grid).astype(np.int32),
                                 device=cuda_dev)
        split = None if s_ == 1 else torch.as_tensor(
            (rng.random((f,) + grid) < 0.7).astype(np.int32),
            device=cuda_dev)
        inter = None
        if mode in (1, 3):
            def r(lo, hi, *shp):
                return torch.as_tensor(
                    rng.integers(lo, hi, (f, h16, w16) + shp)
                    .astype(np.int32), device=cuda_dev)
            inter = (r(0, 3), r(1, 4), r(-6, 7, 2), r(-6, 7, 2),
                     r(0, 2) if mode == 1 else None)
        want = deblock.deblock_maps_plain(lv, 30, qp_sig, split, inter)
        got = deblock.deblock_maps(lv, 30, qp_sig, split, inter)
        for g, wt in zip(got, want):
            assert torch.equal(g, wt.to(torch.int32)), pattern
        # levels 2 bytes past an aligned start: the wrapper realigns them
        shifted = []
        for t in lv:
            flat = torch.empty(t.numel() + 1, dtype=torch.int16,
                               device=cuda_dev)
            flat[1:] = t.reshape(-1)
            shifted.append(flat[1:].view(t.shape))
        got = deblock.deblock_maps(tuple(shifted), 30, qp_sig, split, inter)
        for g, wt in zip(got, want):
            assert torch.equal(g, wt.to(torch.int32)), pattern
