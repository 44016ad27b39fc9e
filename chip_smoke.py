"""Chip smoke test of the PyTorch/CUDA port (x265amod_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build of the eight CUDA kernels
     (nvcc for sm_90a, all started together) with their ptxas reports;
  2. each kernel against its plain PyTorch version on the card, with its
     time, bound and the plain version's time: K1-K4 at the shapes of
     config 1's 16-frame batch, K5-K8 at config 2's per-frame shapes, plus
     edge inputs (QP 0 and 51, flat 0/255 blocks, frame borders without
     references, MVs at the search-range bound on border blocks), K2 with
     inter rounding, K3 at P-slice init states and K4 on bS 1 edges; the
     plain bS/QP maps and SSE/SSIM (rows 10-11) are timed too;
  3. BASELINE config 1 (640x360 all-intra ultrafast QP 30, CTU32) through
     `Encoder(device="cuda")`, 40 frames with the first 8 as warm-up; fps,
     PSNR-Y, kbps and the launch count of every kernel;
  4. config 1's bitstream on the card against the port's CPU bitstream
     (plain versions) on the first 2 frames;
  5. BASELINE config 2 (1280x720 low-delay P superfast QP 32, CTU32, one
     reference) through `Encoder(device="cuda")` and `encode_push`/`flush`,
     24 frames with the first 4 as warm-up, as the repository's bench.py
     runs it; fps, PSNR-Y, kbps, seconds, and every kernel's launch count;
  6. config 2's bitstream on the card against the CPU's for its first 3
     frames (I, P, P); where they differ, the CPU's decisions replayed on
     the card must give the CPU's stream.

Prints one JSON line of kernel figures, then the card's name and power
limit, then `{"ok": true, "device": {...}}` as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# int32 ALU peak: 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (a multiply-add
# counts two operations) = half the data sheet's 67 TFLOP/s fp32 rate
H100_INT32_OPS_PER_S = 33.5e12
# the kernels config 1 (all-intra) runs; config 2 runs all eight
CONFIG1_KERNELS = ("intra_pred", "residual_chain", "tu_bits", "deblock")


def synth_frames(w, h, n, seed=0):
    """The bench clip of the repository's bench.py (a copy)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for t in range(n):
        y = (128 + 80 * np.sin((xx + 3 * t) / 11.0) *
             np.cos((yy - 2 * t) / 7.0) +
             rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 30 * np.sin((xx[::2, ::2] + t) / 19.0)) \
            .clip(0, 255).astype(np.uint8)
        cr = (128 - 30 * np.cos((yy[::2, ::2] + t) / 23.0)) \
            .clip(0, 255).astype(np.uint8)
        frames.append((y, cb, cr))
    return frames


def log(msg):
    print(msg, flush=True)


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(fn, iters):
    import torch
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def bound_ms(nbytes, ops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---- phase 2: kernels against their plain versions --------------------------

def ref_inputs(rng, b, n, dev):
    """Raw refs with availability patterns, including blocks with no
    references at all (frame corner) and flat 0 / 255 content."""
    import torch
    top = rng.integers(0, 256, (b, 2 * n)).astype(np.int32)
    left = rng.integers(0, 256, (b, 2 * n)).astype(np.int32)
    cor = rng.integers(0, 256, b).astype(np.int32)
    at = rng.random((b, 2 * n)) < 0.8
    al = rng.random((b, 2 * n)) < 0.8
    ac = rng.random(b) < 0.8
    at[::7] = False
    al[::7] = False
    ac[::7] = False                    # no references: mid-grey fill
    at[1::7, n:] = False               # top-right missing
    al[1::7, n:] = False               # below-left missing
    top[2::7] = 0
    left[2::7] = 0
    cor[2::7] = 0
    top[3::7] = 255
    left[3::7] = 255
    cor[3::7] = 255
    return [torch.as_tensor(a, device=dev) for a in (top, left, cor, at, al,
                                                     ac)]


def check_equal(name, got, want, tol=0.0):
    import torch
    if got.shape != want.shape:
        raise AssertionError(f"{name}: shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    err = (got.double() - want.double()).abs().max().item() \
        if got.numel() else 0.0
    if err > tol or not torch.isfinite(got.double()).all():
        raise AssertionError(f"{name}: max abs error {err} > {tol}")
    return err


def phase_kernels(f, h16, w16, iters, dev="cuda"):
    """Each kernel at the main path's batch shapes: the estimate's calls for
    F frames (K1-K3) and the loop filter of F frames (K4)."""
    import torch
    from x265amod_tpu_torch.ops import cuda_lib, deblock, estbits, intra, \
        residual
    dev = torch.device(dev)
    rng = np.random.default_rng(1)
    b16, b32 = f * h16 * w16, f * h16 * w16 // 4
    qps = np.array([0, 22, 27, 30, 51], np.int32)
    rows = []

    # K1 intra_pred: satd35 at B16/B32 and predict of the top-4 shortlist
    k1 = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, bytes=0, ops=0, err=0.0)
    for n, b in ((16, b16), (32, b32)):
        refs = ref_inputs(rng, b, n, dev)
        orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
        orig[2::7] = 0
        orig[3::7] = 255
        orig = torch.as_tensor(orig, device=dev)
        got = intra.satd35(orig, *refs, n, 0)
        want = intra.satd35_plain(orig, *refs, n, 0)
        k1["err"] = max(k1["err"], check_equal(f"satd35 n={n}", got, want))
        modes = torch.as_tensor(rng.integers(0, 35, (b, 4)).astype(np.int32),
                                device=dev)
        for c_idx in (0, 1):
            got = intra.predict(*refs, modes, n, c_idx)
            want = intra.predict_plain(*refs, modes, n, c_idx)
            k1["err"] = max(k1["err"], check_equal(
                f"predict n={n} c={c_idx}", got, want))
        k1["ms"] += time_ms(lambda: intra.satd35(orig, *refs, n, 0), iters)
        k1["ms"] += time_ms(lambda: intra.predict(*refs, modes, n, 0), iters)
        k1["plain_ms"] += time_ms(
            lambda: intra.satd35_plain(orig, *refs, n, 0), 2)
        k1["plain_ms"] += time_ms(
            lambda: intra.predict_plain(*refs, modes, n, 0), 2)
        io = nbytes(orig, *refs) + b * 35 * 4 + nbytes(*refs, modes) \
            + b * 4 * n * n * 4
        ops = b * 35 * n * n * 16 + b * 4 * n * n * 8
        k1["bytes"] += io
        k1["ops"] += ops
    rows.append(("intra_pred", "x265amod_tpu_torch/csrc/intra_pred.cu",
                 "x265amod_tpu/ops/intra.py:133 predict_all_modes_batch "
                 "(+ :250 predict_modes_batch, :340 substitute_refs_general,"
                 " models/intra_tree.py:68 _satd_modes)", k1))

    # K2 residual_chain and K3 tu_bits: the estimate's four calls
    k2 = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    k3 = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    for n, b, k, c_idx in ((16, b16, 4, 0), (8, 2 * b16, 1, 1),
                           (32, b32, 4, 0), (16, 2 * b32, 1, 1)):
        orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
        pred = np.clip(orig[:, None] + rng.integers(-40, 41, (b, k, n, n)),
                       0, 255).astype(np.int32)
        pred[::5] = rng.integers(0, 256, (n, n))      # far predictions
        orig[1::5] = 0
        pred[1::5] = 255                              # flat 0 vs flat 255
        orig[2::5] = 255
        pred[2::5] = 255                              # zero residual
        qp = qps[rng.integers(0, len(qps), b)]
        orig, pred, qp = (torch.as_tensor(a, device=dev)
                          for a in (orig, pred, qp))
        for sbh in (False, True):
            for intra in (True, False):         # intra / inter rounding
                got = residual.residual_chain(orig, pred, qp, sbh,
                                              intra=intra)
                want = residual.residual_chain_plain(orig, pred, qp, sbh,
                                                     intra=intra)
                for part, g, w_ in zip(("levels", "recon", "ssd"), got,
                                       want):
                    k2["err"] = max(k2["err"], check_equal(
                        f"residual_chain n={n} sbh={sbh} intra={intra} "
                        f"{part}", g, w_))
        levels = got[0]
        want_recon = k == 1
        k2["ms"] += time_ms(lambda: residual.residual_chain(
            orig, pred, qp, False, want_recon=want_recon), iters)
        k2["plain_ms"] += time_ms(lambda: residual.residual_chain_plain(
            orig, pred, qp, False, want_recon=want_recon), 2)
        k2["bytes"] += nbytes(orig, pred, qp) + b * k * n * n * 2 \
            + (b * k * n * n * 4 if want_recon else 0) + b * k * 4
        k2["ops"] += b * k * 8 * n ** 3
        qk = qp[:, None].expand(b, k)
        dense = torch.as_tensor(
            (rng.integers(-300, 301, (b, n, n)) *
             (rng.random((b, n, n)) < 0.6)).astype(np.int16), device=dev)
        for st in ("I", "P"):                   # the slice type's table
            got = estbits.tu_bits(levels, c_idx, qk, st)
            want = estbits.tu_bits_plain(levels, c_idx, qk, st)
            k3["err"] = max(k3["err"], check_equal(f"tu_bits n={n} {st}",
                                                   got, want))
            k3["err"] = max(k3["err"], check_equal(
                f"tu_bits dense n={n} {st}",
                estbits.tu_bits(dense, c_idx, qp, st),
                estbits.tu_bits_plain(dense, c_idx, qp, st)))
        k3["ms"] += time_ms(lambda: estbits.tu_bits(levels, c_idx, qk),
                            iters)
        k3["plain_ms"] += time_ms(
            lambda: estbits.tu_bits_plain(levels, c_idx, qk), 2)
        k3["bytes"] += nbytes(levels) + b * k * 4 * 2
        k3["ops"] += b * k * n * n * 12
    for d in (k2, k3):
        d["bound_ms"], d["bound_by"] = bound_ms(d["bytes"], d["ops"])
    rows.append(("residual_chain", "x265amod_tpu_torch/csrc/residual_chain.cu",
                 "x265amod_tpu/ops/transforms.py:133 fwd_transform "
                 "(+ :151 inv_transform, ops/quant.py:100,136, "
                 "ops/sbh.py:45)", k2))
    rows.append(("tu_bits", "x265amod_tpu_torch/csrc/tu_bits.cu",
                 "x265amod_tpu/ops/estbits.py:114 tu_bits", k3))

    # K4 deblock: F frames, luma + both chroma planes
    k4 = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    hh, ww = 16 * h16, 16 * w16
    split = torch.as_tensor(rng.integers(0, 2, (f, h16 // 2, w16 // 2)),
                            device=dev)
    bs_v, bs_h = deblock.intra_tree_bs_maps(split, h16, w16)
    qmap = torch.as_tensor(rng.choice(qps, (f, h16, w16)).astype(np.int32),
                           device=dev)
    qp_v, qp_h = deblock.edge_qp_maps(qmap)
    from x265amod_tpu_torch.ops.quant import chroma_qp_t
    qpc_v, qpc_h = chroma_qp_t(qp_v), chroma_qp_t(qp_h)
    for name, fn, plain, shape, qv, qh in (
            ("luma", deblock.deblock_luma, deblock.deblock_luma_plain,
             (f, hh, ww), qp_v, qp_h),
            ("chroma", deblock.deblock_chroma, deblock.deblock_chroma_plain,
             (f, hh // 2, ww // 2), qpc_v, qpc_h)):
        base = rng.integers(0, 256, shape)
        smooth = (np.arange(shape[2])[None, None, :] * 3 // 2
                  + np.arange(shape[1])[None, :, None]) % 256
        plane = np.where(rng.random(shape) < 0.5, smooth,
                         np.clip(smooth + rng.integers(-6, 7, shape), 0,
                                 255))
        plane[0] = base[0]
        plane[-1, :, : shape[2] // 2] = 0
        plane[-1, :, shape[2] // 2:] = 255
        plane = torch.as_tensor(plane.astype(np.int32), device=dev)
        k4["err"] = max(k4["err"], check_equal(
            f"deblock {name}", fn(plane, bs_v, bs_h, qv, qh),
            plain(plane, bs_v, bs_h, qv, qh)))
        # inter frames: bS 1 edges (luma tC at QP + 0; chroma unfiltered)
        rv, rh = (torch.as_tensor(rng.integers(0, 3, t.shape).astype(
            np.int32), device=dev) for t in (bs_v, bs_h))
        k4["err"] = max(k4["err"], check_equal(
            f"deblock {name} bS 0/1/2", fn(plane, rv, rh, qv, qh),
            plain(plane, rv, rh, qv, qh)))
        reps = 1 if name == "luma" else 2
        k4["ms"] += reps * time_ms(lambda: fn(plane, bs_v, bs_h, qv, qh),
                                   iters)
        k4["plain_ms"] += reps * time_ms(
            lambda: plain(plane, bs_v, bs_h, qv, qh), 2)
        k4["bytes"] += reps * (2 * nbytes(plane) + nbytes(bs_v, bs_h, qv,
                                                          qh))
        k4["ops"] += reps * plane.numel() * 4
    rows.append(("deblock", "x265amod_tpu_torch/csrc/deblock.cu",
                 "x265amod_tpu/ops/deblock.py:494 deblock_luma_bs "
                 "(+ :529 deblock_chroma_bs)", k4))
    for _, _, _, d in rows:
        d["bound_ms"], d["bound_by"] = bound_ms(d["bytes"], d["ops"])
    cuda_lib.reset_launches()
    return rows


def subpel_ops(n):
    """Integer operations `subpel_refine` needs for one n x n block: its 25
    candidates use x and y phases 0-3, phase 0 being a copy and the half-pel
    phase serving both of its offsets from n + 1 columns (rows).  So the
    horizontal 8-tap pass (16 ops a sample) covers phases 1, 2, 3 over the
    n + 7 rows the vertical taps read; the vertical pass covers the 12
    distinct (x, y) phase pairs whose y phase is not 0; then 25 SSDs of
    3 ops a pixel."""
    taps = 16
    horizontal = (n + 7) * (n + (n + 1) + n) * taps
    x_cols = n + n + (n + 1) + n          # x phases 0, 1, 2, 3
    y_rows = n + (n + 1) + n              # y phases 1, 2, 3
    return horizontal + x_cols * y_rows * taps + 25 * n * n * 3


def phase_kernels_p(iters, dev="cuda", w=1280, h=736, sr=8):
    """K5-K8 at config 2's per-frame shapes (1280x720 padded to 736 rows,
    sr 8): the ME grids at bn 16 (3680 cells) and 32 (920 CTUs) over the
    reference and the half-pel plane, the two sub-pel refinements, the five
    MC calls (trials at 16 and 32, final luma, cb, cr) and the half-pel
    plane; each against its plain version, with MVs at +-sr on the border
    blocks and flat regions."""
    import torch
    import torch.nn.functional as F
    from x265amod_tpu_torch.ops import me
    dev = torch.device(dev)
    rng = np.random.default_rng(2)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    ref = np.clip(128 + 80 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
                  + rng.normal(0, 4, (h, w)), 0, 255).astype(np.int32)
    ref[:64, :64] = 0
    ref[-64:, -64:] = 255
    cur = np.clip(np.roll(ref, (2, -3), (0, 1)) + rng.integers(-4, 5, (h, w)),
                  0, 255).astype(np.int32)
    ref_t = torch.as_tensor(ref, device=dev)
    cur_t = torch.as_tensor(cur, device=dev)
    rows = []

    def blocks(bn):
        return cur_t.reshape(h // bn, bn, w // bn, bn).permute(0, 2, 1, 3) \
            .reshape(-1, bn, bn).contiguous()

    def edge_mvs(nb, wb, bound):
        mv = rng.integers(-bound, bound + 1, (nb, 2)).astype(np.int32)
        mv[:wb] = (-bound, -bound)           # top row of blocks
        mv[-wb:] = (bound, bound)            # bottom row
        mv[::wb] = (-bound, bound)           # left column
        return torch.as_tensor(mv, device=dev)

    s = 2 * sr + 1
    # K8 hpel_plane: one call per P frame
    d = dict(err=0.0)
    hp = me.hpel_plane(ref_t)
    d["err"] = check_equal("hpel_plane", hp, me.hpel_plane_plain(ref_t))
    d["ms"] = time_ms(lambda: me.hpel_plane(ref_t), iters)
    d["plain_ms"] = time_ms(lambda: me.hpel_plane_plain(ref_t), 2)
    kern = torch.as_tensor(np.outer(me.LUMA_FILTERS[2], me.LUMA_FILTERS[2])
                           .astype(np.float32), device=dev)[None, None]
    padded = F.pad(ref_t.float()[None, None], (3, 4, 3, 4), mode="replicate")
    d["library_ms"] = time_ms(lambda: F.conv2d(padded, kern), iters)
    d["library_note"] = ("F.conv2d of the 8x8 (1/2,1/2) kernel over the "
                         "replicate-padded plane in float32, without the "
                         "rounding shift")
    d["bound_ms"], d["bound_by"] = bound_ms(
        2 * h * w * 4, 16 * (h + 7) * w + 16 * h * w)
    rows.append(("hpel", "x265amod_tpu_torch/csrc/hpel.cu",
                 "x265amod_tpu/models/inter_tree.py:51 _hpel_plane", d))

    # K5 me_ssd_grid: bn 16 and 32, on the reference and the hpel plane
    d = dict(err=0.0, ms=0.0, plain_ms=0.0)
    nbytes_, ops = 0, 0
    for bn in (16, 32):
        cb = blocks(bn)
        nb = cb.shape[0]
        for plane in (ref_t, hp):
            d["err"] = max(d["err"], check_equal(
                f"me_ssd_grid bn={bn}", me.me_ssd_grid(cb, plane, sr, bn),
                me.me_ssd_grid_plain(cb, plane, sr, bn)))
            d["ms"] += time_ms(lambda: me.me_ssd_grid(cb, plane, sr, bn),
                               iters)
            d["plain_ms"] += time_ms(
                lambda: me.me_ssd_grid_plain(cb, plane, sr, bn), 2)
            nbytes_ += nbytes(cb, plane) + nb * s * s * 4
            ops += nb * s * s * bn * bn * 3
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, ops)
    d["library_ms"] = None
    d["library_note"] = ("none: the SSD grid is two grouped convolutions "
                         "and an add, no single call")
    rows.append(("me_ssd", "x265amod_tpu_torch/csrc/me_ssd.cu",
                 "x265amod_tpu/ops/me.py:33 me_ssd_grid", d))

    # K6 subpel_refine: bn 16 and 32
    d = dict(err=0.0, ms=0.0, plain_ms=0.0)
    nbytes_, ops = 0, 0
    for bn in (16, 32):
        cb = blocks(bn)
        nb = cb.shape[0]
        mv = edge_mvs(nb, w // bn, sr)
        lam = torch.as_tensor(rng.uniform(0, 400, nb).astype(np.float32),
                              device=dev)
        lam[::5] = 0.0
        got = me.subpel_refine(ref_t, cb, mv, lam, bn)
        want = me.subpel_refine_plain(ref_t, cb, mv, lam, bn)
        d["err"] = max(d["err"], check_equal(f"subpel mv bn={bn}", got[0],
                                             want[0]),
                       check_equal(f"subpel ssd bn={bn}", got[1], want[1]))
        d["ms"] += time_ms(lambda: me.subpel_refine(ref_t, cb, mv, lam, bn),
                           iters)
        d["plain_ms"] += time_ms(
            lambda: me.subpel_refine_plain(ref_t, cb, mv, lam, bn), 2)
        nbytes_ += nbytes(ref_t, cb, mv, lam) + nb * 12
        ops += nb * subpel_ops(bn)
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, ops)
    d["library_ms"] = None
    d["library_note"] = "none: no PyTorch call interpolates and searches"
    rows.append(("subpel", "x265amod_tpu_torch/csrc/subpel.cu",
                 "x265amod_tpu/ops/me.py:385 subpel_refine (+ :450 "
                 "_mvd_bits_f, :180 _block_windows)", d))

    # K7 mc_qpel: trials at 16 and 32, final luma at 16, cb and cr at 8
    d = dict(err=0.0, ms=0.0, plain_ms=0.0)
    nbytes_, ops = 0, 0
    cref = ref_t[::2, ::2].contiguous()
    for plane, n, chroma, bound in ((ref_t, 16, False, 4 * (sr + 2)),
                                    (ref_t, 32, False, 4 * (sr + 2)),
                                    (ref_t, 16, False, 4 * (sr + 2)),
                                    (cref, 8, True, 8 * (sr // 2 + 2)),
                                    (cref, 8, True, 8 * (sr // 2 + 2))):
        ph, pw = plane.shape
        nb = (ph // n) * (pw // n)
        mv = edge_mvs(nb, pw // n, bound)
        fn, plain = ((me.mc_chroma_qpel, me.mc_chroma_qpel_plain) if chroma
                     else (me.mc_luma_qpel, me.mc_luma_qpel_plain))
        d["err"] = max(d["err"], check_equal(
            f"mc_qpel n={n} chroma={chroma}", fn(plane, mv, n),
            plain(plane, mv, n)))
        d["ms"] += time_ms(lambda: fn(plane, mv, n), iters)
        d["plain_ms"] += time_ms(lambda: plain(plane, mv, n), 2)
        t = 4 if chroma else 8
        nbytes_ += nbytes(plane, mv) + nb * n * n * 4
        ops += nb * ((n + t - 1) * n * 2 * t + n * n * (2 * t + 4))
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, ops)
    d["library_ms"] = None
    d["library_note"] = ("none: per-block MVs need a gather before any "
                         "convolution")
    rows.append(("mc_qpel", "x265amod_tpu_torch/csrc/mc_qpel.cu",
                 "x265amod_tpu/ops/me.py:315 mc_luma_qpel (+ :262 "
                 "mc_luma_qpel14, :377 mc_chroma_qpel, :331 "
                 "mc_chroma_qpel14)", d))
    return rows


def phase_plain_rows(iters, dev="cuda"):
    """Rows 10-11 of the kernel table (plain PyTorch on the card): the bS
    and QP maps and SSE/SSIM, for config 1's 16-frame batch and one
    config 2 frame."""
    import torch
    from x265amod_tpu_torch.ops import deblock, metrics
    dev = torch.device(dev)
    rng = np.random.default_rng(5)
    out = {}
    for name, f, h, w in (("config1_batch", 16, 384, 640),
                          ("config2_frame", 1, 736, 1280)):
        h16, w16 = h // 16, w // 16
        split = torch.as_tensor(rng.integers(0, 2, (f, h16 // 2, w16 // 2)),
                                device=dev)
        coded = torch.as_tensor(rng.random((f, h16, w16)) < 0.5, device=dev)
        qp32 = torch.full((h16 // 2, w16 // 2), 30, dtype=torch.int32,
                          device=dev)
        intra = torch.as_tensor(rng.random((f, h16, w16)) < 0.1, device=dev)
        mv = torch.as_tensor(rng.integers(-40, 41, (f, h16, w16, 2)),
                             device=dev)

        def maps():
            if name == "config1_batch":
                bs = deblock.intra_tree_bs_maps(split, h16, w16)
            else:
                bs = deblock.inter_tree_bs_maps(
                    intra, coded, torch.where(intra, 0, 1), mv,
                    torch.zeros_like(mv), split, torch.zeros_like(coded,
                                                                  dtype=torch.int32))
            eff = deblock.effective_qp16_tree(qp32, split, coded, 30)
            return bs, deblock.edge_qp_maps(eff)
        a = torch.as_tensor(rng.integers(0, 256, (f, h, w)), device=dev) \
            .to(torch.uint8)
        b = torch.as_tensor(rng.integers(0, 256, (f, h, w)), device=dev) \
            .to(torch.uint8)

        def quality():
            return metrics.plane_sse(a, b), metrics.ssim_plane(a, b)
        out[name] = dict(
            bs_qp_maps_ms=time_ms(maps, iters),
            bs_qp_maps_bound_ms=bound_ms(f * h16 * w16 * 4 * 12, 0)[0],
            sse_ssim_ms=time_ms(quality, iters),
            sse_ssim_bound_ms=bound_ms(2 * a.numel(), a.numel() * 12)[0])
    return out


# ---- phases 3 and 4 -----------------------------------------------------------

def config1(w=640, h=360):
    from x265amod_tpu_torch.utils.params import param_default_preset
    p = param_default_preset("ultrafast")
    p.width, p.height = w, h
    p.qp = 30
    p.keyint = 1
    p.ctu_size = 32
    return p


def phase_main_path(frames, warm):
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config1(), device="cuda")
    for _ in enc.encode_pipelined(frames[:warm]):
        pass
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(enc.encode_pipelined(frames[warm:]))
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s = enc.summary()
    n = len(frames) - warm
    if len(outs) != n or not all(o.nals for o in outs):
        raise AssertionError("main path: missing encoded frames")
    for k in ("psnr_y", "bitrate_kbps"):
        if not np.isfinite(s[k]):
            raise AssertionError(f"main path: {k} not finite")
    if not 30.0 < s["psnr_y"] < 60.0:
        raise AssertionError(f"main path: PSNR-Y {s['psnr_y']} out of range")
    missing = [k for k in CONFIG1_KERNELS if launches[k] <= 0]
    if missing:
        raise AssertionError(f"main path did not launch {missing}")
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=s["psnr_y"],
                kbps=s["bitrate_kbps"], ssim_y=s["ssim_y"],
                batches=-(-n // enc.BATCH_FRAMES)), launches


def phase_card_vs_cpu(frames):
    """The first 2 frames through the port on the card and on the CPU."""
    from x265amod_tpu_torch.models.encoder import Encoder
    encs = {}
    streams = {}
    for dev in ("cuda", "cpu"):
        p = config1()
        p.info = False
        e = Encoder(p, device=dev)
        e.BATCH_FRAMES = 2
        streams[dev] = [o.nals for o in e.encode_pipelined(frames[:2])]
        encs[dev] = e
    same = streams["cuda"] == streams["cpu"]
    out = dict(bitstreams_identical=same)
    if same:
        return out
    # near-tie decisions may differ: replay the CPU's decisions on the card
    agree = []
    for i, fr in enumerate(frames[:2]):
        pads = [np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
                for a, s in zip(fr, (32, 16, 16))]
        qp = encs["cpu"].frame_stats[i].qp
        fcpu = encs["cpu"].frame_encoder
        fgpu = encs["cuda"].frame_encoder
        rc = fcpu.collect(fcpu.encode_async(*pads, qp))
        rg = fgpu.collect(fgpu.encode_async(*pads, qp))
        agree.append(float(np.mean(rc.modes == rg.modes)))
        forced = fgpu.collect(fgpu.encode_async_load(*pads, qp, rc.split,
                                                     rc.modes))
        pc = encs["cpu"]._cabac_intra_tree(rc, qp)
        pg = encs["cuda"]._cabac_intra_tree(forced, qp)
        if pc != pg:
            raise AssertionError("card and CPU differ under the CPU's "
                                 "decisions")
    out.update(forced_identical=True, mode_agreement=agree)
    return out


def config2(w=1280, h=720):
    """BASELINE config 2 as the repository's bench.py runs it."""
    from x265amod_tpu_torch.utils.params import param_default_preset
    p = param_default_preset("superfast")
    p.width, p.height = w, h
    p.qp = 32
    p.keyint = 250
    p.bframes = 0
    p.ctu_size = 32
    p.aq_mode = 0
    p.cutree = False
    return p


def phase_config2(frames, warm):
    """Config 2 through `encode_push` and `flush`; the clock and the launch
    counts start after the warm-up frames (the I frame among them)."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config2(), device="cuda")
    n_done, t0 = 0, None
    for i, fr in enumerate(frames):
        outs = enc.encode_push(*fr)
        if i == warm - 1:
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            t0 = time.time()
        elif i >= warm:
            n_done += len(outs)
    n_done += len(enc.flush())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s = enc.summary()
    n = len(frames) - warm
    types = [st.slice_type for st in enc.frame_stats]
    if n_done != n or types != ["I"] + ["P"] * (len(frames) - 1):
        raise AssertionError(f"config 2: {n_done} of {n} frames, types "
                             f"{types}")
    for k in ("psnr_y", "bitrate_kbps"):
        if not np.isfinite(s[k]):
            raise AssertionError(f"config 2: {k} not finite")
    if not 30.0 < s["psnr_y"] < 60.0:
        raise AssertionError(f"config 2: PSNR-Y {s['psnr_y']} out of range")
    missing = [k for k, v in launches.items() if v <= 0]
    if missing:
        raise AssertionError(f"config 2 did not launch {missing}")
    p_stats = enc.frame_stats[warm:]
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=s["psnr_y"],
                kbps=s["bitrate_kbps"], ssim_y=s["ssim_y"],
                timed_psnr_y=float(np.mean([x.psnr_y for x in p_stats])),
                timed_kbps=float(sum(x.bits for x in p_stats) * 25.0 / n
                                 / 1000.0)), launches


def phase_card_vs_cpu_p(frames):
    """Config 2's first 3 frames (I, P, P) on the card and on the CPU."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    encs, streams = {}, {}
    for dev in ("cuda", "cpu"):
        p = config2()
        p.info = False
        e = Encoder(p, device=dev)
        streams[dev] = [o.nals for f in frames[:3] for o in e.encode_push(*f)]
        encs[dev] = e
    same = streams["cuda"] == streams["cpu"]
    out = dict(bitstreams_identical=same, frames=3)
    if same:
        return out
    # a near-tie may flip a decision: replay the CPU's on the card
    ec, eg = encs["cpu"], encs["cuda"]
    pads = [[np.pad(a, ((0, (-a.shape[0]) % m), (0, (-a.shape[1]) % m)),
                    mode="edge") for a, m in zip(fr, (32, 16, 16))]
            for fr in frames[:3]]
    qpi, qpp = ec.frame_stats[0].qp, ec.frame_stats[1].qp
    hc = ec.frame_encoder.encode_async(*pads[0], qpi, keep_recon=True)
    rc = ec.frame_encoder.collect(hc)
    rg = eg.frame_encoder.collect(eg.frame_encoder.encode_async_load(
        *pads[0], qpi, rc.split, rc.modes, want_recon=True))
    if ec._cabac_intra_tree(rc, qpi) != eg._cabac_intra_tree(rg, qpi):
        raise AssertionError("config 2 I frame: card and CPU differ under "
                             "the CPU's decisions")
    ref_c = hc["recon_dev"]
    ref_g = tuple(torch.as_tensor(a, device="cuda")
                  for a in (rg.recon_y, rg.recon_cb, rg.recon_cr))
    agree = []
    for i in (1, 2):
        hcp = ec.inter_encoder.encode_async(*pads[i], ref_c, qpp)
        rc = ec.inter_encoder.collect(hcp)
        free = eg.inter_encoder.collect(eg.inter_encoder.encode_async(
            *pads[i], ref_g, qpp))
        agree.append(float(np.mean(free.kinds == rc.kinds)))
        rg = eg.inter_encoder.collect(eg.inter_encoder.encode_async_load(
            *pads[i], ref_g, qpp, rc.split, rc.kinds, rc.merge_idx, rc.mvd,
            rc.mvp_idx, rc.modes, want_recon=True))
        if ec._cabac_inter_tree(rc, qpp) != eg._cabac_inter_tree(rg, qpp):
            raise AssertionError(f"config 2 P frame {i}: card and CPU "
                                 "differ under the CPU's decisions")
        ref_c = hcp["recon_dev"]
        ref_g = tuple(torch.as_tensor(a, device="cuda")
                      for a in (rg.recon_y, rg.recon_cb, rg.recon_cr))
    out.update(forced_identical=True, kind_agreement=agree)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--p-frames", type=int, default=24)
    ap.add_argument("--p-warm", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        sys.stderr.write("chip_smoke: no CUDA device\n")
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from x265amod_tpu_torch.ops import cuda_lib
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    seconds = {}
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.time()
    reports = cuda_lib.build_all()
    seconds["1_build"] = time.time() - t0
    log(f"phase 1: built {len(reports)} kernels in {seconds['1_build']:.1f}"
        " s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    t0 = time.time()
    w, h = 640, 360
    h16, w16 = -(-h // 32) * 2, w // 16
    rows = phase_kernels(16, h16, w16, args.iters)
    rows += phase_kernels_p(args.iters)
    for name, _, _, d in rows:
        log(f"phase 2: {name} equal to plain (max abs err {d['err']}); "
            f"{d['ms']:.4f} ms vs plain {d['plain_ms']:.4f} ms, bound "
            f"{d['bound_ms']:.4f} ms ({d['bound_by']}) [{card}]")
    log("phase 2: plain rows 10-11 " + json.dumps(phase_plain_rows(
        args.iters)))
    cuda_lib.reset_launches()
    seconds["2_kernels"] = time.time() - t0

    t0 = time.time()
    frames = synth_frames(w, h, args.frames)
    main_stats, launches1 = phase_main_path(frames, args.warm)
    log("phase 3: " + json.dumps(dict(main_stats, card=card,
                                      launches=launches1)))
    cmp = phase_card_vs_cpu(frames)
    log("phase 4: " + json.dumps(cmp))
    seconds["3_4_config1"] = time.time() - t0

    t0 = time.time()
    pframes = synth_frames(1280, 720, args.p_frames, seed=2)
    p_stats, launches2 = phase_config2(pframes, args.p_warm)
    log("phase 5: " + json.dumps(dict(p_stats, card=card,
                                      launches=launches2)))
    seconds["5_config2"] = time.time() - t0
    t0 = time.time()
    log("phase 6: " + json.dumps(phase_card_vs_cpu_p(pframes)))
    seconds["6_config2_card_vs_cpu"] = time.time() - t0
    log("seconds per phase: " + json.dumps(seconds))

    kernels = []
    for name, src, replaces, d in rows:
        config1_kernel = name in CONFIG1_KERNELS
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches1[name] if config1_kernel else launches2[name],
            launches_config1=launches1[name],
            launches_config2=launches2[name],
            max_abs_err=d["err"], ms=d["ms"],
            plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
            bound_by=d["bound_by"], library_ms=d.get("library_ms"),
            library_note=d.get("library_note",
                               "no single PyTorch call computes this "
                               "function"),
            shapes=(f"16-frame batch at {w}x{h} (padded {16 * w16}x"
                    f"{16 * h16})" if config1_kernel else
                    "one P frame at 1280x720 (padded 1280x736), sr 8")))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
