"""Chip smoke test of the PyTorch/CUDA port (x265amod_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build of the four CUDA kernels
     (nvcc for sm_90a, all started together) with their ptxas reports;
  2. each kernel against its plain PyTorch version on the card, at the
     shapes of the main path's 16-frame batch plus edge inputs (QP 0 and
     51, flat 0/255 blocks, frame borders without references), with its
     time, bound and the plain version's time;
  3. the main path: BASELINE config 1 (640x360 all-intra ultrafast QP 30,
     CTU32) through `Encoder(device="cuda")`, 40 frames with the first 8 as
     warm-up; fps, PSNR-Y, kbps and every kernel's launch count;
  4. the card's bitstream against the port's CPU bitstream (plain
     versions) on the first 2 frames.

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
            got = residual.residual_chain(orig, pred, qp, sbh)
            want = residual.residual_chain_plain(orig, pred, qp, sbh)
            for part, g, w_ in zip(("levels", "recon", "ssd"), got, want):
                k2["err"] = max(k2["err"], check_equal(
                    f"residual_chain n={n} sbh={sbh} {part}", g, w_))
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
        got = estbits.tu_bits(levels, c_idx, qk)
        want = estbits.tu_bits_plain(levels, c_idx, qk)
        k3["err"] = max(k3["err"], check_equal(f"tu_bits n={n}", got, want))
        dense = torch.as_tensor(
            (rng.integers(-300, 301, (b, n, n)) *
             (rng.random((b, n, n)) < 0.6)).astype(np.int16), device=dev)
        k3["err"] = max(k3["err"], check_equal(
            f"tu_bits dense n={n}", estbits.tu_bits(dense, c_idx, qp),
            estbits.tu_bits_plain(dense, c_idx, qp)))
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
    missing = [k for k, v in launches.items() if v <= 0]
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


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warm", type=int, default=8)
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
    log(f"phase 1: card {card}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}")
    t0 = time.time()
    reports = cuda_lib.build_all()
    log(f"phase 1: built {len(reports)} kernels in {time.time() - t0:.1f} s")
    for name, text in reports.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                log(f"  ptxas {name}: {line.strip()}")

    w, h = 640, 360
    h16, w16 = -(-h // 32) * 2, w // 16
    rows = phase_kernels(16, h16, w16, args.iters)
    for name, _, _, d in rows:
        log(f"phase 2: {name} equal to plain (max abs err {d['err']}); "
            f"{d['ms']:.4f} ms vs plain {d['plain_ms']:.4f} ms, bound "
            f"{d['bound_ms']:.4f} ms ({d['bound_by']}) [{card}]")

    frames = synth_frames(w, h, args.frames)
    main_stats, launches = phase_main_path(frames, args.warm)
    log("phase 3: " + json.dumps(dict(main_stats, card=card,
                                      launches=launches)))
    cmp = phase_card_vs_cpu(frames)
    log("phase 4: " + json.dumps(cmp))

    kernels = []
    for name, src, replaces, d in rows:
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches[name], max_abs_err=d["err"], ms=d["ms"],
            plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
            bound_by=d["bound_by"], library_ms=None,
            library_note="no single PyTorch call computes this function",
            shapes=f"16-frame batch at {w}x{h} (padded {16 * w16}x"
                   f"{16 * h16})"))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
