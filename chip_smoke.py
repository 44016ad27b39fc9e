"""Chip smoke test of the PyTorch/CUDA port (x265amod_tpu_torch) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure exits non-zero):
  1. the card's name and power limit; build of the twenty-five CUDA kernel
     libraries (nvcc for sm_90a, all started together) with their ptxas
     reports;
  2. each kernel against its plain PyTorch version on the card, with its
     time, bound and the plain version's time: K1-K4 at the shapes of
     config 1's 16-frame batch, K5-K8 at config 2's per-frame shapes, K9-K11
     at one config-3 B frame's shapes (1920x1088), K12-K14 and K1 on the
     lowres blocks at one config-3 frame's lookahead shapes (1920x1088
     planes, 960x544 lowres, 120x68 blocks; K14 also run twice, bit-equal),
     and K1-K8 checked again at the B frame's shapes (one 1920x1088 frame,
     sr 16); K1's predict at the flat intra trial's shape (8160 CU16s x 35
     modes) and K5 at 1920x1088, sr 16 (bn 16 and 32 on the integer and
     the half-pel plane, whose values reach -263 and 518), checked and
     timed; K1's bound counts its Hadamard at the f16 and K5's
     correlation at the int8 tensor-core rate and K6's integers at the f32
     FMA rate (`bound_ms_int32`: the int32 ALUs alone); K2 with its RDOQ
     stage (row 21) at one diagonal of config 1's commit and at one
     1920x1088 B and P frame's final coding, timed with
     and without the stage, with lambdas within 4 ulps of hi/lo and
     group-kill ties and levels at +-32767; K1-K3 at bit depth 10 at the
     Main10 path's 16-frame batch of 1920x1088 with flat 0 / 1023 blocks;
     plus edge inputs (QP 0 and 51, flat 0/255 blocks, frame
     borders without references, MVs at the search-range or window bound
     on border blocks, 0/255 steps under the MC filters, rec == orig and
     lambda 0 for SAO, flat lowres planes whose candidates all tie, a
     CU-tree pile-up on the border blocks), K2 with inter rounding, K3 at
     P- and B-slice init states and K4 on bS 1 edges;
     K21 (the loop filter's bS/QP maps, two launches a call) and K22
     (SSE/SSIM) at a config-1 batch, a config-2 P frame, a config-3 B
     frame and a 1080p CTB16 frame, K21 also with L2 flushed and queued
     behind a spin of the card; K7 at the flat 1080p frames' calls (luma
     n 16, chroma n 8 and the select entry of a B frame's final MC, MVs at
     the window bound past all four edges, every phase pair), timed the
     same three ways;
     the ME argmin on K5's grids of a config-2 P frame and a 1080p B frame
     (and crafted near-ties); K23 (the flat CTB16 scan, two launches a
     call: its ticket list, held to `scan_tickets`, and the scan) at one
     1920x1088 frame, lossy and lossless, a 16-frame batch of 640x368,
     and as the commit of a 1920x1088 P frame on adversarial kinds maps
     (all intra, none, one column, one diagonal chain, a checkerboard, a
     336-CTU patch);
     K15 (the level pack) at a config-1 batch, a config-2 P frame and a
     config-3 B frame, with an overflow and int16 extremes, and the packed
     D2H against the dense one; K16 (the resampler) at 1080p -> 720p and ->
     360p (luma, chroma, bicubic, bilinear) and 360p -> 720p, on the
     unrounded and the uint8 output, beside `torch.matmul`; K17 (the P
     decide scan, one launch a frame) on a real 1280x736 P frame's phase-1
     outputs (frame 4 of the bench clip against the card's recon of frames
     1-3) at R = 1 and R = 3, free (decisions, MVs, references and cost
     rows) and forced (the plain scan's decisions replayed), against the
     plain scan on the card, and again at R = 1 on config 3's first P
     anchor (1920x1088, phases 7 and 9's frames); K18 (`pick_ref`) at R = 3
     on the 720p frame's CU16 and CU32 trials; K7 with a reference index
     at R = 3 (final luma and chroma MC and the trials, MVs at the window
     bound on border blocks); K19 (the B decide scan, one launch a B
     frame) free and forced against the plain scan at one config-3 B frame
     (phase 9's clip at 1920x1088, sr 16, between the card's recon of the
     IDR and the P anchor) at POC 2 (dsf -256) and POC 1 (dsf -85 and
     -768); K20 (the forced intra commit, one launch a diagonal) against
     the trees' plain commits on a config-1 batch, a Main10 batch, an
     intra batch with RDOQ, a config-2 P frame and a config-3 B frame with
     RDOQ 2 (the inter frames with a flat patch where intra cells win);
     K24 and K25 (the flat CTB16 P and B decide scans, one launch a frame)
     free and forced, K23 as the commit scan of a flat P and B frame and
     K21's flat P/B maps, at one 1920x1088 P frame and one B frame (POC 1
     between two CTB16 IDR recons), against their plain versions, and K3
     on that P frame's two calls (its intra trial's 8160 x 35 TUs of 16x16
     and its inter trial's 8160), recorded from the frame's phase 1;
  3. BASELINE config 1 (640x360 all-intra ultrafast QP 30, CTU32) through
     `Encoder(device="cuda")`, 24 frames with the first 8 as warm-up; fps,
     PSNR-Y, kbps and the launch count of every kernel;
  4. config 1's bitstream on the card against the port's CPU bitstream
     (plain versions) on the first 2 frames;
  5. BASELINE config 2 (1280x720 low-delay P superfast QP 32, CTU32, one
     reference; K17 decides every P frame) through `Encoder(device="cuda")`
     and `encode_push`/`flush`,
     12 frames with the first 4 as warm-up, as the repository's bench.py
     runs it; fps, PSNR-Y, kbps, seconds, and every kernel's launch count;
  6. config 2's bitstream on the card against the CPU's for its first 3
     frames (I, P, P); where they differ, the CPU's decisions replayed on
     the card must give the CPU's stream;
  7. the config-3 slice (BASELINE config 3 at 1920x1080 with AQ and
     CU-tree off: CQP 32, keyint 60, a B pyramid of 3, SAO on) through
     `encode_push`/`flush`: 5 frames, the IDR as warm-up, the mini-GOP (P +
     3 B) timed; fps, PSNR-Y (after SAO), kbps, the launches of K1-K11 per
     B frame and the share of CTUs whose luma SAO is on;
  8. the config-3 slice at 640x360 (IDR + one mini-GOP) on the card and on
     the CPU: the streams must be identical byte for byte;
  9. BASELINE config 3 exactly as bench.py builds it (`aq_mode=2,
     cutree=True, rc_lookahead=4`: the lookahead, AQ and CU-tree QP offsets,
     cu_qp_delta) at 1920x1080, 9 frames through `encode_push`/`flush`,
     all timed; fps, PSNR-Y, kbps, the share of CTUs whose QP differs from
     the slice QP and the range of the deltas, the scene cuts, and the
     launches per frame of K1 (lowres), K12, K13 and K14;
  10. config 3 with AQ and CU-tree at 640x360 (IDR + one mini-GOP) on the
     card and on the CPU: the streams must be identical byte for byte;
  11. config 3 as in phase 9 plus `rdoq_level=2` on the same 9 frames: fps,
     PSNR-Y, kbps and K2's RDOQ launches per frame; it must code fewer bits
     than phase 9 and lose at most 0.6 dB PSNR-Y;
  12. Main10 all-intra at 1920x1080 (QP 30, CTU32, no loop filters) through
     `encode_pipelined`, 32 frames of a 10-bit clip with the first 16 as
     warm-up: fps, PSNR-Y at the 10-bit peak, kbps, launches; the recon
     must exceed 255 and the SPS carry profile 2 and bit depth 10;
  13. card against CPU, byte for byte: config 3 + RDOQ at 320x192 (IDR +
     one mini-GOP) and Main10 all-intra at 640x360 (2 frames);
  14. the ABR ladder at full width through the port's ladder app
     (`abr.run`, from a y4m of the bench clip, 11 frames at 1920x1080):
     rungs 1920x1080 at 5800 kb/s, 1280x720 at 2400 and 640x360 at 145
     (the HEVC rows of Apple's HLS Authoring Specification), each at preset
     medium with CTU32 under ABR; kb/s against the target, PSNR-Y, frames
     and QPs per rung, the ladder's enc-fps, and every kernel's launches
     (K16 resamples the two smaller rungs, K15 packs every frame);
  15. config 2 (1280x720 superfast, no B frames) under ABR at 1500 kb/s
     with a VBV of 1500 kb/s and 1500 kb and --hrd, 24 frames through
     `encode_pipelined`: kb/s, the buffer's lowest fill before the clamp
     against one frame's budget, the underflow count, and the buffering
     period and pic timing SEI in the stream;
  16. card against CPU, byte for byte: the ladder of phase 14 at 320x192,
     160x96 and 96x64, and phase 15's config at 320x192 (6 frames each);
  17. config 2 at x265's default `--ref 3` on phase 5's frames (12, the
     first 4 as warm-up) through `encode_push`/`flush`: fps, PSNR-Y, kbps,
     the share of inter cells on an older reference (ref_idx >= 1), the
     launches per P frame of K5-K8, K17 and K18, beside phase 5's figures
     and those of config 2 at one reference run again right after;
  18. card against CPU, byte for byte: `--ref 4` at 320x192 on a period-2
     flicker clip, 8 frames (the cyclic fill and every ref_idx bin occur);
     some inter cells must use an older reference;
  19. CTB16 all-intra at 1920x1080 (the JAX package's defaults: `Param()`
     with keyint 1, CQP 32, deblocking on, SAO off) through
     `encode_pipelined`, 20 frames with the first 4 as warm-up: fps,
     PSNR-Y, kbps, K23's launches (two a frame);
  20. lossless at 1920x1080, 5 frames with the first as warm-up: the recon
     must equal the source; fps, kbps;
  21. card against CPU, byte for byte: CTB16 with AQ 2 and SAO, and
     lossless, at 320x192 (3 frames each);
  22. the flat CTB16 P frames: `Param(width=1920, height=1080)` (the JAX
     defaults: an IDR and P frames, CQP 32) through `encode_pipelined`, 12
     frames of the clip of seed 22 with the first 2 as warm-up: fps,
     PSNR-Y, kbps, launches per frame (K24 once a P frame, K23 twice a
     frame), and no launch of the CTU32 trees' scans;
  23. the flat B pyramid: `--preset medium` without `--ctu` at 1920x1080
     (bframes 4, SAO, AQ 2, CU-tree, lookahead 20, CQP 32), 11 frames of
     the clip of seed 23, all timed: fps, PSNR-Y, kbps, launches (K25 once
     a B frame);
  24. card against CPU, byte for byte: phases 22 and 23's configurations
     at 320x192 (6 frames each).

Prints one JSON line of kernel figures, then the card's name and power
limit, then `{"ok": true, "device": {...}}` as the last line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
# int32 ALU peak: 132 SMs x 64 INT32 lanes x 1.98 GHz x 2 (a multiply-add
# counts two operations) = half the data sheet's 67 TFLOP/s fp32 rate
H100_INT32_OPS_PER_S = 33.5e12
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
# dense tensor-core rates (data sheet): int8 products (K5's correlation) and
# f16 products with f32 accumulation (K1's Hadamard)
H100_INT8_OPS_PER_S = 1979e12
H100_F16_FLOPS = 989e12
# the kernels config 1 (all-intra) runs; config 2 runs K1-K8, the config-3
# slice K1-K11, config 3 with AQ and CU-tree also the lookahead's (K12-K14
# and K1 on the lowres blocks, counted apart)
CONFIG1_KERNELS = ("intra_pred", "residual_chain", "tu_bits", "deblock",
                   "pack_levels", "commit_intra", "deblock_maps",
                   "frame_metrics")
# the flat CTB16 scan (K23) and the flat decide scans (K24 P, K25 B) run
# only on the CTB16 path (phases 19-24)
FLAT_KERNELS = ("intra16_scan", "decide_flat", "decide_flat_b")
# phase 22: the flat P frames (JAX defaults at 1920x1080), 2 warm-up;
# phase 23: preset medium without --ctu (the flat B pyramid), all timed
FLAT_P_FRAMES, FLAT_P_WARM = 12, 2
FLAT_B_FRAMES = 11
# phase 19: CTB16 all-intra at 1920x1080; phase 20: lossless at 1920x1080
CTB16_FRAMES, CTB16_WARM = 20, 4
LOSSLESS_FRAMES, LOSSLESS_WARM = 5, 1
CONFIG3_KERNELS = ("mc_bi", "sao_analyse", "sao_apply", "decide_b")
LOOKAHEAD_KERNELS = ("lowres_aq", "lowres_me", "cutree_prop",
                     "intra_pred_lowres")
# phase 7: IDR + one mini-GOP (P + 3 B) in display order; the IDR warms up
CONFIG3_FRAMES, CONFIG3_WARM = 5, 1
# phase 9: IDR + two mini-GOPs, every frame timed (phase 11 too)
CONFIG3_AQ_FRAMES = 9
# K2's launches with its RDOQ stage, counted apart (phase 11)
RDOQ_KERNELS = ("residual_chain_rdoq",)
# phase 12: Main10 all-intra, two 16-frame batches timed after one warm-up
MAIN10_FRAMES, MAIN10_WARM = 32, 16
# RDOQ may cost this much PSNR-Y against the same run without it (the JAX
# package's tests/test_rdoq.py bound)
RDOQ_MAX_PSNR_LOSS = 0.6


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


def synth_frames10(w, h, n, seed=7):
    """The 10-bit clip of the repository's Main10 tests (a copy): the bench
    pattern at 4x the amplitude around 512, uint16."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    frames = []
    for t in range(n):
        y = (512 + 320 * np.sin((xx + 3 * t) / 11.0) *
             np.cos((yy - 2 * t) / 7.0) +
             rng.normal(0, 12, (h, w))).clip(0, 1023).astype(np.uint16)
        cb = (512 + 120 * np.sin((xx[::2, ::2] + t) / 19.0)) \
            .clip(0, 1023).astype(np.uint16)
        cr = (512 - 120 * np.cos((yy[::2, ::2] + t) / 23.0)) \
            .clip(0, 1023).astype(np.uint16)
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


# tries of a time_queued_ms reading, the spin doubled after each late one
QUEUE_TRIES = 6
# readings of time_queued_ms, of which it returns the median
QUEUE_READINGS = 3
# a queued reading above this multiple of the same calls' back-to-back
# mean is a misread: back to back the card runs the same kernels and waits
# on the host besides, so their device time cannot be longer
QUEUE_MISREAD = 1.2
# what time_queued_ms met in this run: readings kept, late tries, the
# largest max / min of one call's readings, and each misread with the SM
# clock nvidia-smi read just after it
QUEUE_LOG = dict(calls=0, late=0, max_spread=1.0, misreads=[])


def sm_clock():
    """The card's SM clock and its maximum, as nvidia-smi reads them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def time_queued_ms(fn, iters):
    """Device ms of ``fn``, its ``iters`` calls enqueued while the card
    spins, so that none waits on the host (a wrapper's host time can exceed
    a short kernel's), with the grids warm; after its back-to-back mean
    (`time_ms`).  The median of QUEUE_READINGS readings.  A reading is
    taken again when the card reached the calls before the host had
    enqueued them all (late: the spin is doubled) and when it is a misread
    (above QUEUE_MISREAD x the back-to-back mean); after QUEUE_TRIES x
    QUEUE_READINGS tries it raises: a ``fn`` that waits on the card (a
    host copy, ``.item()``) never lets the queue form.  Counts go to
    QUEUE_LOG."""
    import torch
    b2b = time_ms(fn, iters)
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    spin = (time.perf_counter() - t) * (iters + 2) * 2.0
    got = []
    for _ in range(QUEUE_TRIES * QUEUE_READINGS):
        # cycles at about 2 GHz (the H100's SM clock reaches 1.98); a lower
        # clock only spins longer
        torch.cuda._sleep(int(spin * 2e9))
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        for _ in range(iters):
            fn()
        t1.record()
        late = t0.query()
        torch.cuda.synchronize()
        ms = t0.elapsed_time(t1) / iters
        if late:
            QUEUE_LOG["late"] += 1
            spin *= 2
        elif ms > QUEUE_MISREAD * b2b:
            QUEUE_LOG["misreads"].append(dict(
                ms=ms, back_to_back_ms=b2b, sm_clock=sm_clock()))
        else:
            got.append(ms)
            if len(got) == QUEUE_READINGS:
                QUEUE_LOG["calls"] += 1
                QUEUE_LOG["max_spread"] = max(QUEUE_LOG["max_spread"],
                                              max(got) / min(got))
                return float(np.median(got))
    raise RuntimeError(f"time_queued_ms: {len(got)} of {QUEUE_READINGS} "
                       f"readings in {QUEUE_TRIES * QUEUE_READINGS} tries "
                       f"(late or above {QUEUE_MISREAD} x the back-to-back "
                       f"{b2b:.4f} ms): does the timed function wait on "
                       f"the card?")


# bytes written between the launches that time_cold_ms times: more than
# the H100's 50 MB of L2
L2_FLUSH_BYTES = 128 << 20


def time_cold_ms(fn, iters):
    """Mean ms of ``fn`` on the card with L2 flushed before each call (a
    128 MB fill, then a spin of the card that lets the host enqueue ``fn``
    before its start event), as a frame's flow finds its inputs after
    other kernels' traffic; after 2 warm-up calls."""
    import torch
    buf = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    for _ in range(2):
        fn()
    ev = []
    for _ in range(iters):
        buf.fill_(1)
        torch.cuda._sleep(1_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        fn()
        t1.record()
        ev.append((t0, t1))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in ev) / iters


def butterfly_mults(n):
    """Multiplies of one n-point partial butterfly (x265's
    partialButterfly): the odd half's (n/2)^2 and the even half's."""
    return 1 if n == 1 else (n // 2) ** 2 + butterfly_mults(n // 2)


def chain_ops(n):
    """int32 operations of one n x n residual chain as K2, K20 and K23 run
    it: four passes of n partial butterflies, a multiply and an add each."""
    return 4 * n * 2 * butterfly_mults(n)


def bound_ms(nbytes, ops):
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_f32_ms(nbytes, ops):
    """The least time with the operations on the f32 FMA pipes: K16's
    filters, and K6's exact integer arithmetic, which it runs as f32."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = ops / H100_F32_FLOPS * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def bound_tc_ms(nbytes, int32_ops=0, int8_ops=0, f16_flops=0):
    """The least time counted with the units a tensor-core design maps its
    work onto: bytes over HBM against the int8 products at 1,979 TOP/s,
    the f16 products at 989 TFLOP/s and the rest on the int32 ALUs.  The
    tensor cores run beside the int32 pipes, so the operations take the
    longest of the three times, not their sum."""
    tb = nbytes / H100_BYTES_PER_S * 1e3
    to = max(int32_ops / H100_INT32_OPS_PER_S, int8_ops / H100_INT8_OPS_PER_S,
             f16_flops / H100_F16_FLOPS) * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


# DC and the modes whose angle is 0 or +-32 (2, 10, 18, 26, 34) copy
# reference samples: no interpolation
K1_COPY_MODES = (1, 2, 10, 18, 26, 34)


def k1_ops(b, n, bd, modes=None):
    """K1's work for b CUs as its design maps it: satd35 (modes None)
    predicts 35 n x n blocks, 5 int32 operations a sample for planar and
    the interpolating angular modes (two taps, a multiply-add, the rounding
    shift; none for DC and the copy modes), takes the difference and sums
    |.| (3 more), and transforms each 8x8 block with two 8x8x8 f16 products
    (32 flops a sample; 48 at bit depth 10, whose second stage takes two);
    predict forms the blocks of `modes` ([b, k]), 5 operations a sample of
    an interpolating mode.  Returns (int32 ops, f16 flops, the int32-only
    count of the design before: 16 and 8 a sample of every mode)."""
    if modes is None:
        interp = 35 - len(K1_COPY_MODES)
        return (b * n * n * (5 * interp + 3 * 35),
                b * 35 * n * n * (32 if bd == 8 else 48),
                b * 35 * n * n * 16)
    m = np.asarray(modes.cpu() if hasattr(modes, "cpu") else modes)
    interp = int((~np.isin(m, K1_COPY_MODES)).sum())
    return interp * n * n * 5, 0, m.size * n * n * 8


def k5_split_blocks(plane, bn, sr):
    """The blocks of a K5 call whose window (read at clamped coordinates)
    holds a sample outside [0, 255], so that the kernel's vote takes the
    byte split's second product."""
    import torch
    import torch.nn.functional as F
    out = ((plane < 0) | (plane > 255)).float()[None, None]
    out = F.pad(out, (sr, sr, sr, sr), mode="replicate")
    return int(F.max_pool2d(out, bn + 2 * sr, bn).sum().item())


def k5_ops(nb, bn, sr, split=0):
    """K5's work for nb blocks: the correlation's S^2 bn^2 multiply-adds
    as int8 products (twice for the `split` blocks whose window needs the
    byte split), the box sums of the window energies (4 int32 operations
    an entry of the (bn + 2 sr) x S row sums and of the S x S column sums,
    4 for the combination) and c2 (2 a sample).  Returns (int32 ops, int8
    ops, the int32-only count of the design before: 3 a multiply-add)."""
    s = 2 * sr + 1
    ws = bn + 2 * sr
    return (nb * (4 * ws * s + 8 * s * s + 2 * bn * bn),
            (nb + split) * 2 * s * s * bn * bn,
            nb * s * s * bn * bn * 3)


def nbytes(*ts):
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


# ---- phase 2: kernels against their plain versions --------------------------

def ref_inputs(rng, b, n, dev, maxv=255):
    """Raw refs with availability patterns, including blocks with no
    references at all (frame corner) and flat 0 / maxv content."""
    import torch
    top = rng.integers(0, maxv + 1, (b, 2 * n)).astype(np.int32)
    left = rng.integers(0, maxv + 1, (b, 2 * n)).astype(np.int32)
    cor = rng.integers(0, maxv + 1, b).astype(np.int32)
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
    top[3::7] = maxv
    left[3::7] = maxv
    cor[3::7] = maxv
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


def phase_kernels(f, h16, w16, iters, dev="cuda", bd=8):
    """Each kernel at the main path's batch shapes: the estimate's calls for
    F frames (K1-K3) and the loop filter of F frames (K4).  At bd 10 (the
    Main10 path, no loop filter): K1-K3 on 10-bit samples, rows named
    `<kernel>_main10`."""
    import torch
    from x265amod_tpu_torch.ops import cuda_lib, deblock, estbits, intra, \
        residual
    dev = torch.device(dev)
    rng = np.random.default_rng(1)
    b16, b32 = f * h16 * w16, f * h16 * w16 // 4
    qps = np.array([0, 22, 27, 30, 51], np.int32)
    maxv = (1 << bd) - 1
    tag = "_main10" if bd == 10 else ""
    rows = []

    # K1 intra_pred: satd35 at B16/B32 and predict of the top-4 shortlist
    k1 = dict(ms=0.0, plain_ms=0.0, bytes=0, err=0.0, ms_satd35=0.0,
              ms_predict=0.0)
    k1_int = k1_f16 = k1_old = 0
    for n, b in ((16, b16), (32, b32)):
        refs = ref_inputs(rng, b, n, dev, maxv)
        orig = rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32)
        orig[2::7] = 0
        orig[3::7] = maxv
        orig = torch.as_tensor(orig, device=dev)
        got = intra.satd35(orig, *refs, n, 0, bit_depth=bd)
        want = intra.satd35_plain(orig, *refs, n, 0, bd)
        k1["err"] = max(k1["err"], check_equal(f"satd35 n={n} bd={bd}", got,
                                               want))
        del got, want
        modes = torch.as_tensor(rng.integers(0, 35, (b, 4)).astype(np.int32),
                                device=dev)
        modes[:, 1], modes[:, 2] = 10, 26        # the clipped edge filters
        for c_idx in (0, 1):
            got = intra.predict(*refs, modes, n, c_idx, bit_depth=bd)
            want = intra.predict_plain(*refs, modes, n, c_idx, bd)
            k1["err"] = max(k1["err"], check_equal(
                f"predict n={n} c={c_idx} bd={bd}", got, want))
        del got, want
        ms_s = time_ms(lambda: intra.satd35(orig, *refs, n, 0,
                                            bit_depth=bd), iters)
        ms_p = time_ms(lambda: intra.predict(*refs, modes, n, 0,
                                             bit_depth=bd), iters)
        k1["ms"] += ms_s + ms_p
        k1["ms_satd35"] += ms_s
        k1["ms_predict"] += ms_p
        k1["plain_ms"] += time_ms(
            lambda: intra.satd35_plain(orig, *refs, n, 0, bd), 2)
        k1["plain_ms"] += time_ms(
            lambda: intra.predict_plain(*refs, modes, n, 0, bd), 2)
        io = nbytes(orig, *refs) + b * 35 * 4 + nbytes(*refs, modes) \
            + b * 4 * n * n * 4
        for ops in (k1_ops(b, n, bd), k1_ops(b, n, bd, modes)):
            k1_int += ops[0]
            k1_f16 += ops[1]
            k1_old += ops[2]
        k1["bytes"] += io
    k1["bound_ms"], k1["bound_by"] = bound_tc_ms(k1["bytes"], k1_int,
                                                 f16_flops=k1_f16)
    k1["bound_ms_int32"], k1["bound_by_int32"] = bound_ms(k1["bytes"],
                                                          k1_old)
    rows.append(("intra_pred" + tag, "x265amod_tpu_torch/csrc/intra_pred.cu",
                 "x265amod_tpu/ops/intra.py:133 predict_all_modes_batch "
                 "(+ :250 predict_modes_batch, :340 substitute_refs_general,"
                 " models/intra_tree.py:68 _satd_modes)", k1))

    # K2 residual_chain and K3 tu_bits: the estimate's four calls
    k2 = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    k3 = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    for n, b, k, c_idx in ((16, b16, 4, 0), (8, 2 * b16, 1, 1),
                           (32, b32, 4, 0), (16, 2 * b32, 1, 1)):
        spread = 40 << (bd - 8)
        orig = rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32)
        pred = np.clip(orig[:, None] + rng.integers(-spread, spread + 1,
                                                    (b, k, n, n)),
                       0, maxv).astype(np.int32)
        pred[::5] = rng.integers(0, maxv + 1, (n, n))  # far predictions
        orig[1::5] = 0
        pred[1::5] = maxv                             # flat 0 vs flat max
        orig[2::5] = maxv
        pred[2::5] = maxv                             # zero residual
        qp = qps[rng.integers(0, len(qps), b)]
        orig, pred, qp = (torch.as_tensor(a, device=dev)
                          for a in (orig, pred, qp))
        for sbh in (False, True):
            for intra in (True, False):         # intra / inter rounding
                got = residual.residual_chain(orig, pred, qp, sbh,
                                              intra=intra, bit_depth=bd)
                want = residual.residual_chain_plain(orig, pred, qp, sbh,
                                                     intra=intra,
                                                     bit_depth=bd)
                for part, g, w_ in zip(("levels", "recon", "ssd"), got,
                                       want):
                    k2["err"] = max(k2["err"], check_equal(
                        f"residual_chain n={n} sbh={sbh} intra={intra} "
                        f"bd={bd} {part}", g, w_))
        levels = got[0]
        del got, want
        want_recon = k == 1
        k2["ms"] += time_ms(lambda: residual.residual_chain(
            orig, pred, qp, False, want_recon=want_recon, bit_depth=bd),
            iters)
        k2["plain_ms"] += time_ms(lambda: residual.residual_chain_plain(
            orig, pred, qp, False, want_recon=want_recon, bit_depth=bd), 2)
        k2["bytes"] += nbytes(orig, pred, qp) + b * k * n * n * 2 \
            + (b * k * n * n * 4 if want_recon else 0) + b * k * 4
        k2["ops"] += b * k * chain_ops(n)
        qk = qp[:, None].expand(b, k)
        dense = torch.as_tensor(
            (rng.integers(-300, 301, (b, n, n)) *
             (rng.random((b, n, n)) < 0.6)).astype(np.int16), device=dev)
        for st in ("I", "P", "B"):              # the slice type's table
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
    rows.append(("residual_chain" + tag,
                 "x265amod_tpu_torch/csrc/residual_chain.cu",
                 "x265amod_tpu/ops/transforms.py:133 fwd_transform "
                 "(+ :151 inv_transform, ops/quant.py:100,136, "
                 "ops/sbh.py:45)", k2))
    rows.append(("tu_bits" + tag, "x265amod_tpu_torch/csrc/tu_bits.cu",
                 "x265amod_tpu/ops/estbits.py:114 tu_bits", k3))
    if bd == 10:          # the Main10 path runs no loop filter
        cuda_lib.reset_launches()
        return rows

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
    k4["bound_ms"], k4["bound_by"] = bound_ms(k4["bytes"], k4["ops"])
    rows.append(("deblock", "x265amod_tpu_torch/csrc/deblock.cu",
                 "x265amod_tpu/ops/deblock.py:494 deblock_luma_bs "
                 "(+ :529 deblock_chroma_bs)", k4))
    cuda_lib.reset_launches()
    return rows


def rdoq_tie_lambdas(orig, pred, qp, lam, n, st, c_idx, intra):
    """Per-block lambdas (f32, on the CPU) within a few ulps of an RDOQ tie:
    even blocks at the hi/lo tie of their largest coefficient, odd blocks
    at the kill tie of their first 4x4 group, so that the kernel's choice
    turns on the last bit of its f32 costs.  Blocks without a tie keep
    ``lam``."""
    import torch
    from x265amod_tpu_torch.ops import rdoq
    from x265amod_tpu_torch.ops.quant import quant
    from x265amod_tpu_torch.ops.transforms import fwd_transform
    o, p_, q = orig.cpu(), pred[:, 0].cpu(), qp.cpu().long()
    co = fwd_transform(o - p_)
    lv = quant(co, q[:, None, None], intra=intra)
    a = lv.abs().long()
    b = a.shape[0]
    qb = 14 + q // 6 + 7 - (n.bit_length() - 1)
    sc = torch.as_tensor(rdoq.QUANT_SCALES_F32)[q % 6]
    qf = ((co.abs().float() * sc[:, None, None])
          / torch.bitwise_left_shift(torch.ones_like(qb), qb).float()
          [:, None, None]).double()
    step = torch.as_tensor(rdoq.pixel_step_sse(n)).double()[q]
    rtab = torch.as_tensor(rdoq.rate_consts(st, c_idx))
    csb0, csb1 = (float(x) for x in rdoq.group_csb(st, c_idx))
    out = lam.cpu().clone()
    flat = a.reshape(b, -1)
    pos = flat.argmax(1)
    hi = flat.gather(1, pos[:, None])[:, 0]
    qv = qf.reshape(b, -1).gather(1, pos[:, None])[:, 0]
    rr = rdoq.level_rate(torch.stack([hi, (hi - 1).clamp(min=0)], 1),
                         q[:, None].expand(b, 2), rtab).double()
    den = rr[:, 0] - rr[:, 1]
    t_hilo = step * ((qv - hi + 1) ** 2 - (qv - hi) ** 2) / den
    ok_hilo = (hi > 0) & (den > 0) & (t_hilo > 0) & (t_hilo < 1e7)
    t_grp = out.double()
    ok_grp = torch.zeros(b, dtype=torch.bool)
    for _ in range(3):
        l1 = rdoq.rdoq_adjust_plain(co, lv, q, t_grp.float(), c_idx, st,
                                    cg_pass=False).abs().long()[:, :4, :4]
        g = qf[:, :4, :4]
        r = rdoq.level_rate(l1, q[:, None, None].expand_as(l1), rtab)
        den = r.double().sum((1, 2)) + csb1 - csb0
        t = step * (g ** 2 - (g - l1) ** 2).sum((1, 2)) / den
        ok_grp = (l1.sum((1, 2)) > 0) & (den > 0) & (t > 1e-3) & (t < 1e7)
        t_grp = torch.where(ok_grp, t, t_grp)
    even = torch.arange(b) % 2 == 0
    tie = torch.where(even, t_hilo, t_grp).float()
    use = torch.where(even, ok_hilo, ok_grp)
    # a few ulps either side of the tie
    k = torch.arange(b) % 9 - 4
    for _ in range(4):
        tie = torch.where(k > 0, torch.nextafter(tie, tie * 2), tie)
        tie = torch.where(k < 0, torch.nextafter(tie, tie * 0), tie)
        k = k - k.sign()
    return torch.where(use, tie, out).to(lam.device), int(use.sum())


def phase_kernels_rdoq(iters, dev="cuda"):
    """K2 with its RDOQ stage (row 21) against the plain chain with
    `rdoq_adjust_plain`, timed with and without the stage at the same
    shapes: one diagonal's luma commit chains of config 1's 16-frame batch
    (st I, intra rounding: 16 frames x 6 CTUs at n 32, 96 cells at n 16)
    and one 1920x1088 frame's final coding (inter rounding): a B frame's
    luma (st B, 8160 cells at n 16, 2040 CTUs at n 32), a P frame's luma
    and stacked chroma (st P: also 16320 blocks at n 8, 4080 at n 16).
    Edge inputs: QP 0 and 51, lambda 0 and 1e6, all-zero blocks, flat
    0 / 1023 blocks at bit depth 10 (levels at the 16-bit clip), and
    lambdas within 4 ulps of a hi/lo or a group-kill tie."""
    import torch
    from x265amod_tpu_torch.ops import residual
    dev = torch.device(dev)
    rng = np.random.default_rng(8)
    shapes = {"config1_diagonal": [(32, 96, "I", 0, True),
                                   (16, 96, "I", 0, True)],
              "b_frame_final": [(16, 8160, "B", 0, False),
                                (32, 2040, "B", 0, False)],
              "p_frame_final": [(16, 8160, "P", 0, False),
                                (8, 16320, "P", 1, False),
                                (32, 2040, "P", 0, False),
                                (16, 4080, "P", 1, False)]}
    d = dict(err=0.0, ties=0)
    for key, calls in shapes.items():
        ms = ms_off = plain = 0.0
        nbytes_ = int_ops = f32_ops = 0
        for n, b, st, c_idx, intra in calls:
            orig = rng.integers(0, 256, (b, n, n)).astype(np.int32)
            pred = np.clip(orig[:, None] + rng.integers(-30, 31,
                                                        (b, 1, n, n)),
                           0, 255).astype(np.int32)
            orig[1::11], pred[1::11] = 0, 255          # flat 0 vs 255
            orig[2::11], pred[2::11] = 100, 100        # all-zero levels
            qp = rng.choice(np.array([0, 22, 27, 30, 32, 37, 51], np.int32),
                            b)
            lam = (10.0 ** rng.uniform(-1, 4, b)).astype(np.float32)
            lam[3::11], lam[4::11] = 0.0, 1e6
            orig, pred, qp, lam = (torch.as_tensor(a, device=dev)
                                   for a in (orig, pred, qp, lam))
            lam_t, nt = rdoq_tie_lambdas(orig, pred, qp, lam, n, st, c_idx,
                                         intra)
            d["ties"] += nt
            for lm in (lam, lam_t):
                got = residual.residual_chain(orig, pred, qp, True,
                                              intra=intra, rdoq=True,
                                              lam=lm, st=st, c_idx=c_idx)
                want = residual.residual_chain_plain(
                    orig, pred, qp, True, intra=intra, rdoq=True, lam=lm,
                    st=st, c_idx=c_idx)
                for part, g, w_ in zip(("levels", "recon", "ssd"), got,
                                       want):
                    d["err"] = max(d["err"], check_equal(
                        f"residual_chain rdoq {key} n={n} {st} {part}", g,
                        w_))

            def run(rd=True, fn=residual.residual_chain):
                return fn(orig, pred, qp, True, intra=intra, rdoq=rd,
                          lam=lam, st=st, c_idx=c_idx)
            ms += time_ms(run, iters)
            ms_off += time_ms(lambda: run(False), iters)
            plain += time_ms(lambda: run(fn=residual.residual_chain_plain),
                             2)
            nbytes_ += nbytes(orig, pred, qp, lam) + b * n * n * (2 + 4) \
                + b * 4
            int_ops += b * chain_ops(n)
            # per coefficient: two costs (sub, mul, rate add, mul, fma) and
            # its share of the group pass (3 products, the rate, two lane
            # sums, the zero chain's fma)
            f32_ops += b * n * n * 24
        d[f"ms_{key}"], d[f"ms_without_stage_{key}"] = ms, ms_off
        d[f"plain_ms_{key}"] = plain
        t_int = int_ops / H100_INT32_OPS_PER_S * 1e3
        t_f32 = f32_ops / H100_F32_FLOPS * 1e3
        d[f"bound_ms_{key}"], d[f"bound_by_{key}"] = max(
            (nbytes_ / H100_BYTES_PER_S * 1e3, "bytes"),
            (t_int + t_f32, "operations"))
    # bit depth 10 (the kernel runs it, the encoder refuses it): flat 0
    # against 1023 at QP 0 quantizes to the 16-bit clip (-32768)
    n, b = 32, 8
    orig = torch.zeros((b, n, n), dtype=torch.int32, device=dev)
    pred = torch.full((b, 1, n, n), 1023, dtype=torch.int32, device=dev)
    pred[1::2, :, :, : n // 2] = 0
    qp = torch.zeros(b, dtype=torch.int32, device=dev)
    lam = torch.as_tensor(np.float32([0, 1, 10, 100, 1e3, 1e4, 1e5, 1e6]),
                          device=dev)
    got = residual.residual_chain(orig, pred, qp, True, bit_depth=10,
                                  rdoq=True, lam=lam, st="I")
    want = residual.residual_chain_plain(orig, pred, qp, True, bit_depth=10,
                                         rdoq=True, lam=lam, st="I")
    for g, w_ in zip(got, want):
        d["err"] = max(d["err"], check_equal("residual_chain rdoq bd 10",
                                             g, w_))
    d["level_bound_reached"] = bool(
        (residual.residual_chain_plain(orig, pred, qp, False, bit_depth=10)
         [0].long().abs() >= 32767).any())
    if not d["level_bound_reached"] or d["ties"] < 1000:
        raise AssertionError("residual_chain rdoq: edge inputs missing "
                             f"(ties {d['ties']})")
    # the row: a B frame's final coding, the call phase 11 makes most
    d["ms"], d["plain_ms"] = d["ms_b_frame_final"], d["plain_ms_b_frame_final"]
    d["bound_ms"], d["bound_by"] = d["bound_ms_b_frame_final"], \
        d["bound_by_b_frame_final"]
    d["library_ms"] = None
    d["library_note"] = ("none: no PyTorch call makes a rate-distortion "
                         "choice per coefficient")
    return [("residual_chain_rdoq",
             "x265amod_tpu_torch/csrc/residual_chain.cu",
             "x265amod_tpu/ops/rdoq.py:87 rdoq_adjust (a stage of K2 "
             "between quant and sign-bit hiding)", d)]


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


def k6_flat_p_args(dev):
    """The arguments of K6's call in phase 2's flat P frame (1920x1088, n
    16, sr 16, 8160 blocks): the card's IDR recon, the frame's blocks, the
    integer MVs of K5 and the argmin kernel, lambda at QP 32."""
    import torch
    from x265amod_tpu_torch.models.inter_frame import InterFrameEncoder
    from x265amod_tpu_torch.ops import me
    w, h, recon, cur = flat_inter_inputs(dev)
    enc = InterFrameEncoder(w, h, device=dev)
    lam = enc._maps(32)["lam"].reshape(-1).to(torch.float32).contiguous()
    ref = recon[0][0]
    blk = cur[0].reshape(h // 16, 16, w // 16, 16).permute(0, 2, 1, 3) \
        .reshape(-1, 16, 16).contiguous()
    mvi = me.int_mv_argmin(me.me_ssd_grid(blk, ref, enc.sr, 16), lam, enc.sr)
    return ref, blk, mvi, lam


def phase_kernels_k6_1080p(iters, dev="cuda"):
    """K6 at the flat P frame's call (`k6_flat_p_args`) against its plain
    version bit for bit, timed back to back, with L2 flushed and queued
    behind a spin.  Returns the keys added to the `subpel` row."""
    from x265amod_tpu_torch.ops import me
    ref, blk, mvi, lam = k6_flat_p_args(dev)
    got = me.subpel_refine(ref, blk, mvi, lam, 16)
    want = me.subpel_refine_plain(ref, blk, mvi, lam, 16)
    err = max(check_equal("subpel mv flat P 1080p", got[0], want[0]),
              check_equal("subpel ssd flat P 1080p", got[1], want[1]))
    nb = blk.shape[0]
    nbytes_ = nbytes(ref, blk, mvi, lam) + nb * 12
    ops = nb * subpel_ops(16)
    bound, by = bound_f32_ms(nbytes_, ops)
    bound_int32, by_int32 = bound_ms(nbytes_, ops)
    return dict(
        err=err,
        ms_flat_p_1080p=time_ms(lambda: me.subpel_refine(ref, blk, mvi, lam,
                                                         16), iters),
        ms_flat_p_1080p_l2_cold=time_cold_ms(
            lambda: me.subpel_refine(ref, blk, mvi, lam, 16), iters),
        ms_device_flat_p_1080p=time_queued_ms(
            lambda: me.subpel_refine(ref, blk, mvi, lam, 16), iters),
        plain_ms_flat_p_1080p=time_ms(
            lambda: me.subpel_refine_plain(ref, blk, mvi, lam, 16), 2),
        bound_ms_flat_p_1080p=bound, bound_by_flat_p_1080p=by,
        bound_ms_int32_flat_p_1080p=bound_int32,
        bound_by_int32_flat_p_1080p=by_int32,
        blocks_flat_p_1080p=nb)


def k7_ops(nb, n, chroma):
    """int32 operations of nb uni predictions: the n + T - 1 rows filtered
    horizontally (T taps, a multiply and an add each), the vertical taps
    and the two roundings and the clip of each pixel."""
    t = 4 if chroma else 8
    return nb * ((n + t - 1) * n * 2 * t + n * n * (2 * t + 4))


def k7_read_bytes(plane, mv, n, chroma, use=None):
    """Bytes that the uni predictions k of ``plane`` [H, W] named by ``use``
    (a bool mask over mv's rows; all by default), prediction k of raster
    block k mod (H / n)(W / n), must read:
    their MV rows, and once each sample of the plane that a block's
    prediction depends on, at clamped coordinates: along each axis the
    samples under the phase's nonzero taps (n + T - 1 wide where all T
    are nonzero, n wide at phase 0, a single 64 tap)."""
    import torch
    from x265amod_tpu_torch.ops import me
    h, w = plane.shape
    filt, sh = (me.CHROMA_FILTERS, 3) if chroma else (me.LUMA_FILTERS, 2)
    nz = [np.flatnonzero(f) for f in np.asarray(filt)]
    first = torch.as_tensor([z[0] for z in nz], device=mv.device)
    span = torch.as_tensor([n + z[-1] - z[0] for z in nz], device=mv.device)
    m = filt.shape[1] // 2 - 1
    k = torch.arange(mv.shape[0], device=mv.device)
    if use is not None:
        k = k[use]
    v = mv[k].long()
    ar = torch.arange(n + filt.shape[1] - 1, device=mv.device)

    def axis(origin, comp, size):
        ph = comp & ((1 << sh) - 1)
        lo = origin + (comp >> sh) - m + first[ph]
        return (lo[:, None] + ar).clamp(0, size - 1), ar < span[ph][:, None]
    blk = k % ((h // n) * (w // n))
    xs, okx = axis((blk % (w // n)) * n, v[:, 0], w)
    ys, oky = axis((blk // (w // n)) * n, v[:, 1], h)
    hit = torch.zeros(h * w, dtype=torch.bool, device=mv.device)
    hit[(ys[:, :, None] * w + xs[:, None, :])[
        oky[:, :, None] & okx[:, None, :]]] = True
    return int(hit.sum()) * plane.element_size() + \
        k.numel() * 2 * mv.element_size()


def window_mvs(rng, nb, wb, unit, m):
    """MVs [nb, 2] in 1/unit pel of the raster blocks of a plane wb blocks
    wide: integer parts within +-m (the window bound), every phase pair in
    turn, the border blocks' pointing past the four frame edges."""
    base = rng.integers(-m, m + 1, (nb, 2)) * unit
    base[:wb, 1] = -m * unit                  # top row of blocks: up
    base[-wb:, 1] = m * unit                  # bottom row: down
    base[::wb, 0] = -m * unit                 # left column: left
    base[wb - 1::wb, 0] = m * unit            # right column: right
    i = np.arange(nb)
    return (base + np.stack([i % unit, (i // unit) % unit], 1)) \
        .astype(np.int32)


def k7_flat_inputs(dev, sr=16):
    """K7's calls at the flat 1080p frames' shapes: the card's CTB16 IDR
    recons of phase 2's flat P/B frames (`flat_inter_inputs`) as list 0's
    and list 1's planes (1920x1088 luma, 960x544 chroma), the MVs of the
    8160 16x16 blocks (`window_mvs`, within +-(sr + 2) luma pels, so
    +-(sr / 2 + 2) chroma pels as the chroma calls read them), directions
    0-3 at random and K9's bi-predictions of both planes.  Returns a dict
    of tensors."""
    import torch
    from x265amod_tpu_torch.ops import me
    rng = np.random.default_rng(16)
    w, h, recon, _ = flat_inter_inputs(dev)
    wb, nb = w // 16, (w // 16) * (h // 16)
    mv0, mv1 = (torch.as_tensor(window_mvs(rng, nb, wb, 4, sr + 2),
                                device=dev) for _ in range(2))
    dirs = torch.as_tensor(rng.integers(0, 4, nb).astype(np.int32),
                           device=dev)
    out = dict(y0=recon[0][0], y1=recon[1][0], c0=recon[0][1],
               c1=recon[1][1], mv0=mv0, mv1=mv1, dir=dirs)
    out["bi_y"] = me.mc_bi(out["y0"], out["y1"], mv0, mv1, 16, False,
                           sr + 2)
    out["bi_c"] = me.mc_bi(out["c0"], out["c1"], mv0, mv1, 8, True,
                           sr // 2 + 2)
    return out


def phase_kernels_k7_1080p(iters, dev="cuda"):
    """K7 at the flat 1080p frames' calls (`k7_flat_inputs`): the trial's
    and the P frame's final luma call (n 16, 8160 blocks), a chroma call
    (n 8, 8160 blocks) and the select entry of a B frame's final MC on
    luma and chroma, with and without K9's rows (the selbi keys: the
    both-list blocks bi-predicted in the same launch), each against its
    plain version bit for bit, timed back to back, with L2 flushed before
    each call and queued behind a spin (the kernel's own time).  Each
    bound counts the bytes this run's
    blocks must read (`k7_read_bytes`; the select entry's per list, and
    K9's rows only where both lists are used; without those rows, the
    `_selbi` keys, both lists of the blocks that use both) and the output.
    Returns the keys added to the mc_qpel row."""
    from x265amod_tpu_torch.ops import me
    a = k7_flat_inputs(dev)
    nb = a["mv0"].shape[0]
    d3 = a["dir"] & 3
    # the select entry: list 0 where dir & 3 is 1, list 1 where it is 0 or
    # 2, K9's rows where it is 3
    l0, l1, both = d3 == 1, (d3 & 1) == 0, d3 == 3
    uni = int((~both).sum())

    def sel_bytes(r0, r1, n, chroma):
        return (k7_read_bytes(r0, a["mv0"], n, chroma, l0)
                + k7_read_bytes(r1, a["mv1"], n, chroma, l1)
                + int(both.sum()) * n * n * 4 + nbytes(a["dir"]))

    def selbi_bytes(r0, r1, n, chroma):
        # without bi rows: the both-list blocks read both lists
        return (k7_read_bytes(r0, a["mv0"], n, chroma, l0 | both)
                + k7_read_bytes(r1, a["mv1"], n, chroma, l1 | both)
                + nbytes(a["dir"]))

    def selbi(r0, r1, mv0, mv1, d, n, chroma, mm):
        return me.mc_qpel_sel(r0, r1, mv0, mv1, d, n, chroma, None, mm, [])

    def selbi_plain(r0, r1, mv0, mv1, d, n, chroma, mm):
        return me.mc_sel_plain(r0, r1, mv0, mv1, d, n, chroma,
                               me.mc_bi_plain(r0, r1, mv0, mv1, n, chroma))
    nb3 = int(both.sum())
    calls = {
        "_flat_1080p_luma16": (
            me.mc_luma_qpel, me.mc_luma_qpel_plain, (a["y0"], a["mv0"], 16),
            k7_read_bytes(a["y0"], a["mv0"], 16, False), k7_ops(nb, 16, 0)),
        "_flat_1080p_chroma8": (
            me.mc_chroma_qpel, me.mc_chroma_qpel_plain,
            (a["c0"], a["mv0"], 8), k7_read_bytes(a["c0"], a["mv0"], 8, True),
            k7_ops(nb, 8, 1)),
        "_flat_1080p_sel_luma16": (
            me.mc_qpel_sel, me.mc_sel_plain,
            (a["y0"], a["y1"], a["mv0"], a["mv1"], a["dir"], 16, False,
             a["bi_y"]), sel_bytes(a["y0"], a["y1"], 16, False),
            k7_ops(uni, 16, 0)),
        "_flat_1080p_sel_chroma8": (
            me.mc_qpel_sel, me.mc_sel_plain,
            (a["c0"], a["c1"], a["mv0"], a["mv1"], a["dir"], 8, True,
             a["bi_c"]), sel_bytes(a["c0"], a["c1"], 8, True),
            k7_ops(uni, 8, 1)),
        "_flat_1080p_selbi_luma16": (
            selbi, selbi_plain,
            (a["y0"], a["y1"], a["mv0"], a["mv1"], a["dir"], 16, False, 18),
            selbi_bytes(a["y0"], a["y1"], 16, False),
            k7_ops(uni, 16, 0) + k9_ops(nb3, 16, 0)),
        "_flat_1080p_selbi_chroma8": (
            selbi, selbi_plain,
            (a["c0"], a["c1"], a["mv0"], a["mv1"], a["dir"], 8, True, 10),
            selbi_bytes(a["c0"], a["c1"], 8, True),
            k7_ops(uni, 8, 1) + k9_ops(nb3, 8, 1))}
    k7 = dict(err=0.0, blocks_flat_1080p=nb, uni_blocks_flat_1080p_sel=uni)
    for key, (fn, plain, args, read, ops) in calls.items():
        got = fn(*args)
        k7["err"] = max(k7["err"], check_equal(f"mc_qpel{key}", got,
                                               plain(*args)))
        k7[f"ms{key}"] = time_ms(lambda: fn(*args), iters)
        k7[f"ms_l2_cold{key}"] = time_cold_ms(lambda: fn(*args), iters)
        k7[f"ms_device{key}"] = time_queued_ms(lambda: fn(*args), iters)
        k7[f"plain_ms{key}"] = time_ms(lambda: plain(*args), 2)
        # the bytes this run's blocks need read, and the output written
        k7[f"bytes{key}"] = read + nbytes(got)
        k7[f"bound_ms{key}"], k7[f"bound_by{key}"] = bound_ms(
            read + nbytes(got), ops)
    return k7


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
    nbytes_, ops, int32_ops, int8_ops = 0, 0, 0, 0
    for bn in (16, 32):
        cb = blocks(bn)
        nb = cb.shape[0]
        for plane in (ref_t, hp):
            k5 = k5_ops(nb, bn, sr, k5_split_blocks(plane, bn, sr))
            int32_ops += k5[0]
            int8_ops += k5[1]
            d["err"] = max(d["err"], check_equal(
                f"me_ssd_grid bn={bn}", me.me_ssd_grid(cb, plane, sr, bn),
                me.me_ssd_grid_plain(cb, plane, sr, bn)))
            d["ms"] += time_ms(lambda: me.me_ssd_grid(cb, plane, sr, bn),
                               iters)
            d["plain_ms"] += time_ms(
                lambda: me.me_ssd_grid_plain(cb, plane, sr, bn), 2)
            nbytes_ += nbytes(cb, plane) + nb * s * s * 4
            ops += k5[2]
    d["bound_ms"], d["bound_by"] = bound_tc_ms(nbytes_, int32_ops,
                                               int8_ops=int8_ops)
    d["bound_ms_int32"], d["bound_by_int32"] = bound_ms(nbytes_, ops)
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
        d["ms_device"] = d.get("ms_device", 0.0) + time_queued_ms(
            lambda: me.subpel_refine(ref_t, cb, mv, lam, bn), iters)
        d["plain_ms"] += time_ms(
            lambda: me.subpel_refine_plain(ref_t, cb, mv, lam, bn), 2)
        nbytes_ += nbytes(ref_t, cb, mv, lam) + nb * 12
        ops += nb * subpel_ops(bn)
    d["bound_ms"], d["bound_by"] = bound_f32_ms(nbytes_, ops)
    d["bound_ms_int32"], d["bound_by_int32"] = bound_ms(nbytes_, ops)
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
        d["ms_device"] = d.get("ms_device", 0.0) + time_queued_ms(
            lambda: fn(plane, mv, n), iters)
        d["plain_ms"] += time_ms(lambda: plain(plane, mv, n), 2)
        nbytes_ += k7_read_bytes(plane, mv, n, chroma) + nb * n * n * 4
        ops += k7_ops(nb, n, chroma)
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, ops)
    d["library_ms"] = None
    d["library_note"] = ("none: per-block MVs need a gather before any "
                         "convolution")
    rows.append(("mc_qpel", "x265amod_tpu_torch/csrc/mc_qpel.cu",
                 "x265amod_tpu/ops/me.py:315 mc_luma_qpel (+ :262 "
                 "mc_luma_qpel14, :377 mc_chroma_qpel, :331 "
                 "mc_chroma_qpel14)", d))
    return rows


def flat_levels(rng, f, h16, w16, dev):
    """Sparse random levels of F frames in the trees' cell layout (ly [F,
    h16, w16, 16, 16], lcb, lcr [F, h16, w16, 8, 8] int16): about half the
    cells code something, a frame codes nothing."""
    import torch
    out = []
    for n in (16, 8, 8):
        coded = rng.random((f, h16, w16, 1, 1)) < 0.5
        v = rng.integers(-4, 5, (f, h16, w16, n, n)) * (
            rng.random((f, h16, w16, n, n)) < 0.05) * coded
        if f > 1:
            v[-1] = 0
        out.append(torch.as_tensor(v.astype(np.int16), device=dev))
    return tuple(out)


def scan_bytes_ops(f, h, w, lossless):
    """(bytes, int32 operations) of the flat CTB16 scan of F frames: the
    source planes read, the recon planes, levels and modes written, the
    maps read; 35 luma modes a CTU16 through the residual chain's partial
    butterflies (`chain_ops`) and the two 8x8 chroma blocks at the chosen
    mode (none under lossless)."""
    npix = f * h * w * 1.5
    nctu = f * (h // 16) * (w // 16)
    nbytes_ = npix * (4 + 4 + 2) + nctu * 4 + (h // 16) * (w // 16) * 12
    ops = 0 if lossless else nctu * (35 * chain_ops(16) + 2 * chain_ops(8))
    return nbytes_, ops


def scan_chain(kinds, hc, wc):
    """The longest chain of coded CTUs in which each reads the one before
    it (left, top-left, top or top-right neighbour): K23's critical path
    in CTUs (all coded: the anti-diagonals d = cx + 2 cy)."""
    coded = np.ones((hc, wc), bool) if kinds is None else kinds == 2
    depth = np.zeros((hc, wc), np.int64)
    for d in range(wc + 2 * (hc - 1)):
        for cy in range(max(0, -(-(d - wc + 1) // 2)), min(hc - 1, d // 2)
                        + 1):
            cx = d - 2 * cy
            if not coded[cy, cx]:
                continue
            best = 0
            for ny, nx in ((cy, cx - 1), (cy - 1, cx - 1), (cy - 1, cx),
                           (cy - 1, cx + 1)):
                if 0 <= ny and 0 <= nx < wc:
                    best = max(best, depth[ny, nx])
            depth[cy, cx] = best + 1
    return int(depth.max()) if depth.size else 0


def k23_launches(fn):
    """The launches one K23 call enqueues."""
    from x265amod_tpu_torch.ops import cuda_lib
    before = cuda_lib.LAUNCHES["intra16_scan"]
    fn()
    return cuda_lib.LAUNCHES["intra16_scan"] - before


def check_tickets(enc, y, cb, cr, maps, kinds, lossless, label):
    """K23's first launch (its ticket list) against `scan_tickets`, and
    two launches a call."""
    import torch
    from x265amod_tpu_torch.ops import commit
    f = y.shape[0]
    hc, wc = enc.hc, enc.wc
    dev = y.device
    rec = tuple(torch.zeros_like(t) for t in (y, cb, cr))
    lv = (torch.zeros((f, hc, wc, 16, 16), dtype=torch.int16, device=dev),
          torch.zeros((f, hc, wc, 8, 8), dtype=torch.int16, device=dev),
          torch.zeros((f, hc, wc, 8, 8), dtype=torch.int16, device=dev))
    modes = torch.ones((f, hc, wc), dtype=torch.int32, device=dev)
    n = k23_launches(lambda: commit.intra16_scan(
        (y, cb, cr), rec, lv, modes, maps, sbh=enc.sbh, lossless=lossless,
        kinds=kinds, st="P"))
    sched = commit.intra16_scan((y, cb, cr), rec, lv, modes, maps,
                                sbh=enc.sbh, lossless=lossless, kinds=kinds,
                                st="P").cpu().numpy()
    want = commit.scan_tickets(None if kinds is None else
                               kinds.cpu().numpy(), f, wc, hc)
    if n != 2 or sched[0] != len(want) or \
            sched[2:2 + len(want)].tolist() != want:
        raise AssertionError(f"intra16_scan {label}: {n} launches, ticket "
                             f"list of {sched[0]} != scan_tickets' "
                             f"{len(want)}")


COMMIT_KINDS = ("all", "none", "column", "diagonal", "checker", "patch")


def commit_kinds(name, rng, hc, wc):
    """A flat P frame's kinds map [1, hc, wc] (2 intra, 0 skip, 1 inter):
    all intra, no intra, one intra column, one chain of intra CTUs each
    the top-right of the next, a checkerboard, or the 24 x 14 patch of
    phase 2's flat P frame (336 of 8160 CTUs at 1920x1088)."""
    k = rng.integers(0, 2, (1, hc, wc))
    yy, xx = np.mgrid[0:hc, 0:wc]
    if name == "all":
        k[:] = 2
    elif name == "column":
        k[0, :, wc // 3] = 2
    elif name == "diagonal":
        k[0, (xx + yy) == wc // 2] = 2
    elif name == "checker":
        k[0, (xx + yy) % 2 == 0] = 2
    elif name == "patch":
        k[0, 27:41, 48:72] = 2
    return k.astype(np.int32)


def k23_commit_kinds(kz, iters, dev):
    """K23 as the commit of a 1920x1088 P frame (the bench clip of seed 22,
    QP 32, random inter recon and levels in place) on `COMMIT_KINDS`,
    against the plain scan on the card, with its ticket list; time, bound
    and critical chain per map into kz."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    fr = synth_frames(1920, 1080, 1, seed=22)[0]
    y, cb, cr = (torch.as_tensor(_pad_to_ctu(x, 16 if k == 0 else 8),
                                 device=dev)[None].to(torch.int32)
                 for k, x in enumerate(fr))
    enc = IntraFrameEncoder(1920, 1088, device=dev)
    hc, wc = enc.hc, enc.wc
    rng = np.random.default_rng(24)
    rec = tuple(torch.clamp(t + torch.as_tensor(rng.integers(
        -9, 10, t.shape).astype(np.int32), device=dev), 0, 255)
        for t in (y, cb, cr))
    lv = tuple(torch.as_tensor(rng.integers(-3, 4, sh).astype(np.int16),
                               device=dev)
               for sh in ((1, hc, wc, 16, 16), (1, hc, wc, 8, 8),
                          (1, hc, wc, 8, 8)))
    maps = enc._maps(32)
    for name in COMMIT_KINDS:
        kinds = torch.as_tensor(commit_kinds(name, rng, hc, wc), device=dev)

        def commit(fn):
            return fn(y, cb, cr, maps, (kinds, tuple(t.clone() for t in rec),
                                        tuple(t.clone() for t in lv), "P"))
        got = commit(enc._scan_kernel)
        want = commit(enc._scan_plain)
        for i, (g, w_) in enumerate(zip(got, want)):
            kz["err"] = max(kz["err"], check_exact(
                f"intra16_scan commit {name} out{i}", g, w_))
        check_tickets(enc, y, cb, cr, maps, kinds, False, f"commit {name}")
        kz[f"ms_commit_{name}"] = time_ms(lambda: commit(enc._scan_kernel),
                                          iters)
        kz[f"plain_ms_commit_{name}"] = time_once_ms(
            lambda: commit(enc._scan_plain))
        kz[f"bound_ms_commit_{name}"], kz[f"bound_by_commit_{name}"] = \
            bound_ms(*commit16_bytes_ops(kinds))
        kz[f"intra_cells_commit_{name}"] = int((kinds == 2).sum())
        kz[f"chain_commit_{name}"] = scan_chain(kinds[0].cpu().numpy(), hc,
                                                wc)
        del got, want


# K21's shapes in phase 2 (key, F, h, w, kind): a config-1 batch of 16
# frames at 640x384, a config-2 P frame, a config-3 B frame, a 1080p CTB16
# frame
K21_CASES = (("", 16, 384, 640, "intra"), ("_p_frame", 1, 736, 1280, "p"),
             ("_b_frame", 1, 1088, 1920, "b"),
             ("_flat_1080p", 1, 1088, 1920, "flat"))


def k21_case(rng, f, h, w, kind, dev):
    """K21's inputs for F frames of w x h: sparse random levels
    (`flat_levels`), per-CTB QPs (offsets on the B and flat frames), random
    CTB32 splits (the trees), random kinds, MVs and reference indices (the
    P tree) or directions and both lists' MVs (the B tree).  Returns (levels,
    qp_sig, split, inter) as `deblock_maps` takes them."""
    import torch
    h16, w16 = h // 16, w // 16
    lv = flat_levels(rng, f, h16, w16, dev)
    flat = kind == "flat"
    grid = (h16, w16) if flat else (h16 // 2, w16 // 2)
    qp_sig = torch.as_tensor(30 + rng.integers(-6, 3, grid).astype(
        np.int32) * (kind in ("b", "flat")), device=dev)
    split = None if flat else torch.as_tensor(rng.integers(
        0, 2, (f,) + grid).astype(np.int32), device=dev)
    inter = None

    def r(lo, hi, *shp):
        return torch.as_tensor(rng.integers(lo, hi, (f, h16, w16) + shp)
                               .astype(np.int32), device=dev)
    if kind == "p":
        inter = (r(0, 3), None, r(-40, 41, 2), None, r(0, 1))
    elif kind == "b":
        inter = (r(0, 3), r(1, 4), r(-40, 41, 2), r(-40, 41, 2), None)
    return lv, qp_sig, split, inter


def k21_times(km, key, fn, iters):
    """K21's times of ``fn`` under ``key``: back to back (ms), with L2
    flushed before each call (ms_l2_cold, as a frame's flow finds the
    levels after the residual chain's traffic) and queued behind a spin
    of the card (ms_device: the kernels' own time)."""
    km[f"ms{key}"] = time_ms(fn, iters)
    km[f"ms_l2_cold{key}"] = time_cold_ms(fn, iters)
    km[f"ms_device{key}"] = time_queued_ms(fn, iters)


def phase_kernels_flat(iters, dev="cuda"):
    """K21 (the loop filter's maps), K22 (SSE/SSIM), the ME argmin and K23
    (the flat CTB16 scan) against their plain versions on the card, exact
    but the SSIM (1e-6).  K21 and K22 at the shapes of the three trees'
    tails (a config-1 batch of 16 frames of 640x384 with random splits; a
    config-2 P frame at 1280x736 and a config-3 B frame at 1920x1088 with
    random kinds, directions, MVs and reference indices and per-CTU QPs)
    and of a 1080p CTB16 frame; the argmin on K5's grids of the bench clip
    at a config-2 P frame (sr 8) and a config-3 B frame (1920x1088, sr 16),
    CU16 and CU32, plus crafted near-ties and exact ties; K23 at one
    1920x1088 frame, lossy (QP 32) and lossless, and a 16-frame batch of
    640x368.  Times: CUDA events, 20 calls after 2 warm-up (the plain
    scans once after a warm-up)."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    from x265amod_tpu_torch.ops import deblock, me, metrics
    from x265amod_tpu_torch.utils.lambdas import lambda2_of
    dev = torch.device(dev)
    rng = np.random.default_rng(21)
    km, kq = dict(err=0.0), dict(err=0.0)
    for key, f, h, w, kind in K21_CASES:
        lv, qp_sig, split, inter = k21_case(rng, f, h, w, kind, dev)
        got = deblock.deblock_maps(lv, 30, qp_sig, split, inter)
        want = deblock.deblock_maps_plain(lv, 30, qp_sig, split, inter)
        for i, (g, w_) in enumerate(zip(got, want)):
            km["err"] = max(km["err"], check_exact(
                f"deblock_maps {kind} out{i}", g, w_))
        k21_times(km, key, lambda: deblock.deblock_maps(
            lv, 30, qp_sig, split, inter), iters)
        km[f"plain_ms{key}"] = time_ms(lambda: deblock.deblock_maps_plain(
            lv, 30, qp_sig, split, inter), iters)
        ins = list(lv) + [qp_sig, split] + [t for t in inter or ()]
        km[f"bound_ms{key}"], km[f"bound_by{key}"] = bound_ms(
            nbytes(*ins) + nbytes(*got), 0)
        src = tuple(torch.as_tensor(rng.integers(0, 256, s).astype(np.int32),
                                    device=dev)
                    for s in ((f, h, w), (f, h // 2, w // 2),
                              (f, h // 2, w // 2)))
        rec = tuple(torch.clamp(t + torch.as_tensor(rng.integers(
            -6, 7, t.shape).astype(np.int32), device=dev), 0, 255)
            for t in src)
        got = metrics.frame_metrics(src, rec)
        want = metrics.frame_metrics_plain(src, rec)
        check_exact("frame_metrics sse", got[:, :3].contiguous(),
                    want[:, :3].contiguous())
        kq["err"] = max(kq["err"], check_equal("frame_metrics ssim",
                                               got[:, 3], want[:, 3], 1e-6))
        kq[f"ms{key}"] = time_ms(lambda: metrics.frame_metrics(src, rec),
                                 iters)
        kq[f"plain_ms{key}"] = time_ms(
            lambda: metrics.frame_metrics_plain(src, rec), iters)
        kq[f"bound_ms{key}"], kq[f"bound_by{key}"] = bound_ms(
            nbytes(*src, *rec, got), 0)
        del lv, src, rec
    for k in (km, kq):
        k.update(library_ms=None, shapes_note=(
            "keys without suffix: a config-1 batch of 16 frames of 640x384; "
            "_p_frame 1280x736; _b_frame 1920x1088; _flat_1080p a CTB16 "
            "frame at 1920x1088"))
    km["library_note"] = "none: no single PyTorch call derives the maps"
    kq["library_note"] = "none: no single PyTorch call computes SSIM"
    rows = [("deblock_maps", "x265amod_tpu_torch/csrc/deblock_maps.cu",
             "x265amod_tpu/ops/deblock.py:296 _bs_pair (+ :310 bs_maps, "
             ":330 intra_tree_bs_maps, :356 inter_tree_bs_maps, :384 "
             "effective_qp_map, :415 effective_qp16_tree, :454 "
             "edge_qp_maps; the flat P/B maps of models/inter_frame.py:"
             "472-501 and models/b_frame.py:562-588)", km),
            ("frame_metrics", "x265amod_tpu_torch/csrc/frame_metrics.cu",
             "x265amod_tpu/ops/metrics.py:24 ssim_plane (+ the plane SSE of "
             "each encoder's tail)", kq)]

    # ---- the ME argmin on K5's grids of the bench clip ----
    ka = dict(err=0.0)
    for key, w, h, sr, seed in (("", 1280, 720, 8, 2),
                                ("_b_frame", 1920, 1080, 16, 4)):
        fr = synth_frames(w, h, 2, seed=seed)
        ref, cur_p = (torch.as_tensor(_pad_to_ctu(x[0], 32), device=dev)
                      .to(torch.int32) for x in fr)
        ms = plain = nb_all = 0.0
        nbytes_ = 0
        for bn in (16, 32):
            hh, ww = cur_p.shape
            cur = cur_p.reshape(hh // bn, bn, ww // bn, bn).permute(
                0, 2, 1, 3).reshape(-1, bn, bn).contiguous()
            g = me.me_ssd_grid(cur, ref, sr, bn)
            lam = torch.as_tensor(lambda2_of(np.full(
                g.shape[0], 32)).astype(np.float32), device=dev)
            got = me.int_mv_argmin(g, lam, sr)
            ka["err"] = max(ka["err"], check_exact(
                f"mv_argmin {w}x{h} bn {bn}", got,
                me.int_mv_argmin_plain(g, lam, sr)))
            ms += time_ms(lambda: me.int_mv_argmin(g, lam, sr), iters)
            plain += time_ms(lambda: me.int_mv_argmin_plain(g, lam, sr),
                             iters)
            nbytes_ += nbytes(g, lam, got)
            nb_all += g.shape[0]
        ka[f"ms{key}"], ka[f"plain_ms{key}"] = ms, plain
        ka[f"bound_ms{key}"], ka[f"bound_by{key}"] = bound_ms(nbytes_, 0)
        ka[f"blocks{key}"] = int(nb_all)
    # crafted near-ties (the FMA and the rounded cost pick differently)
    # and exact ties (the first index wins)
    sr, n = 8, 4096
    s_ = 2 * sr + 1
    lam = rng.uniform(1.0, 300.0, n).astype(np.float32)
    grid = rng.uniform(1e3, 1e6, (n, s_, s_)).astype(np.float32)
    bits_a = float(me.mvd_bits(torch.tensor([-4 * sr, -4 * sr])))
    cb_ = rng.uniform(1e3, 1e5, n)
    ca = (cb_ + lam * 2.0 - lam.astype(np.float64) * bits_a) * (
        1 + rng.integers(-3, 4, n) * 2.0 ** -23)
    grid[:, 0, 0], grid[:, sr, sr] = ca, cb_
    grid[::7, 1, 1] = grid[::7, 0, 0]
    g, la = (torch.as_tensor(a, device=dev) for a in (grid, lam))
    ka["err"] = max(ka["err"], check_exact(
        "mv_argmin crafted ties", me.int_mv_argmin(g, la, sr),
        me.int_mv_argmin_plain(g, la, sr)))
    ka.update(library_ms=None, ties_checked=n, shapes_note=(
        "keys without suffix: a config-2 P frame at 1280x736, sr 8, CU16 + "
        "CU32 grids (two launches); _b_frame: 1920x1088, sr 16"),
        library_note="none: torch.argmin over fma(lam, bits, grid) needs "
        "the FMA formed first (a second kernel)")
    rows.append(("mv_argmin", "x265amod_tpu_torch/csrc/mv_argmin.cu",
                 "x265amod_tpu/models/inter_tree.py:227-229 best_mv cost "
                 "and argmin", ka))

    # ---- K23, the flat CTB16 scan ----
    kz = dict(err=0.0)
    for key, w, h, f, lossless, seed in (
            ("", 1920, 1080, 1, False, 19),
            ("_lossless", 1920, 1080, 1, True, 20),
            ("_batch16_640x368", 640, 360, 16, False, 3)):
        fr = synth_frames(w, h, f, seed=seed)
        y, cb, cr = (torch.stack([torch.as_tensor(
            _pad_to_ctu(x[k], 16 if k == 0 else 8), device=dev)
            for x in fr]).to(torch.int32) for k in range(3))
        enc = IntraFrameEncoder(y.shape[2], y.shape[1], lossless=lossless,
                                device=dev)
        maps = enc._maps(32)
        got = enc._scan_kernel(y, cb, cr, maps)
        want = enc._scan_plain(y, cb, cr, maps)
        for i, (g, w_) in enumerate(zip(got, want)):
            kz["err"] = max(kz["err"], check_exact(
                f"intra16_scan {key or '1080p'} out{i}", g, w_))
        kz[f"ms{key}"] = time_ms(lambda: enc._scan_kernel(y, cb, cr, maps),
                                 iters)
        kz[f"plain_ms{key}"] = time_once_ms(
            lambda: enc._scan_plain(y, cb, cr, maps))
        kz[f"bound_ms{key}"], kz[f"bound_by{key}"] = bound_ms(
            *scan_bytes_ops(f, y.shape[1], y.shape[2], lossless))
        kz[f"chain{key}"] = scan_chain(None, enc.hc, enc.wc)
        kz[f"launches_per_call{key}"] = k23_launches(
            lambda: enc._scan_kernel(y, cb, cr, maps))
        check_tickets(enc, y, cb, cr, maps, None, lossless, f"{key or '1080p'}")
        del y, cb, cr, got, want
    k23_commit_kinds(kz, iters, dev)
    kz.update(library_ms=None, shapes_note=(
        "keys without suffix: one 1920x1088 frame at QP 32; _lossless the "
        "same frame under transquant bypass; _batch16_640x368 16 frames; "
        "_commit_<map>: the commit of a 1920x1088 P frame on adversarial "
        "kinds maps; two launches a call (the ticket list, the scan); "
        "chain: the longest chain of dependent CTUs"),
        library_note="none: no single call codes a wavefront")
    rows.append(("intra16_scan", "x265amod_tpu_torch/csrc/intra16_scan.cu",
                 "x265amod_tpu/models/intra_frame.py:121 _encode_frame "
                 "(scan body :183-234, lax.scan :236); the commit scans of "
                 "models/inter_frame.py:394-458 (:457) and "
                 "models/b_frame.py:489-548 (:547)", kz))
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
    missing = [k for k, v in launches.items() if v <= 0
               and k not in CONFIG3_KERNELS + LOOKAHEAD_KERNELS
               + RDOQ_KERNELS + LADDER_KERNELS + MULTIREF_KERNELS
               + FLAT_KERNELS]
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


def sao_ops(npix, planes):
    """Integer operations SAO analysis needs per sample of ``planes``
    planes: the difference, 4 edge classes (2 subtractions, 2 signs, the
    category map and a count/sum update: 8 each) and the band (shift and
    update: 3)."""
    return npix * planes * (1 + 4 * 8 + 3)


def sao_inputs(dev, w=1920, h=1088, seed=3):
    """SAO's planes at a w x h frame (a config-3 B frame's and a flat
    CTB16 frame's 1920x1088): luma and two chroma planes (sine texture with
    noise, flat 0 / 255 corners and a 0/255 step), each deblocked plane
    the original plus noise of +-5, equal to it on a quarter; lambdas at
    CTU 32 and 16, 0 on every seventh CTU.  Returns ((oy, ry), (ocb, rcb),
    (ocr, rcr), {32: lam, 16: lam})."""
    import torch
    rng = np.random.default_rng(seed)

    def plane(hh, ww):
        xx, yy = np.meshgrid(np.arange(ww), np.arange(hh))
        p = np.clip(128 + 80 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
                    + rng.normal(0, 4, (hh, ww)), 0, 255).astype(np.int32)
        p[: hh // 8, : ww // 8] = 0
        p[: hh // 8, ww // 8: ww // 4] = 255      # a 0/255 step
        p[-hh // 8:, -ww // 8:] = 255
        orig = torch.as_tensor(p, device=dev)
        rec = torch.clamp(orig + torch.as_tensor(
            rng.integers(-5, 6, p.shape).astype(np.int32), device=dev),
            0, 255)
        rec[: hh // 4, ww // 2:] = orig[: hh // 4, ww // 2:]  # rec == orig
        return orig.contiguous(), rec.contiguous()
    planes = (plane(h, w), plane(h // 2, w // 2), plane(h // 2, w // 2))
    lam = {}
    for ctu in (32, 16):
        n = (h // ctu) * (w // ctu)
        la = rng.uniform(0, 600, n).astype(np.float32)
        la[::7] = 0.0
        lam[ctu] = torch.as_tensor(la, device=dev)
    return planes + (lam,)


def k9_bytes(r0, r1, mv0, mv1, n, chroma):
    """Bytes K9's blocks must move: the samples each block's prediction
    depends on in each list, once (`k7_read_bytes`), and the output."""
    return (k7_read_bytes(r0, mv0, n, chroma)
            + k7_read_bytes(r1, mv1, n, chroma) + mv0.shape[0] * n * n * 4)


def k9_ops(nb, n, chroma):
    """int32 operations of nb bi-predictions: two uni filterings
    (`k7_ops` less their uni rounding) and the combination (an add, the
    rounding shift and the clip)."""
    return 2 * k7_ops(nb, n, chroma) + nb * n * n


def phase_kernels_b(iters, dev="cuda", w=1920, h=1088, sr=16):
    """K9-K11 at one config-3 B frame's shapes (1920x1080 padded to 1088
    rows, sr 16): K9 at the trials' luma calls (bn 16 and 32) and at luma
    16 and chroma 8 (the final MC's shapes, which K7's select entry now
    runs), with MVs at the window bound on the border blocks over
    references with 0/255 steps; K10 on luma (CTU 32) and on cb + cr
    jointly (CTU 16), and both in one launch (the frame entry), also at a
    flat CTB16 frame's CTU 16 / 8, with flat, exact and noisy regions and
    lambda 0 on some CTUs; K11 on the three planes of both frames.  K9's
    1080p calls, K10's frame entry and K11 are also timed queued behind a
    spin (`ms_device*`: the kernels' own time)."""
    import torch
    from x265amod_tpu_torch.ops import me, sao
    dev = torch.device(dev)
    rng = np.random.default_rng(3)
    rows = []
    (oy, ry), (ocb, rcb), (ocr, rcr), lam = sao_inputs(dev, w, h)
    ry0, ry1, rc0, rc1 = oy, ry, ocb, ocr

    # K9 mc_bi: the trials at 16 and 32, luma 16 and chroma 8 x 2
    d = dict(err=0.0, ms=0.0, plain_ms=0.0)
    nbytes_, ops = 0, 0
    for i, (r0, r1, n, chroma) in enumerate((
            (ry0, ry1, 16, False), (ry0, ry1, 32, False),
            (ry0, ry1, 16, False), (rc0, rc1, 8, True),
            (rc0, rc1, 8, True))):
        ph, pw = r0.shape
        nb = (ph // n) * (pw // n)
        mm = sr // 2 + 2 if chroma else sr + 2
        unit = 8 if chroma else 4
        mvs = [torch.as_tensor(window_mvs(rng, nb, pw // n, unit, mm),
                               device=dev) for _ in range(2)]
        d["err"] = max(d["err"], check_equal(
            f"mc_bi n={n} chroma={chroma}",
            me.mc_bi(r0, r1, *mvs, n, chroma, mm),
            me.mc_bi_plain(r0, r1, *mvs, n, chroma)))
        excess = []             # the kernel's window check: one sample out
        me.mc_bi(r0, r1, mvs[0], mvs[1] + unit, n, chroma, mm, excess)
        if int(excess[0]) != 1:
            raise AssertionError(f"mc_bi n={n}: window excess "
                                 f"{int(excess[0])}, expected 1")

        def call(r0=r0, r1=r1, mvs=mvs, n=n, chroma=chroma, mm=mm):
            # the excess appended, not read: no wait on the card
            return me.mc_bi(r0, r1, *mvs, n, chroma, mm, [])
        d["ms"] += time_ms(call, iters)
        d["plain_ms"] += time_ms(
            lambda: me.mc_bi_plain(r0, r1, *mvs, n, chroma), 2)
        nbytes_ += k9_bytes(r0, r1, *mvs, n, chroma)
        ops += k9_ops(nb, n, chroma)
        if i in (0, 1, 3):
            key = f"_1080p_{'chroma' if chroma else 'luma'}{n}"
            d[f"ms_device{key}"] = time_queued_ms(call, iters)
            d[f"ms_l2_cold{key}"] = time_cold_ms(call, iters)
            d[f"bound_ms{key}"], d[f"bound_by{key}"] = bound_ms(
                k9_bytes(r0, r1, *mvs, n, chroma), k9_ops(nb, n, chroma))
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, ops)
    d["library_ms"] = None
    d["library_note"] = ("none: two per-block-MV interpolations and a "
                         "rounding average, no single call")
    d["shapes_note"] = (
        "ms, plain_ms, bound_ms: five calls at 1920x1088 (luma n 16, 32, "
        "16; chroma n 8 twice at 960x544), MVs at the window bound; "
        "_1080p_luma16 / _luma32 / _chroma8: one call each (8160, 2040 and "
        "8160 blocks); ms_device*: the calls enqueued behind a spin of the "
        "card, the kernel's own time; ms_l2_cold*: L2 flushed before each "
        "call; bound_ms*: the samples each block needs from both lists "
        "once, and the output; the final MC's bi blocks run in K7's select "
        "entry (mc_qpel row, _flat_1080p_selbi_* keys)")
    rows.append(("mc_bi", "x265amod_tpu_torch/csrc/mc_bi.cu",
                 "x265amod_tpu/ops/me.py:323 bi_combine (+ :262 "
                 "mc_luma_qpel14, :331 mc_chroma_qpel14, :180 "
                 "_block_windows)", d))

    # K10 sao_analyse: luma and joint chroma, apart and in one launch
    d = dict(err=0.0, launches_per_b_frame=1)
    frames = {"": 32, "_flat_1080p": 16}
    for key, ctu in frames.items():
        la = lam[ctu]
        want_y = sao.sao_analyse_plain(oy, ry, la, ctu)
        want_c = sao.sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, la,
                                              ctu // 2)
        got_y, got_c = sao.sao_analyse_frame(oy, ocb, ocr, ry, rcb, rcr, la,
                                             ctu)
        for g, p_ in zip(got_y + got_c, want_y + want_c):
            d["err"] = max(d["err"], check_equal(
                f"sao_analyse_frame ctu {ctu}", g, p_))
        for g, p_ in zip(sao.sao_analyse(oy, ry, la, ctu), want_y):
            d["err"] = max(d["err"], check_equal("sao_analyse luma", g, p_))
        for g, p_ in zip(sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, la,
                                                ctu // 2), want_c):
            d["err"] = max(d["err"], check_equal("sao_analyse chroma", g,
                                                 p_))

        def frame(la=la, ctu=ctu):
            return sao.sao_analyse_frame(oy, ocb, ocr, ry, rcb, rcr, la,
                                         ctu)

        def two(la=la, ctu=ctu):
            return (sao.sao_analyse(oy, ry, la, ctu),
                    sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, la,
                                           ctu // 2))
        d[f"ms{key}"] = time_ms(frame, iters)
        d[f"ms_device{key}"] = time_queued_ms(frame, iters)
        d[f"ms_l2_cold{key}"] = time_cold_ms(frame, iters)
        d[f"ms_two_entries{key}"] = time_ms(two, iters)
        d[f"ms_device_two_entries{key}"] = time_queued_ms(two, iters)
        d[f"plain_ms{key}"] = time_ms(lambda: (
            sao.sao_analyse_plain(oy, ry, la, ctu),
            sao.sao_analyse_chroma_plain(ocb, rcb, ocr, rcr, la, ctu // 2)),
            2)
        d[f"bound_ms{key}"], d[f"bound_by{key}"] = bound_ms(
            nbytes(oy, ry, ocb, rcb, ocr, rcr) + nbytes(la)
            + 2 * la.numel() * 52,
            sao_ops(h * w, 1) + sao_ops(h * w // 4, 2))
    d["library_ms"] = None
    d["library_note"] = "none: no call classifies edges and picks offsets"
    d["shapes_note"] = (
        "ms, ms_device, bound_ms: the frame entry (luma at CTU 32, cb + cr "
        "at 16, one launch); _flat_1080p: a flat CTB16 frame's (CTU 16, "
        "8; 8160 CTUs); _two_entries: the luma and the joint chroma "
        "entries, two launches; ms_device*: enqueued behind a spin of the "
        "card, the kernel's own time; ms_l2_cold*: L2 flushed before each "
        "call")
    rows.append(("sao_analyse", "x265amod_tpu_torch/csrc/sao_analyse.cu",
                 "x265amod_tpu/ops/sao.py:75 sao_analyse (+ :257 "
                 "sao_analyse_chroma)", d))

    # K11 sao_apply: the three planes with their chosen parameters
    d = dict(err=0.0, launches_per_b_frame=3)
    for key, ctu in frames.items():
        ly, lc = sao.sao_analyse_frame(oy, ocb, ocr, ry, rcb, rcr, lam[ctu],
                                       ctu)
        calls = (("y", ry, ly[:4], ctu),
                 ("cb", rcb, lc[:4], ctu // 2),
                 ("cr", rcr, (lc[0], lc[1], lc[4], lc[5]), ctu // 2))
        nbytes_ = 0
        for name, r, par, c in calls:
            d["err"] = max(d["err"], check_equal(
                f"sao_apply {name}", sao.sao_apply(r, *par, c),
                sao.sao_apply_plain(r, *par, c)))
            nbytes_ += 2 * nbytes(r) + nbytes(*par)

        def three(calls=calls):
            return [sao.sao_apply(r, *par, c) for _, r, par, c in calls]
        d[f"ms{key}"] = time_ms(three, iters)
        d[f"ms_device{key}"] = time_queued_ms(three, iters)
        d[f"ms_l2_cold{key}"] = time_cold_ms(three, iters)
        d[f"plain_ms{key}"] = time_ms(lambda: [
            sao.sao_apply_plain(r, *par, c) for _, r, par, c in calls], 2)
        d[f"bound_ms{key}"], d[f"bound_by{key}"] = bound_ms(
            nbytes_, (h * w + h * w // 2) * 12)
    d["library_ms"] = None
    d["library_note"] = "none: per-CTU lookup tables need a gather"
    d["shapes_note"] = (
        "the three planes of a frame, three launches: a config-3 B frame "
        "(CTU 32, 16) and, _flat_1080p, a flat CTB16 frame (CTU 16, 8); "
        "ms_device*: enqueued behind a spin of the card, the kernel's own "
        "time; ms_l2_cold*: L2 flushed before each call")
    rows.append(("sao_apply", "x265amod_tpu_torch/csrc/sao_apply.cu",
                 "x265amod_tpu/ops/sao.py:168 sao_apply", d))
    return rows


def phase_kernels_la(iters, dev="cuda", w=1920, h=1088):
    """K12-K14 and K1 on the lowres blocks at one config-3 frame's
    lookahead shapes (1920x1088 planes, a 960x544 lowres plane, 120x68
    lowres blocks): K12 on the bench picture with flat 0/255 regions and a
    0/255 step; K13 against the previous frame's lowres plane (content
    moving) and on flat planes (every candidate ties: MV (-8, -8)); K14 on
    K13's MVs and on a pile-up of sources clipped onto the border blocks
    with amounts 10^-5 to 10^7 apart, run twice to show it bit-identical;
    K1 (`lowres_intra_cost`) on the lowres plane."""
    import torch
    from x265amod_tpu_torch.models import lookahead as la
    from x265amod_tpu_torch.ops import intra
    dev = torch.device(dev)
    rng = np.random.default_rng(6)
    rows = []
    f0, f1 = synth_frames(w, h, 2, seed=6)
    y, cb, cr = (torch.as_tensor(a, device=dev) for a in f0)
    y[: h // 8, : w // 8] = 0
    y[: h // 8, w // 8: w // 4] = 255                  # a 0/255 step
    cb[-h // 16:, -w // 16:] = 255

    # K12 lowres_aq
    d = dict(err=0.0)
    for strength in (1.0, 0.5):
        got = la.lowres_aq(y, cb, cr, strength)
        want = la.lowres_aq_plain(y, cb, cr, strength)
        d["err"] = max(d["err"], check_equal("lowres_aq lowres", got[0],
                                             want[0]),
                       check_equal("lowres_aq offsets", got[1], want[1]))
    d["ms"] = time_ms(lambda: la.lowres_aq(y, cb, cr), iters)
    d["plain_ms"] = time_ms(lambda: la.lowres_aq_plain(y, cb, cr), 2)
    npix = h * w
    d["bound_ms"], d["bound_by"] = bound_ms(
        nbytes(y, cb, cr) + npix // 4 + 4 * (npix // 256),
        npix * 4 + (npix // 2) * 3)
    d["library_ms"] = None
    d["library_note"] = ("none: no call forms the 8x8 variances, their "
                         "log2 and the frame mean")
    rows.append(("lowres_aq", "x265amod_tpu_torch/csrc/lowres_aq.cu",
                 "x265amod_tpu/models/lookahead.py:64 aq_offsets (+ :39 "
                 "lowres_half)", d))

    # K13 lowres_me
    lr = la.lowres_half(y)
    prev = la.lowres_half(torch.as_tensor(f1[0], device=dev))
    d = dict(err=0.0)
    flat = torch.full_like(lr, 77)
    for a, b in ((lr, prev), (flat, flat)):
        got = la.lowres_inter_cost(a, b)
        want = la.lowres_inter_cost_plain(a, b)
        d["err"] = max(d["err"], check_equal("lowres_me cost", got[0],
                                             want[0]),
                       check_equal("lowres_me mv", got[1], want[1]))
    if not bool((la.lowres_inter_cost(flat, flat)[1] == -8).all()):
        raise AssertionError("lowres_me: a flat plane must give MV (-8, -8)")
    d["ms"] = time_ms(lambda: la.lowres_inter_cost(lr, prev), iters)
    d["plain_ms"] = time_ms(lambda: la.lowres_inter_cost_plain(lr, prev), 2)
    hb, wb = lr.shape[0] // 8, lr.shape[1] // 8
    s_ = 2 * la.LOWRES_ME_RANGE + 1
    d["bound_ms"], d["bound_by"] = bound_ms(
        nbytes(lr, prev) + hb * wb * 12, hb * wb * s_ * s_ * 64 * 3)
    d["library_ms"] = None
    d["library_note"] = ("none: the SSD grid is two grouped convolutions "
                         "and an add, then an argmin; no single call")
    rows.append(("lowres_me", "x265amod_tpu_torch/csrc/lowres_me.cu",
                 "x265amod_tpu/models/lookahead.py:90 lowres_inter_cost",
                 d))

    # K14 cutree_prop, on K13's MVs and on a border pile-up
    icost = la.lowres_intra_cost(lr)
    pcost, pmv = la.lowres_inter_cost(lr, prev)
    prop = torch.as_tensor((rng.random((hb, wb)) * 10.0 ** rng.integers(
        -5, 8, (hb, wb))).astype(np.float32), device=dev)
    pile = pmv.clone()
    pile[:2, :, 1], pile[:, :2, 0], pile[-2:, :, 1] = -8, -8, 8
    d = dict(err=0.0)
    for mv in (pmv, pile):
        args = (prop, icost, pcost, mv)
        got = la.cutree_propagate_step(*args)
        d["err"] = max(d["err"], check_equal(
            "cutree_prop", got, la.cutree_propagate_step_plain(*args)))
        if not torch.equal(got, la.cutree_propagate_step(*args)):
            raise AssertionError("cutree_prop differs from run to run")
    d["deterministic"] = True
    d["ms"] = time_ms(lambda: la.cutree_propagate_step(prop, icost, pcost,
                                                       pmv), iters)
    d["plain_ms"] = time_ms(lambda: la.cutree_propagate_step_plain(
        prop, icost, pcost, pmv), 2)
    # the function's own work: each source's amount and four weighted adds
    d["bound_ms"], d["bound_by"] = bound_ms(
        nbytes(prop, icost, pcost, pmv) + hb * wb * 4, hb * wb * 24)
    d["library_ms"] = None
    d["library_note"] = ("none: index_put_ with accumulate adds in no "
                         "fixed order")
    rows.append(("cutree_prop", "x265amod_tpu_torch/csrc/cutree_prop.cu",
                 "x265amod_tpu/models/lookahead.py:160 "
                 "cutree_propagate_step", d))

    # K1 on the lowres blocks
    d = dict(err=0.0)
    orig, refs = la.lowres_intra_refs(lr)
    d["err"] = check_equal("lowres_intra_cost", la.lowres_intra_cost(lr),
                           intra.satd35_plain(orig, *refs, 8, 0).amin(1)
                           .float().reshape(hb, wb))
    d["ms"] = time_ms(lambda: la.lowres_intra_cost(lr), iters)
    d["plain_ms"] = time_ms(lambda: intra.satd35_plain(orig, *refs, 8, 0)
                            .amin(1), 2)
    d["ms_satd35"] = time_ms(lambda: intra.satd35(orig, *refs, 8, 0),
                             iters)
    nb = hb * wb
    io = nbytes(lr) + nbytes(*refs) + nb * 4
    k1 = k1_ops(nb, 8, 8)
    d["bound_ms"], d["bound_by"] = bound_tc_ms(io, k1[0], f16_flops=k1[1])
    d["bound_ms_int32"], d["bound_by_int32"] = bound_ms(io, k1[2])
    d["library_ms"] = None
    d["library_note"] = "none: no call predicts intra modes"
    rows.append(("intra_pred_lowres", "x265amod_tpu_torch/csrc/intra_pred.cu",
                 "x265amod_tpu/models/lookahead.py:131 lowres_intra_cost "
                 "(+ :56 satd8, ops/intra.py:379 substitute_refs, :133 "
                 "predict_all_modes_batch)", d))
    return rows


def hpel_extremes(ref):
    """Plants in an 8-bit plane (in place) the two 8x8 patches of 0 and 255
    whose (1/2, 1/2) 8-tap value is K8's largest (518) and smallest (-263),
    at the plane's top-right and bottom-left; returns their positions."""
    from x265amod_tpu_torch.ops import me
    import torch
    t = np.outer(me.LUMA_FILTERS[2], me.LUMA_FILTERS[2])
    h, w = ref.shape
    at = {518: (16, w - 24), -263: (h - 24, 16)}
    for v, (y, x) in at.items():
        patch = (t > 0) if v > 0 else (t < 0)
        ref[y - 3:y + 5, x - 3:x + 5] = torch.as_tensor(
            patch.astype(np.int32) * 255, device=ref.device)
    return at


def phase_kernels_k1_k5_1080p(iters, dev="cuda", w=1920, h=1088, sr=16):
    """K1 and K5 where the flat and B paths spend their time, each against
    its plain version bit for bit: K1's predict at the flat intra trial's
    shape (8160 CU16s x 35 modes, frame-border availability, the
    references of a 1080p source); K5 at 1920x1088, sr 16, bn 16 on the
    integer plane (the flat P call) and bn 16 and 32 on the integer and the
    half-pel plane (a config-3 B frame's calls per reference).  The
    reference holds 0 and 255 regions and the two patches whose half-pel
    values are -263 and 518; the grids cover MVs at +-sr on the border
    blocks.  Returns the keys added to the `intra_pred` and `me_ssd`
    rows."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.ops import intra, me
    dev = torch.device(dev)
    rng = np.random.default_rng(12)
    k1, k5 = dict(err=0.0), dict(err=0.0)

    # K1 predict: the flat intra trial (models/inter_frame.py:150-176)
    src = torch.as_tensor(_pad_to_ctu(synth_frames(w, h - 8, 1, seed=22)
                                      [0][0], 16).astype(np.int32),
                          device=dev)
    hc, wc = h // 16, w // 16
    oy = src.reshape(hc, 16, wc, 16).permute(0, 2, 1, 3)
    n = hc * wc
    i = torch.arange(n, device=dev)
    cy, cx = i // wc, i % wc
    cyu, cxl = torch.clamp(cy - 1, min=0), torch.clamp(cx - 1, min=0)
    cxr = torch.clamp(cx + 1, max=wc - 1)
    left0 = oy[cy, cxl, :, 15]

    def bc(flag):
        return flag[:, None].expand(-1, 16)
    refs = [t.contiguous() for t in (
        torch.cat([oy[cyu, cx, 15, :], oy[cyu, cxr, 15, :]], 1),
        torch.cat([left0, left0], 1), oy[cyu, cxl, 15, 15],
        torch.cat([bc(cy > 0), bc((cy > 0) & (cx < wc - 1))], 1),
        torch.cat([bc(cx > 0), bc(cx < 0)], 1), (cx > 0) & (cy > 0))]
    modes = torch.arange(35, dtype=torch.int32, device=dev)[None] \
        .expand(n, 35).contiguous()
    got = intra.predict(*refs, modes, 16, 0)
    k1["err"] = check_equal("predict flat trial", got,
                            intra.predict_plain(*refs, modes, 16, 0))
    del got
    k1["ms_flat_trial_predict"] = time_ms(
        lambda: intra.predict(*refs, modes, 16, 0), iters)
    k1["plain_ms_flat_trial_predict"] = time_ms(
        lambda: intra.predict_plain(*refs, modes, 16, 0), 2)
    io = nbytes(*refs, modes) + n * 35 * 16 * 16 * 4
    ops = k1_ops(n, 16, 8, modes)
    k1["bound_ms_flat_trial_predict"], k1["bound_by_flat_trial_predict"] = \
        bound_tc_ms(io, ops[0])
    k1["bound_ms_int32_flat_trial_predict"] = bound_ms(io, ops[2])[0]
    torch.cuda.empty_cache()

    # K5 at 1920x1088, sr 16
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    ref = torch.as_tensor(np.clip(
        128 + 80 * np.sin(xx / 11.0) * np.cos(yy / 7.0)
        + rng.normal(0, 4, (h, w)), 0, 255).astype(np.int32), device=dev)
    ref[:64, :64] = 0
    ref[-64:, -64:] = 255
    at = hpel_extremes(ref)
    cur = torch.clamp(torch.roll(ref, (3, -5), (0, 1)) + torch.as_tensor(
        rng.integers(-6, 7, (h, w)).astype(np.int32), device=dev), 0, 255)
    hp = me.hpel_plane(ref)
    for v, (y, x) in at.items():
        if int(hp[y, x]) != v:
            raise AssertionError(f"half-pel plane: {int(hp[y, x])} at "
                                 f"{(y, x)}, expected {v}")
    k5["hpel_range"] = [int(hp.min()), int(hp.max())]
    for bn, plane, key in ((16, ref, "bn16_int"), (16, hp, "bn16_hpel"),
                           (32, ref, "bn32_int"), (32, hp, "bn32_hpel")):
        cb = cur.reshape(h // bn, bn, w // bn, bn).permute(0, 2, 1, 3) \
            .reshape(-1, bn, bn).contiguous()
        nb = cb.shape[0]
        k5["err"] = max(k5["err"], check_equal(
            f"me_ssd_grid 1080p sr {sr} {key}",
            me.me_ssd_grid(cb, plane, sr, bn),
            me.me_ssd_grid_plain(cb, plane, sr, bn)))
        k5[f"ms_1080p_sr16_{key}"] = time_ms(
            lambda: me.me_ssd_grid(cb, plane, sr, bn), iters)
        k5[f"plain_ms_1080p_sr16_{key}"] = time_ms(
            lambda: me.me_ssd_grid_plain(cb, plane, sr, bn), 2)
        s = 2 * sr + 1
        io = nbytes(cb, plane) + nb * s * s * 4
        split = k5_split_blocks(plane, bn, sr)
        k5[f"split_blocks_1080p_sr16_{key}"] = split
        ops = k5_ops(nb, bn, sr, split)
        k5[f"bound_ms_1080p_sr16_{key}"], k5[f"bound_by_1080p_sr16_{key}"] \
            = bound_tc_ms(io, ops[0], int8_ops=ops[1])
        k5[f"bound_ms_int32_1080p_sr16_{key}"] = bound_ms(io, ops[2])[0]
    return {"intra_pred": k1, "me_ssd": k5}


def config3(w=1920, h=1080, aq=False, rdoq=0):
    """BASELINE config 3 as the repository's bench.py builds it
    (`bench.py:114`, aq=True), or with AQ and CU-tree off so that no
    lookahead runs; ``rdoq`` sets the RDOQ level.  Its crf is not read:
    rc_mode stays "cqp", so frames code at QP 32 (I 29, referenced B 33, b
    34) plus the AQ and CU-tree offsets."""
    from x265amod_tpu_torch.utils.params import Param
    return Param(width=w, height=h, keyint=60, bframes=3, ctu_size=32,
                 sao=True, aq_mode=2 if aq else 0, cutree=aq,
                 rc_lookahead=4, rdoq_level=rdoq)


def phase_config3(frames, warm):
    """The config-3 slice through `encode_push` and `flush`; the clock and
    the launch counts start after the warm-up frames (the IDR and the first
    mini-GOP).  Launches per B frame are read around each B frame's
    dispatch, where all of its kernels launch."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config3(), device="cuda")
    per_b, sao_on, sao_n = [], [], [0, 0]
    inner = enc.b_encoder.encode_async

    def counted(*a, **k):
        before = dict(cuda_lib.LAUNCHES)
        out = inner(*a, **k)
        per_b.append({n: cuda_lib.LAUNCHES[n] - before[n] for n in before})
        return out
    enc.b_encoder.encode_async = counted
    for tree in (enc.frame_encoder, enc.inter_encoder, enc.b_encoder):
        def wrap(tree=tree, inner=tree.collect):
            def collect(*a, **k):
                r = inner(*a, **k)
                sao_n[0] += int((np.asarray(r.sao[0]) != 0).sum())
                sao_n[1] += int(np.asarray(r.sao[0]).size)
                return r
            tree.collect = collect
        wrap()
    n_done, t0 = 0, None
    for i, fr in enumerate(frames):
        outs = enc.encode_push(*fr)
        if i == warm - 1:
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            per_b.clear()
            t0 = time.time()
        elif i >= warm:
            n_done += len(outs)
    n_done += len(enc.flush())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s = enc.summary()
    types = [st.slice_type for st in enc.frame_stats]
    n = len(frames) - warm
    if n_done != n or types != ["I", "P", "B", "B", "B"]:
        raise AssertionError(f"config 3: {n_done} of {n} frames, types "
                             f"{types}")
    for k in ("psnr_y", "bitrate_kbps"):
        if not np.isfinite(s[k]):
            raise AssertionError(f"config 3: {k} not finite")
    if not 30.0 < s["psnr_y"] < 60.0:
        raise AssertionError(f"config 3: PSNR-Y {s['psnr_y']} out of range")
    missing = [k for k, v in launches.items() if v <= 0 and
               k not in LOOKAHEAD_KERNELS + RDOQ_KERNELS + LADDER_KERNELS
               + MULTIREF_KERNELS + FLAT_KERNELS]
    if missing:
        raise AssertionError(f"config 3 did not launch {missing}")
    if sao_n[0] == 0:
        raise AssertionError("config 3: SAO is off on every CTU")
    timed = enc.frame_stats[warm:]
    b_mean = {k: float(np.mean([b[k] for b in per_b])) for k in launches}
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=s["psnr_y"],
                kbps=s["bitrate_kbps"], ssim_y=s["ssim_y"],
                timed_psnr_y=float(np.mean([x.psnr_y for x in timed])),
                timed_kbps=float(sum(x.bits for x in timed) * 25.0 / n
                                 / 1000.0),
                qps=[x.qp for x in enc.frame_stats],
                sao_luma_on_share=sao_n[0] / max(sao_n[1], 1),
                launches_per_b_frame=b_mean), launches


def phase_config3_aq(frames, rdoq=0):
    """Config 3 exactly as bench.py builds it (AQ mode 2, CU-tree,
    rc-lookahead 4), with RDOQ at level ``rdoq``, through `encode_push` and
    `flush`, every frame timed (the kernels are loaded and the card warm
    from the phases before).  The launch counts start at 0 before the first
    push and are read after the flush; the QP maps are the ones each frame
    signals."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.models.intra_tree import qp32_of
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config3(aq=True, rdoq=rdoq), device="cuda")
    qp_maps, cuts = [], []
    inner_dispatch, inner_la = enc._dispatch_entry, enc._la_frame

    def dispatch(e, *a, **k):
        pending = inner_dispatch(e, *a, **k)
        qp_maps.append((pending["qp"], e["qp_map"]))
        return pending

    def la_frame(fa):
        cuts.append(bool(fa.is_scenecut))
        return inner_la(fa)
    enc._dispatch_entry, enc._la_frame = dispatch, la_frame
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    n_done = sum(len(enc.encode_push(*fr)) for fr in frames)
    n_done += len(enc.flush())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s = enc.summary()
    n = len(frames)
    types = [st.slice_type for st in enc.frame_stats]
    if n_done != n or types != ["I"] + ["P", "B", "B", "B"] * 2:
        raise AssertionError(f"config 3 with AQ: {n_done} of {n} frames, "
                             f"types {types}")
    for k in ("psnr_y", "bitrate_kbps"):
        if not np.isfinite(s[k]):
            raise AssertionError(f"config 3 with AQ: {k} not finite")
    if not 30.0 < s["psnr_y"] < 60.0:
        raise AssertionError(f"config 3 with AQ: PSNR-Y {s['psnr_y']} out "
                             "of range")
    missing = [k for k, v in launches.items() if v <= 0 and
               k not in LADDER_KERNELS + MULTIREF_KERNELS + FLAT_KERNELS
               and (rdoq or k not in RDOQ_KERNELS)]
    if missing:
        raise AssertionError(f"config 3 with AQ did not launch {missing}")
    deltas = np.concatenate([(qp32_of(m) - qp).ravel() for qp, m in qp_maps])
    off_share = float(np.mean(deltas != 0))
    if off_share <= 0.0:
        raise AssertionError("config 3 with AQ: every CTU at the slice QP")
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=s["psnr_y"],
                kbps=s["bitrate_kbps"], ssim_y=s["ssim_y"],
                qps=[x.qp for x in enc.frame_stats],
                ctu_qp_off_slice_share=off_share,
                ctu_qp_delta_range=[int(deltas.min()), int(deltas.max())],
                scene_cuts=[i for i, c in enumerate(cuts) if c],
                bits=int(sum(x.bits for x in enc.frame_stats)),
                launches_per_frame={k: launches[k] / n for k in
                                    LOOKAHEAD_KERNELS + RDOQ_KERNELS}), \
        launches


def phase_card_vs_cpu_b(frames, aq=False, rdoq=0, w=640, h=360):
    """Config 3 at w x h, IDR + one mini-GOP, on the card and on the CPU
    (the slice without the lookahead, or with AQ and CU-tree, with or
    without RDOQ): the streams must be identical."""
    from x265amod_tpu_torch.models.encoder import Encoder
    streams = {}
    for dev in ("cuda", "cpu"):
        p = config3(w, h, aq=aq, rdoq=rdoq)
        p.info = False
        e = Encoder(p, device=dev)
        streams[dev] = [o.nals for o in e.encode_pipelined(frames)]
    same = streams["cuda"] == streams["cpu"]
    if not same:
        bad = [i for i, (a, b) in enumerate(zip(streams["cuda"],
                                                streams["cpu"])) if a != b]
        raise AssertionError(f"config 3 at {w}x{h}: card and CPU streams "
                             f"differ in frames {bad} (decode order)")
    return dict(bitstreams_identical=True, frames=len(frames),
                bytes=sum(len(x) for x in streams["cuda"]))


def config_main10(w=1920, h=1080):
    """Main10 all-intra as far as the reference reaches (BASELINE config 4's
    resolution and bit depth): QP 30, CTU32, keyint 1, deblocking and SAO
    off (the reference's gate), no RDOQ."""
    from x265amod_tpu_torch.utils.params import Param
    return Param(width=w, height=h, qp=30, keyint=1, ctu_size=32,
                 internal_bit_depth=10, deblock=False, sao=False)


def sps_profile_idc(headers: bytes) -> int:
    """general_profile_idc of the SPS in an Annex-B header blob: the low 5
    bits of the byte after sps_video_parameter_set_id, max_sub_layers and
    the nesting flag (the SPS payload's first byte)."""
    nals = headers.split(b"\x00\x00\x01")
    for nal in nals:
        if len(nal) > 3 and (nal[0] >> 1) & 63 == 33:
            return nal[3] & 31
    raise AssertionError("no SPS in the headers")


def phase_main10(frames, warm):
    """Main10 all-intra at 1920x1080 through `encode_pipelined` (16-frame
    batches); the clock and the launch counts start after the warm-up
    batch.  Then one frame with its recon, which must use the 10-bit
    range, and the SPS, which must carry profile 2 and bit depth 10."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config_main10(), device="cuda")
    for _ in enc.encode_pipelined(frames[:warm]):
        pass
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    n_warm_stats = len(enc.frame_stats)
    t0 = time.time()
    outs = list(enc.encode_pipelined(frames[warm:]))
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    n = len(frames) - warm
    timed = enc.frame_stats[n_warm_stats:]
    if len(outs) != n or not all(o.nals for o in outs):
        raise AssertionError("Main10: missing encoded frames")
    psnr = float(np.mean([x.psnr_y for x in timed]))
    kbps = float(sum(x.bits for x in timed) * 25.0 / n / 1000.0)
    if not (np.isfinite(psnr) and np.isfinite(kbps) and 30.0 < psnr < 70.0):
        raise AssertionError(f"Main10: PSNR-Y {psnr}, kbps {kbps}")
    missing = [k for k in ("intra_pred", "residual_chain", "tu_bits",
                           "commit_intra")
               if launches[k] <= 0]
    unexpected = [k for k in ("deblock", "sao_analyse", "sao_apply",
                              "residual_chain_rdoq") if launches[k] > 0]
    if missing or unexpected:
        raise AssertionError(f"Main10: launched none of {missing}, "
                             f"launched {unexpected}")
    one = Encoder(config_main10(), device="cuda")
    rec = one.encode_frame(*frames[0], return_recon=True).recon
    rmax = int(rec[0].max())
    if rec[0].dtype != np.uint16 or rmax <= 255:
        raise AssertionError(f"Main10 recon: dtype {rec[0].dtype}, max "
                             f"{rmax}")
    profile = sps_profile_idc(enc.headers())
    if profile != 2 or enc.sps.bit_depth != 10:
        raise AssertionError(f"Main10 SPS: profile {profile}, bit depth "
                             f"{enc.sps.bit_depth}")
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=psnr, kbps=kbps,
                batches=-(-n // enc.BATCH_FRAMES), recon_max=rmax,
                sps_profile_idc=profile, sps_bit_depth=enc.sps.bit_depth,
                launches_per_batch={k: launches[k] / -(-n // enc.BATCH_FRAMES)
                                    for k in ("intra_pred", "residual_chain",
                                              "tu_bits")}), launches


def phase_card_vs_cpu_main10(frames):
    """Main10 all-intra at 640x360, 2 frames, on the card and on the CPU:
    the streams and the recon must be identical."""
    from x265amod_tpu_torch.models.encoder import Encoder
    out = {}
    for dev in ("cuda", "cpu"):
        p = config_main10(640, 360)
        p.info = False
        e = Encoder(p, device=dev)
        res = [e.encode_frame(*f, return_recon=True) for f in frames]
        out[dev] = ([r.nals for r in res], [r.recon for r in res])
    if out["cuda"][0] != out["cpu"][0]:
        raise AssertionError("Main10 at 640x360: card and CPU streams "
                             "differ")
    for a, b in zip(out["cuda"][1], out["cpu"][1]):
        for pa, pb in zip(a, b):
            if not np.array_equal(pa, pb):
                raise AssertionError("Main10 at 640x360: recon differs")
    return dict(bitstreams_identical=True, recon_identical=True,
                frames=len(frames), bytes=sum(len(x) for x in out["cuda"][0]))


# ---- this slice: level pack (K15), resampler (K16), ABR ladder, VBV --------

def phase_kernels_pack(iters, dev="cuda"):
    """K15 against its plain version at one config-1 batch (16 x 640x384,
    cap T/16), one config-2 P frame (1280x736) and one config-3 B frame
    (1920x1088; cap T/8), each on levels of the density the encode gives,
    plus an overflow (a cap below nnz) and int16 extremes; then the packed
    D2H (K15, its outputs to pinned memory, the host unpack) against the
    dense D2H (the int16 levels to pinned memory) per config-1 batch and
    per B frame.  Returns (rows, D2H timings)."""
    import torch
    from x265amod_tpu_torch.ops import pack
    dev = torch.device(dev)
    rng = np.random.default_rng(15)

    def levels(f, h16, w16, density):
        out = []
        for n in (16, 8, 8):
            v = rng.integers(-60, 61, (f, h16, w16, n, n))
            v[rng.random(v.shape) >= density] = 0
            out.append(torch.as_tensor(v.astype(np.int16), device=dev))
        return out
    d = dict(ms=0.0, plain_ms=0.0, bytes=0, ops=0, err=0.0)
    d2h = {}
    cases = (("config1_batch", 16, 24, 40, 16, 0.02),
             ("config2_p_frame", 1, 46, 80, 8, 0.03),
             ("config3_b_frame", 1, 68, 120, 8, 0.01))
    for name, f, h16, w16, frac, density in cases:
        lv = levels(f, h16, w16, density)
        total = h16 * w16 * 384
        cap = pack.pack_cap(total, frac)
        edge = [t.clone() for t in lv]
        edge[0][0, 0, 0, 0, :4] = torch.tensor([-32768, 32767, -1, 1],
                                               dtype=torch.int16)
        for c, src in ((cap, lv), (128, lv), (cap, edge)):
            got = pack.pack_levels(src, c)
            want = pack.pack_levels_plain(src, c)
            for part, g, w_ in zip(("bitmap", "vals", "nnz", "fits"), got,
                                   want):
                d["err"] = max(d["err"], check_equal(
                    f"pack_levels {name} cap {c} {part}", g, w_))
            if c == 128 and bool(got[3].any()):
                raise AssertionError("pack_levels: the overflow case fits")
        nnz = pack.pack_levels_plain(lv, cap)[2]
        if name in ("config1_batch", "config3_b_frame"):
            d["ms_" + name] = time_ms(lambda: pack.pack_levels(lv, cap),
                                      iters)
            d["plain_ms_" + name] = time_ms(
                lambda: pack.pack_levels_plain(lv, cap), 2)
            if name == "config3_b_frame":
                d["ms"], d["plain_ms"] = d["ms_" + name], \
                    d["plain_ms_" + name]
            io = 2 * f * total + f * total // 8 \
                + 2 * int(torch.clamp(nnz, max=cap).sum()) + 5 * f
            d["bytes_" + name] = io
            d["bound_ms_" + name] = bound_ms(io, 0)[0]
            if name == "config3_b_frame":
                d["bytes"] = io
            d2h[name] = d2h_times(lv, frac, iters)
    d["bound_ms"], d["bound_by"] = bound_ms(d["bytes"], 0)
    d["library_note"] = ("none: no single call packs a bitmap and compacts "
                         "values")
    return [("pack_levels", "x265amod_tpu_torch/csrc/pack_levels.cu",
             "x265amod_tpu/ops/pack.py:108 pack_levels", d)], d2h


def d2h_times(lv, frac, iters):
    """Host ms of the levels' trip to the host, packed (K15, the four
    outputs to pinned memory, an event wait, `unpack_levels` per frame)
    against dense (the three int16 tensors to pinned memory, the wait, the
    int32 copy that `collect` made of them)."""
    import torch
    from x265amod_tpu_torch.ops import pack

    def dense():
        host = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                for t in lv]
        for h_, t in zip(host, lv):
            h_.copy_(t, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        return [h_.numpy().astype(np.int32) for h_ in host]

    def packed():
        out = pack.levels_for_host(lv, frac)
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                for k, v in out.items()}
        for k, v in out.items():
            host[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream().synchronize()
        h_ = {k: v.numpy() for k, v in host.items()}
        return [pack.levels_from_host(h_, i, lv)
                for i in range(lv[0].shape[0])]
    for i, fr in enumerate(packed()):
        for a, t in zip(fr, lv):
            if not np.array_equal(a, t[i].cpu().numpy()):
                raise AssertionError("packed D2H: levels differ")
    res = {}
    for name, fn in (("dense", dense), ("packed", packed),
                     ("dense_again", dense), ("packed_again", packed)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        res[name + "_ms"] = (time.perf_counter() - t0) * 1e3 / iters
    return res


def phase_kernels_resample(iters, dev="cuda"):
    """K16 against its plain version (the unrounded f32 values and the
    uint8 output, max abs error 0) at 1920x1080 -> 1280x720 and -> 640x360,
    luma and chroma, bicubic and bilinear, and one upscale (640x360 ->
    1280x720) on the bench picture with 0/255 regions; timed per scaled
    frame (Y, Cb, Cr: six launches) at 1080p -> 720p bicubic, beside the
    plain version and `torch.matmul(torch.matmul(V, P), H.T)` (TF32 off)
    on the same planes."""
    import torch
    from x265amod_tpu_torch.ops import scaler
    dev = torch.device(dev)
    y, cb, cr = (torch.as_tensor(a, device=dev)
                 for a in synth_frames(1920, 1080, 1, seed=16)[0])
    y[:64, :64] = 0
    y[:64, 64:128] = 255
    d = dict(err=0.0)
    cases = []
    for dw, dh in ((1280, 720), (640, 360)):
        for m in ("bicubic", "bilinear"):
            cases += [(y, dw, dh, m), (cb, dw // 2, dh // 2, m)]
    small = scaler.resample_plane(y, 640, 360)
    cases += [(small, 1280, 720, "bicubic"), (small, 1280, 720, "bilinear")]
    for p, dw, dh, m in cases:
        for raw in (True, False):
            d["err"] = max(d["err"], check_equal(
                f"resample {tuple(p.shape)}->{dh}x{dw} {m} raw={raw}",
                scaler.resample_plane(p, dw, dh, m, unrounded=raw),
                scaler.resample_plane_plain(p, dw, dh, m, unrounded=raw)))
    frame = (y, cb, cr)
    d["ms"] = time_ms(lambda: scaler.resample_frame(frame, 1280, 720), iters)
    d["plain_ms"] = time_ms(
        lambda: [scaler.resample_plane_plain(p, w_, h_) for p, w_, h_ in
                 ((y, 1280, 720), (cb, 640, 360), (cr, 640, 360))], 2)
    mats = []
    for p, w_, h_ in ((y, 1280, 720), (cb, 640, 360), (cr, 640, 360)):
        v = torch.as_tensor(scaler._resample_matrix(p.shape[0], h_),
                            device=dev)
        hm = torch.as_tensor(scaler._resample_matrix(p.shape[1], w_),
                             device=dev)
        mats.append((v, p.to(torch.float32), hm))
    d["library_ms"] = time_ms(
        lambda: [torch.matmul(torch.matmul(v, pf), hm.T)
                 for v, pf, hm in mats], iters)
    d["library_note"] = ("torch.matmul(torch.matmul(V, P), H.T) per plane, "
                         "f32 with TF32 off (dense operators)")
    taps, flops = 0, 0
    for p, w_, h_ in ((y, 1280, 720), (cb, 640, 360), (cr, 640, 360)):
        nv = scaler._band_np(p.shape[0], h_, "bicubic")[1].shape[1]
        nh = scaler._band_np(p.shape[1], w_, "bicubic")[1].shape[1]
        flops += 2 * (h_ * p.shape[1] * nv + h_ * w_ * nh)
        taps = max(taps, nv, nh)
    io = sum(p.numel() for p in frame) + 1280 * 720 * 3 // 2
    d["bound_ms"], d["bound_by"] = bound_f32_ms(io, flops)
    d["bytes"], d["flops"], d["max_taps"] = io, flops, taps
    return [("resample", "x265amod_tpu_torch/csrc/resample.cu",
             "x265amod_tpu/ops/scaler.py:74 resample_plane", d)]


# phase 14: the ABR ladder, after the HEVC rows of Apple's HLS Authoring
# Specification (1080p at 5800 kb/s, 720p at 2400, 360p at 145), each rung
# at preset medium with CTU32
LADDER = (("1080p", 1920, 1080, 5800), ("720p", 1280, 720, 2400),
          ("360p", 640, 360, 145))
LADDER_FRAMES = 11
LADDER_KERNELS = ("resample",)
# phase 15: config 2 under VBV with its HRD signalling
VBV_FRAMES = 24


def write_y4m(path, frames, w, h):
    from x265amod_tpu_torch.io.y4m import Y4mHeader, Y4mWriter
    with open(path, "wb") as f:
        wr = Y4mWriter(f, Y4mHeader(w, h, 25, 1))
        for fr in frames:
            wr.write_frame(*fr)


def run_ladder(tmp, frames, w, h, rungs, device):
    """The port's ladder app (`abr.run`, `abr.main` without its report) on
    the frames written to a y4m under ``tmp``: preset medium, each rung
    ABR at its bitrate with CTU32, info SEI off."""
    import os
    from x265amod_tpu_torch import abr
    src = os.path.join(tmp, f"in_{w}x{h}.y4m")
    write_y4m(src, frames, w, h)
    cfg = os.path.join(tmp, f"ladder_{w}x{h}.txt")
    with open(cfg, "w") as f:
        for name, rw, rh, kbps in rungs:
            f.write(f"{name}:{rw}x{rh}:{kbps}:ctu=32 no-info\n")
    return abr.run([src, "--ladder", cfg, "--output-prefix",
                    os.path.join(tmp, f"out_{device}_{w}x{h}"),
                    "--preset", "medium", "--device", device])


def phase_ladder(tmp):
    """Phase 14: the ladder at full width, launch counts from 0 before the
    run and read after it."""
    import torch
    from x265amod_tpu_torch.ops import cuda_lib
    frames = synth_frames(1920, 1080, LADDER_FRAMES, seed=14)
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    rungs, n_in, dt = run_ladder(tmp, frames, 1920, 1080, LADDER, "cuda")
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    out = dict(input_frames=n_in, rungs=len(rungs), seconds=dt,
               enc_fps=n_in * len(rungs) / dt, per_rung={})
    for r in rungs:
        s = r.encoder.summary()
        out["per_rung"][r.name] = dict(
            size=f"{r.width}x{r.height}", frames=r.frames,
            kbps=s["bitrate_kbps"], target_kbps=r.bitrate,
            kbps_over_target=s["bitrate_kbps"] / r.bitrate,
            psnr_y=s["psnr_y"], bytes=r.bytes_out,
            qps=[x.qp for x in r.encoder.frame_stats],
            types="".join(x.slice_type for x in r.encoder.frame_stats))
        if r.frames != n_in or not (np.isfinite(s["psnr_y"])
                                     and 20.0 < s["psnr_y"] < 70.0):
            raise AssertionError(f"ladder rung {r.name}: {r.frames} frames, "
                                 f"PSNR-Y {s['psnr_y']}")
    missing = [k for k, v in launches.items() if v <= 0
               and k not in RDOQ_KERNELS + MULTIREF_KERNELS + FLAT_KERNELS]
    if missing:
        raise AssertionError(f"the ladder did not launch {missing}")
    out["launches_pack_levels"] = launches["pack_levels"]
    out["launches_resample"] = launches["resample"]
    return out, launches


def config_vbv(w=1280, h=720):
    """Config 2 (1280x720 low-delay P, superfast) under ABR at 1500 kb/s
    with a VBV of 1500 kb/s and 1500 kb and its HRD signalling (AQ through
    the depth-1 lookahead)."""
    p = config2(w, h)
    p.aq_mode, p.cutree = 2, True
    p.rc_mode, p.bitrate = "abr", 1500
    p.vbv_maxrate = p.vbv_bufsize = 1500
    p.hrd = True
    return p


def sei_counts(stream: bytes) -> dict:
    """Buffering-period and pic-timing messages in an Annex-B stream."""
    counts = {0: 0, 1: 0}
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
            if t in counts:
                counts[t] += 1
            i += s
    return dict(buffering_period=counts[0], pic_timing=counts[1])


def phase_vbv(frames):
    """Phase 15: config 2 under VBV + HRD through `encode_pipelined`."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config_vbv(), device="cuda")
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(enc.encode_pipelined(frames))
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s, rc = enc.summary(), enc.rc
    stream = b"".join(o.nals for o in outs)
    sei = sei_counts(stream)
    n = len(frames)
    if len(outs) != n or sei != dict(buffering_period=1, pic_timing=n):
        raise AssertionError(f"VBV: {len(outs)} of {n} frames, SEI {sei}")
    if not (np.isfinite(s["psnr_y"]) and 20.0 < s["psnr_y"] < 70.0):
        raise AssertionError(f"VBV: PSNR-Y {s['psnr_y']}")
    missing = [k for k, v in launches.items() if v <= 0 and k not in
               CONFIG3_KERNELS + LADDER_KERNELS + RDOQ_KERNELS
               + MULTIREF_KERNELS + FLAT_KERNELS + ("cutree_prop",)]
    if missing:
        raise AssertionError(f"VBV did not launch {missing}")
    return dict(frames=n, seconds=dt, fps=n / dt, kbps=s["bitrate_kbps"],
                target_kbps=1500, psnr_y=s["psnr_y"],
                qps=[x.qp for x in enc.frame_stats],
                min_fill_preclamp=rc.min_fill_preclamp,
                buffer_rate=rc.buffer_rate, buffer_size=rc.buffer_size,
                underflow_events=rc.underflow_events,
                final_fill=rc.buffer_fill, **sei), launches


def phase_card_vs_cpu_rc(tmp, frames):
    """Phase 16: the ladder (rungs scaled to 320x192, 160x96 and 96x64, the
    same bitrate per pixel) and the VBV config at 320x192, on the card and
    on the CPU: every stream identical byte for byte."""
    from x265amod_tpu_torch.models.encoder import Encoder
    rungs = (("a", 320, 192, 5800 * 320 * 192 // (1920 * 1080)),
             ("b", 160, 96, 2400 * 160 * 96 // (1280 * 720)),
             ("c", 96, 64, 145 * 96 * 64 // (640 * 360) + 10))
    out = {}
    streams = {}
    for dev in ("cuda", "cpu"):
        got = run_ladder(tmp, frames, 320, 192, rungs, dev)[0]
        streams[dev] = [open(r.out.name, "rb").read() for r in got]
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("ladder at 320x192: card and CPU differ")
    out["ladder"] = dict(bitstreams_identical=True, rungs=len(rungs),
                         bytes=[len(x) for x in streams["cuda"]])
    vbv = {}
    for dev in ("cuda", "cpu"):
        e = Encoder(config_vbv(320, 192), device=dev)
        vbv[dev] = [o.nals for o in e.encode_pipelined(frames)]
    if vbv["cuda"] != vbv["cpu"]:
        raise AssertionError("VBV at 320x192: card and CPU differ")
    out["vbv"] = dict(bitstreams_identical=True, frames=len(frames),
                      bytes=sum(len(x) for x in vbv["cuda"]))
    return out


# ---- this slice: multi-reference P, the P decide scan (K17), pick_ref (K18) -

# phase 17: config 2 at x265's default --ref 3 on phase 5's frames
MULTIREF = 3
# launched only with several references (phase 17, 18)
MULTIREF_KERNELS = ("pick_ref",)
# phase 18: card against CPU at --ref 4 on a period-2 flicker clip
FLICKER_REF, FLICKER_FRAMES = 4, 8


def check_exact(name, got, want):
    """Bit equality (dtype, shape and values; +inf equals +inf, as the CU32
    cost rows hold it in the intra column).  Returns the max abs error, 0."""
    import torch
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.equal(got, want):
        raise AssertionError(f"{name}: differs from the plain version")
    return 0.0


def flicker_frames(w, h, n, period=2, seed=5):
    """The flicker clip of the repository's multi-reference tests (a copy):
    two alternating patterns plus noise, so frame t is predicted far better
    from t - 2 than from t - 1."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    bases = [128 + 70 * np.sin(xx / 7.0) * np.cos(yy / 9.0),
             128 + 70 * np.cos(xx / 5.0) * np.sin(yy / 11.0)]
    out = []
    for t in range(n):
        y = (bases[t % period] + rng.normal(0, 2, (h, w))).clip(
            0, 255).astype(np.uint8)
        out.append((y, np.full((h // 2, w // 2), 120, np.uint8),
                    np.full((h // 2, w // 2), 130, np.uint8)))
    return out


def config2_ref(ref, w=1280, h=720):
    p = config2(w, h)
    p.ref = ref
    return p


def time_once_ms(fn):
    """One call timed with CUDA events (for the plain scan, a few hundred
    host-launched ops a diagonal), after one warm-up call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1)


def decide_bytes(tree, nr, forced):
    """Bytes the decide scan must move for one frame: its per-CU inputs
    (free: d, rb, lambda, intra cost, MV and reference of every 16-cell and
    CTU, two SSD-grid lookups per CU decision, the dsf and bin tables;
    forced: the choice, MVD, MVP index and reference per CU and the split)
    read once, its outputs (decisions, MVs, references; the cost rows when
    free) written once.  Its arithmetic is a few hundred operations a CU,
    far below the bytes."""
    n16, n32 = tree.h16 * tree.w16, tree.hc * tree.wc
    if forced:
        inp = (n16 + n32) * 20 + n32 * 4
    else:
        inp = n16 * 28 + n32 * 24 + (n16 + n32) * 2 * 4 + nr * nr * 8
    out = n32 * 24 + n16 * 32 + (0 if forced else n16 * 16 + n32 * 24)
    return inp + out


def check_decide(tree, st1, maps, tables, label):
    """K17 free (decisions, MVs, references and cost rows) and forced (the
    plain scan's decisions replayed) against the plain scan on the card,
    bit for bit.  Returns (max abs error, the forced inputs, the per-cell
    decisions)."""
    import torch
    err = 0.0
    got = tree._decide_kernel(st1, maps, tables, want_costs=True)
    want = tree._decide_plain(st1, maps, tables, want_costs=True)
    for k in want:
        err = max(err, check_exact(f"decide_p {label} {k}", got[k], want[k]))
    cells = tree._cell_decisions(want)
    kinds = cells["kinds"]
    forced = dict(c16=(torch.where(kinds == 0, cells["merge"],
                                   torch.where(kinds == 1, 2, 3)),
                       cells["mvd"], cells["mvp"], cells["ref"]),
                  split=want["split"].reshape(-1))
    forced["c32"] = [v[tree._q0_cell] for v in forced["c16"]]
    fk = tree._decide_kernel(None, maps, tables, forced=forced)
    fp = tree._decide_plain(None, maps, tables, forced=forced)
    for k in fp:
        err = max(err, check_exact(f"decide_p forced {label} {k}", fk[k],
                                   fp[k]))
    for k in ("split", "mv", "ref"):
        check_exact(f"decide_p forced {label} replays {k}", fk[k], want[k])
    return err, forced, cells


def phase_kernels_decide_1080p(iters, dev="cuda"):
    """K17 at config 3's P-anchor shapes: the first P anchor of the bench
    clip at 1920x1080 (padded 1920x1088; phases 7 and 9's frames) against
    the card's recon of its IDR, R = 1, at the P tree's search range,
    free and forced against the plain scan, and timed."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder, _pad_to_ctu
    enc = Encoder(config3(), device=torch.device(dev))
    frames = synth_frames(1920, 1080, enc.bframes + 2, seed=4)
    enc.encode_push(*frames[0])
    tree = enc.inter_encoder
    poc = enc.bframes + 1
    y = torch.as_tensor(_pad_to_ctu(frames[poc][0], 32), device=dev) \
        .to(torch.int32)
    refs, tables = tree._ref_list([enc._dpb[0]], [0], poc)
    maps = tree._maps(32)
    st1 = tree._phase1(y, refs[0], maps, tables)
    err, _, _ = check_decide(tree, st1, maps, tables, "1080p R=1")
    return dict(err=err, width=tree.width, height=tree.height, sr=tree.sr,
                rows=tree.hc, steps=tree.wc + 2 * (tree.hc - 1),
                ms=time_ms(lambda: tree._decide_kernel(st1, maps, tables),
                           iters),
                bound_ms=bound_ms(decide_bytes(tree, 1, False), 0)[0])


def decide_b_bytes(tree, forced):
    """Bytes the B decide scan must move for one frame, counted as K17's:
    its per-CU inputs (free: d and rb of L0, L1 and bi, both ME MVs,
    lambda, and the intra cost of every 16-cell; two SSD-grid entries per
    list and CU decision for the merge candidates; forced: the choice,
    both MVDs and MVP indices per CU and the split) read once, its outputs
    (decisions, directions and MVs; the cost rows when free) written once.
    Its arithmetic is a few hundred operations a CU, far below the
    bytes."""
    n16, n32 = tree.h16 * tree.w16, tree.hc * tree.wc
    if forced:
        inp = (n16 + n32) * 28 + n32 * 4
    else:
        inp = n16 * 48 + n32 * 44 + (n16 + n32) * 2 * 2 * 4
    out = n32 * 32 + n16 * 44 + (0 if forced else n16 * 24 + n32 * 32)
    return inp + out


def check_decide_b(tree, st1, maps, dsf, label):
    """K19 free (decisions, directions, MVs and cost rows) and forced (the
    plain scan's decisions replayed) against the plain B scan on the card,
    bit for bit.  Returns (max abs error, the forced inputs)."""
    import torch
    err = 0.0
    got = tree._decide_b_kernel(st1, maps, dsf, want_costs=True)
    want = tree._decide_b_plain(st1, maps, dsf, want_costs=True)
    if got.keys() != want.keys():
        raise AssertionError(f"decide_b {label}: outputs {sorted(got)} != "
                             f"{sorted(want)}")
    for k in want:
        err = max(err, check_exact(f"decide_b {label} {k}", got[k], want[k]))
    cells = tree._cell_decisions_b(want)
    kinds = cells["kinds"]
    choice = torch.where(kinds == 0, cells["merge"], torch.where(
        kinds == 1, 1 + cells["dir"].long(), 5))
    c16 = (choice, cells["mvd0"], cells["mvp0"], cells["mvd1"],
           cells["mvp1"])
    forced = dict(c16=c16, c32=[v[tree._q0_cell] for v in c16],
                  split=want["split"].reshape(-1))
    fk = tree._decide_b_kernel(None, maps, dsf, forced=forced)
    fp = tree._decide_b_plain(None, maps, dsf, forced=forced)
    for k in fp:
        err = max(err, check_exact(f"decide_b forced {label} {k}", fk[k],
                                   fp[k]))
    for k in ("split", "dir", "mv0", "mv1"):
        check_exact(f"decide_b forced {label} replays {k}", fk[k], want[k])
    return err, forced


def flat_patch(frame, seed, w, h):
    """A frame with a flat luma patch (and its chroma) over the middle
    fifth of a w x h frame, where the references hold the clip's texture,
    so that intra cells win there and the commit of intra cells has
    work."""
    y, cb, cr = (a.copy() for a in frame)
    rng = np.random.default_rng(seed)
    v = int(rng.integers(60, 200))
    x0, x1, y0, y1 = 2 * w // 5, 3 * w // 5, 2 * h // 5, 3 * h // 5
    y[y0:y1, x0:x1] = v
    cb[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = 255 - v // 2
    cr[y0 // 2:y1 // 2, x0 // 2:x1 // 2] = v // 2
    return y, cb, cr


def commit_bytes_ops(split=None, kinds=None, f=1, h=1088, w=1920):
    """(bytes, int32 operations) the forced intra commit must spend: the
    source read and the recon and levels written of every coded cell (the
    intra tree: every sample; the P/B commit: its intra cells, and the
    kinds read), the references of each block read, and the residual
    chain's partial butterflies (`chain_ops`) of each luma block and its
    two chroma blocks."""
    if split is not None:
        n32 = int((split == 0).sum())
        n16 = 4 * int((split != 0).sum())
        nbytes_ = f * h * w * 1.5 * (4 + 4 + 2) + split.numel() * 4 \
            + f * (h // 16) * (w // 16) * 4
    else:
        n32 = 0
        n16 = int((kinds == 2).sum())
        nbytes_ = kinds.numel() * 4 + n16 * 384 * (4 + 4 + 2 + 4)
    refs = n16 * (65 + 2 * 33) + n32 * (129 + 2 * 65)
    ops = n16 * (chain_ops(16) + 2 * chain_ops(8)) \
        + n32 * (chain_ops(32) + 2 * chain_ops(16))
    return nbytes_ + refs * 4, ops


def phase_kernels_scans(iters, dev="cuda"):
    """K19 (the B decide scan, one launch a B frame) and K20 (the forced
    intra commit, one launch a diagonal) against their plain versions on
    the card, every output bit for bit.  K19 free and forced at one
    config-3 B frame (phase 9's clip at 1920x1088, sr 16: POC 2 between
    the card's recon of the IDR and of the P anchor, dsf -256 both ways)
    and at POC 1 between the same references (dsf -85 and -768).  K20 on a
    config-1 batch (16 frames of 640x384), a Main10 batch (16 frames of
    1920x1088, bit depth 10), an intra batch with RDOQ (640x384), a
    config-2 P frame (1280x736) and a config-3 B frame with RDOQ 2
    (1920x1088, luma and chroma RDOQ), the two inter frames with a flat
    patch where intra cells win.  Times: CUDA events, 20 launches after 2
    warm-up, wrapper included (K19 also with L2 flushed before each
    launch, the _l2_cold keys); the plain versions once after a warm-up."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder, _pad_to_ctu
    from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
    from x265amod_tpu_torch.models.mvpred import dist_scale_factor
    dev = torch.device(dev)

    def up(frame, bd=8):
        return tuple(torch.as_tensor(
            _pad_to_ctu(a.view(np.int16) if bd == 10 else a, m),
            device=dev).to(torch.int32) for a, m in zip(frame, (32, 16, 16)))

    # ---- the config-3 B frames (config 3 + RDOQ 2: its B tree codes its
    # final and commit RDOQ; the decide scan runs none) ----
    frames = synth_frames(1920, 1080, 5, seed=4)
    enc = Encoder(config3(rdoq=2), device=dev)
    for fr in frames[:4]:
        enc.encode_push(*fr)
    refs0 = tuple(t.to(torch.int32) for t in enc._dpb[0])
    enc.encode_push(*frames[4])        # the P anchor and the mini-GOP
    refs1 = tuple(t.to(torch.int32) for t in enc._dpb[4])
    tree = enc.b_encoder
    maps = tree._maps(33)
    kb = dict(err=0.0)
    for poc, label in ((2, "1080p POC 2"), (1, "1080p POC 1")):
        y, cb, cr = up(frames[poc])
        dsf = (dist_scale_factor(poc, 0, 4), dist_scale_factor(poc, 4, 0))
        st1 = tree._phase1_b(y, (refs0[0], refs1[0]), maps, [])
        err, forced = check_decide_b(tree, st1, maps, dsf, label)
        kb["err"] = max(kb["err"], err)
        key = "" if poc == 2 else "_poc1"
        kb[f"dsf{key}"] = list(dsf)
        kb[f"ms{key}"] = time_ms(lambda: tree._decide_b_kernel(st1, maps,
                                                               dsf), iters)
        kb[f"ms_l2_cold{key}"] = time_cold_ms(
            lambda: tree._decide_b_kernel(st1, maps, dsf), iters)
        kb[f"ms_forced{key}"] = time_ms(lambda: tree._decide_b_kernel(
            None, maps, dsf, forced=forced), iters)
        kb[f"plain_ms{key}"] = time_once_ms(
            lambda: tree._decide_b_plain(st1, maps, dsf))
        kb[f"plain_ms_forced{key}"] = time_once_ms(
            lambda: tree._decide_b_plain(None, maps, dsf, forced=forced))
    kb.update(bound_ms=bound_ms(decide_b_bytes(tree, False), 0)[0],
              bound_ms_forced=bound_ms(decide_b_bytes(tree, True), 0)[0],
              bound_by="bytes", library_ms=None,
              library_note="none: no single call makes the decision",
              rows=tree.hc, steps=tree.wc + 2 * (tree.hc - 1))
    rows = [("decide_b", "x265amod_tpu_torch/csrc/decide_b.cu",
             "x265amod_tpu/models/inter_tree.py:1317-1570 B decide_body "
             "(lax.scan :1568)", kb)]

    # ---- K20 ----
    kc = dict(err=0.0)

    def commit_check(label, kernel, plain, nb, key):
        got, want = kernel(), plain()
        flat_g = [t for t in got if torch.is_tensor(t)] + [
            t for g in got if isinstance(g, tuple) for t in g]
        flat_w = [t for t in want if torch.is_tensor(t)] + [
            t for g in want if isinstance(g, tuple) for t in g]
        for i, (g, w_) in enumerate(zip(flat_g, flat_w)):
            kc["err"] = max(kc["err"], check_exact(
                f"commit_intra {label} out{i}", g, w_))
        kc[f"ms{key}"] = time_ms(kernel, iters)
        kc[f"plain_ms{key}"] = time_once_ms(plain)
        b, o = nb
        kc[f"bound_ms{key}"], kc[f"bound_by{key}"] = bound_ms(b, o)

    # the B frame of phase 9's clip with RDOQ 2 and a flat patch
    y, cb, cr = up(flat_patch(frames[2], 3, 1920, 1080))
    dsf = (dist_scale_factor(2, 0, 4), dist_scale_factor(2, 4, 0))
    st1 = tree._phase1_b(y, (refs0[0], refs1[0]), maps, [])
    cell = tree._cell_decisions_b(tree._decide_b(st1, maps, dsf))
    lv, rec = tree._phase3(y, cb, cr, tree._final_mc_b(
        refs0, refs1, cell, []), maps, cell)
    kinds, imode = cell["kinds"], st1["imode16"]
    kc["intra_cells_b_frame"] = int((kinds == 2).sum())
    lv_k = tuple(t.clone() for t in lv)
    commit_check("B frame rdoq 2", lambda: tree._commit_kernel(
        y, cb, cr, maps, kinds, imode, lv_k, rec),
        lambda: tree._commit_plain(y, cb, cr, maps, kinds, imode, lv, rec),
        commit_bytes_ops(kinds=kinds), "_b_frame_rdoq")
    kc["diagonals_b_frame"] = len(tree.diags)
    del enc, tree, st1, lv, rec, lv_k

    # a config-2 P frame with a flat patch
    pframes = synth_frames(1280, 720, 5, seed=2)
    enc = Encoder(config2(), device=dev)
    for fr in pframes[:4]:
        enc.encode_push(*fr)
    ptree = enc.inter_encoder
    refs, tables = ptree._ref_list([enc._dpb[3]], [3], 4)
    pmaps = ptree._maps(32)
    y, cb, cr = up(flat_patch(pframes[4], 4, 1280, 720))
    st1 = ptree._phase1(y, refs[0], pmaps, tables)
    cell = ptree._cell_decisions(ptree._decide(st1, pmaps, tables))
    lv, rec = ptree._phase3(y, cb, cr, ptree._final_mc(refs, cell), pmaps,
                            cell)
    kinds, imode = cell["kinds"], st1["imode16"]
    kc["intra_cells_p_frame"] = int((kinds == 2).sum())
    lv_k = tuple(t.clone() for t in lv)
    commit_check("P frame", lambda: ptree._commit_kernel(
        y, cb, cr, pmaps, kinds, imode, lv_k, rec),
        lambda: ptree._commit_plain(y, cb, cr, pmaps, kinds, imode, lv, rec),
        commit_bytes_ops(kinds=kinds), "_p_frame")
    kc["diagonals_p_frame"] = len(ptree.diags)
    if kc["intra_cells_p_frame"] == 0 or kc["intra_cells_b_frame"] == 0:
        raise AssertionError("commit_intra: the P or B frame has no intra "
                             f"cell ({kc})")
    del enc, ptree, st1, lv, rec, lv_k

    # intra batches: config 1, config 1 with RDOQ, Main10
    for label, w, h, bd, rdoq, key in (
            ("config-1 batch", 640, 360, 8, False, ""),
            ("intra batch rdoq", 640, 360, 8, True, "_rdoq"),
            ("Main10 batch", 1920, 1080, 10, False, "_main10")):
        fr = synth_frames(w, h, 16) if bd == 8 else synth_frames10(w, h, 16)
        ups = [up(x, bd) for x in fr]
        y, cb, cr = (torch.stack([u[k] for u in ups]) for k in range(3))
        itree = IntraTreeEncoder(y.shape[2], y.shape[1], deblock=bd == 8,
                                 device=dev, bit_depth=bd, rdoq=rdoq)
        imaps = itree._maps(30)
        split, modes = itree._estimate(y, cb, cr, imaps)
        commit_check(label, lambda: itree._commit_kernel(
            y, cb, cr, imaps, split, modes),
            lambda: itree._commit_plain(y, cb, cr, imaps, split, modes),
            commit_bytes_ops(split=split, f=16, h=y.shape[1],
                             w=y.shape[2]), key)
        kc[f"diagonals_batch{key}"] = len(itree.diags)
        kc[f"cu32_share{key}"] = float((split == 0).float().mean())
        del ups, y, cb, cr
    kc.update(library_ms=None,
              library_note="none: no single call codes a wavefront")
    rows.append(("commit_intra", "x265amod_tpu_torch/csrc/commit_intra.cu",
                 "x265amod_tpu/models/intra_tree.py:308-596 _encode_frame "
                 "scan (:595); x265amod_tpu/models/inter_tree.py:829-1044 "
                 "_commit_scan (:1028)", kc))
    return rows


def phase_kernels_multiref(iters, frames, dev="cuda"):
    """K17 at a real 1280x736 P frame's phase-1 outputs (frame 4 of the bench
    clip against the card's recon of frames 1-3, as config 2 at --ref 3
    codes it), at R = 1 and R = 3, free (decisions, MVs, references and cost
    rows) and forced (the plain scan's decisions replayed), against the
    plain scan on the card; K18 at R = 3 on the same frame's trials (CU16
    and CU32); K7 with a reference index at R = 3: the final MC of luma and
    chroma and the trials, with MVs at the window bound on border
    blocks."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder, _pad_to_ctu
    from x265amod_tpu_torch.ops import me
    dev = torch.device(dev)
    enc = Encoder(config2_ref(MULTIREF), device=dev)
    for fr in frames[:4]:
        enc.encode_push(*fr)
    tree = enc.inter_encoder
    pocs = sorted(enc._dpb, reverse=True)
    y = torch.as_tensor(_pad_to_ctu(frames[4][0], 32), device=dev) \
        .to(torch.int32)
    rows = []
    d = dict(err=0.0)
    per_r = {}
    for nr in (1, MULTIREF):
        refs, tables = tree._ref_list([enc._dpb[p] for p in pocs[:nr]],
                                      pocs[:nr], 4)
        maps = tree._maps(32)
        st1 = tree._phase1(y, refs[0], maps, tables)
        err, forced, cells = check_decide(tree, st1, maps, tables,
                                          f"R={nr}")
        d["err"] = max(d["err"], err)
        kinds = cells["kinds"]
        per_r[nr] = dict(
            ms=time_ms(lambda: tree._decide_kernel(st1, maps, tables), iters),
            device_ms=time_queued_ms(
                lambda: tree._decide_kernel(st1, maps, tables), iters),
            forced_ms=time_ms(lambda: tree._decide_kernel(
                None, maps, tables, forced=forced), iters),
            plain_ms=time_once_ms(lambda: tree._decide_plain(st1, maps,
                                                             tables)),
            forced_plain_ms=time_once_ms(lambda: tree._decide_plain(
                None, maps, tables, forced=forced)),
            bound_ms=bound_ms(decide_bytes(tree, nr, False), 0)[0],
            forced_bound_ms=bound_ms(decide_bytes(tree, nr, True), 0)[0],
            older_ref_share=float((cells["ref"][kinds <= 1] >= 1).float()
                                  .mean()))
    tables3 = tables
    r1, r3 = per_r[1], per_r[MULTIREF]
    d.update(ms=r1["ms"], ms_device=r1["device_ms"],
             ms_device_r3=r3["device_ms"], plain_ms=r1["plain_ms"],
             bound_ms=r1["bound_ms"],
             bound_by="bytes", library_ms=None,
             library_note="none: no single call makes the decision",
             launches_per_p_frame=1,
             ms_forced=r1["forced_ms"], plain_ms_forced=r1["forced_plain_ms"],
             bound_ms_forced=r1["forced_bound_ms"],
             ms_r3=r3["ms"], plain_ms_r3=r3["plain_ms"],
             bound_ms_r3=r3["bound_ms"], ms_forced_r3=r3["forced_ms"],
             plain_ms_forced_r3=r3["forced_plain_ms"],
             bound_ms_forced_r3=r3["forced_bound_ms"],
             bound_by_r3="bytes", rows=tree.hc,
             steps=tree.wc + 2 * (tree.hc - 1))
    rows.append(("decide_p", "x265amod_tpu_torch/csrc/decide_p.cu",
                 "x265amod_tpu/models/inter_tree.py:336-544 decide_body "
                 "(lax.scan :544)", d))

    # K18 pick_ref at R = 3: the trials of the same frame at 16 and 32
    d = dict(err=0.0, ms=0.0, plain_ms=0.0)
    per = []
    for r in range(MULTIREF):
        m = tree._motion_search(y, refs[0][r], maps)
        m.update(tree._subpel(y, refs[0][r], maps, m))
        per.append(m)
    trials = tree._trials(y, refs[0], maps, per)
    nbytes_ = 0
    for bn, lam in ((16, maps["lam16"]), (32, maps["lam32"])):
        args = (trials[f"d{bn}"], trials[f"rb{bn}"], trials[f"mv{bn}"], lam,
                tables3[1])
        for i, (g, w_) in enumerate(zip(me.pick_ref(*args),
                                        me.pick_ref_plain(*args))):
            d["err"] = max(d["err"], check_equal(f"pick_ref bn={bn} out{i}",
                                                 g, w_))
        d["ms"] += time_ms(lambda: me.pick_ref(*args), iters)
        d["plain_ms"] += time_ms(lambda: me.pick_ref_plain(*args), 2)
        n = lam.shape[0]
        nbytes_ += nbytes(*args) + n * 20
    d["bound_ms"], d["bound_by"] = bound_ms(nbytes_, 0)
    d["library_ms"] = None
    d["library_note"] = "none: no single call makes the decision"
    d["launches_per_p_frame_r3"] = 2
    rows.append(("pick_ref", "x265amod_tpu_torch/csrc/pick_ref.cu",
                 "x265amod_tpu/models/inter_tree.py:274-290 pick_ref", d))

    # K7 with a reference index at R = 3 (row 15's extension)
    rng = np.random.default_rng(17)
    ext = dict(err=0.0, ms=0.0, plain_ms=0.0)
    nbytes_, ops = 0, 0
    sr = tree.sr
    for planes, n, chroma, bound, k in (
            (refs[0], 16, False, 4 * (sr + 2), 1),
            (refs[1], 8, True, 8 * (sr // 2 + 2), 1),
            (refs[2], 8, True, 8 * (sr // 2 + 2), 1),
            (refs[0], 16, False, 4 * (sr + 2), MULTIREF),
            (refs[0], 32, False, 4 * (sr + 2), MULTIREF)):
        ph, pw = planes.shape[1:]
        wb = pw // n
        nb = (ph // n) * wb * k
        mv = rng.integers(-bound, bound + 1, (nb, 2)).astype(np.int32)
        mv[:wb] = (-bound, -bound)
        mv[-wb:] = (bound, bound)
        mv[::wb] = (-bound, bound)
        ref = rng.integers(0, MULTIREF, nb).astype(np.int32) if k == 1 \
            else np.repeat(np.arange(MULTIREF, dtype=np.int32), nb // k)
        mv, ref = (torch.as_tensor(a, device=dev) for a in (mv, ref))
        ext["err"] = max(ext["err"], check_equal(
            f"mc_qpel_ref n={n} chroma={chroma} k={k}",
            me.mc_qpel_ref(planes, mv, ref, n, chroma),
            me.mc_ref_plain(planes, mv, ref, n, chroma)))
        ext["ms"] += time_ms(lambda: me.mc_qpel_ref(planes, mv, ref, n,
                                                    chroma), iters)
        ext["plain_ms"] += time_ms(lambda: me.mc_ref_plain(planes, mv, ref, n,
                                                           chroma), 2)
        # as K7's own row: what each plane's predictions need of it, the
        # MVs and indices read, the predictions written
        nbytes_ += sum(k7_read_bytes(planes[r], mv, n, chroma, ref == r)
                       for r in range(planes.shape[0])) \
            + nbytes(ref) + nb * n * n * 4
        ops += k7_ops(nb, n, chroma)
    ext["bound_ms"], ext["bound_by"] = bound_ms(nbytes_, ops)
    summary = dict(older_ref_share_r3=r3["older_ref_share"],
                   decide_free_equal=True, decide_forced_equal=True)
    return rows, ext, summary


def phase_config2_ref(frames, warm, p5):
    """Config 2 at --ref 3 through `encode_push` and `flush` on phase 5's
    frames; fps, PSNR-Y, kbps, the share of inter cells on an older
    reference (ref_idx >= 1), and the launches per P frame of K5-K8, K17
    and K18, beside phase 5's figures (one reference)."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    enc = Encoder(config2_ref(MULTIREF), device="cuda")
    shares = []
    inner = enc.inter_encoder.collect

    def collect(handle):
        r = inner(handle)
        m = r.kinds <= 1
        shares.append((int((r.ref0[m] >= 1).sum()), int(m.sum())))
        return r
    enc.inter_encoder.collect = collect
    n_done, t0 = 0, None
    for i, fr in enumerate(frames):
        outs = enc.encode_push(*fr)
        if i == warm - 1:
            torch.cuda.synchronize()
            cuda_lib.reset_launches()
            shares.clear()
            t0 = time.time()
        elif i >= warm:
            n_done += len(outs)
    n_done += len(enc.flush())
    torch.cuda.synchronize()
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    s = enc.summary()
    n = len(frames) - warm
    if n_done != n or enc.num_ref_p != MULTIREF:
        raise AssertionError(f"config 2 --ref 3: {n_done} of {n} frames")
    if not 30.0 < s["psnr_y"] < 60.0 or not np.isfinite(s["bitrate_kbps"]):
        raise AssertionError(f"config 2 --ref 3: PSNR-Y {s['psnr_y']}")
    missing = [k for k, v in launches.items() if v <= 0
               and k not in CONFIG3_KERNELS + LOOKAHEAD_KERNELS
               + RDOQ_KERNELS + LADDER_KERNELS + FLAT_KERNELS]
    if missing:
        raise AssertionError(f"config 2 --ref 3 did not launch {missing}")
    if launches["decide_p"] != n:
        raise AssertionError(f"config 2 --ref 3: {launches['decide_p']} "
                             f"launches of K17 for {n} P frames")
    timed = enc.frame_stats[warm:]
    return dict(
        frames=n, seconds=dt, fps=n / dt, psnr_y=s["psnr_y"],
        kbps=s["bitrate_kbps"], ssim_y=s["ssim_y"],
        timed_psnr_y=float(np.mean([x.psnr_y for x in timed])),
        timed_kbps=float(sum(x.bits for x in timed) * 25.0 / n / 1000.0),
        older_ref_share=sum(a for a, _ in shares) / max(sum(
            b for _, b in shares), 1),
        launches_per_p_frame={k: launches[k] / n for k in (
            "me_ssd", "subpel", "mc_qpel", "hpel", "decide_p", "pick_ref")},
        phase5_one_ref=dict(fps=p5["fps"], psnr_y=p5["psnr_y"],
                            kbps=p5["kbps"], timed_psnr_y=p5["timed_psnr_y"],
                            timed_kbps=p5["timed_kbps"])), launches


def phase_card_vs_cpu_multiref(w=320, h=192):
    """--ref 4 at 320x192 on the flicker clip, 8 frames, on the card and on
    the CPU: the streams must be identical byte for byte, and some inter
    cells must use an older reference (the cyclic fill and every ref_idx
    bin occur)."""
    from x265amod_tpu_torch.models.encoder import Encoder
    frames = flicker_frames(w, h, FLICKER_FRAMES)
    streams, refs_used = {}, {}
    for dev in ("cuda", "cpu"):
        p = config2_ref(FLICKER_REF, w, h)
        p.info = False
        e = Encoder(p, device=dev)
        used = []
        inner = e.inter_encoder.collect

        def collect(handle, inner=inner, used=used):
            r = inner(handle)
            used.append(r.ref0[r.kinds <= 1])
            return r
        e.inter_encoder.collect = collect
        streams[dev] = [o.nals for f in frames for o in e.encode_push(*f)] \
            + [o.nals for o in e.flush()]
        refs_used[dev] = np.concatenate(used)
    if streams["cuda"] != streams["cpu"]:
        raise AssertionError("--ref 4: card and CPU streams differ")
    r = refs_used["cpu"]
    share = float((r >= 1).mean())
    if share <= 0.0:
        raise AssertionError("--ref 4: no inter cell uses an older reference")
    return dict(bitstreams_identical=True, frames=FLICKER_FRAMES,
                older_ref_share=share,
                ref_idx_counts=np.bincount(r, minlength=FLICKER_REF)
                .tolist())


# ---- phases 19-21: the flat CTB16 path ---------------------------------------

def config_ctb16(w=1920, h=1080, **kw):
    """The JAX package's defaults (`Param()`: CTU16, deblocking on, SAO
    off, sign hiding on, CQP 32) at keyint 1; kw overrides."""
    from x265amod_tpu_torch.utils.params import Param
    return Param(width=w, height=h, keyint=1, info=False, **kw)


def phase_ctb16(frames, warm, lossless=False):
    """CTB16 all-intra (or lossless) through `Encoder(device="cuda")` and
    `encode_pipelined` (the per-frame path): the first ``warm`` frames as
    warm-up, the rest timed.  fps, PSNR-Y, kbps, K23's launches (two a
    frame: its ticket list and its scan); lossless: the recon must equal
    the source."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    label = "lossless" if lossless else "CTB16"
    enc = Encoder(config_ctb16(lossless=lossless), device="cuda")
    for _ in enc.encode_pipelined(frames[:warm]):
        pass
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(enc.encode_pipelined(frames[warm:], return_recon=lossless))
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    n = len(frames) - warm
    timed = enc.frame_stats[warm:]
    if len(outs) != n or not all(o.nals for o in outs) or enc.ctu != 16:
        raise AssertionError(f"{label}: missing encoded frames")
    psnr = float(np.mean([x.psnr_y for x in timed]))
    kbps = float(sum(x.bits for x in timed) * 25.0 / n / 1000.0)
    if not np.isfinite(kbps) or not (psnr == 99.99 if lossless
                                     else 30.0 < psnr < 60.0):
        raise AssertionError(f"{label}: PSNR-Y {psnr}, kbps {kbps}")
    if lossless:
        for o, fr in zip(outs, frames[warm:]):
            for rec, src in zip(o.recon, fr):
                if not np.array_equal(rec, src):
                    raise AssertionError("lossless: recon differs from the "
                                         "source")
    want = ("intra16_scan", "frame_metrics") + (
        () if lossless else ("deblock_maps", "deblock", "pack_levels"))
    tree = ("intra_pred", "residual_chain", "tu_bits", "commit_intra")
    missing = [k for k in want if launches[k] <= 0]
    unexpected = [k for k in tree + (("deblock_maps", "deblock",
                                      "pack_levels") if lossless else ())
                  if launches[k] > 0]
    diags = len(enc.frame_encoder.diags)
    if missing or unexpected or launches["intra16_scan"] != 2 * n:
        raise AssertionError(f"{label}: did not launch {missing}, launched "
                             f"{unexpected}, K23 {launches['intra16_scan']}"
                             f" launches for {n} frames (two a frame)")
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=psnr, kbps=kbps,
                ssim_y=float(np.mean([x.ssim_y for x in timed])),
                qp=timed[0].qp, diagonals=diags,
                recon_equals_source=lossless or None), launches


def phase_card_vs_cpu_flat(w=320, h=192, n=3):
    """CTB16 with AQ 2 (the depth-1 lookahead, cu_qp_delta) and SAO, and
    lossless, on the card and on the CPU through `encode_pipelined`: the
    streams must be identical byte for byte."""
    from x265amod_tpu_torch.models.encoder import Encoder
    frames = synth_frames(w, h, n, seed=21)
    out = {}
    for label, kw in (("aq2_sao", dict(aq_mode=2, sao=True)),
                      ("lossless", dict(lossless=True))):
        streams = {}
        for dev in ("cuda", "cpu"):
            e = Encoder(config_ctb16(w, h, **kw), device=dev)
            streams[dev] = b"".join(o.nals for o in e.encode_pipelined(
                frames))
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"CTB16 {label}: card and CPU streams "
                                 "differ")
        out[label] = dict(bitstreams_identical=True,
                          bytes=len(streams["cuda"]))
    return out


# ---- phases 22-24: the flat CTB16 P and B frames -------------------------------

def config_flat_p(w=1920, h=1080):
    """`Param(width, height)`: the JAX package's defaults (CTU16, keyint
    250, no B frames, CQP 32, deblocking on, SAO off)."""
    from x265amod_tpu_torch.utils.params import Param
    return Param(width=w, height=h, info=False)


def config_flat_b(w=1920, h=1080):
    """`--preset medium` without `--ctu`, as the JAX CLI runs it without
    `--qp`/`--crf` (CQP 32): bframes 4 (the flat B pyramid), SAO, AQ 2,
    CU-tree, lookahead 20, me_range 16, subme 2."""
    from x265amod_tpu_torch.utils.params import param_default_preset
    p = param_default_preset("medium")
    p.width, p.height, p.info = w, h, False
    return p


def flat_decide_bytes(n, bidir, forced):
    """Bytes one flat decide scan must move: free, per CTU its trial
    distortion and rate (one or three), intra cost, lambda and ME MVs
    read, two SSD-grid entries per list (the two skip candidates) read,
    and its choice, MVs, MVDs, MVP indices and cost rows written; forced,
    the given choice, MVDs and MVP indices read and the MVs written.  Its
    arithmetic is a few hundred operations a CTU, far below the bytes."""
    k = 2 if bidir else 1
    if forced:
        inp = n * (4 + k * 12)
        out = n * k * 8 + (n * 4 if bidir else 0)
    else:
        inp = n * (8 * (3 if bidir else 1) + 8 + k * 8 + k * 2 * 4)
        out = n * (4 + k * 20 + (4 if bidir else 0) + (24 if bidir else 16))
    return inp + out


def commit16_bytes_ops(kinds, h=1088, w=1920):
    """(bytes, int32 operations) of K23 as the commit of a flat P/B frame:
    the kinds read; per intra CTU16 the source read, the recon and levels
    written and the references read, and 35 luma modes through the
    residual chain's partial butterflies (`chain_ops`) plus the two 8x8
    chroma blocks at the chosen mode."""
    n_intra = int((kinds == 2).sum())
    nbytes_ = kinds.numel() * 4 + n_intra * (384 * (4 + 4 + 2) + 4
                                             + (65 + 2 * 33) * 4)
    ops = n_intra * (35 * chain_ops(16) + 2 * chain_ops(8))
    return nbytes_, ops


def flat_inter_inputs(dev, w=1920, h=1080):
    """Phase 2's flat P/B frames: the clip of seed 22 at w x h padded to
    CTB16 (frame 1 with a flat patch), the card's CTB16 IDR recons of
    frames 0 and 2 (int32 planes) and frame 1's planes on ``dev``.
    Returns (padded w, padded h, [recon 0, recon 2], frame 1)."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    fr = synth_frames(w, h, 3, seed=22)
    fr[1] = flat_patch(fr[1], 22, w, h)
    pads = [[_pad_to_ctu(a, m) for a, m in zip(f, (16, 8, 8))] for f in fr]
    h, w = pads[0][0].shape
    idr = IntraFrameEncoder(w, h, device=dev)
    recon = [tuple(t.to(torch.int32) for t in idr.encode_async(
        *pads[i], 29, keep_recon=True)["recon_dev"]) for i in (0, 2)]
    cur = tuple(torch.as_tensor(a, device=dev).to(torch.int32)
                for a in pads[1])
    return w, h, recon, cur


def traced_tu_bits(module, fn):
    """``fn()`` with ``module.tu_bits`` (K3 as a model module imports it)
    recording each call's arguments.  Returns (fn's result, the calls)."""
    calls = []
    inner = module.tu_bits

    def spy(*a, **k):
        calls.append((a, k))
        return inner(*a, **k)
    module.tu_bits = spy
    try:
        return fn(), calls
    finally:
        module.tu_bits = inner


def k3_call_keys(calls, iters, label_of):
    """K3 against its plain version on recorded calls (bit for bit) and
    timed: per call label, ms, plain ms (one call), bound, TU count."""
    from x265amod_tpu_torch.ops import estbits
    out = dict(err=0.0)
    for a, k in calls:
        lv = a[0]
        tus = lv[..., 0, 0].numel()
        key = label_of(tus)
        out["err"] = max(out["err"], check_exact(
            f"tu_bits {key}", estbits.tu_bits(*a, **k),
            estbits.tu_bits_plain(*a, **k)))
        out[f"ms_{key}"] = time_ms(lambda: estbits.tu_bits(*a, **k), iters)
        out[f"plain_ms_{key}"] = time_once_ms(
            lambda: estbits.tu_bits_plain(*a, **k))
        n = lv.shape[-1]
        out[f"bound_ms_{key}"], out[f"bound_by_{key}"] = bound_ms(
            nbytes(lv) + tus * 4 * 2, tus * n * n * 12)
        out[f"tus_{key}"] = tus
    return out


def phase_kernels_flat_inter(iters, dev="cuda", w=1920, h=1080):
    """K24 (the flat P decide scan), K25 (the flat B decide scan), K23 as
    the commit of a flat P and B frame and K21's flat P/B maps against
    their plain versions on the card, bit for bit, at one 1920x1088 P frame
    (frame 1 of the clip of seed 22, with a flat patch, against the card's
    CTB16 IDR recon of frame 0) and one B frame (frame 1 between the IDR
    recons of frames 0 and 2, POC 1 of 2: dsf -256 for both lists), QP 32,
    sr 16:
    K24 and K25 free (decisions, MVs, MVDs, MVP indices and cost rows) and
    forced (the plain scan's decisions replayed); K23 on the frame's kinds
    and inter coding; K21 on its final levels and motion; K3 on the P
    frame's two calls (the inter trial's 8160 TUs and the intra trial's
    8160 x 35 TUs of 16x16, recorded from `_phase1`).  Times: CUDA events,
    20 calls after 2 warm-up (the plain scans once after a warm-up).
    Returns the K24 and K25 rows and the extra keys of the K23, K21 and
    K3 rows."""
    import torch
    import x265amod_tpu_torch.models.inter_frame as mif
    from x265amod_tpu_torch.models.b_frame import BFrameEncoder
    from x265amod_tpu_torch.models.inter_frame import InterFrameEncoder
    from x265amod_tpu_torch.models.mvpred import dist_scale_factor
    from x265amod_tpu_torch.ops import deblock
    from x265amod_tpu_torch.ops import decide_flat as dfl
    dev = torch.device(dev)
    w, h, recon, cur = flat_inter_inputs(dev, w, h)
    rows, extra = [], dict(intra16_scan={}, deblock_maps={})
    kz, km = extra["intra16_scan"], extra["deblock_maps"]
    for bidir in (False, True):
        enc = (BFrameEncoder if bidir else InterFrameEncoder)(w, h,
                                                              device=dev)
        maps = enc._maps(32)
        lam = maps["lam"].reshape(-1)
        n = enc.wc * enc.hc
        tag = "_flat_b" if bidir else "_flat_p"
        if bidir:
            dsf = (dist_scale_factor(1, 0, 2), dist_scale_factor(1, 2, 0))
            refs = recon
            st1 = enc._phase1(cur[0], (refs[0][0], refs[1][0]), maps, [])
            args = (enc.sch, st1["grids"], st1["d"], st1["rb"], st1["di"],
                    st1["mv_me"], lam, enc.sr, dsf, enc.hdr_bits)
            run, plain = dfl.decide_b, dfl.decide_b_plain
            fkeys = ("choice", "mvd0", "mvp0", "mvd1", "mvp1")
        else:
            refs = recon[:1]
            st1, calls = traced_tu_bits(mif, lambda: enc._phase1(
                cur[0], refs[0][0], maps))
            extra["tu_bits"] = k3_call_keys(
                calls, iters, lambda tus: "flat_intra_trial"
                if tus == 35 * n else "flat_inter_trial")
            args = (enc.sch, st1["grid"], st1["d"], st1["rb"], st1["di"],
                    st1["mv_me"], lam, enc.sr, enc.hdr_bits)
            run, plain = dfl.decide_p, dfl.decide_p_plain
            fkeys = ("choice", "mvd", "mvp")
        kd = dict(err=0.0)
        got = run(*args, want_costs=True)
        want = plain(*args, want_costs=True)
        for k in want:
            kd["err"] = max(kd["err"], check_exact(
                f"decide{tag} free {k}", got[k], want[k]))
        forced = tuple(want[k] for k in fkeys)
        fargs = args[:1] + (None,) * 5 + (lam,) + args[7:]
        got_f = run(*fargs, forced=forced)
        want_f = plain(*fargs, forced=forced)
        for k in want_f:
            kd["err"] = max(kd["err"], check_exact(
                f"decide{tag} forced {k}", got_f[k], want_f[k]))
            check_exact(f"decide{tag} forced replays {k}", got_f[k], want[k])
        kd["ms"] = time_ms(lambda: run(*args), iters)
        kd["ms_l2_cold"] = time_cold_ms(lambda: run(*args), iters)
        kd["ms_forced"] = time_ms(lambda: run(*fargs, forced=forced), iters)
        kd["plain_ms"] = time_once_ms(lambda: plain(*args))
        kd["plain_ms_forced"] = time_once_ms(lambda: plain(*fargs,
                                                           forced=forced))
        kd["bound_ms"], kd["bound_by"] = bound_ms(
            flat_decide_bytes(n, bidir, False), 0)
        kd["bound_ms_forced"], kd["bound_by_forced"] = bound_ms(
            flat_decide_bytes(n, bidir, True), 0)
        choice = want["choice"]
        kd.update(rows=enc.hc, steps=enc.wc + 2 * (enc.hc - 1),
                  library_ms=None,
                  library_note="none: no single call makes the decision",
                  choice_histogram=torch.bincount(
                      choice, minlength=6 if bidir else 4).tolist(),
                  shapes_note=("one 1920x1088 B frame, POC 1 between two "
                               "CTB16 IDR recons (dsf %d, %d), sr 16, QP 32"
                               % dsf) if bidir else (
                      "one 1920x1088 P frame against a CTB16 IDR recon, sr "
                      "16, QP 32"))
        rows.append(("decide_flat_b" if bidir else "decide_flat",
                     "x265amod_tpu_torch/csrc/decide_flat.cu",
                     "x265amod_tpu/models/b_frame.py:242-390 decide_body "
                     "(lax.scan :390)" if bidir else
                     "x265amod_tpu/models/inter_frame.py:240-315 "
                     "decide_body (lax.scan :314)", kd))
        # K23 as the commit, on the frame's kinds and inter coding
        kinds = torch.tensor(dfl.KIND_OF_CHOICE_B if bidir else
                             dfl.KIND_OF_CHOICE_P, device=dev)[choice]
        preds = enc._final_mc(refs[0], refs[1], want, []) if bidir else \
            enc._final_mc(refs[0], want["mv"])
        rec, lv = enc._final_code(*cur, preds, maps, kinds)
        k3 = kinds.reshape(1, enc.hc, enc.wc)
        st = "B" if bidir else "P"
        src = tuple(t[None] for t in cur)

        def commit(fn):
            return fn(*src, maps, (k3, tuple(t.clone() for t in rec),
                                   tuple(t.clone() for t in lv), st))
        got = commit(enc._scan._scan_kernel)
        want_c = commit(enc._scan._scan_plain)
        for i, (g, w_) in enumerate(zip(got, want_c)):
            kz["err"] = max(kz.get("err", 0.0), check_exact(
                f"intra16_scan commit{tag} out{i}", g, w_))
        kz[f"ms_commit{tag}"] = time_ms(
            lambda: commit(enc._scan._scan_kernel), iters)
        kz[f"plain_ms_commit{tag}"] = time_once_ms(
            lambda: commit(enc._scan._scan_plain))
        kz[f"bound_ms_commit{tag}"], kz[f"bound_by_commit{tag}"] = \
            bound_ms(*commit16_bytes_ops(kinds))
        kz[f"intra_cells_commit{tag}"] = int((kinds == 2).sum())
        # K21's flat P/B maps on the final levels and motion
        levels = got[3:6]
        inter = (k3, want["dir"].reshape(k3.shape) if bidir else None,
                 (want["mv0"] if bidir else want["mv"]).reshape(
                     k3.shape + (2,)),
                 want["mv1"].reshape(k3.shape + (2,)) if bidir else None,
                 None)
        got_m = deblock.deblock_maps(levels, 32, maps["qp"], None, inter)
        want_m = deblock.deblock_maps_plain(levels, 32, maps["qp"], None,
                                            inter)
        for i, (g, w_) in enumerate(zip(got_m, want_m)):
            km["err"] = max(km.get("err", 0.0), check_exact(
                f"deblock_maps{tag} out{i}", g, w_))
        k21_times(km, tag, lambda: deblock.deblock_maps(
            levels, 32, maps["qp"], None, inter), iters)
        km[f"plain_ms{tag}"] = time_ms(lambda: deblock.deblock_maps_plain(
            levels, 32, maps["qp"], None, inter), iters)
        ins = list(levels) + [maps["qp"]] + [t for t in inter
                                             if t is not None]
        km[f"bound_ms{tag}"], km[f"bound_by{tag}"] = bound_ms(
            nbytes(*ins) + nbytes(*got_m), 0)
        del st1, got, want_c, rec, lv
    return rows, extra


def phase_flat_inter(frames, warm, bidir):
    """The flat CTB16 P frames (`config_flat_p`) or the flat B pyramid
    (`config_flat_b`) through `Encoder(device="cuda")` and
    `encode_pipelined`: the first ``warm`` frames as warm-up (the IDR and
    a P frame), the rest timed; fps, PSNR-Y, kbps, the launches per frame;
    every flat kernel of the path must launch (K24 once a P frame, K25
    once a B frame, K23 twice a frame: its ticket list and its scan, for
    the IDR's all-intra scan and every P/B frame's commit) and no kernel
    of the CTU32 trees' scans."""
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    label = "flat B" if bidir else "flat P"
    enc = Encoder(config_flat_b() if bidir else config_flat_p(),
                  device="cuda")
    if warm:
        for _ in enc.encode_pipelined(frames[:warm]):
            pass
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    t0 = time.time()
    outs = list(enc.encode_pipelined(frames[warm:]))
    dt = time.time() - t0
    launches = dict(cuda_lib.LAUNCHES)
    n = len(frames) - warm
    timed = enc.frame_stats[warm:]
    types = [x.slice_type for x in timed]
    if len(outs) != n or not all(o.nals for o in outs) or enc.ctu != 16:
        raise AssertionError(f"{label}: missing encoded frames")
    psnr = float(np.mean([x.psnr_y for x in timed]))
    kbps = float(sum(x.bits for x in timed) * 25.0 / n / 1000.0)
    if not np.isfinite(kbps) or not 30.0 < psnr < 60.0:
        raise AssertionError(f"{label}: PSNR-Y {psnr}, kbps {kbps}")
    n_p, n_b = types.count("P"), types.count("B")
    want = ["me_ssd", "mv_argmin", "subpel", "mc_qpel", "intra_pred",
            "residual_chain", "tu_bits", "intra16_scan", "decide_flat",
            "deblock_maps", "deblock", "frame_metrics", "pack_levels"]
    if bidir:
        want += ["decide_flat_b", "mc_bi", "sao_analyse", "sao_apply",
                 "lowres_aq", "lowres_me", "cutree_prop"]
    tree = ("decide_p", "decide_b", "commit_intra", "hpel", "pick_ref")
    missing = [k for k in want if launches[k] <= 0]
    unexpected = [k for k in tree if launches[k] > 0]
    if (missing or unexpected or launches["decide_flat"] != n_p
            or launches["decide_flat_b"] != n_b or n_p < 1
            or (bidir and n_b < 1) or launches["intra16_scan"] != 2 * n):
        raise AssertionError(
            f"{label}: did not launch {missing}, launched {unexpected}; "
            f"K24 {launches['decide_flat']} for {n_p} P frames, K25 "
            f"{launches['decide_flat_b']} for {n_b} B frames ({types}), "
            f"K23 {launches['intra16_scan']} for {n} frames")
    return dict(frames=n, seconds=dt, fps=n / dt, psnr_y=psnr, kbps=kbps,
                ssim_y=float(np.mean([x.ssim_y for x in timed])),
                slice_types="".join(types),
                qps=sorted({x.qp for x in timed}),
                launches_per_frame={k: launches[k] / n for k in want}), \
        launches


def phase_card_vs_cpu_flat_inter(w=320, h=192, n=6):
    """The flat P frames (`config_flat_p`) and the flat B pyramid
    (`config_flat_b`) at 320x192 on the card and on the CPU through
    `encode_pipelined`: the streams must be identical byte for byte."""
    from x265amod_tpu_torch.models.encoder import Encoder
    out = {}
    for label, cfg, seed in (("flat_p", config_flat_p, 24),
                             ("flat_b", config_flat_b, 25)):
        frames = synth_frames(w, h, n, seed=seed)
        streams = {}
        for dev in ("cuda", "cpu"):
            e = Encoder(cfg(w, h), device=dev)
            streams[dev] = b"".join(o.nals for o in e.encode_pipelined(
                frames))
        if streams["cuda"] != streams["cpu"]:
            raise AssertionError(f"{label}: card and CPU streams differ")
        out[label] = dict(bitstreams_identical=True,
                          bytes=len(streams["cuda"]))
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--warm", type=int, default=8)
    ap.add_argument("--p-frames", type=int, default=12)
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
    # K17, K18 and K7 with a reference index on the bench clip's frames
    pframes = synth_frames(1280, 720, args.p_frames, seed=2)
    mr_rows, mc_ref, mr_summary = phase_kernels_multiref(args.iters, pframes)
    rows += mr_rows
    mc_row = next(d for name, _, _, d in rows if name == "mc_qpel")
    mc_row["err"] = max(mc_row["err"], mc_ref["err"])
    mc_row.update(ms_ref_r3=mc_ref["ms"], plain_ms_ref_r3=mc_ref["plain_ms"],
                  bound_ms_ref_r3=mc_ref["bound_ms"],
                  bound_by_ref_r3=mc_ref["bound_by"])
    rows += phase_kernels_b(args.iters)
    rows += phase_kernels_la(args.iters)
    rows += phase_kernels_rdoq(args.iters)
    pack_rows, d2h = phase_kernels_pack(args.iters)
    rows += pack_rows + phase_kernels_resample(args.iters)
    # K1-K3 at bit depth 10, at the Main10 path's 16-frame batch of
    # 1920x1088 (phase 12)
    rows += phase_kernels(16, 68, 120, args.iters, bd=10)
    # K1-K8 again at the config-3 slice's shapes (one B frame at 1920x1088,
    # sr 16): checked only, the rows keep config 1's and config 2's times
    by_name = {name: d for name, _, _, d in rows}
    for name, _, _, d in phase_kernels(1, 68, 120, 1) + phase_kernels_p(
            1, w=1920, h=1088, sr=16):
        by_name[name]["err"] = max(by_name[name]["err"], d["err"])
        by_name[name]["checked_at_config3_shapes"] = True
        log(f"phase 2: {name} equal to plain at 1920x1088 (max abs err "
            f"{d['err']})")
    # K1 at the flat intra trial's shape, K5 at 1920x1088 sr 16
    for name, ext in phase_kernels_k1_k5_1080p(args.iters).items():
        by_name[name]["err"] = max(by_name[name]["err"], ext.pop("err"))
        by_name[name].update(ext)
        log(f"phase 2: {name} at 1920x1088 " + json.dumps(ext)
            + f" [{card}]")
    by_name["intra_pred"]["shapes_note"] = (
        "also checked at one B frame's shapes (1920x1088, sr 16); "
        "_satd35 / _predict: the row's two entry points apart; "
        "_flat_trial_predict: predict of 8160 CU16s x 35 modes (the flat "
        "intra trial at 1920x1088, frame-border availability); "
        "bound_ms_int32*: the bound on int32 ALUs alone")
    by_name["me_ssd"]["shapes_note"] = (
        "also checked at one B frame's shapes (1920x1088, sr 16); "
        "_1080p_sr16_bn16_int: the flat P frame's grid; _bn16/32_int/hpel:"
        " a config-3 B frame's four grids per reference (1920x1088, sr "
        "16); bound_ms_int32*: the bound on int32 ALUs alone")
    # K6 at the flat P frame's call (1920x1088, n 16)
    k6 = phase_kernels_k6_1080p(args.iters)
    sub = by_name["subpel"]
    sub["err"] = max(sub["err"], k6.pop("err"))
    sub.update(k6)
    sub["shapes_note"] = (
        "also checked at one B frame's shapes (1920x1088, sr 16); "
        "_flat_p_1080p: the flat P frame's call (1920x1088, n 16, sr 16, "
        "8160 blocks), _l2_cold with L2 flushed before each call; "
        "ms_device*: the calls enqueued behind a spin of the card, the "
        "kernel's own time (ms: back to back from the host, which the "
        "wrapper's host time bounds); "
        "bound_ms*: the operations at the f32 FMA rate, on which the "
        "kernel runs its exact integer arithmetic; bound_ms_int32*: the "
        "bound on int32 ALUs alone")
    log("phase 2: subpel at the flat P frame " + json.dumps(k6)
        + f" [{card}]")
    # K7 at the flat 1080p frames' calls, the select entry among them
    k7 = phase_kernels_k7_1080p(args.iters)
    mc_row = by_name["mc_qpel"]
    mc_row["err"] = max(mc_row["err"], k7.pop("err"))
    mc_row.update(k7)
    mc_row["shapes_note"] = (
        "ms: config 2's five calls (1280x736: trials at n 16 and 32, the "
        "final luma at 16, cb and cr at 8); _ref_r3: the multi-reference "
        "calls at R 3; _flat_1080p_luma16 / _chroma8: a flat 1080p frame's "
        "luma call (8160 blocks of 16x16) and a chroma call (8160 of 8x8); "
        "_flat_1080p_sel_*: the select entry of a flat B frame's final MC "
        "(one list a block, K9's rows where both are used); "
        "_flat_1080p_selbi_*: the same without K9's rows, the blocks that "
        "use both lists bi-predicted in the launch (what mc_select runs); "
        "_l2_cold: L2 "
        "flushed before each call; ms_device*: the calls enqueued behind a "
        "spin of the card, the kernel's own time")
    log("phase 2: mc_qpel at the flat 1080p frames " + json.dumps(k7)
        + f" [{card}]")
    # K17 at config 3's P-anchor shapes (also the ladder's 1080p rung)
    dec1080 = phase_kernels_decide_1080p(args.iters)
    dec = by_name["decide_p"]
    dec["err"] = max(dec["err"], dec1080["err"])
    dec["checked_at_config3_shapes"] = True
    dec.update(ms_1080p=dec1080["ms"], bound_ms_1080p=dec1080["bound_ms"])
    log("phase 2: decide_p equal to plain at config 3's P anchor "
        + json.dumps(dec1080) + f" [{card}]")
    # K19 and K20 (the B decide scan and the forced intra commit)
    rows += phase_kernels_scans(args.iters)
    # K21, K22, the ME argmin and K23 (the flat CTB16 scan)
    rows += phase_kernels_flat(args.iters)
    # K24 and K25 (the flat decide scans), K23 as the flat P/B commit and
    # K21's flat P/B maps
    fi_rows, fi_extra = phase_kernels_flat_inter(args.iters)
    rows += fi_rows
    by_name = {name: d for name, _, _, d in rows}
    for name, ext in fi_extra.items():
        by_name[name]["err"] = max(by_name[name]["err"], ext.pop("err"))
        by_name[name].update(ext)
    by_name["intra16_scan"]["shapes_note"] += (
        "; _commit_flat_p / _commit_flat_b: K23 as the commit scan of "
        "phase 2's flat P / B frame at 1920x1088 (its intra CTUs only)")
    by_name["deblock_maps"]["shapes_note"] += (
        "; _flat_p / _flat_b: the maps of phase 2's flat P / B frame at "
        "1920x1088 (bS from kinds, directions and MVs); ms_l2_cold*: L2 "
        "flushed before each call; ms_device*: the calls enqueued behind "
        "a spin of the card, the two kernels' own time")
    by_name["tu_bits"]["shapes_note"] = (
        "ms: a config-1 batch's four calls; _flat_intra_trial / "
        "_flat_inter_trial: the two calls of phase 2's flat P frame at "
        "1920x1088 (8160 x 35 and 8160 TUs of 16x16)")
    for name in ("decide_b", "commit_intra", "deblock_maps",
                 "frame_metrics", "mv_argmin", "intra16_scan", "decide_flat",
                 "decide_flat_b", "tu_bits"):
        log(f"phase 2: {name} " + json.dumps(by_name[name]) + f" [{card}]")
    for name, _, _, d in rows:
        log(f"phase 2: {name} equal to plain (max abs err {d['err']}); "
            f"{d['ms']:.4f} ms vs plain {d['plain_ms']:.4f} ms, bound "
            f"{d['bound_ms']:.4f} ms ({d['bound_by']}) [{card}]")
    rd = by_name["residual_chain_rdoq"]
    log("phase 2: residual_chain_rdoq " + json.dumps(
        {k: v for k, v in rd.items() if k.startswith(("ms_", "ties"))})
        + f" [{card}]")
    log("phase 2: multi-reference " + json.dumps(dict(
        mr_summary, mc_qpel_ref_r3={k: mc_ref[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "err")}))
        + f" [{card}]")
    log("phase 2: level D2H, packed (K15) against dense, host ms "
        + json.dumps(d2h) + f" [{card}]")
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
    p_stats, launches2 = phase_config2(pframes, args.p_warm)
    log("phase 5: " + json.dumps(dict(p_stats, card=card,
                                      launches=launches2)))
    seconds["5_config2"] = time.time() - t0
    t0 = time.time()
    log("phase 6: " + json.dumps(phase_card_vs_cpu_p(pframes)))
    seconds["6_config2_card_vs_cpu"] = time.time() - t0

    t0 = time.time()
    bframes = synth_frames(1920, 1080, CONFIG3_FRAMES, seed=4)
    b_stats, launches3 = phase_config3(bframes, CONFIG3_WARM)
    log("phase 7: " + json.dumps(dict(b_stats, card=card,
                                      launches=launches3)))
    seconds["7_config3"] = time.time() - t0
    del bframes
    t0 = time.time()
    log("phase 8: " + json.dumps(phase_card_vs_cpu_b(
        synth_frames(640, 360, 5, seed=4))))
    seconds["8_config3_card_vs_cpu"] = time.time() - t0

    t0 = time.time()
    aqframes = synth_frames(1920, 1080, CONFIG3_AQ_FRAMES, seed=4)
    aq_stats, launches9 = phase_config3_aq(aqframes)
    log("phase 9: " + json.dumps(dict(aq_stats, card=card,
                                      launches=launches9)))
    seconds["9_config3_aq"] = time.time() - t0
    del aqframes
    t0 = time.time()
    log("phase 10: " + json.dumps(phase_card_vs_cpu_b(
        synth_frames(640, 360, 5, seed=4), aq=True)))
    seconds["10_config3_aq_card_vs_cpu"] = time.time() - t0

    t0 = time.time()
    aqframes = synth_frames(1920, 1080, CONFIG3_AQ_FRAMES, seed=4)
    rdoq_stats, launches11 = phase_config3_aq(aqframes, rdoq=2)
    del aqframes
    loss = aq_stats["psnr_y"] - rdoq_stats["psnr_y"]
    if rdoq_stats["bits"] >= aq_stats["bits"] or loss > RDOQ_MAX_PSNR_LOSS:
        raise AssertionError(
            f"config 3 with RDOQ: {rdoq_stats['bits']} bits against "
            f"{aq_stats['bits']} without, PSNR-Y {loss:.4f} dB lower")
    rdoq_stats.update(bits_saved_share=1.0 - rdoq_stats["bits"]
                      / aq_stats["bits"], psnr_y_loss_db=loss)
    log("phase 11: " + json.dumps(dict(rdoq_stats, card=card,
                                       launches=launches11)))
    seconds["11_config3_rdoq"] = time.time() - t0

    t0 = time.time()
    m10frames = synth_frames10(1920, 1080, MAIN10_FRAMES)
    m10_stats, launches12 = phase_main10(m10frames, MAIN10_WARM)
    del m10frames
    log("phase 12: " + json.dumps(dict(m10_stats, card=card,
                                       launches=launches12)))
    seconds["12_main10"] = time.time() - t0

    t0 = time.time()
    log("phase 13: config 3 + RDOQ " + json.dumps(phase_card_vs_cpu_b(
        synth_frames(320, 192, 5, seed=4), aq=True, rdoq=2, w=320, h=192)))
    log("phase 13: Main10 " + json.dumps(phase_card_vs_cpu_main10(
        synth_frames10(640, 360, 2))))
    seconds["13_card_vs_cpu"] = time.time() - t0

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.time()
        ladder_stats, launches14 = phase_ladder(tmp)
        log("phase 14: " + json.dumps(dict(ladder_stats, card=card,
                                           launches=launches14)))
        seconds["14_ladder"] = time.time() - t0
        t0 = time.time()
        vbv_stats, launches15 = phase_vbv(
            synth_frames(1280, 720, VBV_FRAMES, seed=2))
        log("phase 15: " + json.dumps(dict(vbv_stats, card=card,
                                           launches=launches15)))
        seconds["15_vbv"] = time.time() - t0
        t0 = time.time()
        log("phase 16: " + json.dumps(phase_card_vs_cpu_rc(
            tmp, synth_frames(320, 192, 6, seed=14))))
        seconds["16_rc_card_vs_cpu"] = time.time() - t0
    t0 = time.time()
    mr_stats, launches17 = phase_config2_ref(pframes, args.p_warm, p_stats)
    # config 2 at one reference again, after --ref 3: phase 5 ran first in
    # the process, so the pair 5, 17 alone confounds the reference count
    # with run order
    again, _ = phase_config2(pframes, args.p_warm)
    mr_stats["one_ref_after"] = {k: again[k] for k in (
        "fps", "psnr_y", "kbps", "timed_psnr_y", "timed_kbps")}
    log("phase 17: " + json.dumps(dict(mr_stats, card=card,
                                       launches=launches17)))
    seconds["17_config2_ref3"] = time.time() - t0
    t0 = time.time()
    log("phase 18: " + json.dumps(phase_card_vs_cpu_multiref()))
    seconds["18_multiref_card_vs_cpu"] = time.time() - t0
    t0 = time.time()
    cframes = synth_frames(1920, 1080, CTB16_FRAMES, seed=19)
    ctb16_stats, launches19 = phase_ctb16(cframes, CTB16_WARM)
    log("phase 19: " + json.dumps(dict(ctb16_stats, card=card,
                                       launches=launches19)))
    seconds["19_ctb16"] = time.time() - t0
    t0 = time.time()
    ll_stats, launches20 = phase_ctb16(cframes[:LOSSLESS_FRAMES],
                                       LOSSLESS_WARM, lossless=True)
    del cframes
    log("phase 20: " + json.dumps(dict(ll_stats, card=card,
                                       launches=launches20)))
    seconds["20_lossless"] = time.time() - t0
    t0 = time.time()
    log("phase 21: " + json.dumps(phase_card_vs_cpu_flat()))
    seconds["21_ctb16_card_vs_cpu"] = time.time() - t0
    t0 = time.time()
    pf = synth_frames(1920, 1080, FLAT_P_FRAMES, seed=22)
    flat_p_stats, launches22 = phase_flat_inter(pf, FLAT_P_WARM, False)
    del pf
    log("phase 22: " + json.dumps(dict(flat_p_stats, card=card,
                                       launches=launches22)))
    seconds["22_flat_p"] = time.time() - t0
    t0 = time.time()
    bf = synth_frames(1920, 1080, FLAT_B_FRAMES, seed=23)
    flat_b_stats, launches23 = phase_flat_inter(bf, 0, True)
    del bf
    log("phase 23: " + json.dumps(dict(flat_b_stats, card=card,
                                       launches=launches23)))
    seconds["23_flat_b"] = time.time() - t0
    t0 = time.time()
    log("phase 24: " + json.dumps(phase_card_vs_cpu_flat_inter()))
    seconds["24_flat_inter_card_vs_cpu"] = time.time() - t0
    log("seconds per phase: " + json.dumps(seconds))

    kernels = []
    for name, src, replaces, d in rows:
        base = name.replace("_main10", "")
        config1_kernel = name in CONFIG1_KERNELS
        config3_kernel = name in CONFIG3_KERNELS
        la_kernel = name in LOOKAHEAD_KERNELS
        main10_kernel = name != base
        if name == "decide_flat":
            launches, shapes = launches22[name], (
                "launches from the flat P frames (phase 22)")
        elif name == "decide_flat_b":
            launches, shapes = launches23[name], (
                "launches from the flat B pyramid (phase 23)")
        elif name in FLAT_KERNELS:
            launches, shapes = launches19[name], (
                "one 1920x1088 CTB16 frame (1920x1080 padded), QP 32; "
                "launches from CTB16 all-intra (phase 19)")
        elif name == "pack_levels":
            launches, shapes = launches14[name], (
                "one B frame at 1920x1088 (cap T/8); also a 16-frame "
                "config-1 batch at 640x384 (cap T/16) and a P frame at "
                "1280x736; launches from the ladder (phase 14)")
        elif name in MULTIREF_KERNELS:
            launches, shapes = launches17[name], (
                "one P frame at 1280x720 (padded 1280x736), sr 8, R 3, CU16 "
                "and CU32; launches from config 2 at --ref 3 (phase 17)")
        elif name == "decide_p":
            launches, shapes = launches2[name], (
                "one P frame at 1280x720 (padded 1280x736), sr 8, R 1 (and "
                "R 3: the _r3 keys), free and forced; launches from config "
                "2 (phase 5)")
        elif name in LADDER_KERNELS:
            launches, shapes = launches14[name], (
                "one 4:2:0 frame 1920x1080 -> 1280x720 (bicubic, 6 "
                "launches); also checked at -> 640x360, bilinear, and "
                "640x360 -> 1280x720; launches from the ladder (phase 14)")
        elif main10_kernel:
            launches, shapes = launches12[base], (
                "16-frame Main10 batch at 1920x1080 (padded 1920x1088), "
                "bit depth 10")
        elif name in RDOQ_KERNELS:
            launches, shapes = launches11[name], (
                "one B frame's final coding at 1920x1088 (luma, st B); "
                "also a P frame's (luma and chroma, st P) and one "
                "diagonal of config 1's commit (st I)")
        elif config1_kernel:
            launches, shapes = launches1[name], (
                f"16-frame batch at {w}x{h} (padded {16 * w16}x{16 * h16})")
        elif config3_kernel:
            launches, shapes = launches3[name], (
                "one B frame at 1920x1080 (padded 1920x1088), sr 16")
        elif la_kernel:
            launches, shapes = launches9[name], (
                "one frame's lookahead at 1920x1080 (padded 1920x1088, "
                "lowres 960x544, 120x68 blocks)")
        else:
            launches, shapes = launches2[name], (
                "one P frame at 1280x720 (padded 1280x736), sr 8")
        if name == "decide_p":
            shapes += "; also checked and timed (the _1080p keys) at config " \
                "3's first P anchor (1920x1088, R 1)"
        elif name == "decide_b":
            shapes += "; POC 2 between the IDR and the P anchor, free and " \
                "forced; also at POC 1 (unequal dsf, the _poc1 keys)"
        elif name == "commit_intra":
            shapes += "; also a Main10 batch at 1920x1088 (_main10), an " \
                "intra batch with RDOQ (_rdoq), a config-2 P frame " \
                "(_p_frame) and a config-3 B frame with RDOQ 2 " \
                "(_b_frame_rdoq); launches = diagonals"
        elif "shapes_note" in d:
            shapes += "; " + d["shapes_note"]
        elif d.get("checked_at_config3_shapes"):
            shapes += "; also checked at one B frame's shapes (1920x1088, " \
                "sr 16)"
        extra = {k: v for k, v in d.items() if k.startswith(
            ("ms_", "plain_ms_", "bound_ms_", "bound_by_", "diagonals",
             "intra_cells_", "dsf", "cu32_share", "chain",
             "launches_per_call", "tus_"))
            or k.startswith(("blocks", "ms_per_launch", "split_blocks"))
            or k in ("ties", "level_bound_reached", "rows", "steps",
                     "ties_checked", "choice_histogram", "hpel_range")}
        kernels.append(dict(
            name=name, route="cuda", source=src, replaces=replaces,
            launches=launches,
            launches_config1=launches1[base],
            launches_config2=launches2[base],
            launches_config3=launches3[base],
            launches_config3_aq=launches9[base],
            launches_config3_rdoq=launches11[base],
            launches_main10=launches12[base],
            launches_ladder=launches14[base],
            launches_vbv=launches15[base],
            launches_config2_ref3=launches17[base],
            launches_ctb16=launches19[base],
            launches_lossless=launches20[base],
            launches_flat_p=launches22[base],
            launches_flat_b=launches23[base],
            launches_per_frame_config3_aq=launches9[base] / CONFIG3_AQ_FRAMES,
            launches_per_frame_config3_rdoq=launches11[base]
            / CONFIG3_AQ_FRAMES,
            launches_per_b_frame=b_stats["launches_per_b_frame"][base],
            max_abs_err=d["err"], ms=d["ms"],
            plain_ms=d["plain_ms"], bound_ms=d["bound_ms"],
            bound_by=d["bound_by"], library_ms=d.get("library_ms"),
            library_note=d.get("library_note",
                               "no single PyTorch call computes this "
                               "function"),
            **({"deterministic_run_to_run": True}
               if d.get("deterministic") else {}),
            **extra, shapes=shapes))
    print(json.dumps({"queued_timer": QUEUE_LOG}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
