"""Where the time goes in the PyTorch/CUDA port's paths on one GPU:
BASELINE config 1 (640x360 all-intra QP 30, CTU32, 16-frame batches),
config 2 (1280x720 low-delay P QP 32, CTU32, one reference), the config-3
slice (1920x1080 B pyramid with SAO, CQP 32, AQ and CU-tree off), config
3 as bench.py builds it (the same with the lookahead, AQ and CU-tree: "4"),
the ABR ladder ("5"), config 2 under VBV with HRD ("6"), Main10 all-intra
("7"), config 3 with RDOQ ("8"), config 2 at x265's default --ref 3
("9"), the flat CTB16 all-intra path at 1920x1080, lossy and lossless
("10"), the flat CTB16 P frames of the JAX defaults ("11") and the flat B
pyramid of preset medium without --ctu ("12") at 1920x1080; K1, K5, K24,
K3, K23, K2, K20, K19 and K25 alone ("13"); the end-to-end fps of the flat
paths ("14").

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_port.py [--configs 1,2,...,14] [--batches 2]
        [--p-frames 4] [--iters 20] [--root DIR]
        [--kernels k1k5,k24,k3,k23,k2k20,k19k25,k6k17,k7k21,k9k10,k13am,
                   k22k8]
        [--fold-tail none|launch|read]

and, anywhere, to compare runs of two trees (one output file per run):

    python3 profile_port.py --summarize OUT... --root PARENT_DIR

Prints JSON lines:
  - "stages": host wall time of each stage of a config 1 16-frame batch,
    with a device synchronize after each (upload, estimate, commit (K20),
    loop filter + metrics (K21, K4, K22), D2H copy, CABAC on 4 threads, NAL
    assembly),
    averaged over --batches batches;
  - "profile": torch.profiler over one config 1 encode_pipelined call of
    32 frames (two 16-frame batches): wall time, summed device kernel
    time, the device busy share (kernel time / wall) and the 80 kernels
    with the most device time, each with its calls;
  - "p_stages": the same breakdown of a config 2 P frame (upload, ME,
    sub-pel, trials, pick_ref (K18, with several references), intra trial,
    decide scan (K17), final MC and residuals, commit scan (K20), loop
    filter + metrics, D2H, CABAC), averaged over --p-frames P frames after
    two P frames that warm every stage up;
  - "p_profile": torch.profiler over --p-frames P frames of config 2
    through encode_push;
  - "b_stages": the breakdown of a config-3 B frame (upload, ME, trials,
    intra trial, decide scan (K19), final MC and residuals, commit scan
    (K20), deblock + metrics, SAO, D2H, CABAC), averaged over the 3 B
    frames coded between the IDR and the P anchor of the first mini-GOP,
    after one uncounted warm-up pass of the first B frame;
  - "b_profile": torch.profiler over one mini-GOP (P + 3 B) of config 3
    through encode_push (its 80 kernels with the most device time);
  - "la_stages": the lookahead of config 3 per pushed frame (upload, K12
    lowres plane + AQ, K1 lowres intra cost, K13 lowres motion search, the
    host copies of the small maps, scene-cut decision, CU-tree over the
    queue with K14), averaged over 9 frames;
  - "aq_profile": torch.profiler over the pushes that code one mini-GOP of
    config 3 with AQ and CU-tree (after the IDR and a warm-up mini-GOP);
  - "ladder_stages": chip_smoke's ladder (1920x1080 in; 1080p, 720p and
    360p rungs at preset medium, ABR) per input frame: K16's resample of
    each smaller rung with the copy of its planes to the host, and each
    rung's encode_push and flush (gross; the lookahead of preset medium
    holds 20 frames, so an 11-frame run codes in the flush), out of which
    the trees' level pack and D2H
    start (`_to_host`: K15 and the copies), the wait and the unpack
    (`collect`), the lookahead and the rate control are broken out;
    "other" is the wall time outside every stage (the input's upload
    among it; K16's stage includes the first frame's band build);
  - "vbv_stages": config 2 under ABR + VBV with HRD (chip_smoke phase 15)
    per frame through encode_pipelined: lookahead, rate control, level pack
    and D2H start, wait and unpack, the rest of the encode;
  - "main10_stages": Main10 all-intra at 1920x1080 per 16-frame batch:
    upload, estimate, commit, level pack and D2H start, wait and unpack;
  - "rdoq_b_stages": the B-frame breakdown of "b_stages" with
    `rdoq_level=2` (its final MC and residuals carry the RDOQ stage);
  - "p_stages_ref3": the "p_stages" breakdown of config 2 at --ref 3, over
    the P frames 3 to --p-frames + 2 (the two warm-up P frames are the
    ones coded against a list filled cyclically from fewer pictures);
    "p_profile_ref3": torch.profiler over the same P frames of a new
    encoder through encode_push;
  - "ctb16_stages" and "lossless_stages": the flat CTB16 all-intra path
    (chip_smoke phases 19 and 20: 1920x1080, the JAX defaults at keyint 1,
    QP 32; and lossless) per frame through encode_pipelined after 2
    warm-up frames: the scan (K23), the loop filter (K21 + K4), SAO,
    SSE/SSIM (K22), level pack and D2H start, wait and unpack, CABAC, rate
    control; "ctb16_profile": torch.profiler over 8 CTB16 frames;
  - "flat_p_stages": the flat CTB16 P frames (chip_smoke phase 22:
    `Param(1920, 1080)`, QP 32) per P frame through encode_pipelined after
    the IDR and a warm-up P frame: ME (K5, the argmin, K6), the inter trial
    (K7, K2, K3), the intra trial (35 modes through K1, K2, K3) ("phase1_all"
    holds all three; "me" and "intra_trial" again apart), the decide scan
    (K24), final MC (K7) and residuals (K2), the commit scan (K23 on
    the intra CTUs), loop filter (K21 + K4), SSE/SSIM (K22), level pack and
    D2H, CABAC; "flat_p_profile": torch.profiler over 8 P frames;
  - "flat_b_stages": the same stages per frame of the flat B pyramid
    (chip_smoke phase 23: preset medium, 11 frames, I, P and B frames
    together; the B trials in "phase1_all", K25 in "decide_scan", SAO and
    the lookahead apart, the IDR's device step in "idr_step");
    "flat_b_profile": torch.profiler over the same 11 frames coded again
    by a new encoder (its 80 kernels with the most device time, each with
    its calls); with --fold-tail launch or read, both runs enqueue after
    each folded K5 launch of the flat frames' ME a one-element fill (a
    launch that moves no bytes) or a max over the grid (its bytes read
    once, as a separate argmin kernel would), to show whether a later
    kernel's time in the flow depends on what runs before it;
  - "kernel_times" ("13"): K1, K5, K24, K3, K23, K2 and K20 alone at the main
    path's shapes, CUDA events over --iters calls after 2 warm-up.  K1
    and K5 (lists of KT_REPS timings): "k1_satd35_*" and "k1_predict_*"
    at a config-1 batch's calls (16 frames at 640x384: 15360 CU16s and
    3840 CU32s, predict of a top-4 shortlist) and a Main10 batch's (16
    frames at 1920x1088), satd35 on the lookahead's 8160 lowres blocks,
    predict of the flat intra trial (8160 CU16s x 35 modes); K5's four
    grids of a config-2 P frame (1280x736, sr 8: bn 16 and 32 on the
    integer and the half-pel plane), the flat P frame's grid (1920x1088,
    sr 16, bn 16) and a config-3 B frame's four grids per reference
    (1920x1088, sr 16), on the bench clip.  K24 and K3 (lists of KT_REPS
    timings): "k24_flat_p_1080p" and "k24_flat_p_1080p_forced" (the flat
    P frame of chip_smoke phase 2, free and replaying its own decisions;
    "_l2_cold": free, L2 flushed before each call, as the frame's flow
    finds the grids after the intra trial's traffic),
    "k3_flat_intra_trial" and "k3_flat_inter_trial" (that frame's two
    calls: 8160 x 35 and 8160 TUs of 16x16), "k3_config1" and "k3_main10"
    (a batch's four calls on K2's levels).  K23 on one 1920x1088
    CTB16 frame at QP 32 (the bench clip of seed 19), lossless, a 16-frame
    640x368 batch, and as the commit of a 1920x1088 P frame whose intra
    CTUs are a 24 x 14 patch (336 of 8160); K2 at a config-1 batch's four
    calls (16 frames at 640x384), the flat intra trial (35 modes of 8160
    CTU16s) and a Main10 batch's four calls (16 frames at 1920x1088); K20
    as the commit of a config-1 and a Main10 batch (chip_smoke phase 2's);
    K25 and K19 (lists of KT_REPS timings): "k25_flat_b_1080p" (the flat
    B frame of chip_smoke phase 2: 1920x1088, POC 1 between two CTB16 IDR
    recons, sr 16) and "k19_config3_b_1080p" (config 3's POC 2 between the
    card's recons of the IDR and the P anchor, 1920x1088, sr 16), each
    also "_forced" (replaying its own decisions) and "_l2_cold" (L2
    flushed before each call).  K17 and K6 ("k6k17", lists of KT_REPS
    timings, each also "_l2_cold" and "_device": the calls enqueued behind
    a spin of the card, the kernel's own time where the wrapper's host
    time is the longer): "k17_config2_720p_r1" and "_r3" (chip_smoke
    phase 2's config-2 P frame at R 1 and 3) and "k17_config3_p_1080p"
    (config 3's first P anchor, 1920x1088, sr 16), each also "_forced"
    and "_forced_device" (replaying its own decisions); "k6_config2_720p"
    (that P frame's two calls, n 16 and 32, sr 8), "k6_1080p_n32" (the P
    anchor's n-32 call) and "k6_flat_p_1080p_n16" (the flat P frame's
    call, 8160 blocks).  K7 and K21 ("k7k21", lists of KT_REPS timings,
    each also "_l2_cold" and "_device"): "k7_flat_1080p_luma16" and
    "k7_flat_1080p_chroma8" (a flat 1080p frame's luma call, 8160 blocks
    of 16x16, and a chroma call, 8160 of 8x8, on chip_smoke's
    `k7_flat_inputs`), "k7_copy_flat_1080p_luma16" and "_chroma8" (a
    device copy of the bytes each call moves), "k7_mc_select_flat_b_1080p"
    (the whole final MC of the three planes, K9 included),
    "k7_config2_five" (config 2's five calls at 1280x736); K21 at
    chip_smoke phase 2's shapes: "k21_config1_batch" (16 frames at
    640x384), "k21_p_frame" (1280x736), "k21_b_frame" and
    "k21_flat_1080p" (1920x1088), each with "_split" (torch.profiler's
    device ms a call of each of its two kernels); "launch_floor" (an
    empty launch).  K9, K10 and K11 ("k9k10", lists of KT_REPS timings,
    each also "_l2_cold" and "_device"): "k9_flat_1080p_luma16" and
    "k9_flat_1080p_chroma8" (K9 on `k7_flat_inputs`' two lists),
    "k9_config3_trials" (the B tree's two trial calls, bn 16 and 32),
    "k9_final_mc_flat_b_1080p_copy" (a flat B frame's final MC with K9's
    rows: K9 and K7's select entry a plane) and "_fold" (K7's select entry
    alone, its both-list blocks bi-predicted in the launch);
    "k10_config3_b_frame" and "k10_flat_1080p" (K10's frame entry: luma
    at CTU 32 / 16 and cb + cr at half of it, one launch, on chip_smoke's
    `sao_inputs`), each also "_two_entries" (the luma and the joint chroma
    entries); "k11_config3_b_frame_three" and "k11_flat_1080p_three" (K11
    on the three planes).  K13 and the ME argmin ("k13am", lists of
    KT_REPS timings, each also "_l2_cold" and "_device"):
    "k13_lookahead_1080p" (K13 at a 1080p frame's lowres planes, 960x544,
    rng 8, chip_smoke's `phase_kernels_la` planes); "k5_argmin_flat_1080p"
    (the flat 1080p frame's grid, 8160 blocks, sr 16) and
    "k5_argmin_config2" (config 2's two grids, 1280x736, sr 8, bn 16 and
    32): K5 with the argmin in its epilogue (`me_ssd_grid_mv`), or in a
    tree without it, K5 then its argmin kernel.  K22 and K8 ("k22k8",
    lists of KT_REPS timings, each also "_l2_cold" and "_device"):
    "k22_config1_batch", "k22_p_frame", "k22_b_frame" and
    "k22_flat_1080p" (chip_smoke phase 2's four shapes: 16 frames of
    640x384, 1280x736, 1920x1088 twice, SSIM on), "k8_config2_720p" and
    "k8_1080p" (K8 on the bench clip's luma at 1280x736 and 1920x1088)
    and "conv2d_k8_config2_720p" and "conv2d_k8_1080p" (`F.conv2d` of the
    8x8 kernel over the same planes, replicate-padded, f32: the library
    call K8's row compares with).
    With --root DIR the port package is imported from DIR (an unpacked
    earlier tree), so that two designs are timed by one script in one
    call; --kernels names the groups timed ("k1k5", "k24", "k3", "k23",
    "k2k20", "k19k25", "k6k17", "k7k21", "k9k10", "k13am", "k22k8"; all
    by default);
  - "e2e_fps": chip_smoke phases 19, 20 and 22 timed as those phases time
    them (a new Encoder, their warm-up frames, then one encode_pipelined
    call over the rest, host wall clock): CTB16 all-intra (16 frames),
    lossless (4) and the flat P frames (10) at 1920x1080, the three in
    turn, E2E_REPS times, every fps listed; with --root DIR an earlier
    tree's port, so that two trees alternate in one call (parent, change,
    change, parent);
  - with --summarize: for every number of the "kernel_times", "e2e_fps",
    "p_stages", "p_profile", "b_stages", "b_profile", "flat_b_stages" and
    "flat_b_profile" lines
    (each tagged with its tree's root), the median, min and max of each
    tree's runs and the verdict: "faster" only where every change run
    beats every parent run (ms and shares lower, fps higher), "slower" the
    other way round, else "unresolved";
  - "queued_timer": what chip_smoke's `time_queued_ms` met in the run
    (readings kept, late tries, misreads with the SM clock);
  - the card's name and power limit.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (QUEUE_LOG, card_line, config1, config2, config2_ref,
                        config3, synth_frames, time_cold_ms, time_ms,
                        time_queued_ms)

# P frames that run every stage before the P breakdowns' clock starts
P_WARM = 2
# rounds of the end-to-end fps runs ("14")
E2E_REPS = 5
# timings of each K1 and K5 key in one process ("13")
KT_REPS = 3


def stage_breakdown(enc, frames, batches):
    import torch
    from x265amod_tpu_torch.ops.deblock import deblock_frame_planes
    from x265amod_tpu_torch.ops.metrics import frame_metrics
    fe = enc.frame_encoder
    qp = enc.rc.frame_qp("I")
    maps = fe._maps(qp)
    acc = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3 / batches
        return t1

    pad = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
            for a, s in zip(f, (32, 16, 16))] for f in frames]
    with ThreadPoolExecutor(max_workers=4) as pool:
        for b in range(batches):
            grp = pad[16 * b:16 * b + 16]
            torch.cuda.synchronize()
            t = time.perf_counter()
            y, cb, cr = (fe._upload(np.stack([g[i] for g in grp]))
                         .to(torch.int32) for i in range(3))
            t = mark("upload", t)
            split, modes = fe._estimate(y, cb, cr, maps)
            t = mark("estimate", t)
            ry, rcb, rcr, ly, lcb, lcr, mo = fe._commit(y, cb, cr, maps,
                                                        split, modes)
            t = mark("commit", t)
            ry, rcb, rcr = deblock_frame_planes(
                ry, rcb, rcr, (ly, lcb, lcr), maps["qp32"], qp, split=split)
            sse = frame_metrics((y, cb, cr), (ry, rcb, rcr))
            t = mark("loop_filter_and_metrics", t)
            handle = fe._to_host(dict(
                split=split.to(torch.int8), modes=mo.to(torch.uint8), ly=ly,
                lcb=lcb, lcr=lcr, sse=sse))
            results = fe.collect_batch(handle)
            t = mark("d2h", t)
            payloads = list(pool.map(
                lambda r: enc._cabac_intra_tree(r, qp), results))
            t = mark("cabac_4_threads", t)
            for r, pl in zip(results, payloads):
                enc._assemble_intra_nal(r, qp, *pl, t)
            mark("nal", t)
    acc["total"] = sum(acc.values())
    return acc


def p_stage_breakdown(enc, frames, warm=P_WARM):
    """Stages of config 2's P frames (at the encoder's --ref), each against
    the recon of the previous frames as the encoder's L0 list holds them
    (nearest first, filled cyclically while fewer exist); frames[0] is
    coded as the I frame that seeds the list, and the first ``warm`` P
    frames run every stage once before the clock counts (first-call
    set-up: lazy module loads, the allocator's first blocks).  Each
    reference's half-pel plane is made once, as the encoder's DPB keeps it
    (`RefPicture`), where the tree has that cache."""
    import torch
    from x265amod_tpu_torch.models import inter_tree
    picture = getattr(inter_tree, "RefPicture", None)
    enc.encode_push(*frames[0])
    recons = [next(iter(enc._dpb.values()))]
    nr = enc.num_ref_p
    fe = enc.inter_encoder
    qp = enc.rc.frame_qp("P")
    maps = fe._maps(qp)
    n = len(frames) - 1 - warm
    acc = {}
    timed = [False]

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        if timed[0]:
            acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3 / n
        return t1

    pad = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
            for a, s in zip(f, (32, 16, 16))] for f in frames[1:]]
    for poc, fr in enumerate(pad, 1):
        timed[0] = poc > warm
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, cb, cr = (fe._upload(a).to(torch.int32) for a in fr)
        pick = [k % len(recons) for k in range(nr)]
        refs, tables = fe._ref_list([recons[k] for k in pick],
                                    [poc - 1 - k for k in pick], poc)
        t = mark("upload", t)
        per = [fe._motion_search(y, refs[0][r], maps, recons[pick[r]])
               if picture else fe._motion_search(y, refs[0][r], maps)
               for r in range(nr)]
        t = mark("me", t)
        for r, m in enumerate(per):
            m.update(fe._subpel(y, refs[0][r], maps, m))
        t = mark("subpel", t)
        st1 = dict(grid=fe._stack_grids(per))
        st1.update(fe._trials(y, refs[0], maps, per))
        t = mark("trials", t)
        fe._pick_refs(st1, maps, tables)
        t = mark("pick_ref", t)
        oy = y.reshape(fe.h16, 16, fe.w16, 16).permute(0, 2, 1, 3)
        st1["di16"], st1["imode16"] = fe._intra_trial16(
            oy, oy.reshape(-1, 16, 16), maps["qp16"], maps["lam16"])
        t = mark("intra_trial", t)
        dec = fe._decide(st1, maps, tables)
        t = mark("decide_scan", t)
        cell = fe._cell_decisions(dec)
        lv, rec = fe._phase3(y, cb, cr, fe._final_mc(refs, cell), maps,
                             cell)
        t = mark("final_mc_residuals", t)
        rec, lv, modes = fe._commit(y, cb, cr, maps, cell["kinds"],
                                    st1["imode16"], lv, rec)
        t = mark("commit_scan", t)
        h16, w16 = fe.h16, fe.w16
        intra = (cell["kinds"] == 2).reshape(h16, w16)
        mv0 = torch.where(intra[..., None], 0, dec["mv"].reshape(h16, w16, 2))
        ref0 = torch.where(intra, 0, cell["ref"].reshape(h16, w16))
        rec, sse, _ = fe._filter_and_metrics(
            (y, cb, cr), rec, lv, cell["kinds"], dec["split"],
            (torch.where(intra, 0, 1), mv0, torch.zeros_like(mv0)), maps, qp,
            ref0)
        t = mark("loop_filter_and_metrics", t)
        handle = fe._to_host(dict(
            split=dec["split"].to(torch.int8),
            kinds=cell["kinds"].reshape(h16, w16).to(torch.uint8),
            merge=cell["merge"].reshape(h16, w16).to(torch.uint8),
            mvd=cell["mvd"].reshape(h16, w16, 2).to(torch.int16),
            mvp=cell["mvp"].reshape(h16, w16).to(torch.uint8),
            ref=cell["ref"].reshape(h16, w16).to(torch.uint8),
            modes=modes.to(torch.uint8),
            ly=lv[0].reshape(h16, w16, 16, 16),
            lcb=lv[1].reshape(h16, w16, 8, 8),
            lcr=lv[2].reshape(h16, w16, 8, 8), sse=sse),
            tuple(r.to(torch.uint8) for r in rec))
        res = fe.collect(handle)
        t = mark("d2h", t)
        enc._cabac_inter_tree(res, qp)
        mark("cabac", t)
        recons = [picture(handle["recon_dev"]) if picture else
                  handle["recon_dev"]] + recons[:nr - 1]
    acc["total"] = sum(acc.values())
    return acc


def b_stage_breakdown(enc, frames):
    """Stages of config-3 B frames: frames[0] is coded as the IDR and
    frames[-1] as the P anchor against it; each frame between is coded as
    a referenced B between the two, after one uncounted warm-up pass of
    the first."""
    import torch
    from x265amod_tpu_torch.models.mvpred import dist_scale_factor
    from x265amod_tpu_torch.ops.sao import sao_filter_frame
    enc.encode_push(*frames[0])
    ref0 = enc._dpb[0]
    pad = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
            for a, s in zip(f, (32, 16, 16))] for f in frames]
    anchor = len(frames) - 1
    ref1 = enc.inter_encoder.encode_async(*pad[anchor], ref0,
                                          enc.rc.frame_qp("P"))["recon_dev"]
    fe = enc.b_encoder
    qp = enc.rc.frame_qp("B")
    maps = fe._maps(qp)
    n = anchor - 1
    acc = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3 / n
        return t1

    # the first B frame twice: its first pass (the process's first launch
    # of each B-frame kernel loads its module) warms up and is not counted
    for rep, poc in enumerate([1] + list(range(1, anchor))):
        if rep == 1:
            acc.clear()
        dsf = (dist_scale_factor(poc, 0, anchor),
               dist_scale_factor(poc, anchor, 0))
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, cb, cr = (fe._upload(a).to(torch.int32) for a in pad[poc])
        r0 = tuple(r.to(torch.int32) for r in ref0)
        r1 = tuple(r.to(torch.int32) for r in ref1)
        t = mark("upload", t)
        st1 = fe._motion_b(y, (r0[0], r1[0]), maps)
        t = mark("me_both_lists", t)
        excess = []
        st1.update(fe._trials_b(y, (r0[0], r1[0]), maps, st1, excess))
        t = mark("trials_l0_l1_bi", t)
        oy = y.reshape(fe.h16, 16, fe.w16, 16).permute(0, 2, 1, 3)
        st1["di16"], st1["imode16"] = fe._intra_trial16(
            oy, oy.reshape(-1, 16, 16), maps["qp16"], maps["lam16"])
        t = mark("intra_trial", t)
        dec = fe._decide_b(st1, maps, dsf)
        t = mark("decide_scan", t)
        cell = fe._cell_decisions_b(dec)
        lv, rec = fe._phase3(y, cb, cr, fe._final_mc_b(r0, r1, cell, excess),
                             maps, cell)
        t = mark("final_mc_residuals", t)
        rec, lv, modes = fe._commit(y, cb, cr, maps, cell["kinds"],
                                    st1["imode16"], lv, rec)
        t = mark("commit_scan", t)
        h16, w16 = fe.h16, fe.w16
        motion = (cell["dir"].reshape(h16, w16),
                  cell["mv0"].reshape(h16, w16, 2),
                  cell["mv1"].reshape(h16, w16, 2))
        fe.sao = False
        rec, sse, _ = fe._filter_and_metrics((y, cb, cr), rec, lv,
                                             cell["kinds"], dec["split"],
                                             motion, maps, qp)
        fe.sao = True
        t = mark("deblock_and_metrics", t)
        rec, par = sao_filter_frame(y, cb, cr, *rec, maps["lam32"])
        t = mark("sao", t)
        out = dict(split=dec["split"].to(torch.int8),
                   kinds=cell["kinds"].reshape(h16, w16).to(torch.uint8),
                   merge=cell["merge"].reshape(h16, w16).to(torch.uint8),
                   dir=cell["dir"].reshape(h16, w16).to(torch.uint8),
                   mvd0=cell["mvd0"].reshape(h16, w16, 2).to(torch.int16),
                   mvp0=cell["mvp0"].reshape(h16, w16).to(torch.uint8),
                   mvd1=cell["mvd1"].reshape(h16, w16, 2).to(torch.int16),
                   mvp1=cell["mvp1"].reshape(h16, w16).to(torch.uint8),
                   modes=modes.to(torch.uint8),
                   ly=lv[0].reshape(h16, w16, 16, 16),
                   lcb=lv[1].reshape(h16, w16, 8, 8),
                   lcr=lv[2].reshape(h16, w16, 8, 8), sse=sse,
                   window_excess=torch.stack(excess).amax(),
                   **{f"sao{k}": v for k, v in enumerate(par)})
        res = fe.collect(fe._to_host(out, tuple(r.to(torch.uint8)
                                                for r in rec)))
        t = mark("d2h", t)
        enc._cabac_b_tree(res, qp)
        mark("cabac", t)
    acc["total"] = sum(acc.values())
    return acc


def la_stage_breakdown(frames):
    """The lookahead's stages per pushed frame (`Lookahead.push` taken
    apart, with a device synchronize after each stage)."""
    import torch
    from x265amod_tpu_torch.models import lookahead as la
    pad = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
            for a, s in zip(f, (32, 16, 16))] for f in frames]
    h, w = pad[0][0].shape
    look = la.Lookahead(w, h, depth=4, device="cuda")
    acc = {}
    n = len(frames)

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3 / n
        return t1

    prev = None
    for y, cb, cr in pad:
        torch.cuda.synchronize()
        t = time.perf_counter()
        planes = [look._upload(a) for a in (y, cb, cr)]
        t = mark("upload", t)
        lr, aq = la.lowres_aq(*planes, look.strength)
        t = mark("lowres_aq", t)
        icost = la.lowres_intra_cost(lr)
        t = mark("lowres_intra", t)
        inter = mv = None
        if prev is not None:
            inter, mv = la.lowres_inter_cost(lr, prev)
        prev = lr
        t = mark("lowres_me", t)
        fa = la.FrameAnalysis(
            display=look._disp, aq=aq.cpu().numpy(),
            intra_cost=icost.cpu().numpy(),
            inter_cost=None if inter is None else inter.cpu().numpy(),
            mv=None if mv is None else mv.cpu().numpy(), lowres=lr,
            dev=(icost, inter, mv))
        look._disp += 1
        t = mark("d2h_maps", t)
        fa.is_scenecut = look._decide_scenecut(fa)
        look._queue.append(fa)
        t = mark("scenecut", t)
        if len(look._queue) >= look.depth:
            look._run_cutree()
            look._queue = look._queue[1:]
        mark("cutree", t)
    acc["total"] = sum(acc.values())
    return acc


class StageTimer:
    """Wraps methods of objects so that each call runs between two device
    synchronizes and adds its host ms to a stage; nested calls count in
    the innermost stage only.  `acc` holds the sums."""

    def __init__(self):
        self.acc = {}
        self._depth = 0

    def wrap(self, obj, method, stage):
        import torch
        inner = getattr(obj, method)

        def timed(*a, **k):
            self._depth += 1
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            try:
                return inner(*a, **k)
            finally:
                torch.cuda.synchronize()
                ms = (time.perf_counter() - t0) * 1e3
                self._depth -= 1
                self.acc[stage] = self.acc.get(stage, 0.0) + ms
                self.acc["_nested"] = self.acc.get("_nested", 0.0) + (
                    ms if self._depth else 0.0)
        setattr(obj, method, timed)

    def wrap_encoder(self, enc, prefix=""):
        """The stages every config shares: the lookahead, the rate control,
        the pack + D2H start and the wait + unpack of each tree."""
        if enc.lookahead is not None:
            self.wrap(enc.lookahead, "push", prefix + "lookahead")
            self.wrap(enc.lookahead, "flush", prefix + "lookahead")
        for m in ("frame_qp", "update", "set_complexity"):
            self.wrap(enc.rc, m, prefix + "rate_control")
        for tree in (enc.frame_encoder, enc.inter_encoder, enc.b_encoder):
            if tree is None:
                continue
            self.wrap(tree, "_to_host", prefix + "level_pack_and_d2h_start")
            self.wrap(tree, "collect_batch" if hasattr(tree, "collect_batch")
                      else "collect", prefix + "d2h_wait_and_unpack")

    def per(self, n, total_ms):
        """The sums per unit (frame or batch), with the rest of the wall
        time as "other"."""
        nested = self.acc.pop("_nested", 0.0)
        out = {k: v / n for k, v in self.acc.items()}
        out["other"] = (total_ms - sum(self.acc.values()) + nested) / n
        out["total"] = total_ms / n
        return out


def ladder_stages(frames):
    """The ladder per input frame, its stages timed (see the docstring)."""
    import torch
    from x265amod_tpu_torch import abr
    from x265amod_tpu_torch.models.encoder import Encoder
    from chip_smoke import LADDER
    rungs = [abr.Rung(name, w, h, kbps, ["ctu=32", "no-info"])
             for name, w, h, kbps in LADDER]
    for r in rungs:
        r.encoder = Encoder(abr.rung_param(r, "medium", 25, 1),
                            device="cuda")
    st = StageTimer()
    for r in rungs:
        st.wrap_encoder(r.encoder, r.name + "_")
    resample = abr.resample_frame
    st.wrap(abr, "resample_frame", "resample_k16")
    for r in rungs:
        for m in ("encode_push", "flush"):
            st.wrap(r.encoder, m, r.name + "_encode")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    src_h, src_w = frames[0][0].shape
    try:
        abr.encode_ladder(rungs, frames, src_w, src_h, torch.device("cuda"))
        torch.cuda.synchronize()
    finally:
        abr.resample_frame = resample
    total = (time.perf_counter() - t0) * 1e3
    out = st.per(len(frames), total)
    out["rung_kbps"] = {r.name: r.encoder.summary()["bitrate_kbps"]
                        for r in rungs}
    return out


def vbv_stages(frames):
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from chip_smoke import config_vbv
    enc = Encoder(config_vbv(), device="cuda")
    st = StageTimer()
    st.wrap_encoder(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(enc.encode_pipelined(frames))
    torch.cuda.synchronize()
    return st.per(len(frames), (time.perf_counter() - t0) * 1e3)


def main10_stages(frames):
    import torch
    from x265amod_tpu_torch.models.encoder import Encoder
    from chip_smoke import config_main10
    enc = Encoder(config_main10(), device="cuda")
    list(enc.encode_pipelined(frames[:16]))             # warm-up batch
    st = StageTimer()
    fe = enc.frame_encoder
    for m, stage in (("_upload", "upload"), ("_estimate", "estimate"),
                     ("_commit", "commit")):
        st.wrap(fe, m, stage)
    st.wrap_encoder(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(enc.encode_pipelined(frames[16:]))
    torch.cuda.synchronize()
    return st.per(-(-len(frames[16:]) // 16),
                  (time.perf_counter() - t0) * 1e3)


def ctb16_stages(frames, lossless=False, warm=2):
    """The flat CTB16 path per frame (see the docstring)."""
    import torch
    from x265amod_tpu_torch.models import intra_frame
    from x265amod_tpu_torch.models.encoder import Encoder
    from chip_smoke import config_ctb16
    enc = Encoder(config_ctb16(lossless=lossless), device="cuda")
    list(enc.encode_pipelined(frames[:warm]))
    st = StageTimer()
    st.wrap(enc.frame_encoder, "_scan", "scan_k23")
    for fn, stage in (("deblock_frame_planes", "loop_filter_k21_k4"),
                      ("sao_filter_frame", "sao"),
                      ("frame_metrics", "sse_ssim_k22")):
        st.wrap(intra_frame, fn, stage)
    st.wrap(enc, "_cabac_intra", "cabac")
    st.wrap_encoder(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(enc.encode_pipelined(frames[warm:]))
    torch.cuda.synchronize()
    return st.per(len(frames) - warm, (time.perf_counter() - t0) * 1e3)


def flat_stages(param, frames, warm):
    """The flat CTB16 P/B path per frame (see the docstring)."""
    import torch
    from x265amod_tpu_torch.models import inter_frame
    from x265amod_tpu_torch.models.encoder import Encoder
    enc = Encoder(param, device="cuda")
    list(enc.encode_pipelined(frames[:warm]))
    st = StageTimer()
    for fe in (enc.inter_encoder, enc.b_encoder):
        if fe is None:
            continue
        for m, stage in (("_motion", "me"), ("_intra_trial", "intra_trial"),
                         ("_phase1", "phase1_all"),
                         ("_decide", "decide_scan"),
                         ("_final_mc", "final_mc"),
                         ("_final_code", "final_residuals")):
            st.wrap(fe, m, stage)
        st.wrap(fe._scan, "_scan", "commit_scan_k23")
    for fn, stage in (("deblock_frame_planes", "loop_filter_k21_k4"),
                      ("sao_filter_frame", "sao"),
                      ("frame_metrics", "sse_ssim_k22")):
        st.wrap(inter_frame, fn, stage)
    for m in ("_cabac_inter", "_cabac_b", "_cabac_intra"):
        st.wrap(enc, m, "cabac")
    st.wrap(enc.frame_encoder, "_step", "idr_step")
    st.wrap_encoder(enc)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    list(enc.encode_pipelined(frames[warm:]))
    torch.cuda.synchronize()
    return st.per(len(frames) - warm, (time.perf_counter() - t0) * 1e3)


def k23_trace(y, cb, cr, maps, enc):
    """K23's per-CTU stage stamps on one frame (`intra16_scan(trace=)`),
    as mean microseconds per CTU: waiting for the luma neighbours (from the
    ticket), reading the references, the 7 modes of a CTA (prediction,
    chain, rate, cost), the cluster barrier and the decision, writing and
    publishing the luma, the chroma CTA's wait and its Cb chain; mode 6's
    prediction, chain, rate counts and cost (the last group of the first
    CTA); the hand-off (a CTU's acquire after the last of its neighbours
    published,
    over the CTUs that had to wait), the luma step (publish to publish
    along a chain) and the span of the whole scan."""
    import torch
    from x265amod_tpu_torch.ops import commit
    f, h, w = y.shape
    hc, wc = h // 16, w // 16
    dev = y.device
    rec = tuple(torch.empty_like(t) for t in (y, cb, cr))
    lv = (torch.empty((f, hc, wc, 16, 16), dtype=torch.int16, device=dev),
          torch.empty((f, hc, wc, 8, 8), dtype=torch.int16, device=dev),
          torch.empty((f, hc, wc, 8, 8), dtype=torch.int16, device=dev))
    modes = torch.empty((f, hc, wc), dtype=torch.int32, device=dev)
    tr = torch.zeros((f * hc * wc, 12), dtype=torch.int64, device=dev)
    for _ in range(3):               # the last of three warm calls
        commit.intra16_scan((y, cb, cr), rec, lv, modes, maps, sbh=enc.sbh,
                            lossless=enc.lossless, trace=tr)
    torch.cuda.synchronize()
    t = tr.cpu().numpy().astype(np.float64).reshape(f, hc, wc, 12) / 1e3
    t -= t[..., 0].min()
    pub = t[..., 5]
    last = np.full((f, hc, wc), -np.inf)
    for dy, dx in ((0, -1), (-1, -1), (-1, 0), (-1, 1)):
        sh = np.full((f, hc, wc), -np.inf)
        ys, xs = slice(max(0, -dy), hc), slice(max(0, -dx), wc - max(0, dx))
        sh[:, ys, xs] = pub[:, max(0, -dy) + dy:hc + dy,
                            max(0, -dx) + dx:wc - max(0, dx) + dx]
        last = np.maximum(last, sh)
    waited = np.isfinite(last) & (t[..., 0] < last)
    d = np.diff(t[..., :8], axis=-1)
    sub = np.diff(t[..., [2, 8, 9, 10, 11]], axis=-1)
    return dict(
        mode6_pred=float(sub[..., 0].mean()),
        mode6_chain=float(sub[..., 1].mean()),
        mode6_rate_counts=float(sub[..., 2].mean()),
        mode6_bits_cost=float(sub[..., 3].mean()),
        wait_luma=float(d[..., 0].mean()), refs=float(d[..., 1].mean()),
        modes=float(d[..., 2].mean()), decide=float(d[..., 3].mean()),
        publish_luma=float(d[..., 4].mean()),
        wait_cb=float((t[..., 6] - t[..., 4]).mean()),
        chain_cb=float(d[..., 6].mean()),
        handoff=float((t[..., 1] - last)[waited].mean()),
        luma_step=float((pub - last)[waited].mean()),
        waited_ctus=int(waited.sum()), span=float(t[..., 5:8].max()))


def k1_k5_times(iters, dev):
    """K1 and K5 alone at the shapes where the paths spend their time (see
    the docstring), each KT_REPS times."""
    import torch
    from chip_smoke import ref_inputs
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.ops import intra, me
    rng = np.random.default_rng(1)
    out = {}

    def reps(fn):
        return [time_ms(fn, iters) for _ in range(KT_REPS)]

    def total(fns):
        per = [reps(fn) for fn in fns]
        return [sum(t) for t in zip(*per)]
    for key, f, h16, w16, bd in (("config1", 16, 24, 40, 8),
                                 ("main10", 16, 68, 120, 10)):
        sat, pre = [], []
        for n, b in ((16, f * h16 * w16), (32, f * h16 * w16 // 4)):
            maxv = (1 << bd) - 1
            refs = ref_inputs(rng, b, n, dev, maxv)
            orig = torch.as_tensor(rng.integers(0, maxv + 1, (b, n, n))
                                   .astype(np.int32), device=dev)
            modes = torch.as_tensor(rng.integers(0, 35, (b, 4))
                                    .astype(np.int32), device=dev)
            sat.append(lambda o=orig, r=refs, n=n, bd=bd: intra.satd35(
                o, *r, n, 0, bit_depth=bd))
            pre.append(lambda r=refs, m=modes, n=n, bd=bd: intra.predict(
                *r, m, n, 0, bit_depth=bd))
        out[f"k1_satd35_{key}"] = total(sat)
        out[f"k1_predict_{key}"] = total(pre)
    # the lookahead's lowres blocks (960x544: 120 x 68 blocks of 8x8)
    refs = ref_inputs(rng, 8160, 8, dev)
    orig = torch.as_tensor(rng.integers(0, 256, (8160, 8, 8)).astype(
        np.int32), device=dev)
    out["k1_satd35_lowres"] = reps(lambda: intra.satd35(orig, *refs, 8, 0))
    # the flat intra trial: 8160 CU16s x 35 modes
    refs = ref_inputs(rng, 8160, 16, dev)
    modes = torch.arange(35, dtype=torch.int32, device=dev)[None] \
        .expand(8160, 35).contiguous()
    out["k1_predict_flat_trial"] = reps(
        lambda: intra.predict(*refs, modes, 16, 0))
    torch.cuda.empty_cache()

    # K5: config 2's four grids (1280x736, sr 8), the flat P grid and a
    # config-3 B frame's four grids per reference (1920x1088, sr 16)
    def grids(w, h, seed, sr, shapes):
        src = [torch.as_tensor(_pad_to_ctu(x[0], 32).astype(np.int32),
                               device=dev)
               for x in synth_frames(w, h, 2, seed=seed)]
        ref, cur = src
        hp = me.hpel_plane(ref)
        fns = []
        for bn, half in shapes:
            hh, ww = cur.shape
            cb = cur.reshape(hh // bn, bn, ww // bn, bn) \
                .permute(0, 2, 1, 3).reshape(-1, bn, bn).contiguous()
            fns.append(lambda cb=cb, p=hp if half else ref, bn=bn:
                       me.me_ssd_grid(cb, p, sr, bn))
        return total(fns)
    four = ((16, False), (16, True), (32, False), (32, True))
    out["k5_sr8_config2"] = grids(1280, 720, 2, 8, four)
    out["k5_sr16_flat_p"] = grids(1920, 1080, 22, 16, ((16, False),))
    out["k5_sr16_b_frame_per_ref"] = grids(1920, 1080, 4, 16, four)
    return out


def k3_k24_times(iters, dev, groups):
    """K24 and K3 (as ``groups`` names them) alone at the shapes where the
    paths spend their time (see the docstring), each KT_REPS times."""
    import torch
    import x265amod_tpu_torch.models.inter_frame as mif
    from chip_smoke import flat_inter_inputs, traced_tu_bits
    from x265amod_tpu_torch.ops import decide_flat, estbits, residual
    out = {}

    def reps(fn):
        return [time_ms(fn, iters) for _ in range(KT_REPS)]
    # the flat P frame of chip_smoke phase 2 (1920x1088, sr 16, QP 32)
    w, h, recon, cur = flat_inter_inputs(dev)
    enc = mif.InterFrameEncoder(w, h, device=dev)
    maps = enc._maps(32)
    lam = maps["lam"].reshape(-1)
    st1, calls = traced_tu_bits(mif, lambda: enc._phase1(
        cur[0], recon[0][0], maps))
    args = (enc.sch, st1["grid"], st1["d"], st1["rb"], st1["di"],
            st1["mv_me"], lam, enc.sr, enc.hdr_bits)
    if "k24" in groups:
        out["k24_flat_p_1080p"] = reps(lambda: decide_flat.decide_p(*args))
        out["k24_flat_p_1080p_l2_cold"] = [
            time_cold_ms(lambda: decide_flat.decide_p(*args), iters)
            for _ in range(KT_REPS)]
        dec = decide_flat.decide_p(*args)
        forced = (dec["choice"], dec["mvd"], dec["mvp"])
        fargs = args[:1] + (None,) * 5 + args[6:]
        out["k24_flat_p_1080p_forced"] = reps(
            lambda: decide_flat.decide_p(*fargs, forced=forced))
    if "k3" not in groups:
        return out
    for a, k in calls:
        key = ("k3_flat_intra_trial" if a[0].dim() == 4
               else "k3_flat_inter_trial")
        out[key] = reps(lambda a=a, k=k: estbits.tu_bits(*a, **k))
    del st1, calls, args
    # the estimate's four calls of a config-1 and a Main10 batch, on the
    # levels of K2 at random predictions (K2's keys' inputs)
    rng = np.random.default_rng(1)
    for key, f, h16, w16, bd in (("k3_config1", 16, 24, 40, 8),
                                 ("k3_main10", 16, 68, 120, 10)):
        b16, b32 = f * h16 * w16, f * h16 * w16 // 4
        fns = []
        for n, b, k, c_idx in ((16, b16, 4, 0), (8, 2 * b16, 1, 1),
                               (32, b32, 4, 0), (16, 2 * b32, 1, 1)):
            maxv = (1 << bd) - 1
            orig = rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32)
            pred = np.clip(orig[:, None] + rng.integers(
                -40, 41, (b, k, n, n)) * (maxv // 255), 0, maxv)
            o, p_ = (torch.as_tensor(v.astype(np.int32), device=dev)
                     for v in (orig, pred))
            q = torch.as_tensor(rng.choice([22, 27, 30], b).astype(
                np.int32), device=dev)
            lv = residual.residual_chain(o, p_, q, False, want_recon=False,
                                         bit_depth=bd)[0]
            qk = q[:, None].expand(b, k)
            fns.append(lambda lv=lv, c=c_idx, qk=qk: estbits.tu_bits(
                lv, c, qk))
        per = [reps(fn) for fn in fns]
        out[key] = [sum(t) for t in zip(*per)]
    torch.cuda.empty_cache()
    return out


def k19_k25_times(iters, dev, w=1920, h=1080):
    """K25 and K19 alone (see the docstring), each KT_REPS times: free,
    replaying their own decisions, and free with L2 flushed before each
    call; at w x h (the keys name 1080p)."""
    import torch
    from chip_smoke import flat_inter_inputs
    from x265amod_tpu_torch.models.b_frame import BFrameEncoder
    from x265amod_tpu_torch.models.encoder import Encoder, _pad_to_ctu
    from x265amod_tpu_torch.models.mvpred import dist_scale_factor
    from x265amod_tpu_torch.ops import decide_flat
    out = {}

    def keys(name, run, run_forced):
        out[name] = [time_ms(run, iters) for _ in range(KT_REPS)]
        out[name + "_l2_cold"] = [time_cold_ms(run, iters)
                                  for _ in range(KT_REPS)]
        out[name + "_forced"] = [time_ms(run_forced, iters)
                                 for _ in range(KT_REPS)]
    # K25: the flat B frame of chip_smoke phase 2 (1920x1088, POC 1 between
    # the IDR recons of frames 0 and 2, sr 16, QP 32)
    fw, fh, recon, cur = flat_inter_inputs(dev, w, h)
    enc = BFrameEncoder(fw, fh, device=dev)
    maps = enc._maps(32)
    lam = maps["lam"].reshape(-1)
    dsf = (dist_scale_factor(1, 0, 2), dist_scale_factor(1, 2, 0))
    st1 = enc._phase1(cur[0], (recon[0][0], recon[1][0]), maps, [])
    args = (enc.sch, st1["grids"], st1["d"], st1["rb"], st1["di"],
            st1["mv_me"], lam, enc.sr, dsf, enc.hdr_bits)
    dec = decide_flat.decide_b(*args)
    forced = tuple(dec[k] for k in ("choice", "mvd0", "mvp0", "mvd1",
                                    "mvp1"))
    fargs = args[:1] + (None,) * 5 + args[6:]
    keys("k25_flat_b_1080p", lambda: decide_flat.decide_b(*args),
         lambda: decide_flat.decide_b(*fargs, forced=forced))
    del st1, args, dec
    # K19: config 3's first mini-GOP's POC 2 (chip_smoke phase 2's frame:
    # 1920x1088, sr 16, between the card's recons of the IDR and the P
    # anchor, dsf -256 both ways)
    frames = synth_frames(w, h, 5, seed=4)
    cenc = Encoder(config3(w, h), device=dev)
    for fr in frames[:4]:
        cenc.encode_push(*fr)
    refs0 = tuple(t.to(torch.int32) for t in cenc._dpb[0])
    cenc.encode_push(*frames[4])
    refs1 = tuple(t.to(torch.int32) for t in cenc._dpb[4])
    tree = cenc.b_encoder
    tmaps = tree._maps(33)
    y = torch.as_tensor(_pad_to_ctu(frames[2][0], 32),
                        device=dev).to(torch.int32)
    bdsf = (dist_scale_factor(2, 0, 4), dist_scale_factor(2, 4, 0))
    bst1 = tree._phase1_b(y, (refs0[0], refs1[0]), tmaps, [])
    want = tree._decide_b_kernel(bst1, tmaps, bdsf)
    cells = tree._cell_decisions_b(want)
    kinds = cells["kinds"]
    choice = torch.where(kinds == 0, cells["merge"], torch.where(
        kinds == 1, 1 + cells["dir"].long(), 5))
    c16 = (choice, cells["mvd0"], cells["mvp0"], cells["mvd1"],
           cells["mvp1"])
    bforced = dict(c16=c16, c32=[v[tree._q0_cell] for v in c16],
                   split=want["split"].reshape(-1))
    keys("k19_config3_b_1080p",
         lambda: tree._decide_b_kernel(bst1, tmaps, bdsf),
         lambda: tree._decide_b_kernel(None, tmaps, bdsf, forced=bforced))
    torch.cuda.empty_cache()
    return out


def k6_k17_times(iters, dev):
    """K17 and K6 alone (see the docstring), each KT_REPS times: warm and
    with L2 flushed before each call (K17 also replaying its own
    decisions)."""
    import torch
    import x265amod_tpu_torch.models.inter_tree as mit
    from chip_smoke import MULTIREF, check_decide, k6_flat_p_args
    from x265amod_tpu_torch.models.encoder import Encoder, _pad_to_ctu
    from x265amod_tpu_torch.ops import me
    out = {}

    def reps(key, fn):
        out[key] = [time_ms(fn, iters) for _ in range(KT_REPS)]
        out[key + "_l2_cold"] = [time_cold_ms(fn, iters)
                                 for _ in range(KT_REPS)]
        out[key + "_device"] = [time_queued_ms(fn, iters)
                                for _ in range(KT_REPS)]

    def phase1_k6(tree, y, refs, maps, tables):
        """The tree's phase 1 with its K6 calls' arguments recorded."""
        calls, inner = [], mit.subpel_refine

        def spy(*a):
            calls.append(a)
            return inner(*a)
        mit.subpel_refine = spy
        try:
            st1 = tree._phase1(y, refs, maps, tables)
        finally:
            mit.subpel_refine = inner
        return st1, calls

    def k17(key, tree, st1, maps, tables):
        forced = check_decide(tree, st1, maps, tables, key)[1]
        reps(key, lambda: tree._decide_kernel(st1, maps, tables))
        for t, name in ((time_ms, "_forced"), (time_queued_ms,
                                               "_forced_device")):
            out[key + name] = [t(lambda: tree._decide_kernel(
                None, maps, tables, forced=forced), iters)
                for _ in range(KT_REPS)]

    # config 2 (chip_smoke phase 2's P frame: frame 4 of the bench clip at
    # 1280x736, sr 8, against the card's recons of frames 1-3), R 1 and 3
    frames = synth_frames(1280, 720, 5, seed=2)
    enc = Encoder(config2_ref(MULTIREF), device=dev)
    for fr in frames[:4]:
        enc.encode_push(*fr)
    tree = enc.inter_encoder
    pocs = sorted(enc._dpb, reverse=True)
    y = torch.as_tensor(_pad_to_ctu(frames[4][0], 32), device=dev) \
        .to(torch.int32)
    maps = tree._maps(32)
    for nr in (1, MULTIREF):
        refs, tables = tree._ref_list([enc._dpb[p] for p in pocs[:nr]],
                                      pocs[:nr], 4)
        st1, calls = phase1_k6(tree, y, refs[0], maps, tables)
        k17(f"k17_config2_720p_r{nr}", tree, st1, maps, tables)
        if nr == 1:
            reps("k6_config2_720p", lambda: [me.subpel_refine(*a)
                                             for a in calls])
    del enc, tree, st1, calls
    # config 3's first P anchor (1920x1088, sr 16, R 1, against the card's
    # recon of the IDR): K17 and its K6 call at n 32
    frames = synth_frames(1920, 1080, 5, seed=4)
    enc = Encoder(config3(), device=dev)
    enc.encode_push(*frames[0])
    tree = enc.inter_encoder
    poc = enc.bframes + 1
    y = torch.as_tensor(_pad_to_ctu(frames[poc][0], 32), device=dev) \
        .to(torch.int32)
    refs, tables = tree._ref_list([enc._dpb[0]], [0], poc)
    maps = tree._maps(32)
    st1, calls = phase1_k6(tree, y, refs[0], maps, tables)
    k17("k17_config3_p_1080p", tree, st1, maps, tables)
    a32 = next(a for a in calls if a[4] == 32)
    reps("k6_1080p_n32", lambda: me.subpel_refine(*a32))
    del enc, tree, st1, calls
    # the flat P frame's call (chip_smoke phase 2's: 1920x1088, n 16)
    args = k6_flat_p_args(dev)
    reps("k6_flat_p_1080p_n16", lambda: me.subpel_refine(*args, 16))
    torch.cuda.empty_cache()
    return out


def k7_k21_times(iters, dev):
    """K7 and K21 alone (see the docstring), each KT_REPS times: back to
    back, with L2 flushed before each call and queued behind a spin of the
    card (`_device`)."""
    import torch
    from chip_smoke import K21_CASES, k21_case, k7_flat_inputs, window_mvs
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.ops import deblock, me
    out = {}

    def reps(key, fn):
        out[key] = [time_ms(fn, iters) for _ in range(KT_REPS)]
        out[key + "_l2_cold"] = [time_cold_ms(fn, iters)
                                 for _ in range(KT_REPS)]
        out[key + "_device"] = [time_queued_ms(fn, iters)
                                for _ in range(KT_REPS)]

    a = k7_flat_inputs(dev)
    reps("k7_flat_1080p_luma16",
         lambda: me.mc_luma_qpel(a["y0"], a["mv0"], 16))
    reps("k7_flat_1080p_chroma8",
         lambda: me.mc_chroma_qpel(a["c0"], a["mv0"], 8))

    # a copy of the same bytes (the plane read, an output of its size
    # written: both equal the call's, 1920x1088 and 8160 x 16^2; 960x544
    # and 8160 x 8^2): what a launch that only moves them takes
    for key, src in (("luma16", a["y0"]), ("chroma8", a["c0"])):
        dst = torch.empty_like(src)
        reps(f"k7_copy_flat_1080p_{key}", lambda: dst.copy_(src))
    # a flat B frame's whole final MC: K9 and K7 on the three planes
    refs0, refs1 = (a["y0"], a["c0"], a["c0"]), (a["y1"], a["c1"], a["c1"])
    reps("k7_mc_select_flat_b_1080p", lambda: me.mc_select(
        refs0, refs1, a["dir"], a["mv0"], a["mv1"], 16, []))
    # config 2's five calls (chip_smoke phase 2's shapes: 1280x736, sr 8)
    y = torch.as_tensor(_pad_to_ctu(synth_frames(1280, 720, 1, seed=2)[0][0],
                                    32), device=dev).to(torch.int32)
    c = y[::2, ::2].contiguous()
    rng = np.random.default_rng(7)
    five = []
    for plane, n, chroma, unit, m in ((y, 16, False, 4, 10),
                                      (y, 32, False, 4, 10),
                                      (y, 16, False, 4, 10),
                                      (c, 8, True, 8, 6), (c, 8, True, 8, 6)):
        ph, pw = plane.shape
        mv = torch.as_tensor(window_mvs(rng, (ph // n) * (pw // n), pw // n,
                                        unit, m), device=dev)
        five.append((me.mc_chroma_qpel if chroma else me.mc_luma_qpel,
                     plane, mv, n))
    reps("k7_config2_five", lambda: [fn(p, mv, n) for fn, p, mv, n in five])
    # K21 at phase 2's shapes (chip_smoke.K21_CASES, the same seed)
    rng = np.random.default_rng(21)
    for key, f, h, w, kind in K21_CASES:
        lv, qp_sig, split, inter = k21_case(rng, f, h, w, kind, dev)
        name = f"k21{key or '_config1_batch'}"
        reps(name, lambda: deblock.deblock_maps(lv, 30, qp_sig, split,
                                                 inter))
        # the two launches apart: torch.profiler's device ms a call of each
        prof = device_profile(lambda: [deblock.deblock_maps(
            lv, 30, qp_sig, split, inter) for _ in range(iters)], iters)
        out[name + "_split"] = {t["name"]: t["ms"] / t["calls"]
                                for t in prof["top"]}
    # an empty launch (a spin of 0 cycles) queued: the floor of a launch
    reps("launch_floor", lambda: torch.cuda._sleep(0))
    torch.cuda.empty_cache()
    return out


def k9_k10_times(iters, dev):
    """K9, K10 and K11 alone (see the docstring), each KT_REPS times: back
    to back, with L2 flushed before each call and queued behind a spin of
    the card (`_device`).  An entry the imported tree lacks (K10's frame
    entry, the select entry without bi rows) is left out."""
    import torch
    from chip_smoke import k7_flat_inputs, sao_inputs, window_mvs
    from x265amod_tpu_torch.ops import me, sao
    out = {}

    def reps(key, fn):
        out[key] = [time_ms(fn, iters) for _ in range(KT_REPS)]
        out[key + "_l2_cold"] = [time_cold_ms(fn, iters)
                                 for _ in range(KT_REPS)]
        out[key + "_device"] = [time_queued_ms(fn, iters)
                                for _ in range(KT_REPS)]

    a = k7_flat_inputs(dev)
    # the window excess is appended, not read: no wait on the card
    reps("k9_flat_1080p_luma16", lambda: me.mc_bi(
        a["y0"], a["y1"], a["mv0"], a["mv1"], 16, False, 18, []))
    reps("k9_flat_1080p_chroma8", lambda: me.mc_bi(
        a["c0"], a["c1"], a["mv0"], a["mv1"], 8, True, 10, []))
    # a config-3 B frame's two trial calls (bn 16 and 32, sr 16)
    rng = np.random.default_rng(9)
    h, w = a["y0"].shape
    mv32 = [torch.as_tensor(window_mvs(rng, (h // 32) * (w // 32), w // 32,
                                       4, 18), device=dev)
            for _ in range(2)]
    reps("k9_config3_trials", lambda: (
        me.mc_bi(a["y0"], a["y1"], a["mv0"], a["mv1"], 16, False, 18, []),
        me.mc_bi(a["y0"], a["y1"], *mv32, 32, False, 18, [])))
    # a flat B frame's whole final MC: with K9's rows copied (K9 a plane,
    # then K7's select entry) and, where the tree has it, without (K7's
    # select entry alone, one launch a plane)
    planes = ((a["y0"], a["y1"], 16, False, 18),
              (a["c0"], a["c1"], 8, True, 10),
              (a["c0"], a["c1"], 8, True, 10))

    def final_mc(fold):
        for r0, r1, n, ch, mm in planes:
            bi = None if fold else me.mc_bi(r0, r1, a["mv0"], a["mv1"], n,
                                            ch, mm, [])
            me.mc_qpel_sel(r0, r1, a["mv0"], a["mv1"], a["dir"], n, ch, bi,
                           *((mm, []) if fold else ()))
    reps("k9_final_mc_flat_b_1080p_copy", lambda: final_mc(False))
    if "max_mv" in inspect.signature(me.mc_qpel_sel).parameters:
        reps("k9_final_mc_flat_b_1080p_fold", lambda: final_mc(True))
    # K10 and K11 at a config-3 B frame's shapes (CTU 32) and a flat CTB16
    # frame's (CTU 16), chip_smoke's planes
    (oy, ry), (ocb, rcb), (ocr, rcr), lam = sao_inputs(dev)
    for key, ctu in (("config3_b_frame", 32), ("flat_1080p", 16)):
        la = lam[ctu]
        reps(f"k10_{key}_two_entries", lambda: (
            sao.sao_analyse(oy, ry, la, ctu),
            sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, la, ctu // 2)))
        if hasattr(sao, "sao_analyse_frame"):
            reps(f"k10_{key}", lambda: sao.sao_analyse_frame(
                oy, ocb, ocr, ry, rcb, rcr, la, ctu))
        ly = sao.sao_analyse(oy, ry, la, ctu)
        lc = sao.sao_analyse_chroma(ocb, rcb, ocr, rcr, la, ctu // 2)
        calls = ((ry, ly[:4], ctu), (rcb, lc[:4], ctu // 2),
                 (rcr, (lc[0], lc[1], lc[4], lc[5]), ctu // 2))
        reps(f"k11_{key}_three", lambda: [sao.sao_apply(r, *p, c)
                                          for r, p, c in calls])
    torch.cuda.empty_cache()
    return out


def k13_argmin_times(iters, dev):
    """K13 and K5 with the ME argmin (see the docstring), each KT_REPS
    times: back to back, with L2 flushed before each call and queued
    behind a spin of the card (`_device`).  A tree without the fold runs K5
    then its argmin kernel."""
    import torch
    from x265amod_tpu_torch.models import lookahead as la
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.ops import me
    from x265amod_tpu_torch.utils.lambdas import lambda2_of
    out = {}

    def reps(key, fn):
        out[key] = [time_ms(fn, iters) for _ in range(KT_REPS)]
        out[key + "_l2_cold"] = [time_cold_ms(fn, iters)
                                 for _ in range(KT_REPS)]
        out[key + "_device"] = [time_queued_ms(fn, iters)
                                for _ in range(KT_REPS)]

    f0, f1 = synth_frames(1920, 1088, 2, seed=6)
    lr, prev = (la.lowres_half(torch.as_tensor(f[0], device=dev))
                for f in (f0, f1))
    reps("k13_lookahead_1080p", lambda: la.lowres_inter_cost(lr, prev))
    if hasattr(me, "me_ssd_grid_mv"):
        k5_argmin = me.me_ssd_grid_mv
    else:
        def k5_argmin(cur, ref, sr, bn, lam):
            return me.int_mv_argmin(me.me_ssd_grid(cur, ref, sr, bn), lam,
                                    sr)
    for key, w, h, sr, bns, seed in (("flat_1080p", 1920, 1080, 16, (16,),
                                      22),
                                     ("config2", 1280, 720, 8, (16, 32), 2)):
        fr = synth_frames(w, h, 2, seed=seed)
        ref, cur_p = (torch.as_tensor(_pad_to_ctu(x[0], 32), device=dev)
                      .to(torch.int32) for x in fr)
        calls = []
        for bn in bns:
            hh, ww = cur_p.shape
            cur = cur_p.reshape(hh // bn, bn, ww // bn, bn).permute(
                0, 2, 1, 3).reshape(-1, bn, bn).contiguous()
            lam = torch.as_tensor(lambda2_of(np.full(
                cur.shape[0], 32)).astype(np.float32), device=dev)
            calls.append((cur, bn, lam))
        reps(f"k5_argmin_{key}", lambda: [k5_argmin(cur, ref, sr, bn, lam)
                                          for cur, bn, lam in calls])
    torch.cuda.empty_cache()
    return out


def k22_k8_times(iters, dev):
    """K22 and K8 alone (see the docstring), each KT_REPS times: back to
    back, with L2 flushed before each call and queued behind a spin of the
    card (`_device`); `F.conv2d` of K8's 8x8 kernel the same three ways."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import K21_CASES
    from x265amod_tpu_torch.ops import me, metrics
    out = {}

    def reps(key, fn):
        out[key] = [time_ms(fn, iters) for _ in range(KT_REPS)]
        out[key + "_l2_cold"] = [time_cold_ms(fn, iters)
                                 for _ in range(KT_REPS)]
        out[key + "_device"] = [time_queued_ms(fn, iters)
                                for _ in range(KT_REPS)]

    # K22 at chip_smoke phase 2's four shapes, its planes made the same way
    rng = np.random.default_rng(21)
    for key, f, h, w, _ in K21_CASES:
        src = tuple(torch.as_tensor(rng.integers(0, 256, s).astype(np.int32),
                                    device=dev)
                    for s in ((f, h, w), (f, h // 2, w // 2),
                              (f, h // 2, w // 2)))
        rec = tuple(torch.clamp(t + torch.as_tensor(rng.integers(
            -6, 7, t.shape).astype(np.int32), device=dev), 0, 255)
            for t in src)
        reps(f"k22{key or '_config1_batch'}",
             lambda: metrics.frame_metrics(src, rec))
    # K8 at config 2's reference and at 1080p, on the bench clip
    kern = torch.as_tensor(np.outer(me.LUMA_FILTERS[2], me.LUMA_FILTERS[2])
                           .astype(np.float32), device=dev)[None, None]
    for key, w, h, seed in (("config2_720p", 1280, 736, 2),
                            ("1080p", 1920, 1088, 4)):
        ref = torch.as_tensor(synth_frames(w, h, 1, seed=seed)[0][0],
                              device=dev).to(torch.int32)
        reps(f"k8_{key}", lambda: me.hpel_plane(ref))
        padded = F.pad(ref.float()[None, None], (3, 4, 3, 4),
                       mode="replicate")
        reps(f"conv2d_k8_{key}", lambda: F.conv2d(padded, kern))
    torch.cuda.empty_cache()
    return out


# the kernel groups of "13", each timed by its own part of kernel_times
KERNEL_GROUPS = ("k1k5", "k24", "k3", "k23", "k2k20", "k19k25", "k6k17",
                 "k7k21", "k9k10", "k13am", "k22k8")


def kernel_times(iters, groups=KERNEL_GROUPS):
    """K1, K5, K24, K3, K23, K2, K20, K19 and K25 alone at the main path's
    shapes (see the docstring), the groups named in ``groups``."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    dev = torch.device("cuda")
    out = {}
    if "k1k5" in groups:
        out.update(k1_k5_times(iters, dev))
    if "k24" in groups or "k3" in groups:
        out.update(k3_k24_times(iters, dev, groups))
    if "k19k25" in groups:
        out.update(k19_k25_times(iters, dev))
    if "k6k17" in groups:
        out.update(k6_k17_times(iters, dev))
    if "k7k21" in groups:
        out.update(k7_k21_times(iters, dev))
    if "k9k10" in groups:
        out.update(k9_k10_times(iters, dev))
    if "k13am" in groups:
        out.update(k13_argmin_times(iters, dev))
    if "k22k8" in groups:
        out.update(k22_k8_times(iters, dev))

    def planes(w, h, n, seed):
        fr = synth_frames(w, h, n, seed=seed)
        return tuple(torch.stack([torch.as_tensor(
            _pad_to_ctu(x[k], 16 if k == 0 else 8), device=dev)
            for x in fr]).to(torch.int32) for k in range(3))
    if "k23" in groups:
        out.update(k23_times(iters, dev, planes))
    if "k2k20" in groups:
        out.update(k2_k20_times(iters, dev))
    return out


def k23_times(iters, dev, planes):
    """K23 alone (see the docstring)."""
    import torch
    from x265amod_tpu_torch.models.intra_frame import IntraFrameEncoder
    from x265amod_tpu_torch.ops import commit
    out = {}
    y, cb, cr = planes(1920, 1080, 1, 19)
    for key, lossless in (("k23_1080p", False), ("k23_lossless", True)):
        enc = IntraFrameEncoder(1920, 1088, lossless=lossless, device=dev)
        maps = enc._maps(32)
        out[key] = time_ms(lambda: enc._scan_kernel(y, cb, cr, maps),
                           iters)
    enc = IntraFrameEncoder(1920, 1088, device=dev)
    maps = enc._maps(32)
    # an earlier tree's K23 (--root) may take no stamps
    if "trace" in inspect.signature(commit.intra16_scan).parameters:
        out["k23_1080p_stages_us"] = k23_trace(y, cb, cr, maps, enc)
    kinds = torch.zeros((1, 68, 120), dtype=torch.int32, device=dev)
    kinds[0, 27:41, 48:72] = 2
    rng = np.random.default_rng(5)
    rec = tuple(torch.clamp(t + torch.as_tensor(rng.integers(
        -9, 10, t.shape).astype(np.int32), device=dev), 0, 255)
        for t in (y, cb, cr))
    lv = tuple(torch.as_tensor(rng.integers(-3, 4, s).astype(np.int16),
                               device=dev)
               for s in ((1, 68, 120, 16, 16), (1, 68, 120, 8, 8),
                         (1, 68, 120, 8, 8)))
    out["k23_commit_patch336"] = time_ms(lambda: enc._scan_kernel(
        y, cb, cr, maps, (kinds, tuple(t.clone() for t in rec),
                          tuple(t.clone() for t in lv), "P")), iters)
    yb, cbb, crb = planes(640, 360, 16, 3)
    benc = IntraFrameEncoder(640, 368, device=dev)
    bmaps = benc._maps(32)
    out["k23_batch16_640x368"] = time_ms(
        lambda: benc._scan_kernel(yb, cbb, crb, bmaps), iters)
    return out


def k2_k20_times(iters, dev):
    """K2 and K20 alone (see the docstring)."""
    import torch
    from x265amod_tpu_torch.models.encoder import _pad_to_ctu
    from x265amod_tpu_torch.ops import residual
    out = {}
    # K2: a config-1 batch's calls, the flat intra trial, a Main10 batch's
    rng = np.random.default_rng(1)
    for key, f, h16, w16, bd in (("k2_config1", 16, 24, 40, 8),
                                 ("k2_main10", 16, 68, 120, 10)):
        b16, b32 = f * h16 * w16, f * h16 * w16 // 4
        total = 0.0
        for n, b, k in ((16, b16, 4), (8, 2 * b16, 1), (32, b32, 4),
                        (16, 2 * b32, 1)):
            maxv = (1 << bd) - 1
            orig = rng.integers(0, maxv + 1, (b, n, n)).astype(np.int32)
            pred = np.clip(orig[:, None] + rng.integers(
                -40, 41, (b, k, n, n)) * (maxv // 255), 0, maxv)
            o, p_ = (torch.as_tensor(a.astype(np.int32), device=dev)
                     for a in (orig, pred))
            q = torch.as_tensor(rng.choice([22, 27, 30], b).astype(
                np.int32), device=dev)
            total += time_ms(lambda: residual.residual_chain(
                o, p_, q, False, want_recon=k == 1, bit_depth=bd), iters)
        out[key] = total
    orig = torch.as_tensor(_pad_to_ctu(synth_frames(1920, 1080, 1, 22)[0][0],
                                       16).astype(np.int32), device=dev)
    o = orig.reshape(68, 16, 120, 16).permute(0, 2, 1, 3).reshape(-1, 16, 16)
    o = o.contiguous()
    p_ = torch.clamp(o[:, None] + torch.as_tensor(rng.integers(
        -30, 31, (8160, 35, 16, 16)).astype(np.int32), device=dev), 0, 255)
    q = torch.full((8160,), 32, dtype=torch.int32, device=dev)
    out["k2_flat_intra_trial"] = time_ms(lambda: residual.residual_chain(
        o, p_, q, False, want_recon=False), iters)
    # K20: the intra tree's commit of a config-1 batch and a Main10 batch
    from chip_smoke import synth_frames10
    from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
    for key, w, h, bd in (("k20_config1", 640, 360, 8),
                          ("k20_main10", 1920, 1080, 10)):
        fr = synth_frames(w, h, 16) if bd == 8 else synth_frames10(w, h, 16)
        y, cb, cr = (torch.stack([torch.as_tensor(_pad_to_ctu(
            x[k].view(np.int16) if bd == 10 else x[k], 32 if k == 0 else 16),
            device=dev) for x in fr]).to(torch.int32) for k in range(3))
        itree = IntraTreeEncoder(y.shape[2], y.shape[1], deblock=bd == 8,
                                 device=dev, bit_depth=bd)
        imaps = itree._maps(30)
        split, modes = itree._estimate(y, cb, cr, imaps)
        out[key] = time_ms(lambda: itree._commit_kernel(
            y, cb, cr, imaps, split, modes), iters)
    return out


def e2e_fps():
    """fps of chip_smoke phases 19, 20 and 22 (see the docstring)."""
    import torch
    from chip_smoke import (CTB16_FRAMES, CTB16_WARM, FLAT_P_FRAMES,
                            FLAT_P_WARM, LOSSLESS_FRAMES, LOSSLESS_WARM,
                            config_ctb16, config_flat_p)
    from x265amod_tpu_torch.models.encoder import Encoder
    cframes = synth_frames(1920, 1080, CTB16_FRAMES, seed=19)
    pframes = synth_frames(1920, 1080, FLAT_P_FRAMES, seed=22)
    runs = (("ctb16", config_ctb16(), cframes, CTB16_WARM),
            ("lossless", config_ctb16(lossless=True),
             cframes[:LOSSLESS_FRAMES], LOSSLESS_WARM),
            ("flat_p", config_flat_p(), pframes, FLAT_P_WARM))
    out = {key: [] for key, *_ in runs}
    for _ in range(E2E_REPS):
        for key, param, frames, warm in runs:
            enc = Encoder(param, device="cuda")
            for _ in enc.encode_pipelined(frames[:warm]):
                pass
            torch.cuda.synchronize()
            t0 = time.time()
            n = len(list(enc.encode_pipelined(
                frames[warm:], return_recon=key == "lossless")))
            out[key].append(n / (time.time() - t0))
    return out


def add_fold_tail(kind):
    """Enqueue ``kind`` after each folded K5 launch of the flat P/B
    frames' ME (`models/inter_frame.py:_motion`): "launch", a one-element
    fill; "read", a max over the grid.  A tree without the fold is left as
    it is."""
    import torch
    from x265amod_tpu_torch.models import inter_frame
    if kind == "none" or not hasattr(inter_frame, "me_ssd_grid_mv"):
        return
    fold = inter_frame.me_ssd_grid_mv
    one = torch.zeros(1, device="cuda")

    def tailed(cur, ref, sr, bn, lam):
        grid, mv = fold(cur, ref, sr, bn, lam)
        if kind == "launch":
            one.zero_()
        else:
            grid.amax()
        return grid, mv
    inter_frame.me_ssd_grid_mv = tailed


def device_profile(run, n_frames, top=12):
    """torch.profiler over ``run()``: wall time, device kernel time, the
    device busy share and the ``top`` kernels with the most device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    dev_total = 0.0
    for ev in prof.key_averages():
        # device kernels only: an aten op also reports its kernel's time
        if "CUDA" not in str(ev.device_type):
            continue
        us = ev.self_device_time_total
        if us > 0:
            dev_total += us
            rows.append((us, ev.key, ev.count))
    rows.sort(reverse=True)
    return dict(frames=n_frames, wall_ms=wall,
                device_kernel_ms=dev_total / 1e3,
                device_busy_share=dev_total / 1e3 / wall,
                top=[dict(name=k[:80], ms=us / 1e3, calls=c)
                     for us, k, c in rows[:top]])


# the output lines --summarize reads: their numbers (ms or shares) are
# better lower, e2e_fps's higher
SUMMARIZED = ("kernel_times", "e2e_fps", "profile", "p_stages", "p_profile",
              "p_profile_ref3", "b_stages", "b_profile", "flat_b_stages",
              "flat_b_profile")


def summarize(paths, parent_root):
    """Medians and spreads of the numbers of the `SUMMARIZED` lines in the
    files ``paths`` (a profile's: its wall and device kernel ms and busy
    share), split by tree: the lines whose root is ``parent_root`` against
    the others.  A gain is "faster" only where every change run beats every
    parent run, "slower" where every parent run beats every change run,
    otherwise "unresolved"."""
    runs = {}
    for path in paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line.startswith("{"):
                    continue
                rec = json.loads(line)
                for kind in SUMMARIZED:
                    if kind not in rec:
                        continue
                    tree = ("parent" if rec[kind].get("root") == parent_root
                            else "change")
                    for key, v in rec[kind].items():
                        if isinstance(v, (int, float)):
                            v = [v]
                        if isinstance(v, list) and all(
                                isinstance(x, (int, float)) for x in v):
                            runs.setdefault((kind, key), {}).setdefault(
                                tree, []).extend(v)
    out = {}
    for (kind, key), trees in sorted(runs.items()):
        row = {tree: dict(median=float(np.median(v)), min=min(v),
                          max=max(v), n=len(v))
               for tree, v in trees.items()}
        if len(trees) == 2:
            p, c = trees["parent"], trees["change"]
            if kind == "e2e_fps":
                p, c = [-x for x in p], [-x for x in c]
            row["verdict"] = ("faster" if max(c) < min(p) else "slower"
                              if max(p) < min(c) else "unresolved")
        out[f"{kind}.{key}"] = row
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs",
                    default="1,2,3,4,5,6,7,8,9,10,11,12,13,14")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--p-frames", type=int, default=4)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--root", default=None,
                    help="import the port package from this tree")
    ap.add_argument("--kernels", default=",".join(KERNEL_GROUPS),
                    help="the kernel groups \"13\" times: "
                    + ", ".join(KERNEL_GROUPS))
    ap.add_argument("--fold-tail", default="none",
                    choices=("none", "launch", "read"),
                    help="config 12: what runs after each folded K5")
    ap.add_argument("--summarize", nargs="+", default=None,
                    help="print the parent/change comparison of these "
                    "output files (--root names the parent's tree)")
    args = ap.parse_args()
    if args.summarize:
        print(json.dumps(summarize(args.summarize, args.root)))
        return
    configs = {int(c) for c in args.configs.split(",")}
    root = args.root or "."
    if args.root:
        import sys
        sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    if configs - {13}:
        cuda_lib.build_all()
    if 1 in configs:
        frames = synth_frames(640, 360, 16 * max(args.batches, 2))
        enc = Encoder(config1(), device="cuda")
        for _ in enc.encode_pipelined(frames[:16]):
            pass
        print(json.dumps({"stages": stage_breakdown(enc, frames,
                                                    args.batches)}))
        print(json.dumps({"profile": dict(device_profile(
            lambda: [None for _ in enc.encode_pipelined(frames[:32])], 32,
            top=80), root=root)}))
    if 2 in configs:
        pframes = synth_frames(1280, 720, 2 * args.p_frames + 2, seed=2)
        penc = Encoder(config2(), device="cuda")
        print(json.dumps({"p_stages": dict(p_stage_breakdown(
            penc, pframes[:P_WARM + args.p_frames + 1]), root=root)}))
        penc = Encoder(config2(), device="cuda")
        penc.encode_push(*pframes[0])
        penc.encode_push(*pframes[1])
        rest = pframes[2:2 + args.p_frames]
        print(json.dumps({"p_profile": dict(device_profile(
            lambda: [penc.encode_push(*f) for f in rest], len(rest),
            top=80), root=root)}))
    if 3 in configs:
        bframes = synth_frames(1920, 1080, 9, seed=4)
        benc = Encoder(config3(), device="cuda")
        print(json.dumps({"b_stages": dict(b_stage_breakdown(
            benc, bframes[:5]), root=root)}))
        benc = Encoder(config3(), device="cuda")
        for f in bframes[:5]:          # the IDR and a warm-up mini-GOP
            benc.encode_push(*f)
        print(json.dumps({"b_profile": dict(device_profile(
            lambda: [benc.encode_push(*f) for f in bframes[5:9]], 4,
            top=80), root=root)}))
    if 4 in configs:
        aframes = synth_frames(1920, 1080, 13, seed=4)
        print(json.dumps({"la_stages": la_stage_breakdown(aframes[:9])}))
        aenc = Encoder(config3(aq=True), device="cuda")
        # the lookahead holds 3 frames back: 8 pushes code the IDR and the
        # first mini-GOP, the next 4 the second
        for f in aframes[:8]:
            aenc.encode_push(*f)
        print(json.dumps({"aq_profile": device_profile(
            lambda: [aenc.encode_push(*f) for f in aframes[8:12]], 4)}))
    if 5 in configs:
        lframes = synth_frames(1920, 1080, 11, seed=14)
        print(json.dumps({"ladder_stages": ladder_stages(lframes)}))
    if 6 in configs:
        print(json.dumps({"vbv_stages": vbv_stages(
            synth_frames(1280, 720, 12, seed=2))}))
    if 7 in configs:
        from chip_smoke import synth_frames10
        print(json.dumps({"main10_stages": main10_stages(
            synth_frames10(1920, 1080, 48))}))
    if 8 in configs:
        rframes = synth_frames(1920, 1080, 5, seed=4)
        print(json.dumps({"rdoq_b_stages": b_stage_breakdown(
            Encoder(config3(rdoq=2), device="cuda"), rframes)}))
    if 9 in configs:
        pframes = synth_frames(1280, 720, P_WARM + args.p_frames + 1,
                               seed=2)
        print(json.dumps({"p_stages_ref3": p_stage_breakdown(
            Encoder(config2_ref(3), device="cuda"), pframes)}))
        renc = Encoder(config2_ref(3), device="cuda")
        for f in pframes[:P_WARM + 1]:
            renc.encode_push(*f)
        rest = pframes[P_WARM + 1:]
        print(json.dumps({"p_profile_ref3": dict(device_profile(
            lambda: [renc.encode_push(*f) for f in rest], len(rest),
            top=80), root=root)}))
    if 10 in configs:
        cframes = synth_frames(1920, 1080, 10, seed=19)
        print(json.dumps({"ctb16_stages": ctb16_stages(cframes)}))
        print(json.dumps({"lossless_stages": ctb16_stages(
            cframes[:6], lossless=True)}))
        from chip_smoke import config_ctb16
        cenc = Encoder(config_ctb16(), device="cuda")
        list(cenc.encode_pipelined(cframes[:2]))
        print(json.dumps({"ctb16_profile": device_profile(
            lambda: list(cenc.encode_pipelined(cframes[2:])), 8)}))
    if 11 in configs:
        from chip_smoke import config_flat_p
        fframes = synth_frames(1920, 1080, 10, seed=22)
        print(json.dumps({"flat_p_stages": flat_stages(
            config_flat_p(), fframes, warm=2)}))
        fenc = Encoder(config_flat_p(), device="cuda")
        list(fenc.encode_pipelined(fframes[:2]))
        print(json.dumps({"flat_p_profile": device_profile(
            lambda: list(fenc.encode_pipelined(fframes[2:])), 8)}))
    if 12 in configs:
        from chip_smoke import config_flat_b
        add_fold_tail(args.fold_tail)
        bframes = synth_frames(1920, 1080, 11, seed=23)
        print(json.dumps({"flat_b_stages": dict(flat_stages(
            config_flat_b(), bframes, warm=0), root=root)}))
        # phase 23's run again, its kernels loaded by the run above
        benc = Encoder(config_flat_b(), device="cuda")
        print(json.dumps({"flat_b_profile": dict(device_profile(
            lambda: list(benc.encode_pipelined(bframes)), len(bframes),
            top=80), root=root, fold_tail=args.fold_tail)}))
    if 13 in configs:
        print(json.dumps({"kernel_times": dict(
            kernel_times(args.iters, args.kernels.split(",")),
            root=root)}))
    if 14 in configs:
        print(json.dumps({"e2e_fps": dict(e2e_fps(), root=root)}))
    print(json.dumps({"queued_timer": QUEUE_LOG}))
    print(card_line())


if __name__ == "__main__":
    main()
