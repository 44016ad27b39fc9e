"""Where the time goes in the PyTorch/CUDA port's paths on one GPU:
BASELINE config 1 (640x360 all-intra QP 30, CTU32, 16-frame batches),
config 2 (1280x720 low-delay P QP 32, CTU32, one reference), the config-3
slice (1920x1080 B pyramid with SAO, CQP 32, AQ and CU-tree off), config
3 as bench.py builds it (the same with the lookahead, AQ and CU-tree: "4"),
the ABR ladder ("5"), config 2 under VBV with HRD ("6"), Main10 all-intra
("7"), config 3 with RDOQ ("8") and config 2 at x265's default --ref 3
("9").

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_port.py [--configs 1,2,3,4,5,6,7,8,9] [--batches 2]
        [--p-frames 4]

Prints JSON lines:
  - "stages": host wall time of each stage of a config 1 16-frame batch,
    with a device synchronize after each (upload, estimate, commit, loop
    filter + metrics, D2H copy, CABAC on 4 threads, NAL assembly),
    averaged over --batches batches;
  - "profile": torch.profiler over one config 1 encode_pipelined call of
    32 frames: wall time, summed device kernel time, the device busy share
    (kernel time / wall) and the kernels with the most device time;
  - "p_stages": the same breakdown of a config 2 P frame (upload, ME,
    sub-pel, trials, pick_ref (K18, with several references), intra trial,
    decide scan (K17), final MC and residuals, commit scan, loop filter +
    metrics, D2H, CABAC), averaged over --p-frames P frames after two
    P frames that warm every stage up;
  - "p_profile": torch.profiler over --p-frames P frames of config 2
    through encode_push;
  - "b_stages": the breakdown of a config-3 B frame (upload, ME, trials,
    intra trial, decide scan, final MC and residuals, commit scan, deblock
    + metrics, SAO, D2H, CABAC), averaged over the 3 B frames coded
    between the IDR and the P anchor of the first mini-GOP;
  - "b_profile": torch.profiler over one mini-GOP (P + 3 B) of config 3
    through encode_push;
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
  - the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import (card_line, config1, config2, config2_ref, config3,
                        synth_frames)

# P frames that run every stage before the P breakdowns' clock starts
P_WARM = 2


def stage_breakdown(enc, frames, batches):
    import torch
    from x265amod_tpu_torch.ops.deblock import deblock_frame_planes
    from x265amod_tpu_torch.ops.metrics import plane_sse, ssim_plane
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
            coded = ((ly != 0).any(-1).any(-1) | (lcb != 0).any(-1).any(-1)
                     | (lcr != 0).any(-1).any(-1))
            ry, rcb, rcr = deblock_frame_planes(ry, rcb, rcr, split, coded,
                                                maps["qp32"], qp)
            sse = torch.stack([plane_sse(y, ry), plane_sse(cb, rcb),
                               plane_sse(cr, rcr), ssim_plane(y, ry)], 1)
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
    set-up: lazy module loads, the allocator's first blocks)."""
    import torch
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
        per = [fe._motion_search(y, refs[0][r], maps) for r in range(nr)]
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
        recons = [handle["recon_dev"]] + recons[:nr - 1]
    acc["total"] = sum(acc.values())
    return acc


def b_stage_breakdown(enc, frames):
    """Stages of config-3 B frames: frames[0] is coded as the IDR and
    frames[-1] as the P anchor against it; each frame between is coded as
    a referenced B between the two."""
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

    for poc in range(1, anchor):
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


def device_profile(run, n_frames):
    """torch.profiler over ``run()``: wall time, device kernel time, the
    device busy share and the kernels with the most device time."""
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
                     for us, k, c in rows[:12]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--configs", default="1,2,3,4,5,6,7,8,9")
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--p-frames", type=int, default=4)
    args = ap.parse_args()
    configs = {int(c) for c in args.configs.split(",")}
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    if 1 in configs:
        frames = synth_frames(640, 360, 16 * max(args.batches, 2))
        enc = Encoder(config1(), device="cuda")
        for _ in enc.encode_pipelined(frames[:16]):
            pass
        print(json.dumps({"stages": stage_breakdown(enc, frames,
                                                    args.batches)}))
        print(json.dumps({"profile": device_profile(
            lambda: [None for _ in enc.encode_pipelined(frames[:32])], 32)}))
    if 2 in configs:
        pframes = synth_frames(1280, 720, 2 * args.p_frames + 2, seed=2)
        penc = Encoder(config2(), device="cuda")
        print(json.dumps({"p_stages": p_stage_breakdown(
            penc, pframes[:P_WARM + args.p_frames + 1])}))
        penc = Encoder(config2(), device="cuda")
        penc.encode_push(*pframes[0])
        penc.encode_push(*pframes[1])
        rest = pframes[2:2 + args.p_frames]
        print(json.dumps({"p_profile": device_profile(
            lambda: [penc.encode_push(*f) for f in rest], len(rest))}))
    if 3 in configs:
        bframes = synth_frames(1920, 1080, 9, seed=4)
        benc = Encoder(config3(), device="cuda")
        print(json.dumps({"b_stages": b_stage_breakdown(
            benc, bframes[:5])}))
        benc = Encoder(config3(), device="cuda")
        for f in bframes[:5]:          # the IDR and a warm-up mini-GOP
            benc.encode_push(*f)
        print(json.dumps({"b_profile": device_profile(
            lambda: [benc.encode_push(*f) for f in bframes[5:9]], 4)}))
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
    print(card_line())


if __name__ == "__main__":
    main()
