"""Where the time goes in the PyTorch/CUDA port's two paths on one GPU:
BASELINE config 1 (640x360 all-intra QP 30, CTU32, 16-frame batches) and
config 2 (1280x720 low-delay P QP 32, CTU32, one reference).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_port.py [--batches 2] [--p-frames 4]

Prints JSON lines:
  - "stages": host wall time of each stage of a config 1 16-frame batch,
    with a device synchronize after each (upload, estimate, commit, loop
    filter + metrics, D2H copy, CABAC on 4 threads, NAL assembly),
    averaged over --batches batches;
  - "profile": torch.profiler over one config 1 encode_pipelined call of
    32 frames: wall time, summed device kernel time, the device busy share
    (kernel time / wall) and the kernels with the most device time;
  - "p_stages": the same breakdown of a config 2 P frame (upload, ME,
    sub-pel, trials, intra trial, decide scan, final MC and residuals,
    commit scan, loop filter + metrics, D2H, CABAC), averaged over
    --p-frames P frames;
  - "p_profile": torch.profiler over --p-frames P frames of config 2
    through encode_push;
  - the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import card_line, config1, config2, synth_frames


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


def p_stage_breakdown(enc, frames):
    """Stages of config 2's P frames, each against the previous frame's
    recon; frames[0] is coded as the I frame that seeds the reference."""
    import torch
    enc.encode_push(*frames[0])
    ref = next(iter(enc._dpb.values()))
    fe = enc.inter_encoder
    qp = enc.rc.frame_qp("P")
    maps = fe._maps(qp)
    n = len(frames) - 1
    acc = {}

    def mark(name, t0):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        acc[name] = acc.get(name, 0.0) + (t1 - t0) * 1e3 / n
        return t1

    pad = [[np.pad(a, ((0, (-a.shape[0]) % s), (0, 0)), mode="edge")
            for a, s in zip(f, (32, 16, 16))] for f in frames[1:]]
    for fr in pad:
        torch.cuda.synchronize()
        t = time.perf_counter()
        y, cb, cr = (fe._upload(a).to(torch.int32) for a in fr)
        refs = tuple(r.to(torch.int32) for r in ref)
        t = mark("upload", t)
        st1 = fe._motion_search(y, refs[0], maps)
        t = mark("me", t)
        st1.update(fe._subpel(y, refs[0], maps, st1))
        t = mark("subpel", t)
        st1.update(fe._trials(y, refs[0], maps, st1))
        t = mark("trials", t)
        oy = y.reshape(fe.h16, 16, fe.w16, 16).permute(0, 2, 1, 3)
        st1["di16"], st1["imode16"] = fe._intra_trial16(
            oy, oy.reshape(-1, 16, 16), maps["qp16"], maps["lam16"])
        t = mark("intra_trial", t)
        dec = fe._decide(st1, maps)
        t = mark("decide_scan", t)
        cell = fe._cell_decisions(dec)
        cell["mv"] = dec["mv"]
        lv, rec = fe._phase3(y, cb, cr, refs, maps, cell)
        t = mark("final_mc_residuals", t)
        rec, lv, modes = fe._commit(y, cb, cr, maps, cell["kinds"],
                                    st1["imode16"], lv, rec)
        t = mark("commit_scan", t)
        rec, sse = fe._filter_and_metrics((y, cb, cr), rec, lv,
                                          cell["kinds"], dec["split"],
                                          dec["mv"], maps, qp)
        t = mark("loop_filter_and_metrics", t)
        h16, w16 = fe.h16, fe.w16
        handle = fe._to_host(dict(
            split=dec["split"].to(torch.int8),
            kinds=cell["kinds"].reshape(h16, w16).to(torch.uint8),
            merge=cell["merge"].reshape(h16, w16).to(torch.uint8),
            mvd=cell["mvd"].reshape(h16, w16, 2).to(torch.int16),
            mvp=cell["mvp"].reshape(h16, w16).to(torch.uint8),
            modes=modes.to(torch.uint8),
            ly=lv[0].reshape(h16, w16, 16, 16),
            lcb=lv[1].reshape(h16, w16, 8, 8),
            lcr=lv[2].reshape(h16, w16, 8, 8), sse=sse),
            tuple(r.to(torch.uint8) for r in rec))
        res = fe.collect(handle)
        t = mark("d2h", t)
        enc._cabac_inter_tree(res, qp)
        mark("cabac", t)
        ref = handle["recon_dev"]
    acc["total"] = sum(acc.values())
    return acc


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
    ap.add_argument("--batches", type=int, default=2)
    ap.add_argument("--p-frames", type=int, default=4)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_port: no CUDA device")
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.ops import cuda_lib
    cuda_lib.build_all()
    frames = synth_frames(640, 360, 16 * max(args.batches, 2))
    enc = Encoder(config1(), device="cuda")
    for _ in enc.encode_pipelined(frames[:16]):
        pass
    print(json.dumps({"stages": stage_breakdown(enc, frames, args.batches)}))
    print(json.dumps({"profile": device_profile(
        lambda: [None for _ in enc.encode_pipelined(frames[:32])], 32)}))
    pframes = synth_frames(1280, 720, 2 * args.p_frames + 2, seed=2)
    penc = Encoder(config2(), device="cuda")
    print(json.dumps({"p_stages": p_stage_breakdown(
        penc, pframes[:args.p_frames + 1])}))
    penc = Encoder(config2(), device="cuda")
    penc.encode_push(*pframes[0])
    penc.encode_push(*pframes[1])
    rest = pframes[2:2 + args.p_frames]
    print(json.dumps({"p_profile": device_profile(
        lambda: [penc.encode_push(*f) for f in rest], len(rest))}))
    print(card_line())


if __name__ == "__main__":
    main()
