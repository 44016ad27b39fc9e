"""Where the time goes in the PyTorch/CUDA port's main path (BASELINE
config 1: 640x360 all-intra QP 30, CTU32, 16-frame batches) on one GPU.

Run from the repository root on a machine with an NVIDIA GPU:

    python3 profile_port.py [--batches 2]

Prints JSON lines:
  - "stages": host wall time of each stage of a 16-frame batch, with a
    device synchronize after each (upload, estimate, commit, loop filter +
    metrics, D2H copy, CABAC on 4 threads, NAL assembly), averaged over
    --batches batches;
  - "profile": torch.profiler over one encode_pipelined call of 32 frames:
    wall time, summed device kernel time, the device busy share (kernel
    time / wall) and the kernels with the most device time;
  - the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from chip_smoke import card_line, config1, synth_frames


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


def device_profile(enc, frames):
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in enc.encode_pipelined(frames):
            pass
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
    return dict(frames=len(frames), wall_ms=wall,
                device_kernel_ms=dev_total / 1e3,
                device_busy_share=dev_total / 1e3 / wall,
                top=[dict(name=k[:80], ms=us / 1e3, calls=c)
                     for us, k, c in rows[:12]])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batches", type=int, default=2)
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
    print(json.dumps({"profile": device_profile(enc, frames[:32])}))
    print(card_line())


if __name__ == "__main__":
    main()
