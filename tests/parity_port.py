"""Stream parity of the PyTorch port against the JAX package, on the CPU.

Encodes the bench clip (bench.py's `synth_frames`) with both encoders at the
settings of BASELINE config 1 (ultrafast, QP 30, keyint 1, CTU32), config
2 (superfast, QP 32, keyint 250, no B frames, CTU32, one reference), the
config-3 slice (bench.py's config 3 with AQ and CU-tree off: CQP 32, keyint
60, a B pyramid of 3, SAO on, CTU32) or config 3 as bench.py builds it
("4": the same with AQ 2, CU-tree and a lookahead of 4), info SEI off (its
text names each encoder), and compares the streams frame by frame (decode
order).  --rc codes under CRF 28, ABR at --bitrate kb/s, or ABR with a VBV
of one second at that rate and its HRD SEI; both encoders then run
`encode_pipelined`, whose order of rate-control calls is the reference's.
The port runs its plain PyTorch versions (device="cpu").

    JAX_PLATFORMS=cpu python -m tests.parity_port [--config 1|2|3|4
        --width W --height H --frames N --batch 2 --rc cqp|crf|abr|vbv
        --bitrate KBPS]                                (from the repo root)

Full sizes belong here, not in the tier-1 suite: JAX needs 94-202 s per
run on a CPU at 1280x720 and 1920x1080.

A test tool, not a test: config 1 takes about a minute per 40 frames at
640x360, config 2 a few seconds per frame at 320x192 and config 3 (320x192,
9 frames by default) a few minutes with JAX's compiles, too long for the
tier-1 suite, which runs the same comparisons at 96x64 and 64x64
(tests/test_torch_encoder.py, tests/test_torch_inter.py,
tests/test_torch_b.py).

Prints one JSON line: frames, identical frames, and each encoder's PSNR-Y
and kbps.  Exits non-zero unless every frame is byte-identical.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from chip_smoke import synth_frames


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", type=int, choices=(1, 2, 3, 4), default=1)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--rc", choices=("cqp", "crf", "abr", "vbv"),
                    default="cqp")
    ap.add_argument("--bitrate", type=int, default=500)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from x265amod_tpu.models.encoder import Encoder as JaxEncoder
    from x265amod_tpu.utils.params import Param, param_default_preset
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.utils.params import param_from_dict

    if args.config == 1:
        w, h, n, seed = args.width or 640, args.height or 360, \
            args.frames or 40, 0
        p = param_default_preset("ultrafast")
        p.qp, p.keyint = 30, 1
    elif args.config == 2:
        w, h, n, seed = args.width or 320, args.height or 192, \
            args.frames or 8, 2
        p = param_default_preset("superfast")
        p.qp, p.keyint, p.bframes = 32, 250, 0
        p.aq_mode, p.cutree = 0, False
    else:
        w, h, n, seed = args.width or 320, args.height or 192, \
            args.frames or 9, 4
        aq = args.config == 4
        p = Param(keyint=60, bframes=3, sao=True, aq_mode=2 if aq else 0,
                  cutree=aq, rc_lookahead=4)
    p.width, p.height, p.ctu_size, p.info = w, h, 32, False
    if args.rc == "crf":
        p.rc_mode, p.crf = "crf", 28.0
    elif args.rc in ("abr", "vbv"):
        p.rc_mode, p.bitrate = "abr", args.bitrate
    if args.rc == "vbv":
        p.vbv_maxrate = p.vbv_bufsize = args.bitrate
        p.hrd = True
    frames = synth_frames(w, h, n, seed=seed)
    jenc = JaxEncoder(p.copy())
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    if args.config == 1 or args.rc != "cqp":
        jenc.BATCH_FRAMES = tenc.BATCH_FRAMES = args.batch
        js = [o.nals for o in jenc.encode_pipelined(frames)]
    else:
        js = [o.nals for f in frames for o in jenc.encode_push(*f)]
        js += [o.nals for o in jenc.flush()]
    ts = [o.nals for o in tenc.encode_pipelined(frames)]
    same = sum(a == b for a, b in zip(js, ts))
    sj, st = jenc.summary(), tenc.summary()
    print(json.dumps(dict(
        config=args.config, rc=args.rc, width=w, height=h,
        frames=len(frames),
        identical_frames=same, jax_psnr_y=sj["psnr_y"],
        port_psnr_y=st["psnr_y"], jax_kbps=sj["bitrate_kbps"],
        port_kbps=st["bitrate_kbps"])))
    return 0 if same == len(frames) == len(ts) else 1


if __name__ == "__main__":
    sys.exit(main())
