"""Stream parity of the PyTorch port against the JAX package, on the CPU.

Encodes the bench clip (bench.py's `synth_frames`) with both encoders at the
settings of BASELINE config 1 (ultrafast, QP 30, keyint 1, CTU32) or config
2 (superfast, QP 32, keyint 250, no B frames, CTU32, one reference), info
SEI off (its text names each encoder), and compares the streams frame by
frame.  The port runs its plain PyTorch versions (device="cpu").

    JAX_PLATFORMS=cpu python -m tests.parity_port [--config 1|2
        --width W --height H --frames N --batch 2]     (from the repo root)

A test tool, not a test: config 1 takes about a minute per 40 frames at
640x360 and config 2 a few seconds per frame at 320x192, too long for the
tier-1 suite, which runs the same comparisons at 96x64
(tests/test_torch_encoder.py, tests/test_torch_inter.py).

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
    ap.add_argument("--config", type=int, choices=(1, 2), default=1)
    ap.add_argument("--width", type=int, default=None)
    ap.add_argument("--height", type=int, default=None)
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from x265amod_tpu.models.encoder import Encoder as JaxEncoder
    from x265amod_tpu.utils.params import param_default_preset
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.utils.params import param_from_dict

    if args.config == 1:
        w, h, n, seed = args.width or 640, args.height or 360, \
            args.frames or 40, 0
        p = param_default_preset("ultrafast")
        p.qp, p.keyint = 30, 1
    else:
        w, h, n, seed = args.width or 320, args.height or 192, \
            args.frames or 8, 2
        p = param_default_preset("superfast")
        p.qp, p.keyint, p.bframes = 32, 250, 0
        p.aq_mode, p.cutree = 0, False
    p.width, p.height, p.ctu_size, p.info = w, h, 32, False
    frames = synth_frames(w, h, n, seed=seed)
    jenc = JaxEncoder(p.copy())
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    if args.config == 1:
        jenc.BATCH_FRAMES = tenc.BATCH_FRAMES = args.batch
        js = [o.nals for o in jenc.encode_pipelined(frames)]
    else:
        js = [o.nals for f in frames for o in jenc.encode_push(*f)]
        js += [o.nals for o in jenc.flush()]
    ts = [o.nals for o in tenc.encode_pipelined(frames)]
    same = sum(a == b for a, b in zip(js, ts))
    sj, st = jenc.summary(), tenc.summary()
    print(json.dumps(dict(
        config=args.config, width=w, height=h, frames=len(frames),
        identical_frames=same, jax_psnr_y=sj["psnr_y"],
        port_psnr_y=st["psnr_y"], jax_kbps=sj["bitrate_kbps"],
        port_kbps=st["bitrate_kbps"])))
    return 0 if same == len(frames) == len(ts) else 1


if __name__ == "__main__":
    sys.exit(main())
