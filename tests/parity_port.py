"""Stream parity of the PyTorch port against the JAX package, on the CPU.

Encodes the bench clip (bench.py's `synth_frames`) with both encoders at
BASELINE config 1 settings (ultrafast, QP 30, keyint 1, CTU32; info SEI off,
since its text names each encoder) and compares the streams frame by frame.
The port runs its plain PyTorch versions (device="cpu").

    JAX_PLATFORMS=cpu python -m tests.parity_port [--width 640
        --height 360 --frames 40 --batch 2]      (from the repo root)

A test tool, not a test: it takes about a minute per 40 frames at 640x360,
too long for the tier-1 suite, which runs the same comparison at 96x64
(tests/test_torch_encoder.py).

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
    ap.add_argument("--width", type=int, default=640)
    ap.add_argument("--height", type=int, default=360)
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--batch", type=int, default=2)
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    from x265amod_tpu.models.encoder import Encoder as JaxEncoder
    from x265amod_tpu.utils.params import param_default_preset
    from x265amod_tpu_torch.models.encoder import Encoder
    from x265amod_tpu_torch.utils.params import param_from_dict

    p = param_default_preset("ultrafast")
    p.width, p.height, p.qp = args.width, args.height, 30
    p.keyint, p.ctu_size, p.info = 1, 32, False
    frames = synth_frames(args.width, args.height, args.frames)
    jenc = JaxEncoder(p.copy())
    jenc.BATCH_FRAMES = args.batch
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    tenc.BATCH_FRAMES = args.batch
    js = [o.nals for o in jenc.encode_pipelined(frames)]
    ts = [o.nals for o in tenc.encode_pipelined(frames)]
    same = sum(a == b for a, b in zip(js, ts))
    sj, st = jenc.summary(), tenc.summary()
    print(json.dumps(dict(
        width=args.width, height=args.height, frames=len(frames),
        identical_frames=same, jax_psnr_y=sj["psnr_y"],
        port_psnr_y=st["psnr_y"], jax_kbps=sj["bitrate_kbps"],
        port_kbps=st["bitrate_kbps"])))
    return 0 if same == len(frames) == len(ts) else 1


if __name__ == "__main__":
    sys.exit(main())
