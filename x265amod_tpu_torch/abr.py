"""ABR-ladder multi-encode app of the port (the JAX package's `abr.py`, role
of x265's `abrEncApp.{h,cpp}` and the `--abr-ladder` parsing in
`x265.cpp:93-248`): one input, read once, coded at several resolutions and
bitrates, each rung by its own `Encoder` under ABR rate control.

Each input frame goes to the card once; each rung whose size differs from
the input's gets it resampled there (K16, `ops/scaler.py`), and every rung
takes the frame in turn through `encode_push`, as the JAX `main` does.

Ladder file, one rung per line:   name:WxH:bitrate_kbps[:extra opts]
where the extra options are x265-style names, ``name=value`` or a bare flag.

    python -m x265amod_tpu_torch.abr in.y4m --ladder ladder.txt
        [--output-prefix abr_out] [--preset medium] [--frames N]
        [--device cuda|cpu]
"""

from __future__ import annotations

import sys
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .io.y4m import Y4mReader
from .models.encoder import Encoder, resolve_device
from .ops.scaler import resample_frame
from .utils.params import check_params, param_default_preset, param_parse


@dataclass
class Rung:
    name: str
    width: int
    height: int
    bitrate: int
    extra: list[str] = field(default_factory=list)
    encoder: Encoder | None = None
    out: object = None
    frames: int = 0
    bytes_out: int = 0


def parse_ladder_config(path: str) -> list[Rung]:
    rungs = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split(":")
            if len(parts) < 3:
                raise ValueError(f"bad ladder line: {line}")
            w, h = parts[1].lower().split("x")
            extra = parts[3].split() if len(parts) > 3 else []
            rungs.append(Rung(name=parts[0], width=int(w), height=int(h),
                              bitrate=int(parts[2]), extra=extra))
    if not rungs:
        raise ValueError("empty ladder config")
    return rungs


def rung_param(r: Rung, preset: str, fps_num: int, fps_den: int):
    """The rung's `Param`: the preset, its size and frame rate, ABR at its
    bitrate, then its extra options (JAX `main` :74-92)."""
    p = param_default_preset(preset)
    p.width, p.height = r.width, r.height
    p.fps_num, p.fps_den = fps_num, fps_den
    p.bitrate = r.bitrate
    p.rc_mode = "abr"
    for opt in r.extra:
        if "=" in opt:
            k, v = opt.split("=", 1)
            param_parse(p, k, v)
        else:
            param_parse(p, opt)
    check_params(p)
    return p


def encode_ladder(rungs: list[Rung], frames, src_w: int, src_h: int,
                  device) -> int:
    """Code the (y, cb, cr) uint8 frames through every rung's encoder (each
    rung's `encoder` and `out`, a binary file or None, set by the caller),
    then flush and close each.  Returns the count of input frames."""
    n_in = 0
    for fr in frames:
        n_in += 1
        planes = None
        for r in rungs:
            if (r.width, r.height) == (src_w, src_h):
                scaled = fr
            else:
                if planes is None:      # the reader's arrays are read-only
                    planes = tuple(torch.from_numpy(np.array(a)).to(device)
                                   for a in fr)
                scaled = tuple(t.cpu().numpy() for t in resample_frame(
                    planes, r.width, r.height))
            _emit(r, r.encoder.encode_push(*scaled))
    for r in rungs:
        _emit(r, r.encoder.flush())
        r.encoder.close()
    return n_in


def _emit(r: Rung, outs) -> None:
    for out in outs:
        if r.out is not None:
            r.out.write(out.nals)
        r.bytes_out += len(out.nals)
        r.frames += 1


def run(argv=None):
    """Parse the command line, open one encoder per rung and code the input
    through them.  Returns (rungs, input frames, seconds); each rung keeps
    its encoder (statistics, rate control) and the bytes it wrote."""
    import argparse
    ap = argparse.ArgumentParser(
        prog="x265amod-tpu-torch-abr",
        description="ABR ladder: N encodes from one input")
    ap.add_argument("input", help="y4m input ('-' for stdin)")
    ap.add_argument("--ladder", required=True,
                    help="config file: name:WxH:kbps[:opts] per line")
    ap.add_argument("--output-prefix", default="abr_out")
    ap.add_argument("--preset", default="medium")
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    rungs = parse_ladder_config(args.ladder)
    reader = Y4mReader(sys.stdin.buffer if args.input == "-"
                       else args.input)
    hdr = reader.header
    for r in rungs:
        r.encoder = Encoder(rung_param(r, args.preset, hdr.fps_num,
                                       hdr.fps_den), device=device)
        r.out = open(f"{args.output_prefix}_{r.name}.hevc", "wb")

    def frames():
        for i, fr in enumerate(reader):
            if args.frames and i >= args.frames:
                return
            yield fr

    t0 = time.time()
    try:
        n_in = encode_ladder(rungs, frames(), hdr.width, hdr.height, device)
    finally:
        for r in rungs:
            r.out.close()
    return rungs, n_in, time.time() - t0


def main(argv=None) -> int:
    rungs, n_in, dt = run(argv)
    for r in rungs:
        s = r.encoder.summary()
        sys.stderr.write(
            f"[{r.name}] {r.frames} frames {r.width}x{r.height} "
            f"{s.get('bitrate_kbps', 0):.0f} kb/s "
            f"PSNR-Y {s.get('psnr_y', 0):.2f}\n")
    sys.stderr.write(
        f"ladder: {n_in} input frames x {len(rungs)} rungs "
        f"in {dt:.1f}s ({n_in * len(rungs) / max(dt, 1e-9):.2f} enc-fps)\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
