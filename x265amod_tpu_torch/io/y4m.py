"""Y4M reader/writer with the aMod XLENGTH extension (the port's copy of the
JAX package's `io/y4m.py`, numpy only).

Role of reference `input/y4m.{h,cpp}` (incl. the aMod `XLENGTH` tag that
carries total frame count for progress/ETA, `input/y4m.cpp:291-310`) and
`output/y4m.cpp`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class Y4mHeader:
    width: int
    height: int
    fps_num: int = 25
    fps_den: int = 1
    interlace: str = "p"
    aspect: str = "0:0"
    csp: str = "420"
    bit_depth: int = 8
    total_frames: int = 0       # from aMod XLENGTH tag (0 = unknown)


class Y4mReader:
    def __init__(self, f):
        self.f = f if hasattr(f, "read") else open(f, "rb")
        line = self.f.readline().decode("ascii", "replace").strip()
        if not line.startswith("YUV4MPEG2"):
            raise ValueError("not a y4m stream")
        h = Y4mHeader(0, 0)
        for tok in line.split()[1:]:
            tag, val = tok[0], tok[1:]
            if tag == "W":
                h.width = int(val)
            elif tag == "H":
                h.height = int(val)
            elif tag == "F":
                n, d = val.split(":")
                h.fps_num, h.fps_den = int(n), int(d)
            elif tag == "I":
                h.interlace = val
            elif tag == "A":
                h.aspect = val
            elif tag == "C":
                if val.startswith("420"):
                    h.csp = "420"
                    if "p10" in val:
                        h.bit_depth = 10
                else:
                    raise ValueError(f"unsupported y4m colorspace {val}")
            elif tag == "X" and val.startswith("LENGTH="):
                # aMod extension: total frame count
                h.total_frames = int(val[len("LENGTH="):])
        if not h.width or not h.height:
            raise ValueError("y4m missing dimensions")
        self.header = h
        self._fsize = (h.width * h.height * 3) // 2 * \
            (2 if h.bit_depth > 8 else 1)

    def read_frame(self):
        """Returns (y, cb, cr) uint8/uint16 planes or None at EOF."""
        line = self.f.readline()
        if not line:
            return None
        if not line.startswith(b"FRAME"):
            raise ValueError("bad y4m frame header")
        data = self.f.read(self._fsize)
        if len(data) < self._fsize:
            return None
        h = self.header
        dt = np.uint16 if h.bit_depth > 8 else np.uint8
        arr = np.frombuffer(data, dtype=dt)
        ys = h.width * h.height
        cs = ys // 4
        y = arr[:ys].reshape(h.height, h.width)
        cb = arr[ys:ys + cs].reshape(h.height // 2, h.width // 2)
        cr = arr[ys + cs:ys + 2 * cs].reshape(h.height // 2, h.width // 2)
        return y, cb, cr

    def __iter__(self):
        while True:
            fr = self.read_frame()
            if fr is None:
                return
            yield fr


class Y4mWriter:
    def __init__(self, f, header: Y4mHeader):
        self.f = f if hasattr(f, "write") else open(f, "wb")
        self.header = header
        tags = f"W{header.width} H{header.height} " \
               f"F{header.fps_num}:{header.fps_den} I{header.interlace} " \
               f"A{header.aspect} C{header.csp}"
        if header.total_frames:
            tags += f" XLENGTH={header.total_frames}"
        self.f.write(f"YUV4MPEG2 {tags}\n".encode())

    def write_frame(self, y, cb, cr):
        self.f.write(b"FRAME\n")
        for p in (y, cb, cr):
            self.f.write(np.ascontiguousarray(p).tobytes())
