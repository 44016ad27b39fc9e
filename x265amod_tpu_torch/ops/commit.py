"""The wavefront scans' kernels: K20 `commit_intra` and K23 `intra16_scan`.

K20 is the forced intra commit over the CTU32 wavefront, shared by the intra tree (every CTU: its CU32 or its four CU16s
by the forced split; JAX `models/intra_tree.py:_encode_frame` :308-596) and
the P/B trees (the 16-cells the decide scan made intra; JAX
`models/inter_tree.py:_commit_scan` :829-1044).

The plain versions are the trees' own `_commit_plain` methods, which chain
K1 `predict` and K2 `residual_chain` diagonal by diagonal; this module only
binds `csrc/commit_intra.cu`: one C call enqueues a launch per
anti-diagonal (no host sync between them) and reports how many, which
`LAUNCHES["commit_intra"]` counts.  Recon planes are updated in place;
levels are written into raster 16-cells.

K23 (`csrc/intra16_scan.cu`) is the flat CTB16 all-intra scan (JAX
`models/intra_frame.py:_encode_frame` :183-236): per CTU16 the 35-mode RD
decision, the chosen mode's luma and chroma coding and the reconstruction,
lossy or lossless; given the kinds of a flat P or B frame, the commit scan
of its intra CTUs (JAX `models/inter_frame.py` :394-458,
`models/b_frame.py` :489-548).  Two launches a call: the ticket list (the
CTUs to code in wavefront order, `scan_tickets` is its plain version),
then one persistent launch of clusters that take tickets and wait on
their neighbours' done flags.  Its plain version is
`models.intra_frame.IntraFrameEncoder._scan_plain`.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .estbits import bit_consts_table
from .residual import rdoq_table

_P = ctypes.c_void_p


class CommitArgs(ctypes.Structure):
    """`CommitArgs` of `csrc/commit_intra.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "F", "W", "H", "wc", "hc", "w16", "h16", "sbh", "rdoq_chroma")]
        + [(k, _P) for k in (
            "src_y", "src_cb", "src_cr", "rec_y", "rec_cb", "rec_cr", "ly",
            "lcb", "lcr", "modes", "split", "kinds", "qp16", "qc16", "qp32",
            "qc32", "lam16", "lam32", "tab_y16", "tab_y32", "tab_c8")])


def commit_intra(src, rec, levels, modes, maps, *, split=None, kinds=None,
                 sbh=True, bit_depth=8, rdoq=False, st="I"):
    """Launch K20 over a batch: src and rec = (y [F, H, W], cb, cr [F, H/2,
    W/2]) int32 (rec updated in place), levels = (ly [F, h16, w16, 16, 16],
    lcb, lcr [F, h16, w16, 8, 8]) int16 (written in place), modes [F, h16,
    w16] int32, maps the tree's QP/lambda maps (qp16, qc16, lam16 [h16,
    w16]; qp32, qc32, lam32 [hc, wc]).  The intra tree passes ``split`` [F,
    hc, wc] (RDOQ on luma, slice type I), the P/B commit ``kinds`` [F, h16,
    w16] (only kind-2 cells; RDOQ on luma and chroma at slice type ``st``
    with the luma lambda)."""
    y = src[0]
    f, h, w = y.shape
    hc, wc = h // 32, w // 32
    dev = y.device
    i32, f32 = torch.int32, torch.float32
    keep = []

    def p(t, dt=None):
        if t is None:
            return None
        t = t.contiguous() if dt is None else t.to(dt).contiguous()
        keep.append(t)
        return cuda_lib.ptr(t)
    a = CommitArgs(F=f, W=w, H=h, wc=wc, hc=hc, w16=2 * wc, h16=2 * hc,
                   sbh=int(sbh), rdoq_chroma=int(rdoq and kinds is not None))
    a.src_y, a.src_cb, a.src_cr = (p(t, i32) for t in src)
    for k, t in zip(("rec_y", "rec_cb", "rec_cr", "ly", "lcb", "lcr"),
                    tuple(rec) + tuple(levels)):
        if not t.is_contiguous():
            raise ValueError("commit_intra writes rec and levels in place: "
                             "they must be contiguous")
        setattr(a, k, p(t))
    if rec[0].dtype != i32 or levels[0].dtype != torch.int16:
        raise ValueError("commit_intra: int32 recon, int16 levels")
    a.modes = p(modes, i32)
    a.split, a.kinds = p(split, i32), p(kinds, i32)
    for k in ("qp16", "qc16", "qp32", "qc32"):
        setattr(a, k, p(maps[k], i32))
    a.lam16, a.lam32 = p(maps["lam16"], f32), p(maps["lam32"], f32)
    if rdoq:
        a.tab_y16 = p(rdoq_table(16, st, 0, dev))
        a.tab_y32 = p(rdoq_table(32, st, 0, dev))
        a.tab_c8 = p(rdoq_table(8, st, 1, dev))
    cuda_lib.require_cuda(*keep)
    lib = cuda_lib.lib("commit_intra")
    fn = lib.commit_intra
    fn.argtypes = [ctypes.POINTER(CommitArgs), ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_int), _P]
    fn.restype = ctypes.c_int
    launches = ctypes.c_int(0)
    rc = fn(ctypes.byref(a), int(bit_depth), int(bool(rdoq)),
            ctypes.byref(launches), _P(cuda_lib.stream_handle(y)))
    cuda_lib.launched("commit_intra", rc, launches.value)


class ScanArgs(ctypes.Structure):
    """`ScanArgs` of `csrc/intra16_scan.cu`, field for field."""
    _fields_ = ([(k, ctypes.c_int) for k in (
        "F", "W", "H", "wc", "hc", "sbh", "lossless")]
        + [(k, _P) for k in (
            "src_y", "src_cb", "src_cr", "rec_y", "rec_cb", "rec_cr", "ly",
            "lcb", "lcr", "modes", "qp", "qpc", "lam", "bits", "kinds",
            "sched", "flags")]
        + [("trace", _P)])


_bits: dict = {}


def scan_tickets(kinds, f: int, wc: int, hc: int) -> list[int]:
    """K23's ticket list (its first launch), plainly: the raster CTU
    indices fi * hc * wc + cy * wc + cx to code, in wavefront order (the
    anti-diagonal d = cx + 2 cy, then the frame, then cy); every CTU, or
    with ``kinds`` [F, hc, wc] the kind-2 ones."""
    k = None if kinds is None else np.asarray(kinds).reshape(f, hc, wc)
    out = []
    for d in range(wc + 2 * (hc - 1)):
        lo = max(0, -(-(d - wc + 1) // 2))
        for fi in range(f):
            for cy in range(lo, min(hc - 1, d // 2) + 1):
                if k is None or k[fi, cy, d - 2 * cy] == 2:
                    out.append((fi * hc + cy) * wc + d - 2 * cy)
    return out


def intra16_scan(src, rec, levels, modes, maps, *, sbh=True, lossless=False,
                 kinds=None, st="I", trace=None):
    """Launch K23 over a batch: src = (y [F, H, W], cb, cr [F, H/2, W/2])
    int32; rec (same shapes, int32), levels = (ly [F, hc, wc, 16, 16], lcb,
    lcr [F, hc, wc, 8, 8]) int16 and modes [F, hc, wc] int32 are written in
    place; maps the per-CTU16 qp, qc and lam [hc, wc] (one frame's, shared
    by the batch).  ``kinds`` [F, hc, wc] (the commit of a flat P or B
    frame, slice type ``st``): only the kind-2 CTUs are coded; rec, levels
    and modes must already hold every other CTU's (modes 1 there).
    ``trace`` (int64 [F hc wc, 12], or None) takes each CTU's global-timer
    stamps in ns (`ScanArgs.trace` of the source: ticket, luma neighbours
    acquired, references read, costs out, decision, luma published, Cb
    neighbours acquired, Cb published; then one mode group's prediction,
    chain, rate counts and cost).
    Returns the ticket list [2 + F hc wc] int32 (count, next ticket, then
    the coded CTUs in order: `scan_tickets`), valid once the stream has
    run it."""
    y = src[0]
    f, h, w = y.shape
    dev = y.device
    keep = []

    def p(t, dt=None):
        t = t.contiguous() if dt is None else t.to(dt).contiguous()
        keep.append(t)
        return cuda_lib.ptr(t)
    hc, wc = h // 16, w // 16
    want = [(f, h, w), (f, h // 2, w // 2), (f, h // 2, w // 2)] * 2 + [
        (f, hc, wc, 16, 16), (f, hc, wc, 8, 8), (f, hc, wc, 8, 8),
        (f, hc, wc)]
    got = [tuple(t.shape) for t in tuple(src) + tuple(rec) + tuple(levels)
           + (modes,)]
    if kinds is not None:
        got.append(tuple(kinds.shape))
        want.append((f, hc, wc))
    if h % 16 or w % 16 or got != want or any(
            tuple(maps[k].shape) != (hc, wc) for k in ("qp", "qc", "lam")):
        raise ValueError("intra16_scan: bad shapes")
    a = ScanArgs(F=f, W=w, H=h, wc=w // 16, hc=h // 16, sbh=int(sbh),
                 lossless=int(lossless))
    a.src_y, a.src_cb, a.src_cr = (p(t, torch.int32) for t in src)
    outs = tuple(rec) + tuple(levels) + (modes,)
    for k, t in zip(("rec_y", "rec_cb", "rec_cr", "ly", "lcb", "lcr",
                     "modes"), outs):
        if not t.is_contiguous():
            raise ValueError("intra16_scan writes its outputs in place: "
                             "they must be contiguous")
        setattr(a, k, p(t))
    if rec[0].dtype != torch.int32 or levels[0].dtype != torch.int16 or \
            modes.dtype != torch.int32:
        raise ValueError("intra16_scan: int32 recon and modes, int16 levels")
    a.qp, a.qpc = p(maps["qp"], torch.int32), p(maps["qc"], torch.int32)
    a.lam = p(maps["lam"], torch.float32)
    if (st, dev) not in _bits:      # one upload per slice type and device
        _bits[st, dev] = torch.as_tensor(bit_consts_table(st, 0), device=dev)
    a.bits = p(_bits[st, dev])
    if kinds is not None:
        if lossless:
            raise ValueError("intra16_scan: a P/B commit is lossy")
        a.kinds = p(kinds, torch.int32)
    n = f * hc * wc       # scratch: K23's first launch fills both
    sched = torch.empty(2 + n, dtype=torch.int32, device=dev)
    a.sched = p(sched)
    a.flags = p(torch.empty(3 * n, dtype=torch.int32, device=dev))
    if trace is not None:
        if trace.dtype != torch.int64 or tuple(trace.shape) != (n, 12):
            raise ValueError("intra16_scan: trace must be int64 "
                             "[F hc wc, 12]")
        a.trace = p(trace)
    cuda_lib.require_cuda(*keep)
    fn = cuda_lib.lib("intra16_scan").intra16_scan
    fn.argtypes = [ctypes.POINTER(ScanArgs), ctypes.POINTER(ctypes.c_int),
                   _P]
    fn.restype = ctypes.c_int
    launches = ctypes.c_int(0)
    rc = fn(ctypes.byref(a), ctypes.byref(launches),
            _P(cuda_lib.stream_handle(y)))
    cuda_lib.launched("intra16_scan", rc, launches.value)
    return sched
