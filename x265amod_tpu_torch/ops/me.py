"""Motion estimation and motion compensation for the P tree: kernels K5
`me_ssd_grid`, K6 `subpel_refine`, K7 `mc_qpel` and K8 `hpel_plane`, each
beside its plain PyTorch version.

Counterparts in the JAX package: `ops/me.py` (`me_ssd_grid` :33,
`subpel_refine` :385, `mc_luma_qpel` :315 / `mc_luma_qpel14` :262,
`mc_chroma_qpel` :377 / `mc_chroma_qpel14` :331, `LUMA_FILTERS` and
`CHROMA_FILTERS` :230-247, `_mvd_bits_f` :450) and
`models/inter_tree.py:_hpel_plane` (:51).

The JAX package fetches each block's reference window with one-hot f32
matmuls (`ops/me.py:_block_windows`), the TPU's stand-in for a gather.  Here
every reference read is a gather at coordinates clamped to the plane, which
is what the JAX edge padding gives for every MV the encoder produces.  The
JAX `me_ssd_grid` forms ``w2 - 2 corr + c2`` in f32 (exact while every term
stays below 2^24: always at bn 16 on 8-bit planes); the port sums the SSD in
int32 and converts once.

Each block of a plane is addressed by its raster index: block i of an
[H, W] plane at block size n has its origin at ((i % (W/n)) n, (i // (W/n)) n).
A CPU tensor takes the plain version; a CUDA tensor launches the kernel.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

# luma 8-tap filters per quarter phase (spec Table 8-11)
LUMA_FILTERS = np.array([
    [0, 0, 0, 64, 0, 0, 0, 0],
    [-1, 4, -10, 58, 17, -5, 1, 0],
    [-1, 4, -11, 40, 40, -11, 4, -1],
    [0, 1, -5, 17, 58, -10, 4, -1],
], dtype=np.int32)

# chroma 4-tap filters per eighth phase (spec Table 8-13)
CHROMA_FILTERS = np.array([
    [0, 64, 0, 0],
    [-2, 58, 10, -2],
    [-4, 54, 16, -2],
    [-6, 46, 28, -4],
    [-4, 36, 36, -4],
    [-4, 28, 46, -6],
    [-2, 16, 54, -4],
    [-2, 10, 58, -2],
], dtype=np.int32)


def mvd_bits(mvd):
    """MVD bin count [...] f32 of qpel vectors [..., 2] (the JAX
    `inter_frame._mvd_bits` and `me._mvd_bits_f`, one formula): a component
    of magnitude a costs 1 + 2 bitlen(a) bins, and bitlen(a) is the
    exponent `frexp` returns for a (exact: a < 2^24 is exact in f32).  The
    JAX f32 form ``3 + 2 (floor(log2((a - 2) / 2 + 1)) + 1)`` equals it for
    every |a| < 16384; XLA's f32 log2 rounds low at a = 16384 and 65536, far
    beyond the 4 (2 sr + 4) the encoder can produce."""
    e = torch.frexp(mvd.abs().to(torch.float32)).exponent
    return (e.sum(-1) * 2 + 2).to(torch.float32)


def _plane_blocks(h, w, n, dev):
    """Origins (bx, by) of the n x n raster blocks of an [h, w] plane."""
    wb = w // n
    i = torch.arange((h // n) * wb, device=dev)
    return (i % wb) * n, (i // wb) * n


def _gather_windows(plane, x0, y0, size):
    """[nb, size, size] windows of ``plane`` starting at (x0, y0) per block,
    read at clamped coordinates (= edge padding)."""
    h, w = plane.shape
    ar = torch.arange(size, device=plane.device)
    rows = torch.clamp(y0[:, None] + ar[None], 0, h - 1)
    cols = torch.clamp(x0[:, None] + ar[None], 0, w - 1)
    return plane[rows[:, :, None], cols[:, None, :]]


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def me_ssd_grid_plain(cur, ref, sr: int, bn: int = 16):
    """cur [nb, bn, bn] int (the raster blocks of a frame), ref [H, W] int
    -> [nb, S, S] f32 SSD, S = 2 sr + 1: grid[i, dy, dx] is the SSD of block
    i against the reference at MV (dx - sr, dy - sr)."""
    h, w = ref.shape
    s = 2 * sr + 1
    ref = ref.to(torch.int32)
    cur = cur.to(torch.int32)
    bx, by = _plane_blocks(h, w, bn, ref.device)
    win = _gather_windows(ref, bx - sr, by - sr, bn + 2 * sr)
    out = torch.empty((cur.shape[0], s, s), dtype=torch.float32,
                      device=ref.device)
    for dy in range(s):
        rows = win[:, dy:dy + bn]                         # [nb, bn, bn+2sr]
        cand = rows.unfold(2, bn, 1)                      # [nb, bn, S, bn]
        d = cand - cur[:, :, None, :]
        out[:, dy] = (d * d).sum((1, 3)).to(torch.float32)
    return out


def _mc14(plane, mv, n, chroma):
    """14-bit intermediate uni prediction [nb, n, n] int32 of the raster
    blocks of ``plane`` at qpel luma MVs mv [nb, 2] (chroma: the same value
    in eighth-pel chroma units).  Phase 0 of each filter table is a single
    64 tap, so one formula covers every phase: horizontal taps, then
    vertical taps and >> 6 (spec 8.5.3.3.3, 8-bit: first shift 0)."""
    h, w = plane.shape
    filt, sh, margin = (CHROMA_FILTERS, 3, 1) if chroma else \
        (LUMA_FILTERS, 2, 3)
    t = filt.shape[1]
    taps = torch.as_tensor(filt, device=plane.device)
    mv = mv.to(torch.int32)
    bx, by = _plane_blocks(h, w, n, plane.device)
    mask = (1 << sh) - 1
    win = _gather_windows(plane.to(torch.int32), bx + (mv[:, 0] >> sh)
                          - margin, by + (mv[:, 1] >> sh) - margin,
                          n + t - 1)
    tx = taps[(mv[:, 0] & mask).long()]                   # [nb, t]
    ty = taps[(mv[:, 1] & mask).long()]
    hor = (win.unfold(2, t, 1) * tx[:, None, None, :]).sum(-1)
    ver = (hor.unfold(1, t, 1) * ty[:, None, None, :]).sum(-1)
    return (ver >> 6).to(torch.int32)


def _uni(pred14):
    return torch.clamp((pred14 + 32) >> 6, 0, 255).to(torch.int32)


def mc_luma_qpel_plain(plane, mv, n: int = 16):
    """Quarter-pel luma uni MC (JAX `mc_luma_qpel`): [nb, n, n] int32."""
    return _uni(_mc14(plane, mv, n, False))


def mc_chroma_qpel_plain(plane, mv, n: int = 8):
    """Eighth-pel chroma uni MC (JAX `mc_chroma_qpel`) at luma qpel MVs."""
    return _uni(_mc14(plane, mv, n, True))


# candidate order of the JAX subpel_refine: dy outer, dx inner, -2..2 each
_SUBPEL_D = torch.tensor([[dx, dy] for dy in range(-2, 3)
                          for dx in range(-2, 3)], dtype=torch.int32)


def subpel_refine_plain(ref, cur, mv_int, lam, n: int = 16):
    """Exhaustive +-2 qpel refinement around integer MVs: ref [H, W], cur
    [nb, n, n], mv_int [nb, 2], lam [nb] f32 -> (mv_q [nb, 2] int32,
    ssd [nb] f32).  Cost ``ssd + lam * mvd_bits(mv)`` in f32 (product
    rounded, then the add), first minimum in the JAX candidate order."""
    nb = cur.shape[0]
    dev = ref.device
    cand = mv_int.to(torch.int32)[:, None, :] * 4 + _SUBPEL_D.to(dev)[None]
    # the 25 candidates of block i are blocks of a plane with the same
    # origins: run the MC once per candidate column
    ssd = torch.empty((nb, 25), dtype=torch.float32, device=dev)
    cur = cur.to(torch.int32)
    for k in range(25):
        pred = mc_luma_qpel_plain(ref, cand[:, k], n)
        d = pred - cur
        ssd[:, k] = (d * d).sum((1, 2)).to(torch.float32)
    cost = ssd + lam.to(torch.float32)[:, None] * mvd_bits(cand)
    best = torch.argmin(cost, 1)
    mv_q = torch.gather(cand, 1, best[:, None, None].expand(nb, 1, 2))[:, 0]
    return mv_q.contiguous(), torch.gather(ssd, 1, best[:, None])[:, 0]


def hpel_plane_plain(ref):
    """(1/2, 1/2)-phase 8-tap plane of ref [H, W] on the integer grid,
    ``(v + 2048) >> 12`` without clipping (JAX `inter_tree._hpel_plane`)."""
    h, w = ref.shape
    t = torch.as_tensor(LUMA_FILTERS[2], device=ref.device)
    rows = torch.clamp(torch.arange(-3, h + 4, device=ref.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-3, w + 4, device=ref.device), 0, w - 1)
    p = ref.to(torch.int32)[rows[:, None], cols[None, :]]
    hor = (p.unfold(1, 8, 1) * t).sum(-1)                 # [h+7, w]
    ver = (hor.unfold(0, 8, 1) * t).sum(-1)               # [h, w]
    return ((ver + 2048) >> 12).to(torch.int32)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int


def _lib(name, fn, argtypes):
    lib = cuda_lib.lib(name)
    if not getattr(lib, "_typed", False):
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = _I
        lib._typed = True
    return lib


def _plane_arg(plane):
    p = plane.to(torch.int32).contiguous()
    if p.dim() != 2:
        raise ValueError("expected one [H, W] plane")
    return p


def me_ssd_grid(cur, ref, sr: int, bn: int = 16):
    """See me_ssd_grid_plain; a CUDA tensor launches `csrc/me_ssd.cu`."""
    if ref.device.type == "cpu":
        return me_ssd_grid_plain(cur, ref, sr, bn)
    r = _plane_arg(ref)
    c = cur.to(torch.int32).contiguous()
    cuda_lib.require_cuda(r, c)
    h, w = r.shape
    nb = (h // bn) * (w // bn)
    if c.shape != (nb, bn, bn) or bn not in (16, 32) or not 1 <= sr <= 32:
        raise ValueError("me_ssd_grid: bad shapes")
    s = 2 * sr + 1
    out = torch.empty((nb, s, s), dtype=torch.float32, device=r.device)
    if nb:
        rc = _lib("me_ssd", "me_ssd_grid", [_VP] * 2 + [_I] * 4 + [_VP] * 2) \
            .me_ssd_grid(cuda_lib.ptr(c), cuda_lib.ptr(r), h, w, bn, sr,
                         cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("me_ssd", rc)
    return out


def subpel_refine(ref, cur, mv_int, lam, n: int = 16):
    """See subpel_refine_plain; a CUDA tensor launches `csrc/subpel.cu`."""
    if ref.device.type == "cpu":
        return subpel_refine_plain(ref, cur, mv_int, lam, n)
    r = _plane_arg(ref)
    c = cur.to(torch.int32).contiguous()
    m = mv_int.to(torch.int32).contiguous()
    la = lam.to(torch.float32).contiguous()
    cuda_lib.require_cuda(r, c, m, la)
    h, w = r.shape
    nb = (h // n) * (w // n)
    if c.shape != (nb, n, n) or m.shape != (nb, 2) or la.shape != (nb,) \
            or n not in (16, 32):
        raise ValueError("subpel_refine: bad shapes")
    mv_q = torch.empty((nb, 2), dtype=torch.int32, device=r.device)
    ssd = torch.empty(nb, dtype=torch.float32, device=r.device)
    if nb:
        rc = _lib("subpel", "subpel_refine", [_VP, _I, _I] + [_VP] * 3
                  + [_I] + [_VP] * 3).subpel_refine(
            cuda_lib.ptr(r), h, w, cuda_lib.ptr(c), cuda_lib.ptr(m),
            cuda_lib.ptr(la), n, cuda_lib.ptr(mv_q), cuda_lib.ptr(ssd),
            _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("subpel", rc)
    return mv_q, ssd


def _mc(plane, mv, n, chroma):
    if plane.device.type == "cpu":
        return (mc_chroma_qpel_plain if chroma else mc_luma_qpel_plain)(
            plane, mv, n)
    p = _plane_arg(plane)
    m = mv.to(torch.int32).contiguous()
    cuda_lib.require_cuda(p, m)
    h, w = p.shape
    nb = (h // n) * (w // n)
    if m.shape != (nb, 2) or n not in (8, 16, 32):
        raise ValueError("mc_qpel: bad shapes")
    out = torch.empty((nb, n, n), dtype=torch.int32, device=p.device)
    if nb:
        rc = _lib("mc_qpel", "mc_qpel", [_VP, _I, _I, _VP, _I, _I, _I, _VP,
                                         _VP]).mc_qpel(
            cuda_lib.ptr(p), h, w, cuda_lib.ptr(m), nb, n, int(chroma),
            cuda_lib.ptr(out), _VP(cuda_lib.stream_handle(p)))
        cuda_lib.launched("mc_qpel", rc)
    return out


def mc_luma_qpel(plane, mv, n: int = 16):
    """See mc_luma_qpel_plain; a CUDA tensor launches `csrc/mc_qpel.cu`."""
    return _mc(plane, mv, n, False)


def mc_chroma_qpel(plane, mv, n: int = 8):
    """See mc_chroma_qpel_plain; a CUDA tensor launches `csrc/mc_qpel.cu`."""
    return _mc(plane, mv, n, True)


def hpel_plane(ref):
    """See hpel_plane_plain; a CUDA tensor launches `csrc/hpel.cu`."""
    if ref.device.type == "cpu":
        return hpel_plane_plain(ref)
    r = _plane_arg(ref)
    cuda_lib.require_cuda(r)
    h, w = r.shape
    out = torch.empty((h, w), dtype=torch.int32, device=r.device)
    if h * w:
        rc = _lib("hpel", "hpel_plane", [_VP, _I, _I, _VP, _VP]).hpel_plane(
            cuda_lib.ptr(r), h, w, cuda_lib.ptr(out),
            _VP(cuda_lib.stream_handle(r)))
        cuda_lib.launched("hpel", rc)
    return out
