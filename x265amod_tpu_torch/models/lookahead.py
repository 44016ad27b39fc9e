"""Lookahead pre-analysis of the port (the JAX package's
`models/lookahead.py`, role of the reference `encoder/slicetype.cpp`):
the lowres plane, auto-variance AQ, the lowres intra and inter costs,
scene cuts and CU-tree propagation, as config 3 runs them (`aq_mode` 2,
`cutree`, `rc_lookahead` 4).

Device functions, each a kernel beside its plain PyTorch version (a CPU
tensor takes the plain version, a CUDA tensor launches the kernel or
raises):

- `lowres_aq` (kernel K12 `csrc/lowres_aq.cu`): JAX `lowres_half` (:39)
  and `aq_offsets` (:64) in one pass over the full-resolution planes;
- `lowres_intra_cost` (JAX :131): kernel K1 `intra_satd35` on the lowres
  8x8 blocks with source references, its launches counted apart from the
  trees' (`cuda_lib.LAUNCHES["intra_pred_lowres"]`);
- `lowres_inter_cost` (kernel K13 `csrc/lowres_me.cu`, JAX :90): the full
  +-8 search of every lowres 8x8 block against the previous lowres plane;
- `cutree_propagate_step` (kernel K14 `csrc/cutree_prop.cu`, JAX :160):
  one CU-tree back-propagation step, as a deterministic gather.

The host code (`cutree_offsets`, `FrameAnalysis`, `Lookahead`) is the JAX
package's, in numpy: the scene-cut sums are numpy's f32 sums of the
host copies of the cost maps, and the CU-tree offsets an f64 log2.  The
lowres planes stay on the device; the [hb, wb] cost and MV maps and the
[hc, wc] AQ map come to the host once per frame, and each CU-tree step
brings its propagate map back for `cutree_offsets`.

Numerics against the JAX functions:
- `lowres_half`, `lowres_intra_cost`, `lowres_inter_cost` and
  `cutree_propagate_step` are exact: the JAX SSD terms are integers below
  2^24, its scatter adds in XLA's CPU order (scatter 1 over the sources in
  row-major order, then scatters 2, 3 and 4), which the gather repeats
  per target block;
- `aq_offsets` is within 1e-5: JAX forms each 8x8 variance as an f32 sum
  of rounded squares, the port the exact energy (64 sum x^2 - (sum x)^2 in
  integers), its log2 in f64 rounded to f32, and the frame mean as an f64
  sum of the f32 values (exact, so in any order) divided once.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ..ops import cuda_lib
from ..ops.intra import satd35

LOWRES_ME_RANGE = 8
# QG size of the AQ offsets: one offset per 16x16 luma block (JAX qg=16)
AQ_QG = 16
# the AQ slope of the JAX `aq_offsets` (times the strength)
_AQ_SCALE = 1.0397


# ---------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------


def lowres_half(y):
    """Half-resolution plane [H/2, W/2] uint8: the rounded 2x2 mean (JAX
    `lowres_half`, reference frameInitLowres)."""
    y = y.to(torch.int32)
    return ((y[0::2, 0::2] + y[1::2, 0::2] + y[0::2, 1::2] + y[1::2, 1::2]
             + 2) >> 2).to(torch.uint8)


def _energy64(plane, rows: int, cols: int):
    """64 x the variance sum of each 8x8 block, exact: 64 sum x^2 -
    (sum x)^2, int64 [rows, cols]."""
    b = plane[:8 * rows, :8 * cols].to(torch.int64) \
        .reshape(rows, 8, cols, 8)
    s = b.sum((1, 3))
    return 64 * (b * b).sum((1, 3)) - s * s


def aq_scale(strength: float) -> float:
    """The f32 factor of the offsets: JAX multiplies its f32 array by the
    Python float strength * 1.0397, which it rounds to f32."""
    return float(np.float32(strength * _AQ_SCALE))


def aq_offsets(y, cb, cr, strength: float = 1.0):
    """Auto-variance AQ (reference aq-mode 2, JAX `aq_offsets`): per 16x16
    block, the energy of its four luma 8x8 blocks and of the co-located
    cb and cr 8x8 blocks, s = log2(energy + 1), offset = f32(strength *
    1.0397) (s - mean s).  f32 [H/16, W/16]."""
    h, w = y.shape
    hc, wc = h // AQ_QG, w // AQ_QG
    e = (_energy64(y, 2 * hc, 2 * wc).reshape(hc, 2, wc, 2).sum((1, 3))
         + _energy64(cb, hc, wc) + _energy64(cr, hc, wc))
    s = torch.log2(e.to(torch.float64) / 64.0 + 1.0).to(torch.float32)
    mean = (s.to(torch.float64).sum() / s.numel()).to(torch.float32)
    return torch.tensor(aq_scale(strength), dtype=torch.float32,
                        device=y.device) * (s - mean)


def lowres_aq_plain(y, cb, cr, strength: float = 1.0):
    """Plain version of K12: (lowres plane uint8 [H/2, W/2], AQ offsets f32
    [H/16, W/16])."""
    return lowres_half(y), aq_offsets(y, cb, cr, strength)


def lowres_inter_cost_plain(cur_lr, ref_lr, rng: int = LOWRES_ME_RANGE):
    """Plain version of K13 (JAX `lowres_inter_cost`): every 8x8 block of
    cur_lr [h, w] against ref_lr at every offset in [-rng, rng]^2 (edge
    padded); the exact integer SSD, its first minimum in dy-major order,
    cost sqrt(ssd * 64) in f32.  Returns (cost f32 [hb, wb], mv int32 [hb,
    wb, 2] as (x, y))."""
    h, w = cur_lr.shape
    hb, wb = h // 8, w // 8
    s = 2 * rng + 1
    dev = cur_lr.device
    rows = torch.clamp(torch.arange(-rng, h + rng, device=dev), 0, h - 1)
    cols = torch.clamp(torch.arange(-rng, w + rng, device=dev), 0, w - 1)
    refp = ref_lr.to(torch.int32)[rows][:, cols]       # edge padded
    cur = cur_lr.to(torch.int32).reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    # first column of the window of block bx at offset dx: 8 bx + dx
    start = (torch.arange(wb, device=dev)[:, None] * 8
             + torch.arange(s, device=dev)[None, :])
    ssd = torch.empty((hb, wb, s, s), dtype=torch.int32, device=dev)
    for dy in range(s):
        band = refp[dy:dy + 8 * hb].reshape(hb, 8, -1).unfold(2, 8, 1)
        win = band[:, :, start].permute(0, 2, 3, 1, 4)  # [hb, wb, s, 8, 8]
        d = win - cur[:, :, None]
        ssd[:, :, dy] = (d * d).sum((-2, -1))
    flat_ssd = ssd.reshape(hb, wb, s * s)
    cost = flat_ssd.amin(-1)
    flat = torch.argmin(flat_ssd, -1)             # the first minimum
    mv = torch.stack([flat % s - rng, flat // s - rng], -1).to(torch.int32)
    # ssd * 64 is exact; the f64 root rounds to the correctly rounded f32
    # root (torch's f32 sqrt on the CPU is not always correctly rounded)
    return torch.sqrt(cost.to(torch.float64) * 64.0).to(torch.float32), mv


def lowres_intra_refs(cur_lr):
    """The 8x8 lowres blocks [hb*wb, 8, 8] int32 and K1's raw references
    with per-sample availability (JAX `lowres_intra_cost` with
    `substitute_refs`): left iff cx > 0, below-left never, top iff cy > 0,
    top-right iff cy > 0 and cx < wb - 1, corner iff both left and top."""
    h, w = cur_lr.shape
    hb, wb = h // 8, w // 8
    dev = cur_lr.device
    cur = cur_lr.to(torch.int32).reshape(hb, 8, wb, 8).permute(0, 2, 1, 3)
    cy = torch.arange(hb, device=dev)[:, None].expand(hb, wb).reshape(-1)
    cx = torch.arange(wb, device=dev)[None, :].expand(hb, wb).reshape(-1)
    cyu = torch.clamp(cy - 1, min=0)
    cxl = torch.clamp(cx - 1, min=0)
    cxr = torch.clamp(cx + 1, max=wb - 1)
    left0 = cur[cy, cxl, :, 7]
    top_ok, left_ok = cy > 0, cx > 0

    def bc(flag):
        return flag[:, None].expand(-1, 8)
    refs = (torch.cat([cur[cyu, cx, 7, :], cur[cyu, cxr, 7, :]], 1),
            torch.cat([left0, left0], 1), cur[cyu, cxl, 7, 7],
            torch.cat([bc(top_ok), bc(top_ok & (cx < wb - 1))], 1),
            torch.cat([bc(left_ok), bc(torch.zeros_like(left_ok))], 1),
            top_ok & left_ok)
    return cur.reshape(-1, 8, 8), refs


def lowres_intra_cost(cur_lr):
    """Best 35-mode 8x8 SATD of every lowres block, f32 [hb, wb] (JAX
    `lowres_intra_cost`): K1 on a CUDA tensor, its plain version on a CPU
    tensor."""
    h, w = cur_lr.shape
    orig, refs = lowres_intra_refs(cur_lr)
    sat = satd35(orig, *refs, 8, 0, counter="intra_pred_lowres")
    return sat.amin(1).to(torch.float32).reshape(h // 8, w // 8)


def _propagate_terms(prop_in, intra_cost, inter_cost, mv):
    """Per source block: the propagated amount and its four bilinear
    targets and weights, in the JAX order of operations."""
    hb, wb = intra_cost.shape
    dev = intra_cost.device
    inter_c = torch.minimum(inter_cost, intra_cost)
    ratio = torch.where(intra_cost > 0, (intra_cost - inter_c)
                        / torch.clamp(intra_cost, min=1.0),
                        torch.zeros_like(intra_cost))
    amount = (intra_cost + prop_in) * ratio
    by = torch.arange(hb, device=dev)[:, None] * 8 + mv[:, :, 1]
    bx = torch.arange(wb, device=dev)[None, :] * 8 + mv[:, :, 0]
    x0 = torch.clamp(torch.div(bx, 8, rounding_mode="floor"), 0, wb - 1)
    y0 = torch.clamp(torch.div(by, 8, rounding_mode="floor"), 0, hb - 1)
    x1 = torch.clamp(x0 + 1, 0, wb - 1)
    y1 = torch.clamp(y0 + 1, 0, hb - 1)
    fx = torch.clamp((bx - x0 * 8).to(torch.float32) / 8.0, 0.0, 1.0)
    fy = torch.clamp((by - y0 * 8).to(torch.float32) / 8.0, 0.0, 1.0)
    return ((y0, x0, amount * (1 - fx) * (1 - fy)),
            (y0, x1, amount * fx * (1 - fy)),
            (y1, x0, amount * (1 - fx) * fy),
            (y1, x1, amount * fx * fy))


def _gather_radius(rng: int) -> int:
    """A target receives from sources at most this many blocks away: x0
    lies within ceil(rng / 8) of the source and x1 one further."""
    return -(-rng // 8) + 1


def cutree_propagate_step_plain(prop_in, intra_cost, inter_cost, mv,
                                rng: int = LOWRES_ME_RANGE):
    """Plain version of K14 (JAX `cutree_propagate_step`): the share of
    each block's (cost + inherited propagate) that inter prediction
    explains, spread bilinearly over the blocks its MV points at.  JAX
    scatters with four `.at[].add`; here each target block sums its
    sources as XLA's CPU scatter does: scatter 1 over the sources in
    row-major order, then scatters 2, 3 and 4.  Requires |mv| <= rng.
    f32 [hb, wb]."""
    hb, wb = intra_cost.shape
    dev = intra_cost.device
    r = _gather_radius(rng)
    ty = torch.arange(hb, device=dev)[:, None].expand(hb, wb)
    tx = torch.arange(wb, device=dev)[None, :].expand(hb, wb)
    out = torch.zeros((hb, wb), dtype=torch.float32, device=dev)
    for yk, xk, wk in _propagate_terms(prop_in, intra_cost, inter_cost, mv):
        # -1 marks the padding: no target matches it
        pad = (r, r, r, r)
        yk = torch.nn.functional.pad(yk, pad, value=-1)
        xk = torch.nn.functional.pad(xk, pad, value=-1)
        wk = torch.nn.functional.pad(wk, pad)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                sl = (slice(r + dy, r + dy + hb), slice(r + dx, r + dx + wb))
                hit = (yk[sl] == ty) & (xk[sl] == tx)
                out = torch.where(hit, out + wk[sl], out)
    return out


# ---------------------------------------------------------------------------
# kernel wrappers: K12 lowres_aq, K13 lowres_me, K14 cutree_prop
# ---------------------------------------------------------------------------

_VP = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


# the C entry point of each kernel library and its argument types
_ARGTYPES = {"lowres_aq": [_VP] * 6 + [_I, _I, _F, _VP],
             "lowres_me": [_VP] * 4 + [_I, _I, _I, _VP],
             "cutree_prop": [_VP] * 5 + [_I, _I, _I, _VP]}


def _entry(name):
    lib = cuda_lib.lib(name)
    fn = getattr(lib, name)
    if not getattr(lib, "_typed", False):
        fn.argtypes = _ARGTYPES[name]
        fn.restype = _I
        lib._typed = True
    return fn


def lowres_aq(y, cb, cr, strength: float = 1.0):
    """(lowres plane uint8 [H/2, W/2], AQ offsets f32 [H/16, W/16]) of one
    frame's uint8 planes y [H, W], cb/cr [H/2, W/2]; H and W multiples of
    16.  K12 on CUDA tensors: one pass reads each plane once."""
    if y.device.type == "cpu":
        return lowres_aq_plain(y, cb, cr, strength)
    h, w = y.shape
    if h % AQ_QG or w % AQ_QG or cb.shape != (h // 2, w // 2) \
            or cr.shape != cb.shape:
        raise ValueError("lowres_aq: planes must be [H, W] and [H/2, W/2] "
                         "with H, W multiples of 16")
    if {t.dtype for t in (y, cb, cr)} != {torch.uint8}:
        raise ValueError("lowres_aq: uint8 planes")
    y, cb, cr = (t.contiguous() for t in (y, cb, cr))
    cuda_lib.require_cuda(y, cb, cr)
    lr = torch.empty((h // 2, w // 2), dtype=torch.uint8, device=y.device)
    s = torch.empty((h // AQ_QG, w // AQ_QG), dtype=torch.float32,
                    device=y.device)
    off = torch.empty_like(s)
    rc = _entry("lowres_aq")(
        *(cuda_lib.ptr(t) for t in (y, cb, cr, lr, s, off)), h, w,
        aq_scale(strength), _VP(cuda_lib.stream_handle(y)))
    cuda_lib.launched("lowres_aq", rc)
    return lr, off


def lowres_inter_cost(cur_lr, ref_lr, rng: int = LOWRES_ME_RANGE):
    """(cost f32 [hb, wb], mv int32 [hb, wb, 2]) of every lowres 8x8 block
    of cur_lr against ref_lr (uint8 [h, w], h and w multiples of 8); K13
    on CUDA tensors."""
    if cur_lr.device.type == "cpu":
        return lowres_inter_cost_plain(cur_lr, ref_lr, rng)
    h, w = cur_lr.shape
    if ref_lr.shape != cur_lr.shape or h % 8 or w % 8 or not 1 <= rng <= 16:
        raise ValueError("lowres_inter_cost: bad shapes or range")
    if cur_lr.dtype != torch.uint8 or ref_lr.dtype != torch.uint8:
        raise ValueError("lowres_inter_cost: uint8 planes")
    cur, ref = cur_lr.contiguous(), ref_lr.contiguous()
    cuda_lib.require_cuda(cur, ref)
    cost = torch.empty((h // 8, w // 8), dtype=torch.float32,
                       device=cur.device)
    mv = torch.empty((h // 8, w // 8, 2), dtype=torch.int32,
                     device=cur.device)
    rc = _entry("lowres_me")(
        *(cuda_lib.ptr(t) for t in (cur, ref, cost, mv)), h, w, rng,
        _VP(cuda_lib.stream_handle(cur)))
    cuda_lib.launched("lowres_me", rc)
    return cost, mv


def cutree_propagate_step(prop_in, intra_cost, inter_cost, mv,
                          rng: int = LOWRES_ME_RANGE):
    """One CU-tree step: the previous frame's propagate-in f32 [hb, wb]
    from this frame's prop_in, intra and inter costs (f32 [hb, wb]) and
    lowres MVs (int32 [hb, wb, 2], |mv| <= rng); K14 on CUDA tensors."""
    if prop_in.device.type == "cpu":
        return cutree_propagate_step_plain(prop_in, intra_cost, inter_cost,
                                           mv, rng)
    hb, wb = intra_cost.shape
    if prop_in.shape != (hb, wb) or inter_cost.shape != (hb, wb) \
            or mv.shape != (hb, wb, 2) or not 1 <= rng <= 16:
        raise ValueError("cutree_propagate_step: bad shapes or range")
    f32 = [t.to(torch.float32).contiguous()
           for t in (prop_in, intra_cost, inter_cost)]
    mv = mv.to(torch.int32).contiguous()
    cuda_lib.require_cuda(*f32, mv)
    out = torch.empty((hb, wb), dtype=torch.float32, device=mv.device)
    rc = _entry("cutree_prop")(
        *(cuda_lib.ptr(t) for t in (*f32, mv, out)), hb, wb, rng,
        _VP(cuda_lib.stream_handle(mv)))
    cuda_lib.launched("cutree_prop", rc)
    return out


# ---------------------------------------------------------------------------
# host decisions (numpy, as the JAX package keeps them)
# ---------------------------------------------------------------------------


def cutree_offsets(intra_cost: np.ndarray, prop_in: np.ndarray,
                   strength: float = 2.0) -> np.ndarray:
    """Final CU-tree QP offset (reference cuTreeFinish):
    -strength * log2(1 + propagate/intra), in f64, then f32."""
    ic = np.maximum(np.asarray(intra_cost, np.float64), 1.0)
    return (-strength * np.log2(1.0 + np.asarray(prop_in) / ic)) \
        .astype(np.float32)


@dataclass
class FrameAnalysis:
    display: int
    aq: np.ndarray                  # [hc, wc] per-CTU16 QP offsets
    intra_cost: np.ndarray          # [hb, wb] lowres 8x8 intra SATD
    inter_cost: np.ndarray | None   # vs previous frame (None for first)
    mv: np.ndarray | None           # lowres MV field vs previous
    is_scenecut: bool = False
    pred_ratio: float = 0.0         # inter/intra cost ratio (0 = first)
    cutree: np.ndarray | None = None   # [hb, wb] qp offsets (<= 0)
    lowres: object = None           # device lowres plane
    dev: tuple | None = None        # device (intra, inter, mv) for CU-tree


class Lookahead:
    """Host decision loop over the device analysis (JAX `Lookahead`).

    push() frames in display order; analyses come back with scene-cut
    flags and per-CTU QP offset maps after ``depth`` frames of latency
    (the reference's rc-lookahead), so CU-tree back-propagates through the
    queued window before a frame is released."""

    def __init__(self, width: int, height: int, strength: float = 1.0,
                 depth: int = 8, scenecut_bias: float = 0.4,
                 cutree: bool = True, cutree_strength: float = 2.0,
                 min_keyint: int = 2, device="cuda"):
        self.w, self.h = width, height
        self.strength = strength
        self.depth = max(1, depth)
        self.bias = scenecut_bias
        self.cutree = cutree
        self.cutree_strength = cutree_strength
        self.min_keyint = min_keyint
        self.device = torch.device(device)
        self._prev_lowres = None
        self._queue: list[FrameAnalysis] = []
        self._disp = 0
        self._since_key = 0

    def _upload(self, a):
        return torch.as_tensor(np.ascontiguousarray(a, np.uint8),
                               device=self.device)

    def _analyse(self, y, cb, cr) -> FrameAnalysis:
        lr, aq = lowres_aq(self._upload(y), self._upload(cb),
                           self._upload(cr), self.strength)
        icost = lowres_intra_cost(lr)
        inter = mv = None
        if self._prev_lowres is not None:
            inter, mv = lowres_inter_cost(lr, self._prev_lowres)

        def host(t):
            return None if t is None else t.cpu().numpy()
        fa = FrameAnalysis(
            display=self._disp, aq=host(aq), intra_cost=host(icost),
            inter_cost=host(inter), mv=host(mv), lowres=lr,
            dev=(icost, inter, mv))
        self._prev_lowres = lr
        self._disp += 1
        return fa

    def _decide_scenecut(self, fa: FrameAnalysis) -> bool:
        if fa.inter_cost is None:
            return True                      # first frame
        self._since_key += 1
        isum = float(fa.intra_cost.sum()) + 1.0
        psum = float(np.minimum(fa.inter_cost, fa.intra_cost).sum())
        fa.pred_ratio = psum / isum
        if self.bias <= 0:                   # --no-scenecut
            return False
        if self._since_key < self.min_keyint:
            return False
        # reference scenecut: P cost not much cheaper than I cost
        if psum > (1.0 - self.bias) * isum:
            self._since_key = 0
            return True
        return False

    def _run_cutree(self) -> None:
        """Back-propagate over the queued window, newest -> oldest (the
        reference runs the same loop over the lookahead buffer)."""
        prop = torch.zeros(self._queue[-1].intra_cost.shape,
                           dtype=torch.float32, device=self.device)
        for fa in reversed(self._queue):
            fa.cutree = cutree_offsets(fa.intra_cost, prop.cpu().numpy(),
                                       self.cutree_strength)
            if fa.inter_cost is None or fa.is_scenecut:
                prop = torch.zeros_like(prop)
                continue
            prop = cutree_propagate_step(prop, *fa.dev)

    def push(self, y, cb, cr) -> list[FrameAnalysis]:
        fa = self._analyse(y, cb, cr)
        fa.is_scenecut = self._decide_scenecut(fa)
        if fa.is_scenecut:
            self._since_key = 0
        self._queue.append(fa)
        if len(self._queue) >= self.depth:
            if self.cutree:
                self._run_cutree()
            out, self._queue = self._queue[:1], self._queue[1:]
            return out
        return []

    def flush(self) -> list[FrameAnalysis]:
        if self._queue and self.cutree:
            self._run_cutree()
        out, self._queue = self._queue, []
        return out

    def ctu_qp_offsets(self, fa: FrameAnalysis) -> np.ndarray:
        """Combine AQ + CU-tree into per-CTU16 QP offsets [hc, wc]."""
        off = fa.aq.copy()
        if fa.cutree is not None:
            ct = fa.cutree
            hb, wb = ct.shape
            hc, wc = off.shape
            # lowres 8x8 == full-res 16x16: shapes match when dims align
            off[:min(hc, hb), :min(wc, wb)] += \
                ct[:min(hc, hb), :min(wc, wb)]
        return np.clip(off, -12.0, 12.0)
