"""RDOQ level 1 (row 21 of the kernel table): the plain PyTorch version of
the JAX package's `ops/rdoq.py:rdoq_adjust`, and the tables that kernel K2's
RDOQ stage (`csrc/residual_chain.cu`) reads.

For every coefficient the level moves from ``hi = |l|`` to ``lo = |l| - 1``
when ``(q - lo)^2 step + lam R(lo) < (q - hi)^2 step + lam R(hi)``, with
``q = |c| scale / 2^qbits`` the unrounded level, ``step`` the pixel SSD of a
one-level step and ``R`` the init-state bit cost of a level.  Then a whole
4x4 coefficient group is zeroed when that is cheaper by the same measure.

The reference's quirks are copied, not repaired:

- ``qbits`` and ``step`` are those of bit depth 8 whatever the chain's bit
  depth (JAX `ops/rdoq.py:106,110`); the port refuses Main10 with RDOQ.
- The group pass prices its coded-sub-block flags at QP 30 (`:127`).
- ``floor(log2(.))`` of the Golomb-Rice escape is XLA's f32 ``log`` times
  ``1/ln 2``, which rounds 8192 down to 12.99999 (`floor_log2_xla`).

XLA's CPU code (the reference the tests hold the port to) contracts each
``x * y + z`` whose product has one use into a fused multiply-add, and sums
each group's 16 terms in a fixed order; `rdoq_adjust_plain` spells out the
same operations in the same order, and `fma32` rounds once as an FMA does:
- the coefficient cost: ``fma(step, (q - l)^2, lam * R(l))``;
- the group's coded distortion: eight lanes ``fma(step, d[k + 8], step d[k])``
  added as ``((L0 + L4) + (L2 + L6)) + ((L1 + L5) + (L3 + L7))``; its rate
  the same tree over ``R[k] + R[k + 8]``;
- the group's zero distortion: one FMA chain over k = 0..15;
- ``j_code = fma(lam, r_code + csb1, d_code)`` and ``j_zero = d_zero +
  lam * csb0`` (this product has another use, so it is rounded).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .estbits import bit_consts
from .quant import QUANT_SCALES, dequant
from .transforms import inv_transform

QUANT_SCALES_F32 = QUANT_SCALES.astype(np.float32)

# floor(log2(x)) values XLA's f32 log2 gets one too low, over the escape
# domain 1..32763 (x = |level| - 5, |level| <= 32768)
XLA_LOG2_LOW = (8192,)


@functools.lru_cache(maxsize=None)
def pixel_step_sse(n: int) -> np.ndarray:
    """[52] f32: pixel-domain SSD of a one-level step at each QP for an
    n x n TU (JAX `_pixel_step_sse`): level 1 at (1, 1) through the
    normative dequant and inverse transform at bit depth 8, summed in f64,
    then rounded to f32."""
    lv = torch.zeros((52, n, n), dtype=torch.int32)
    lv[:, 1, 1] = 1
    qp = torch.arange(52)[:, None, None]
    px = inv_transform(dequant(lv, qp)).to(torch.float64)
    return (px ** 2).sum((1, 2)).numpy().astype(np.float32)


@functools.lru_cache(maxsize=None)
def rate_consts(st: str, c_idx: int) -> np.ndarray:
    """[4, 52] f32 bit costs of a level 0, 1, 2 and >= 3 (before its Golomb
    tail) at each QP's init states (JAX `_rate_of_level_consts`)."""
    r = np.zeros((4, 52), np.float32)
    for qp in range(52):
        k = bit_consts(st, qp, 1 if c_idx else 0)
        r[0, qp] = k[6]
        r[1, qp] = k[7] + k[8] + 1.0
        r[2, qp] = k[7] + k[9] + k[10] + 1.0
        r[3, qp] = k[7] + k[9] + k[10] + 1.0
    return r


def group_csb(st: str, c_idx: int) -> tuple:
    """(csb0, csb1) as f32: the coded-sub-block flag costs of the group
    pass, at QP 30 whatever the block's QP."""
    k = bit_consts(st, 30, 1 if c_idx else 0)
    return np.float32(k[2]), np.float32(k[3])


@functools.lru_cache(maxsize=None)
def kernel_table(n: int, st: str, c_idx: int) -> np.ndarray:
    """f32 [262]: step[52], the rates [4, 52] and (csb0, csb1), the layout
    K2's RDOQ stage reads."""
    return np.concatenate([pixel_step_sse(n), rate_consts(st, c_idx).ravel(),
                           np.asarray(group_csb(st, c_idx), np.float32)])


def fma32(a, b, c):
    """f32 a * b + c rounded once (a fused multiply-add) for f32 tensors.
    The product is exact in f64 and TwoSum gives the sum's f64 rounding
    error, so the one case the f64 sum rounds wrongly for f32 (an exact
    f32 midpoint with a nonzero error) is steered toward the error."""
    a, b, c = torch.broadcast_tensors(a.double(), b.double(), c.double())
    p = a * b
    s = p + c
    bb = s - p
    err = (p - (s - bb)) + (c - bb)
    r = s.to(torch.float32)
    other = torch.nextafter(r, torch.where(s > r.double(), float("inf"),
                                           -float("inf")).to(torch.float32))
    mid = (s == (r.double() + other.double()) / 2) & (err != 0)
    toward = torch.where(err > 0, torch.maximum(r, other),
                         torch.minimum(r, other))
    return torch.where(mid, toward, r)


def floor_log2_xla(x):
    """floor(log2(x)) of an int64 tensor x >= 1 as XLA's f32 forms it."""
    out = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        big = y >= (1 << s)
        out = out + torch.where(big, s, 0)
        y = torch.where(big, y >> s, y)
    for v in XLA_LOG2_LOW:
        out = out - (x == v).to(out.dtype)
    return out


def golomb_bits(rem):
    """JAX `_golomb_bits` of int64 rem = level - 3 -> f32."""
    remc = torch.clamp(rem, min=0)
    pref = torch.clamp(remc, max=3).to(torch.float32) + 1.0
    lg = floor_log2_xla(torch.clamp(remc - 2, min=1)).to(torch.float32)
    esc = torch.where(remc >= 3, 2.0 * (lg + 1.0), 0.0)
    return torch.where(remc > 0, pref + esc, 0.0)


def level_rate(l, qp, rtab):
    """JAX `_rate`: f32 bits of levels l >= 0 (int64) at QPs qp (int64,
    same shape); rtab [4, 52] f32 tensor."""
    r = rtab[:, qp]
    return torch.where(l == 0, r[0], torch.where(
        l == 1, r[1], torch.where(l == 2, r[2], r[3] + golomb_bits(l - 3))))


def _lanes_tree(term):
    """Sum of term(k) for k = 0..15 in XLA's vectorised reduce order:
    eight lanes of k and k + 8, then a halving tree."""
    lanes = [term(k, k + 8) for k in range(8)]
    a = [lanes[k] + lanes[k + 4] for k in range(4)]
    return (a[0] + a[2]) + (a[1] + a[3])


def rdoq_adjust_plain(coeff, levels, qp, lam, c_idx: int = 0, st: str = "P",
                      cg_pass: bool = True):
    """RDOQ of ``levels`` [..., n, n] (JAX `rdoq_adjust`): coeff are the
    unquantized coefficients (same shape), qp (int) and lam (f32) are per
    block, broadcastable to the lead shape.  Returns the adjusted levels
    (|l| only decreases), in levels' dtype."""
    n = levels.shape[-1]
    lead = levels.shape[:-2]
    dev = levels.device
    qpb = torch.clamp(torch.broadcast_to(torch.as_tensor(qp, device=dev),
                                         lead).reshape(-1).long(), 0, 51)
    lamb = torch.broadcast_to(torch.as_tensor(lam, device=dev), lead) \
        .reshape(-1).to(torch.float32)
    a = levels.reshape(-1, n, n).long().abs()
    sgn = torch.sign(levels.reshape(-1, n, n).long())
    c = coeff.reshape(-1, n, n).long().abs().to(torch.float32)
    nb = a.shape[0]
    log2n = n.bit_length() - 1
    scale = torch.as_tensor(QUANT_SCALES_F32, device=dev)[qpb % 6]
    qbits = 14 + qpb // 6 + (15 - 8 - log2n)
    q = (c * scale[:, None, None]) / torch.bitwise_left_shift(
        torch.ones_like(qbits), qbits).to(torch.float32)[:, None, None]
    step = torch.as_tensor(pixel_step_sse(n), device=dev)[qpb]
    rtab = torch.as_tensor(rate_consts(st, c_idx), device=dev)
    kq = qpb[:, None, None].expand(nb, n, n)
    s3, l3 = step[:, None, None], lamb[:, None, None]

    def cost(lv):
        d = q - lv.to(torch.float32)
        return fma32(s3, d * d, l3 * level_rate(lv, kq, rtab))

    lo = torch.clamp(a - 1, min=0)
    l1 = torch.where((a > 0) & (cost(lo) < cost(a)), lo, a)

    if cg_pass:
        csb0, csb1 = group_csb(st, c_idx)

        def groups(t):
            return t.reshape(nb, n // 4, 4, n // 4, 4).permute(0, 1, 3, 2, 4) \
                .reshape(nb, -1, 16)
        g, qe = groups(l1), groups(q)
        sg = step[:, None]
        dc = qe - g.to(torch.float32)
        dsq = dc * dc
        zsq = qe * qe
        rr = level_rate(g, qpb[:, None, None].expand_as(g), rtab)
        d_code = _lanes_tree(lambda i, j: fma32(sg, dsq[..., j],
                                                sg * dsq[..., i]))
        r_code = _lanes_tree(lambda i, j: rr[..., i] + rr[..., j])
        d_zero = sg * zsq[..., 0]
        for k in range(1, 16):
            d_zero = fma32(sg, zsq[..., k], d_zero)
        lg = lamb[:, None]
        j_code = fma32(lg, r_code + torch.tensor(csb1), d_code)
        j_zero = d_zero + lg * torch.tensor(csb0)
        kill = (g > 0).any(2) & (j_zero < j_code)
        g = torch.where(kill[:, :, None], 0, g)
        m = n // 4
        l1 = g.reshape(nb, m, m, 4, 4).permute(0, 1, 3, 2, 4) \
            .reshape(nb, n, n)
    return (sgn * l1).reshape(levels.shape).to(levels.dtype)
