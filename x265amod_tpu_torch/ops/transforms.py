"""HEVC integer DCT 8/16/32 (forward HM-style, inverse normative 8.6.4):
plain PyTorch versions, part of kernel K2's chain (`ops/residual.py`).

The JAX package runs these as exact f32 MXU matmuls with hi/lo byte splits
(`ops/transforms.py`).  Here the products run in float64, where every
partial sum of these integer operands (below 2^31) is exact, so the result
is the integer transform on any device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

_C32 = np.array([64, 90, 90, 90, 89, 88, 87, 85, 83, 82, 80, 78, 75, 73,
                 70, 67, 64, 61, 57, 54, 50, 46, 43, 38, 36, 31, 25, 22,
                 18, 13, 9, 4], dtype=np.int64)


def _tuned_cos(m: int) -> int:
    m %= 128
    if m <= 32:
        return int(_C32[m]) if m < 32 else 0
    if m <= 64:
        return -int(_C32[64 - m]) if 64 - m < 32 else 0
    if m <= 96:
        return -int(_C32[m - 64]) if m - 64 < 32 else 0
    return int(_C32[128 - m])


@functools.lru_cache(maxsize=None)
def dct_matrix(n: int) -> np.ndarray:
    """NxN integer DCT-II basis (rows = basis vectors), spec 8.6.4.2."""
    assert n in (4, 8, 16, 32)
    step = 32 // n
    return np.array([[_tuned_cos((k * step) * (2 * j + 1))
                      for j in range(n)] for k in range(n)], dtype=np.int32)


def _mat(n, device):
    return torch.as_tensor(dct_matrix(n), dtype=torch.float64,
                           device=device)


def _round_shift(x, shift: int):
    return (x + (1 << (shift - 1))) >> shift


def fwd_transform(resi, bit_depth: int = 8):
    """resi [..., N, N] int -> coeff int32 (stage shifts log2N+bd-9 and
    log2N+6)."""
    n = resi.shape[-1]
    t = _mat(n, resi.device)
    log2n = n.bit_length() - 1
    tmp = _round_shift(torch.matmul(resi.to(torch.float64), t.T)
                       .to(torch.int64), log2n + bit_depth - 9)
    coeff = torch.matmul(t, tmp.to(torch.float64)).to(torch.int64)
    return _round_shift(coeff, log2n + 6).to(torch.int32)


def inv_transform(coeff, bit_depth: int = 8):
    """Normative inverse transform of coeff [..., N, N] int -> int32."""
    n = coeff.shape[-1]
    t = _mat(n, coeff.device)
    e = torch.matmul(t.T, coeff.to(torch.float64)).to(torch.int64)
    g = torch.clamp(_round_shift(e, 7), -32768, 32767)
    r = torch.matmul(g.to(torch.float64), t).to(torch.int64)
    return torch.clamp(_round_shift(r, 20 - bit_depth), -32768,
                       32767).to(torch.int32)
