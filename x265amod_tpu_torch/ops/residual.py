"""Kernel K2 `residual_chain`: forward DCT -> quant -> sign-bit hiding ->
dequant -> inverse DCT -> add prediction -> clip, with the SSD of the
reconstruction, for K candidate predictions per block.

Counterpart of the chain the JAX package spells out in
`models/intra_tree.py:eval_intra_luma/eval_intra_chroma` and in the P tree's
`inter_trial`/`coded16` (`models/inter_tree.py:239,619`): `fwd_transform`,
`quant` (intra or inter rounding), `sbh_adjust`, `dequant`,
`inv_transform`.  The plain version
below composes the plain ops; a CUDA tensor launches `csrc/residual_chain.cu`.
"""

from __future__ import annotations

import ctypes

import torch

from . import cuda_lib
from .quant import dequant, quant
from .sbh import sbh_adjust
from .transforms import fwd_transform, inv_transform


def residual_chain_plain(orig, pred, qp, sbh: bool, want_recon=True,
                         intra: bool = True):
    """orig [B, n, n], pred [B, K, n, n], qp [B] (int) -> (levels int16
    [B, K, n, n], recon int32 [B, K, n, n] or None, ssd int32 [B, K]).
    ``intra`` picks the quant rounding offset (171, else 85)."""
    orig = orig.to(torch.int32)
    pred = pred.to(torch.int32)
    coeff = fwd_transform(orig[:, None] - pred)
    qpb = qp.to(torch.int64)[:, None, None, None]
    levels = quant(coeff, qpb, intra=intra)
    if sbh:
        levels = sbh_adjust(levels)
    rec = torch.clamp(pred + inv_transform(dequant(levels, qpb)), 0, 255)
    ssd = ((rec - orig[:, None]) ** 2).sum((2, 3)).to(torch.int32)
    return (levels.to(torch.int16), rec.to(torch.int32) if want_recon
            else None, ssd)


_VP = ctypes.c_void_p
_I = ctypes.c_int


def _k2():
    lib = cuda_lib.lib("residual_chain")
    if not getattr(lib, "_typed", False):
        lib.residual_chain.argtypes = [_VP] * 3 + [_I] * 5 + [_VP] * 4
        lib.residual_chain.restype = _I
        lib._typed = True
    return lib


def residual_chain(orig, pred, qp, sbh: bool, want_recon=True,
                   intra: bool = True):
    """See residual_chain_plain.  ``want_recon=False`` skips writing the
    reconstruction (the estimate needs only levels and SSD)."""
    if orig.device.type == "cpu":
        return residual_chain_plain(orig, pred, qp, sbh, want_recon, intra)
    o = orig.to(torch.int32).contiguous()
    p = pred.to(torch.int32).contiguous()
    q = qp.to(torch.int32).contiguous()
    cuda_lib.require_cuda(o, p, q)
    bsz, k, n, _ = p.shape
    if o.shape != (bsz, n, n) or q.shape != (bsz,) or n not in (8, 16, 32):
        raise ValueError("residual_chain: bad shapes")
    dev = o.device
    levels = torch.empty((bsz, k, n, n), dtype=torch.int16, device=dev)
    rec = torch.empty((bsz, k, n, n), dtype=torch.int32, device=dev) \
        if want_recon else None
    ssd = torch.empty((bsz, k), dtype=torch.int32, device=dev)
    if bsz * k:
        rc = _k2().residual_chain(
            cuda_lib.ptr(o), cuda_lib.ptr(p), cuda_lib.ptr(q), bsz, k, n,
            int(sbh), int(intra), cuda_lib.ptr(levels),
            cuda_lib.ptr(rec) if rec is not None else _VP(0),
            cuda_lib.ptr(ssd), _VP(cuda_lib.stream_handle(o)))
        cuda_lib.launched("residual_chain", rc)
    return levels, rec, ssd
