"""Top-level encoder of the port (role of reference `encoder/encoder.cpp` +
`encoder/api.cpp`), cut down to BASELINE config 1: all-intra CTU32, CQP,
deblock on, SAO/AQ off, sign-bit hiding on.

`encode_pipelined` runs the batched all-intra path of the JAX package's
`models/encoder.py:_encode_intra_batched`: BATCH_FRAMES frames per device
step, two steps in flight, and the native CABAC serializer on a 4-thread
pool (its ctypes call releases the GIL).  The host waits on a CUDA event
and reads dense levels from pinned memory (no level packing).
"""

from __future__ import annotations

import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np
import torch

from ..bitstream import sei
from ..bitstream.bitio import BitWriter
from ..bitstream.headers import (PpsInfo, SpsInfo, determine_level,
                                 write_pps, write_slice_header, write_sps,
                                 write_vps)
from ..bitstream.nal import (NAL_AUD, NAL_IDR_W_RADL, NAL_PPS, NAL_SPS,
                             NAL_VPS, wrap_nal)
from ..native import encode_slice_native
from ..utils.params import Param, check_params
from .intra_tree import IntraTreeEncoder
from .ratecontrol import RateControl

MAX_MERGE = 2   # five_minus_max_num_merge_cand = 3 in the slice header


@dataclass
class FrameStats:
    poc: int
    slice_type: str
    qp: int
    bits: int
    psnr_y: float
    psnr_cb: float
    psnr_cr: float
    enc_time: float
    display_order: int = -1
    ssim_y: float = 0.0


@dataclass
class EncodeOutput:
    nals: bytes
    stats: FrameStats
    recon: tuple[np.ndarray, np.ndarray, np.ndarray] | None = None


def _pad_to_ctu(plane: np.ndarray, ctu: int) -> np.ndarray:
    h, w = plane.shape
    ph = -(-h // ctu) * ctu
    pw = -(-w // ctu) * ctu
    if (ph, pw) == (h, w):
        return plane
    return np.pad(plane, ((0, ph - h), (0, pw - w)), mode="edge")


def resolve_device(device=None) -> torch.device:
    """The card unless the caller asks for the CPU; no silent fallback."""
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain PyTorch versions of the kernels")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


class Encoder:
    """x265_encoder_open/encode/close analog for BASELINE config 1."""

    BATCH_FRAMES = 16

    def __init__(self, param: Param, device=None):
        check_params(param)
        self.param = param
        self.device = resolve_device(device)
        w, h = param.width, param.height
        self.ctu = 32
        self.pad_w = -(-w // 32) * 32
        self.pad_h = -(-h // 32) * 32
        fps = param.fps_num / max(param.fps_den, 1)
        self.sps = SpsInfo(
            bit_depth=8, profile_idc=1, width=self.pad_w, height=self.pad_h,
            conf_win_right=(self.pad_w - w) // 2,
            conf_win_bottom=(self.pad_h - h) // 2,
            fps_num=param.fps_num, fps_den=param.fps_den,
            level_idc=determine_level(self.pad_w, self.pad_h, fps),
            num_negative_ref=0, sao_enabled=False)
        self.sps.log2_ctb_size = 5
        self.sps.log2_min_cb_size = 4
        self.sps.log2_max_tb_size = 5
        self.pps = PpsInfo(init_qp=26, sign_data_hiding=param.sign_hide,
                           deblocking_disabled=not param.deblock,
                           beta_offset_div2=param.deblock_beta_offset,
                           tc_offset_div2=param.deblock_tc_offset,
                           cu_qp_delta_enabled=False,
                           diff_cu_qp_delta_depth=0,
                           entropy_coding_sync=False,
                           transquant_bypass=False)
        self.frame_encoder = IntraTreeEncoder(
            self.pad_w, self.pad_h, deblock=param.deblock,
            sign_hide=self.pps.sign_data_hiding, device=self.device)
        self.rc = RateControl(param)
        self.total_bits = 0
        self.frame_stats: list[FrameStats] = []
        self._disp_idx = 0
        self._emitted_headers = False

    def headers(self) -> bytes:
        out = (wrap_nal(NAL_VPS, write_vps(self.sps))
               + wrap_nal(NAL_SPS, write_sps(self.sps))
               + wrap_nal(NAL_PPS, write_pps(self.pps)))
        return out + self._metadata_sei()

    def _metadata_sei(self) -> bytes:
        """Stream-level prefix SEI: info string, HDR static metadata,
        alternative transfer characteristics."""
        msgs = []
        p = self.param
        if p.info:
            txt = (b"x265amod-tpu-torch - PyTorch/CUDA HEVC encoder - "
                   b"options: " + f"qp={p.qp} keyint={p.keyint} "
                   f"bframes={p.bframes}".encode())
            msgs.append((sei.SEI_USER_DATA_UNREGISTERED,
                         sei.user_data_unregistered(txt)))
        if p.master_display:
            prim, wp, mx, mn = sei.parse_mastering_display_string(
                p.master_display)
            msgs.append((sei.SEI_MASTERING_DISPLAY,
                         sei.mastering_display(prim, wp, mx, mn)))
        if p.max_cll or p.max_fall:
            msgs.append((sei.SEI_CONTENT_LIGHT_LEVEL,
                         sei.content_light_level(p.max_cll, p.max_fall)))
        if p.atc_sei >= 0:
            msgs.append((sei.SEI_ALTERNATIVE_TRANSFER,
                         sei.alternative_transfer(p.atc_sei)))
        return sei.wrap_sei(msgs) if msgs else b""

    # -- frame pipeline ------------------------------------------------------

    def encode_pipelined(self, frames, return_recon: bool = False):
        """Generator over EncodeOutput, one per input (y, cb, cr) frame.
        Groups of BATCH_FRAMES frames go to the device in one step (a tail
        group pads by repeating its last frame); while group g computes,
        group g-1's slices are serialized on the thread pool."""
        if return_recon:
            raise NotImplementedError(
                "return_recon needs the per-frame path, which the port does "
                "not run yet")
        bsz = self.BATCH_FRAMES
        fe = self.frame_encoder
        pending = deque()      # (handle, qp, n_real, t0)
        with ThreadPoolExecutor(max_workers=4) as pool:

            def dispatch(buf):
                n_real = len(buf)
                while len(buf) < bsz:
                    buf.append(buf[-1])
                qp = self.rc.frame_qp("I")
                t0 = time.time()
                handle = fe.encode_batch_async(
                    np.stack([f[0] for f in buf]),
                    np.stack([f[1] for f in buf]),
                    np.stack([f[2] for f in buf]), qp)
                return handle, qp, n_real, t0

            def start_cabac(group):
                """Wait for the group's D2H copy, then queue its slices on
                the pool (they run while the next group is dispatched)."""
                handle, qp, n_real, t0 = group
                results = fe.collect_batch(handle)[:n_real]
                futs = [pool.submit(self._cabac_intra_tree, r, qp)
                        for r in results]
                return results, futs, qp, t0

            def finish(started):
                results, futs, qp, t0 = started
                return [self._assemble_intra_nal(res, qp, *fut.result(), t0)
                        for res, fut in zip(results, futs)]

            buf = []
            for fr in frames:
                buf.append((_pad_to_ctu(np.asarray(fr[0]), 32),
                            _pad_to_ctu(np.asarray(fr[1]), 16),
                            _pad_to_ctu(np.asarray(fr[2]), 16)))
                if len(buf) == bsz:
                    started = start_cabac(pending.popleft()) \
                        if pending else None
                    pending.append(dispatch(buf))
                    buf = []
                    if started is not None:
                        yield from finish(started)
            if buf:
                started = start_cabac(pending.popleft()) if pending else None
                pending.append(dispatch(buf))
                if started is not None:
                    yield from finish(started)
            while pending:
                yield from finish(start_cabac(pending.popleft()))

    def _assemble_intra_nal(self, res, qp, payload, entry_offs,
                            t0) -> EncodeOutput:
        """NAL assembly + stats for one intra frame."""
        nal_type = NAL_IDR_W_RADL
        bw = write_slice_header(
            self.sps, self.pps, "I", qp, nal_type, poc=0,
            rps_neg=None, rps_pos=None, max_merge=MAX_MERGE,
            sao_luma=False, sao_chroma=False,
            num_entry_points=len(entry_offs),
            entry_point_offsets=entry_offs or None)
        bw.append_bytes(payload)
        nal = wrap_nal(nal_type, bw.data())
        if self.param.aud:
            audw = BitWriter()
            audw.write(0, 3)
            audw.rbsp_trailing_bits()
            nal = wrap_nal(NAL_AUD, audw.data()) + nal
        if self.param.repeat_headers or not self._emitted_headers:
            nal = self.headers() + nal
            self._emitted_headers = True

        def sse_psnr(sse, npix):
            mse = sse / max(npix, 1)
            return 99.99 if mse <= 0 else float(
                10.0 * np.log10(255.0 * 255.0 / mse))
        npix_y = self.pad_w * self.pad_h
        stats = FrameStats(
            poc=0, slice_type="I", qp=qp, bits=len(nal) * 8,
            psnr_y=sse_psnr(float(res.sse[0]), npix_y),
            psnr_cb=sse_psnr(float(res.sse[1]), npix_y // 4),
            psnr_cr=sse_psnr(float(res.sse[2]), npix_y // 4),
            enc_time=time.time() - t0, display_order=self._disp_idx,
            ssim_y=float(res.sse[3]))
        self._disp_idx += 1
        self.frame_stats.append(stats)
        self.total_bits += stats.bits
        self.rc.update(stats.bits, "I", qp)
        return EncodeOutput(nal, stats, None)

    # -- host side -------------------------------------------------------------

    def _cabac_intra_tree(self, res, qp):
        """Slice payload of one CTU32-tree intra frame (native serializer;
        a failure raises)."""
        return encode_slice_native(
            "I", 5, res.split.shape[0], res.split.shape[1], qp,
            split=res.split, modes=res.modes, levels_y=res.levels_y,
            levels_cb=res.levels_cb, levels_cr=res.levels_cr,
            sign_hide=self.pps.sign_data_hiding)

    def summary(self) -> dict:
        n = len(self.frame_stats)
        if not n:
            return {}
        fps = self.param.fps_num / max(self.param.fps_den, 1)
        return {
            "frames": n,
            "bitrate_kbps": self.total_bits * fps / n / 1000.0,
            "psnr_y": float(np.mean([s.psnr_y for s in self.frame_stats])),
            "psnr_cb": float(np.mean([s.psnr_cb for s in self.frame_stats])),
            "psnr_cr": float(np.mean([s.psnr_cr for s in self.frame_stats])),
            "ssim_y": float(np.mean([s.ssim_y for s in self.frame_stats])),
            "enc_fps": n / max(sum(s.enc_time for s in self.frame_stats),
                               1e-9),
        }
