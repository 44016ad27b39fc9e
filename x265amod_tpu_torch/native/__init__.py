"""Native CABAC slice serializer (C++), loaded with ctypes.

`cabac.cpp` is the port's copy of the JAX package's serializer.  It is built
with g++ into `build/x265amod_tpu_torch/` at first use.  A failed build or
load raises: the port keeps no Python fallback.  The serializer releases the
GIL while it runs (a ctypes call), so a thread pool overlaps slices.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from ..utils.build import build_library

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cabac.cpp")

_lib = None
_lock = threading.Lock()


def get_cabac_lib():
    """Build (at first use), load and set up the serializer library."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path, _ = build_library(
            [_SRC], "libhevc_cabac.so",
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17"], timeout=300)
        lib = ctypes.CDLL(path)
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.hevc_cabac_set_layout.argtypes = [i32p, ctypes.c_int32]
        lib.hevc_cabac_set_layout2.argtypes = [i32p]
        lib.hevc_cabac_set_layout3.argtypes = [i32p]
        lib.hevc_encode_slice.argtypes = (
            [ctypes.c_int32] * 4 + [i32p] * 16 + [i32p, ctypes.c_int32]
            + [ctypes.c_int32] * 5 + [i32p, i32p,
                                      ctypes.POINTER(ctypes.c_uint8),
                                      ctypes.c_int64])
        lib.hevc_encode_slice.restype = ctypes.c_int64

        from ..cabac.tables import CTX_OFFSET, NUM_CTX
        offs = np.array([
            CTX_OFFSET["part_mode"], CTX_OFFSET["prev_intra_luma_pred_flag"],
            CTX_OFFSET["intra_chroma_pred_mode"], CTX_OFFSET["qt_cbf"],
            CTX_OFFSET["last_sig_coeff_prefix"],
            CTX_OFFSET["last_sig_coeff_prefix"] + 18,
            CTX_OFFSET["coded_sub_block_flag"], CTX_OFFSET["sig_coeff_flag"],
            CTX_OFFSET["coeff_abs_level_greater1_flag"],
            CTX_OFFSET["coeff_abs_level_greater2_flag"],
        ], dtype=np.int32)
        lib.hevc_cabac_set_layout(offs.ctypes.data_as(i32p), NUM_CTX)
        offs2 = np.array([
            CTX_OFFSET["cu_skip_flag"], CTX_OFFSET["pred_mode_flag"],
            CTX_OFFSET["merge_flag"], CTX_OFFSET["merge_idx"],
            CTX_OFFSET["abs_mvd_greater_flag"], CTX_OFFSET["mvp_flag"],
            CTX_OFFSET["rqt_root_cbf"], CTX_OFFSET["inter_pred_idc"],
        ], dtype=np.int32)
        lib.hevc_cabac_set_layout2(offs2.ctypes.data_as(i32p))
        offs3 = np.array([
            CTX_OFFSET["split_cu_flag"], CTX_OFFSET["cu_qp_delta_abs"],
            CTX_OFFSET["sao_merge_flag"], CTX_OFFSET["sao_type_idx"],
            CTX_OFFSET["ref_idx"], CTX_OFFSET["cu_transquant_bypass_flag"],
        ], dtype=np.int32)
        lib.hevc_cabac_set_layout3(offs3.ctypes.data_as(i32p))
        _lib = lib
        return _lib


def encode_slice_native(slice_type: str, ctb_log2: int, hc: int, wc: int,
                        qp: int, *, split=None, kinds=None, modes=None,
                        merge_idx=None, inter_dir=None, mvd0=None, mvp0=None,
                        mvd1=None, mvp1=None, levels_y=None, levels_cb=None,
                        levels_cr=None, qp16=None, qp32=None, sao_luma=None,
                        sao_chroma=None, max_merge: int = 2,
                        sign_hide: bool = False, ref0=None,
                        num_ref0: int = 1, tq_bypass=None):
    """I-, P- and B-slice serializer for the CTU32 quadtree (``ctb_log2``
    5) and the flat CTB16 frame (4) (the port's subset of the JAX package's
    unified call, `x265amod_tpu/native/__init__.py:115`: no WPP).
    ``tq_bypass`` None codes no cu_transquant_bypass_flag (the PPS disables
    it), else the flag every CU codes first (1 under `--lossless`, spec
    7.3.8.5; the JAX package codes those slices with its Python syntax,
    `cabac/syntax.py:encode_intra_ctu16`).  P slices take the
    per-cell kinds, merge indices, L0 MVDs and MVP indices; B slices also
    the inter directions and the L1 MVDs and MVP indices.  sao_luma
    [n_ctu, 7] and sao_chroma [n_ctu, 14] are `ops.sao.sao_pack`'s rows.
    Returns (payload, entry_sizes); raises when the serializer fails."""
    st = {"I": 0, "P": 1, "B": 2}.get(slice_type)
    if st is None:
        raise ValueError(f"unknown slice type {slice_type!r}")
    if st >= 1 and kinds is None:
        raise ValueError("an inter slice needs kinds, merge_idx, mvd0 and "
                         "mvp0")
    if st == 2 and (inter_dir is None or mvd1 is None or mvp1 is None):
        raise ValueError("a B slice needs inter_dir, mvd1 and mvp1")
    lib = get_cabac_lib()
    from ..cabac.tables import init_context_states
    states = np.ascontiguousarray(
        init_context_states(slice_type, qp).astype(np.int32))
    p = ctypes.POINTER(ctypes.c_int32)
    keep = []

    def c(a):
        if a is None:
            return ctypes.cast(None, p)
        arr = np.ascontiguousarray(np.asarray(a), dtype=np.int32)
        keep.append(arr)
        return arr.ctypes.data_as(p)

    nly = np.asarray(levels_y)
    cap = max(1 << 16, int(nly.size) * 8 * 2)
    out = np.empty(cap, dtype=np.uint8)
    entry = np.zeros(max(hc, 1), dtype=np.int32)
    n = lib.hevc_encode_slice(
        st, ctb_log2, hc, wc,
        c(split), c(kinds), c(modes), c(merge_idx), c(inter_dir),
        c(mvd0), c(mvp0), c(mvd1), c(mvp1),
        c(levels_y), c(levels_cb), c(levels_cr), c(qp16), c(qp32),
        c(sao_luma), c(sao_chroma),
        c(ref0), num_ref0,
        qp, max_merge, 0, 1 if sign_hide else 0,
        -1 if tq_bypass is None else int(tq_bypass),
        states.ctypes.data_as(p), entry.ctypes.data_as(p),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), cap)
    if n < 0:
        raise RuntimeError(f"native CABAC serializer failed ({n})")
    return out[:n].tobytes(), []
