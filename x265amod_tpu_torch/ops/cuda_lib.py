"""Builds, loads and counts the port's hand-written CUDA kernels.

Each kernel is one `csrc/<name>.cu` with a plain C interface, compiled by
`nvcc` for `sm_90a` into `build/x265amod_tpu_torch/lib<name>.so` at first use
and loaded with ctypes.  Every C entry point takes PyTorch's current stream,
launches, and returns `cudaGetLastError()`; the wrappers raise on a nonzero
code.  Nothing here falls back to the plain PyTorch versions: a CUDA tensor
either runs the kernel or raises.

`LAUNCHES[name]` counts the launches of kernel `name` by its wrapper (one
a call; K20 `commit_intra` enqueues one a diagonal in one call, K23
`intra16_scan` two: its ticket list and its scan, K21 `deblock_maps` two:
the cells' flags, then the QP chain and the edges);
`LAUNCHES["intra_pred_lowres"]` counts K1's launches by the lookahead apart
from the trees', `LAUNCHES["residual_chain_rdoq"]` K2's launches with its
RDOQ stage apart from those without, and `LAUNCHES["decide_flat_b"]` the B
scan K25 of `csrc/decide_flat.cu` apart from its P scan K24
(`LAUNCHES["decide_flat"]`), and `LAUNCHES["me_ssd_argmin"]` K5's
launches with the ME argmin folded into its epilogue apart from those
without (`LAUNCHES["me_ssd"]`).
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import subprocess
import threading

from ..utils.build import BUILD_DIR, PKG_DIR, build_library

CSRC = os.path.join(PKG_DIR, "csrc")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
BASE_FLAGS = ["-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

# name -> extra nvcc flags.  tu_bits, subpel, sao_analyse, decide_p,
# decide_b, pick_ref, intra16_scan, decide_flat and the RDOQ
# stage of residual_chain (also in commit_intra, through chain_lanes.cuh)
# form f32 costs in a fixed order that decides RD argmins, so the compiler
# must not contract them into FMAs (each writes the FMAs XLA's order has
# itself); lowres_aq and cutree_prop repeat the JAX f32 operations one by
# one, resample writes the FMA chain of XLA's dot itself, and frame_metrics
# repeats the plain SSIM's f32 operations.  Every file that includes a
# shared header (csrc/*.cuh) builds with the header's flags.
KERNELS = {
    "intra_pred": ["--fmad=false"],
    "residual_chain": ["--fmad=false"],
    "tu_bits": ["--fmad=false"],
    "deblock": [],
    "me_ssd": [],
    "subpel": ["--fmad=false"],
    "mc_qpel": [],
    "hpel": [],
    "mc_bi": [],
    "sao_analyse": ["--fmad=false"],
    "sao_apply": [],
    "lowres_aq": ["--fmad=false"],
    "lowres_me": [],
    "cutree_prop": ["--fmad=false"],
    "pack_levels": [],
    "resample": ["--fmad=false"],
    "decide_p": ["--fmad=false"],
    "pick_ref": ["--fmad=false"],
    "decide_b": ["--fmad=false"],
    "commit_intra": ["--fmad=false"],
    "deblock_maps": [],
    "frame_metrics": ["--fmad=false"],
    "intra16_scan": ["--fmad=false"],
    "decide_flat": ["--fmad=false"],
}

LAUNCHES = {name: 0 for name in KERNELS}
LAUNCHES["intra_pred_lowres"] = 0
LAUNCHES["residual_chain_rdoq"] = 0
LAUNCHES["decide_flat_b"] = 0
LAUNCHES["me_ssd_argmin"] = 0

_libs: dict = {}
_lock = threading.Lock()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def nvcc_path() -> str:
    cand = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(cand):
        raise RuntimeError("nvcc not found: the CUDA kernels build only on "
                           "a machine with the CUDA toolkit")
    return cand


def _cmd(name: str) -> list[str]:
    return [nvcc_path()] + ARCH + BASE_FLAGS + KERNELS[name]


def build_all() -> dict:
    """Compile every kernel at once (one nvcc process per source, all
    started together).  Returns {name: ptxas report}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in KERNELS:
        src = os.path.join(CSRC, f"{name}.cu")
        out = os.path.join(BUILD_DIR, f"lib{name}.so")
        tmp = f"{out}.tmp{os.getpid()}"
        procs[name] = (subprocess.Popen(
            _cmd(name) + ["-o", tmp, src], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True), tmp, out)
    reports = {}
    failed = []
    for name, (proc, tmp, out) in procs.items():
        text, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            failed.append(f"{name}:\n{text}")
            continue
        os.replace(tmp, out)
        reports[name] = text
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return reports


def lib(name: str):
    """The loaded ctypes library of kernel ``name`` (built at first use, and
    again when its source or a shared header is newer)."""
    with _lock:
        if name not in _libs:
            path, _ = build_library(
                [os.path.join(CSRC, f"{name}.cu")], f"lib{name}.so",
                _cmd(name), deps=glob.glob(os.path.join(CSRC, "*.cuh")))
            _libs[name] = ctypes.CDLL(path)
        return _libs[name]


def typed_lib(name: str, fn: str, argtypes):
    """The library of kernel ``name`` with its entry ``fn`` typed: its
    arguments ``argtypes``, an int (the CUDA error code) returned."""
    lib_ = lib(name)
    typed = lib_.__dict__.setdefault("_typed_fns", set())
    if fn not in typed:
        f = getattr(lib_, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
        typed.add(fn)
    return lib_


def stream_handle(t) -> int:
    import torch
    return torch.cuda.current_stream(t.device).cuda_stream


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def launched(name: str, rc: int, n: int = 1) -> None:
    """Count ``n`` launches of ``name`` (the kernel launches one C call
    enqueued) and raise if the C entry reported a CUDA error."""
    LAUNCHES[name] += n
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch "
                           f"(cudaError {rc})")


def require_cuda(*tensors) -> None:
    """Validate a kernel's tensor arguments: same CUDA device, contiguous."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError("kernel arguments must lie on one CUDA device")
        if not t.is_contiguous():
            raise ValueError("kernel arguments must be contiguous")
