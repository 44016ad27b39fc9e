"""Forced-decision slice parity of the PyTorch port against the JAX package
on the CPU, for the all-intra CTU32 tree (BASELINE config 1) at 96x64 and
64x64: given the JAX estimate's split and modes, the port's commit gives
byte-identical levels, modes and recon, and the same NAL bytes (info SEI
off on both sides, since its text names each encoder)."""

import contextlib
import dataclasses
import fcntl
import os
import resource
import subprocess

import numpy as np
import pytest
import torch

from x265amod_tpu.models.encoder import Encoder as JaxEncoder
from x265amod_tpu.models.intra_tree import IntraTreeEncoder as JaxTree
from x265amod_tpu.utils.params import param_default_preset
from x265amod_tpu_torch.models.encoder import Encoder
from x265amod_tpu_torch.models.intra_tree import IntraTreeEncoder
from x265amod_tpu_torch.utils.params import param_from_dict

# The port's CPU ops are small: one intra-op thread keeps torch's idle
# threads from spinning on cores that parallel test workers need.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_jax_native_once():
    """Build the JAX package's native CABAC library (`x265amod_tpu.native`)
    once for all the processes of a parallel test run, while they collect
    the tests.  Its loader builds it in place at first use (`g++ -o` the
    library itself), so in a fresh checkout one worker could load a library
    that another worker's linker was still writing ("file too short") and
    then keep None for the rest of its run, failing the tests that need the
    library.  Here the first process builds it under a lock, into a
    temporary file renamed into place; the others find it up to date and
    the loader never builds.  A build that fails is left to the loader."""
    from x265amod_tpu import native
    so, src = native._SO, native._SRC
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    with open(os.path.join(REPO, "build", "jax_native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(so) and os.path.getmtime(so) >= os.path.getmtime(
                src):
            return
        tmp = so[:-3] + f".tmp{os.getpid()}.so"
        try:
            subprocess.run(["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
                            "-o", tmp, src], check=True, capture_output=True,
                           timeout=300)
            os.replace(tmp, so)
        except (OSError, subprocess.SubprocessError):
            with contextlib.suppress(OSError):
                os.remove(tmp)


build_jax_native_once()


def build_port_native_once():
    """Build the port's native CABAC library (`x265amod_tpu_torch.native`)
    while the processes of a parallel test run collect the tests, as
    `build_jax_native_once` does the JAX package's: its build at first use
    holds a lock (`utils.build.build_library`), so the first process builds
    it and the others wait and load it; no test pays for the build.  A
    build that fails is left to the tests that need the library."""
    from x265amod_tpu_torch.native import get_cabac_lib
    with contextlib.suppress(RuntimeError, OSError):
        get_cabac_lib()


build_port_native_once()


@contextlib.contextmanager
def lowest_cpu_priority():
    """Run the block with every thread of this process at nice 19 (threads
    started inside inherit it), then restore the process's priority.  Where
    the system would not let the priority be restored, nothing is changed."""
    tasks = "/proc/self/task"
    before = os.getpriority(os.PRIO_PROCESS, 0)
    limit = resource.getrlimit(resource.RLIMIT_NICE)[0]
    if not os.path.isdir(tasks) or not (
            os.geteuid() == 0 or limit == resource.RLIM_INFINITY
            or 20 - limit <= before):
        yield
        return

    def renice(value):
        for tid in os.listdir(tasks):
            with contextlib.suppress(OSError):      # a thread that ended
                os.setpriority(os.PRIO_PROCESS, int(tid), value)
    renice(19)
    try:
        yield
    finally:
        renice(before)


# JAX's persistent compilation cache of the port's test modules, in the
# checkout (the repo's .gitignore lists it)
JAX_CACHE = os.path.join(REPO, ".jax_cache")


@contextlib.contextmanager
def shared_jax_compiles():
    """Run the block with JAX's persistent compilation cache in
    `JAX_CACHE`, every compile cached (the small op jits too), then restore
    the process's settings.  The port's test modules compile the same JAX
    trees and ops (one configuration at one shape) in several worker
    processes of a parallel run and in several tests of one module; with
    the cache each is compiled once and the others load the executable it
    wrote.  A cache entry is the compiled executable itself, so a test runs
    what it would have compiled; an entry that cannot be read is compiled
    again (JAX warns)."""
    import jax
    from jax._src import compilation_cache
    keys = ("jax_compilation_cache_dir",
            "jax_persistent_cache_min_compile_time_secs")
    before = {k: getattr(jax.config, k) for k in keys}
    for k, v in zip(keys, (JAX_CACHE, 0.0)):
        jax.config.update(k, v)
    compilation_cache.reset_cache()
    try:
        yield
    finally:
        for k, v in before.items():
            jax.config.update(k, v)
        compilation_cache.reset_cache()


@pytest.fixture(scope="module", autouse=True)
def yield_cpu():
    """The port's CPU test modules (which import this fixture) run at the
    lowest priority: in a parallel test run their JAX compiles take only
    the cores that the JAX package's own, longer test files leave idle.
    They also share their JAX compiles (`shared_jax_compiles`)."""
    with lowest_cpu_priority(), shared_jax_compiles():
        yield


def clip(w, h, n, seed=0):
    """bench.py's synthetic clip (sinusoid luma + noise, smooth chroma)."""
    rng = np.random.default_rng(seed)
    xx, yy = np.meshgrid(np.arange(w), np.arange(h))
    out = []
    for t in range(n):
        y = (128 + 80 * np.sin((xx + 3 * t) / 11.0) * np.cos((yy - 2 * t)
                                                             / 7.0)
             + rng.normal(0, 4, (h, w))).clip(0, 255).astype(np.uint8)
        cb = (128 + 30 * np.sin((xx[::2, ::2] + t) / 19.0)).clip(
            0, 255).astype(np.uint8)
        cr = (128 - 30 * np.cos((yy[::2, ::2] + t) / 23.0)).clip(
            0, 255).astype(np.uint8)
        out.append((y, cb, cr))
    return out


def config1(w, h, qp=30):
    p = param_default_preset("ultrafast")
    p.width, p.height, p.qp = w, h, qp
    p.keyint, p.ctu_size, p.info = 1, 32, False
    return p


@pytest.mark.parametrize("w,h,qp", [(96, 64, 22), (64, 64, 30)])
def test_forced_decisions_byte_identical(w, h, qp):
    frames = clip(w, h, 2, seed=qp)
    jtree = JaxTree(w, h, deblock=True, sign_hide=True)
    ttree = IntraTreeEncoder(w, h, deblock=True, sign_hide=True,
                             device="cpu")
    p = config1(w, h, qp)
    jenc = JaxEncoder(p.copy())
    tenc = Encoder(param_from_dict(dataclasses.asdict(p)), device="cpu")
    for y, cb, cr in frames:
        dec = jtree.collect(jtree.encode_async(y, cb, cr, qp))
        jres = jtree.collect(jtree.encode_async_load(
            y, cb, cr, qp, dec.split, dec.modes, want_recon=True),
            want_recon=True)
        tres = ttree.collect(ttree.encode_async_load(
            y, cb, cr, qp, dec.split, dec.modes, want_recon=True))
        np.testing.assert_array_equal(tres.split, jres.split)
        np.testing.assert_array_equal(tres.modes, jres.modes)
        for name in ("levels_y", "levels_cb", "levels_cr", "recon_y",
                     "recon_cb", "recon_cr"):
            np.testing.assert_array_equal(getattr(tres, name),
                                          getattr(jres, name), name)
        np.testing.assert_array_equal(tres.sse[:3], jres.sse[:3])
        jnal = jenc._assemble_intra_nal(
            jres, qp, *jenc._cabac_intra(jres, qp), 0.0).nals
        tnal = tenc._assemble_intra_nal(
            tres, qp, *tenc._cabac_intra_tree(tres, qp), 0.0).nals
        assert tnal == jnal
