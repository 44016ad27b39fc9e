"""Builds the port's native libraries at first use.

Outputs go to `build/x265amod_tpu_torch/` beside the package (the repo's
`.gitignore` lists `build/`).  A build writes a temporary file and renames
it into place, so concurrent processes never load a half-written library,
and holds a lock on the library's name meanwhile, so the processes that
need it at once build it once: the others wait and find it up to date.
A failed build raises: the port has no fallback for a missing library.
"""

from __future__ import annotations

import fcntl
import os
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(os.path.dirname(PKG_DIR), "build",
                         "x265amod_tpu_torch")


def build_library(sources: list[str], name: str, cmd: list[str],
                  timeout: int = 600, deps=()) -> tuple[str, str]:
    """Compile ``sources`` into ``BUILD_DIR/name`` with ``cmd`` (the
    compiler and its flags; ``-o`` and the sources are appended) unless a
    library newer than the sources and the headers ``deps`` is there.
    Returns (path, compiler output)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR, name)
    with open(f"{out}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(out) and all(
                os.path.getmtime(out) >= os.path.getmtime(s)
                for s in list(sources) + list(deps)):
            return out, ""
        tmp = f"{out}.tmp{os.getpid()}"
        proc = subprocess.run(cmd + ["-o", tmp] + sources,
                              capture_output=True, text=True,
                              timeout=timeout)
        if proc.returncode != 0:
            raise RuntimeError(f"build of {name} failed:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        return out, proc.stdout + proc.stderr
