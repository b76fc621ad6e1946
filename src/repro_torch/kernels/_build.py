"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the source and the flags, so an edited source builds
anew and an unchanged one is reused.  ``--use_fast_math`` is deliberately
absent: bin ids, route decisions and NaN handling must follow IEEE f32
(IEEE division, no flush-to-zero, NaN compares false).  Builds happen at
first use on a CUDA tensor, or all at once, one nvcc process per source
started together, through :func:`build`.  Nothing here runs at import.

``LAUNCHES`` holds one integer per kernel; each wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "LAUNCHES", "reset_launches", "build", "library",
           "check", "BuildError"]

SOURCES = ("qo_route", "qo_update_leaves", "qo_query_batched",
           "sketch_compact", "qo_update", "qo_query")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in SOURCES}


class BuildError(RuntimeError):
    """nvcc failed on one of the port's sources."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    """Where ``name``'s library lands: keyed by its source and the flags."""
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together.  Returns ``{name: library path}``; raises
    :class:`BuildError` with nvcc's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        log = out.with_suffix(".log")
        with open(log, "w") as fh:
            proc = subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                 str(CSRC / f"{name}.cu")],
                stdout=fh, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        if proc.wait() != 0:
            failed.append(f"{name}:\n{log.read_text()}")
        else:
            os.replace(tmp, out)
    if failed:
        raise BuildError("nvcc failed\n" + "\n".join(failed))
    return {name: lib_path(name) for name in names}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    return ctypes.CDLL(str(build((name,))[name]))


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        lib = library(name)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
