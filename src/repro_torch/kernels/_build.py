"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

``<hash>`` covers the source, the shared headers ``csrc/*.cuh`` and the
flags, so an edited source or header builds anew and an unchanged one is
reused.  ``--use_fast_math`` is deliberately absent: bin ids, route
decisions and NaN handling must follow IEEE f32 (IEEE division, no
flush-to-zero, NaN compares false).  Builds happen at
first use on a CUDA tensor, or all at once, one nvcc process per source
started together, through :func:`build`.  Nothing here runs at import.
Both take one module lock, so threads that reach a kernel's first use
together (a serving engine's trainer and server) build it once.

``LAUNCHES`` holds one integer per kernel entry point, under the source's
name where a source has one entry point and under ``ebst_insert`` and
``ebst_query`` for the two of ``csrc/ebst.cu``; each wrapper adds one
through :func:`launched` where it launches its kernel and nowhere else.
:func:`launched` also hands every sink in ``COST_SINKS`` (the op-cost
counter of :mod:`repro_torch.perf.opcost`) the launch's cost function.

A kernel's launch shape (rows, warps or threads a block) is a schedule
knob: each allowed value is its own template instantiation, the wrapper
takes it as a keyword and :func:`check_knob` refuses a value that was not
compiled.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

__all__ = ["SOURCES", "LAUNCHES", "COST_SINKS", "reset_launches",
           "launched", "check_knob", "build", "library", "check",
           "BuildError"]

SOURCES = ("qo_route", "qo_update_leaves", "qo_query_batched",
           "sketch_compact", "qo_update", "qo_query", "qo_merge",
           "leaf_stats", "ebst")
CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

LAUNCHES = {name: 0 for name in SOURCES[:-1] + ("ebst_insert",
                                                 "ebst_query")}
#: Callables ``sink(name, cost)`` told of every launch.
COST_SINKS: list = []
_LOCK = threading.Lock()
_LIBRARIES: dict = {}


class BuildError(RuntimeError):
    """nvcc failed on one of the port's sources."""


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launched(name: str, cost) -> None:
    """Count one launch of ``name`` and hand ``cost`` to every sink.
    ``cost()`` gives the launch's ``(bytes, flops)``; only a sink calls
    it, so where it reads the launch's data on the card (the leaves a
    batch reached, the nodes a forest allocated) that host read happens
    only while a sink listens."""
    LAUNCHES[name] += 1
    for sink in COST_SINKS:
        sink(name, cost)


def check_knob(kernel: str, knob: str, value, choices) -> int:
    """``value`` if the kernel was compiled for it, else ValueError."""
    if value not in choices:
        raise ValueError(f"{kernel}: {knob} = {value!r} is not compiled; "
                         f"the kernel takes {tuple(choices)}")
    return int(value)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return str(Path(home) / "bin" / "nvcc")


def lib_path(name: str) -> Path:
    """Where ``name``'s library lands: keyed by its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    src = CSRC / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names=SOURCES) -> dict:
    """Compile the named sources that are not built yet, one nvcc process
    each, all started together.  Returns ``{name: library path}``; raises
    :class:`BuildError` with nvcc's output if any build fails."""
    with _LOCK:
        return _build_locked(names)


def _build_locked(names) -> dict:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        tmp = out.with_name(
            f"{out.name}.{os.getpid()}.{threading.get_ident()}.tmp")
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


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    with _LOCK:
        if name not in _LIBRARIES:
            _LIBRARIES[name] = ctypes.CDLL(str(_build_locked((name,))[name]))
        return _LIBRARIES[name]


def check(rc: int, name: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if rc != 0:
        lib = library(name)
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{name}: CUDA launch failed ({rc}: {msg})")
