"""Elementwise Chan merge of two QO table sets: the reduce of the
data-parallel sync collective (DESIGN.md §4.1).

Replaces ``src/repro/kernels/qo_merge.py::qo_merge_pallas``.  Inputs are
two same-shape sets of four planes, ``(n, mean, m2, sum_x)`` each; per
element:

    n     = n_a + n_b
    mean  = (n_a*mean_a + n_b*mean_b) / n           (0 where n == 0)
    M2    = M2_a + M2_b + delta^2 * n_a*n_b / n     (delta = mean_b - mean_a)
    sum_x = sum_x_a + sum_x_b

-- :func:`repro_torch.core.stats.merge` on the planes plus the sum_x add.
Returns four new planes (out of place, as the reference's op).
:func:`merge` launches ``csrc/qo_merge.cu`` on a CUDA tensor and runs
:func:`merge_plain` on a CPU one; the kernel keeps the plain version's
operation order and rounding, so the two are bitwise equal on the card.
``threads`` (threads a block) is the launch's schedule knob:
:data:`THREADS_CHOICES` are compiled, each element is merged on its own so
every one gives the same bits, and the plain version never sees it.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["merge_plain", "merge_kernel", "merge", "cost", "THREADS",
           "THREADS_CHOICES"]

#: Threads a block by default, and the values compiled.
THREADS = 256
THREADS_CHOICES = (128, 256, 512, 1024)


def cost(E: int):
    """``(bytes, flops)`` of merging two sets of four planes of E floats:
    eight planes read and four written once, about 14 flops an element."""
    return 12 * 4 * E, 14 * E

_NAMES = ("n_a", "mean_a", "m2_a", "sum_x_a", "n_b", "mean_b", "m2_b",
          "sum_x_b")


def merge_plain(n_a, mean_a, m2_a, sum_x_a, n_b, mean_b, m2_b, sum_x_b):
    """Plain PyTorch merge -> new ``(n, mean, m2, sum_x)`` planes."""
    y = stats.merge({"n": n_a, "mean": mean_a, "m2": m2_a},
                    {"n": n_b, "mean": mean_b, "m2": m2_b})
    return y["n"], y["mean"], y["m2"], sum_x_a + sum_x_b


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_merge").qo_merge_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def merge_kernel(*planes, threads: int = THREADS):
    """Launch ``csrc/qo_merge.cu`` on the eight planes (a's n, mean, m2,
    sum_x, then b's), ``threads`` threads a block -> four new planes."""
    threads = _build.check_knob("qo_merge", "threads", threads,
                                THREADS_CHOICES)
    if len(planes) != 8:
        raise ValueError(f"qo_merge: expected 8 planes, got {len(planes)}")
    dev, shape = planes[0].device, planes[0].shape
    for name, t in zip(_NAMES, planes):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"qo_merge: {name} must be a contiguous float32 "
                             f"CUDA tensor on {dev} shaped like n_a")
    out = [torch.empty(shape, dtype=torch.float32, device=dev)
           for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(*(t.data_ptr() for t in planes),
                     *(o.data_ptr() for o in out), planes[0].numel(),
                     threads, stream)
    _build.check(rc, "qo_merge")
    E = planes[0].numel()
    _build.launched("qo_merge", lambda: cost(E))
    return tuple(out)


def merge(*planes, threads: int = THREADS):
    """The plain version on a CPU tensor, else the kernel (or a raise).
    ``threads`` is checked on both: the plain version never sees it."""
    if planes[0].device.type == "cpu":
        _build.check_knob("qo_merge", "threads", threads, THREADS_CHOICES)
        return merge_plain(*planes)
    return merge_kernel(*planes, threads=threads)
