"""Single-table QO absorb (paper Algorithm 1).

Replaces ``src/repro/kernels/qo_update.py::qo_update_pallas``.  One table
of C bins (``n``, ``mean``, ``m2``, ``sum_x`` planes, a scalar ``radius``
and ``origin``) absorbs N weighted rows:

1. quantize each x into bin ``floor((x - origin)/radius) + C/2``, clipped
   into [0, C), with the reference's integer semantics (ROADMAP C1);
2. per bin, the batch's w, w*y and w*x sums, then the two-pass
   w * (y - batch bin mean)^2;
3. one Chan merge (Eqs. 4-5) of the batch into the running table.

Out of place on both paths: the result is four new planes.
:func:`update` launches ``csrc/qo_update.cu`` on a CUDA tensor and runs
:func:`update_plain` (the reference's ``core/qo.py::update``: one segment
reduction over the whole batch) on a CPU one.  The TPU kernel instead
Chan-merges 1024-row tiles one after another; the three differ by f32
rounding only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build
from repro_torch.kernels.qo_update_leaves import bin_ids_plain

__all__ = ["update_plain", "update_kernel", "update", "MAX_BINS"]

#: The bin-id kernel keeps one block's histogram (C int32 counts) in
#: shared memory, within the 227 KB a block can use.
MAX_BINS = 49152


def update_plain(n, mean, m2, sum_x, radius, origin, x, y, w):
    """Plain PyTorch absorb -> new (n, mean, m2, sum_x) planes.

    Bin ids always take the reference's float32 arithmetic; the sums run
    in the inputs' dtype, so float64 inputs give a float64 yardstick."""
    C = n.shape[0]
    ids = bin_ids_plain(radius.float(), origin.float(), x.float(), C).long()

    def segsum(v):
        return torch.zeros(C, dtype=v.dtype, device=x.device).index_add_(
            0, ids, v)

    n_b, sx_b, sy_b = segsum(w), segsum(w * x), segsum(w * y)
    mean_b = torch.where(n_b > 0, sy_b / torch.where(n_b > 0, n_b, 1.0), 0.0)
    # two-pass M2: residuals against the batch's own bin means
    m2_b = segsum(w * (y - mean_b[ids]) ** 2)
    merged = stats.merge({"n": n, "mean": mean, "m2": m2},
                         {"n": n_b, "mean": mean_b, "m2": m2_b})
    return merged["n"], merged["mean"], merged["m2"], sum_x + sx_b


@functools.lru_cache(maxsize=None)
def _launchers():
    lib = _build.library("qo_update")
    bins = lib.qo_update_bins_launch
    bins.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong, ctypes.c_int,
                                             ctypes.c_void_p]
    bins.restype = ctypes.c_int
    reduce_ = lib.qo_update_reduce_launch
    reduce_.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int,
                                                 ctypes.c_void_p]
    reduce_.restype = ctypes.c_int
    return bins, reduce_


def update_kernel(n, mean, m2, sum_x, radius, origin, x, y, w):
    """Launch ``csrc/qo_update.cu`` -> new (n, mean, m2, sum_x) planes.

    Planes (C,), radius/origin 0-d (read on the card: no host sync for
    them), x/y/w (N,), all contiguous float32 on one CUDA device."""
    dev = x.device
    C = n.shape[0]
    N = x.shape[0]
    for name, t, shape in (("n", n, (C,)), ("mean", mean, (C,)),
                           ("m2", m2, (C,)), ("sum_x", sum_x, (C,)),
                           ("radius", radius, ()), ("origin", origin, ()),
                           ("x", x, (N,)), ("y", y, (N,)), ("w", w, (N,))):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"qo_update: {name} must be a contiguous "
                             f"float32 {shape} tensor on {dev}")
    if N >= 2 ** 31:
        raise ValueError("qo_update: at most 2^31 - 1 rows a call")
    if not 0 < C <= MAX_BINS:
        raise ValueError(f"qo_update: C = {C} bins, expected 1..{MAX_BINS}")
    bins_fn, reduce_fn = _launchers()
    stream = torch.cuda.current_stream(dev).cuda_stream
    bins = torch.empty(N, dtype=torch.int32, device=dev)
    counts = torch.zeros(C, dtype=torch.int32, device=dev)
    _build.check(bins_fn(x.data_ptr(), radius.data_ptr(), origin.data_ptr(),
                         bins.data_ptr(), counts.data_ptr(), N, C, stream),
                 "qo_update")
    # group the rows by bin, row order kept within a bin (radix sort)
    order = torch.sort(bins, stable=True).indices.to(torch.int32)
    offsets = torch.zeros(C + 1, dtype=torch.int32, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    out = [torch.empty(C, dtype=torch.float32, device=dev) for _ in range(4)]
    _build.check(reduce_fn(order.data_ptr(), offsets.data_ptr(), x.data_ptr(),
                           y.data_ptr(), w.data_ptr(), n.data_ptr(),
                           mean.data_ptr(), m2.data_ptr(), sum_x.data_ptr(),
                           *(o.data_ptr() for o in out), C, stream),
                 "qo_update")
    _build.LAUNCHES["qo_update"] += 1
    return tuple(out)


def update(n, mean, m2, sum_x, radius, origin, x, y, w):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if x.device.type == "cpu":
        return update_plain(n, mean, m2, sum_x, radius, origin, x, y, w)
    return update_kernel(n, mean, m2, sum_x, radius, origin, x, y, w)
