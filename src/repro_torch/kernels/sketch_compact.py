"""Sketch compaction: the grouped reduction of sorted centroids into rank
buckets.

Replaces ``src/repro/kernels/sketch_compact.py::sketch_compact_pallas``
(the compute stage of ``core/sketch.py::compact_planes``).  Planes are
(..., J): ``n``, ``mean``, ``m2``, ``sum_x`` per centroid, each row's
centroids sorted by prototype, and ``bucket`` (..., J) the int32 rank
bucket of each centroid in [0, K).  Per row and bucket k:

    n_k    = sum of n            sum_x_k = sum of sum_x
    mean_k = sum of n * mean / n_k                 (0 where n_k == 0)
    M2_k   = sum of M2 + n * (mean - mean_k)^2     (0 where n_k == 0)

-- Chan's Eqs. 4-5 as one grouped two-pass form, exact for the grouping.
Returns four (..., K) planes.  :func:`bucket_reduce` launches
``csrc/sketch_compact.cu`` on a CUDA tensor and runs
:func:`bucket_reduce_plain` (the reference's ``sketch._bucket_reduce``:
two flat segment sums) on a CPU one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["bucket_reduce_plain", "bucket_reduce_kernel", "bucket_reduce",
           "MAX_BUCKETS"]

#: One warp keeps its row's K bucket accumulators (4 floats each) in
#: shared memory, 8 warps a block, within the 48 KB of static launch.
MAX_BUCKETS = 256


def bucket_reduce_plain(n, mean, m2, sum_x, bucket, k_out: int):
    """Plain PyTorch grouped reduction -> four (..., k_out) planes."""
    lead, J = n.shape[:-1], n.shape[-1]
    R = n.numel() // max(J, 1)
    dev = n.device
    seg = (torch.arange(R, device=dev)[:, None] * k_out
           + bucket.reshape(R, J).long()).reshape(-1)
    nf = n.reshape(-1)

    def segsum(v):
        return torch.zeros(R * k_out, dtype=torch.float32,
                           device=dev).index_add_(0, seg, v)

    n_b, sy_b = segsum(nf), segsum(nf * mean.reshape(-1))
    sx_b = segsum(sum_x.reshape(-1))
    mean_b = torch.where(n_b > 0, sy_b / torch.where(n_b > 0, n_b, 1.0), 0.0)
    m2_b = segsum(m2.reshape(-1) + nf * (mean.reshape(-1) - mean_b[seg]) ** 2)
    m2_b = torch.where(n_b > 0, m2_b, 0.0)
    out = lambda a: a.reshape(lead + (k_out,))
    return out(n_b), out(mean_b), out(m2_b), out(sx_b)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("sketch_compact").sketch_compact_launch
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_longlong, ctypes.c_int,
                                           ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bucket_reduce_kernel(n, mean, m2, sum_x, bucket, k_out: int):
    """Launch ``csrc/sketch_compact.cu`` -> four (..., k_out) planes."""
    dev = n.device
    shape = n.shape
    for name, t in (("n", n), ("mean", mean), ("m2", m2), ("sum_x", sum_x)):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != shape:
            raise ValueError(f"sketch_compact: {name} must be a contiguous "
                             f"float32 tensor on {dev} shaped like n")
    if bucket.device != dev or bucket.dtype != torch.int32 \
            or not bucket.is_contiguous() or bucket.shape != shape:
        raise ValueError(f"sketch_compact: bucket must be a contiguous int32 "
                         f"tensor on {dev} shaped like n")
    if not 0 < k_out <= MAX_BUCKETS:
        raise ValueError(f"sketch_compact: K = {k_out}, expected "
                         f"1..{MAX_BUCKETS}")
    J = shape[-1]
    R = n.numel() // max(J, 1)
    out = [torch.empty(shape[:-1] + (k_out,), dtype=torch.float32,
                       device=dev) for _ in range(4)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(n.data_ptr(), mean.data_ptr(), m2.data_ptr(),
                     sum_x.data_ptr(), bucket.data_ptr(),
                     *(o.data_ptr() for o in out), R, J, k_out, stream)
    _build.check(rc, "sketch_compact")
    _build.LAUNCHES["sketch_compact"] += 1
    return tuple(out)


def bucket_reduce(n, mean, m2, sum_x, bucket, k_out: int):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if n.device.type == "cpu":
        return bucket_reduce_plain(n, mean, m2, sum_x, bucket, k_out)
    return bucket_reduce_kernel(n, mean, m2, sum_x, bucket, k_out)
