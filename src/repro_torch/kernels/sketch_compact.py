"""Sketch compaction: sort each row's centroids by prototype, rank them
into K buckets by cumulative weight and reduce each bucket exactly.

Replaces ``src/repro/kernels/sketch_compact.py::sketch_compact_pallas``
together with the jnp stages the reference keeps around it
(``core/sketch.py::sort_planes``, ``_bucket_ids`` and ``merge_planes``'s
concatenation).  Planes are (..., J): ``n``, ``mean``, ``m2``, ``sum_x``
per centroid, in any order.  Per row:

* sort: a stable sort by prototype ``sum_x / n`` (+inf where n == 0, so
  empties sink; the key is canonicalized with ``+ 0.0``, ROADMAP C7);
* rank: centroid i goes to bucket
  ``clip(int((cumw_i - n_i/2) * (K / tot)), 0, K-1)``;
* reduce, per bucket k:

      n_k    = sum of n            sum_x_k = sum of sum_x
      mean_k = sum of n * mean / n_k                 (0 where n_k == 0)
      M2_k   = sum of M2 + n * (mean - mean_k)^2     (0 where n_k == 0)

  -- Chan's Eqs. 4-5 as one grouped two-pass form, exact for the grouping.

Returns four (..., K) planes, ascending-prototype.  :func:`compact` takes
one plane set, or two (``b``: a merge's second sketch, read in place of a
concatenation).  On a CUDA tensor it launches ``csrc/sketch_compact.cu``
(all three stages in one kernel) or raises; on a CPU tensor it runs
:func:`compact_plain`: :func:`sort_planes` -> :func:`bucket_ids` ->
:func:`bucket_reduce_plain` (the reference's ``sketch._bucket_reduce``,
the TPU kernel's own function).  ``warps`` and ``gen_warps`` (rows a
block of the fast kernel, 4 a warp, and of the general kernel, one a warp)
are the launch's schedule knobs: :data:`WARPS_CHOICES` and
:data:`GEN_WARPS_CHOICES` are compiled, a row lives in one warp so every
choice gives the same bits, and the plain version never sees them.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.qo_update_leaves import xla_int32

__all__ = ["prototypes", "sort_planes", "bucket_ids", "bucket_reduce_plain",
           "compact_plain", "compact_kernel", "compact", "cost",
           "fast_kernel", "MAX_BUCKETS", "MAX_CENTROIDS", "WARPS",
           "WARPS_CHOICES", "GEN_WARPS", "GEN_WARPS_CHOICES"]

#: Largest K: the kernel keeps a row's K bucket slots (4 floats each) in
#: shared memory, several rows a block, within 48 KB.
MAX_BUCKETS = 256
#: Largest J the kernel sorts (a merge of two MAX_BUCKETS sketches).
MAX_CENTROIDS = 2 * MAX_BUCKETS
#: Warps a block of the fast kernel (J <= 32, K <= 32) and of the general
#: one by default, and the values compiled.  At 16 warps and K > 16 the
#: fast kernel's block takes over 48 KB of shared memory (it opts in).
WARPS, WARPS_CHOICES = 8, (4, 8, 16)
GEN_WARPS, GEN_WARPS_CHOICES = 4, (2, 4, 8)


def cost(R: int, J: int, K: int):
    """``(bytes, flops)`` of compacting R rows of J centroids into K: four
    (R, J) planes read once, four (R, K) planes written once; about 20
    flops a centroid (key, sort share, scans, reduce)."""
    return R * J * 16 + R * K * 16, R * J * 20


def fast_kernel(J: int, K: int) -> bool:
    """Whether ``csrc/sketch_compact.cu`` compacts rows of J centroids into
    K on its fast kernel (``warps``) rather than its general one
    (``gen_warps``), as its launcher chooses."""
    return J <= 32 and K <= 32


def _check_knobs(warps, gen_warps):
    return (_build.check_knob("sketch_compact", "warps", warps,
                              WARPS_CHOICES),
            _build.check_knob("sketch_compact", "gen_warps", gen_warps,
                              GEN_WARPS_CHOICES))


def prototypes(n, sum_x, empty: float = float("inf")):
    """Per-centroid prototype ``sum_x / n``, ``empty`` at n == 0 slots."""
    return torch.where(n > 0, sum_x / torch.where(n > 0, n, 1.0), empty)


def sort_planes(n, mean, m2, sum_x):
    """Stable sort of the centroids along the last axis by ascending
    prototype, empties last (the identity on well-formed sketch state)."""
    key = prototypes(n, sum_x) + 0.0
    order = torch.sort(key, dim=-1, stable=True).indices
    return tuple(torch.gather(a, -1, order) for a in (n, mean, m2, sum_x))


def bucket_ids(n_sorted, k_out: int):
    """int32 rank bucket of each sorted centroid: its cumulative-weight
    midpoint scaled to ``k_out`` buckets, clipped.  ``k_out / tot`` is one
    division, as the reference and the kernel take it (a Python number
    over a tensor would be a reciprocal and a product in PyTorch)."""
    cumw = torch.cumsum(n_sorted, -1)
    tot = torch.clamp(cumw[..., -1:], min=1e-30)
    mid = cumw - 0.5 * n_sorted
    return torch.clamp(xla_int32(mid * (torch.full_like(tot, k_out) / tot)),
                       0, k_out - 1).to(torch.int32)


def bucket_reduce_plain(n, mean, m2, sum_x, bucket, k_out: int):
    """Plain PyTorch grouped reduction of sorted centroids with their
    bucket ids -> four (..., k_out) planes."""
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


def compact_plain(a, k_out: int, b=None):
    """Plain PyTorch compaction of the plane set ``a`` (and ``b``, joined
    along the last axis) -> four (..., k_out) planes."""
    if b is not None:
        a = [torch.cat([u, v], -1) for u, v in zip(a, b)]
    n, mean, m2, sum_x = sort_planes(*a)
    return bucket_reduce_plain(n, mean, m2, sum_x, bucket_ids(n, k_out),
                               k_out)


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("sketch_compact").sketch_compact_launch
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_longlong] \
        + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _check_set(planes, dev, lead, what):
    names = ("n", "mean", "m2", "sum_x")
    if len(planes) != 4:
        raise ValueError(f"sketch_compact: {what} must hold four planes")
    J = planes[0].shape[-1] if planes[0].dim() else 0
    for name, t in zip(names, planes):
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous() or t.shape != lead + (J,):
            raise ValueError(f"sketch_compact: {what} {name} must be a "
                             f"contiguous float32 {tuple(lead)} + (J,) "
                             f"tensor on {dev}")
    return J


def compact_kernel(a, k_out: int, b=None, *, warps: int = WARPS,
                   gen_warps: int = GEN_WARPS):
    """Launch ``csrc/sketch_compact.cu`` on the plane set ``a`` (and
    ``b``) -> four (..., k_out) planes.  One launch a call (none when
    there is no row)."""
    warps, gen_warps = _check_knobs(warps, gen_warps)
    dev = a[0].device
    if a[0].dim() == 0:
        raise ValueError("sketch_compact: planes need a centroid axis")
    lead = a[0].shape[:-1]
    Ja = _check_set(a, dev, lead, "a")
    Jb = 0 if b is None else _check_set(b, dev, lead, "b")
    if not 0 < k_out <= MAX_BUCKETS:
        raise ValueError(f"sketch_compact: K = {k_out}, expected "
                         f"1..{MAX_BUCKETS}")
    if not 0 < Ja + Jb <= MAX_CENTROIDS:
        raise ValueError(f"sketch_compact: J = {Ja + Jb}, expected "
                         f"1..{MAX_CENTROIDS}")
    out = [torch.empty(lead + (k_out,), dtype=torch.float32, device=dev)
           for _ in range(4)]
    R = out[0].numel() // k_out
    if R == 0:
        return tuple(out)
    bp = [t.data_ptr() for t in b] if b is not None else [None] * 4
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(*(t.data_ptr() for t in a), *bp,
                     *(o.data_ptr() for o in out), R, Ja, Jb, k_out, warps,
                     gen_warps, stream)
    _build.check(rc, "sketch_compact")
    _build.launched("sketch_compact", lambda: cost(R, Ja + Jb, k_out))
    return tuple(out)


def compact(a, k_out: int, b=None, *, warps: int = WARPS,
            gen_warps: int = GEN_WARPS):
    """The plain version on a CPU tensor, else the kernel (or a raise).
    The knobs are checked on both: the plain version never sees them."""
    if a[0].device.type == "cpu":
        _check_knobs(warps, gen_warps)
        return compact_plain(a, k_out, b)
    return compact_kernel(a, k_out, b, warps=warps, gen_warps=gen_warps)
