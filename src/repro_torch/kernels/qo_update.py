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
reduction over the whole batch) on a CPU one.  The kernel cuts the rows
into :func:`pieces` contiguous pieces, reduces each with its own two-pass
M2 and Chan-merges them in piece order; the TPU kernel Chan-merges
1024-row tiles one after another.  The three differ by f32 rounding only.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build
from repro_torch.kernels.qo_update_leaves import bin_ids_plain

__all__ = ["update_plain", "update_kernel", "update", "pieces", "MAX_BINS",
           "PIECES", "MIN_PIECE_ROWS"]

#: Largest table the port takes; the kernel tiles the bins of a piece over
#: a grid dimension, 1024 bins a block, so a block's tables stay in shared
#: memory at every C up to this.
MAX_BINS = 49152
#: Pieces of the rows: two blocks on each of the H100's 132 SMs.
PIECES = 264
#: Fewer pieces when each would hold fewer rows than this.
MIN_PIECE_ROWS = 1024


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


def pieces(N: int):
    """``(G, piece_rows)``: the kernel's cut of N rows into G contiguous
    pieces of ``piece_rows`` rows (a multiple of 4, so every piece starts
    on a 16-byte boundary; the last piece may be shorter)."""
    if N == 0:
        return 0, 0
    per = max(MIN_PIECE_ROWS, -(-N // PIECES))
    per = -(-per // 4) * 4
    return -(-N // per), per


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_update").qo_update_launch
    fn.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_longlong] * 2 \
        + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


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
    G, per = pieces(N)
    partial = torch.empty(max(G, 1) * 4 * C, dtype=torch.float32, device=dev)
    out = torch.empty((4, C), dtype=torch.float32, device=dev).unbind(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(_launcher()(
        x.data_ptr(), y.data_ptr(), w.data_ptr(), radius.data_ptr(),
        origin.data_ptr(), n.data_ptr(), mean.data_ptr(), m2.data_ptr(),
        sum_x.data_ptr(), partial.data_ptr(), *(o.data_ptr() for o in out),
        N, per, G, C, stream), "qo_update")
    _build.LAUNCHES["qo_update"] += 1
    return tuple(out)


def update(n, mean, m2, sum_x, radius, origin, x, y, w):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if x.device.type == "cpu":
        return update_plain(n, mean, m2, sum_x, radius, origin, x, y, w)
    return update_kernel(n, mean, m2, sum_x, radius, origin, x, y, w)
