"""QO absorb of a routed batch into every (leaf, feature) table.

Replaces ``src/repro/kernels/qo_update_leaves.py::qo_update_leaves_pallas``.
For each row r of the folded batch (tree t = r // B, row b = r % B, leaf
``gl[r]`` in the folded T*M table axis) and each feature f:

1. quantize ``x[b, f]`` into its leaf's bin ``floor((x - origin)/radius)
   + C/2``, clipped into [0, C) (:func:`bin_ids_plain`, ROADMAP C1);
2. sum w, w*y, w*x per (leaf, f, bin), then w * (y - bin mean)^2;
3. Chan-merge those batch stats into the running (n, mean, M2) and add
   the w*x sums to ``sum_x``.

The tables are updated IN PLACE on both paths (at the full width the four
planes hold 268 MB; an out-of-place copy doubles that), so a caller that
needs the old tables clones them first.  :func:`absorb` launches
``csrc/qo_update_leaves.cu`` on a CUDA tensor and runs
:func:`absorb_plain` (the reference's ``ops._forest_update_jnp``) on a
CPU one.  The kernel walks the rows sorted by leaf: a caller that sorted
them already (the step's segment statistics do) passes ``rows=(order,
offsets)`` from :func:`sort_rows`, and the wrapper sorts only when it is
not given them.  Each leaf's run is cut into pieces of at most
:data:`PIECE_ROWS` rows; a leaf of several pieces merges its pieces'
statistics in piece order (the TPU kernel merges 256-row tiles in order).
``PIECE_ROWS`` sets where that sequential merge cuts a leaf's rows, so
another value would reorder f32 sums: it stays compile-time
(``repro_torch.perf.tune.KERNEL_STREAM_KNOBS``).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["xla_int32", "bin_ids_plain", "absorb_plain", "absorb_kernel",
           "absorb", "sort_rows", "cost", "PIECE_ROWS"]

#: Rows of a piece: ``PIECE_ROWS`` in ``csrc/qo_update_leaves.cu`` (the
#: launcher checks that the two agree).
PIECE_ROWS = 128


def cost(N: int, R: int, B: int, F: int, C: int, touched=None):
    """``(bytes, flops)`` of absorbing R folded rows (X of B rows) into
    (N, F, C) tables: X, y, the leaf ids and weights read once, and the
    tables of the ``touched`` leaves (every leaf a row reaches; at most
    min(N, R) unless given) read and written once; about 16 flops a row
    and feature and 14 a touched bin."""
    touched = min(N, R) if touched is None else touched
    nbytes = B * F * 4 + B * 4 + R * 8 + touched * F * (C * 32 + 8)
    return nbytes, R * F * 16 + touched * F * C * 14

_I32_MIN, _I32_MAX = -(2 ** 31), 2 ** 31 - 1


def xla_int32(v) -> torch.Tensor:
    """f32 -> int32 as XLA casts (ROADMAP C1): truncation toward zero,
    saturating at the int32 limits, NaN -> 0, returned as int64 so that a
    caller can reproduce int32 wraparound on what it adds next.  torch's
    own ``.to(int32)`` sends NaN and +inf to INT_MIN on x86."""
    h = torch.nan_to_num(v.double(), nan=0.0, posinf=float(_I32_MAX),
                         neginf=float(_I32_MIN))
    return torch.clamp(h, _I32_MIN, _I32_MAX).to(torch.int64)


def bin_ids_plain(radius, origin, X, n_bins: int) -> torch.Tensor:
    """Bin ids with the reference's integer semantics (ROADMAP C1).

    XLA casts f32 -> int32 with saturation and NaN -> 0, then the
    ``+ n_bins // 2`` wraps around in int32 before the clip: x = 1e10 or
    +inf lands in bin 0, NaN in bin ``n_bins // 2``.  A plain
    ``floor(...).to(int32)`` would send NaN to INT_MIN (bin 0) instead.
    """
    h = xla_int32(torch.floor((X - origin) / radius)) + n_bins // 2
    h = (h - _I32_MIN) % (2 ** 32) + _I32_MIN        # int32 wraparound
    return torch.clamp(h, 0, n_bins - 1).to(torch.int32)


def absorb_plain(tab_y, tab_sum_x, radius, origin, gl, X, y, w) -> None:
    """Plain PyTorch absorb, in place: one segment reduction per payload
    over the flat (N*F*C) id space, two-pass M2, one Chan merge."""
    N, F, C = tab_sum_x.shape
    B = X.shape[0]
    dev = X.device
    gl = gl.long()
    b = torch.arange(gl.shape[0], device=dev) % B
    Xr, yr = X[b], y[b]
    bins = bin_ids_plain(radius[gl], origin[gl], Xr, C).long()
    seg = ((gl[:, None] * F + torch.arange(F, device=dev)[None, :]) * C
           + bins).reshape(-1)
    wr = w.repeat_interleave(F)
    yrr = yr.repeat_interleave(F)
    xf = Xr.reshape(-1)

    def segsum(v):
        return torch.zeros(N * F * C, dtype=torch.float32,
                           device=dev).index_add_(0, seg, v)

    nb, syb, sxb = segsum(wr), segsum(wr * yrr), segsum(wr * xf)
    meanb = torch.where(nb > 0, syb / torch.where(nb > 0, nb, 1.0), 0.0)
    # second pass: residuals against the batch's own bin means
    m2b = segsum(wr * (yrr - meanb[seg]) ** 2)
    tile = {"n": nb.view(N, F, C), "mean": meanb.view(N, F, C),
            "m2": m2b.view(N, F, C)}
    merged = stats.merge(tab_y, tile)
    for k in ("n", "mean", "m2"):
        tab_y[k].copy_(merged[k])
    tab_sum_x.add_(sxb.view(N, F, C))


def sort_rows(gl, n_leaves: int):
    """Folded rows ordered by leaf (stable) and the (n_leaves + 1,) segment
    offsets of each leaf's run: the layout the absorb kernel walks.

    No host read: the offsets come from the sorted ids by binary search.
    A row whose id lies outside [0, n_leaves) belongs to no run (its
    position is before ``offsets[0]`` or from ``offsets[-1]`` on), so
    ``offsets[-1] - offsets[0]`` falls short of the row count exactly when
    some id is out of range."""
    keys, order = torch.sort(gl, stable=True)
    bounds = torch.arange(n_leaves + 1, dtype=keys.dtype, device=keys.device)
    offsets = torch.searchsorted(keys, bounds, out_int32=True)
    return order.to(torch.int32), offsets


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("qo_update_leaves")
    lib.qo_update_leaves_launch.argtypes = [ctypes.c_void_p] * 13 \
        + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.qo_update_leaves_launch.restype = ctypes.c_int
    lib.qo_update_leaves_feature_group.argtypes = [ctypes.c_int] * 2
    lib.qo_update_leaves_feature_group.restype = ctypes.c_int
    if lib.qo_update_leaves_piece_rows() != PIECE_ROWS:
        raise RuntimeError("qo_update_leaves: PIECE_ROWS differs between "
                           "the module and its CUDA source")
    return lib


def absorb_kernel(tab_y, tab_sum_x, radius, origin, gl, X, y, w,
                  rows=None) -> None:
    """Launch ``csrc/qo_update_leaves.cu`` (in place on the four planes).

    ``rows``: the ``(order, offsets)`` of :func:`sort_rows` for ``gl``, if
    the caller has them; rows whose ids lie outside [0, N) are then left
    out (the step's segment statistics raise on them).  Without ``rows``
    the wrapper sorts and raises on such ids itself, with a host read."""
    N, F, C = tab_sum_x.shape
    B = X.shape[0]
    n_rows = gl.shape[0]
    dev = X.device
    tensors = {"n": tab_y["n"], "mean": tab_y["mean"], "m2": tab_y["m2"],
               "sum_x": tab_sum_x, "radius": radius, "origin": origin,
               "X": X, "y": y, "w": w}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"qo_update_leaves: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    if gl.device != dev or gl.shape != w.shape or n_rows % max(B, 1):
        raise ValueError("qo_update_leaves: leaf ids and weights must be "
                         f"(T*B,) on {dev} with B = {B}")
    if radius.shape != (N, F) or origin.shape != (N, F) or y.shape != (B,):
        raise ValueError("qo_update_leaves: radius/origin must be (N, F) "
                         "and y (B,)")
    if n_rows >= 2 ** 31 or N >= 2 ** 31:
        raise ValueError("qo_update_leaves: at most 2^31 - 1 rows and "
                         "tables a call")
    if rows is None:
        rows = sort_rows(gl, N)
        # a host read, off the main path (which passes rows)
        if int(rows[1][-1] - rows[1][0]) != n_rows:
            raise ValueError(f"qo_update_leaves: leaf ids outside [0, {N})")
    order, offsets = rows
    for name, t, shape in (("order", order, (n_rows,)),
                           ("offsets", offsets, (N + 1,))):
        if t.device != dev or t.dtype != torch.int32 \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"qo_update_leaves: {name} must be a "
                             f"contiguous int32 {shape} tensor on {dev}")
    if n_rows == 0 or F == 0 or N == 0:
        return
    lib = _library()
    group = lib.qo_update_leaves_feature_group(F, C)
    if group == 0:
        raise ValueError(f"qo_update_leaves: C = {C} bins of one feature "
                         "outgrow a block's shared memory")
    # the piece list (int4 entries), each long leaf's arrival count, the
    # counts and the ticket; scratch for the pieces of long leaves
    pieces = -(-n_rows // PIECE_ROWS) + min(N, n_rows)
    slots = 2 * -(-n_rows // PIECE_ROWS) if n_rows > PIECE_ROWS else 0
    plan = torch.empty(4 * pieces + slots + 3, dtype=torch.int32,
                       device=dev)
    scratch = torch.empty(max(slots * 4 * F * C, 1), dtype=torch.float32,
                          device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = lib.qo_update_leaves_launch(
        order.data_ptr(), offsets.data_ptr(), X.data_ptr(), y.data_ptr(),
        w.data_ptr(), radius.data_ptr(), origin.data_ptr(),
        tab_y["n"].data_ptr(), tab_y["mean"].data_ptr(),
        tab_y["m2"].data_ptr(), tab_sum_x.data_ptr(), plan.data_ptr(),
        scratch.data_ptr(), N, n_rows, B, F, C, group, stream)
    _build.check(rc, "qo_update_leaves")
    _build.launched("qo_update_leaves", lambda: cost(
        N, n_rows, B, F, C, touched=int((offsets.diff() > 0).sum())))


def absorb(tab_y, tab_sum_x, radius, origin, gl, X, y, w,
           rows=None) -> None:
    """The plain version on a CPU tensor (``rows`` unused), else the
    kernel (or a raise)."""
    if X.device.type == "cpu":
        absorb_plain(tab_y, tab_sum_x, radius, origin, gl, X, y, w)
    else:
        absorb_kernel(tab_y, tab_sum_x, radius, origin, gl, X, y, w, rows)
