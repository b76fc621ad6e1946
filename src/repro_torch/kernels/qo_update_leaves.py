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
CPU one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["xla_int32", "bin_ids_plain", "absorb_plain", "absorb_kernel",
           "absorb", "sort_rows"]

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
    offsets of each leaf's run: the layout the absorb kernel walks."""
    order = torch.sort(gl, stable=True).indices.to(torch.int32)
    counts = torch.bincount(gl, minlength=n_leaves)
    if counts.numel() != n_leaves:
        raise ValueError(f"leaf ids reach {counts.numel() - 1}, the table "
                         f"axis holds {n_leaves}")
    offsets = torch.zeros(n_leaves + 1, dtype=torch.int32, device=gl.device)
    offsets[1:] = torch.cumsum(counts, 0)
    return order, offsets


@functools.lru_cache(maxsize=None)
def _launcher():
    fn = _build.library("qo_update_leaves").qo_update_leaves_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def absorb_kernel(tab_y, tab_sum_x, radius, origin, gl, X, y, w) -> None:
    """Launch ``csrc/qo_update_leaves.cu`` (in place on the four planes)."""
    N, F, C = tab_sum_x.shape
    B = X.shape[0]
    dev = X.device
    tensors = {"n": tab_y["n"], "mean": tab_y["mean"], "m2": tab_y["m2"],
               "sum_x": tab_sum_x, "radius": radius, "origin": origin,
               "X": X, "y": y, "w": w}
    for name, t in tensors.items():
        if not t.is_cuda or t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(f"qo_update_leaves: {name} must be a "
                             f"contiguous float32 tensor on {dev}")
    if gl.device != dev or gl.shape != w.shape or gl.shape[0] % max(B, 1):
        raise ValueError("qo_update_leaves: leaf ids and weights must be "
                         f"(T*B,) on {dev} with B = {B}")
    if radius.shape != (N, F) or origin.shape != (N, F) or y.shape != (B,):
        raise ValueError("qo_update_leaves: radius/origin must be (N, F) "
                         "and y (B,)")
    order, offsets = sort_rows(gl, N)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _launcher()(order.data_ptr(), offsets.data_ptr(), X.data_ptr(),
                     y.data_ptr(), w.data_ptr(), radius.data_ptr(),
                     origin.data_ptr(), tab_y["n"].data_ptr(),
                     tab_y["mean"].data_ptr(), tab_y["m2"].data_ptr(),
                     tab_sum_x.data_ptr(), N, B, F, C, stream)
    _build.check(rc, "qo_update_leaves")
    _build.LAUNCHES["qo_update_leaves"] += 1


def absorb(tab_y, tab_sum_x, radius, origin, gl, X, y, w) -> None:
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if X.device.type == "cpu":
        absorb_plain(tab_y, tab_sum_x, radius, origin, gl, X, y, w)
    else:
        absorb_kernel(tab_y, tab_sum_x, radius, origin, gl, X, y, w)
