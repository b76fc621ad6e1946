"""Every forest step's drift test and the window-state writes after it.

Replaces no TPU kernel: the JAX package leaves this step to XLA
(``csrc/drift_test.cu`` says why the port has a kernel for it).  Over the
(T,) members, before this batch folds into the long window (a
short-vs-long error-window test):

1. ``frac``, the batch's share of real rows (0 when every row weighs 0),
   ``alpha = drift_alpha * frac`` and the short window's ``ewma`` (the
   member's error itself on its first live batch);
2. ``signal``: at least ``min_batches`` in the long window and an ewma
   above its mean plus ``kappa`` sample standard deviations; ``drift`` at
   the worst signalling member alone (the first largest ewma);
3. the long window decayed by ``decay ** frac`` and observed with the
   member's error at weight ``frac``, frozen where ``signal`` holds;
4. where ``drift`` holds the window and ewma are zeroed and ``resets``
   advances: the reset a swapped member gets.

:func:`drift_test` runs :func:`drift_test_plain` (that composition, as
``core/forest.py::_update`` wrote it) on a CPU tensor and launches the
kernel on a CUDA one.  Both return new ``(drift, err_win, err_ewma,
resets)`` and write ``flags[0] = drift.any()`` (``flags[1:]``, where there
is one, is left alone), so that the forest step reads the swap decision
with the host read it makes anyway.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from repro_torch.core import stats
from repro_torch.kernels import _build
from repro_torch.perf.spans import count

__all__ = ["drift_test", "drift_test_plain", "drift_test_kernel", "cost"]


def cost(T: int):
    """``(bytes, flops)`` of one call over T members: the error, the three
    window statistics, the ewma and resets read, the same and ``drift``
    written, two row-weight sums read and the flag written; about 24
    flops a member."""
    return T * (6 * 4 + 5 * 4 + 1) + 2 * 4 + 1, T * 24


def drift_test_plain(member_mse, wraw, wsum, err_win, err_ewma, resets,
                     flags, B: int, drift_alpha: float, drift_decay: float,
                     drift_kappa: float, min_batches: int):
    """The drift test as the forest step composed it: ``wraw`` the batch's
    row-weight sum, ``wsum`` the same clamped at 1e-12, B its rows.
    Returns new ``(drift, err_win, err_ewma, resets)``; writes
    ``flags[0]``."""
    T, dev = member_mse.shape[0], member_mse.device
    live = wraw > 0
    frac = torch.where(live, torch.clamp(wsum / max(float(B), 1.0),
                                         max=1.0), 0.0)
    alpha = drift_alpha * frac
    first = (err_win["n"] < 0.5) & live
    ewma = torch.where(first, member_mse,
                       (1.0 - alpha) * err_ewma + alpha * member_mse)
    ref = err_win
    sd = torch.sqrt(torch.clamp(stats.variance(ref), min=1e-12))
    signal = (ref["n"] >= min_batches) \
        & (ewma > ref["mean"] + drift_kappa * sd)
    # swap at most the WORST signalling member per batch
    worst = torch.argmax(torch.where(signal, ewma, float("-inf")))
    drift = signal & (torch.arange(T, device=dev) == worst)
    decay_f32 = torch.tensor(drift_decay, dtype=torch.float32, device=dev)
    decay = torch.where(frac >= 1.0, decay_f32, decay_f32 ** frac)
    decayed = {"n": decay * ref["n"], "mean": ref["mean"],
               "m2": decay * ref["m2"]}
    observed = stats.observe(decayed, member_mse, frac)
    # a signalling member's reference freezes (no decay, no observe)
    win = {k: torch.where(signal, ref[k], observed[k]) for k in observed}
    torch.any(drift, 0, keepdim=True, out=flags[:1])
    return (drift, {k: torch.where(drift, 0.0, v) for k, v in win.items()},
            torch.where(drift, 0.0, ewma), resets + drift.to(torch.int32))


@functools.lru_cache(maxsize=None)
def _library():
    lib = _build.library("drift_test")
    lib.drift_test_launch.argtypes = [ctypes.c_void_p] * 15 \
        + [ctypes.c_int] + [ctypes.c_float] * 5 + [ctypes.c_void_p]
    lib.drift_test_launch.restype = ctypes.c_int
    return lib


def drift_test_kernel(member_mse, wraw, wsum, err_win, err_ewma, resets,
                      flags, B: int, drift_alpha: float, drift_decay: float,
                      drift_kappa: float, min_batches: int):
    """Launch ``csrc/drift_test.cu`` (one block, any T): new ``(drift,
    err_win, err_ewma, resets)``, the three statistics and the ewma rows
    of one (4, T) tensor; writes ``flags[0]``.  Each launch counts
    ``forest.drift_test`` while a profiler records."""
    T, dev = member_mse.shape[0], member_mse.device
    for name, t, dtype, shape in (
            ("member_mse", member_mse, torch.float32, (T,)),
            ("n", err_win["n"], torch.float32, (T,)),
            ("mean", err_win["mean"], torch.float32, (T,)),
            ("m2", err_win["m2"], torch.float32, (T,)),
            ("err_ewma", err_ewma, torch.float32, (T,)),
            ("resets", resets, torch.int32, (T,)),
            ("wraw", wraw, torch.float32, ()),
            ("wsum", wsum, torch.float32, ())):
        if not t.is_cuda or t.device != dev or t.dtype != dtype \
                or not t.is_contiguous() or tuple(t.shape) != shape:
            raise ValueError(f"drift_test: {name} must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    if flags.device != dev or flags.dtype != torch.bool \
            or flags.dim() != 1 or flags.numel() < 1:
        raise ValueError(f"drift_test: flags must be a (>= 1,) bool on {dev}")
    if not 1 <= T < 2 ** 31:
        raise ValueError(f"drift_test: {T} members")
    out = torch.empty((4, T), dtype=torch.float32, device=dev)
    out_resets = torch.empty((T,), dtype=torch.int32, device=dev)
    drift = torch.empty((T,), dtype=torch.bool, device=dev)
    # a tensor over a host scalar is, on the card, a multiply by the
    # scalar's float reciprocal
    inv_b = float(np.float32(1.0) / np.float32(max(float(B), 1.0)))
    n, mean, m2, ewma = out.unbind(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().drift_test_launch(
        member_mse.data_ptr(), wraw.data_ptr(), wsum.data_ptr(),
        err_win["n"].data_ptr(), err_win["mean"].data_ptr(),
        err_win["m2"].data_ptr(), err_ewma.data_ptr(), resets.data_ptr(),
        n.data_ptr(), mean.data_ptr(), m2.data_ptr(), ewma.data_ptr(),
        out_resets.data_ptr(), drift.data_ptr(), flags.data_ptr(), T, inv_b,
        drift_alpha, drift_decay, drift_kappa, float(min_batches), stream)
    _build.check(rc, "drift_test")
    _build.launched("drift_test", lambda: cost(T))
    count("forest.drift_test")
    return drift, {"n": n, "mean": mean, "m2": m2}, ewma, out_resets


def drift_test(member_mse, wraw, wsum, err_win, err_ewma, resets, flags,
               B: int, drift_alpha: float, drift_decay: float,
               drift_kappa: float, min_batches: int):
    """The plain version on a CPU tensor, else the kernel or a raise.
    Returns new ``(drift, err_win, err_ewma, resets)``; writes
    ``flags[0]``."""
    fn = drift_test_plain if member_mse.device.type == "cpu" \
        else drift_test_kernel
    return fn(member_mse, wraw, wsum, err_win, err_ewma, resets, flags, B,
              drift_alpha, drift_decay, drift_kappa, min_batches)
