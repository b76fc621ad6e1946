"""E-BST / TE-BST insert and split query (the paper's baselines).

No TPU kernel exists for these: the reference's ``core/ebst.py`` lowers
the serial insert (``_insert_one``, ``ebst.py:60``) to a ``lax.scan`` of a
``lax.while_loop`` and the in-order query (``best_split``, ``ebst.py:135``)
to a ``lax.while_loop`` over an explicit stack.  Here each is one launch
of ``csrc/ebst.cu`` on the card.

The tree is the reference's dict: ``key`` (cap,) f32, ``left`` /
``right`` (cap,) i32 (-1 = nil), ``le`` Stats (cap,), ``size`` () i32,
``total`` Stats (), ``decimals`` () i32 (>= 0: TE-BST).

* :func:`insert` folds rows into the tree IN PLACE: the kernel on CUDA
  tensors, :func:`insert_plain` on CPU tensors;
* :func:`query` returns ``(threshold, merit, valid)`` 0-d tensors: the
  kernel, or :func:`query_plain`.

The plain versions walk the same arrays with scalar tensor reads and the
port's :mod:`repro_torch.core.stats` algebra on 0-d tensors; the kernel
takes every operation in their order with explicit rounding, so the two
are bitwise equal.  Launches are counted under ``"ebst_insert"`` and
``"ebst_query"`` in :data:`repro_torch.kernels._build.LAUNCHES`.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["insert_plain", "insert_kernel", "insert", "query_plain",
           "query_kernel", "query", "insert_cost", "query_cost",
           "STACK_ENTRY_BYTES"]

#: One query stack entry in the kernel: node (i32) and S (3 x f32).
STACK_ENTRY_BYTES = 16

_NIL = -1


def insert_cost(N: int, nodes: int, visits=None):
    """``(bytes, flops)`` of inserting N rows into a tree: the rows read
    once, the node arrays of ``nodes`` nodes (24 B a node; the tree's
    capacity, or its size after the insert) read and written once; 8
    flops a node visited (``visits``: at least one a row, N, unless
    given)."""
    visits = N if visits is None else visits
    return N * 8 + nodes * 24 * 2, visits * 8


def query_cost(size: int):
    """``(bytes, flops)`` of the in-order query of ``size`` nodes: each
    node's 24 B read once and the 12-byte result written; about 40 flops
    a node."""
    return size * 24 + 12, size * 40


def _get(le, i):
    return {k: v[i] for k, v in le.items()}


def _put(le, i, s):
    for k, v in s.items():
        le[k][i] = v


def _scales(decimals: int, dev):
    """(10^decimals, its reciprocal) in f32: the power by repeated
    multiplication (exact up to 10^10), the reciprocal rounded once, as
    the kernel forms them.  The reference's ``round(x * s) / s`` runs as
    ``round(x * s) * 10^-d``: XLA rewrites a division by ``pow(10, d)``
    into a product with ``pow(10, -d)``, and the port keeps its keys."""
    scale = torch.ones((), dtype=torch.float32, device=dev)
    for _ in range(decimals):
        scale = scale * 10.0
    return scale, torch.ones_like(scale) / scale


def insert_plain(t, xs, ys) -> None:
    """Plain PyTorch insert of the rows ``(xs, ys)``, in order, in place:
    the reference's ``_insert_one`` row by row."""
    key, left, right, le = t["key"], t["left"], t["right"], t["le"]
    cap = key.shape[0]
    dec = int(t["decimals"])
    scale, inv = _scales(dec, key.device)
    size = int(t["size"])
    tot = {k: v.clone() for k, v in t["total"].items()}
    empty = stats.init((), key.device)
    for x, y in zip(xs, ys):
        if dec >= 0:
            x = torch.round(x * scale) * inv       # half to even
        tot = stats.observe(tot, y)
        if size == 0:
            key[0] = x
            _put(le, 0, stats.observe(empty, y))
            size = 1
            continue
        cur = 0
        while True:
            k = key[cur]
            goes_left = bool(x <= k)
            if goes_left:
                _put(le, cur, stats.observe(_get(le, cur), y))
            is_eq = bool(x == k)
            side = left if goes_left else right
            child = int(side[cur])
            if child == _NIL and not is_eq:
                if size < cap:                # at capacity: stats only
                    key[size] = x
                    _put(le, size, stats.observe(empty, y))
                    side[cur] = size
                    size += 1
                break
            if is_eq:                         # a duplicate adds no node
                break
            cur = child
    t["size"].fill_(size)
    for k, v in tot.items():
        t["total"][k].copy_(v)


def query_plain(t):
    """Plain PyTorch split query: the reference's in-order walk with its
    explicit stack of (node, phase, S) entries."""
    key, left, right, le = t["key"], t["left"], t["right"], t["le"]
    total = t["total"]
    s2_d = stats.variance(total)
    n_tot = torch.clamp(total["n"], min=1.0)
    best = torch.tensor(float("-inf"), device=key.device)
    thr = torch.zeros((), dtype=torch.float32, device=key.device)
    stack = [(0, 0, stats.init((), key.device))] if int(t["size"]) > 0 \
        else []
    while stack:
        v, phase, S = stack.pop()
        if phase == 0:                        # descend
            stack.append((v, 1, S))
            lc = int(left[v])
            if lc != _NIL:
                stack.append((lc, 0, S))
            continue
        left_s = stats.merge(S, _get(le, v))  # emit
        right_s = stats.subtract(total, left_s)
        ok = bool((left_s["n"] > 0) & (right_s["n"] > 0))
        vr = s2_d - (left_s["n"] / n_tot) * stats.variance(left_s) \
            - (right_s["n"] / n_tot) * stats.variance(right_s)
        score = vr if ok else torch.tensor(float("-inf"))
        if bool(score > best):
            best, thr = score, key[v].clone()
        rc = int(right[v])
        if rc != _NIL:
            stack.append((rc, 0, left_s))
    valid = torch.isfinite(best)
    return thr, torch.where(valid, best, 0.0), valid


def _check(t, what):
    dev = t["key"].device
    cap = t["key"].shape[0]
    want = [("key", t["key"], torch.float32, (cap,)),
            ("left", t["left"], torch.int32, (cap,)),
            ("right", t["right"], torch.int32, (cap,)),
            ("size", t["size"], torch.int32, ()),
            ("decimals", t["decimals"], torch.int32, ())]
    want += [(f"le/{k}", v, torch.float32, (cap,)) for k, v in t["le"].items()]
    want += [(f"total/{k}", v, torch.float32, ())
             for k, v in t["total"].items()]
    for name, a, dtype, shape in want:
        if not a.is_cuda or a.device != dev or a.dtype != dtype \
                or not a.is_contiguous() or tuple(a.shape) != shape:
            raise ValueError(f"{what}: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {dev}")
    if not 0 < cap < 2 ** 31 - 1:
        raise ValueError(f"{what}: capacity {cap}, expected 1..2^31 - 2")
    return dev, cap


@functools.lru_cache(maxsize=None)
def _insert_launcher():
    fn = _build.library("ebst").ebst_insert_launch
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int,
                                            ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _query_launcher():
    fn = _build.library("ebst").ebst_query_launch
    fn.argtypes = [ctypes.c_void_p] * 11
    fn.restype = ctypes.c_int
    return fn


def insert_kernel(t, xs, ys) -> None:
    """Launch ``ebst_insert`` of ``csrc/ebst.cu``: the rows (xs, ys), (N,)
    contiguous float32 on the tree's device, in order, in place.  The
    total's three scalars are packed into one buffer for the launch and
    copied back after it (no host read)."""
    dev, cap = _check(t, "ebst_insert")
    N = xs.shape[0]
    for name, a in (("xs", xs), ("ys", ys)):
        if not a.is_cuda or a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous() or tuple(a.shape) != (N,):
            raise ValueError(f"ebst_insert: {name} must be a contiguous "
                             f"float32 (N,) tensor on {dev}")
    if N == 0:
        return
    tot = torch.stack([t["total"][k] for k in ("n", "mean", "m2")])
    stream = torch.cuda.current_stream(dev).cuda_stream
    le = t["le"]
    rc = _insert_launcher()(
        t["key"].data_ptr(), t["left"].data_ptr(), t["right"].data_ptr(),
        le["n"].data_ptr(), le["mean"].data_ptr(), le["m2"].data_ptr(),
        t["size"].data_ptr(), tot.data_ptr(), t["decimals"].data_ptr(),
        xs.data_ptr(), ys.data_ptr(), N, cap, stream)
    _build.check(rc, "ebst")
    _build.launched("ebst_insert", lambda: insert_cost(N, int(t["size"])))
    for i, k in enumerate(("n", "mean", "m2")):
        t["total"][k].copy_(tot[i])


def query_kernel(t):
    """Launch ``ebst_query`` of ``csrc/ebst.cu`` -> (threshold, merit,
    valid) 0-d tensors on the card; the stack is a scratch buffer of
    cap + 1 entries."""
    dev, cap = _check(t, "ebst_query")
    tot = torch.stack([t["total"][k] for k in ("n", "mean", "m2")])
    stack = torch.empty((cap + 1) * STACK_ENTRY_BYTES, dtype=torch.uint8,
                        device=dev)
    out = torch.empty(3, dtype=torch.float32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    le = t["le"]
    rc = _query_launcher()(
        t["key"].data_ptr(), t["left"].data_ptr(), t["right"].data_ptr(),
        le["n"].data_ptr(), le["mean"].data_ptr(), le["m2"].data_ptr(),
        t["size"].data_ptr(), tot.data_ptr(), stack.data_ptr(),
        out.data_ptr(), stream)
    _build.check(rc, "ebst")
    _build.launched("ebst_query", lambda: query_cost(int(t["size"])))
    return out[0], out[1], out[2] > 0


def insert(t, xs, ys) -> None:
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if t["key"].device.type == "cpu":
        return insert_plain(t, xs, ys)
    return insert_kernel(t, xs, ys)


def query(t):
    """The plain version on a CPU tensor, else the kernel (or a raise)."""
    if t["key"].device.type == "cpu":
        return query_plain(t)
    return query_kernel(t)
