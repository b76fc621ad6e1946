"""E-BST / TE-BST insert and split query (the paper's baselines).

No TPU kernel exists for these: the reference's ``core/ebst.py`` lowers
the serial insert (``_insert_one``, ``ebst.py:60``) to a ``lax.scan`` of a
``lax.while_loop`` and the in-order query (``best_split``, ``ebst.py:135``)
to a ``lax.while_loop`` over an explicit stack.  Here each is a kernel of
``csrc/ebst.cu`` on the card: the insert one block whose walker warp walks
the structure (its top in shared memory) while other warps apply the
statistics, the query a level-synchronous walk that computes every
node's left statistics (one block on narrow levels, the whole card on
wide ones), then a grid that scores them and picks the best in
in-order.

The tree is the reference's dict: ``key`` (cap,) f32, ``left`` /
``right`` (cap,) i32 (-1 = nil), ``le`` Stats (cap,), ``size`` () i32,
``total`` Stats (), ``decimals`` () i32 (>= 0: TE-BST).

* :func:`insert` folds rows into the tree IN PLACE: the kernel on CUDA
  tensors, :func:`insert_plain` on CPU tensors;
* :func:`query` returns ``(threshold, merit, valid)`` 0-d tensors: the
  kernel, or :func:`query_plain`.

The plain versions walk the same arrays with scalar tensor reads and the
port's :mod:`repro_torch.core.stats` algebra on 0-d tensors; the kernels
take every operation in their order with explicit rounding, so the two
are bitwise equal.  :func:`query_model` is a plain PyTorch model of the
query kernel's algorithm (level-synchronous left statistics, parallel
scores, the in-order tie key), used by the tests.  :func:`insert_serial`
and :func:`query_serial` launch single-thread kernels of the same walks, a
bitwise oracle on the card where the plain versions take minutes; no
path of :mod:`repro_torch.core.ebst` calls them.  Launches of the path's
kernels are counted under ``"ebst_insert"`` and ``"ebst_query"`` in
:data:`repro_torch.kernels._build.LAUNCHES`; the oracle's are not.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import stats
from repro_torch.kernels import _build

__all__ = ["insert_plain", "insert_kernel", "insert", "query_plain",
           "query_kernel", "query", "query_model", "inorder_keys",
           "insert_serial", "query_serial", "insert_cost", "query_cost",
           "STACK_ENTRY_BYTES", "SHARED_NODES"]

#: One stack entry of the serial query: node (i32) and S (3 x f32).
STACK_ENTRY_BYTES = 16
#: Nodes the insert kernel keeps in shared memory (``csrc/ebst.cu``
#: ``SHARED_NODES``; the launcher checks that the two agree).
SHARED_NODES = 13312

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


def _order_codes(k):
    """The query kernel's order code of each non-NaN f32 key, int64: the
    float order as unsigned integers, -0.0 as +0.0, every code above
    ``_LO_NONE``."""
    u = (k + 0.0).view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


_LO_NONE = 0


def _levels(t):
    """The query kernel's level-synchronous walk of the tree by depth.
    A level's nodes v take left(v) = merge(left(c(v)), le[v]) together,
    c(v) being v's nearest ancestor whose right subtree holds v (none:
    the empty statistics), which an earlier level computed; children
    learn c from their parent.  lo(v) is the order code of the largest
    non-NaN key among the ancestors v passed on the right (``_LO_NONE``
    if none).  Returns ``(left stats (size,), lo (size,) int64, c (size,)
    int64, levels)``."""
    key, left, right, le = t["key"], t["left"], t["right"], t["le"]
    size = int(t["size"])
    dev = key.device
    L = stats.init((size,), dev)
    lo = torch.full((size,), _LO_NONE, dtype=torch.int64, device=dev)
    c = torch.full((size,), -1, dtype=torch.int64, device=dev)
    nodes = torch.zeros(1 if size else 0, dtype=torch.int64, device=dev)
    levels = 0
    while nodes.numel():
        levels += 1
        cv = c[nodes]
        S = {k: torch.where(cv >= 0, v[cv.clamp(min=0)], 0.0)
             for k, v in L.items()}
        Lv = stats.merge(S, {k: v[nodes] for k, v in le.items()})
        for k, v in Lv.items():
            L[k][nodes] = v
        kv = key[nodes]
        lo_r = torch.where(torch.isnan(kv), lo[nodes], _order_codes(kv))
        lc, rc = left[nodes].long(), right[nodes].long()
        hl, hr = lc >= 0, rc >= 0
        c[lc[hl]], lo[lc[hl]] = cv[hl], lo[nodes][hl]
        c[rc[hr]], lo[rc[hr]] = nodes[hr], lo_r[hr]
        nodes = torch.cat([lc[hl], rc[hr]])
    return L, lo, c, levels


def inorder_keys(t):
    """The query kernel's tie key of every node, (size,) int64: smaller
    is earlier in in-order.  Non-NaN keys are in in-order ascending
    (a duplicate adds no node; -0.0 == 0.0).  A NaN key goes right at
    every node, so NaN nodes lie on the root's right spine with no left
    child, after every node outside their subtree and before the rest of
    it; the nodes outside are those whose key is <= lo.  So the key is
    (code(key), 0, v) for a non-NaN key and (code(lo), 1, v) for a NaN
    one (a deeper NaN node, made later, has the larger v)."""
    key = t["key"][:int(t["size"])]
    _, lo, _, _ = _levels(t)
    v = torch.arange(key.shape[0], dtype=torch.int64, device=key.device)
    nan = torch.isnan(key)
    code = torch.where(nan, lo, _order_codes(key))
    return (code - 2 ** 31) * 2 ** 32 + nan.to(torch.int64) * 2 ** 31 + v


def query_model(t):
    """Plain PyTorch model of the query kernel's algorithm (used by the
    tests): every node's left statistics level by level (:func:`_levels`),
    right = subtract(total, left), the VR of all nodes at once, then the
    largest non-NaN score, ties to the smallest :func:`inorder_keys`.
    Bitwise equal to :func:`query_plain`: the same operations on the same
    operands, and the walk's "first strictly greater score" is the
    largest score's first node in in-order."""
    key, total = t["key"], t["total"]
    size = int(t["size"])
    thr = torch.zeros((), dtype=torch.float32, device=key.device)
    best = torch.tensor(float("-inf"), device=key.device)
    if size:
        left_s, _, _, _ = _levels(t)
        right_s = stats.subtract(total, left_s)
        n_tot = torch.clamp(total["n"], min=1.0)
        ok = (left_s["n"] > 0) & (right_s["n"] > 0)
        vr = stats.variance(total) \
            - (left_s["n"] / n_tot) * stats.variance(left_s) \
            - (right_s["n"] / n_tot) * stats.variance(right_s)
        score = torch.where(ok, vr, float("-inf"))
        live = ~torch.isnan(score)
        if bool(live.any()):
            top = score[live].max()
            tied = live & (score == top)
            w = torch.where(tied, inorder_keys(t),
                            torch.iinfo(torch.int64).max).argmin()
            if bool(score[w] > best):
                best, thr = score[w], key[w].clone()
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


def _launcher(name, argtypes, restype=ctypes.c_int):
    fn = getattr(_build.library("ebst"), name)
    fn.argtypes, fn.restype = argtypes, restype
    return fn


_INSERT_ARGS = [ctypes.c_void_p] * 11 + [ctypes.c_longlong, ctypes.c_int,
                                         ctypes.c_void_p]


@functools.lru_cache(maxsize=None)
def _insert_launcher():
    shared = _launcher("ebst_shared_nodes", [])()
    if shared != SHARED_NODES:
        raise RuntimeError(f"ebst_insert: csrc/ebst.cu keeps {shared} nodes "
                           f"in shared memory, kernels/ebst.py says "
                           f"{SHARED_NODES}")
    return _launcher("ebst_insert_launch", _INSERT_ARGS)


@functools.lru_cache(maxsize=None)
def _query_launcher():
    return _launcher("ebst_query_launch", [ctypes.c_void_p] * 9
                     + [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _serial_launchers():
    return (_launcher("ebst_insert_serial_launch", _INSERT_ARGS),
            _launcher("ebst_query_serial_launch", [ctypes.c_void_p] * 11))


@functools.lru_cache(maxsize=None)
def _query_scratch_bytes(cap: int) -> int:
    return _launcher("ebst_query_scratch_bytes", [ctypes.c_int],
                     ctypes.c_longlong)(cap)


def _check_rows(dev, xs, ys, what):
    N = xs.shape[0]
    for name, a in (("xs", xs), ("ys", ys)):
        if not a.is_cuda or a.device != dev or a.dtype != torch.float32 \
                or not a.is_contiguous() or tuple(a.shape) != (N,):
            raise ValueError(f"{what}: {name} must be a contiguous "
                             f"float32 (N,) tensor on {dev}")
    return N


def _run_insert(launch, t, xs, ys, cap, dev):
    """Launch an insert kernel; the total's three scalars are packed into
    one buffer for the launch and copied back after it (no host read)."""
    tot = torch.stack([t["total"][k] for k in ("n", "mean", "m2")])
    stream = torch.cuda.current_stream(dev).cuda_stream
    le = t["le"]
    rc = launch(
        t["key"].data_ptr(), t["left"].data_ptr(), t["right"].data_ptr(),
        le["n"].data_ptr(), le["mean"].data_ptr(), le["m2"].data_ptr(),
        t["size"].data_ptr(), tot.data_ptr(), t["decimals"].data_ptr(),
        xs.data_ptr(), ys.data_ptr(), xs.shape[0], cap, stream)
    _build.check(rc, "ebst")
    for i, k in enumerate(("n", "mean", "m2")):
        t["total"][k].copy_(tot[i])


def _query_args(t):
    le = t["le"]
    tot = torch.stack([t["total"][k] for k in ("n", "mean", "m2")])
    return tot, (t["key"].data_ptr(), t["left"].data_ptr(),
                 t["right"].data_ptr(), le["n"].data_ptr(),
                 le["mean"].data_ptr(), le["m2"].data_ptr(),
                 t["size"].data_ptr(), tot.data_ptr())


def insert_kernel(t, xs, ys) -> None:
    """Launch ``ebst_insert`` of ``csrc/ebst.cu``: the rows (xs, ys), (N,)
    contiguous float32 on the tree's device, in order, in place."""
    dev, cap = _check(t, "ebst_insert")
    N = _check_rows(dev, xs, ys, "ebst_insert")
    if N == 0:
        return
    _run_insert(_insert_launcher(), t, xs, ys, cap, dev)
    _build.launched("ebst_insert", lambda: insert_cost(N, int(t["size"])))


def query_kernel(t):
    """Launch ``ebst_query`` of ``csrc/ebst.cu`` -> (threshold, merit,
    valid) 0-d tensors on the card; its level queue, left statistics and
    per-block bests live in one scratch buffer of
    ``ebst_query_scratch_bytes(cap)`` bytes."""
    dev, cap = _check(t, "ebst_query")
    launch = _query_launcher()
    scratch = torch.empty(_query_scratch_bytes(cap), dtype=torch.uint8,
                          device=dev)
    out = torch.empty(3, dtype=torch.float32, device=dev)
    tot, args = _query_args(t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = launch(*args, scratch.data_ptr(), cap, out.data_ptr(), stream)
    _build.check(rc, "ebst")
    _build.launched("ebst_query", lambda: query_cost(int(t["size"])))
    return out[0], out[1], out[2] > 0


def insert_serial(t, xs, ys) -> None:
    """The serial insert kernel (one thread), in place: a bitwise oracle
    on the card; not counted in ``LAUNCHES``."""
    dev, cap = _check(t, "ebst_insert_serial")
    _check_rows(dev, xs, ys, "ebst_insert_serial")
    if xs.shape[0]:
        _run_insert(_serial_launchers()[0], t, xs, ys, cap, dev)


def query_serial(t):
    """The serial query kernel (one thread, its stack of cap + 1 entries
    in scratch): a bitwise oracle on the card; not counted in
    ``LAUNCHES``."""
    dev, cap = _check(t, "ebst_query_serial")
    launch = _serial_launchers()[1]
    stack = torch.empty((cap + 1) * STACK_ENTRY_BYTES, dtype=torch.uint8,
                        device=dev)
    out = torch.empty(3, dtype=torch.float32, device=dev)
    tot, args = _query_args(t)
    stream = torch.cuda.current_stream(dev).cuda_stream
    _build.check(launch(*args, stack.data_ptr(), out.data_ptr(), stream),
                 "ebst")
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
