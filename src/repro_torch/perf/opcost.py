"""Op-cost counter: flops and bytes of a callable, counted while it runs.

The counterpart of the reference's ``repro.launch.hlocost``, which walks a
compiled XLA module's HLO text and multiplies each computation by the trip
counts of the loops around it.  Eager PyTorch has no module to walk, so
:class:`OpCounter` counts the ops as they execute, which gives each loop
its real number of passes (what ``known_trip_count`` reconstructs for
XLA) with no walker:

* flops: the matmul-class aten ops (:data:`MATMUL_OPS`), ``2 *
  prod(output) * prod(contracted dims)`` each, as ``hlocost`` charges a
  ``dot``; elementwise flops are ignored, as there;
* bytes: operand plus result bytes of every op that moves data, the
  eager counterpart of ``hlocost``'s traffic-bearing classes (an eager
  elementwise op is its own kernel, as a fusion is in XLA).  Views,
  metadata and allocations move nothing.  A gather-like op
  (:data:`GATHER_OPS`) reads only what it produces, twice its result; an
  in-place scatter (:data:`SCATTER_OPS`) reads and writes its update
  operand, twice that; an in-place op's destination is charged once;
* the port's CUDA kernels launch through ctypes, where no dispatch mode
  sees them: each wrapper reports its launch through
  :func:`repro_torch.kernels._build.launched` with its kernel module's
  ``cost`` (the bytes each input is read and each output written once,
  and the kernel's operations), and the counter adds those.  A cost
  counts what the launch's data touches where the wrapper can read it on
  the card (the leaves a batch reached, the nodes a forest allocated, a
  tree's size; the counter does not charge those reads) and the launch's
  shapes elsewhere (a route's compares at its ply bound).

Under a ``DeviceMesh`` the counter sees each DTensor op after DTensor
has turned it into this rank's local ops and collectives (it declines
the DTensor-level call), so it counts one rank's work; the c10d
functional collectives DTensor issues are also summed by kind
(:data:`COLLECTIVES`, their result bytes, as ``hlocost`` charges them).

Use it as a context manager: ``with OpCounter() as c: fn(); c.flops``.
"""
from __future__ import annotations

from collections import defaultdict

import torch
from torch.utils._pytree import tree_flatten
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _build

__all__ = ["OpCounter", "count", "MATMUL_OPS", "GATHER_OPS", "SCATTER_OPS",
           "COLLECTIVES", "FREE_OPS"]

#: Matmul-class ops: ``2 * prod(output) * prod(contracted)`` flops each.
MATMUL_OPS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "mv", "addmv",
              "dot", "vdot"}
#: Ops that read only the elements they produce.
GATHER_OPS = {"gather", "index_select", "index", "take", "embedding",
              "masked_select"}
#: In-place ops that read and write only their update operand.
SCATTER_OPS = {"index_put_", "index_add_", "index_copy_", "scatter_",
               "scatter_add_", "scatter_reduce_", "masked_scatter_"}
#: The c10d functional collectives by kind.
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
#: Allocations and metadata: no kernel reads or writes data.
FREE_OPS = {"empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "_local_scalar_dense", "lift_fresh",
            "resize_", "set_", "sym_size", "sym_stride", "sym_numel",
            "is_nonzero", "equal", "record_stream", "_unsafe_view",
            "wait_tensor"}


from torch._subclasses.fake_tensor import FakeTensor as _FAKE

try:
    from torch.distributed.tensor import DTensor as _DTENSOR
except ImportError:          # a build without torch.distributed
    _DTENSOR = None


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _contracted(name: str, args) -> int:
    """Product of the contracted dims of one matmul-class op."""
    if name in ("mm", "bmm", "mv"):
        return args[0].shape[-1]
    if name in ("addmm", "baddbmm", "addmv"):
        return args[1].shape[-1]
    if name == "addbmm":                  # sums over the batch axis too
        return args[1].shape[0] * args[1].shape[-1]
    return args[0].numel()                # dot, vdot


def _is_view(func) -> bool:
    returns = func._schema.returns
    return bool(returns) and returns[0].alias_info is not None \
        and not returns[0].alias_info.is_write


class OpCounter(TorchDispatchMode):
    """Counts flops and bytes of every aten op and port kernel launched
    while it is entered.  ``flops``, ``bytes``; ``by_op[name] = [calls,
    flops, bytes]`` (a kernel under its launch-count name); ``devices``:
    the device types of the tensors seen; ``collectives[kind]``: the
    result bytes of the collectives issued."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.bytes = 0.0
        self.by_op = defaultdict(lambda: [0, 0.0, 0.0])
        self.devices: set = set()
        self.collectives = defaultdict(float)
        self._paused = False

    def _charge(self, name, flops, nbytes):
        self.flops += flops
        self.bytes += nbytes
        row = self.by_op[name]
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def _on_launch(self, name, cost):
        self._paused = True        # the cost's own reads are not the op's
        try:
            nbytes, flops = cost()
        finally:
            self._paused = False
        self.devices.add("cuda")
        self._charge(name, float(flops), float(nbytes))

    def __enter__(self):
        _build.COST_SINKS.append(self._on_launch)
        return super().__enter__()

    def __exit__(self, *exc):
        _build.COST_SINKS.remove(self._on_launch)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _DTENSOR is not None and any(issubclass(t, _DTENSOR)
                                        for t in types):
            # let DTensor turn the op into local ops and collectives,
            # which come back here
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._paused:
            return out
        name = func.overloadpacket.__name__
        ins = [a for a in tree_flatten((args, kwargs))[0]
               if isinstance(a, torch.Tensor)]
        outs = [o for o in tree_flatten(out)[0]
                if isinstance(o, torch.Tensor)]
        if any(isinstance(t, _FAKE) for t in ins + outs):
            return out   # DTensor's shape propagation, not the rank's work
        self.devices.update(t.device.type for t in ins + outs)
        if name in COLLECTIVES:
            self.collectives[COLLECTIVES[name]] += sum(
                _nbytes(o) for o in outs)
        if name in FREE_OPS or _is_view(func):
            return out
        flops = 0.0
        if name in MATMUL_OPS:
            res = outs[0].numel() if outs else 1
            flops = 2.0 * res * _contracted(name, args)
        if name in GATHER_OPS:
            nbytes = 2 * sum(_nbytes(o) for o in outs)
        elif name in SCATTER_OPS:
            upd = ins[-1] if len(ins) > 1 else ins[0]
            idx = sum(_nbytes(t) for t in ins[1:-1])
            nbytes = 2 * _nbytes(upd) + idx
        else:
            seen, nbytes = set(), 0
            for t in ins + outs:          # an aliased output counts once
                key = (t.data_ptr(), t.shape, t.dtype) \
                    if t.device.type != "meta" else id(t)
                if key not in seen:
                    seen.add(key)
                    nbytes += _nbytes(t)
        self._charge(name, flops, float(nbytes))
        return out


def count(fn, *args, **kwargs) -> OpCounter:
    """Run ``fn(*args, **kwargs)`` once under a fresh :class:`OpCounter`
    and return the counter."""
    counter = OpCounter()
    with counter:
        fn(*args, **kwargs)
    return counter
