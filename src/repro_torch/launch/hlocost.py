"""Trip-count-aware op cost of one call (the reference's
``launch/hlocost.py``).

The reference walks a compiled XLA module's HLO text and multiplies each
computation by the trip counts of the while loops around it, because
``cost_analysis`` counts a scan body once.  Eager PyTorch has no HLO:
:func:`analyze` runs the call once under
:class:`repro_torch.perf.opcost.OpCounter`, which counts every op as it
executes, so each loop contributes its real number of passes and nested
loops multiply with no walker.  The reference's keys:

* ``flops``: the matmul-class ops (``2 * prod(output) *
  prod(contracted)``, as the walker charges a ``dot``); elementwise flops
  are ignored, as there;
* ``bytes``: operands plus result of every op that moves data (the
  eager op is its own kernel, as a fusion is in XLA);
* ``collectives``: result bytes by kind (``all-gather``, ``all-reduce``,
  ``reduce-scatter``, ``all-to-all``) of the c10d functional collectives
  DTensor issues under a ``DeviceMesh``;
* ``collective_bytes``: their sum.

Under a mesh the counts are this rank's (the counter sees the local ops
DTensor runs).  On meta tensors nothing is computed or allocated, so the
dry-run counts production shapes on one host.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.perf import opcost

__all__ = ["analyze"]


def analyze(fn, *args, **kwargs) -> Dict[str, object]:
    """Run ``fn(*args, **kwargs)`` once and return its ``{flops, bytes,
    collectives, collective_bytes}``."""
    counter = opcost.count(fn, *args, **kwargs)
    coll = dict(counter.collectives)
    return {"flops": float(counter.flops), "bytes": float(counter.bytes),
            "collectives": coll,
            "collective_bytes": float(sum(coll.values()))}
