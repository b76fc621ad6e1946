"""PyTorch/CUDA port of the QO Hoeffding-tree forest (H100).

A second package beside the JAX reference (``src/repro``).  It runs the
forest's prequential step (:func:`repro_torch.core.forest.update`) under
the dense QO observer and the sketch observer, snapshot serving
(:mod:`repro_torch.core.serve`) and the paper's single-table QO observer
(:mod:`repro_torch.core.qo`), with hand-written CUDA kernels for routing,
the QO absorb, the split query, the sketch compaction and the
single-table absorb and query (:mod:`repro_torch.kernels`).  States are
plain dicts of tensors with the JAX package's key names, so
:mod:`repro_torch.convert` carries them across one to one.  Beside the
forest sits the reference's LM scaffolding on one device
(:mod:`repro_torch.models`, :mod:`repro_torch.optim.adamw`,
:mod:`repro_torch.train.steps`, :mod:`repro_torch.train.loop`), whose
training step folds its loss and gradient norm into QO tables.

The package imports ``torch`` and numpy only, never ``jax`` and nothing
of ``repro``.  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``, where every kernel wrapper runs its plain PyTorch
version instead.
"""
