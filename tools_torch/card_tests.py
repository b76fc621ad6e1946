#!/usr/bin/env python3
"""Run the ``TestOnCard`` classes of ``tests/test_torch_kernels.py``,
``tests/test_torch_ebst.py``, ``tests/test_torch_perf.py``,
``tests/test_torch_lm_card.py``, ``tests/test_torch_launch.py`` (the
sharded train step over a one-rank NCCL mesh),
``tests/test_torch_forest_many_trees.py`` and
``tests/test_torch_forest.py`` on a GPU machine without JAX: the
modules' JAX and reference imports (which only their CPU tests use) are
stubbed with empty modules.  ``CUBLAS_WORKSPACE_CONFIG`` is set for the
deterministic resume test before CUDA starts.

    python3 tools_torch/card_tests.py [pytest arguments]

Prints the card's name and power limit and each kernel's ptxas register
and spill lines, then runs the card tests (``--noconftest``: the
repository's conftest imports the JAX package).
"""
import os
import subprocess
import sys
import types

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

STUBS = ("jax", "jax.numpy", "repro", "repro.kernels", "repro.kernels.ops",
         "repro.core", "repro.core.ebst", "repro.core.forest",
         "repro.core.hoeffding", "repro.core.serve")
for name in STUBS:
    sys.modules[name] = types.ModuleType(name)
for name in STUBS:
    parent, _, child = name.rpartition(".")
    if parent:
        setattr(sys.modules[parent], child, sys.modules[name])
sys.path.insert(0, os.path.join(ROOT, "src"))
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                      "--format=csv,noheader"], capture_output=True,
                     text=True).stdout, flush=True)
from repro_torch.kernels import _build  # noqa: E402

for name, path in _build.build().items():
    log = path.with_suffix(".log")
    for line in log.read_text().splitlines() if log.exists() else []:
        if "registers" in line or "spill" in line or "error" in line:
            print(f"    {name}: {line.strip()}")
import pytest  # noqa: E402

sys.exit(pytest.main(["-q", "-p", "no:cacheprovider", "--noconftest",
                      "-p", "no:randomly", *sys.argv[1:],
                      *(os.path.join(ROOT, "tests", f) + "::TestOnCard"
                        for f in ("test_torch_kernels.py",
                                  "test_torch_ebst.py",
                                  "test_torch_perf.py",
                                  "test_torch_lm_card.py",
                                  "test_torch_launch.py",
                                  "test_torch_forest_many_trees.py",
                                  "test_torch_forest.py"))]))
