"""The port's own rules: no JAX, no reference imports, no silent CPU runs.

* no module under ``src/repro_torch/`` (nor ``chip_smoke.py``) imports
  ``jax`` or anything of ``repro``;
* every entry point called without ``device=`` raises when no GPU is
  visible instead of running on the CPU;
* the kernel wrappers never run a CPU tensor through a CUDA launch path;
* the configuration refuses what the port does not have;
* ``chip_smoke.py`` fails, printing no result, without a GPU and when it
  stands alone in a directory.
"""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import qo as tqo
from repro_torch.core import serve as tsv
from repro_torch.kernels import (qo_query, qo_query_batched, qo_route,
                                 qo_update, qo_update_leaves, sketch_compact)

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
CFG = tfr.ForestConfig(tree=tht.HTRConfig(n_features=3, max_nodes=15,
                                          n_bins=16, max_depth=3),
                       n_trees=2)


def _imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: {name}"


def test_every_port_module_is_scanned():
    names = {p.stem for p in PORT.rglob("*.py")}
    assert {"stats", "decide", "hoeffding", "forest", "serve", "ops",
            "qo_route", "qo_update_leaves", "qo_query_batched", "_build",
            "synth", "convert", "qo", "sketch", "qo_update", "qo_query",
            "sketch_compact"} <= names
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "qo_route.cu", "qo_update_leaves.cu", "qo_query_batched.cu",
        "sketch_compact.cu", "qo_update.cu", "qo_query.cu"}


@pytest.fixture
def no_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_entry_points_without_device_raise_without_gpu(no_gpu):
    X = np.zeros((4, 3), np.float32)
    y = np.zeros(4, np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tht.init_state(CFG.tree)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfr.init_forest(CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tqo.init(16, 0.1)
    tree = tht.init_state(CFG.tree, device="cpu")
    table = tqo.init(16, 0.1, device="cpu")
    state = tfr.init_forest(CFG, device="cpu")
    snap = tsv.freeze(state, device="cpu")
    calls = [lambda: tht.update(CFG.tree, tree, X, y),
             lambda: tht.predict(CFG.tree, tree, X),
             lambda: tfr.update(CFG, state, X, y),
             lambda: tfr.predict(CFG, state, X),
             lambda: tsv.freeze(state),
             lambda: tsv.predict_snapshot(snap, X),
             lambda: tqo.update(table, y, y),
             lambda: tqo.best_split(table)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            call()


def test_state_on_another_device_is_refused():
    state = tfr.init_forest(CFG, device="cpu")
    with pytest.raises(ValueError, match="lives on cpu"):
        tfr.update(CFG, state, np.zeros((4, 3), np.float32),
                   np.zeros(4, np.float32), device="meta")


def test_kernel_wrappers_refuse_cpu_tensors():
    """The ``*_kernel`` launchers take CUDA tensors only: a CPU tensor is
    refused before any build or launch."""
    z = torch.zeros(4, dtype=torch.int32)
    X = torch.zeros((2, 3))
    with pytest.raises(ValueError, match="qo_route"):
        qo_route.route_kernel(z, torch.zeros(4), z, z, X, 1, 4, 1)
    tab = {k: torch.zeros((4, 3, 8)) for k in ("n", "mean", "m2")}
    with pytest.raises(ValueError, match="qo_update_leaves"):
        qo_update_leaves.absorb_kernel(tab, torch.zeros((4, 3, 8)),
                                       torch.ones((4, 3)),
                                       torch.zeros((4, 3)),
                                       torch.zeros(2, dtype=torch.int32), X,
                                       torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError, match="qo_query_batched"):
        qo_query_batched.best_splits_kernel(tab, torch.zeros((4, 3, 8)), z)
    planes = [torch.zeros((4, 8)) for _ in range(4)]
    with pytest.raises(ValueError, match="sketch_compact"):
        sketch_compact.bucket_reduce_kernel(
            *planes, torch.zeros((4, 8), dtype=torch.int32), 4)
    one = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ValueError, match="qo_update"):
        qo_update.update_kernel(*one, torch.tensor(1.0), torch.tensor(0.0),
                                torch.zeros(2), torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError, match="qo_query"):
        qo_query.best_kernel(*one)


def test_config_refuses_what_is_not_ported():
    sketch = tht.HTRConfig(n_features=3, observer_backend="sketch")
    assert sketch.observer_bins() == sketch.sketch_k
    with pytest.raises(ValueError, match="no oracle engine"):
        tht.HTRConfig(n_features=3, observer_backend="sketch",
                      split_backend="oracle")
    with pytest.raises(NotImplementedError, match="ROADMAP A13"):
        tht.HTRConfig(n_features=3, split_backend="oracle")
    for backend in ("jnp", "pallas", "interpret", "cuda"):
        with pytest.raises(ValueError, match="auto"):
            tht.HTRConfig(n_features=3, split_backend=backend)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu_and_alone(tmp_path):
    for cwd in (ROOT, tmp_path):
        if cwd == tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        proc = _run_smoke(cwd)
        assert proc.returncode != 0, proc.stdout
        assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
