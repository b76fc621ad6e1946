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

from repro_torch.core import ebst as tebst
from repro_torch.core import engine as teng
from repro_torch.core import forest as tfr
from repro_torch.core import hoeffding as tht
from repro_torch.core import multi as tmulti
from repro_torch.core import qo as tqo
from repro_torch.core import serve as tsv
from repro_torch.kernels import _build
from repro_torch.kernels import (ebst, leaf_stats, qo_merge, qo_query,
                                 qo_query_batched, qo_route, qo_update,
                                 qo_update_leaves, sketch_compact)
from repro_torch import configs as tcfg
from repro_torch.data import tokens as ttokens
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as tlaunch
from repro_torch.models import model as tmodel
from repro_torch.train import loop as tloop
from repro_torch.train import sharding as tsh
from repro_torch.train import steps as tsteps

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
            "sketch_compact", "qo_merge", "sharding", "compress", "ckpt",
            "engine", "faults", "ebst", "multi", "monitor", "ref", "tune",
            "opcost", "profile", "base", "layers", "ssm", "transformer",
            "model", "adamw", "tokens", "steps", "loop", "train",
            "qwen3_8b", "grok_1_314b", "zamba2_2_7b",
            "whisper_medium", "mesh", "dryrun", "perf", "hlocost",
            "leaf_stats"} <= names
    assert {p.name for p in (PORT / "csrc").glob("*.cu")} == {
        "qo_route.cu", "qo_update_leaves.cu", "qo_query_batched.cu",
        "sketch_compact.cu", "qo_update.cu", "qo_query.cu", "qo_merge.cu",
        "leaf_stats.cu", "ebst.cu"}
    assert set(_build.SOURCES) == {p.stem for p in
                                   (PORT / "csrc").glob("*.cu")}


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
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.build_data_parallel_reference(CFG, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsh.init_data_parallel(CFG, 0, 2)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tebst.init(16)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmulti.init(16, 2, 0.1)
    bst = tebst.init(16, device="cpu")
    mt = tmulti.init(16, 2, 0.1, device="cpu")
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
             lambda: tqo.best_split(table),
             lambda: tebst.update(bst, y, y),
             lambda: tebst.best_split(bst),
             lambda: tmulti.update(mt, y, np.zeros((4, 2), np.float32)),
             lambda: tmulti.best_split(mt),
             lambda: teng.ServingEngine(CFG, state, lambda step: None)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            call()


def test_lm_entry_points_without_device_raise_without_gpu(no_gpu):
    cfg = tcfg.reduced(tcfg.get_arch("qwen3-8b"))
    shape = tcfg.ShapeConfig("t", 16, 2, "train")
    shape_only = tsh.MeshShape(("data", "model"), (1, 1))
    calls = [lambda: tmodel.init_params(cfg),
             lambda: tmodel.init_cache(cfg, 2, 16),
             lambda: tsteps.build_train_step(cfg, shape),
             lambda: tsteps.build_serve_steps(cfg, shape),
             lambda: tloop.Trainer(cfg, shape, None, tloop.LoopConfig()),
             lambda: ttokens.TokenStream(64, 16, 2).batch(0),
             lambda: tlaunch.main(["--reduced", "--steps", "1"]),
             lambda: tmesh.make_local_mesh(),
             lambda: tsteps.build_train_step(cfg, shape, mesh=shape_only),
             lambda: tsteps.build_serve_steps(cfg, shape, mesh=shape_only)]
    for call in calls:
        with pytest.raises(RuntimeError, match="no GPU is visible"):
            call()


def test_lm_sharding_options_are_accepted(tmp_path):
    """The LM sharding layer (mesh, seq_parallel, sharding_style, the
    un-donated step; the launcher's --mesh, --data-par, --model-par)
    builds: the calls that raised before ROADMAP A14b was ported, with a
    real ``DeviceMesh`` (a one-rank gloo group) in place of ``"pod"``.
    The production mesh wants 256 ranks and says so."""
    import datetime
    import torch.distributed as dist
    cfg = tcfg.reduced(tcfg.get_arch("qwen3-8b"))
    shape = tcfg.ShapeConfig("t", 16, 2, "train")
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        mesh = tmesh.make_local_mesh(4, 2, device="cpu")
        assert tuple(mesh.shape) == (1, 1)
        for kw in (dict(mesh=mesh), dict(seq_parallel=True),
                   dict(sharding_style="fsdp"), dict(donate=False)):
            assert callable(tsteps.build_train_step(cfg, shape, device="cpu",
                                                    **kw))
        prefill, decode, init_cache = tsteps.build_serve_steps(
            cfg, shape, device="cpu", mesh=mesh)
        assert init_cache()["attn"]["k"].device_mesh is mesh
        tr = tloop.Trainer(cfg, shape, None, tloop.LoopConfig(
            ckpt_dir=str(tmp_path / "trainer")), device="cpu", mesh=mesh)
        assert tr.mesh is mesh
        small = ["--reduced", "--device", "cpu", "--steps", "1",
                 "--d-model", "64", "--layers", "1", "--batch", "2",
                 "--seq", "16", "--ckpt-every", "1"]
        for i, argv in enumerate((["--data-par", "2"], ["--model-par", "2"])):
            tlaunch.main([*small, *argv, "--ckpt-dir",
                          str(tmp_path / f"launch{i}")])
            assert (tmp_path / f"launch{i}" / "LATEST").exists()
        with pytest.raises(RuntimeError, match="256|world size|bigger"):
            tlaunch.main([*small, "--mesh", "pod", "--ckpt-dir",
                          str(tmp_path / "pod")])
    finally:
        dist.destroy_process_group()


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
        qo_route.route_kernel(z[None], torch.zeros((1, 4)),
                              torch.full((1, 4, 2), -1, dtype=torch.int32),
                              torch.ones((1, 4), dtype=torch.bool), X, 1)
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
        sketch_compact.compact_kernel(planes, 4, planes)
    one = [torch.zeros(8) for _ in range(4)]
    with pytest.raises(ValueError, match="qo_update"):
        qo_update.update_kernel(*one, torch.tensor(1.0), torch.tensor(0.0),
                                torch.zeros(2), torch.zeros(2), torch.ones(2))
    with pytest.raises(ValueError, match="qo_query"):
        qo_query.best_kernel(*one)
    with pytest.raises(ValueError, match="qo_merge"):
        qo_merge.merge_kernel(*one, *one)
    with pytest.raises(ValueError, match="leaf_stats"):
        leaf_stats.leaf_stats_kernel(
            {k: torch.zeros(4) for k in ("n", "mean", "m2")}, torch.zeros(4),
            torch.zeros(2), torch.ones(2), (z[:2], z[:1].repeat(5)),
            torch.zeros(1, dtype=torch.bool))
    bst = tebst.init(8, device="cpu")
    with pytest.raises(ValueError, match="ebst_insert"):
        ebst.insert_kernel(bst, torch.zeros(2), torch.zeros(2))
    with pytest.raises(ValueError, match="ebst_query"):
        ebst.query_kernel(bst)


def test_qo_merge_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """``qo_merge.merge`` on CPU tensors never reaches the launcher."""
    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launch")
    monkeypatch.setattr(qo_merge, "merge_kernel", boom)
    monkeypatch.setattr(qo_merge, "_launcher", boom)
    before = dict(_build.LAUNCHES)
    planes = [torch.rand(3, 4) for _ in range(8)]
    out = qo_merge.merge(*planes)
    assert all(torch.equal(a, b) for a, b in
               zip(out, qo_merge.merge_plain(*planes)))
    assert _build.LAUNCHES == before


def test_leaf_stats_routes_cpu_tensors_to_the_plain_version(monkeypatch):
    """``leaf_stats.leaf_stats`` on CPU tensors never reaches the launcher
    and is the plain composition; a CPU forest step counts no kernel
    step under a profiler."""
    from repro_torch.perf import spans

    def boom(*a, **k):
        raise AssertionError("a CPU tensor reached the CUDA launch")
    monkeypatch.setattr(leaf_stats, "leaf_stats_kernel", boom)
    monkeypatch.setattr(leaf_stats, "_library", boom)
    before = dict(_build.LAUNCHES)
    gl = torch.tensor([3, 0, 3, 1, 4, 4], dtype=torch.int32)
    ystats = {k: torch.rand(6) for k in ("n", "mean", "m2")}
    args = (ystats, torch.zeros(6), gl, torch.rand(3), torch.rand(6),
            qo_update_leaves.sort_rows(gl, 6))
    bad = torch.ones(1, dtype=torch.bool)
    out = leaf_stats.leaf_stats(*args, bad)
    plain = leaf_stats.leaf_stats_plain(*args, torch.ones(1, dtype=bool))
    assert not bool(bad)
    assert all(torch.equal(out[0][k], plain[0][k]) for k in ystats)
    assert torch.equal(out[1], plain[1])
    spans.reset_counts()
    state = tfr.init_forest(CFG, device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        tfr.update(CFG, state, np.zeros((4, 3), np.float32),
                   np.zeros(4, np.float32), device="cpu")
    assert spans.counts()["forest.steps"] == 1
    assert "forest.leaf_stats" not in spans.counts()
    assert _build.LAUNCHES == before


def test_distributed_builder_raises_without_gpu(no_gpu, tmp_path):
    """``build_data_parallel_forest``, ``build_sharded_forest`` and
    ``build_sharded_serving`` without ``device=`` raise before they read
    the group (a one-rank gloo group here)."""
    import datetime
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1, timeout=datetime.timedelta(seconds=30))
    try:
        state = tfr.init_forest(CFG, device="cpu")
        snap = tsv.freeze(state, device="cpu")
        for build in (lambda **k: tsh.build_data_parallel_forest(CFG, **k),
                      lambda **k: tsh.build_sharded_forest(CFG, **k),
                      lambda **k: tsh.build_sharded_serving(snap, **k)):
            with pytest.raises(RuntimeError, match="no GPU is visible"):
                build()
        init, _, _, _ = tsh.build_data_parallel_forest(CFG, device="cpu")
        assert init(0)["delta"]["ao_sum_x"].shape[0] == 1
        sharded = tsh.build_sharded_forest(CFG, device="cpu")
        assert sharded.shard(state)["vote_w"].device.type == "cpu"
    finally:
        dist.destroy_process_group()


def test_config_refuses_what_is_not_ported():
    sketch = tht.HTRConfig(n_features=3, observer_backend="sketch")
    assert sketch.observer_bins() == sketch.sketch_k
    with pytest.raises(ValueError, match="no oracle engine"):
        tht.HTRConfig(n_features=3, observer_backend="sketch",
                      split_backend="oracle")
    oracle = tht.HTRConfig(n_features=3, split_backend="oracle")
    assert oracle.split_backend == "oracle"
    assert not tht.HTRConfig(n_features=3, compact_query=False).compact_query
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
