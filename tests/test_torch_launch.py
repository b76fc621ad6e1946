"""The port's ``launch/`` layer: the op-count walker (``hlocost``), the
dry-run and the perf variants (the reference's ``launch/hlocost.py``,
``dryrun.py`` and ``perf.py``), and, on the card (marked ``cuda``; skips
without a GPU; ``python3 tools_torch/card_tests.py`` runs it where JAX is
missing), the sharded train step over a one-rank NCCL mesh.

* the walker, the counterparts of ``tests/test_multi_hlocost.py:54-100``:
  5 looped 64^3 products count 5*2*64^3 flops, nested loops multiply, a
  plain product counts 2*128*256*64 flops and at least its operands and
  result in bytes; an all-gather over 2 gloo ranks counts its result's
  bytes;
* ``python -m repro_torch.launch.dryrun --arch phi3-mini-3.8b --shape
  decode_32k`` gives status ok and 256 chips (the counterpart of
  ``tests/test_sharding.py:116``); ``model_flops`` equals the reference's
  for every arch and shape; one ``launch.perf`` variant runs.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch import configs as TC
from repro_torch.launch import dryrun, hlocost, perf

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")


# --------------------------------------------------------------------------
# the walker
# --------------------------------------------------------------------------

def test_walker_counts_loop_trip_counts():
    def f(x, w):
        for wi in w:
            x = torch.tanh(x @ wi)
        return x

    r = hlocost.analyze(f, torch.randn(64, 64), torch.randn(5, 64, 64))
    assert r["flops"] == 5 * 2 * 64 ** 3
    assert r["collectives"] == {} and r["collective_bytes"] == 0


def test_walker_nested_loops_multiply():
    def g(x, w):
        for wi in w:
            for _ in range(3):
                x = torch.tanh(x @ wi)
        return x

    r = hlocost.analyze(g, torch.randn(32, 32), torch.randn(4, 32, 32))
    assert r["flops"] == 4 * 3 * 2 * 32 ** 3


def test_walker_plain_matmul():
    r = hlocost.analyze(lambda a, b: a @ b, torch.randn(128, 256),
                        torch.randn(256, 64))
    assert r["flops"] == 2 * 128 * 256 * 64
    # traffic at least the operands + result once
    assert r["bytes"] >= (128 * 256 + 256 * 64 + 128 * 64) * 4


def test_walker_counts_an_all_gather(tmp_path):
    from tests.torch_mesh_ranks import all_gather_rank, spawn_ranks
    ranks = spawn_ranks(all_gather_rank, 2, str(tmp_path), None)
    for got in ranks:
        assert got["walked"]["collectives"] == {"all-gather": 8 * 16 * 4}
        assert got["walked"]["collective_bytes"] == 8 * 16 * 4
        assert torch.equal(got["whole"], torch.arange(2.0).repeat_interleave(
            4)[:, None].expand(8, 16))


# --------------------------------------------------------------------------
# the dry-run and the perf variants
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """The dry-run's CLI on one cell and one perf variant, each a
    subprocess of its own (the fake process group must be its process's
    first), run at once."""
    tmp = tmp_path_factory.mktemp("cli")
    env = dict(os.environ, PYTHONPATH=SRC)
    runs = {
        "dryrun": (["-m", "repro_torch.launch.dryrun", "--arch",
                    "phi3-mini-3.8b", "--shape", "decode_32k"],
                   tmp / "dryrun.json"),
        "perf": (["-m", "repro_torch.launch.perf", "--cell",
                  "whisper-medium:train_4k", "--variant", "weight_gather"],
                 tmp / "perf.json")}
    procs = {k: subprocess.Popen([sys.executable, *args, "--out", str(out)],
                                 env=env, stdout=subprocess.PIPE,
                                 stderr=subprocess.PIPE, text=True)
             for k, (args, out) in runs.items()}
    results = {}
    for k, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=600)
        assert proc.returncode == 0, stderr[-3000:]
        with open(runs[k][1]) as f:
            results[k] = (json.load(f), stdout)
    return results


def test_dryrun_entrypoint_single_cell(cli_runs):
    res, stdout = cli_runs["dryrun"]
    assert res[0]["status"] == "ok"
    assert res[0]["chips"] == 256
    assert res[0]["hlo_flops_per_chip"] > 0
    assert res[0]["memory_analysis"]["temp_size_bytes"] is None
    assert res[0]["t_collective_s"] > 0 and "lower bound" in stdout
    assert set(res[0]["collective_breakdown"]) <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}


def test_dryrun_uses_the_h100_data_sheet():
    assert (dryrun.PEAK_FLOPS, dryrun.HBM_BW, dryrun.LINK_BW) == (
        989e12, 3.35e12, 450e9)


def test_perf_variant_runs(cli_runs):
    (res,), _ = cli_runs["perf"]
    assert res["variant"] == "weight_gather"
    assert res["overrides"] == {"sharding_style": "gather"}
    assert res["t_compute_s"] > 0 and res["t_memory_s"] > 0
    assert res["dominant"] in ("compute", "memory", "collective")
    assert len(perf.VARIANTS) == 25


def test_model_flops_equal_reference():
    # the reference's dryrun sets XLA_FLAGS for 512 host devices when
    # imported: keep this process's environment as it was
    before = os.environ.get("XLA_FLAGS")
    try:
        from repro import configs as RC
        from repro.launch import dryrun as rdryrun
    finally:
        if before is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = before
    for arch in sorted(RC.ARCHS):
        for shape in RC.SHAPES:
            t_cfg, t_shape = TC.get_arch(arch), TC.get_shape(shape.name)
            assert dryrun.model_flops(t_cfg, t_shape) == \
                rdryrun.model_flops(RC.get_arch(arch), shape), (arch, shape)
            assert dryrun.should_skip(t_cfg, t_shape) == \
                rdryrun.should_skip(RC.get_arch(arch), shape)


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a one-rank NCCL mesh")


@pytest.mark.cuda
class TestOnCard:
    def test_sharded_step_on_a_one_rank_nccl_mesh(self, card, tmp_path):
        """A reduced qwen3-8b, bf16: two steps through a 1 x 1 NCCL mesh
        equal the unsharded steps (1e-4), the monitor's ``qo_update``
        twice a step."""
        import datetime
        import torch.distributed as dist
        from repro_torch.configs import ShapeConfig
        from repro_torch.data.tokens import TokenStream
        from repro_torch.kernels import _build
        from repro_torch.launch.mesh import make_local_mesh
        from repro_torch.models import model as M
        from repro_torch.optim import adamw
        from repro_torch.train import monitor as MON
        from repro_torch.train import steps as ST

        cfg = TC.reduced(TC.get_arch("qwen3-8b"), d_model=256, n_heads=8,
                         n_kv_heads=4, head_dim=32, d_ff=512)
        shape = ShapeConfig("card", 128, 4, "train")
        data = TokenStream(cfg.vocab, 128, 4, seed=0, device="cuda")

        def run(mesh):
            step = ST.build_train_step(cfg, shape, mesh=mesh)
            lm = M.init_params(cfg, seed=0, mesh=mesh)
            opt, mon = adamw.init_state(lm), MON.init_monitor()
            _build.reset_launches()
            out = []
            for i in range(2):
                lm, opt, met, mon = step(lm, opt, data.batch(i), mon)
                out.append((float(met["loss"]), float(met["grad_norm"])))
            return out, _build.LAUNCHES["qo_update"]

        want, _ = run(None)
        dist.init_process_group(
            "nccl", store=dist.FileStore(str(tmp_path / "store"), 1),
            rank=0, world_size=1, timeout=datetime.timedelta(seconds=120))
        try:
            got, launches = run(make_local_mesh(1, 1))
        finally:
            dist.destroy_process_group()
        for g, w in zip(got, want):
            assert abs(g[0] - w[0]) <= 1e-4 * max(1.0, abs(w[0]))
            assert abs(g[1] - w[1]) <= 1e-4 * max(1.0, abs(w[1]))
        assert launches == 4

    def test_make_local_mesh_starts_a_one_rank_group(self, card):
        import torch.distributed as dist
        from repro_torch.launch.mesh import make_local_mesh
        try:
            mesh = make_local_mesh(2, 2)
            assert mesh.device_type == "cuda"
            assert tuple(mesh.shape) == (1, 1)
            assert mesh.mesh_dim_names == ("data", "model")
        finally:
            if dist.is_initialized():
                dist.destroy_process_group()
