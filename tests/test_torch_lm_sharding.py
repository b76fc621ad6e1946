"""The LM's multi-device layer against the reference
(``src/repro/train/sharding.py``, ``train/steps.py`` under a mesh):

* spec parity: ``param_specs`` (both styles), ``batch_specs``,
  ``cache_specs`` (train and decode shapes, a KV head count that does not
  divide TP), ``opt_specs`` and ``monitor_specs`` equal the reference's
  exactly for all ten archs on 16x16, 2x16x16 and 4x2 meshes (the
  reference's on a device-free ``AbstractMesh``);
* on 8 gloo ranks (a 4x2 mesh, one spawn shared by the module): every
  rank's local shard of every leaf of five archs equals the shard the
  reference (8 forced host devices, in a subprocess) puts on the device at
  the same mesh coordinate, the model-major two-axis leaves included; the
  loss within 2e-3 of the reference's one-device loss and, with
  ``seq_parallel`` and ``"gather"`` too, loss and grad norm within 1e-4
  of the port's one device; ``donate=False`` leaves its inputs bitwise
  unchanged;
* on 4 gloo ranks (2x2, one spawn): prefill plus 4 decode steps within
  1e-4 of one device with heads over TP and with a sequence-sharded
  cache; a sharded ``Trainer`` resumes a reference checkpoint and its own
  checkpoint restores into the reference's ``Trainer``; the launcher runs
  ``--data-par 2 --model-par 2 --device cpu``.

Reduced configs (d 64, 2 layers), float32 compute.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.checkpoint.ckpt import Checkpointer as RCheckpointer
from repro.data.tokens import TokenStream as RTokenStream
from repro.launch.mesh import make_local_mesh as r_local_mesh
from repro.models import layers as RL
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro.train import loop as RLOOP
from repro.train import monitor as RMON
from repro.train import sharding as RSH
from repro.train import steps as RST
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import sharding as SH
from repro_torch.train import steps as ST
from tests.torch_mesh_ranks import (LOSS_KW, LOSS_SHAPE, PLACED_ARCHS,
                                    SERVE_B, SERVE_KV, SERVE_PROMPT, STYLES,
                                    TRAINER_STEPS, VARIANTS, loss_cfg,
                                    placed_cfg, serve, serve_cfg, serve_rank,
                                    spawn_ranks, train_rank)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
MESHES = (((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((4, 2), ("data", "model")))

def ref_loss_cfg():
    return RC.reduced(RC.get_arch("qwen3-8b"), **LOSS_KW)


def ref_flat(tree, is_spec=False):
    leaf = (lambda x: isinstance(x, jax.sharding.PartitionSpec)) \
        if is_spec else None
    return {tuple(str(getattr(k, "key", k)) for k in path): v for path, v in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=leaf)[0]}


def port_flat(tree):
    return dict(TT.tree_leaves(tree))


def specs_equal(port, ref):
    got = {k: tuple(v) for k, v in port_flat(port).items()}
    want = {k: tuple(v) for k, v in ref_flat(ref, True).items()}
    assert got == want


# --------------------------------------------------------------------------
# spec parity
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def abstract():
    """Per arch: the reference's and the port's abstract parameters."""
    return {a: (RST.abstract_params(RC.get_arch(a)),
                TT.abstract_params(TC.get_arch(a))) for a in RC.ARCHS}


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_param_and_opt_specs_equal_reference(mesh, abstract):
    am = jax.sharding.AbstractMesh(*mesh)
    pm = SH.MeshShape(mesh[1], mesh[0])
    for arch, (rshapes, tshapes) in sorted(abstract.items()):
        for style in STYLES + ("fsdp",):   # any other style: contraction
            ref = RSH.param_specs(RC.get_arch(arch), rshapes, am, style=style)
            got = SH.param_specs(TC.get_arch(arch), tshapes, pm, style=style)
            specs_equal(got, ref)
            specs_equal(SH.opt_specs(got), RSH.opt_specs(ref))
    # the model-major two-axis leaf prints as the reference's
    grok = SH.param_specs(TC.get_arch("grok-1-314b"),
                          abstract["grok-1-314b"][1],
                          SH.MeshShape(("data", "model"), (16, 16)),
                          style="gather")
    assert repr(grok["layers"]["moe"]["w_gate"]) == \
        "PartitionSpec(None, None, None, ('model', 'data'))"


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    map(str, m[0])))
def test_batch_cache_and_monitor_specs_equal_reference(mesh):
    am = jax.sharding.AbstractMesh(*mesh)
    pm = SH.MeshShape(mesh[1], mesh[0])
    for arch in sorted(RC.ARCHS):
        r, t = RC.get_arch(arch), TC.get_arch(arch)
        for shape in RC.SHAPES:
            B, S = shape.global_batch, shape.seq_len
            rf = RSH.batch_specs(r, shape.kind, B, am)
            tf = SH.batch_specs(t, shape.kind, B, pm)
            for name in ("tokens", "labels", "loss_mask", "embeds",
                         "enc_in", "token"):
                assert tuple(tf(name)) == tuple(rf(name)), (arch, name)
            if shape.kind == "train":
                continue
            rc = jax.eval_shape(lambda: RM.init_cache(r, B, S))
            tc = TT.init_cache(t, B, S, device="meta")
            specs_equal(SH.cache_specs(t, B, pm, tc),
                        RSH.cache_specs(r, B, am, rc))
        # a KV head count that does not divide TP: the sequence over TP
        r3 = RC.reduced(r, n_kv_heads=3) if r.n_kv_heads else r
        t3 = TC.reduced(t, n_kv_heads=3) if t.n_kv_heads else t
        rc = jax.eval_shape(lambda: RM.init_cache(r3, 32, 4096))
        specs_equal(SH.cache_specs(t3, 32, pm, TT.init_cache(
            t3, 32, 4096, device="meta")), RSH.cache_specs(r3, 32, am, rc))
    specs_equal(MON.monitor_specs(), RMON.monitor_specs())


def test_seq_sharded_cache_is_the_fallback():
    pm = SH.MeshShape(("data", "model"), (4, 2))
    t = TC.reduced(TC.get_arch("qwen3-8b"), n_kv_heads=1)
    spec = SH.cache_specs(t, 8, pm, TT.init_cache(t, 8, 32, device="meta"))
    assert tuple(spec["attn"]["k"]) == (None, "data", "model", None, None)


def test_two_axes_on_one_dimension_are_model_major():
    """("model", "data") on a ("data", "model") mesh: the data mesh dim
    splits dimension 1 strided by the model axis's size, so the model
    axis is major as in JAX (the gloo test checks the layout itself)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.placement_types import _StridedShard
    pm = SH.MeshShape(("data", "model"), (4, 2))
    assert SH.placements(pm, SH.Spec(None, ("model", "data"))) == (
        _StridedShard(1, split_factor=2), Shard(1))
    assert SH.placements(pm, SH.Spec(("data", "model"), None)) == (
        Shard(0), Shard(0))
    assert SH.placements(pm, SH.Spec(None, "model")) == (Replicate(),
                                                          Shard(1))


# --------------------------------------------------------------------------
# the 4x2 run: placements, losses, the un-donated step
# --------------------------------------------------------------------------

REFERENCE_SHARDS = """
import pickle, sys
import jax, numpy as np
from jax.sharding import NamedSharding
from repro import configs as RC
from repro.launch.mesh import make_local_mesh
from repro.train import sharding as RSH
placed = pickle.load(open(sys.argv[1], "rb"))
mesh = make_local_mesh(4, 2)
coord = {d.id: (i, j) for (i, j), d in np.ndenumerate(mesh.devices)}
out = {}
for arch, tree in placed.items():
    cfg = RC.reduced(RC.get_arch(arch))
    for style in ("contraction", "gather"):
        specs = RSH.param_specs(cfg, tree, mesh, style=style)
        arrs = jax.device_put(tree, jax.tree.map(
            lambda s: NamedSharding(mesh, s), specs,
            is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec)))
        for path, a in jax.tree_util.tree_flatten_with_path(arrs)[0]:
            name = "/".join(str(k.key) for k in path)
            for sh in a.addressable_shards:
                out[arch, style, name, coord[sh.device.id]] = \\
                    np.asarray(sh.data)
pickle.dump(out, open(sys.argv[2], "wb"))
"""


@pytest.fixture(scope="module")
def mesh42(tmp_path_factory):
    """One 8-rank gloo run; meanwhile the reference's shards on 8 forced
    host devices in a subprocess.  Returns (inputs, ranks, reference
    shards)."""
    import pickle
    tmp = str(tmp_path_factory.mktemp("mesh42"))
    placed = {a: jax.tree.map(np.asarray, RM.init_params(
        jax.random.PRNGKey(i), RC.reduced(RC.get_arch(a))))
        for i, a in enumerate(PLACED_ARCHS)}
    r = ref_loss_cfg()
    rng = np.random.default_rng(1)
    inputs = {"placed": placed,
              "loss_params": jax.tree.map(np.asarray, RM.init_params(
                  jax.random.PRNGKey(0), r)),
              "batch": {k: rng.integers(0, 256, (8, 64)).astype(np.int32)
                        for k in ("tokens", "labels")}}
    with open(os.path.join(tmp, "placed.pkl"), "wb") as f:
        pickle.dump(placed, f)
    env = dict(os.environ, PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE_SHARDS,
         os.path.join(tmp, "placed.pkl"), os.path.join(tmp, "ref.pkl")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        ranks = spawn_ranks(train_rank, 8, tmp, inputs)
    finally:
        _, err = ref.communicate(timeout=240)
    assert ref.returncode == 0, err[-3000:]
    with open(os.path.join(tmp, "ref.pkl"), "rb") as f:
        return inputs, ranks, pickle.load(f)


def test_every_local_shard_equals_the_reference_shard(mesh42):
    _, ranks, ref = mesh42
    assert sorted(r["coord"] for r in ranks) == sorted(
        (i, j) for i in range(4) for j in range(2))
    for got in ranks:
        assert len(got["shards"]) == len(PLACED_ARCHS) * len(STYLES)
        for (arch, style), shards in got["shards"].items():
            for name, local in shards.items():
                np.testing.assert_array_equal(
                    local, ref[arch, style, name, got["coord"]],
                    err_msg=f"{arch} {style} {name} at {got['coord']}")
    # the gather style's model-major two-axis leaves were among them
    specs = SH.param_specs(placed_cfg("qwen3-8b"), TT.abstract_params(
        placed_cfg("qwen3-8b")), SH.MeshShape(("data", "model"), (4, 2)),
        style="gather")
    assert tuple(specs["layers"]["mlp"]["w_gate"])[-1] == ("model", "data")
    assert tuple(specs["lm_head"])[-1] == ("model", "data")


def test_sharded_loss_equals_one_device_and_reference(mesh42):
    """The counterpart of the reference's
    ``test_train_step_agrees_with_single_device``."""
    inputs, ranks, _ = mesh42
    r, t = ref_loss_cfg(), loss_cfg()
    RL.set_compute_dtype(jnp.float32)
    try:
        ref_loss, _ = jax.jit(lambda p, b: RM.lm_loss(p, r, b))(
            inputs["loss_params"], inputs["batch"])
    finally:
        RL.set_compute_dtype(jnp.bfloat16)
    TL.set_compute_dtype(torch.float32)
    try:
        step = ST.build_train_step(t, LOSS_SHAPE, device="cpu", donate=False)
        lm = convert.lm_params_from_numpy(t, inputs["loss_params"],
                                          device="cpu")
        _, _, m, _ = step(lm, adamw.init_state(lm), {
            k: torch.as_tensor(v) for k, v in inputs["batch"].items()})
    finally:
        TL.set_compute_dtype(torch.bfloat16)
    one = (float(m["loss"]), float(m["grad_norm"]))
    assert abs(one[0] - float(ref_loss)) < 2e-3
    for got in ranks:
        assert abs(got["loss"]["contraction"][0] - float(ref_loss)) < 2e-3
        for name in VARIANTS:
            loss, gnorm = got["loss"][name]
            assert abs(loss - one[0]) <= 1e-4, (name, loss, one)
            assert abs(gnorm - one[1]) <= 1e-4 * max(1.0, one[1]), (
                name, gnorm, one)


def test_undonated_step_leaves_its_inputs_unchanged(mesh42):
    _, ranks, _ = mesh42
    assert all(got["unchanged"] for got in ranks)


# --------------------------------------------------------------------------
# the 2x2 run: serving, trainer checkpoints, the launcher
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh22(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("mesh22"))
    r = ref_loss_cfg()
    params = jax.jit(lambda k: RM.init_params(k, r))(jax.random.PRNGKey(3))
    RCheckpointer(os.path.join(tmp, "ckpt")).save(
        0, {"params": params, "opt": radamw.init_state(params)},
        blocking=True)
    rng = np.random.default_rng(2)
    stream = RTokenStream(vocab=r.vocab, seq_len=64, global_batch=8, seed=1)
    inputs = {"prompt": rng.integers(0, 256, (SERVE_B, SERVE_PROMPT)).astype(
        np.int32), "ckpt_dir": os.path.join(tmp, "ckpt"),
        "batches": [stream.host_batch(i) for i in range(TRAINER_STEPS)]}
    return tmp, inputs, spawn_ranks(serve_rank, 4, tmp, inputs)


def test_sharded_decode_equals_one_device(mesh22):
    _, inputs, ranks = mesh22
    TL.set_compute_dtype(torch.float32)
    try:
        for name, kv in SERVE_KV.items():
            cfg = serve_cfg(kv)
            want, _ = serve(cfg, TM.init_params(cfg, seed=0, device="cpu"),
                             torch.as_tensor(inputs["prompt"]), None)
            for got in ranks:
                logits, placed = got["serve"][name]
                scale = float(np.abs(want).max())
                assert np.abs(logits - want).max() <= 1e-4 * max(1.0, scale)
            # (data, model): the batch over data, the heads (axis 3) or
            # the sequence (axis 2) over model
            assert ranks[0]["serve"][name][1] == [
                ("Shard", 1), ("Shard", 3 if name == "heads" else 2)]
    finally:
        TL.set_compute_dtype(torch.bfloat16)


def test_sharded_trainer_checkpoints_cross_to_the_reference(mesh22):
    """A sharded Trainer resumed the reference's step-0 checkpoint (into
    DTensor templates) and its step-4 checkpoint restores into the
    reference's Trainer."""
    tmp, inputs, ranks = mesh22
    r = ref_loss_cfg()
    assert all(got["trainer"]["start"] == 0 for got in ranks)
    rtr = RLOOP.Trainer(
        r, LOSS_SHAPE, r_local_mesh(1, 1),
        RTokenStream(vocab=r.vocab, seq_len=64, global_batch=8, seed=1),
        RLOOP.LoopConfig(total_steps=8, ckpt_every=4, log_every=4,
                         ckpt_dir=inputs["ckpt_dir"], kv_chunk=32),
        radamw.AdamWConfig(lr=5e-3, total_steps=8, warmup_steps=4))
    params, _, _, start = rtr.init_or_restore()
    assert start == 4
    got = ref_flat(params)
    for name, v in ranks[0]["trainer"]["params"].items():
        np.testing.assert_array_equal(np.asarray(got[tuple(
            name.split("/"))]), v, err_msg=name)
    for other in ranks[1:]:
        for name, v in other["trainer"]["params"].items():
            np.testing.assert_array_equal(
                v, ranks[0]["trainer"]["params"][name])


def test_launcher_runs_on_spawned_ranks(mesh22):
    tmp, _, _ = mesh22
    with open(os.path.join(tmp, "launch", "LATEST")) as f:
        assert f.read() == "step_000000002"
