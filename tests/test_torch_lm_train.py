"""The port's LM training path against the reference: AdamW and its
schedule (1e-6), one ``build_train_step`` step and a microbatched one
(loss, grad norm, parameters within 1e-4, the monitor's counts equal), the
NaN-step skip, the serve steps, the token stream, the fault-tolerant
``Trainer`` (``tests/test_system.py`` on the port: the loss falls, resume
is bitwise on the CPU, the monitor collects, a preemption saves, publish
fires at each save) and trainer checkpoints crossing both ways.

Reduced phi3 (d 64, 2 layers, vocab 128, S 64, B 4) as in
``tests/test_system.py``; float32 compute on both sides.
"""
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.checkpoint.ckpt import Checkpointer as RCheckpointer
from repro.configs import ShapeConfig
from repro.data.tokens import TokenStream as RTokenStream
from repro.launch.mesh import make_local_mesh
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro.train import loop as RLOOP
from repro.train import monitor as RMON
from repro.train import steps as RST
from repro_torch import configs as TC
from repro_torch import convert
from repro_torch.checkpoint.ckpt import Checkpointer
from repro_torch.data.tokens import TokenStream
from repro_torch.models import layers as TL
from repro_torch.models import model as TM
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import steps as ST
from repro_torch.train.loop import (LoopConfig, PublicationOverwritten,
                                    Trainer)

SMALL = dict(d_model=64, n_layers=2, n_heads=4, n_kv_heads=4, d_ff=128,
             vocab=128, head_dim=16)
SHAPE = ShapeConfig("t", 64, 4, "train")


@pytest.fixture(autouse=True)
def f32_compute():
    TL.set_compute_dtype(torch.float32)
    yield
    TL.set_compute_dtype(torch.bfloat16)


def cfgs(arch="phi3-mini-3.8b", **over):
    kw = dict(SMALL, **over)
    return (RC.reduced(RC.get_arch(arch), **kw),
            TC.reduced(TC.get_arch(arch), **kw))


def flat(tree):
    return {"/".join(str(k.key) for k in path): np.asarray(v) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def flat_port(tree):
    """Copies: a CPU tensor's ``numpy()`` shares its memory, and the steps
    update in place."""
    return {"/".join(p): v.detach().cpu().numpy().copy()
            for p, v in TT.tree_leaves(TT.tree_of(tree))}


def assert_trees_close(port, ref, tol, what):
    port, ref = flat_port(port), flat(ref)
    assert set(port) == set(ref), what
    for k, r in ref.items():
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(port[k].astype(np.float64) - r).max())
        assert err <= tol * scale, f"{what} {k}: {err:.3g} > {tol} x {scale}"


def reference_state(r, seed=0):
    params = jax.jit(lambda k: RM.init_params(k, r))(jax.random.PRNGKey(seed))
    return params, radamw.init_state(params)


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def test_adamw_apply_and_schedule_equal_reference():
    r, t = cfgs("qwen3-8b")
    params, state = reference_state(r)
    opt = radamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    tparams = convert.lm_params_from_numpy(t, jax.tree.map(np.asarray, params),
                                           device="cpu")
    tstate = convert.lm_opt_state_from_numpy(jax.tree.map(np.asarray, state),
                                             device="cpu")
    topt = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=6)
    rng = np.random.default_rng(0)
    tp = tparams.tree()
    for i in range(3):
        g = jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
            np.float32) * (3.0 if i == 0 else 0.1), params)
        params, state, m = radamw.apply(opt, params, state, g)
        tg = TT.tree_map(torch.as_tensor, g)
        pure_p, pure_s, _ = adamw.apply(topt, tp, tstate, tg)
        tp, tstate, tm = adamw.apply(topt, tp, tstate, tg, inplace=True)
        assert_trees_close(tp, params, 1e-6, f"params {i}")
        assert_trees_close(tstate["m"], state["m"], 1e-6, f"m {i}")
        assert_trees_close(tstate["v"], state["v"], 1e-6, f"v {i}")
        assert int(tstate["step"]) == int(state["step"]) == i + 1
        for a, b in zip(TT.tree_leaves(pure_p), TT.tree_leaves(tp)):
            assert torch.equal(a[1], b[1])
        assert abs(float(tm["grad_norm"]) - float(m["grad_norm"])) <= \
            1e-6 * float(m["grad_norm"])
        assert abs(float(tm["lr"]) - float(m["lr"])) <= 1e-6 * float(m["lr"])
    for s in range(0, 9):
        assert abs(float(adamw.schedule(topt, s))
                   - float(radamw.schedule(opt, jnp.int32(s)))) <= 1e-6 * 1e-2


def test_adamw_keep_if_false_changes_nothing():
    _, t = cfgs()
    lm = TM.init_params(t, seed=0, device="cpu")
    state = adamw.init_state(lm)
    before = flat_port(lm)
    g = TT.tree_map(torch.ones_like, lm.tree())
    adamw.apply(adamw.AdamWConfig(), lm, state, g, inplace=True,
                keep_if=lambda n: torch.tensor(False))
    assert all(np.array_equal(before[k], v) for k, v in flat_port(lm).items())
    assert int(state["step"]) == 0
    assert all(float(v.abs().sum()) == 0 for _, v in TT.tree_leaves(state["m"]))


# --------------------------------------------------------------------------
# the train and serve steps
# --------------------------------------------------------------------------

def _reference_step(r, microbatch):
    mesh = make_local_mesh(1, 1)
    fn, _, _, _ = RST.build_train_step(r, SHAPE, mesh, radamw.AdamWConfig(
        lr=5e-3, warmup_steps=1), microbatch=microbatch, kv_chunk=32,
        donate=False)

    def step(*args):
        with mesh:
            return fn(*args)
    return step


@pytest.mark.parametrize("microbatch", [0, 2])
def test_train_step_equals_reference(microbatch):
    r, t = cfgs()
    params, state = reference_state(r)
    batch = RTokenStream(vocab=r.vocab, seq_len=64, global_batch=4,
                         seed=1).host_batch(0)
    lm = convert.lm_params_from_numpy(t, jax.tree.map(np.asarray, params),
                                      device="cpu")
    tstate = convert.lm_opt_state_from_numpy(jax.tree.map(np.asarray, state),
                                             device="cpu")
    step = ST.build_train_step(t, SHAPE, adamw.AdamWConfig(
        lr=5e-3, warmup_steps=1), microbatch=microbatch, kv_chunk=32,
        device="cpu")
    mon = MON.init_monitor(device="cpu")
    rfn = _reference_step(r, microbatch)
    rmon = RMON.init_monitor()
    for i in range(2):
        params, state, rm, rmon = rfn(params, state, batch, rmon)
        lm, tstate, tm, mon = step(lm, tstate, {k: torch.as_tensor(v) for k, v
                                                in batch.items()}, mon)
        for key in ("loss", "grad_norm", "xent", "aux", "lr", "skipped"):
            assert abs(float(tm[key]) - float(rm[key])) <= 1e-4 * max(
                abs(float(rm[key])), 1e-3), key
        assert_trees_close(lm, params, 1e-4, f"params after step {i}")
    assert_trees_close(tstate["m"], state["m"], 1e-4, "m")
    for name in ("loss", "grad_norm"):
        assert float(MON.summaries(mon)[name]["count"]) == \
            float(RMON.summaries(rmon)[name]["count"]) == 2


def test_nan_step_is_skipped():
    """A poisoned step leaves parameters and AdamW state bitwise as they
    were, decided on the device (``tests/test_system.py:73``)."""
    _, t = cfgs(d_model=32, n_layers=1, n_heads=2, n_kv_heads=2, d_ff=64,
                vocab=64)
    step = ST.build_train_step(t, ShapeConfig("t", 32, 2, "train"),
                               device="cpu")
    lm = TM.init_params(t, seed=0, device="cpu")
    with torch.no_grad():
        for _, p in TT.tree_leaves(lm.tree()):
            p.view(-1)[0] = float("nan")
    opt = adamw.init_state(lm)
    before = flat_port(lm)
    bad = {"tokens": torch.zeros((2, 32), dtype=torch.int32),
           "labels": torch.zeros((2, 32), dtype=torch.int32)}
    lm2, opt2, metrics, mon = step(lm, opt, bad, MON.init_monitor(
        device="cpu"))
    assert float(metrics["skipped"]) == 1.0
    after = flat_port(lm2)
    for k, v in before.items():
        np.testing.assert_array_equal(after[k], v)
    assert int(opt2["step"]) == 0
    assert float(MON.summaries(mon)["loss"]["count"]) == 1


def test_serve_steps_equal_model_calls():
    r, t = cfgs("qwen3-8b")
    lm = TM.init_params(t, seed=3, device="cpu")
    shape = ShapeConfig("s", 48, 2, "decode")
    prefill, decode, new_cache = ST.build_serve_steps(t, shape, kv_chunk=16,
                                                      device="cpu")
    toks = torch.as_tensor(np.random.default_rng(0).integers(
        0, t.vocab, (2, 32)))
    cache, logits = prefill(lm, {"tokens": toks}, new_cache())
    ref_cache, ref_logits = TM.prefill(lm, t, {"tokens": toks},
                                       TM.init_cache(t, 2, 48, device="cpu"),
                                       kv_chunk=16)
    assert torch.equal(logits, ref_logits)
    tok = logits.argmax(-1)
    l1, cache = decode(lm, tok, cache, 32)
    l2, _ = TM.decode_step(lm, t, tok, ref_cache, 32, kv_chunk=16)
    assert torch.equal(l1, l2)
    specs = ST.input_specs(t, shape)
    assert specs["token"].shape == (2,) and specs["token"].device.type == \
        "meta"
    p_meta, o_meta = ST.abstract_state(t)
    assert {p: tuple(v.shape) for p, v in TT.tree_leaves(p_meta)} == \
        {p: tuple(v.shape) for p, v in TT.tree_leaves(lm.tree())}
    assert o_meta["step"].dtype == torch.int32


def test_token_stream_is_stateless_by_index():
    ts = TokenStream(vocab=100, seq_len=16, global_batch=3, seed=5,
                     device="cpu")
    a, b = ts.batch(7), ts.batch(7)
    assert torch.equal(a["tokens"], b["tokens"])
    assert not torch.equal(ts.batch(8)["tokens"], a["tokens"])
    assert a["tokens"].shape == (3, 16) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 100
    hb = ts.host_batch(7)
    assert np.array_equal(hb["labels"], a["labels"].numpy())
    big = TokenStream(vocab=1000, seq_len=256, global_batch=8,
                      device="cpu").batch(0)["tokens"]
    # zipf-ish: the lowest ids carry most of the mass; markov: half the
    # tokens are the previous draw + 1, so about a quarter follow the
    # previous token (plus chance)
    counts = torch.bincount(big.reshape(-1), minlength=1000)
    assert int(counts[:8].sum()) > 0.5 * big.numel()
    follow = (big[:, 1:] == (big[:, :-1] + 1) % 1000).float().mean()
    assert 0.2 < float(follow) < 0.45


# --------------------------------------------------------------------------
# the fault-tolerant trainer (tests/test_system.py on the port)
# --------------------------------------------------------------------------

def make_trainer(tmp_path, steps=24, horizon=None, ckpt_every=8):
    _, t = cfgs()
    data = TokenStream(vocab=t.vocab, seq_len=64, global_batch=4, seed=1,
                       device="cpu")
    lc = LoopConfig(total_steps=steps, ckpt_every=ckpt_every, log_every=4,
                    ckpt_dir=str(tmp_path), kv_chunk=32)
    opt = adamw.AdamWConfig(lr=5e-3, total_steps=horizon or steps,
                            warmup_steps=4)
    return Trainer(t, SHAPE, data, lc, opt, device="cpu")


def test_training_reduces_loss(tmp_path):
    logs = []
    make_trainer(tmp_path, steps=24).run(log_fn=logs.append)
    losses = [r["loss"] for r in logs if "loss" in r]
    assert losses[-1] < losses[0] - 0.1, losses
    assert all(r.get("skipped", 0) == 0 for r in logs if "loss" in r)


def test_resume_from_checkpoint_is_bitwise(tmp_path):
    p_full, o_full, _, _ = make_trainer(tmp_path / "full", steps=16).run(
        log_fn=lambda r: None)
    make_trainer(tmp_path / "split", steps=8, horizon=16).run(
        log_fn=lambda r: None)
    tr = make_trainer(tmp_path / "split", steps=16)
    assert tr.ckpt.latest_step() == 8
    p_split, o_split, _, _ = tr.run(log_fn=lambda r: None)
    for a, b in ((p_full, p_split), (o_full, o_split)):
        fa, fb = flat_port(a), flat_port(b)
        assert set(fa) == set(fb)
        for k in fa:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg=k)


def test_monitor_collects_during_training(tmp_path):
    _, _, mon, _ = make_trainer(tmp_path, steps=8).run(log_fn=lambda r: None)
    s = MON.summaries(mon)
    assert float(s["loss"]["count"]) == 8
    assert float(s["grad_norm"]["count"]) == 8
    assert float(s["step_time"]["count"]) == 8
    assert float(s["loss"]["p50"]) > 0


def test_preemption_makes_a_final_save(tmp_path):
    published = []
    tr = make_trainer(tmp_path, steps=24, ckpt_every=100)

    def log_fn(rec):
        if rec.get("step") == 4 and "loss" in rec:
            signal.raise_signal(signal.SIGTERM)
    before = signal.getsignal(signal.SIGTERM)
    _, _, _, hist = tr.run(log_fn=log_fn,
                           publish_fn=lambda s, p: published.append(s))
    assert hist[-1]["step"] == 4
    assert tr.ckpt.latest_step() == 5 and published == [5]
    assert signal.getsignal(signal.SIGTERM) is before


def test_publish_fn_fires_at_each_save(tmp_path):
    published = []
    tr = make_trainer(tmp_path, steps=12, ckpt_every=4)
    tr.run(log_fn=lambda r: None,
           publish_fn=lambda s, p: published.append(
               (s, float(p.tree()["final_norm"].detach().sum()))))
    assert [s for s, _ in published] == [4, 8, 12, 12]
    assert tr.ckpt.available_steps() == [4, 8, 12]


def test_monitor_is_observed_without_with_monitor():
    """ROADMAP C17: a monitor passed to a step built with
    ``with_monitor=False`` is observed, as in the reference (where the
    flag only sets the monitor's shardings): the same tables as the
    reference's step on the same inputs."""
    r, t = cfgs()
    params, state = reference_state(r)
    batch = RTokenStream(vocab=r.vocab, seq_len=64, global_batch=4,
                         seed=1).host_batch(0)
    lm = convert.lm_params_from_numpy(t, jax.tree.map(np.asarray, params),
                                      device="cpu")
    tstate = convert.lm_opt_state_from_numpy(jax.tree.map(np.asarray, state),
                                             device="cpu")
    step = ST.build_train_step(t, SHAPE, adamw.AdamWConfig(
        lr=5e-3, warmup_steps=1), kv_chunk=32, with_monitor=False,
        device="cpu")
    _, _, _, mon = step(lm, tstate, {k: torch.as_tensor(v) for k, v in
                                     batch.items()},
                        MON.init_monitor(device="cpu"))
    _, _, _, rmon = _reference_step(r, 0)(params, state, batch,
                                          RMON.init_monitor())
    got, ref = flat_port(mon), flat(rmon)
    assert set(got) == set(ref)
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    assert float(MON.summaries(mon)["loss"]["count"]) == 1


class ReferenceBatches:
    """The reference's token stream as the port's Trainer reads it."""

    def __init__(self, stream):
        self.stream = stream

    def batch(self, step):
        return {k: torch.as_tensor(v)
                for k, v in self.stream.host_batch(step).items()}


def _start_from_reference(r, directory):
    """Write the reference's initial parameters and AdamW state as a
    step-0 checkpoint into ``directory``; return them."""
    params, state = reference_state(r)
    RCheckpointer(str(directory)).save(0, {"params": params, "opt": state},
                                       blocking=True)
    return params, state


def _trainer_from_reference(r, t, directory, steps):
    _start_from_reference(r, directory)
    data = ReferenceBatches(RTokenStream(vocab=r.vocab, seq_len=64,
                                         global_batch=4, seed=1))
    lc = LoopConfig(total_steps=steps, ckpt_every=4, log_every=4,
                    ckpt_dir=str(directory), kv_chunk=32)
    return Trainer(t, SHAPE, data, lc, adamw.AdamWConfig(
        lr=5e-3, total_steps=8, warmup_steps=4), device="cpu")


def test_held_publication_raises_after_a_later_step(tmp_path):
    """ROADMAP C16: the step-4 publication, held past step 8, raises on
    read (naming C16 and the step that overwrote it) instead of reading
    the later weights; the final publication stays readable."""
    held = {}
    tr = make_trainer(tmp_path, steps=8, ckpt_every=4)
    tr.run(log_fn=lambda r: None,
           publish_fn=lambda s, p: held.setdefault(s, p))
    assert sorted(held) == [4, 8]
    for read in (lambda p: p.tree(), lambda p: p.copy()):
        with pytest.raises(PublicationOverwritten,
                           match="C16.*step 4.*train step 5"):
            read(held[4])
    assert torch.isfinite(held[8].tree()["final_norm"]).all()


def test_copied_publication_keeps_its_weights(tmp_path):
    """ROADMAP C16: a consumer that copies at step 4 keeps the step-4
    weights: bitwise equal to a rerun stopped at step 4, and within 1e-4
    of the reference's parameters at step 4 on the same batches."""
    r, t = cfgs()
    kept = {}
    _trainer_from_reference(r, t, tmp_path / "long", 8).run(
        log_fn=lambda rec: None,
        publish_fn=lambda s, p: kept.setdefault(s, p.copy()))
    stopped, _, _, _ = _trainer_from_reference(
        r, t, tmp_path / "short", 4).run(log_fn=lambda rec: None)
    got, again = flat_port(kept[4]), flat_port(stopped)
    assert set(got) == set(again)
    for k in got:
        np.testing.assert_array_equal(got[k], again[k], err_msg=k)
    rtr = RLOOP.Trainer(
        r, SHAPE, make_local_mesh(1, 1),
        RTokenStream(vocab=r.vocab, seq_len=64, global_batch=4, seed=1),
        RLOOP.LoopConfig(total_steps=4, ckpt_every=4, log_every=4,
                         ckpt_dir=str(tmp_path / "ref"), kv_chunk=32),
        radamw.AdamWConfig(lr=5e-3, total_steps=8, warmup_steps=4))
    _start_from_reference(r, tmp_path / "ref")
    rparams, _, _, _ = rtr.run(log_fn=lambda rec: None)
    assert_trees_close(kept[4], rparams, 1e-4, "step-4 copy")


# --------------------------------------------------------------------------
# trainer checkpoints cross both ways
# --------------------------------------------------------------------------

def test_reference_checkpoint_restores_into_port_trainer(tmp_path):
    r, _ = cfgs()
    rtr = RLOOP.Trainer(
        r, SHAPE, make_local_mesh(1, 1),
        RTokenStream(vocab=r.vocab, seq_len=64, global_batch=4, seed=1),
        RLOOP.LoopConfig(total_steps=4, ckpt_every=4, log_every=4,
                         ckpt_dir=str(tmp_path), kv_chunk=32),
        radamw.AdamWConfig(lr=5e-3, total_steps=8, warmup_steps=4))
    rparams, ropt, _, _ = rtr.run(log_fn=lambda rec: None)
    tr = make_trainer(tmp_path, steps=8)
    params, opt, _, start = tr.init_or_restore()
    assert start == 4
    assert_trees_close(params, rparams, 0.0, "params")
    assert_trees_close(opt["m"], ropt["m"], 0.0, "m")
    assert int(opt["step"]) == 4 and opt["step"].dtype == torch.int32
    _, _, _, hist = tr.run(log_fn=lambda rec: None)
    assert hist[0]["step"] == 4 and np.isfinite(hist[-1]["loss"])


def test_port_checkpoint_restores_into_reference(tmp_path):
    r, _ = cfgs()
    params, opt, _, _ = make_trainer(tmp_path, steps=4, ckpt_every=4).run(
        log_fn=lambda rec: None)
    pshapes, oshapes = RST.abstract_state(r, radamw.AdamWConfig())
    ck = RCheckpointer(str(tmp_path))
    assert ck.latest_step() == 4
    host = ck.restore(4, {"params": pshapes, "opt": oshapes})
    assert_trees_close(params, host["params"], 0.0, "params")
    assert_trees_close(opt["v"], host["opt"]["v"], 0.0, "v")
    assert int(host["opt"]["step"]) == 4
    # and the port's own Checkpointer reads it back with meta templates
    p_meta, o_meta = ST.abstract_state(TC.reduced(TC.get_arch(
        "phi3-mini-3.8b"), **SMALL))
    back = Checkpointer(str(tmp_path)).restore(4, {"params": p_meta,
                                                   "opt": o_meta})
    assert back["opt"]["step"].device.type == "cpu"
    assert_trees_close(back["params"], host["params"], 0.0, "params")
