"""The LM scaffolding on the card (marked ``cuda``; skips without a GPU;
``python3 tools_torch/card_tests.py`` runs it where JAX is missing):

* every reduced architecture in float32 (TF32 off) on the card against
  the host with the same parameters and batch: loss, every gradient,
  prefill logits and three decode steps within 1e-4 of their largest;
* the ``Trainer`` killed by SIGTERM after step 4 and resumed, against an
  uninterrupted run under ``torch.use_deterministic_algorithms``:
  bitwise, or within the reference's own 2e-4
  (``tests/test_system.py:59``) where an op warned that it has no
  deterministic CUDA path;
* one bf16 train step of a reduced model launches ``qo_update`` twice
  (loss and gradient norm) and the monitor equals a host copy.
"""
import signal
import warnings

import numpy as np
import pytest
import torch

from repro_torch import configs, convert
from repro_torch.configs import ShapeConfig
from repro_torch.data.tokens import TokenStream
from repro_torch.kernels import _build
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_leaves
from repro_torch.optim import adamw
from repro_torch.train import monitor as MON
from repro_torch.train import steps as ST
from repro_torch.train.loop import LoopConfig, Trainer

TOL = 1e-4


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the card's half of the comparison")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    L.set_compute_dtype(torch.bfloat16)


def _gap(a, b):
    a, b = a.detach().double().cpu(), b.detach().double().cpu()
    return float((a - b).abs().max() / max(float(b.abs().max()), 1e-30))


def _run(lm, cfg, batch, where):
    tb = {k: torch.as_tensor(v, device=where) for k, v in batch.items()}
    loss, _ = M.lm_loss(lm, cfg, tb, kv_chunk=16, loss_chunk=16)
    loss.backward()
    cache = M.init_cache(cfg, 2, 40, device=where)
    prompt = {k: v for k, v in tb.items() if k != "labels"}
    cache, lg = M.prefill(lm, cfg, prompt, cache, kv_chunk=16)
    logits = [lg]
    tok = lg.argmax(-1)
    for i in range(3):
        lg, cache = M.decode_step(lm, cfg, tok, cache, 32 + i, kv_chunk=16)
        logits.append(lg)
    return loss, logits, [p.grad for p in lm.parameters()
                          if p.grad is not None]


@pytest.mark.cuda
class TestOnCard:
    @pytest.mark.parametrize("arch", sorted(configs.ARCHS))
    def test_reduced_arch_card_equals_host(self, card, arch):
        L.set_compute_dtype(torch.float32)
        cfg = configs.reduced(configs.get_arch(arch))
        host = M.init_params(cfg, seed=0, device="cpu")
        dev = convert.lm_params_from_numpy(
            cfg, convert.lm_params_to_numpy(host), device=card)
        rng = np.random.default_rng(0)
        batch = {"tokens": rng.integers(0, cfg.vocab, (2, 32)),
                 "labels": rng.integers(0, cfg.vocab, (2, 32))}
        if cfg.family == "encdec":
            batch["enc_in"] = rng.standard_normal(
                (2, cfg.enc_seq, cfg.d_model), dtype=np.float32)
        l0, lg0, g0 = _run(host, cfg, batch, "cpu")
        l1, lg1, g1 = _run(dev, cfg, batch, card)
        assert _gap(l1, l0) <= TOL
        for a, b in zip(lg1, lg0):
            assert _gap(a, b) <= TOL
        for a, b in zip(g1, g0):
            if float(b.abs().max()):
                assert _gap(a, b) <= TOL

    def test_trainer_resume_on_card(self, card, tmp_path):
        cfg = configs.reduced(configs.get_arch("qwen3-8b"), vocab=128)
        shape = ShapeConfig("t", 64, 4, "train")
        data = TokenStream(cfg.vocab, 64, 4, seed=1, device="cuda")
        opt = adamw.AdamWConfig(lr=5e-3, warmup_steps=2, total_steps=8)

        def trainer(d, log_every=4):
            return Trainer(cfg, shape, data, LoopConfig(
                total_steps=8, ckpt_every=4, log_every=log_every,
                ckpt_dir=str(d), kv_chunk=32), opt, device=card)

        def kill(rec):
            if rec.get("step") == 3 and "loss" in rec:
                signal.raise_signal(signal.SIGTERM)

        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                p_full, o_full, _, _ = trainer(tmp_path / "a").run(
                    log_fn=lambda r: None)
                trainer(tmp_path / "b", log_every=1).run(log_fn=kill)
                resumed = trainer(tmp_path / "b")
                assert resumed.ckpt.latest_step() == 4
                p_res, o_res, _, _ = resumed.run(log_fn=lambda r: None)
        finally:
            torch.use_deterministic_algorithms(False)
        nondet = [str(w.message) for w in caught
                  if "deterministic" in str(w.message)]
        for a, b in ((p_full.tree(), p_res.tree()), (o_full, o_res)):
            for (path, x), (_, y) in zip(tree_leaves(a), tree_leaves(b)):
                if nondet:
                    np.testing.assert_allclose(
                        x.cpu().numpy(), y.cpu().numpy(), rtol=2e-4,
                        atol=2e-4, err_msg="/".join(path))
                else:
                    assert torch.equal(x, y), "/".join(path)

    def test_train_step_observes_through_the_kernel(self, card):
        cfg = configs.reduced(configs.get_arch("qwen3-8b"))
        L.set_compute_dtype(torch.bfloat16)
        step = ST.build_train_step(cfg, ShapeConfig("t", 32, 2, "train"),
                                   device=card)
        lm = M.init_params(cfg, seed=0, device=card)
        opt = adamw.init_state(lm)
        mon = MON.init_monitor(device=card)
        host = MON.init_monitor(device="cpu")
        batch = TokenStream(cfg.vocab, 32, 2, device="cuda").batch(0)
        _build.reset_launches()
        lm, opt, met, mon = step(lm, opt, batch, mon)
        torch.cuda.synchronize()
        assert _build.LAUNCHES["qo_update"] == 2
        host = MON.observe(host, loss=met["loss"].cpu(),
                           grad_norm=met["grad_norm"].cpu())
        for name, tab in host.items():
            y = {k: v.cpu() for k, v in mon[name]["y"].items()}
            assert torch.equal(y["n"], tab["y"]["n"])
            # m2 scaled by the bin's sum of squares, as chip_smoke.py does
            scale = tab["y"]["n"] * tab["y"]["mean"] ** 2 + tab["y"]["m2"]
            assert bool(((y["m2"] - tab["y"]["m2"]).abs()
                         <= 1e-6 * scale).all())
            assert float((y["mean"] - tab["y"]["mean"]).abs().max()) <= \
                1e-6 * float(tab["y"]["mean"].abs().max())
