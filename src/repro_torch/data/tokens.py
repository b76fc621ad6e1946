"""Deterministic synthetic token stream for LM training (the reference's
``data/tokens.py``).

Stateless by index: batch ``i`` is a pure function of (seed, i, device),
drawn on the device from a generator seeded from ``(seed, i)``, so a
restart after preemption resumes the stream exactly by skipping to the
checkpointed step.  The mix is the reference's: zipf-ish unigram draws,
and with probability 0.5 the next token is the previous one + 1 (mod V),
so a model can lower its loss on it.  The tokens are not the reference's
(threefry against torch's generators, and a CUDA generator's stream is
not the CPU's: ROADMAP C15); parity tests feed the reference's batches to
both packages.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch import device as dv

__all__ = ["TokenStream"]


@dataclass(frozen=True)
class TokenStream:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    device: Optional[str] = None    # None -> cuda

    def batch(self, step: int):
        """{tokens, labels} int32 (global_batch, seq_len) on the device."""
        dev = dv.resolve(self.device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(int(np.random.SeedSequence(
            [self.seed, int(step)]).generate_state(1, np.uint64)[0]) >> 1)
        B, S, V = self.global_batch, self.seq_len, self.vocab
        u = torch.rand((B, S + 1), generator=gen, device=dev) \
            * (1.0 - 1e-6) + 1e-6
        ranks = torch.floor(u ** -1.2 - 1.0).to(torch.int32)
        base = torch.clamp(ranks, 0, V - 1)
        coin = torch.rand((B, S + 1), generator=gen, device=dev) < 0.5
        rolled = torch.roll(base, 1, dims=1)
        toks = torch.where(coin, torch.remainder(rolled + 1, V), base)
        return {"tokens": toks[:, :-1].contiguous(),
                "labels": toks[:, 1:].contiguous()}

    def host_batch(self, step: int):
        return {k: v.cpu().numpy() for k, v in self.batch(step).items()}
