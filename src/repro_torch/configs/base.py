"""Architecture configuration schema + shape suite shared by all archs
(the reference's ``configs/base.py``, copied: the port imports nothing of
the JAX package)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "reduced"]


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    # attention extras
    qk_norm: bool = False
    swa_window: int = 0          # 0 -> full attention
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba)
    ssm_state: int = 0
    ssm_version: int = 1         # 1 = mamba1, 2 = mamba2 (scalar-A heads)
    ssm_expand: int = 2
    ssm_head_dim: int = 64       # mamba2 only
    # hybrid (zamba2-style): a weight-shared attention block applied every
    # `hybrid_period` ssm layers
    hybrid_period: int = 0
    # encoder-decoder (whisper-style)
    n_enc_layers: int = 0        # 0 -> decoder-only
    enc_seq: int = 0             # fixed encoder length (audio frames)
    # modality frontend stub: inputs are precomputed embeddings, not ids
    frontend_stub: bool = False
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run 500k-token contexts? (DESIGN.md §6)"""
        return self.family in ("ssm", "hybrid") or self.swa_window > 0

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    def n_params(self) -> int:
        """Approximate parameter count (embedding + blocks + head)."""
        d, f, L, V = self.d_model, self.d_ff, self.n_layers, self.vocab
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        att = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        if self.family == "ssm":
            di, N = self.d_inner, self.ssm_state
            blk = 2 * d * di + di * 4 + di * (2 * N + 2) + di * d  # in/conv/ssm/out
            att = 0
            mlp = 0
        else:
            mlp = 3 * d * f
            blk = att + mlp
        if self.is_moe:
            blk = att + self.n_experts * 3 * d * f + d * self.n_experts
        if self.family == "hybrid":
            di, N = self.d_inner, self.ssm_state
            blk = 2 * d * di + di * (2 * N + 2) + di * d
        emb = V * d * (1 if self.tie_embeddings else 2)
        enc = self.n_enc_layers * (att + mlp) if self.n_enc_layers else 0
        return L * blk + emb + enc

    def n_active_params(self) -> int:
        """Params touched per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd, H, Hkv = self.hd, self.n_heads, self.n_kv_heads
        att = d * H * hd + 2 * d * Hkv * hd + H * hd * d
        blk = att + self.top_k * 3 * d * f + d * self.n_experts
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return L * blk + emb


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4096, 256, "train"),
    ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    ShapeConfig("decode_32k", 32768, 128, "decode"),
    ShapeConfig("long_500k", 524288, 1, "decode"),
)


def reduced(cfg: ArchConfig, **over) -> ArchConfig:
    """Tiny same-family config for CPU smoke tests (per assignment)."""
    kw = dict(
        n_layers=min(cfg.n_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 4) if cfg.n_kv_heads else 0,
        d_ff=128,
        vocab=256,
        head_dim=16,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        top_k=min(cfg.top_k, 2) if cfg.top_k else 0,
        ssm_state=min(cfg.ssm_state, 8) if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_version == 2 else cfg.ssm_head_dim,
        swa_window=64 if cfg.swa_window else 0,
        hybrid_period=2 if cfg.hybrid_period else 0,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_seq=32 if cfg.enc_seq else 0,
    )
    kw.update(over)
    return replace(cfg, **kw)
