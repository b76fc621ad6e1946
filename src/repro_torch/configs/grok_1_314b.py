"""grok-1-314b: MoE 8e top-2, GQA kv=8. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072, n_experts=8, top_k=2,
)
