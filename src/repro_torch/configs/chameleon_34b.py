"""chameleon-34b: early-fusion VLM, VQ image tokens share the vocab; the
patch/VQ frontend is stubbed (token ids arrive precomputed).
[arXiv:2405.09818; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=22016, vocab=65536,
)
