"""whisper-medium: enc-dec, conv frontend stubbed (precomputed frame
embeddings). [arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-medium", family="encdec",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16,
    d_ff=4096, vocab=51865,
    n_enc_layers=24, enc_seq=1500, frontend_stub=True,
)
