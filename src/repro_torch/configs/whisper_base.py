"""whisper-base — enc-dec audio; conv frontend stubbed to precomputed frame
embeddings (input_specs) [arXiv:2212.04356].  6 encoder + 6 decoder layers."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="audio", n_layers=6, d_model=512, n_heads=8,
    n_kv=8, d_ff=2048, vocab=51865, enc_layers=6, frontend="audio",
    frontend_dim=512, frontend_tokens=1500, norm="layernorm", mlp="gelu",
    rope_theta=10000.0,
)
