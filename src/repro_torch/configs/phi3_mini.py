"""phi3-mini-3.8b — dense, RoPE SwiGLU GQA kv=32 [arXiv:2404.14219]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3-mini-3.8b", family="dense", n_layers=32, d_model=3072, n_heads=32,
    n_kv=32, d_ff=8192, vocab=32064,
)
