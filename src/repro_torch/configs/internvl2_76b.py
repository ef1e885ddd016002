"""internvl2-76b — VLM: InternViT frontend (stub patch embeddings) +
InternLM2-style dense backbone [arXiv:2404.16821]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-76b", family="vlm", n_layers=80, d_model=8192, n_heads=64,
    n_kv=8, d_ff=28672, vocab=128256, frontend="vision", frontend_dim=1024,
    frontend_tokens=1024,
)
