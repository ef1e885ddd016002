"""rwkv6-1.6b — Finch: attention-free, data-dependent decay [arXiv:2404.05892]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm", n_layers=24, d_model=2048, n_heads=32,
    n_kv=32, d_ff=7168, vocab=65536, block_pattern="rwkv", ssm_head_dim=64,
    norm="layernorm", mlp="swiglu",
)
