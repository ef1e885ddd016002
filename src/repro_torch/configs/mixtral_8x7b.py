"""mixtral-8x7b — MoE 8 experts top-2, sliding-window attention
[arXiv:2401.04088]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mixtral-8x7b", family="moe", n_layers=32, d_model=4096, n_heads=32,
    n_kv=8, d_ff=14336, vocab=32000, n_experts=8, top_k=2, swa_window=4096, seq_parallel=True,
)
