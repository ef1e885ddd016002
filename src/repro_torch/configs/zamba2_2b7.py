"""zamba2-2.7b — hybrid Mamba2 + weight-shared attention blocks
[arXiv:2411.15242].  54 mamba layers, shared attn+MLP every 6."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid", n_layers=54, d_model=2560, n_heads=32,
    n_kv=32, d_ff=10240, vocab=32000, block_pattern="mamba_hybrid",
    hybrid_attn_every=6, ssm_state=64, ssm_head_dim=64,
    swa_window=4096,  # shared-attn block uses SWA at long context (DESIGN §4)
)
