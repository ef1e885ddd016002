"""qwen1.5-32b — dense GQA kv=40, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-32b", family="dense", n_layers=64, d_model=5120, n_heads=40,
    n_kv=40, d_ff=27392, vocab=152064, qkv_bias=True,
)
