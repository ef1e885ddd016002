"""qwen1.5-110b — dense GQA kv=8, QKV bias [hf:Qwen/Qwen1.5-0.5B]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", family="dense", n_layers=80, d_model=8192, n_heads=64,
    n_kv=8, d_ff=49152, vocab=152064, qkv_bias=True,
)
