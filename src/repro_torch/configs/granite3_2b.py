"""granite-3-2b — dense GQA kv=8 [hf:ibm-granite/granite-3.0-2b-base]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="granite-3-2b", family="dense", n_layers=40, d_model=2048, n_heads=32,
    n_kv=8, d_ff=8192, vocab=49155,
)
