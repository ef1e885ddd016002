"""Layer library of the port (``repro.layers``): norms, MLPs, MoE, RoPE,
GQA attention with its KV cache, the SSM blocks (Mamba2, RWKV6) and the
GEMM shapes of the layers.  It imports nothing itself: the suite imports
``layers.shapes`` on the pricing daemon's path, which loads no torch."""
