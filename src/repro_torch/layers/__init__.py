"""Layer library of the port (``repro.layers``): RoPE, GQA attention and
the GEMM shapes of the layers."""
