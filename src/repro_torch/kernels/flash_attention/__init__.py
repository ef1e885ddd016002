"""Causal GQA flash attention and flash decode (the Pallas kernels of the
JAX package): the CUDA kernels, their pinned tiles and entry point."""
