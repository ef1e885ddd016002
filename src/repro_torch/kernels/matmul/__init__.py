"""Blocked matmul (the estimator-tuned Pallas matmul of the JAX package):
the tensor-core CUDA GEMM, its pinned tiles and entry point."""
