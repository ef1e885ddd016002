"""Weighted 2D 5-point Jacobi sweep: generator, CUDA kernels, entry point."""
