"""2D transpose (the padded tiled transpose of the JAX package): generator,
CUDA kernels, entry point."""
