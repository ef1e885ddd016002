"""Range-r 3D star stencil (paper §5.2): generator, CUDA kernels, entry point."""
