"""D3Q15 Allen-Cahn interface-tracking LBM (paper §5.3): generator, CUDA
kernels, entry point."""
