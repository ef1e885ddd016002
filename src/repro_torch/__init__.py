"""PyTorch + CUDA port of ``repro``: the paper's code-generation loop on an
NVIDIA H100.

The estimator path is copied from ``repro.core`` (numpy-only), and every
Pallas TPU kernel on a ported path is a CUDA kernel written by hand for
Hopper (``repro_torch/csrc``).  The package imports ``torch`` and ``numpy``,
never ``jax`` and nothing of ``repro``.
"""
