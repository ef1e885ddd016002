"""Plain PyTorch version of the 2D transpose.

The counterpart of the JAX package's padded tiled transpose
(``repro.kernels.transpose_pad``): ``xt[n, m] = x[m, n]``.  The CPU tests
run it, and the CUDA kernels are held against it on the card; nothing on
the card's main path calls it.  On the card it is PyTorch's own strided
copy kernel, so it is also the library call the kernels are timed against.
"""
from __future__ import annotations

import torch


def transpose_ref(x: torch.Tensor) -> torch.Tensor:
    """The (N, M) transpose of an (M, N) tensor, contiguous."""
    return x.mT.contiguous()
