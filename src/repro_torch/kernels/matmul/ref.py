"""Plain PyTorch version of the blocked matmul.

The counterpart of ``repro.kernels.matmul.ref.matmul_ref``: the product
accumulated in fp32 and cast to ``out_dtype`` (the inputs' dtype by
default).  The CPU tests run it, the CUDA kernel is held against it on the
card, and ``ops.tuned_matmul`` sends the shapes no tile fits to it, as the
reference sends them to ``jnp.dot``.
"""
from __future__ import annotations

import torch


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N), in fp32, cast to ``out_dtype``."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)
