"""Plain PyTorch versions of the blocked matmul.

``matmul_ref`` is the counterpart of ``repro.kernels.matmul.ref.matmul_ref``:
the product accumulated in fp32 and cast to ``out_dtype`` (the inputs' dtype
by default).  The CPU tests run it, the CUDA kernels are held against it on
the card, and ``ops.tuned_matmul`` sends the shapes no tile fits to it, as
the reference sends them to ``jnp.dot``.

``split_tf32`` and the two ``matmul_split_*`` functions emulate the fp32
kernel's three TF32 passes: the split pass is held against ``split_tf32``
bit for bit, and the tests show with them why three passes keep fp32's
accuracy where one does not.
"""
from __future__ import annotations

import torch

_TF32_HALF = 1 << 12     # half a unit in TF32's last place, in fp32 bits
_TF32_MASK = -(1 << 13)  # clears the 13 mantissa bits TF32 drops


def matmul_ref(a: torch.Tensor, b: torch.Tensor, out_dtype=None) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N), in fp32, cast to ``out_dtype``."""
    return torch.matmul(a.float(), b.float()).to(out_dtype or a.dtype)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32's 10 mantissa bits, to nearest with ties
    away from zero (``cvt.rna.tf32.f32``), as fp32 with the low 13 bits 0."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + _TF32_HALF) & _TF32_MASK).view(torch.float32)


def split_tf32(x: torch.Tensor) -> tuple:
    """(hi, lo) = (tf32(x), tf32(x - hi)), both contiguous fp32: hi + lo
    is x to about 2^-22 of |x|."""
    x = x.float().contiguous()
    hi = tf32_round(x)
    return hi, tf32_round(x - hi)


def matmul_split_parts_ref(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor) -> torch.Tensor:
    """``a @ b`` from b's parts (each (N, K), ``split_tf32(b.mT)``), as the
    kernel sums it: a_lo b_hi + a_hi b_lo + a_hi b_hi, each product exact
    in fp32 and summed in fp32; the a_lo b_lo term is dropped."""
    a_hi, a_lo = split_tf32(a)
    return a_lo @ b_hi.mT + a_hi @ b_lo.mT + a_hi @ b_hi.mT


def matmul_split_tf32_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in fp32 by three TF32 passes (``matmul_split_parts_ref``)."""
    return matmul_split_parts_ref(a, *split_tf32(b.mT))
