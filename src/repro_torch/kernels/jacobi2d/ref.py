"""Plain PyTorch versions of the weighted 2D 5-point Jacobi sweep.

The counterpart of ``repro.kernels.jacobi2d.ops.jacobi_ref``:

    dst[y, x] = wc * src[y, x] + wn * (src[y-1, x] + src[y+1, x]
                                       + src[y, x-1] + src[y, x+1])

with a zero boundary.  The CPU tests run them, and the CUDA kernels are
held against them on the card; nothing on the card's main path calls them.
"""
from __future__ import annotations

import torch


def pad_input(src: torch.Tensor) -> torch.Tensor:
    """Zero halo of width 1 around a (Y, X) field."""
    return torch.nn.functional.pad(src, (1, 1, 1, 1))


def jacobi_padded_ref(src_padded: torch.Tensor, weights=(0.5, 0.125)) -> torch.Tensor:
    """One sweep on the halo-1 padded (Y+2, X+2) source; returns (Y, X).

    The neighbours are summed up, down, left, right, left to right, as the
    Pallas kernels sum them (``repro/kernels/jacobi2d/kernel.py``); the
    weights are Python scalars, rounded to the field's dtype before they
    multiply, as JAX's weak typing does.
    """
    wc, wn = (float(w) for w in weights)
    p = src_padded
    return wc * p[1:-1, 1:-1] + wn * (p[:-2, 1:-1] + p[2:, 1:-1] + p[1:-1, :-2] + p[1:-1, 2:])


def jacobi_ref(src: torch.Tensor, weights=(0.5, 0.125)) -> torch.Tensor:
    """One sweep on the unpadded (Y, X) source (zero boundary)."""
    return jacobi_padded_ref(pad_input(src), weights)
