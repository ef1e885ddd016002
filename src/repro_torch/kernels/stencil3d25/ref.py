"""Plain PyTorch versions of the range-r 3D star stencil (paper §5.2).

The counterpart of ``repro.kernels.stencil3d25.ref``.  The CPU tests run
them, and the CUDA kernels are held against them on the card; nothing on
the card's main path calls them.
"""
from __future__ import annotations

import torch


def star_weights(r: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Default weights: uniform average over the 6r+1 points."""
    n = 6 * r + 1
    return torch.full((n,), 1.0 / n, dtype=dtype, device=device)


def star_stencil_ref(src_padded: torch.Tensor, weights, r: int) -> torch.Tensor:
    """dst[z,y,x] = w0*src[z,y,x] + sum_axis sum_o w[...] * src[..+-o..].

    ``src_padded`` has halo r on every side; weights ordered
    [center, (z,-1),(z,+1),...,(z,-r),(z,+r), (y,..), (x,..)].
    """
    zp, yp, xp = src_padded.shape
    Z, Y, X = zp - 2 * r, yp - 2 * r, xp - 2 * r

    def sl(dz, dy, dx):
        return src_padded[
            r + dz : r + dz + Z, r + dy : r + dy + Y, r + dx : r + dx + X
        ]

    out = weights[0] * sl(0, 0, 0)
    w = 1
    for axis in range(3):
        for o in range(1, r + 1):
            for s in (-o, o):
                d = [0, 0, 0]
                d[axis] = s
                out = out + weights[w] * sl(*d)
                w += 1
    return out


def pad_input(src: torch.Tensor, r: int) -> torch.Tensor:
    """Zero halo of width r on every side of a (Z, Y, X) field."""
    return torch.nn.functional.pad(src, (r, r, r, r, r, r))
