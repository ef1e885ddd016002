"""The range-r 3D star stencil (arXiv:2204.14242 §5.2), plain PyTorch.

out[z,y,x] = w[0]·u[z,y,x] + Σ_axis Σ_{o=1..r} (w[k]·u[..-o..] + w[k+1]·u[..+o..]),
weights ordered [centre, (z,-1), (z,+1), ..., (z,-r), (z,+r), the y taps,
the x taps]; every point outside the domain reads 0.
"""
from __future__ import annotations

import torch

BLOCK_PLANES = 64   # output z planes a block


def uniform_weights(r: int, dtype, device) -> torch.Tensor:
    """The uniform average over the star's 6r+1 points."""
    n = 6 * r + 1
    return torch.full((n,), 1.0 / n, dtype=dtype, device=device)


def _block(up: torch.Tensor, w: torch.Tensor, r: int, z0: int, z1: int) -> torch.Tensor:
    """Output planes z0..z1 from the zero-padded field ``up``."""
    _zp, yp, xp = up.shape
    Y, X = yp - 2 * r, xp - 2 * r

    def tap(dz, dy, dx):
        return up[r + z0 + dz:r + z1 + dz, r + dy:r + dy + Y, r + dx:r + dx + X]

    out = w[0] * tap(0, 0, 0)
    k = 1
    for axis in range(3):
        for o in range(1, r + 1):
            for s in (-o, o):
                d = [0, 0, 0]
                d[axis] = s
                out = out + w[k] * tap(*d)
                k += 1
    return out


def step(u: torch.Tensor, weights: torch.Tensor, r: int, dtype=None) -> torch.Tensor:
    """One stencil step of the (Z, Y, X) field ``u``, computed in ``dtype``
    (``u``'s own by default) and returned in ``u``'s dtype."""
    dtype = dtype or u.dtype
    w = weights.to(dtype)
    out = torch.empty_like(u)
    Z = u.shape[0]
    for z0 in range(0, Z, BLOCK_PLANES):
        z1 = min(Z, z0 + BLOCK_PLANES)
        lo, hi = max(0, z0 - r), min(Z, z1 + r)
        part = u[lo:hi].to(dtype)
        # zero halo: r planes in z where the block meets the domain's edge
        up = torch.nn.functional.pad(part, (r, r, r, r, r - (z0 - lo), r - (hi - z1)))
        out[z0:z1] = _block(up, w, r, 0, z1 - z0).to(u.dtype)
    return out
