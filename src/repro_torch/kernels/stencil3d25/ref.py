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


def star_stencil_zsum_ref(src_padded: torch.Tensor, weights, r: int) -> torch.Tensor:
    """``star_stencil_ref`` summed in the order of the z-march kernel, which
    keeps the z taps as partial sums in registers: (z,-r), ..., (z,-1),
    centre, the y taps, the x taps (in ``star_stencil_ref``'s order), then
    (z,+1), ..., (z,+r).  The kernel differs from it only by FMA
    contraction."""
    zp, yp, xp = src_padded.shape
    Z, Y, X = zp - 2 * r, yp - 2 * r, xp - 2 * r

    def sl(dz, dy, dx):
        return src_padded[
            r + dz : r + dz + Z, r + dy : r + dy + Y, r + dx : r + dx + X
        ]

    out = weights[2 * r - 1] * sl(-r, 0, 0)
    for o in range(r - 1, 0, -1):
        out = out + weights[2 * o - 1] * sl(-o, 0, 0)
    out = out + weights[0] * sl(0, 0, 0)
    for axis in (1, 2):
        for o in range(1, r + 1):
            for k, s in ((2 * axis * r + 2 * o - 1, -o), (2 * axis * r + 2 * o, o)):
                d = [0, 0, 0]
                d[axis] = s
                out = out + weights[k] * sl(*d)
    for o in range(1, r + 1):
        out = out + weights[2 * o] * sl(o, 0, 0)
    return out


def one_hot_points(domain: tuple, r: int) -> list:
    """Padded positions of a 1 whose whole star of 6r+1 outputs lies in
    ``domain``: the centre, and the point r inside each of the six faces."""
    mid = tuple(r + n // 2 for n in domain)
    pts = [mid]
    for axis, n in enumerate(domain):
        for v in (2 * r, n - 1):
            p = list(mid)
            p[axis] = v
            pts.append(tuple(p))
    return pts


def one_hot_stencil(domain: tuple, r: int, weights, points) -> torch.Tensor:
    """The stencil of a zero field with a 1 at each of ``points`` (padded
    positions whose stars do not overlap): each output of a star holds
    exactly the weight of the tap that reaches the 1, every other output 0."""
    out = torch.zeros(domain, dtype=weights.dtype, device=weights.device)
    for p in points:
        c0 = [v - r for v in p]
        out[tuple(c0)] = weights[0]
        k = 1
        for axis in range(3):
            for o in range(1, r + 1):
                for s in (-o, o):
                    c = list(c0)
                    c[axis] -= s  # the output whose tap s reads the 1
                    out[tuple(c)] = weights[k]
                    k += 1
    return out


def pad_input(src: torch.Tensor, r: int) -> torch.Tensor:
    """Zero halo of width r on every side of a (Z, Y, X) field."""
    return torch.nn.functional.pad(src, (r, r, r, r, r, r))
