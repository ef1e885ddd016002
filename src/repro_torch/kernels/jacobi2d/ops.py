"""Public entry point for the Jacobi sweep: the paper's fig.-1 loop.

``jacobi_step`` pads the field, asks the generator for the best launch
(ranked analytically on the H100, memoized) and runs the per-point CUDA
kernel there, unless ``config`` pins the decision.
"""
from __future__ import annotations

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels.jacobi2d.generator import best_config
from repro_torch.kernels.jacobi2d.kernel import jacobi_pointwise, jacobi_ytile, ytile_tile
from repro_torch.kernels.jacobi2d.ref import pad_input


def jacobi_step(src: torch.Tensor, weights=(0.5, 0.125),
                config: dict | None = None) -> torch.Tensor:
    """One weighted Jacobi sweep of a (Y, X) field (zero boundary) on
    ``src``'s device.

    ``config=None`` (or ``{"variant": "rowstream"}``) ranks every launch of
    the per-point kernel on the H100 and runs it at the best one.  A pinned
    config is ``{"block": (bx, by, bz), "folding": (fx, fy, fz)}`` for the
    per-point kernel, or ``{"variant": "ytile", "ty": ty}`` (ty divides Y,
    ty >= 2; 8 by default) for the shared-memory tile kernel.  The TPU's
    ``ytile`` needs its input padded in y up to (Y/ty + 1)·ty rows; the CUDA
    kernel masks its own tile edge, so here every variant takes the same
    halo-1 padding.
    """
    if src.dim() != 2:
        raise ValueError(f"expected a (Y, X) field, got {tuple(src.shape)}")
    domain = tuple(src.shape)
    config = config or {"variant": "rowstream"}
    variant = config.get("variant", "rowstream")
    if variant == "rowstream":
        if "block" in config:
            launch = LaunchConfig(block=tuple(config["block"]),
                                  folding=tuple(config.get("folding", (1, 1, 1))))
        else:
            launch = best_config(domain, src.element_size()).launch
    elif variant == "ytile":
        ty = config.get("ty") or 8
        if domain[0] % ty or ty < 2:
            raise ValueError("ty must divide Y and be >= 2")
        tile = ytile_tile(ty, src.element_size())
    else:
        raise ValueError(f"unknown variant {variant!r}")
    padded = pad_input(src.contiguous())
    if variant == "rowstream":
        return jacobi_pointwise(padded, launch, weights)
    return jacobi_ytile(padded, *tile, weights)
