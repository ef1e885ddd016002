"""Public entry point for the star stencil: the paper's fig.-1 loop.

``star_stencil`` pads the field (``kernels.halo_pad``: one pass on the card,
``F.pad`` on the CPU), asks the generator for the best launch (ranked
analytically on the H100, memoized) and runs the per-point CUDA kernel
there, unless ``config`` pins the decision.

With ``obs`` on, a call records ``stencil.step`` (``variant`` in its args)
around ``stencil.pad`` (``halo_pad``) and ``stencil.launch`` (the kernel
wrapper, the constant bank's fill included); the memo lookup stays in the
step's own time.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.access import LaunchConfig
from repro_torch.kernels.halo_pad import halo_pad
from repro_torch.kernels.stencil3d25.generator import best_config
from repro_torch.kernels.stencil3d25.kernel import (
    ring_tile,
    star_pointwise,
    star_zmarch,
    ytile_tile,
)
from repro_torch.kernels.stencil3d25.ref import star_weights


def _launch_for(config, r: int, domain: tuple, elem_bytes: int) -> LaunchConfig:
    if "block" in config:
        return LaunchConfig(block=tuple(config["block"]),
                            folding=tuple(config.get("folding", (1, 1, 1))))
    return best_config(r, domain, elem_bytes).launch


def zmarch_tile(config: dict, r: int, domain: tuple, elem_bytes: int) -> tuple:
    """(TY, TX) of a pinned ``ring`` / ``ytile_ring`` config; ValueError
    when the config cannot run on this domain."""
    if config["variant"] == "ring":
        return ring_tile(r, elem_bytes)
    ty = config.get("ty") or max(2 * r, 8)
    if domain[1] % ty or ty < 2 * r:
        raise ValueError("ty must divide Y and be >= 2r")
    return ytile_tile(r, ty, elem_bytes)


def star_stencil(src: torch.Tensor, weights=None, r: int = 4,
                 config: dict | None = None) -> torch.Tensor:
    """Apply the range-r star stencil to a (Z, Y, X) field on ``src``'s device.

    ``config=None`` (or ``{"variant": "replane"}``) ranks every launch of the
    per-point kernel on the H100 and runs it at the best one.  A pinned
    config is ``{"block": (bx, by, bz), "folding": (fx, fy, fz)}`` for the
    per-point kernel, ``{"variant": "ring"}`` or
    ``{"variant": "ytile_ring", "ty": ty}`` (ty divides Y, ty >= 2r) for the
    shared-memory z-march kernel.  The TPU's ``ytile_ring`` needs its input
    padded in y up to (Y/ty + 1)·ty rows; the CUDA kernel masks its own
    tile edge, so here every variant takes the same r-halo padding.

    On the card, for r <= ``kernel.UNROLLED_R``, both kernels read the
    weights from a constant bank per device and dtype, filled on the
    current stream before each launch and ordered after the bank's last
    launch on any other stream, so calls with different weights may run on
    several streams at once; any other r reads them from the weights
    tensor.  Every r runs on the card as on the CPU.
    """
    config = config or {"variant": "replane"}
    variant = config.get("variant", "replane")
    with obs.span("stencil.step", variant=variant):
        if weights is None:
            weights = star_weights(r, src.dtype, src.device)
        weights = torch.as_tensor(weights, dtype=src.dtype, device=src.device).contiguous()
        domain = tuple(src.shape)
        elem_bytes = src.element_size()
        if variant == "replane":
            launch = _launch_for(config, r, domain, elem_bytes)
        elif variant in ("ring", "ytile_ring"):
            tile = zmarch_tile(config, r, domain, elem_bytes)
        else:
            raise ValueError(f"unknown variant {variant!r}")
        with obs.span("stencil.pad"):
            padded = halo_pad(src.contiguous(), r)
        with obs.span("stencil.launch"):
            if variant == "replane":
                return star_pointwise(padded, weights, r, launch)
            return star_zmarch(padded, weights, r, *tile)
