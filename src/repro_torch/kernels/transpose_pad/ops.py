"""Public entry point for the transpose: the paper's fig.-1 loop.

``transpose`` asks the generator for the best launch (ranked analytically
on the H100, memoized) and runs the per-point CUDA kernel there, unless
``config`` pins the decision.
"""
from __future__ import annotations

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels.transpose_pad.generator import best_config
from repro_torch.kernels.transpose_pad.kernel import transpose_pointwise, transpose_tiled


def transpose(x: torch.Tensor, config: dict | None = None) -> torch.Tensor:
    """The (N, M) transpose of an (M, N) tensor on ``x``'s device.

    ``config=None`` ranks every launch of the per-point kernel on the H100
    and runs it at the best one.  A pinned config is
    ``{"block": (bx, by, bz), "folding": (fx, fy, fz)}`` for the per-point
    kernel, or ``{"bm": bm, "bn": bn}`` for the shared-memory tiled kernel.
    The TPU kernel needs its operand padded to whole (bm, bn) tiles and
    crops the result; the CUDA kernels mask their edges, so nothing is
    padded here.
    """
    if x.dim() != 2:
        raise ValueError(f"expected an (M, N) tensor, got {tuple(x.shape)}")
    config = config or {}
    x = x.contiguous()
    if "bm" in config or "bn" in config:
        if "bm" not in config or "bn" not in config:
            raise ValueError(f"a tile config needs both bm and bn, got {config!r}")
        return transpose_tiled(x, int(config["bm"]), int(config["bn"]))
    if "block" in config:
        launch = LaunchConfig(block=tuple(config["block"]),
                              folding=tuple(config.get("folding", (1, 1, 1))))
    elif config:
        raise ValueError(f"unknown config {config!r}")
    else:
        launch = best_config(tuple(x.shape), x.element_size()).launch
    return transpose_pointwise(x, launch)
