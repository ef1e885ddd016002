"""Jacobi code generator + estimator coupling on the H100 (paper fig. 1).

The decision space is the paper's: every thread block of the eq.-6 grid x
the three thread foldings (``core.selector.enumerate_gpu_configs``), applied
to the per-point kernel whose address expressions are
``core.specs.stencil_2d5pt`` (the reference pins its traced GPU lowering of
``make_rowstream`` equal to that spec).  The analytical GPU model prices
each launch on the machine (``H100`` by default) without running anything;
``generate`` then returns the per-point CUDA kernel at the winning launch,
which is the kernel that was priced.

The y-tiled variants (``ytile``, ty = 8, 16, ... <= Y/2 with ty | Y, the
TPU generator's space) stage their inputs through shared memory, and the
GPU model prices per-point kernels only: they are recorded in ``.skipped``
with that reason and stay runnable through a pinned config
(``ops.jacobi_step``).

The domain is 2D and reads as (1, Y, X), so a launch whose z extent bz·fz
exceeds 1 leaves every thread and fold step with z > 0 without a point,
which the GPU model prices as work done.  The ranking keeps only the
launches with z extent 1 (``kernels.flat_launches``), in the core's order;
the others are recorded in ``.skipped`` with their own reason and stay
runnable through a pinned config.

Ranking runs on the host through the exploration engine
(``core.selector.rank_gpu_configs``, serial) and is memoized per
``(domain, elem_bytes, machine)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.machines import H100, GPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import stencil_2d5pt
from repro_torch.kernels import SCRATCH_REASON, flat_launches, resolve_device
from repro_torch.kernels.jacobi2d.kernel import jacobi_pointwise

_RANKINGS: dict = {}


def ytile_space(domain: tuple):
    """The y-tile decisions, as the TPU generator spans them: ty rows,
    ty = 8, 16, ... <= Y/2 with ty | Y."""
    Y, _X = domain
    ty = 8
    while ty <= Y // 2:
        if Y % ty == 0:
            yield {"variant": "ytile", "ty": ty}
        ty *= 2


def rank_configs(domain: tuple, elem_bytes: int = 8,
                 machine: GPUMachine = H100) -> RankingResult:
    """The launches of the per-point kernel that fill the domain's depth
    (``kernels.fills_depth``), best first, priced on ``machine``: the copied
    core ranking, filtered, in its order.  The y-tiled variants and the deeper
    launches are in ``.skipped``, each with its reason."""
    key = (tuple(domain), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    if cached is None:
        spec = stencil_2d5pt(tuple(domain), elem_bytes)
        cached = rank_gpu_configs(spec, machine)
        cached.skipped.extend(
            SkippedConfig(spec.name, machine.name, cfg, SCRATCH_REASON) for cfg in ytile_space(tuple(domain)))
        cached = flat_launches(cached)
        _RANKINGS[key] = cached
    # a copy: callers may mutate it
    return RankingResult(cached, cached.report, cached.skipped)


def best_config(domain: tuple, elem_bytes: int = 8,
                machine: GPUMachine = H100) -> RankedConfig:
    ranked = rank_configs(domain, elem_bytes, machine)
    if not ranked:
        raise RuntimeError(
            f"no launch of the Jacobi sweep could be priced for domain {domain}: "
            f"{[s.reason for s in ranked.skipped]}")
    return ranked[0]


def generate(domain: tuple, weights=(0.5, 0.125), machine: GPUMachine = H100,
             dtype=torch.float64, device="cuda"):
    """Pick the best launch analytically; return ``(kernel, RankedConfig)``
    where ``kernel(src_padded)`` runs the per-point kernel at that launch on
    ``device``."""
    dev = resolve_device(device)
    best = best_config(domain, dtype.itemsize, machine)

    def kernel(src_padded: torch.Tensor) -> torch.Tensor:
        if src_padded.device.type != dev.type:
            raise ValueError(f"kernel generated for {dev}, got a tensor on {src_padded.device}")
        return jacobi_pointwise(src_padded, best.launch, weights)

    return kernel, best
