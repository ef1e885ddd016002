"""Stencil code generator + estimator coupling on the H100 (paper fig. 1).

The decision space is the paper's: every thread block of the eq.-6 grid x
the three thread foldings (``core.selector.enumerate_gpu_configs``), applied
to the per-point kernel whose address expressions are
``core.specs.star_stencil_3d``.  The analytical GPU model prices each launch
on the machine (``H100`` by default) without running anything; ``generate``
then returns the per-point CUDA kernel at the winning launch, which is the
kernel that was priced.

The z-march variants (``ring``, ``ytile_ring``) stage planes through shared
memory, and the GPU model prices per-point kernels only: DESIGN §9 rejects
scratch-staged kernels for the GPU target.  They are recorded in
``.skipped`` with that reason and stay runnable through a pinned config
(``ops.star_stencil``).

Ranking runs on the host through the exploration engine
(``core.selector.rank_gpu_configs``, serial) and is memoized per
``(r, domain, elem_bytes, machine)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.machines import H100, GPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import star_stencil_3d
from repro_torch.kernels import SCRATCH_REASON, resolve_device
from repro_torch.kernels.stencil3d25.kernel import star_pointwise

_RANKINGS: dict = {}


def zmarch_space(r: int, domain: tuple):
    """The shared-memory z-march decisions, as the TPU generator spans them:
    the full-plane ring, then y-tiles of ty rows (ty >= 2r, ty | Y)."""
    _Z, Y, _X = domain
    yield {"variant": "ring"}
    ty = max(2 * r, 8)
    while ty <= Y // 2:
        if Y % ty == 0:
            yield {"variant": "ytile_ring", "ty": ty}
        ty *= 2


def rank_configs(r: int, domain: tuple, elem_bytes: int = 8,
                 machine: GPUMachine = H100) -> RankingResult:
    """Every launch of the per-point kernel, best first, priced on
    ``machine``; the z-march variants are in ``.skipped``."""
    key = (r, tuple(domain), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    if cached is None:
        spec = star_stencil_3d(r, tuple(domain), elem_bytes)
        cached = rank_gpu_configs(spec, machine)
        cached.skipped.extend(
            SkippedConfig(spec.name, machine.name, cfg, SCRATCH_REASON) for cfg in zmarch_space(r, tuple(domain)))
        _RANKINGS[key] = cached
    # a copy: callers may mutate it
    return RankingResult(cached, cached.report, cached.skipped)


def best_config(r: int, domain: tuple, elem_bytes: int = 8,
                machine: GPUMachine = H100) -> RankedConfig:
    ranked = rank_configs(r, domain, elem_bytes, machine)
    if not ranked:
        raise RuntimeError(
            f"no launch of the star stencil could be priced for domain {domain}: "
            f"{[s.reason for s in ranked.skipped]}")
    return ranked[0]


def generate(r: int, domain: tuple, weights, machine: GPUMachine = H100,
             dtype=torch.float64, device="cuda"):
    """Pick the best launch analytically; return ``(kernel, RankedConfig)``
    where ``kernel(src_padded)`` runs the per-point kernel at that launch."""
    dev = resolve_device(device)
    best = best_config(r, domain, dtype.itemsize, machine)
    w = torch.as_tensor(weights, dtype=dtype, device=dev).contiguous()

    def kernel(src_padded: torch.Tensor) -> torch.Tensor:
        return star_pointwise(src_padded, w, r, best.launch)

    return kernel, best
