"""LBM code generator + estimator coupling on the H100 (paper §5.3, fig. 1).

The decision space is the paper's: every thread block of the eq.-6 grid x
the three thread foldings (``core.selector.enumerate_gpu_configs``), applied
to the per-point kernel whose address expressions are
``core.specs.lbm_d3q15``.  The analytical GPU model prices each launch on
the machine (``H100`` by default) without running anything; ``generate``
then returns the per-point CUDA kernel at the winning launch, which is the
kernel that was priced.

The y-tiled variants (``ytile``, ty = 8, 16, ... <= Y/2 with ty | Y, the
TPU generator's space) stage the phase field through shared memory, and
the GPU model prices per-point kernels only: they are recorded in
``.skipped`` with that reason and stay runnable through a pinned config
(``ops.lbm_step``).

Ranking runs on the host through the exploration engine
(``core.selector.rank_gpu_configs``, serial) and is memoized per
``(domain, elem_bytes, machine)``.
"""
from __future__ import annotations

import torch

from repro_torch.core.machines import H100, GPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import lbm_d3q15
from repro_torch.kernels import SCRATCH_REASON, resolve_device
from repro_torch.kernels.lbm_d3q15.kernel import lbm_pointwise

_RANKINGS: dict = {}


def ytile_space(domain: tuple):
    """The y-tile decisions, as the TPU generator spans them: ty rows,
    ty = 8, 16, ... <= Y/2 with ty | Y."""
    _Z, Y, _X = domain
    ty = 8
    while ty <= Y // 2:
        if Y % ty == 0:
            yield {"variant": "ytile", "ty": ty}
        ty *= 2


def rank_configs(domain: tuple, elem_bytes: int = 8,
                 machine: GPUMachine = H100) -> RankingResult:
    """Every launch of the per-point kernel, best first, priced on
    ``machine``; the y-tiled variants are in ``.skipped``."""
    key = (tuple(domain), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    if cached is None:
        spec = lbm_d3q15(tuple(domain), elem_bytes)
        cached = rank_gpu_configs(spec, machine)
        cached.skipped.extend(
            SkippedConfig(spec.name, machine.name, cfg, SCRATCH_REASON) for cfg in ytile_space(tuple(domain)))
        _RANKINGS[key] = cached
    # a copy: callers may mutate it
    return RankingResult(cached, cached.report, cached.skipped)


def best_config(domain: tuple, elem_bytes: int = 8,
                machine: GPUMachine = H100) -> RankedConfig:
    ranked = rank_configs(domain, elem_bytes, machine)
    if not ranked:
        raise RuntimeError(
            f"no launch of the LBM step could be priced for domain {domain}: "
            f"{[s.reason for s in ranked.skipped]}")
    return ranked[0]


def generate(domain: tuple, machine: GPUMachine = H100, dtype=torch.float64,
             device="cuda", tau: float = 0.8, kappa: float = 0.15):
    """Pick the best launch analytically; return ``(kernel, RankedConfig)``
    where ``kernel(pdf_padded, phase_padded)`` runs the per-point kernel at
    that launch on ``device``."""
    dev = resolve_device(device)
    best = best_config(domain, dtype.itemsize, machine)

    def kernel(pdf_padded: torch.Tensor, phase_padded: torch.Tensor) -> torch.Tensor:
        if pdf_padded.device.type != dev.type:
            raise ValueError(f"kernel generated for {dev}, got a tensor on {pdf_padded.device}")
        return lbm_pointwise(pdf_padded, phase_padded, best.launch, tau, kappa)

    return kernel, best
