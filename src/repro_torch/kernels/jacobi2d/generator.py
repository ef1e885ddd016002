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

``tpu_candidate_specs`` gives the reference's TPU decision space
(``tpu_space``: the rowstream variant, then the y-tiles) as ``(config,
PallasKernelSpec)`` candidates, and ``tpu_rank_configs`` ranks them on a
``TPUMachine`` as the reference's ``rank_configs`` does.  The reference
derives every field of them, the VPU counts and work units too, from its
traced Pallas bodies; the port's kernels are hand-written CUDA, which no
tracer reads, so it declares them in the form that trace takes (pinned
against it by ``tests/test_torch_generators_tpu.py``).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.machines import H100, TPU_V5E, GPUMachine, TPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import stencil_2d5pt
from repro_torch.core.tpu_adapt import (
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    select_pallas_config,
)
from repro_torch.frontend.lower import block_vpu_shape
from repro_torch.kernels import SCRATCH_REASON, flat_launches, resolve_device
from repro_torch.kernels.jacobi2d.kernel import jacobi_pointwise

_RANKINGS: dict = {}

# VPU element-ops a point of the reference's traced bodies: wc * c and
# wn * (u + d + l + r), summed (two multiplies, four adds); the GPU spec's
# flops a point stay ``core.specs.stencil_2d5pt``'s 5
TPU_VPU_OPS_PER_POINT = 6.0


def ytile_space(domain: tuple):
    """The y-tile decisions, as the TPU generator spans them: ty rows,
    ty = 8, 16, ... <= Y/2 with ty | Y."""
    Y, _X = domain
    ty = 8
    while ty <= Y // 2:
        if Y % ty == 0:
            yield {"variant": "ytile", "ty": ty}
        ty *= 2


def tpu_space(domain: tuple):
    """The reference's TPU decisions: the rowstream variant, then the
    y-tiles (a copy of ``repro.kernels.jacobi2d.generator._space``)."""
    yield {"variant": "rowstream"}
    yield from ytile_space(domain)


@lru_cache(maxsize=None)
def _tpu_candidates(domain: tuple, elem_bytes: int) -> tuple:
    Y, X = domain
    Xp = X + 2
    eb = elem_bytes
    out = []
    for cfg in tpu_space(domain):
        if cfg["variant"] == "rowstream":
            # padded rows y, y+1 and y+2 a step; the vector shape is read
            # off the output block, as the reference's lowering reads it
            spec = PallasKernelSpec(
                name="jacobi2d_rowstream", grid=(Y,),
                operands=tuple(OperandSpec(f"src{k}", (1, Xp), eb, grid_deps=(0,))
                               for k in range(3))
                + (OperandSpec("dst", (1, X), eb, grid_deps=(0,), is_output=True),),
                vpu_elems_per_step=TPU_VPU_OPS_PER_POINT * X, vpu_shape=block_vpu_shape((1, X)),
                work_per_step=float(X), elem_bytes=eb)
        else:
            # y-tiles j and j+1 of the input, y-padded to (Y/ty + 1)·ty rows
            ty = cfg["ty"]
            spec = PallasKernelSpec(
                name=f"jacobi2d_ytile{ty}", grid=(Y // ty,),
                operands=(OperandSpec("src0", (ty, Xp), eb, grid_deps=(0,)),
                          OperandSpec("src1", (ty, Xp), eb, grid_deps=(0,)),
                          OperandSpec("dst", (ty, X), eb, grid_deps=(0,), is_output=True)),
                vpu_elems_per_step=TPU_VPU_OPS_PER_POINT * ty * X,
                vpu_shape=block_vpu_shape((ty, X)),
                work_per_step=float(ty * X), elem_bytes=eb)
        out.append((cfg, spec))
    return tuple(out)


def tpu_candidate_specs(domain: tuple, elem_bytes: int = 4):
    """``(config, PallasKernelSpec)`` of the reference's Pallas Jacobi sweep
    at every config of ``tpu_space(domain)``, in its order.  Declared, since
    the port cannot trace a Pallas kernel; memoised per shape."""
    yield from _tpu_candidates(tuple(domain), elem_bytes)


def tpu_rank_configs(domain: tuple, machine: TPUMachine = TPU_V5E,
                     elem_bytes: int = 4) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``)."""
    return select_pallas_config(tpu_candidate_specs(domain, elem_bytes), machine)


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
