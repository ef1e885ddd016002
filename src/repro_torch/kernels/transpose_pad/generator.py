"""Transpose code generator + estimator coupling on the H100 (paper fig. 1).

The decision space is the paper's: every thread block of the eq.-6 grid x
the three thread foldings (``core.selector.enumerate_gpu_configs``), applied
to the per-point kernel whose address expressions are
``core.specs.transpose_pad`` (the dim-permuted access ``x[p1, p0]`` that the
reference recovers by tracing ``make_transpose``).  The analytical GPU
model prices each launch on the machine (``H100`` by default) without
running anything; ``generate`` then returns the per-point CUDA kernel at
the winning launch, which is the kernel that was priced.

The tile shapes (bm, bn) of the TPU generator's space stage tiles through
shared memory, and the GPU model prices per-point kernels only: they are
recorded in ``.skipped`` with that reason and stay runnable through a
pinned config (``ops.transpose``).

The domain is 2D and reads as (1, Y, X), so a launch whose z extent bz·fz
exceeds 1 leaves every thread and fold step with z > 0 without a point,
which the GPU model prices as work done.  The ranking keeps only the
launches with z extent 1 (``kernels.flat_launches``), in the core's order;
the others are recorded in ``.skipped`` with their own reason and stay
runnable through a pinned config.

Ranking runs on the host through the exploration engine
(``core.selector.rank_gpu_configs``, serial) and is memoized per
``(shape, elem_bytes, machine)``.

``tpu_candidate_specs`` gives the reference's TPU decision space (the
(bm, bn) tiles on the operand padded to multiples of 8) as ``(config,
PallasKernelSpec)`` candidates, and ``tpu_rank_configs`` ranks them on a
``TPUMachine`` as the reference's ``rank_configs`` does.  The reference
derives every field from its traced Pallas body (no arithmetic, a moved
element a unit of work, the output tile as the vector shape); the port's
kernels are hand-written CUDA, which no tracer reads, so it declares them
in that form (pinned against the trace by
``tests/test_torch_generators_tpu.py``).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.machines import H100, TPU_V5E, GPUMachine, TPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import transpose_pad
from repro_torch.core.tpu_adapt import (
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    pow2_tiles,
    select_pallas_config,
)
from repro_torch.frontend.lower import block_vpu_shape
from repro_torch.kernels import SCRATCH_REASON, flat_launches, resolve_device
from repro_torch.kernels.transpose_pad.kernel import transpose_pointwise

_RANKINGS: dict = {}


def pad_to_tiles(n: int, tile: int) -> int:
    return -(-n // tile) * tile


def tile_space(shape: tuple, tile: int = 8):
    """The (bm, bn) decisions, as the TPU generator spans them on the
    operand padded to ``tile`` multiples: powers of two from 8 to 512 that
    divide the padded sides."""
    yield from _padded_space(pad_to_tiles(shape[0], tile), pad_to_tiles(shape[1], tile))


def _padded_space(Mp: int, Np: int):
    """``tile_space`` of an operand already padded to (Mp, Np) (a copy of
    ``repro.kernels.transpose_pad.generator._space``)."""
    for bm in pow2_tiles(8, min(Mp, 512)):
        if Mp % bm:
            continue
        for bn in pow2_tiles(8, min(Np, 512)):
            if Np % bn:
                continue
            yield {"bm": bm, "bn": bn}


@lru_cache(maxsize=None)
def _tpu_candidates(Mp: int, Np: int, elem_bytes: int) -> tuple:
    out = []
    for cfg in _padded_space(Mp, Np):
        bm, bn = cfg["bm"], cfg["bn"]
        # a (bm, bn) tile in, its (bn, bm) transpose out, no arithmetic
        out.append((cfg, PallasKernelSpec(
            name=f"transpose_{bm}x{bn}", grid=(Mp // bm, Np // bn),
            operands=(OperandSpec("x", (bm, bn), elem_bytes, grid_deps=(0, 1)),
                      OperandSpec("xt", (bn, bm), elem_bytes, grid_deps=(0, 1),
                                  is_output=True)),
            vpu_elems_per_step=0.0, vpu_shape=block_vpu_shape((bn, bm)),
            work_per_step=float(bm * bn), elem_bytes=elem_bytes)))
    return tuple(out)


def tpu_candidate_specs(shape: tuple, elem_bytes: int = 4, tile: int = 8):
    """``(config, PallasKernelSpec)`` of the reference's Pallas transpose at
    every (bm, bn) of ``tile_space(shape, tile)``, in its order, on the
    operand padded to ``tile`` multiples.  Declared, since the port cannot
    trace a Pallas kernel; memoised per padded shape."""
    M, N = shape
    yield from _tpu_candidates(pad_to_tiles(M, tile), pad_to_tiles(N, tile), elem_bytes)


def tpu_rank_configs(shape: tuple, machine: TPUMachine = TPU_V5E,
                     elem_bytes: int = 4) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``)."""
    return select_pallas_config(tpu_candidate_specs(shape, elem_bytes), machine)


def rank_configs(shape: tuple, elem_bytes: int = 4,
                 machine: GPUMachine = H100) -> RankingResult:
    """The launches of the per-point kernel that fill the domain's depth
    (``kernels.fills_depth``), best first, priced on ``machine``: the copied
    core ranking, filtered, in its order.  The tile shapes and the deeper
    launches are in ``.skipped``, each with its reason."""
    key = (tuple(shape), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    if cached is None:
        spec = transpose_pad(tuple(shape), elem_bytes)
        cached = rank_gpu_configs(spec, machine)
        cached.skipped.extend(
            SkippedConfig(spec.name, machine.name, cfg, SCRATCH_REASON) for cfg in tile_space(tuple(shape)))
        cached = flat_launches(cached)
        _RANKINGS[key] = cached
    # a copy: callers may mutate it
    return RankingResult(cached, cached.report, cached.skipped)


def best_config(shape: tuple, elem_bytes: int = 4,
                machine: GPUMachine = H100) -> RankedConfig:
    ranked = rank_configs(shape, elem_bytes, machine)
    if not ranked:
        raise RuntimeError(
            f"no launch of the transpose could be priced for shape {shape}: "
            f"{[s.reason for s in ranked.skipped]}")
    return ranked[0]


def generate(shape: tuple, machine: GPUMachine = H100, dtype=torch.float32,
             device="cuda"):
    """Pick the best launch analytically; return ``(kernel, RankedConfig)``
    where ``kernel(x)`` runs the per-point kernel at that launch on
    ``device``."""
    dev = resolve_device(device)
    best = best_config(shape, dtype.itemsize, machine)

    def kernel(x: torch.Tensor) -> torch.Tensor:
        if x.device.type != dev.type:
            raise ValueError(f"kernel generated for {dev}, got a tensor on {x.device}")
        return transpose_pointwise(x, best.launch)

    return kernel, best
