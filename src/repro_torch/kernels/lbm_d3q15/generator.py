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
``(domain, elem_bytes, machine)``; ``RANK_MEMO`` (the ``obs`` counter group
``kernels.lbm_d3q15.rank_memo``) counts the memo's hits and misses.

``tpu_candidate_specs`` gives the reference's TPU decision space
(``tpu_space``: the replane variant, then the y-tiles) as ``(config,
PallasKernelSpec)`` candidates, and ``tpu_rank_configs`` ranks them on a
``TPUMachine`` as the reference's ``rank_configs`` does.  The reference
traces them from its Pallas builders; the port's kernels are hand-written
CUDA, which no tracer reads, so it declares them in the form the
reference's tracer derives (pinned against that trace by
``tests/test_torch_generators_tpu.py``).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.machines import H100, TPU_V5E, GPUMachine, TPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import lbm_d3q15
from repro_torch.core.tpu_adapt import (
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    select_pallas_config,
)
from repro_torch.kernels import SCRATCH_REASON, resolve_device
from repro_torch.kernels.lbm_d3q15.kernel import lbm_pointwise
from repro_torch.obs import metrics

_RANKINGS: dict = {}
RANK_MEMO = metrics.CounterGroup("kernels.lbm_d3q15.rank_memo", {
    "hits": "rank_configs calls answered from the memo",
    "misses": "rank_configs calls that found no memo entry and ranked",
})

# the reference's collide-and-stream VPU count a point: relax and
# equilibrium a PDF, plus the gradient and normal math
FLOPS_PER_LUP = 15 * 8 + 25


def ytile_space(domain: tuple):
    """The y-tile decisions, as the TPU generator spans them: ty rows,
    ty = 8, 16, ... <= Y/2 with ty | Y."""
    _Z, Y, _X = domain
    ty = 8
    while ty <= Y // 2:
        if Y % ty == 0:
            yield {"variant": "ytile", "ty": ty}
        ty *= 2


def tpu_space(domain: tuple):
    """The reference's TPU decisions: the replane variant, then the y-tiles
    (a copy of ``repro.kernels.lbm_d3q15.generator._space``)."""
    yield {"variant": "replane"}
    yield from ytile_space(domain)


@lru_cache(maxsize=None)
def _tpu_candidates(domain: tuple, elem_bytes: int) -> tuple:
    Z, Y, X = domain
    Yp, Xp = Y + 2, X + 2
    eb = elem_bytes
    out = []
    for cfg in tpu_space(domain):
        if cfg["variant"] == "replane":
            # a plane of each PDF at its pulled z, the phase planes at z-1,
            # z and z+1, and the 15 new PDF planes, one z a step
            spec = PallasKernelSpec(
                name="lbm_replane", grid=(Z,),
                operands=tuple(OperandSpec(f"pdf{q}", (1, 1, Yp, Xp), eb, grid_deps=(0,))
                               for q in range(15))
                + tuple(OperandSpec(f"phase{k}", (1, Yp, Xp), eb, grid_deps=(0,))
                        for k in range(3))
                + (OperandSpec("dst", (15, 1, Y, X), eb, grid_deps=(0,), is_output=True),),
                vpu_elems_per_step=float(FLOPS_PER_LUP * Y * X), vpu_shape=(Y, X),
                work_per_step=float(Y * X), elem_bytes=eb)
        else:
            # every field as two ty-row tiles (the tile and the next, for
            # the halo) a (y-tile, z) step; the input is y-padded to
            # (Y/ty + 1)·ty rows, which no block shape shows
            ty = cfg["ty"]
            spec = PallasKernelSpec(
                name=f"lbm_ytile{ty}", grid=(Y // ty, Z),
                operands=tuple(OperandSpec(f"pdf{q}_{dj}", (1, 1, ty, Xp), eb, grid_deps=(0, 1))
                               for dj in (0, 1) for q in range(15))
                + tuple(OperandSpec(f"phase{k}_{dj}", (1, ty, Xp), eb, grid_deps=(0, 1))
                        for k in range(3) for dj in (0, 1))
                + (OperandSpec("dst", (15, 1, ty, X), eb, grid_deps=(0, 1), is_output=True),),
                vpu_elems_per_step=float(FLOPS_PER_LUP * ty * X), vpu_shape=(ty, X),
                work_per_step=float(ty * X), elem_bytes=eb)
        out.append((cfg, spec))
    return tuple(out)


def tpu_candidate_specs(domain: tuple, elem_bytes: int = 4):
    """``(config, PallasKernelSpec)`` of the reference's Pallas LBM at every
    config of ``tpu_space(domain)``, in its order: 19 operands a replane
    step, 37 a y-tile step.  Declared, since the port cannot trace a Pallas
    kernel; memoised per shape."""
    yield from _tpu_candidates(tuple(domain), elem_bytes)


def tpu_rank_configs(domain: tuple, machine: TPUMachine = TPU_V5E,
                     elem_bytes: int = 4) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``)."""
    return select_pallas_config(tpu_candidate_specs(domain, elem_bytes), machine)


def rank_configs(domain: tuple, elem_bytes: int = 8,
                 machine: GPUMachine = H100) -> RankingResult:
    """Every launch of the per-point kernel, best first, priced on
    ``machine``; the y-tiled variants are in ``.skipped``."""
    key = (tuple(domain), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    RANK_MEMO["misses" if cached is None else "hits"] += 1
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
