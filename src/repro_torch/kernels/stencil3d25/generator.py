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
``(r, domain, elem_bytes, machine)``; ``RANK_MEMO`` (the ``obs`` counter group
``kernels.stencil3d25.rank_memo``) counts the memo's hits and misses.

``tpu_candidate_specs`` gives the reference's TPU decision space
(``tpu_space``: the replane, ring and y-tiled ring Pallas variants) as
``(config, PallasKernelSpec)`` candidates for ``api.pallas_request``, and
``tpu_rank_configs`` ranks them on a ``TPUMachine`` as the reference's
``rank_configs`` does.  The
reference traces them from its Pallas builders; the port's kernels are
hand-written CUDA, which no tracer reads, so it declares them in the form
the reference's tracer derives (pinned against that trace by
``tests/test_torch_frontend.py``).
"""
from __future__ import annotations

from functools import lru_cache

import torch

from repro_torch.core.machines import H100, TPU_V5E, GPUMachine, TPUMachine
from repro_torch.core.selector import RankedConfig, RankingResult, SkippedConfig, rank_gpu_configs
from repro_torch.core.specs import star_stencil_3d
from repro_torch.core.tpu_adapt import (
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    select_pallas_config,
)
from repro_torch.kernels import SCRATCH_REASON, resolve_device
from repro_torch.kernels.stencil3d25.kernel import star_pointwise
from repro_torch.obs import metrics

_RANKINGS: dict = {}
RANK_MEMO = metrics.CounterGroup("kernels.stencil3d25.rank_memo", {
    "hits": "rank_configs calls answered from the memo",
    "misses": "rank_configs calls that found no memo entry and ranked",
})


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


def tpu_space(r: int, domain: tuple):
    """The reference's TPU decisions: the replane variant, the full-plane
    ring, then the y-tiled rings (a copy of
    ``repro.kernels.stencil3d25.generator._space``)."""
    yield {"variant": "replane"}
    yield from zmarch_space(r, domain)


@lru_cache(maxsize=None)
def _tpu_candidates(r: int, domain: tuple, elem_bytes: int) -> tuple:
    Z, Y, X = domain
    Yp, Xp, Zp = Y + 2 * r, X + 2 * r, Z + 2 * r
    fl = float(6 * r + 1) * 2.0  # a multiply and an add a tap
    eb = elem_bytes
    out = []
    for cfg in tpu_space(r, domain):
        variant = cfg["variant"]
        if variant == "replane":
            # 2r+1 plane windows of the padded source a step, no scratch
            spec = PallasKernelSpec(
                name=f"star{r}_replane", grid=(Z,),
                operands=tuple(OperandSpec(f"src_p{k}", (1, Yp, Xp), eb, grid_deps=(0,))
                               for k in range(2 * r + 1))
                + (OperandSpec("dst", (1, Y, X), eb, grid_deps=(0,), is_output=True),),
                vpu_elems_per_step=fl * Y * X, vpu_shape=(Y, X),
                work_per_step=float(Y * X), elem_bytes=eb)
        elif variant == "ring":
            # one plane a step into a ring of 2r+1 planes in scratch
            spec = PallasKernelSpec(
                name=f"star{r}_ring", grid=(Zp,),
                operands=(OperandSpec("src", (1, Yp, Xp), eb, grid_deps=(0,)),
                          OperandSpec("dst", (1, Y, X), eb, grid_deps=(0,), is_output=True)),
                vpu_elems_per_step=fl * Y * X * Z / Zp, vpu_shape=(Y, X),
                scratch_bytes=(2 * r + 1) * Yp * Xp * eb,
                work_per_step=float(Y * X) * Z / Zp, elem_bytes=eb)
        else:
            # two ty-row windows a step into a ring of 2r+1 (2ty)-row tiles
            ty = cfg["ty"]
            spec = PallasKernelSpec(
                name=f"star{r}_ytile{ty}", grid=(Y // ty, Zp),
                operands=(OperandSpec("src_a", (1, ty, Xp), eb, grid_deps=(0, 1)),
                          OperandSpec("src_b", (1, ty, Xp), eb, grid_deps=(0, 1)),
                          OperandSpec("dst", (1, ty, X), eb, grid_deps=(0, 1), is_output=True)),
                vpu_elems_per_step=fl * ty * X * Z / Zp, vpu_shape=(ty, X),
                scratch_bytes=(2 * r + 1) * 2 * ty * Xp * eb,
                work_per_step=float(ty * X) * Z / Zp, elem_bytes=eb)
        out.append((cfg, spec))
    return tuple(out)


def tpu_candidate_specs(r: int, domain: tuple, elem_bytes: int = 4):
    """``(config, PallasKernelSpec)`` of the reference's Pallas stencil at
    every config of ``tpu_space(r, domain)``, in its order.  Declared, since
    the port cannot trace a Pallas kernel; memoised per shape."""
    yield from _tpu_candidates(r, tuple(domain), elem_bytes)


def tpu_rank_configs(r: int, domain: tuple, machine: TPUMachine = TPU_V5E,
                     elem_bytes: int = 4) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``):
    those whose VMEM working set does not fit are left out."""
    return select_pallas_config(tpu_candidate_specs(r, domain, elem_bytes), machine)


def rank_configs(r: int, domain: tuple, elem_bytes: int = 8,
                 machine: GPUMachine = H100) -> RankingResult:
    """Every launch of the per-point kernel, best first, priced on
    ``machine``; the z-march variants are in ``.skipped``."""
    key = (r, tuple(domain), elem_bytes, machine)
    cached = _RANKINGS.get(key)
    RANK_MEMO["misses" if cached is None else "hits"] += 1
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
