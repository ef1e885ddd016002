"""Multi-limiter performance model + full GPU estimation pipeline (paper §2-4).

The classic roofline model's two limiters (DRAM bandwidth, peak FP) are
extended with L2 bandwidth and L1 load/store throughput (paper §2).  Predicted
performance is the minimum over the per-limiter rates; the argmin identifies
the bottleneck — insight black-box tuning cannot give.

``estimate_gpu`` is the estimator workflow of fig. 1: address expressions +
launch config -> hardware metrics -> performance prediction.

The pipeline is factored into *structural* stages (grid walks, footprint
unions, wave-set counting — pure functions of ``(spec, launch geometry,
machine geometry)``) and *rate* stages (capacity hit-rates and limiter
arithmetic — cheap functions of the structural outputs plus cache sizes).
The exploration engine (``repro_torch.core.engine``) memoizes the structural
stages across the configurations and machines that share them; calling the
staged functions back-to-back is bitwise-identical to ``estimate_gpu``.

A copy of ``repro.core.perfmodel``; the port's tests pin its estimates
bitwise equal to the reference's.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

from .access import KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .footprint import footprint_boxes, footprint_bytes, union_bytes_by_field
from .gridwalk import (
    walk_block_l1_fast,
    warp_sector_requests_fast,
)
from .isets import (
    count_intersection_of_unions,
    count_triple_overlap,
    count_union,
)
from .machines import GPUMachine
from .wave import build_wave_sets, occupancy_blocks_per_sm


@dataclass
class VolumeBreakdown:
    """Per-LUP volumes (bytes) with compulsory/capacity/saved attribution."""

    compulsory: float = 0.0
    capacity: float = 0.0
    saved_y: float = 0.0
    saved_z: float = 0.0
    total: float = 0.0
    detail: dict = dc_field(default_factory=dict)


@dataclass
class GPUEstimate:
    kernel: str
    launch: LaunchConfig
    machine: str
    lups: int
    l1_cycles_per_lup: float
    l2_l1_load_per_lup: float
    l2_l1_store_per_lup: float
    dram_load_per_lup: float
    dram_store_per_lup: float
    dram_breakdown: VolumeBreakdown = None
    l2_breakdown: VolumeBreakdown = None
    flops_per_lup: float = 0.0
    perf_lups: float = 0.0         # predicted LUP/s
    limiter: str = ""
    limiter_rates: dict = dc_field(default_factory=dict)

    @property
    def time_per_lup(self) -> float:
        return 1.0 / self.perf_lups if self.perf_lups > 0 else math.inf


def _interior_block(grid: tuple) -> tuple:
    return (grid[0] // 2, grid[1] // 2, grid[2] // 2)


# --------------------------------------------------------------------------
# L1 stage
# --------------------------------------------------------------------------
@dataclass(frozen=True)
class L1Parts:
    """Structural inputs of the L1 model — machine-independent except for the
    32B-sector / 128B-line granularities shared by all supported GPUs."""

    cycles_per_lup: float   # bank-conflict cycles (grid walk)
    v_comp: int             # unique 32B load sectors of the block
    v_up: int               # per-warp sector-request upper bound
    v_alloc: int            # unique 128B lines of all accesses (L1 allocation)
    v_store: int            # unique 32B store sectors


def _interior_boxes(launch: LaunchConfig, domain: tuple):
    """Domain boxes of the representative interior block."""
    return launch.block_domain_boxes(_interior_block(launch.grid_for(domain)),
                                     domain)


def l1_parts(spec: KernelSpec, launch: LaunchConfig, domain=None) -> L1Parts:
    """Compute the structural L1 metrics for a representative interior block:
    bank cycles and sector requests on the enumeration path (paper listing 5),
    block footprints through implicit sets, as the reference's exploration
    engine computes them (equal to its enumeration oracle)."""
    domain = domain or spec.domain
    boxes = _interior_boxes(launch, domain)
    return L1Parts(
        cycles_per_lup=walk_block_l1_fast(spec, launch, domain),
        v_comp=footprint_bytes(spec.loads, boxes, 32),
        v_up=warp_sector_requests_fast(spec, launch, 32, domain),
        v_alloc=footprint_bytes(spec.accesses, boxes, 128),
        v_store=footprint_bytes(spec.stores, boxes, 32),
    )


def l1_rates(parts: L1Parts, launch: LaunchConfig, machine: GPUMachine,
             capacity: CapacityModel) -> dict:
    """Apply occupancy + capacity model to the structural L1 metrics."""
    pts = launch.points_per_block()
    bps = occupancy_blocks_per_sm(launch, machine.max_threads_per_sm)
    r_hit = capacity.hit_rate("l1_loads", parts.v_alloc * bps, machine.l1_bytes)
    v_cap = (1.0 - r_hit) * max(0.0, parts.v_up - parts.v_comp)
    return {
        "cycles_per_lup": parts.cycles_per_lup,
        "load_per_lup": (parts.v_comp + v_cap) / pts,
        "store_per_lup": parts.v_store / pts,  # write-through, sector granular
        "comp_per_lup": parts.v_comp / pts,
        "cap_per_lup": v_cap / pts,
        "upper_per_lup": parts.v_up / pts,
        "alloc_bytes": parts.v_alloc,
        "r_hit": r_hit,
    }


def estimate_l1(spec: KernelSpec, launch: LaunchConfig, machine: GPUMachine,
                capacity: CapacityModel, domain=None) -> dict:
    """L1 cycles + L2<->L1 volumes for a representative interior block."""
    domain = domain or spec.domain
    return l1_rates(l1_parts(spec, launch, domain), launch, machine, capacity)


# --------------------------------------------------------------------------
# DRAM stage
# --------------------------------------------------------------------------
# The wave-model structure is computed in two pieces with very different
# costs, so the tiered search (engine §5) can price the cheap piece for every
# candidate and reserve the expensive piece for the bound-surviving frontier:
#
#   * ``dram_front_structure`` — wave/layer *footprint volumes* (unions
#     only): compulsory load and store volumes, layer-set load footprints
#     and allocation volumes.  Enough for the sound DRAM lower bound.
#   * ``dram_overlap_structure`` — the wave ∩ layer *intersection* counts
#     (pairwise box intersections + the triple-overlap correction), the
#     dominant cost of the full wave model.
#
# ``dram_structure`` composes the two, so the monolithic path and the tiered
# engine path are bitwise identical by construction (every count is exact
# integer math; the merge introduces no float reassociation).
_WAVE_BOX_MEMO: dict = {}
_WAVE_BOX_MEMO_CAP = 64


def _wave_layer_boxes(spec: KernelSpec, launch: LaunchConfig,
                      machine: GPUMachine):
    """Shared box construction: wave sets + sector-granular load-footprint
    box lists of the wave and the y/z layer sets.

    Memoized in-process (bounded FIFO): the front and overlap stages run
    back-to-back on the same (spec, launch geometry, machine geometry) —
    as engine tasks possibly in the same worker — and the construction is
    a pure function of that key."""
    key = (spec, launch.block_extent(), launch.threads, machine.n_sms,
           machine.max_threads_per_sm, machine.sector_bytes)
    hit = _WAVE_BOX_MEMO.get(key)
    if hit is not None:
        return hit
    ws = build_wave_sets(spec, launch, machine.n_sms,
                         max_threads_per_sm=machine.max_threads_per_sm)
    sect = machine.sector_bytes
    f_wave = footprint_boxes(spec.loads, ws.wave, sect)
    f_y = footprint_boxes(spec.loads, ws.y_layer, sect) if ws.y_layer else {}
    f_z = footprint_boxes(spec.loads, ws.z_layer, sect) if ws.z_layer else {}
    out = (ws, f_wave, f_y, f_z)
    if len(_WAVE_BOX_MEMO) >= _WAVE_BOX_MEMO_CAP:
        _WAVE_BOX_MEMO.pop(next(iter(_WAVE_BOX_MEMO)))
    _WAVE_BOX_MEMO[key] = out
    return out


def _front_counts(spec, launch, machine, domain, ws, f_wave, f_y, f_z,
                  block_store_bytes):
    sect = machine.sector_bytes
    wave_pts = count_union(ws.wave)
    if wave_pts == 0:
        raise ValueError("empty wave")
    # compulsory load volume of the wave; layer-set load footprints bound
    # the potential reuse from above, allocation volumes drive hit-rates
    v_comp = union_bytes_by_field(f_wave, sect)
    v_y = union_bytes_by_field(f_y, sect) if f_y else 0
    v_z = union_bytes_by_field(f_z, sect) if f_z else 0
    alloc_y = (footprint_bytes(spec.accesses, ws.y_layer, machine.line_bytes)
               if f_y else 0)
    alloc_z = (footprint_bytes(spec.accesses, ws.z_layer, machine.line_bytes)
               if f_z else 0)

    # --- stores ---------------------------------------------------------
    v_store_comp = footprint_bytes(spec.stores, ws.wave, sect)
    # per-block redundancy: sum of block store footprints vs wave unique
    if block_store_bytes is None:
        block_store_bytes = footprint_bytes(
            spec.stores, _interior_boxes(launch, domain), sect)
    alloc_wave = footprint_bytes(spec.accesses, ws.wave, machine.line_bytes)
    return {
        "wave_pts": wave_pts,
        "n_blocks": ws.n_blocks,
        "has_y": bool(f_y),
        "has_z": bool(f_z),
        "v_comp": v_comp,
        "v_y": v_y,
        "v_z": v_z,
        "alloc_y": alloc_y,
        "alloc_z": alloc_z,
        "v_store_comp": v_store_comp,
        "block_store_bytes": block_store_bytes,
        "alloc_wave": alloc_wave,
    }


def _overlap_counts(f_wave, f_y, f_z, sect):
    v_ov_y = v_ov_z = 0.0
    triple = 0
    if f_y:
        v_ov_y = sum(
            count_intersection_of_unions(f_wave[k], f_y[k]) for k in f_wave if k in f_y
        ) * sect
    if f_z:
        v_ov_z = sum(
            count_intersection_of_unions(f_wave[k], f_z[k]) for k in f_wave if k in f_z
        ) * sect
        if f_y:
            # overlap of all three (wave ∩ z ∩ y) — subtract from z credit
            for k in f_wave:
                if k not in f_z or k not in f_y:
                    continue
                triple += count_triple_overlap(f_wave[k], f_z[k], f_y[k])
        v_ov_z = max(0.0, v_ov_z - triple * sect)
    return {"v_ov_y": v_ov_y, "v_ov_z": v_ov_z}


def dram_front_structure(spec: KernelSpec, launch: LaunchConfig,
                         machine, domain=None,
                         block_store_bytes: int | None = None) -> dict:
    """Wave-model footprint volumes (§4.4) — unions only, no overlaps.

    Everything here is independent of cache *capacities* (shareable across
    machines differing only in L2 size); ``machine`` may be a ``GPUMachine``
    or its ``GPUGeometry``.  ``block_store_bytes`` optionally injects a
    precomputed interior-block store footprint.
    """
    domain = domain or spec.domain
    ws, f_wave, f_y, f_z = _wave_layer_boxes(spec, launch, machine)
    return _front_counts(spec, launch, machine, domain, ws, f_wave, f_y, f_z,
                         block_store_bytes)


def dram_overlap_structure(spec: KernelSpec, launch: LaunchConfig,
                           machine, domain=None) -> dict:
    """Wave ∩ layer overlap counts (§4.4.2) — the expensive intersections,
    including the triple-overlap correction that keeps the y and z reuse
    credits disjoint.  Rebuilds the (memoized) box lists rather than
    receiving them from the front stage: as engine tasks the two stages may
    run in separate worker processes under separate cache keys."""
    _, f_wave, f_y, f_z = _wave_layer_boxes(spec, launch, machine)
    return _overlap_counts(f_wave, f_y, f_z, machine.sector_bytes)


def dram_structure(spec: KernelSpec, launch: LaunchConfig, machine: GPUMachine,
                   domain=None, block_store_bytes: int | None = None) -> dict:
    """Full wave-model footprint counts (§4.4): front volumes + overlaps,
    over one shared wave/layer box construction."""
    domain = domain or spec.domain
    ws, f_wave, f_y, f_z = _wave_layer_boxes(spec, launch, machine)
    struct = _front_counts(spec, launch, machine, domain, ws, f_wave, f_y,
                           f_z, block_store_bytes)
    struct.update(_overlap_counts(f_wave, f_y, f_z, machine.sector_bytes))
    return struct


def dram_rates(struct: dict, machine: GPUMachine, capacity: CapacityModel) -> dict:
    """Apply the capacity-miss model to the structural wave counts."""
    wave_pts = struct["wave_pts"]
    v_comp = struct["v_comp"]
    saved_y = saved_z = 0.0
    r_y = r_z = 0.0
    v_ov_y, v_ov_z = struct["v_ov_y"], struct["v_ov_z"]
    if struct["has_y"]:
        r_y = capacity.hit_rate("l2_over_y", struct["alloc_y"], machine.l2_bytes)
        saved_y = r_y * v_ov_y
    if struct["has_z"]:
        r_z = capacity.hit_rate("l2_over_z", struct["alloc_z"], machine.l2_bytes)
        saved_z = r_z * v_ov_z
    v_store_comp = struct["v_store_comp"]
    v_store_up = struct["block_store_bytes"] * struct["n_blocks"]
    r_store = capacity.hit_rate("l2_store", struct["alloc_wave"], machine.l2_bytes)
    v_store_red = max(0.0, v_store_up - v_store_comp)
    v_store_cap = (1.0 - r_store) * v_store_red
    # partially-written sectors evicted before completion are re-read (§4.4)
    completion_reads = v_store_cap

    v_load = v_comp - saved_y - saved_z + completion_reads
    v_store = v_store_comp + v_store_cap
    return {
        "load_per_lup": v_load / wave_pts,
        "store_per_lup": v_store / wave_pts,
        "breakdown": VolumeBreakdown(
            compulsory=v_comp / wave_pts,
            capacity=(v_store_cap + completion_reads) / wave_pts,
            saved_y=saved_y / wave_pts,
            saved_z=saved_z / wave_pts,
            total=(v_load + v_store) / wave_pts,
            detail={
                "v_ov_y_per_lup": v_ov_y / wave_pts,
                "v_ov_z_per_lup": v_ov_z / wave_pts,
                "r_y": r_y,
                "r_z": r_z,
                "r_store": r_store,
                "store_comp_per_lup": v_store_comp / wave_pts,
                "wave_blocks": struct["n_blocks"],
            },
        ),
        "wave_pts": wave_pts,
    }


def estimate_dram(spec: KernelSpec, launch: LaunchConfig, machine: GPUMachine,
                  capacity: CapacityModel, domain=None) -> dict:
    """DRAM<->L2 volumes via the wave model + layer-condition reuse (§4.4)."""
    return dram_rates(dram_structure(spec, launch, machine, domain),
                      machine, capacity)


# --------------------------------------------------------------------------
# Assembly
# --------------------------------------------------------------------------
def assemble_gpu_estimate(spec: KernelSpec, launch: LaunchConfig,
                          machine: GPUMachine, domain: tuple,
                          l1: dict, dram: dict) -> GPUEstimate:
    """Combine staged L1/DRAM metrics into the multi-limiter prediction."""
    flops = spec.flops_per_point
    # limiter rates in LUP/s (paper §2: four limiters)
    rates = {
        "L1": machine.n_sms * machine.clock_hz / max(l1["cycles_per_lup"], 1e-12),
        "L2": machine.l2_bw / max(l1["load_per_lup"] + l1["store_per_lup"], 1e-12),
        "DRAM": machine.dram_bw
        / max(dram["load_per_lup"] + dram["store_per_lup"], 1e-12),
        "FP": machine.peak_flops_dp / max(flops, 1e-12),
    }
    limiter = min(rates, key=rates.get)
    n_pts = 1
    for d in domain:
        n_pts *= d
    return GPUEstimate(
        kernel=spec.name,
        launch=launch,
        machine=machine.name,
        lups=n_pts,
        l1_cycles_per_lup=l1["cycles_per_lup"],
        l2_l1_load_per_lup=l1["load_per_lup"],
        l2_l1_store_per_lup=l1["store_per_lup"],
        dram_load_per_lup=dram["load_per_lup"],
        dram_store_per_lup=dram["store_per_lup"],
        dram_breakdown=dram["breakdown"],
        l2_breakdown=VolumeBreakdown(
            compulsory=l1["comp_per_lup"],
            capacity=l1["cap_per_lup"],
            total=l1["load_per_lup"] + l1["store_per_lup"],
            detail={"upper_per_lup": l1["upper_per_lup"], "r_hit": l1["r_hit"]},
        ),
        flops_per_lup=flops,
        perf_lups=min(rates.values()),
        limiter=limiter,
        limiter_rates=rates,
    )


def estimate_gpu(
    spec: KernelSpec,
    launch: LaunchConfig,
    machine: GPUMachine,
    capacity: CapacityModel | None = None,
    domain=None,
) -> GPUEstimate:
    """Full estimator pipeline (paper fig. 1): metrics -> multi-limiter model."""
    capacity = capacity or CapacityModel()
    domain = domain or spec.domain
    l1 = estimate_l1(spec, launch, machine, capacity, domain)
    dram = estimate_dram(spec, launch, machine, capacity, domain)
    return assemble_gpu_estimate(spec, launch, machine, domain, l1, dram)


# --------------------------------------------------------------------------
# Batched machine-axis rate stage (DESIGN.md §11)
# --------------------------------------------------------------------------
GPU_LIMITERS = ("L1", "L2", "DRAM", "FP")  # assemble_gpu_estimate dict order


def gpu_rate_matrix(parts_list, structs, launches, geometry, machines,
                    capacity: CapacityModel, flops: float):
    """Rate/limiter stage as one ``(configs x machines)`` array program.

    ``parts_list``/``structs``/``launches`` are the per-config structural
    outputs (L1Parts, merged front+overlap dicts, LaunchConfig) of one
    geometry group; ``machines`` vary only in rate-key fields.  Returns
    ``(perf, limiter_idx)`` — perf in LUP/s, limiter indices into
    ``GPU_LIMITERS``.

    Bitwise contract: every float operation mirrors the scalar
    ``l1_rates`` / ``dram_rates`` / ``assemble_gpu_estimate`` chain in the
    same order and associativity (IEEE +,-,*,/,min,max vectorize exactly;
    the only transcendental — the Gompertz hit-rate — goes through
    ``CapacityModel.hit_rate_matrix``, which reuses the scalar ``math.exp``
    path per unique input pair).  ``np.argmin`` picks the first minimum,
    matching ``min(rates, key=rates.get)`` over the insertion order above.
    The geometry-factoring property test pins column-equality to
    ``estimate_gpu``.
    """
    import numpy as np

    f = lambda xs: np.array(list(xs), dtype=float)  # noqa: E731
    # --- per-config structural arrays (exact int -> float64 conversions) --
    pts = f(l.points_per_block() for l in launches)
    bps = f(occupancy_blocks_per_sm(l, geometry.max_threads_per_sm)
            for l in launches)
    cycles = f(p.cycles_per_lup for p in parts_list)
    v_comp = f(p.v_comp for p in parts_list)
    v_up = f(p.v_up for p in parts_list)
    v_alloc = f(p.v_alloc for p in parts_list)
    v_store = f(p.v_store for p in parts_list)
    wave_pts = f(s["wave_pts"] for s in structs)
    v_comp_w = f(s["v_comp"] for s in structs)
    alloc_y = f(s["alloc_y"] for s in structs)
    alloc_z = f(s["alloc_z"] for s in structs)
    v_ov_y = f(s["v_ov_y"] for s in structs)
    v_ov_z = f(s["v_ov_z"] for s in structs)
    has_y = np.array([s["has_y"] for s in structs], dtype=bool)
    has_z = np.array([s["has_z"] for s in structs], dtype=bool)
    v_store_comp = f(s["v_store_comp"] for s in structs)
    v_store_up = f(s["block_store_bytes"] * s["n_blocks"] for s in structs)
    alloc_wave = f(s["alloc_wave"] for s in structs)
    # --- per-machine rate arrays -----------------------------------------
    l1_bytes = f(m.l1_bytes for m in machines)
    l2_bytes = f(m.l2_bytes for m in machines)
    clock = f(m.clock_hz for m in machines)
    l2_bw = f(m.l2_bw for m in machines)
    dram_bw = f(m.dram_bw for m in machines)
    peak = f(m.peak_flops_dp for m in machines)

    C, M = len(launches), len(machines)
    # --- L1 stage (l1_rates) ---------------------------------------------
    r_hit = capacity.hit_rate_matrix("l1_loads", v_alloc * bps, l1_bytes)
    v_cap = (1.0 - r_hit) * np.maximum(0.0, v_up - v_comp)[:, None]
    l1_load = (v_comp[:, None] + v_cap) / pts[:, None]
    l1_store = (v_store / pts)[:, None]
    # --- DRAM stage (dram_rates) -----------------------------------------
    r_y = capacity.hit_rate_matrix("l2_over_y", alloc_y, l2_bytes)
    r_z = capacity.hit_rate_matrix("l2_over_z", alloc_z, l2_bytes)
    saved_y = np.where(has_y[:, None], r_y * v_ov_y[:, None], 0.0)
    saved_z = np.where(has_z[:, None], r_z * v_ov_z[:, None], 0.0)
    r_store = capacity.hit_rate_matrix("l2_store", alloc_wave, l2_bytes)
    v_store_cap = (1.0 - r_store) * np.maximum(
        0.0, v_store_up - v_store_comp)[:, None]
    # partially-written sectors evicted before completion are re-read
    v_load = v_comp_w[:, None] - saved_y - saved_z + v_store_cap
    dram_load = v_load / wave_pts[:, None]
    dram_store = (v_store_comp[:, None] + v_store_cap) / wave_pts[:, None]
    # --- limiter arithmetic (assemble_gpu_estimate) ----------------------
    stack = np.stack([
        np.broadcast_to((geometry.n_sms * clock)[None, :]
                        / np.maximum(cycles, 1e-12)[:, None], (C, M)),
        l2_bw[None, :] / np.maximum(l1_load + l1_store, 1e-12),
        dram_bw[None, :] / np.maximum(dram_load + dram_store, 1e-12),
        np.broadcast_to((peak / max(flops, 1e-12))[None, :], (C, M)),
    ])
    return stack.min(axis=0), stack.argmin(axis=0)
