"""Estimator-protocol backends over the GPU and TPU analytical models.

GPU configurations are priced in four structural pieces with distinct
sharing behaviour:

  * ``block``   — interior-block footprints, keyed by the *block extent*
    (machine-independent; different (block, folding) pairs fold to the same
    extent).  Computed on the implicit-set path, which the tier-1 property
    tests pin as exactly equal to the enumeration oracle.  Cheap (a handful
    of box unions) — it doubles as the closed-form bound stage of the
    tiered search.
  * ``wave-front`` — wave/layer footprint *volumes* (§4.4 unions): the
    compulsory load/store volumes and the layer-set footprints and
    allocation volumes.  Keyed by extent + machine *geometry* (SM count,
    sector/line size) but not cache sizes, so hypothetical-GPU sweeps
    (e.g. doubled L2) share every count.
  * ``wave-overlap`` — the wave ∩ layer intersection counts (the dominant
    wave-model cost), same key shape as the front.
  * ``walk``    — L1 grid walk + per-warp sector requests, keyed by the full
    (block, folding) launch (machine-independent: shared across machines).
    Both walks read the memoized stream table (gridwalk, DESIGN §10), so
    one address generation per launch serves the whole exact tier — and
    the cache simulator, when a validation pass prices the same launch.

``combine`` then applies capacity hit-rates and limiter arithmetic — the
exact float operations of ``estimate_gpu``, so engine results are bitwise
identical to the direct path.

The tiered bound-then-refine contract (DESIGN.md §5): the bound stage
resolves only the ``block`` task and bounds predicted time below by FP work
and compulsory L2 volume; surviving configurations refine tier by tier
(front → overlap → walk), with ``tier_bound`` tightening at each step —
after the front a sound DRAM bound (realized layer reuse can never exceed
``min(v_comp, r_y*v_y + r_z*v_z)``, the overlaps being disjoint subsets of
the wave footprint), after the overlap the exact DRAM time.  Every bound is
a mathematical lower bound on the model's predicted time; a relative safety
margin of 1e-9 absorbs float-rounding differences between the closed forms
and the model's own arithmetic, so branch-and-bound pruning is exact.

The Pallas backend wraps ``estimate_pallas`` (already cheap closed-form
math): one task per (kernel spec, machine), with VMEM feasibility turned
into a recorded skip reason.  Its bound is the HBM-traffic time floor from
BlockSpec byte counts (``tpu_adapt.pallas_time_floor``), which shares the
estimate's float ops and is therefore sound without any margin.

A copy of ``repro.core.engine.backends``.  The port's perfmodel computes the
interior-block footprints through implicit sets, as the block task does, so
``combine`` is bitwise ``estimate_gpu`` of the port as well.
"""
from __future__ import annotations

from repro_torch import obs

from ..access import KernelSpec, LaunchConfig
from ..capacity import CapacityModel
from ..footprint import footprint_bytes
from ..gridwalk import walk_block_l1_fast, warp_sector_requests_fast
from ..machines import GPUGeometry, GPUMachine, TPUGeometry, TPUMachine
from ..perfmodel import (
    L1Parts,
    _interior_block,
    assemble_gpu_estimate,
    dram_front_structure,
    dram_overlap_structure,
    dram_rates,
    gpu_rate_matrix,
    l1_rates,
)
from .protocol import EvalResult, RejectedSpec, SkipConfig, Task

# Relative slack applied to the GPU closed-form bounds: the model computes
# times as 1/(bw / volume) while the bounds compute volume/bw directly, which
# can differ by an ulp (~1e-16 relative).  1e-9 is vastly wider than any
# accumulated rounding and vastly tighter than any real pruning margin.
_BOUND_MARGIN = 1.0 - 1e-9


# --------------------------------------------------------------------------
# structural task functions (module-level: picklable for the worker pool)
# --------------------------------------------------------------------------
def _interior_boxes(spec: KernelSpec, launch: LaunchConfig, domain: tuple):
    bidx = _interior_block(launch.grid_for(domain))
    return launch.block_domain_boxes(bidx, domain)


def gpu_block_task(spec: KernelSpec, launch: LaunchConfig, domain: tuple) -> tuple:
    """Interior-block footprints (32B load/store sectors, 128B alloc lines)
    via implicit sets — property-tested equal to the gridwalk oracle."""
    with obs.span("engine.task.footprint", "task"):
        boxes = _interior_boxes(spec, launch, domain)
        return (
            footprint_bytes(spec.loads, boxes, 32),
            footprint_bytes(spec.accesses, boxes, 128),
            footprint_bytes(spec.stores, boxes, 32),
        )


def gpu_walk_task(spec: KernelSpec, launch: LaunchConfig, domain: tuple) -> tuple:
    """L1 bank-conflict cycles + per-warp sector-request upper bound, on the
    vectorized walk (bitwise-equal to the per-warp loop oracle)."""
    with obs.span("engine.task.walk", "task"):
        return (
            walk_block_l1_fast(spec, launch, domain),
            warp_sector_requests_fast(spec, launch, 32, domain),
        )


def gpu_wave_front_task(spec: KernelSpec, launch: LaunchConfig,
                        geometry: GPUGeometry, domain: tuple) -> dict:
    """Wave-model footprint volumes (unions only); the interior-block store
    footprint is fed from the implicit-set path (== oracle) instead of
    re-enumerating.  Takes the machine *geometry*, not the machine: the
    cached value is shared by every rate variant (DESIGN.md §11)."""
    with obs.span("engine.task.wave", "task", part="front"):
        store_bytes = footprint_bytes(
            spec.stores, _interior_boxes(spec, launch, domain),
            geometry.sector_bytes
        )
        return dram_front_structure(spec, launch, geometry, domain,
                                    block_store_bytes=store_bytes)


def gpu_wave_overlap_task(spec: KernelSpec, launch: LaunchConfig,
                          geometry: GPUGeometry, domain: tuple) -> dict:
    """Wave ∩ layer overlap counts — the expensive wave-model intersections."""
    with obs.span("engine.task.wave", "task", part="overlap"):
        return dram_overlap_structure(spec, launch, geometry, domain)


class GPUBackend:
    """Estimator-protocol backend over the multi-limiter GPU model."""

    name = "gpu"

    def __init__(self, spec: KernelSpec, capacity: CapacityModel | None = None,
                 domain: tuple | None = None):
        self.spec = spec
        self.capacity = capacity or CapacityModel()
        self.domain = domain or spec.domain

    def _keys(self, launch: LaunchConfig, machine: GPUMachine) -> tuple:
        """Structural keys (block, front, overlap, walk) — single source of
        truth for task emission, combine lookup, and tier bounds.  Wave keys
        carry the machine's ``GPUGeometry`` (never rate-key fields), so all
        rate variants of one geometry share every entry (DESIGN.md §11)."""
        spec, domain = self.spec, self.domain
        extent = launch.block_extent()
        geom = machine.geometry
        return (
            ("gpu-block", spec, extent, domain),
            ("gpu-wave-front", spec, extent, launch.threads, geom, domain),
            ("gpu-wave-overlap", spec, extent, launch.threads, geom, domain),
            ("gpu-walk", spec, launch.block, launch.folding, domain),
        )

    # items are LaunchConfigs; task order == tier resolution order, so the
    # first failing task yields the same skip reason on both search paths
    def structural_tasks(self, launch: LaunchConfig,
                         machine: GPUMachine) -> list:
        spec, domain = self.spec, self.domain
        geom = machine.geometry
        k_block, k_front, k_overlap, k_walk = self._keys(launch, machine)
        return [
            Task(k_block, gpu_block_task, (spec, launch, domain)),
            Task(k_front, gpu_wave_front_task, (spec, launch, geom, domain)),
            Task(k_overlap, gpu_wave_overlap_task,
                 (spec, launch, geom, domain)),
            Task(k_walk, gpu_walk_task, (spec, launch, domain)),
        ]

    # ---- tiered bound-then-refine (optional protocol methods) ----------
    def bound_tasks(self, launch: LaunchConfig, machine: GPUMachine) -> list:
        """The closed-form bound needs only the (cheap) block footprints."""
        spec, domain = self.spec, self.domain
        k_block = ("gpu-block", spec, launch.block_extent(), domain)
        return [Task(k_block, gpu_block_task, (spec, launch, domain))]

    def tiers(self, launch: LaunchConfig, machine: GPUMachine) -> list:
        """Cheapest discriminating signal first: wave front (sound DRAM
        bound) → wave overlaps (exact DRAM) → grid walk (exact L1/L2)."""
        spec, domain = self.spec, self.domain
        geom = machine.geometry
        _, k_front, k_overlap, k_walk = self._keys(launch, machine)
        return [
            [Task(k_front, gpu_wave_front_task,
                  (spec, launch, geom, domain))],
            [Task(k_overlap, gpu_wave_overlap_task,
                  (spec, launch, geom, domain))],
            [Task(k_walk, gpu_walk_task, (spec, launch, domain))],
        ]

    def tier_bound(self, launch: LaunchConfig, machine: GPUMachine,
                   values: dict) -> float:
        spec = self.spec
        k_block, k_front, k_overlap, _ = self._keys(launch, machine)
        pts = launch.points_per_block()
        # FP work floor (config-independent)
        t = max(spec.flops_per_point, 1e-12) / machine.peak_flops_dp
        if k_block in values:
            # L2 floor: compulsory load sectors + write-through stores; the
            # capacity term of the L1 model only ever adds volume
            v_comp_b, _, v_store_b = values[k_block]
            t = max(t, (v_comp_b + v_store_b) / pts / machine.l2_bw)
        front = values.get(k_front)
        if front is not None:
            if k_overlap in values:
                # exact DRAM time: identical float ops to the model's rate
                struct = dict(front)
                struct.update(values[k_overlap])
                dram = dram_rates(struct, machine, self.capacity)
                vol = dram["load_per_lup"] + dram["store_per_lup"]
                t = max(t, 1.0 / (machine.dram_bw / max(vol, 1e-12)))
            else:
                # sound DRAM floor: realized reuse <= min(v_comp,
                # r_y*v_y + r_z*v_z) because the per-dimension overlaps are
                # disjoint subsets of the wave footprint and hit rates are
                # clamped to [0, 1]
                saved_cap = 0.0
                if front["has_y"]:
                    saved_cap += self.capacity.hit_rate(
                        "l2_over_y", front["alloc_y"], machine.l2_bytes
                    ) * front["v_y"]
                if front["has_z"]:
                    saved_cap += self.capacity.hit_rate(
                        "l2_over_z", front["alloc_z"], machine.l2_bytes
                    ) * front["v_z"]
                saved_cap = min(saved_cap, front["v_comp"])
                v_lb = front["v_comp"] - saved_cap + front["v_store_comp"]
                t = max(t, v_lb / front["wave_pts"] / machine.dram_bw)
        return t * _BOUND_MARGIN

    def primary_time(self, result: EvalResult) -> float:
        return result.estimate.time_per_lup

    def combine(self, launch: LaunchConfig, machine: GPUMachine,
                values: dict) -> tuple:
        spec, domain = self.spec, self.domain
        k_block, k_front, k_overlap, k_walk = self._keys(launch, machine)
        v_comp, v_alloc, v_store = values[k_block]
        cycles, v_up = values[k_walk]
        struct = dict(values[k_front])
        struct.update(values[k_overlap])
        l1 = l1_rates(
            L1Parts(cycles_per_lup=cycles, v_comp=v_comp, v_up=v_up,
                    v_alloc=v_alloc, v_store=v_store),
            launch, machine, self.capacity,
        )
        dram = dram_rates(struct, machine, self.capacity)
        est = assemble_gpu_estimate(spec, launch, machine, domain, l1, dram)
        return launch, est, est.perf_lups, est.limiter

    def sort_key(self, result: EvalResult) -> tuple:
        return (-result.perf,)

    # ---- machine-axis batched evaluation (DESIGN.md §11) ----------------
    def geometry_key(self, machine: GPUMachine) -> GPUGeometry:
        return machine.geometry

    def machine_axis_tasks(self, launch: LaunchConfig,
                           machine: GPUMachine) -> list:
        """Structural work for the whole geometry group — identical to the
        per-machine task set because the keys are already geometry-pure."""
        return self.structural_tasks(launch, machine)

    def batch_order(self, items, values_per_item, machines):
        """Rank every live config on every machine in one array program.

        Returns per-machine index orders into ``items`` (best first, ties
        toward earlier enumeration — matching the scalar ``(-perf, index)``
        sort) plus per-machine ``(item_pos, reason)`` skip lists (empty:
        the GPU combine has no feasibility constraint)."""
        import numpy as np

        rep = machines[0]
        parts_list, structs = [], []
        for launch, values in zip(items, values_per_item):
            k_block, k_front, k_overlap, k_walk = self._keys(launch, rep)
            v_comp, v_alloc, v_store = values[k_block]
            cycles, v_up = values[k_walk]
            parts_list.append(L1Parts(
                cycles_per_lup=cycles, v_comp=v_comp, v_up=v_up,
                v_alloc=v_alloc, v_store=v_store))
            struct = dict(values[k_front])
            struct.update(values[k_overlap])
            structs.append(struct)
        perf, _ = gpu_rate_matrix(parts_list, structs, items, rep.geometry,
                                  machines, self.capacity,
                                  self.spec.flops_per_point)
        idx = np.arange(len(items))
        orders = [np.lexsort((idx, -perf[:, m]))
                  for m in range(len(machines))]
        return orders, [[] for _ in machines]

    def machine_axis_combine(self, launch: LaunchConfig, machine: GPUMachine,
                             values: dict) -> tuple:
        """Scalar entry construction for the selected top-k — the exact
        ``combine`` arithmetic, so returned estimates are bitwise identical
        to per-machine pricing by construction."""
        return self.combine(launch, machine, values)


# --------------------------------------------------------------------------
def pallas_task(spec, machine: TPUMachine):
    from ..tpu_adapt import estimate_pallas

    return estimate_pallas(spec, machine)


def pallas_bound_task(spec, machine: TPUMachine) -> float:
    from ..tpu_adapt import pallas_time_floor

    return pallas_time_floor(spec, machine)


def pallas_structure_task(spec, geometry: TPUGeometry) -> dict:
    from ..tpu_adapt import pallas_structure

    return pallas_structure(spec, geometry)


class PallasBackend:
    """Estimator-protocol backend over the TPU/Pallas analytical model."""

    name = "pallas"

    # items are (config_dict, PallasKernelSpec) candidates; a RejectedSpec
    # spec (frontend tracing diagnostics) needs no structural work — it
    # resolves straight to a recorded skip in combine
    def structural_tasks(self, item, machine: TPUMachine) -> list:
        _, spec = item
        if isinstance(spec, RejectedSpec):
            return []
        return [Task(("pallas", spec, machine), pallas_task, (spec, machine))]

    # ---- tiered bound-then-refine (optional protocol methods) ----------
    def bound_tasks(self, item, machine: TPUMachine) -> list:
        _, spec = item
        if isinstance(spec, RejectedSpec):
            return []
        return [Task(("pallas-bound", spec, machine), pallas_bound_task,
                     (spec, machine))]

    def tiers(self, item, machine: TPUMachine) -> list:
        return [self.structural_tasks(item, machine)]

    def tier_bound(self, item, machine: TPUMachine, values: dict) -> float:
        _, spec = item
        bound = values.get(("pallas-bound", spec, machine))
        # shares the estimate's float ops exactly (monotone max/+) — no
        # rounding margin needed
        return bound if bound is not None else float("-inf")

    def primary_time(self, result: EvalResult) -> float:
        return result.estimate.total_time

    def combine(self, item, machine: TPUMachine, values: dict) -> tuple:
        config, spec = item
        if isinstance(spec, RejectedSpec):
            raise SkipConfig(spec.reason)
        est = values[("pallas", spec, machine)]
        if not est.feasible:
            raise SkipConfig(
                f"VMEM layer condition violated: {est.vmem_alloc_bytes} B "
                f"allocated > {machine.vmem_bytes} B VMEM"
            )
        return config, est, est.work_rate, est.limiter

    def sort_key(self, result: EvalResult) -> tuple:
        # predicted time ascending; ties toward smaller VMEM footprints
        return (result.estimate.total_time, result.estimate.vmem_alloc_bytes)

    # ---- machine-axis batched evaluation (DESIGN.md §11) ----------------
    def geometry_key(self, machine: TPUMachine) -> TPUGeometry:
        return machine.geometry

    def machine_axis_tasks(self, item, machine: TPUMachine) -> list:
        _, spec = item
        if isinstance(spec, RejectedSpec):
            return []
        geom = machine.geometry
        return [Task(("pallas-struct", spec, geom), pallas_structure_task,
                     (spec, geom))]

    def batch_order(self, items, values_per_item, machines):
        """Rank every candidate on every machine from the shared structural
        stage: one ``(candidates x machines)`` rate program, per-machine
        orders matching the scalar ``(total_time, vmem_alloc, index)`` sort,
        and VMEM-infeasible / tracer-rejected candidates as per-machine
        ``(item_pos, reason)`` skips with the scalar path's exact wording."""
        import numpy as np

        from ..tpu_adapt import pallas_rate_matrix

        geom = machines[0].geometry
        live_pos, structs = [], []
        rejected = []  # (pos, reason)
        for pos, (item, values) in enumerate(zip(items, values_per_item)):
            _, spec = item
            if isinstance(spec, RejectedSpec):
                rejected.append((pos, f"SkipConfig: {spec.reason}"))
                continue
            live_pos.append(pos)
            structs.append(values[("pallas-struct", spec, geom)])
        if not structs:
            return ([np.array([], dtype=int) for _ in machines],
                    [list(rejected) for _ in machines])
        total, _, feasible = pallas_rate_matrix(structs, machines)
        vmem_alloc = np.array([s["vmem_alloc"] for s in structs],
                              dtype=float)
        idx = np.arange(len(structs))
        pos_arr = np.array(live_pos)
        orders, skips = [], []
        for m, machine in enumerate(machines):
            order = np.lexsort((idx, vmem_alloc, total[:, m]))
            orders.append(pos_arr[order[feasible[order, m]]])
            mskips = list(rejected)
            for i in np.flatnonzero(~feasible[:, m]):
                alloc = structs[i]["vmem_alloc"]
                mskips.append((live_pos[i], (
                    f"SkipConfig: VMEM layer condition violated: "
                    f"{alloc} B allocated > {machine.vmem_bytes} B VMEM")))
            skips.append(mskips)
        return orders, skips

    def machine_axis_combine(self, item, machine: TPUMachine,
                             values: dict) -> tuple:
        """Scalar estimate for the selected top-k entries — the same
        ``estimate_pallas`` every path runs, so results are bitwise
        identical to per-machine pricing by construction."""
        from ..tpu_adapt import estimate_pallas

        config, spec = item
        if isinstance(spec, RejectedSpec):
            raise SkipConfig(spec.reason)
        est = estimate_pallas(spec, machine)
        if not est.feasible:
            raise SkipConfig(
                f"VMEM layer condition violated: {est.vmem_alloc_bytes} B "
                f"allocated > {machine.vmem_bytes} B VMEM"
            )
        return config, est, est.work_rate, est.limiter
