"""TPU-native adaptation of the estimator (DESIGN §2).

On TPU the memory hierarchy is software-managed: a Pallas kernel's
``BlockSpec``s *are* its address expressions — an affine map from grid indices
to HBM block coordinates.  This module prices a Pallas kernel configuration
analytically, before any lowering:

  * **Revisit analysis** (the cache-reuse analogue): Mosaic elides the
    HBM->VMEM copy when an operand's index map yields the same block on
    consecutive grid steps.  For an index map depending on grid dims S under
    lexicographic iteration (last dim fastest), the number of fetches is
    exactly ``prod(grid[0..m])`` with m the innermost dim in S (size>1) —
    derived from counting increment boundaries, and property-tested against
    explicit grid walking.
  * **VMEM footprint**: blocks allocate at (sublane x 128-lane) tile
    granularity — the "wasted cache line" analogue of paper fig. 7 — and
    pipelined operands are double-buffered.  The layer condition of §5.7
    becomes a *hard feasibility constraint*: the working set must fit VMEM.
  * **Issue model**: MXU matmuls pay padding to 128x128 systolic tiles (the
    TPU analogue of L1 wavefront efficiency); VPU ops pay (8,128) vector-tile
    padding.
  * **Multi-limiter time**: with Mosaic's double-buffered pipeline, compute
    overlaps DMA, so T = max(T_mxu+T_vpu, T_hbm, T_vmem) + grid overhead.

``select_pallas_config`` ranks candidate block configurations — replacing
autotuning exactly as the paper does for thread-block sizes.

A copy of ``repro.core.tpu_adapt``, pure Python: the port's engine prices
the specs its generators declare (``tpu_candidate_specs``) and those its
spec frontend (``repro_torch.frontend``) traces from Triton kernels.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field
from typing import Callable, Iterable

from .access import memoize_hash
from .machines import TPUMachine, TPU_V5E


def _roundup(x: int, m: int) -> int:
    return -(-x // m) * m


@memoize_hash
@dataclass(frozen=True)
class OperandSpec:
    """One Pallas operand: its BlockSpec as seen by the estimator.

    ``grid_deps``: grid dims (indices into the kernel grid) the index map
    depends on.  ``revisit=False`` forces per-step refetch (e.g. dynamic,
    data-dependent index maps where Mosaic cannot prove equality).
    """

    name: str
    block_shape: tuple
    elem_bytes: int = 4
    grid_deps: tuple = ()
    is_output: bool = False
    n_buffers: int = 2          # double-buffered pipeline default
    revisit: bool = True

    def block_bytes(self) -> int:
        return math.prod(self.block_shape) * self.elem_bytes

    def vmem_block_bytes(self, machine: TPUMachine) -> int:
        """Allocated bytes: trailing dims padded to the (sublane, lane) tile."""
        shape = list(self.block_shape)
        if len(shape) >= 1:
            shape[-1] = _roundup(shape[-1], machine.vpu_lanes)
        if len(shape) >= 2:
            shape[-2] = _roundup(shape[-2], machine.sublane_elems(self.elem_bytes))
        return math.prod(shape) * self.elem_bytes


@memoize_hash
@dataclass(frozen=True)
class MatmulShape:
    m: int
    k: int
    n: int

    def flops(self) -> float:
        return 2.0 * self.m * self.k * self.n

    def padded_flops(self, machine: TPUMachine, elem_bytes: int = 2) -> float:
        sub = machine.sublane_elems(elem_bytes)
        return (
            2.0
            * _roundup(self.m, sub)
            * _roundup(self.k, machine.mxu_dim)
            * _roundup(self.n, machine.mxu_dim)
        )


@memoize_hash
@dataclass(frozen=True)
class PallasKernelSpec:
    """Estimator view of one pallas_call configuration."""

    name: str
    grid: tuple
    operands: tuple                      # tuple[OperandSpec, ...]
    matmuls_per_step: tuple = ()         # tuple[MatmulShape, ...]
    vpu_elems_per_step: float = 0.0      # elementwise VPU element-ops per step
    vpu_shape: tuple = ()                # representative (sub, lane) shape for padding
    scratch_bytes: int = 0
    work_per_step: float = 1.0           # work units (points/tokens) per grid step
    elem_bytes: int = 4                  # dominant compute dtype


def fetch_count(grid: tuple, grid_deps: tuple, revisit: bool = True) -> int:
    """Fetches under lexicographic grid iteration with consecutive-step
    copy elision (see module docstring)."""
    n_steps = math.prod(grid) if grid else 1
    deps = [d for d in grid_deps if grid[d] > 1]
    if not revisit:
        return n_steps
    if not deps:
        return 1
    m = max(deps)
    out = 1
    for d in range(m + 1):
        out *= grid[d]
    return out


def fetch_count_oracle(grid: tuple, index_map: Callable, revisit: bool = True) -> int:
    """Explicit grid walk (the listing-5 analogue for TPU) — test oracle."""
    from itertools import product

    steps = list(product(*[range(g) for g in grid]))
    if not steps:
        return 0
    count = 0
    prev = object()
    for s in steps:
        cur = index_map(*s)
        if not revisit or cur != prev:
            count += 1
        prev = cur
    return count


@dataclass
class PallasEstimate:
    kernel: str
    hbm_bytes: float
    hbm_time: float
    mxu_time: float
    vpu_time: float
    vmem_time: float
    vmem_alloc_bytes: int
    grid_overhead: float
    total_time: float
    limiter: str
    feasible: bool
    work: float
    detail: dict = dc_field(default_factory=dict)

    @property
    def work_rate(self) -> float:
        return self.work / self.total_time if self.total_time > 0 else 0.0

    @property
    def bytes_per_work(self) -> float:
        return self.hbm_bytes / self.work if self.work else 0.0


def hbm_traffic(spec: PallasKernelSpec) -> tuple:
    """HBM traffic via revisit analysis: ``(hbm_bytes, per_operand detail)``.

    Closed-form BlockSpec byte counting — cheap enough that the tiered
    search (engine §5) uses it, plus the grid overhead, as the sound lower
    bound on predicted time before running the full estimate.  Factored out
    of ``estimate_pallas`` so bound and estimate share the exact float ops.
    """
    hbm_bytes = 0.0
    per_op = {}
    for op in spec.operands:
        fetches = fetch_count(spec.grid, op.grid_deps, op.revisit)
        # short-row DMA efficiency: rows shorter than the 256B granule waste bw
        row_bytes = op.block_shape[-1] * op.elem_bytes if op.block_shape else op.elem_bytes
        eff = min(1.0, row_bytes / 256.0) if row_bytes < 256 else 1.0
        vol = fetches * op.block_bytes()
        per_op[op.name] = {"fetches": fetches, "bytes": vol, "dma_eff": eff}
        hbm_bytes += vol / max(eff, 1e-6)
    return hbm_bytes, per_op


def pallas_time_floor(spec: PallasKernelSpec,
                      machine: TPUMachine = TPU_V5E) -> float:
    """Lower bound on ``estimate_pallas(...).total_time`` from HBM volume
    and grid overhead alone (no issue model, no VMEM residency).

    Sound by construction: the estimate's total is ``max(compute, hbm_time,
    vmem_time) + overhead`` with both terms computed by the identical float
    operations used here, and ``max``/``+`` are monotone in IEEE arithmetic.
    """
    n_steps = math.prod(spec.grid) if spec.grid else 1
    hbm_bytes, _ = hbm_traffic(spec)
    return hbm_bytes / machine.hbm_bw + n_steps * machine.grid_step_overhead_s


def pallas_structure(spec: PallasKernelSpec, geometry) -> dict:
    """Geometry-keyed structural stage of the Pallas model (DESIGN.md §11).

    ``geometry`` is a ``TPUGeometry`` (or any object with ``vpu_lanes``,
    ``sublane_elems``, ``mxu_dim``) — everything here depends on tile
    paddings and the grid, never on bandwidths, FLOP peaks, or the VMEM
    *capacity* budget, so all rate variants of one geometry share this
    computation.  Mirrors ``estimate_pallas``'s float operations exactly
    (the property tests pin the batched path bitwise-equal to it).
    """
    n_steps = math.prod(spec.grid) if spec.grid else 1
    hbm_bytes, per_op = hbm_traffic(spec)
    vmem_alloc = spec.scratch_bytes
    for op in spec.operands:
        vmem_alloc += op.vmem_block_bytes(geometry) * op.n_buffers
    mxu_flops = sum(m.padded_flops(geometry, spec.elem_bytes)
                    for m in spec.matmuls_per_step)
    vpu_elems = spec.vpu_elems_per_step
    if spec.vpu_shape and len(spec.vpu_shape) >= 2:
        sub = geometry.sublane_elems(spec.elem_bytes)
        pad = (
            _roundup(spec.vpu_shape[-2], sub)
            * _roundup(spec.vpu_shape[-1], geometry.vpu_lanes)
        ) / max(spec.vpu_shape[-2] * spec.vpu_shape[-1], 1)
        vpu_elems *= pad
    vmem_touch = sum(op.block_bytes() for op in spec.operands) * n_steps
    return {
        "n_steps": n_steps,
        "hbm_bytes": hbm_bytes,
        "per_op": per_op,
        "vmem_alloc": vmem_alloc,
        "mxu_flops": mxu_flops,
        "vpu_elems": vpu_elems,
        "vmem_touch": vmem_touch,
        "work": spec.work_per_step * n_steps,
        "elem_bytes": spec.elem_bytes,
    }


PALLAS_LIMITERS = ("MXU", "VPU", "HBM", "VMEM")


def pallas_rate_matrix(structs, machines):
    """Rate stage over ``(candidates x machines)`` (DESIGN.md §11).

    Returns ``(total, limiter_idx, feasible)``: predicted total time,
    limiter indices into ``PALLAS_LIMITERS``, and the VMEM-residency
    feasibility mask.  Bitwise contract with ``estimate_pallas``: identical
    operation order per element; the limiter replicates the scalar path's
    dict-collapse tie semantics (equal float keys keep the *last* inserted
    label over the insertion order compute, hbm, vmem — emulated with an
    argmax over the reversed stack).
    """
    import numpy as np

    f = lambda xs: np.array(list(xs), dtype=float)  # noqa: E731
    n_steps = f(s["n_steps"] for s in structs)
    hbm_bytes = f(s["hbm_bytes"] for s in structs)
    mxu_flops = f(s["mxu_flops"] for s in structs)
    vpu_elems = f(s["vpu_elems"] for s in structs)
    vmem_touch = f(s["vmem_touch"] for s in structs)
    vmem_alloc = f(s["vmem_alloc"] for s in structs)
    bf16 = np.array([s["elem_bytes"] <= 2 for s in structs], dtype=bool)

    hbm_bw = f(m.hbm_bw for m in machines)
    vmem_bw = f(m.vmem_bw for m in machines)
    vpu_flops = f(m.vpu_flops for m in machines)
    vmem_bytes = f(m.vmem_bytes for m in machines)
    overhead_s = f(m.grid_step_overhead_s for m in machines)
    peak = np.where(bf16[:, None],
                    f(m.peak_flops_bf16 for m in machines)[None, :],
                    f(m.peak_flops_f32 for m in machines)[None, :])

    C, M = len(structs), len(machines)
    hbm_time = hbm_bytes[:, None] / hbm_bw[None, :]
    mxu_time = (n_steps * mxu_flops)[:, None] / peak
    vpu_time = (n_steps * vpu_elems)[:, None] / vpu_flops[None, :]
    vmem_time = vmem_touch[:, None] / vmem_bw[None, :]
    compute = mxu_time + vpu_time
    three = np.stack([compute,
                      np.broadcast_to(hbm_time, (C, M)),
                      np.broadcast_to(vmem_time, (C, M))])
    total = three.max(axis=0) + n_steps[:, None] * overhead_s[None, :]
    # scalar limiter: {compute: MXU/VPU, hbm: HBM, vmem: VMEM}[max] — among
    # equal maxima the last-inserted key's label survives the dict collapse
    last_max = 2 - np.argmax(three[::-1], axis=0)
    limiter_idx = np.where(
        last_max == 0, np.where(mxu_time >= vpu_time, 0, 1),
        np.where(last_max == 1, 2, 3))
    feasible = vmem_alloc[:, None] <= vmem_bytes[None, :]
    return total, limiter_idx, feasible


def estimate_pallas(spec: PallasKernelSpec, machine: TPUMachine = TPU_V5E) -> PallasEstimate:
    n_steps = math.prod(spec.grid) if spec.grid else 1

    # ---- HBM traffic via revisit analysis ------------------------------
    hbm_bytes, per_op = hbm_traffic(spec)
    hbm_time = hbm_bytes / machine.hbm_bw

    # ---- VMEM residency (layer condition as feasibility) ---------------
    vmem_alloc = spec.scratch_bytes
    for op in spec.operands:
        vmem_alloc += op.vmem_block_bytes(machine) * op.n_buffers
    feasible = vmem_alloc <= machine.vmem_bytes

    # ---- compute issue model -------------------------------------------
    mxu_flops = sum(m.padded_flops(machine, spec.elem_bytes) for m in spec.matmuls_per_step)
    mxu_time = n_steps * mxu_flops / machine.peak_flops(spec.elem_bytes)
    vpu_elems = spec.vpu_elems_per_step
    if spec.vpu_shape and len(spec.vpu_shape) >= 2:
        sub = machine.sublane_elems(spec.elem_bytes)
        pad = (
            _roundup(spec.vpu_shape[-2], sub)
            * _roundup(spec.vpu_shape[-1], machine.vpu_lanes)
        ) / max(spec.vpu_shape[-2] * spec.vpu_shape[-1], 1)
        vpu_elems *= pad
    vpu_time = n_steps * vpu_elems / machine.vpu_flops

    # ---- VMEM<->VREG traffic -------------------------------------------
    vmem_touch = sum(op.block_bytes() for op in spec.operands) * n_steps
    vmem_time = vmem_touch / machine.vmem_bw

    compute = mxu_time + vpu_time
    overhead = n_steps * machine.grid_step_overhead_s
    total = max(compute, hbm_time, vmem_time) + overhead
    limiter = {
        compute: "MXU" if mxu_time >= vpu_time else "VPU",
        hbm_time: "HBM",
        vmem_time: "VMEM",
    }[max(compute, hbm_time, vmem_time)]
    return PallasEstimate(
        kernel=spec.name,
        hbm_bytes=hbm_bytes,
        hbm_time=hbm_time,
        mxu_time=mxu_time,
        vpu_time=vpu_time,
        vmem_time=vmem_time,
        vmem_alloc_bytes=vmem_alloc,
        grid_overhead=overhead,
        total_time=total,
        limiter=limiter,
        feasible=feasible,
        work=spec.work_per_step * n_steps,
        detail={"per_operand": per_op, "n_steps": n_steps},
    )


@dataclass
class RankedPallasConfig:
    config: dict
    spec: PallasKernelSpec
    estimate: PallasEstimate


def select_pallas_config(
    candidates: Iterable[tuple],
    machine: TPUMachine = TPU_V5E,
    top_k: int | None = None,
    engine=None,
) -> list[RankedPallasConfig]:
    """Rank (config_dict, PallasKernelSpec) candidates by predicted time.

    Routes through the exploration engine (``repro_torch.core.engine``),
    which memoizes per-spec estimates across sweeps: infeasible candidates
    (VMEM oversubscription — the violated layer condition) are recorded in
    the engine report's ``skipped`` list with their reason; ties break
    toward smaller VMEM footprints.  Pass an ``Explorer`` as ``engine`` to
    share its cache across calls.  ``top_k`` runs the engine's
    bound-then-refine search (HBM-volume time floors prune before full
    estimates) — the returned head is bitwise identical to exhaustive
    ranking, but a candidate pruned by its bound lands in
    ``report.pruned`` without its estimate ever running, so VMEM
    infeasibility beyond the top-k may go undiagnosed; use an exhaustive
    ranking to audit the layer condition.
    """
    from .engine import Explorer

    candidates = list(candidates)
    explorer = engine or Explorer()
    report = explorer._rank_pallas(candidates, machine, top_k=top_k)
    ranked = [
        RankedPallasConfig(r.config, candidates[r.index][1], r.estimate)
        for r in report.entries
    ]
    return ranked[:top_k] if top_k else ranked


def pow2_tiles(lo: int, hi: int) -> list[int]:
    """Powers of two from ``lo`` up to ``hi`` (the TPU generators' block
    sizes)."""
    out = []
    t = lo
    while t <= hi:
        out.append(t)
        t *= 2
    return out
