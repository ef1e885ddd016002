"""Design-space sweeps: parametric machine grids + Pareto-frontier reports.

The paper's §1.1 promises "performance comparison of different GPU models,
including hypothetical GPUs for architectural exploration".  This module
turns the Explorer's machine axis into a design-space instrument (DESIGN.md
§11): generators produce dense grids of hypothetical machines around real
anchors — rate variants (cache size x bandwidth x clock scalings) share
their anchor's geometry, so the engine prices structure once per geometry
and replays the batched rate stage per variant — and the Pareto report
answers "what hardware does this workload want": the best machine per
workload at each bandwidth/capacity budget.

Typical use::

    from repro_torch.core.designspace import paper_design_grid, design_space_sweep
    machines = paper_design_grid()              # 1000+ variants, 3 geometries
    report = design_space_sweep([workload], machines, top_k=5)
    print(pareto_table(pareto_frontier(report, machines)))

A copy of ``repro.core.designspace`` over the port's engine; numpy-only.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field as dc_field

from .machines import A100, H100, TPU_V5E, V100, GPUMachine, TPUMachine


def _fmt_scale(s: float) -> str:
    return f"{s:g}"


# --------------------------------------------------------------------------
# machine-grid generators
# --------------------------------------------------------------------------
def gpu_rate_grid(base: GPUMachine, *,
                  l2_scales=(0.5, 1.0, 2.0),
                  dram_bw_scales=(0.5, 1.0, 2.0),
                  l2_bw_scales=(1.0,),
                  clock_scales=(1.0,),
                  l1_scales=(1.0,)) -> list[GPUMachine]:
    """Dense cache-size x bandwidth x clock grid around ``base``.

    Every variant keeps ``base``'s geometry (SM count, occupancy limit,
    sector/line granularity), so the whole grid shares one structural
    equivalence class; names encode the scalings and stay unique.
    """
    out = []
    for l2 in l2_scales:
        for dram in dram_bw_scales:
            for l2bw in l2_bw_scales:
                for clk in clock_scales:
                    for l1 in l1_scales:
                        out.append(dataclasses.replace(
                            base,
                            name=(f"{base.name}"
                                  f"@l2x{_fmt_scale(l2)}"
                                  f"-dramx{_fmt_scale(dram)}"
                                  f"-l2bwx{_fmt_scale(l2bw)}"
                                  f"-clkx{_fmt_scale(clk)}"
                                  f"-l1x{_fmt_scale(l1)}"),
                            l2_bytes=int(base.l2_bytes * l2),
                            dram_bw=base.dram_bw * dram,
                            l2_bw=base.l2_bw * l2bw,
                            clock_hz=base.clock_hz * clk,
                            l1_bytes=int(base.l1_bytes * l1),
                        ))
    return out


def h100_class_grid(*, partitioned_l2=(True, False),
                    bulk_copy=(False, True),
                    dram_bw_scales=(0.75, 1.0, 1.25)) -> list[GPUMachine]:
    """H100-class architectural variants — the natural post-A100 knobs.

    ``partitioned_l2``: False models a unified 50MB L2 (no §3 halving) —
    a rate-side change, sharing the partitioned variant's structure.
    ``bulk_copy``: True models TMA-style 128B bulk transactions by lifting
    the DRAM sector granularity to a full line — a *geometry* change, so
    those variants form their own structural class.
    """
    out = []
    for part in partitioned_l2:
        for bulk in bulk_copy:
            for dram in dram_bw_scales:
                m = dataclasses.replace(
                    H100,
                    name=(f"H100-class@{'split' if part else 'unified'}L2"
                          f"-{'tma128' if bulk else 'sect32'}"
                          f"-dramx{_fmt_scale(dram)}"),
                    l2_bytes=H100.l2_bytes if part else 2 * H100.l2_bytes,
                    sector_bytes=128 if bulk else 32,
                    dram_bw=H100.dram_bw * dram,
                )
                out.append(m)
    return out


def tpu_rate_grid(base: TPUMachine = TPU_V5E, *,
                  hbm_bw_scales=(0.5, 1.0, 2.0),
                  vmem_scales=(0.5, 1.0, 2.0),
                  flops_scales=(1.0,)) -> list[TPUMachine]:
    """HBM-bandwidth x VMEM-capacity x FLOP-peak grid around ``base``.

    All variants share ``base``'s tile geometry (lanes/sublanes/MXU), so
    Pallas structural pricing is shared across the grid.
    """
    out = []
    for hbm in hbm_bw_scales:
        for vmem in vmem_scales:
            for fl in flops_scales:
                out.append(dataclasses.replace(
                    base,
                    name=(f"{base.name}@hbmx{_fmt_scale(hbm)}"
                          f"-vmemx{_fmt_scale(vmem)}"
                          f"-flopsx{_fmt_scale(fl)}"),
                    hbm_bw=base.hbm_bw * hbm,
                    vmem_bytes=int(base.vmem_bytes * vmem),
                    peak_flops_bf16=base.peak_flops_bf16 * fl,
                    peak_flops_f32=base.peak_flops_f32 * fl,
                    vpu_flops=base.vpu_flops * fl,
                ))
    return out


_SEVEN = (0.25, 0.5, 0.75, 1.0, 1.5, 2.0, 4.0)


def paper_design_grid(bases=(V100, A100, H100), *,
                      l2_scales=_SEVEN, dram_bw_scales=_SEVEN,
                      l2_bw_scales=_SEVEN) -> list[GPUMachine]:
    """The bench's 1000+-variant grid: per paper-anchored base geometry, a
    dense 7 x 7 x 7 (L2 size x DRAM bw x L2 bw) rate grid — 343 variants
    per base, 1029 for the default three bases, plus the bases themselves
    (1032 machines, 3 structural equivalence classes)."""
    out = list(bases)
    for base in bases:
        out.extend(gpu_rate_grid(base, l2_scales=l2_scales,
                                 dram_bw_scales=dram_bw_scales,
                                 l2_bw_scales=l2_bw_scales))
    return out


# --------------------------------------------------------------------------
# sweep + Pareto report
# --------------------------------------------------------------------------
def design_space_sweep(workloads, machines, *, top_k: int = 10,
                       explorer=None, configs=None,
                       progress=None):
    """Price ``workloads`` on a machine grid through the batched machine
    axis; returns the ``ExplorationReport`` (per-geometry share counters in
    ``report.cache_stats``)."""
    from .engine import Explorer

    explorer = explorer or Explorer(parallel=True)
    return explorer._explore(workloads, machines, configs, top_k=top_k,
                             progress=progress, machine_axis=True)


@dataclass(frozen=True)
class ParetoPoint:
    """One non-dominated machine for a workload: no cheaper-or-equal
    machine (by bandwidth and capacity budget) predicts equal-or-better
    performance."""

    machine: str
    bandwidth: float        # DRAM/HBM bandwidth budget (B/s)
    capacity: int           # L2 (GPU) / VMEM (TPU) capacity budget (bytes)
    perf: float             # best predicted work/s on this machine
    config: object          # the winning configuration
    limiter: str


def _budget_axes(machine) -> tuple:
    if isinstance(machine, GPUMachine):
        return machine.dram_bw, machine.l2_bytes
    if isinstance(machine, TPUMachine):
        return machine.hbm_bw, machine.vmem_bytes
    raise TypeError(f"no budget axes for {type(machine).__name__}")


def pareto_frontier(report, machines, workload: str | None = None) -> dict:
    """Per-workload Pareto frontiers over (bandwidth, capacity) budgets.

    A machine is on the frontier iff no other machine with
    bandwidth <= and capacity <= (one strictly <) achieves perf >=.
    Exact ties — distinct machines with identical budgets AND identical
    predicted perf (common on dense grids where a knob, e.g. L2 bandwidth,
    is not the limiter anywhere) — collapse to one representative, the
    lexicographically first machine name.  Returns ``{workload:
    [ParetoPoint, ...]}`` sorted by ascending bandwidth — "the best
    machine per workload at each budget".
    """
    by_name = {m.name: m for m in machines}
    frontiers: dict = {}
    workload_names = {e.workload for e in report.entries}
    if workload is not None:
        workload_names &= {workload}
    for wname in sorted(workload_names):
        points = []
        for e in report.entries:
            if e.workload != wname:
                continue
            m = by_name.get(e.machine)
            if m is None:
                continue
            # entries are ranked per cell: keep the first (best) per machine
            if any(p.machine == e.machine for p in points):
                continue
            bw, cap = _budget_axes(m)
            points.append(ParetoPoint(e.machine, bw, cap, e.perf,
                                      e.config, e.limiter))
        representative: dict = {}
        for p in sorted(points, key=lambda p: p.machine):
            representative.setdefault((p.bandwidth, p.capacity, p.perf), p)
        points = list(representative.values())
        frontier = [
            p for p in points
            if not any(
                q.bandwidth <= p.bandwidth and q.capacity <= p.capacity
                and q.perf >= p.perf
                and (q.bandwidth < p.bandwidth or q.capacity < p.capacity
                     or q.perf > p.perf)
                for q in points)
        ]
        frontier.sort(key=lambda p: (p.bandwidth, p.capacity, p.machine))
        frontiers[wname] = frontier
    return frontiers


def pareto_table(frontiers: dict) -> str:
    """Text table of ``pareto_frontier`` output."""
    rows = [("workload", "machine", "bw [GB/s]", "cap [MiB]",
             "perf [work/s]", "limiter")]
    for wname, points in frontiers.items():
        for p in points:
            rows.append((wname, p.machine, f"{p.bandwidth / 1e9:.0f}",
                         f"{p.capacity / 2**20:.1f}", f"{p.perf:.3e}",
                         p.limiter))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines)
