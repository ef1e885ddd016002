"""Design-space sweep through the port: price a dense grid of hypothetical
machines at once.

The port of ``examples/design_space.py``.  Machines factor into a structural
*geometry* and a *rate* key (DESIGN.md §11): every structural quantity —
footprints, grid walks, waves — depends only on the geometry, so the engine
prices structure once per geometry class and runs the rate/limiter stage as
one numpy array program across all machines.  This demo:

1. builds a 60-variant grid around A100 (rate scalings: same geometry),
   plus A100 itself and 12 H100-class architectural variants (TMA-style
   128 B bulk-copy sectors — a *geometry* knob, so those form their own
   class): 73 machines in 3 geometry classes;
2. prices one stencil workload on every machine in a single
   ``machine_axis=True`` sweep, showing the per-geometry share counters;
3. prints the Pareto frontier: the best machine at each
   (DRAM bandwidth, L2 capacity) budget.

Run:  PYTHONPATH=src python examples/torch_design_space.py [--device cpu]

The sweep is host-side pricing, as in the reference.  Like every entry point
of the port it expects the card, and runs without one only when asked with
``--device cpu`` (``main(device="cpu")``); without a card and without it,
the script fails.  Where CUDA has started (``chip_smoke.py``), the pooled
engine starts its workers by ``forkserver``, never by ``fork``.
"""
from __future__ import annotations

import argparse
import sys
import time

from repro_torch.core.designspace import (
    design_space_sweep,
    gpu_rate_grid,
    h100_class_grid,
    pareto_frontier,
    pareto_table,
)
from repro_torch.core.engine import Workload
from repro_torch.core.machines import A100
from repro_torch.core.selector import enumerate_gpu_configs
from repro_torch.core.specs import star_stencil_3d
from repro_torch.kernels import resolve_device

R = 4
DOMAIN = (48, 96, 128)      # (Z, Y, X), as the reference example
TOTAL_THREADS = 512         # the launch space: enumerate_gpu_configs(512)
TOP_K = 3
WORKLOAD = "stencil3d_r4"


def machine_grid() -> list:
    """The reference example's grid: 4 L2 sizes x 5 DRAM rates x 3 L2 rates
    around A100, A100 itself, and ``h100_class_grid()``."""
    return gpu_rate_grid(
        A100,
        l2_scales=(0.25, 0.5, 1.0, 2.0),
        dram_bw_scales=(0.5, 0.75, 1.0, 1.5, 2.0),
        l2_bw_scales=(0.5, 1.0, 2.0),
        clock_scales=(1.0,),
    ) + [A100] + h100_class_grid()


def workload(domain=DOMAIN) -> Workload:
    return Workload(name=WORKLOAD, gpu_spec=star_stencil_3d(r=R, domain=tuple(domain)))


def main(device="cuda", *, machines=None, domain=DOMAIN, configs=None,
         top_k: int = TOP_K, explorer=None) -> dict:
    """Sweep ``machines`` (default: ``machine_grid()``) in one machine-axis
    call and print the report.  ``explorer`` sets the engine (default: the
    pooled one, as ``design_space_sweep``'s).  Returns ``{"report":
    ExplorationReport, "machines", "configs", "frontiers", "table",
    "winner", "seconds"}``; ``seconds`` is the sweep's host time."""
    dev = resolve_device(device)
    machines = machine_grid() if machines is None else list(machines)
    configs = enumerate_gpu_configs(TOTAL_THREADS) if configs is None else list(configs)
    print(f"machine grid: {len(machines)} variants, "
          f"{len({m.geometry for m in machines})} geometry classes (device {dev})")

    t0 = time.perf_counter()
    report = design_space_sweep([workload(domain)], machines, configs=configs,
                                top_k=top_k, explorer=explorer)
    dt = time.perf_counter() - t0

    stats = report.cache_stats
    print(f"\npriced {stats['machines_batched']} machines x {len(configs)} "
          f"configs in {dt:.1f}s ({len(machines) / dt:.0f} machines/s)")
    print(f"geometry groups: {stats['geometry_groups']}; structural tasks "
          f"evaluated: {stats['pool_tasks']} (shared across each class)")
    for label, n in stats["geometry_share"].items():
        print(f"  {n:4d} machines share {label}")

    frontiers = pareto_frontier(report, machines)
    table = pareto_table(frontiers)
    print("\nPareto frontier — best machine per (bandwidth, capacity) budget:")
    print(table)

    best = max(report.entries, key=lambda e: e.perf)
    print(f"\noverall winner: {best.machine} "
          f"block={best.config.block} fold={best.config.folding} "
          f"({best.estimate.perf_lups / 1e9:.1f} GLup/s, limiter={best.limiter})")
    return {"report": report, "machines": machines, "configs": configs,
            "frontiers": frontiers, "table": table, "winner": best, "seconds": dt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs without a card")
    args = ap.parse_args()
    main(device=args.device)
    sys.exit(0)
