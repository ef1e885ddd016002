"""Plan pricing and per-model aggregation (DESIGN.md §8).

A copy of ``repro.suite.report``.  ``_price_plans`` lowers a batch of
``ModelPlan``s through ONE ``Explorer._explore_plans`` sweep — every model,
machine, and candidate configuration shares the engine's invariant cache —
and folds the per-cell rankings into ``ModelReport``s: per-workload best
config, count-weighted predicted time, HBM/DRAM traffic, roofline
placement (``core.roofline``), and a ranked machine comparison per model.
The public way in is ``repro_torch.api.price(plan_request(...))``; the
reference's deprecated ``price_plans`` shim is not copied.

GPU cells are priced by the paper's CUDA-core model (``matmul_naive``
address expressions at the machine's measured FP64 rate, also for the
bf16 GEMMs of a plan: the reference's semantics, kept); TPU cells by the
Pallas analytical model.  Within a machine type the comparison is exact;
across types it compares the two analytical models' predictions.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field as dc_field

from repro_torch.core.engine import Explorer
from repro_torch.core.machines import TPUMachine
from repro_torch.core.roofline import RooflineReport, report_from_values

from .lowering import suite_gpu_configs


def machine_kind(machine) -> str:
    return "tpu" if isinstance(machine, TPUMachine) else "gpu"


@dataclass
class WorkloadPricing:
    """Best configuration of one kernel workload on one machine."""

    name: str
    role: str
    count: int
    config: object            # winning config (dict or LaunchConfig)
    time_s: float             # one instance
    limiter: str
    hbm_bytes: float          # one instance
    flops: float              # one instance (useful flops)

    @property
    def total_time_s(self) -> float:
        return self.time_s * self.count


@dataclass
class ModelReport:
    """Aggregate pricing of one (model, shape) plan on one machine."""

    model: str
    shape: str
    machine: str
    rows: list = dc_field(default_factory=list)   # list[WorkloadPricing]
    missing: list = dc_field(default_factory=list)  # workloads w/o feasible cfg
    n_skipped: int = 0
    roofline: RooflineReport | None = None

    @property
    def complete(self) -> bool:
        return not self.missing

    @property
    def time_s(self) -> float:
        return sum(r.total_time_s for r in self.rows)

    @property
    def flops(self) -> float:
        return sum(r.flops * r.count for r in self.rows)

    @property
    def hbm_bytes(self) -> float:
        return sum(r.hbm_bytes * r.count for r in self.rows)

    @property
    def roofline_fraction(self) -> float:
        """Roofline bound over predicted time: how close the kernel-level
        plan comes to the machine's aggregate compute/memory ceiling."""
        if self.roofline is None or self.time_s <= 0:
            return 0.0
        return self.roofline.t_bound / self.time_s

    def limiter_counts(self) -> dict:
        out: dict = {}
        for r in self.rows:
            out[r.limiter] = out.get(r.limiter, 0) + 1
        return out

    def by_role(self) -> dict:
        """role -> summed predicted time (the per-layer cost breakdown)."""
        out: dict = {}
        for r in self.rows:
            out[r.role] = out.get(r.role, 0.0) + r.total_time_s
        return out

    def to_row(self) -> dict:
        # normalized summary row: raw SI units throughout ("flops",
        # "hbm_bytes"), same field names the engine's EvalResult/roofline
        # vocabulary uses — unit scaling belongs to presentation layers
        rf = self.roofline
        return {
            "model": self.model,
            "shape": self.shape,
            "machine": self.machine,
            "time_s": self.time_s,
            "flops": self.flops,
            "hbm_bytes": self.hbm_bytes,
            "dominant": rf.dominant if rf else "n/a",
            "roofline_fraction": self.roofline_fraction,
            "limiters": self.limiter_counts(),
            "complete": self.complete,
            "missing": list(self.missing),
            "n_workloads": len(self.rows),
            "n_skipped": self.n_skipped,
        }


@dataclass
class SuiteReport:
    """Every (model, machine) ModelReport of one suite sweep."""

    reports: dict = dc_field(default_factory=dict)  # (model, machine) -> MR
    cache_stats: dict = dc_field(default_factory=dict)
    wall_time_s: float = 0.0

    def get(self, model: str, machine: str) -> ModelReport | None:
        return self.reports.get((model, machine))

    def models(self) -> list:
        seen: dict = {}
        for (model, _), _r in self.reports.items():
            seen.setdefault(model, None)
        return list(seen)

    def machine_ranking(self, model: str) -> list:
        """[(machine, predicted time)] fastest first for one model."""
        rows = [
            (machine, r.time_s)
            for (m, machine), r in self.reports.items()
            if m == model and r.rows
        ]
        return sorted(rows, key=lambda t: t[1])

    def table(self) -> str:
        rows = [("model", "machine", "time/pass", "TFLOP", "HBM GB",
                 "dominant", "roofl%", "workloads")]
        for model in self.models():
            for machine, t in self.machine_ranking(model):
                r = self.reports[(model, machine)]
                rows.append((
                    model, machine, f"{t*1e3:.2f}ms",
                    f"{r.flops/1e12:.2f}", f"{r.hbm_bytes/1e9:.2f}",
                    r.roofline.dominant if r.roofline else "n/a",
                    f"{100*r.roofline_fraction:.0f}%",
                    f"{len(r.rows)}" + (f" (+{len(r.missing)} missing)"
                                        if r.missing else ""),
                ))
        widths = [max(len(str(row[i])) for row in rows)
                  for i in range(len(rows[0]))]
        lines = ["  ".join(str(c).ljust(w) for c, w in zip(row, widths)).rstrip()
                 for row in rows]
        lines.insert(1, "-" * len(lines[0]))
        return "\n".join(lines)

    def to_json(self) -> dict:
        """Versioned summary view (the shape BENCH_model_suite.json carries);
        ``to_wire``/``from_wire`` give the exact round-trippable form."""
        from repro_torch.serve.schema import SCHEMA_VERSION

        return {
            "schema": {"kind": "suite_report", "version": SCHEMA_VERSION},
            "cells": [r.to_row() for r in self.reports.values()],
            "ranking": {m: [(name, t) for name, t in self.machine_ranking(m)]
                        for m in self.models()},
            "cache_stats": dict(self.cache_stats),
            "wall_time_s": self.wall_time_s,
        }

    def to_wire(self) -> dict:
        """Exact, versioned JSON-safe form (``serve.schema`` codec)."""
        from repro_torch.serve.schema import encode

        return encode(self)

    @classmethod
    def from_wire(cls, obj) -> "SuiteReport":
        from repro_torch.serve.schema import decode

        out = decode(obj)
        if not isinstance(out, cls):
            raise TypeError(f"wire object decodes to {type(out).__name__}, "
                            f"not {cls.__name__}")
        return out


# ==========================================================================
def _roofline_for(name: str, machine, flops: float, hbm_bytes: float,
                  elem_bytes: int = 2) -> RooflineReport:
    """Aggregate roofline placement; GPU machines get the two-term version
    of ``core.roofline`` built from their measured peaks."""
    if isinstance(machine, TPUMachine):
        return report_from_values(
            name, flops=flops, hbm_bytes=hbm_bytes, coll_wire_bytes=0.0,
            n_chips=1, machine=machine, model_flops_total=flops,
            elem_bytes=elem_bytes,
        )
    t_compute = flops / machine.peak_flops_dp
    t_memory = hbm_bytes / machine.dram_bw
    return RooflineReport(
        name=name, flops=flops, hbm_bytes=hbm_bytes,
        coll_payload_bytes=0.0, coll_wire_bytes=0.0,
        t_compute=t_compute, t_memory=t_memory, t_collective=0.0,
        dominant="compute" if t_compute >= t_memory else "memory",
        model_flops=flops, useful_flops_ratio=1.0,
        detail={"t_model_compute": t_compute},
    )


def _price_row(wl, entry, kind) -> WorkloadPricing:
    est = entry.estimate
    if kind == "tpu":
        t = est.total_time
        hbm = est.hbm_bytes
    else:
        points = float(wl.params["M"]) * wl.params["K"] * wl.params["N"]
        t = points / est.perf_lups
        hbm = (est.dram_load_per_lup + est.dram_store_per_lup) * points
    return WorkloadPricing(
        name=wl.name, role=wl.role, count=wl.count, config=entry.config,
        time_s=t, limiter=entry.limiter, hbm_bytes=hbm, flops=wl.flops(),
    )


def suite_from_report(plans: dict, machines, report) -> SuiteReport:
    """Fold one engine ``ExplorationReport`` (plan workloads namespaced as
    ``"<model>::<workload>"``) into per-(model, machine) ``ModelReport``s.

    Shared by the in-process path (``_price_plans``) and
    ``repro_torch.api.price`` — a sweep that mixed suite plans with other
    requests folds the same way, reading only its own namespaced entries.
    """
    suite = SuiteReport(cache_stats=dict(report.cache_stats),
                        wall_time_s=report.wall_time_s)
    # index entries/skips once: (workload name, machine) -> best entry
    best: dict = {}
    for e in report.entries:
        best.setdefault((e.workload, e.machine), e)  # entries are ranked
    n_skip: dict = {}
    for s in report.skipped:
        n_skip[(s.workload, s.machine)] = n_skip.get(
            (s.workload, s.machine), 0) + 1

    for name, plan in plans.items():
        for machine in machines:
            kind = machine_kind(machine)
            mr = ModelReport(model=name, shape=plan.shape.name,
                             machine=machine.name)
            for wl in plan.workloads:
                if kind not in wl.backends:
                    continue
                key = (f"{name}::{wl.name}", machine.name)
                mr.n_skipped += n_skip.get(key, 0)
                entry = best.get(key)
                if entry is None:
                    mr.missing.append(wl.name)
                    continue
                mr.rows.append(_price_row(wl, entry, kind))
            mr.roofline = _roofline_for(
                f"{name}/{plan.shape.name}/{machine.name}",
                machine, mr.flops, mr.hbm_bytes)
            suite.reports[(name, machine.name)] = mr
    return suite


def _price_plans(plans: dict, machines, *, explorer: Explorer | None = None,
                 gpu_configs=None, strict: bool = False,
                 top_k: int | None = None, progress=None) -> SuiteReport:
    """Price ``{name: ModelPlan}`` on every machine in one engine sweep.

    ``top_k`` switches the sweep to the engine's tiered bound-then-refine
    search (the suite only consumes each cell's best config, so ``top_k=1``
    yields identical reports while skipping most structural work on fresh
    caches); ``progress(done, total)`` observes per-config completion.
    Pass ``explorer=Explorer(parallel=True, cache_path=...)`` to persist the
    invariant cache across runs — a warm re-run of the whole suite then
    skips essentially all structural evaluation.
    """
    t0 = time.perf_counter()
    explorer = explorer or Explorer(parallel=True)
    gpu_configs = gpu_configs or suite_gpu_configs()
    engine_plans = {
        name: plan.engine_workloads(gpu_configs)
        for name, plan in plans.items()
    }
    report = explorer._explore_plans(engine_plans, machines, strict=strict,
                                     top_k=top_k, progress=progress)
    suite = suite_from_report(plans, machines, report)
    # wall time covers lowering + folding, not just the engine sweep
    suite.wall_time_s = time.perf_counter() - t0
    return suite

