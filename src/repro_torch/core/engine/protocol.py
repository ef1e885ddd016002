"""Backend-agnostic exploration contract (DESIGN.md §5).

The paper's promise — "quick exploration of large configuration spaces" — is
made concrete here as a small protocol every estimator backend implements.
A backend splits pricing one configuration into

  * **structural tasks**: pure, expensive computations (grid walks, footprint
    unions, wave counting) identified by a *structural key*; configurations
    and machines that share a key share the computation, and tasks are safe
    to evaluate in a worker pool, and
  * **combine**: cheap arithmetic (capacity hit-rates, limiter minima) that
    folds resolved task values into a final estimate.

The ``Explorer`` (engine.explorer) drives the stages; backends never need to
know about caching or parallelism.  A copy of ``repro.core.engine.protocol``.
"""
from __future__ import annotations

from collections import Counter
from dataclasses import dataclass, field as dc_field
from typing import Any, Callable, Hashable, Mapping, Protocol, Sequence, runtime_checkable


@dataclass(frozen=True)
class Task:
    """One structural computation: ``fn(*args)`` cached under ``key``.

    ``fn`` must be a module-level callable (picklable) and a pure function of
    ``args``; ``key`` must capture everything the result depends on.
    """

    key: Hashable
    fn: Callable
    args: tuple


class SkipConfig(Exception):
    """Raised by a backend's ``combine`` to drop a configuration with a
    recorded reason (e.g. a violated feasibility constraint)."""


@dataclass(frozen=True)
class RejectedSpec:
    """Stand-in for a spec a frontend could not produce (e.g. the tracer
    rejected a non-affine kernel).  Backends turn it into a recorded skip
    with the stored reason, so rejection diagnostics flow through
    ``report.skipped`` exactly like violated feasibility constraints."""

    name: str
    reason: str


@dataclass
class EvalResult:
    """One priced configuration, comparable across backends via ``perf``
    (work units per second, higher is better)."""

    workload: str
    machine: str
    backend: str
    index: int                # enumeration order within the cell
    config: Any               # LaunchConfig (GPU) or config dict (Pallas)
    estimate: Any             # GPUEstimate or PallasEstimate
    perf: float
    limiter: str


@dataclass
class SkippedConfig:
    """A configuration the engine could not (or refused to) price."""

    workload: str
    machine: str
    config: Any
    reason: str


@dataclass
class PrunedConfig:
    """A configuration the tiered search proved out of the top-k without
    refining it: its lower bound on predicted time already exceeded the
    ``threshold`` (the k-th best fully refined time when it was cut)."""

    workload: str
    machine: str
    config: Any
    bound: float
    threshold: float


@runtime_checkable
class Estimator(Protocol):
    """What the Explorer requires of a backend (contract in DESIGN.md §5)."""

    name: str

    def structural_tasks(self, item: Any, machine: Any) -> Sequence[Task]:
        """Structural computations needed to price ``item`` on ``machine``."""
        ...

    def combine(self, item: Any, machine: Any,
                values: Mapping[Hashable, Any]) -> tuple:
        """Fold resolved task values into ``(config, estimate, perf,
        limiter)``.  May raise ``SkipConfig`` (or ValueError/RuntimeError)
        to drop the configuration."""
        ...

    def sort_key(self, result: EvalResult) -> tuple:
        """Ranking key, best first (applied with a stable sort over
        enumeration order)."""
        ...

    # ---- optional: tiered bound-then-refine search (DESIGN.md §5) ------
    # A backend that additionally implements the four methods below opts
    # into branch-and-bound pruning when the caller requests a ``top_k``.
    # The engine only ever prunes a configuration whose *lower bound* on
    # primary time strictly exceeds the k-th best fully refined time, so
    # the returned top-k ranking is bitwise identical to exhaustive search
    # for any sound bound.
    #
    # def bound_tasks(self, item, machine) -> Sequence[Task]:
    #     """Cheap tasks (closed-form volumes, no grid walk / wave model)
    #     the prune stage resolves inline before any pool work.  Their
    #     values flow into ``tier_bound`` and later into ``combine``."""
    #
    # def tiers(self, item, machine) -> Sequence[Sequence[Task]]:
    #     """Ordered partition of the remaining structural tasks, cheapest
    #     signal first; ``tier_bound`` is re-evaluated after each tier so
    #     the bound tightens as structure resolves.  The union of
    #     ``bound_tasks`` and all tiers must equal ``structural_tasks``."""
    #
    # def tier_bound(self, item, machine, values) -> float:
    #     """Sound lower bound on the item's primary time given whatever
    #     task values are present in ``values`` (monotonically tightening
    #     as more keys resolve)."""
    #
    # def primary_time(self, result: EvalResult) -> float:
    #     """The ascending scalar ``tier_bound`` bounds (e.g. predicted
    #     time per work unit); must order identically to the leading
    #     component of ``sort_key``."""


@dataclass
class ExplorationReport:
    """Structured result of an exploration sweep.

    ``entries`` hold every feasible priced configuration, ranked within each
    (workload, machine) cell (truncated to ``top_k`` per cell when the sweep
    ran with one); ``skipped`` records every configuration dropped with an
    error reason, and ``pruned`` every configuration the tiered search
    proved out of the top-k from its bound alone — nothing is silently
    swallowed.  ``cache_stats`` carries per-sweep deltas: invariant-cache
    ``hits``/``misses``/``entries``, ``pool_tasks`` (structural tasks
    actually evaluated), ``bound_evals`` (cheap bound-stage evaluations),
    ``evaluated``/``pruned`` configuration counts, and the cache-metric
    core counters (DESIGN §10, process-local): ``streams_built`` /
    ``streams_shared`` stream-table constructions vs memo hits, and
    ``waves_folded`` / ``wave_fallbacks`` simulator waves served by pure
    translation vs rebuilt per block.

    ``metrics`` (DESIGN.md §14) carries the same per-sweep deltas under
    their canonical dotted names (``engine.cache.hits``,
    ``engine.sweep.evaluated``, ``pool.health.rebuilds``, ...);
    ``cache_stats`` is the backward-compatible view derived from it
    (``repro_torch.obs.metrics.cache_stats_view``).  Appended last so older
    serialized reports decode with an empty mapping.
    """

    entries: list = dc_field(default_factory=list)        # list[EvalResult]
    skipped: list = dc_field(default_factory=list)        # list[SkippedConfig]
    pruned: list = dc_field(default_factory=list)         # list[PrunedConfig]
    cache_stats: dict = dc_field(default_factory=dict)
    wall_time_s: float = 0.0
    metrics: dict = dc_field(default_factory=dict)

    # ---- structure -----------------------------------------------------
    def cells(self) -> list:
        """Distinct (workload, machine) pairs, in first-seen order."""
        seen, out = set(), []
        for e in self.entries:
            k = (e.workload, e.machine)
            if k not in seen:
                seen.add(k)
                out.append(k)
        return out

    def ranking(self, workload: str | None = None,
                machine: str | None = None) -> list:
        return [
            e for e in self.entries
            if (workload is None or e.workload == workload)
            and (machine is None or e.machine == machine)
        ]

    def best(self, workload: str | None = None, machine: str | None = None):
        r = self.ranking(workload, machine)
        return r[0] if r else None

    def skipped_for(self, workload: str | None = None,
                    machine: str | None = None) -> list:
        return [
            s for s in self.skipped
            if (workload is None or s.workload == workload)
            and (machine is None or s.machine == machine)
        ]

    def pruned_for(self, workload: str | None = None,
                   machine: str | None = None) -> list:
        return [
            p for p in self.pruned
            if (workload is None or p.workload == workload)
            and (machine is None or p.machine == machine)
        ]

    @property
    def prune_rate(self) -> float:
        """Fraction of refinable configurations eliminated by bounds alone.

        Derived from the canonical per-sweep metrics (``entries`` is
        truncated to top-k, so counting it would overstate pruning whenever
        more than k configs were fully evaluated; the old ``len(entries)``
        fallback had exactly that bug on reports whose ``cache_stats`` view
        was stripped).  ``cache_stats`` is consulted for hand-built /
        legacy-decoded reports that never carried ``metrics``."""
        pruned = self.metrics.get(
            "engine.sweep.pruned",
            self.cache_stats.get("pruned", len(self.pruned)))
        evaluated = self.metrics.get(
            "engine.sweep.evaluated",
            self.cache_stats.get("evaluated", len(self.entries)))
        total = evaluated + pruned
        return pruned / total if total else 0.0

    # ---- attribution ---------------------------------------------------
    def limiter_attribution(self, workload: str | None = None) -> dict:
        """(workload, machine) -> {limiter: config count} over all priced
        configurations — which hardware resource bounds each region of the
        config space (the insight black-box tuning cannot give)."""
        out: dict = {}
        for e in self.entries:
            if workload is not None and e.workload != workload:
                continue
            out.setdefault((e.workload, e.machine), Counter())[e.limiter] += 1
        return {k: dict(v) for k, v in out.items()}

    # ---- presentation --------------------------------------------------
    def comparison_table(self, workload: str | None = None) -> str:
        """Cross-machine comparison of each cell's best configuration."""
        rows = [("workload", "machine", "best config", "perf [work/s]",
                 "limiter", "priced", "skipped")]
        for w, m in self.cells():
            if workload is not None and w != workload:
                continue
            b = self.best(w, m)
            rows.append((
                w, m, _fmt_config(b.config), f"{b.perf:.3e}", b.limiter,
                str(len(self.ranking(w, m))), str(len(self.skipped_for(w, m))),
            ))
        widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
        lines = ["  ".join(c.ljust(wd) for c, wd in zip(r, widths)).rstrip()
                 for r in rows]
        lines.insert(1, "-" * len(lines[0]))
        return "\n".join(lines)

    def summary(self) -> str:
        n_cells = len(self.cells())
        pruned = f", {len(self.pruned)} pruned" if self.pruned else ""
        return (
            f"{len(self.entries)} configs priced across {n_cells} "
            f"(workload, machine) cells, {len(self.skipped)} skipped"
            f"{pruned}; "
            f"invariant cache: {self.cache_stats.get('hits', 0)} hits / "
            f"{self.cache_stats.get('misses', 0)} misses; "
            f"{self.wall_time_s:.2f}s wall"
        )


def _fmt_config(config) -> str:
    # LaunchConfig prints block x folding; dict configs print compactly
    if hasattr(config, "block"):
        return f"{config.block}x{config.folding}"
    if isinstance(config, dict):
        return ",".join(f"{k}={v}" for k, v in config.items())
    return str(config)
