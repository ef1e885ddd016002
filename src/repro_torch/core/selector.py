"""Configuration selection — the autotuning replacement (paper §1.1, §5).

Given a kernel spec, enumerate the candidate launch configurations (thread
block shapes x thread-folding factors), price every candidate with the
analytical estimator, and return the ranking.  Evaluation is pure math — no
code generation, no compilation, no benchmarking, no hardware.

A copy of the GPU half of ``repro.core.selector``.  Ranking routes through
the port's exploration engine (``repro_torch.core.engine``), as the
reference's does: the staged, memoized pipeline produces estimates bitwise
equal to direct ``estimate_gpu`` calls while sharing structural work across
configurations, optionally in a worker pool (which never forks a process
that has started CUDA) and optionally pruned to a top-k.  Order and
tie-breaking: descending predicted performance, ties to the configuration
enumerated first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

from .access import KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .engine import Explorer, SkippedConfig  # noqa: F401  (the generators' skip records)
from .machines import GPUMachine
from .perfmodel import GPUEstimate


def paper_block_sizes(total_threads: int = 1024) -> list[tuple]:
    """The paper's data-point grid (§5.1, eq. 6): X,Y in powers of two up to
    1024, Z up to 64, X*Y*Z = total_threads."""
    xs = [1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024]
    zs = [1, 2, 4, 8, 16, 32, 64]
    out = []
    for x in xs:
        for y in xs:
            for z in zs:
                if x * y * z == total_threads:
                    out.append((x, y, z))
    return out


def paper_foldings() -> list[tuple]:
    """No folding, 2x in y, 2x in z (§5.2)."""
    return [(1, 1, 1), (1, 2, 1), (1, 1, 2)]


@dataclass
class RankedConfig:
    launch: LaunchConfig
    estimate: GPUEstimate

    @property
    def perf(self) -> float:
        return self.estimate.perf_lups


def enumerate_gpu_configs(
    total_threads: int = 1024,
    foldings: Sequence[tuple] | None = None,
) -> list[LaunchConfig]:
    cfgs = []
    for blk in paper_block_sizes(total_threads):
        for fold in foldings or paper_foldings():
            cfgs.append(LaunchConfig(block=blk, folding=fold))
    return cfgs


class RankingResult(list):
    """``list[RankedConfig]`` (best first) that also carries the engine's
    exploration report: ``.skipped`` records every configuration that could
    not be priced together with its reason (nothing is silently swallowed;
    a generator appends the variants it does not rank), ``.pruned`` every
    configuration a ``top_k`` search proved out of the top-k from its bound
    alone, ``.report`` is the full ``ExplorationReport``.

    ``skipped`` defaults to a copy of the report's, so a caller that
    extends it leaves the report as it was."""

    def __init__(self, ranked=(), report=None, skipped=None):
        super().__init__(ranked)
        self.report = report
        if skipped is None:
            skipped = report.skipped if report is not None else ()
        self.skipped = list(skipped)

    @property
    def pruned(self) -> list:
        return self.report.pruned if self.report is not None else []

    @property
    def cache_stats(self) -> dict:
        """Invariant-cache hits/misses/entries plus pruned/evaluated config
        counts of the engine sweep that produced this ranking (per-sweep
        deltas)."""
        return self.report.cache_stats if self.report is not None else {}


def rank_gpu_configs(
    spec: KernelSpec,
    machine: GPUMachine,
    configs: Iterable[LaunchConfig] | None = None,
    capacity: CapacityModel | None = None,
    total_threads: int = 1024,
    progress: Callable | None = None,
    *,
    strict: bool = False,
    engine=None,
    parallel: bool = False,
    top_k: int | None = None,
) -> RankingResult:
    """Rank configurations by predicted performance, best first.

    Runs on the exploration engine (results are bitwise-identical to serial
    ``estimate_gpu`` calls).  ``strict=True`` re-raises the first estimation
    error instead of recording the config under ``result.skipped``.  Pass an
    ``engine`` (``repro_torch.core.engine.Explorer``) to share its invariant
    cache across calls, or ``parallel=True`` for a pooled one-off sweep.
    ``top_k`` runs the tiered bound-then-refine search instead of exhaustive
    pricing: the result is truncated to the top-k (bitwise identical to the
    exhaustive head) and bound-eliminated configs land in ``.pruned``.
    """
    explorer = engine or Explorer(parallel=parallel)
    report = explorer._rank_gpu(
        spec, machine, configs, capacity=capacity,
        total_threads=total_threads, strict=strict, top_k=top_k,
        progress=progress,
    )
    return RankingResult(
        (RankedConfig(r.config, r.estimate) for r in report.entries), report
    )


def select_gpu_config(
    spec: KernelSpec, machine: GPUMachine, **kw
) -> RankedConfig:
    ranked = rank_gpu_configs(spec, machine, **kw)
    if not ranked:
        raise RuntimeError("no feasible configuration")
    return ranked[0]


def ranking_quality(predicted: Sequence, measured: Sequence) -> dict:
    """How well a predicted ranking matches a measured one.

    The paper's success criterion (§5.8) is not exact argmax recovery but
    distinguishing well- from badly-performing configs: we report the measured
    performance of the predicted-best config relative to the true best
    ("efficiency"), plus Spearman rank correlation.
    """
    n = len(predicted)
    if n == 0:
        return {"efficiency": 0.0, "spearman": 0.0}
    best_measured = max(measured)
    eff = measured[max(range(n), key=lambda i: predicted[i])] / best_measured

    def ranks(v):
        order = sorted(range(n), key=lambda i: v[i])
        r = [0] * n
        for rank, i in enumerate(order):
            r[i] = rank
        return r

    rp, rm = ranks(predicted), ranks(measured)
    mp = sum(rp) / n
    mm = sum(rm) / n
    num = sum((a - mp) * (b - mm) for a, b in zip(rp, rm))
    den = math.sqrt(
        sum((a - mp) ** 2 for a in rp) * sum((b - mm) ** 2 for b in rm)
    )
    return {"efficiency": eff, "spearman": num / den if den else 0.0}
