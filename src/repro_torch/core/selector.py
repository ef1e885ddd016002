"""Configuration selection — the autotuning replacement (paper §1.1, §5).

Given a kernel spec, enumerate the candidate launch configurations (thread
block shapes x thread-folding factors), price every candidate with the
analytical estimator, and return the ranking.  Evaluation is pure math — no
code generation, no compilation, no benchmarking, no hardware.

A copy of the GPU half of ``repro.core.selector``.  Where the reference
ranks through its exploration engine and process pool, this ranking is a
plain serial loop over ``estimate_gpu``: the engine's estimates are pinned
bitwise equal to that loop, and a serial loop needs no worker processes
(none forked after a CUDA context exists).  Order and tie-breaking match
the engine: descending predicted performance, ties to the configuration
enumerated first.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Iterable, Sequence

from .access import KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .machines import GPUMachine
from .perfmodel import GPUEstimate, estimate_gpu


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


@dataclass
class SkippedConfig:
    """A configuration that could not be priced, with the reason."""

    config: Any
    reason: str


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
    """``list[RankedConfig]`` (best first); ``.skipped`` records every
    configuration that could not be priced together with its reason
    (nothing is silently dropped)."""

    def __init__(self, ranked=(), skipped=()):
        super().__init__(ranked)
        self.skipped = list(skipped)


def rank_gpu_configs(
    spec: KernelSpec,
    machine: GPUMachine,
    configs: Iterable[LaunchConfig] | None = None,
    capacity: CapacityModel | None = None,
    total_threads: int = 1024,
    *,
    strict: bool = False,
) -> RankingResult:
    """Rank configurations by predicted performance, best first.

    ``strict=True`` re-raises the first estimation error instead of
    recording the config under ``result.skipped``.
    """
    capacity = capacity or CapacityModel()
    if configs is None:
        configs = enumerate_gpu_configs(total_threads)
    priced, skipped = [], []
    for index, launch in enumerate(configs):
        try:
            est = estimate_gpu(spec, launch, machine, capacity)
        except (ArithmeticError, ValueError, RuntimeError) as exc:
            if strict:
                raise
            skipped.append(SkippedConfig(launch, f"{type(exc).__name__}: {exc}"))
            continue
        priced.append((-est.perf_lups, index, RankedConfig(launch, est)))
    priced.sort(key=lambda t: t[:2])
    return RankingResult((rc for _, _, rc in priced), skipped)


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
