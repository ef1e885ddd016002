"""Unified exploration engine: staged, memoized, parallel, pruned search.

The paper's workflow (fig. 1) prices one configuration; this subsystem prices
*spaces* — the full eq.-6 grid, multiple kernels, multiple (including
hypothetical) machines — behind the unified ``repro_torch.api`` facade:

    from repro_torch.api import PriceRequest, price
    from repro_torch.core.engine import Workload

    result = price(PriceRequest(
        workloads=[Workload("stencil", gpu_spec=spec, tpu_candidates=cands)],
        machines=["H100", "A100", "TPUv5e"],
    ))
    print(result.report.comparison_table())

``top_k=...`` turns any sweep into a tiered bound-then-refine search (same
top-k results, a fraction of the structural work); ``cache_path=...`` makes
the invariant cache persistent, so warm re-runs skip structural work
entirely.  See DESIGN.md §5 for the architecture and the ``Estimator``
protocol contract backends implement.

A copy of ``repro.core.engine``.  Its pool never forks a process that has
started CUDA (``pool._context``), and its persistent files carry magics of
their own, so the port and the reference never read each other's.
"""
from .backends import GPUBackend, PallasBackend
from .explorer import Explorer, Workload
from .invariants import ENGINE_CACHE_VERSION, InvariantCache
from .pool import PoisonTaskError, TaskPool, default_workers
from .protocol import (
    Estimator,
    EvalResult,
    ExplorationReport,
    PrunedConfig,
    RejectedSpec,
    SkipConfig,
    SkippedConfig,
    Task,
)

__all__ = [
    "Explorer", "Workload",
    "GPUBackend", "PallasBackend",
    "InvariantCache", "ENGINE_CACHE_VERSION",
    "TaskPool", "PoisonTaskError", "default_workers",
    "Estimator", "EvalResult", "ExplorationReport",
    "SkipConfig", "SkippedConfig", "PrunedConfig", "RejectedSpec", "Task",
]
