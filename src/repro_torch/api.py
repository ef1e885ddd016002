"""The unified pricing API: one request schema, one result schema.

Every way of asking the estimator a question — a GPU ``KernelSpec`` with
launch configs, ``(config, PallasKernelSpec)`` candidates, engine
``Workload``s, suite ``ModelPlan``s / ``PlanRef``s, traced Triton kernels —
is a ``PriceRequest``; every answer is a ``PriceResult``.
The same frozen dataclasses travel in-process (``price(request)``) and
through the wire codec (``repro_torch.serve.schema``), so an encoded
answer decodes to the same result.

    from repro_torch.api import gpu_request, price

    result = price(gpu_request(spec, "H100", top_k=5))
    for e in result.ranking():
        print(e.config, e.perf, e.limiter)

A copy of ``repro.api``; ``kernel_request`` traces a Triton launcher
(``repro_torch.frontend``) where the reference's traces a Pallas builder,
into the same payload.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

from repro_torch.core.engine import Explorer, Workload
from repro_torch.core.machines import get_machine

API_VERSION = 1


@dataclass(frozen=True)
class PlanRef:
    """A wire-serializable reference to a suite model plan.

    ``ModelPlan`` holds an ``ArchConfig`` and interned spec callables —
    in-process only — so requests that cross a process boundary carry the
    recipe instead: ``price`` resolves it through ``configs.get_config`` +
    ``suite.lower_model`` on the pricing side.
    """

    arch: str
    shape: str = "train_4k"
    batch: int = 1

    def resolve(self):
        from repro_torch.configs import get_config
        from repro_torch.suite import lower_model

        return lower_model(get_config(self.arch), self.shape, self.batch)


@dataclass(frozen=True)
class PriceRequest:
    """One pricing question, versioned and value-like.

    ``workloads``: engine ``Workload``s (a bare GPU ``KernelSpec`` is
    promoted, as ``Explorer`` always did).  ``plans``: ``{name: ModelPlan |
    PlanRef}`` (or an items tuple) — priced through suite lowering into the
    same sweep, results folded into ``result.suite``.  ``traced``:
    ``frontend.TracedSpecPayload``s from ``trace_payload``.  ``machines``:
    registry names (see ``core.machines.MACHINES``) or machine objects.
    ``gpu_configs`` overrides the GPU launch-config list for plan lowering
    and for workloads that do not carry their own.
    """

    workloads: tuple = ()
    plans: tuple = ()
    traced: tuple = ()
    machines: tuple = ()
    gpu_configs: tuple | None = None
    top_k: int | None = None
    strict: bool = False
    machine_axis: bool = False
    version: int = API_VERSION

    def __post_init__(self):
        object.__setattr__(self, "workloads", tuple(self.workloads))
        plans = self.plans
        if isinstance(plans, dict):
            plans = tuple(plans.items())
        object.__setattr__(self, "plans", tuple(tuple(p) for p in plans))
        object.__setattr__(self, "traced", tuple(self.traced))
        machines = self.machines
        if not isinstance(machines, (list, tuple)):
            machines = (machines,)
        object.__setattr__(self, "machines", tuple(machines))
        if self.gpu_configs is not None:
            object.__setattr__(self, "gpu_configs", tuple(self.gpu_configs))

    @property
    def empty(self) -> bool:
        return not (self.workloads or self.plans or self.traced)


@dataclass(frozen=True)
class PriceResult:
    """One pricing answer: the engine's ``ExplorationReport`` plus, when the
    request carried suite plans, the folded ``SuiteReport``.

    The common report accessors are re-exported so most callers never reach
    inside: ``result.ranking(workload, machine)``, ``result.best(...)``,
    ``result.cache_stats`` ...

    ``degraded=True`` marks a graceful-degradation answer (``price_bounds``):
    the ranking orders configs by their sound closed-form lower bound, not
    the exact model — callers that need the exact ranking must ``price``.
    """

    report: Any
    suite: Any = None
    version: int = API_VERSION
    degraded: bool = False

    # ---- report passthrough --------------------------------------------
    @property
    def entries(self):
        return self.report.entries

    @property
    def skipped(self):
        return self.report.skipped

    @property
    def pruned(self):
        return self.report.pruned

    @property
    def cache_stats(self) -> dict:
        return self.report.cache_stats

    @property
    def wall_time_s(self) -> float:
        return self.report.wall_time_s

    def ranking(self, workload=None, machine=None):
        return self.report.ranking(workload, machine)

    def best(self, workload=None, machine=None):
        return self.report.best(workload, machine)

    def to_json_dict(self) -> dict:
        """The versioned, exact wire form (``serve.schema`` codec)."""
        from repro_torch.serve.schema import encode

        return encode(self)


# ==========================================================================
# request builders
# ==========================================================================
def gpu_request(spec, machine, configs=None, *, capacity=None,
                total_threads: int = 1024, top_k: int | None = None,
                strict: bool = False) -> PriceRequest:
    """Rank ``configs`` (default: the paper's eq.-6 grid at
    ``total_threads``) of one GPU kernel spec on one machine."""
    if configs is None:
        from repro_torch.core.selector import enumerate_gpu_configs

        configs = enumerate_gpu_configs(total_threads)
    return PriceRequest(
        workloads=(Workload(name=spec.name, gpu_spec=spec,
                            gpu_configs=tuple(configs), capacity=capacity),),
        machines=(machine,), top_k=top_k, strict=strict,
    )


def pallas_request(candidates, machine="TPUv5e", *,
                   workload: str | None = None,
                   top_k: int | None = None,
                   strict: bool = False) -> PriceRequest:
    """Rank ``(config, PallasKernelSpec)`` candidates on one TPU machine."""
    candidates = tuple(candidates)
    name = workload or (candidates[0][1].name if candidates else "pallas")
    return PriceRequest(
        workloads=(Workload(name=name, tpu_candidates=candidates),),
        machines=(machine,), top_k=top_k, strict=strict,
    )


def plan_request(plans: dict, machines, *, gpu_configs=None,
                 top_k: int | None = None,
                 strict: bool = False) -> PriceRequest:
    """Price suite model plans on ``machines`` in one sweep.

    ``plans`` values may be ``ModelPlan``s (in-process) or ``PlanRef``s
    (serializable — resolved on the pricing side).
    """
    return PriceRequest(plans=plans, machines=machines,
                        gpu_configs=gpu_configs, top_k=top_k, strict=strict)


def kernel_request(call_fn, args, machines, *, name: str = "kernel",
                   costs=None, rename: dict | None = None,
                   top_k: int | None = None) -> PriceRequest:
    """Price one Triton kernel, given its launcher and placeholder args.

    Tracing happens here, eagerly (it needs torch and the launcher); the
    returned request carries only the pure-value payload, so it can cross
    the ``repro_torch.serve`` wire.
    """
    from repro_torch.frontend import trace_payload

    payload = trace_payload(call_fn, args, name=name, costs=costs,
                            rename=rename)
    return PriceRequest(traced=(payload,), machines=machines, top_k=top_k)


# ==========================================================================
# the one entry point
# ==========================================================================
def _resolve_machine(m):
    return get_machine(m) if isinstance(m, str) else m


def _resolve_plan(plan):
    return plan.resolve() if isinstance(plan, PlanRef) else plan


def _check_version(request: PriceRequest) -> None:
    if request.version > API_VERSION:
        raise ValueError(
            f"request version {request.version} is newer than this "
            f"library's API_VERSION {API_VERSION}")


def _request_workloads(request: PriceRequest):
    """Lower a request to its engine workload list and its resolved plans
    (shared by ``price`` and ``price_bounds`` so both answer literally the
    same question)."""
    workloads = [
        w if isinstance(w, Workload) else Workload(name=w.name, gpu_spec=w)
        for w in request.workloads
    ]
    if request.gpu_configs is not None:
        workloads = [
            dataclasses.replace(w, gpu_configs=request.gpu_configs)
            if w.gpu_configs is None and w.gpu_spec is not None else w
            for w in workloads
        ]
    for t in request.traced:
        workloads.append(Workload(
            name=t.name, gpu_spec=t.gpu_spec,
            tpu_candidates=[({}, t.tpu_spec)]))

    plans = {name: _resolve_plan(p) for name, p in request.plans}
    if plans:
        from repro_torch.suite import suite_gpu_configs

        gpu_configs = (list(request.gpu_configs)
                       if request.gpu_configs is not None
                       else suite_gpu_configs())
        for name, plan in plans.items():
            for w in plan.engine_workloads(gpu_configs):
                workloads.append(
                    dataclasses.replace(w, name=f"{name}::{w.name}"))
    return workloads, plans


def price(request: PriceRequest, *, engine: Explorer | None = None,
          progress=None) -> PriceResult:
    """Answer one ``PriceRequest`` in a single engine sweep.

    Workloads, traced kernels, and every suite plan's lowered kernels run
    through ONE ``Explorer`` sweep — sharing the invariant cache, cell-level
    dedupe, and (with ``machine_axis``) geometry batching — then suite plans
    fold their namespaced entries into ``result.suite``.  ``engine`` lets a
    long-lived caller (a code generator ranking many kernels) reuse one
    Explorer, and with it its pool settings and cache, across requests.
    """
    _check_version(request)
    explorer = engine or Explorer()
    machines = [_resolve_machine(m) for m in request.machines]
    workloads, plans = _request_workloads(request)
    report = explorer._explore(workloads, machines,
                               strict=request.strict, top_k=request.top_k,
                               progress=progress,
                               machine_axis=request.machine_axis)
    if plans:
        from repro_torch.suite import suite_from_report

        suite = suite_from_report(plans, machines, report)
    else:
        suite = None
    return PriceResult(report=report, suite=suite)


def price_bounds(request: PriceRequest, *,
                 engine: Explorer | None = None) -> PriceResult:
    """Answer a request with the tier-1 closed-form bound ranking only.

    The graceful-degradation path (DESIGN.md §13): it evaluates each
    backend's cheap bound tasks — no grid walks, no wave model, no worker
    pool — and ranks configurations by their sound lower bound on primary
    time.  The result is flagged ``degraded=True``: the order is a bound
    ranking, not the exact one, and suite folding is skipped (no exact
    estimates exist to fold).
    """
    _check_version(request)
    explorer = engine or Explorer()
    machines = [_resolve_machine(m) for m in request.machines]
    workloads, _ = _request_workloads(request)
    report = explorer.bound_rank(workloads, machines, top_k=request.top_k)
    return PriceResult(report=report, degraded=True)


__all__ = [
    "API_VERSION", "PlanRef", "PriceRequest", "PriceResult",
    "gpu_request", "pallas_request", "plan_request", "kernel_request",
    "price", "price_bounds",
]
