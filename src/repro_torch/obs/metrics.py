"""Named, typed, documented metrics behind one process-local registry.

A copy of ``repro.obs.metrics`` (its registry is this package's own).

Absorbs the counters that used to live in scattered ad-hoc dicts — the
cache-metric core's ``CORE_STATS``, ``TaskPool.health``, the scheduler's
identity counters — without changing any mutation site: ``CounterGroup`` is
a dict-compatible mapping whose *schema* (field names + one-line docs) is
declared once and registered, so ``group["hits"] += 1`` keeps working while
``describe()`` can enumerate and document every metric in the process and
``snapshot()``/``delta()`` give per-sweep semantics.

Naming: dotted ``<subsystem>.<metric>`` (``core.streams_built``,
``serve.memo_hits``, ``pool.health.rebuilds``, ``engine.cache.hits``).  The
legacy ``report.cache_stats`` dict survives as a *view* over the canonical
per-sweep metrics (``cache_stats_view``); its key schema is frozen here
(``CACHE_STATS_KEYS``) and documented in DESIGN.md §14 — a test asserts the
exact key set per sweep kind, so new counters cannot land undocumented.
"""
from __future__ import annotations

import threading
from typing import Mapping, NamedTuple


class MetricSpec(NamedTuple):
    name: str
    kind: str          # "counter" (monotonic) | "gauge" (point-in-time)
    unit: str
    doc: str


_lock = threading.Lock()
_specs: dict = {}          # name -> MetricSpec
_groups: dict = {}         # group name -> live CounterGroup (latest wins)


def _register(spec: MetricSpec) -> None:
    with _lock:
        old = _specs.get(spec.name)
        if old is not None and old != spec:
            raise ValueError(
                f"metric {spec.name!r} already registered with a different "
                f"spec ({old.kind}/{old.unit}: {old.doc!r})")
        _specs[spec.name] = spec


def describe() -> dict:
    """Every registered metric: ``{name: MetricSpec}`` (sorted by name)."""
    with _lock:
        return dict(sorted(_specs.items()))


def attach(group: "CounterGroup") -> None:
    """Expose a live group in ``snapshot()`` (same-named attach replaces:
    per-sweep instances like ``TaskPool.health`` keep the latest)."""
    with _lock:
        _groups[group.name] = group


def detach(name: str) -> None:
    with _lock:
        _groups.pop(name, None)


def snapshot() -> dict:
    """Flat ``{dotted-name: value}`` of every attached group's counters."""
    with _lock:
        groups = list(_groups.values())
    out: dict = {}
    for g in groups:
        for k, v in g.items():
            out[f"{g.name}.{k}"] = v
    return dict(sorted(out.items()))


def delta(prev: Mapping) -> dict:
    """Per-interval counter deltas against an earlier ``snapshot()``.

    Keys absent from ``prev`` count from zero (a group attached
    mid-interval); keys absent from the current snapshot are dropped.
    """
    cur = snapshot()
    return {k: v - prev.get(k, 0) for k, v in cur.items()}


class CounterGroup(dict):
    """A named, documented group of integer counters.

    A ``dict`` subclass on purpose — existing mutation *and consumption*
    sites (``health["rebuilds"] += 1``, ``dict(counters)``,
    ``any(group.values())``, ``json.dumps(pool.health)``) work unchanged —
    but the field set is closed: writing an undeclared key raises
    ``KeyError``, so every counter that exists is documented.  Increments
    take no lock (same GIL-atomicity discipline as the plain dicts they
    replace; these are statistics, not synchronization).
    """

    def __init__(self, name: str, fields: Mapping[str, str], *,
                 register: bool = True):
        super().__init__({k: 0 for k in fields})
        self.name = name
        if register:
            for field, doc in fields.items():
                _register(MetricSpec(f"{name}.{field}", "counter", "count",
                                     doc))
            attach(self)

    def __setitem__(self, key, value):
        if key not in self:
            raise KeyError(
                f"{self.name!r} has no declared counter {key!r} — declare "
                f"it (with a doc line) where the group is defined")
        super().__setitem__(key, value)

    def update(self, *a, **kw):          # route through the closed-set check
        for k, v in dict(*a, **kw).items():
            self[k] = v

    def setdefault(self, key, default=None):
        if key not in self:
            self[key] = default          # raises: undeclared key
        return self[key]

    def as_dict(self) -> dict:
        return dict(self)

    def reset(self) -> None:
        for k in self:
            super().__setitem__(k, 0)

    def __repr__(self):
        return f"CounterGroup({self.name!r}, {dict(self)!r})"


# ---------------------------------------------------------------------------
# The frozen report.cache_stats schema (legacy key -> canonical metric)
# ---------------------------------------------------------------------------
#: Every key ``report.cache_stats`` may ever contain, with the canonical
#: metric name behind it.  DESIGN.md §14 renders this as the schema table;
#: tests/test_cache_stats_schema.py asserts the exact set per sweep kind.
CACHE_STATS_KEYS = {
    "hits": "engine.cache.hits",
    "misses": "engine.cache.misses",
    "entries": "engine.cache.entries",
    "evictions": "engine.cache.evictions",
    "pool_tasks": "engine.sweep.pool_tasks",
    "bound_evals": "engine.sweep.bound_evals",
    "cells": "engine.sweep.cells",
    "shared_cells": "engine.sweep.shared_cells",
    "evaluated": "engine.sweep.evaluated",
    "pruned": "engine.sweep.pruned",
    "streams_built": "core.streams_built",
    "streams_shared": "core.streams_shared",
    "waves_folded": "core.waves_folded",
    "wave_fallbacks": "core.wave_fallbacks",
    "geometry_groups": "engine.axis.geometry_groups",
    "machines_batched": "engine.axis.machines_batched",
    "geometry_share": "engine.axis.geometry_share",
    "pool_health": "pool.health.*",
    "degraded": "engine.sweep.degraded",
    "coalesced": "serve.coalesced",
}

# ordered sections of the legacy view (presence mirrors the historical
# emission exactly: axis keys only on machine-axis sweeps, pool_health only
# when a pool event fired, degraded/coalesced only on those paths)
_SCALAR_VIEW = [
    ("hits", "engine.cache.hits"),
    ("misses", "engine.cache.misses"),
    ("entries", "engine.cache.entries"),
    ("evictions", "engine.cache.evictions"),
    ("pool_tasks", "engine.sweep.pool_tasks"),
    ("bound_evals", "engine.sweep.bound_evals"),
    ("cells", "engine.sweep.cells"),
    ("shared_cells", "engine.sweep.shared_cells"),
    ("evaluated", "engine.sweep.evaluated"),
    ("pruned", "engine.sweep.pruned"),
]
_AXIS_VIEW = [
    ("geometry_groups", "engine.axis.geometry_groups"),
    ("machines_batched", "engine.axis.machines_batched"),
    ("geometry_share", "engine.axis.geometry_share"),
]
_CORE_VIEW = [
    ("streams_built", "core.streams_built"),
    ("streams_shared", "core.streams_shared"),
    ("waves_folded", "core.waves_folded"),
    ("wave_fallbacks", "core.wave_fallbacks"),
]
POOL_HEALTH_FIELDS = ("rebuilds", "retries", "hung_chunks", "broken_pools",
                      "quarantined")


def cache_stats_view(metrics: Mapping) -> dict:
    """The backward-compatible ``report.cache_stats`` dict derived from a
    report's canonical per-sweep ``metrics`` mapping."""
    out: dict = {}
    if metrics.get("engine.sweep.degraded"):
        out["degraded"] = True
    for legacy, canon in _SCALAR_VIEW:
        if canon in metrics:
            out[legacy] = metrics[canon]
    for legacy, canon in _AXIS_VIEW:
        if canon in metrics:
            out[legacy] = metrics[canon]
    health = {k: metrics[f"pool.health.{k}"] for k in POOL_HEALTH_FIELDS
              if f"pool.health.{k}" in metrics}
    if any(health.values()):
        out["pool_health"] = health
    for legacy, canon in _CORE_VIEW:
        if canon in metrics:
            out[legacy] = metrics[canon]
    if metrics.get("serve.coalesced"):
        out["coalesced"] = True
    return out


# engine per-sweep metrics have no live group (they are deltas computed by
# the Explorer per sweep) but their names are documented like all others
for _name, _doc in {
    "engine.cache.hits": "invariant-cache hits during the sweep",
    "engine.cache.misses": "invariant-cache misses during the sweep",
    "engine.cache.entries": "invariant-cache entries after the sweep",
    "engine.cache.evictions": "invariant-cache evictions during the sweep",
    "engine.sweep.pool_tasks": "structural tasks evaluated (post-dedupe)",
    "engine.sweep.bound_evals": "cheap bound-stage task evaluations",
    "engine.sweep.cells": "distinct (workload, machine) cells priced",
    "engine.sweep.shared_cells": "cells cloned from a structural twin",
    "engine.sweep.evaluated": "configurations fully priced (pre-top-k)",
    "engine.sweep.pruned": "configurations eliminated by bounds alone",
    "engine.sweep.resumed_cells": "cells restored from a sweep checkpoint "
                                  "journal instead of being re-priced",
    "engine.sweep.degraded": "1 when this is a bound-only degraded ranking",
    "engine.axis.geometry_groups": "machine-axis structural geometry groups",
    "engine.axis.machines_batched": "machine columns batched across groups",
    "serve.coalesced": "1 when this report was split from a merged sweep",
}.items():
    _register(MetricSpec(_name, "counter", "count", _doc))
_register(MetricSpec("engine.axis.geometry_share", "gauge", "map",
                     "machine count per geometry label (labelled counter)"))


__all__ = [
    "MetricSpec", "CounterGroup", "describe", "attach", "detach",
    "snapshot", "delta", "cache_stats_view", "CACHE_STATS_KEYS",
    "POOL_HEALTH_FIELDS",
]
