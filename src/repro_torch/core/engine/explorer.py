"""The staged exploration engine (DESIGN.md §5).

One ``Explorer`` ranks GPU, TPU, and hypothetical machines through a single
API.  Pricing a configuration space runs in five stages:

  1. **enumerate** — collect the candidate configurations per (workload,
     machine) cell and ask the backend for their structural tasks;
  2. **prune** (only with ``top_k`` and a bound-capable backend) — evaluate
     each configuration's closed-form lower bound on predicted time (cheap:
     no grid walk, no wave model), then branch-and-bound: configurations
     refine tier by tier in best-bound-first order, and any configuration
     whose bound exceeds the current k-th best *refined* time is cut without
     touching its remaining structural work.  Sound bounds make the returned
     top-k ranking bitwise identical to exhaustive search;
  3. **dedupe** — resolve structural keys against the invariant cache, so
     footprint boxes, wave sets, and grid walks are computed once per
     structural equivalence class, not once per configuration;
  4. **evaluate** — run the missing tasks through the worker pool (chunked
     batches, deterministic result ordering; errors become outcomes, not
     crashes);
  5. **combine & rank** — fold cached values into estimates with the
     backend's (cheap, exact) combine arithmetic, record skipped and pruned
     configurations with reasons/bounds, and stable-sort by the backend's
     key.

The cache persists across calls, so a multi-machine or multi-kernel sweep
pays for shared structure only once — and with ``Explorer(cache_path=...)``
it persists across *processes*: structural keys are pure value tuples, so a
warm run reloads every prior computation and skips essentially all
structural work (see ``engine.invariants``).

A copy of ``repro.core.engine.explorer`` without the reference's deprecated
public shims (``rank_gpu``, ``rank_pallas``, ``explore``, ``explore_plans``):
``repro_torch.api.price``, ``core.selector.rank_gpu_configs`` and the
suite's ``_price_plans`` call the private implementations.  One difference of behaviour: an
``ArithmeticError`` of a task or a combine (a launch with a zero block
extent divides by zero) is an estimation error here, recorded as a skip
like ``ValueError``/``RuntimeError`` (raised under ``strict``), where the
reference lets it end the sweep; the port's serial ranking always recorded
it so.
"""
from __future__ import annotations

import bisect
import dataclasses
import hashlib
import json
import os
import pickle
import threading
import time
from dataclasses import dataclass, field as dc_field
from typing import Sequence

from repro_torch import durable, obs
from repro_torch.obs.metrics import cache_stats_view

from ..capacity import CapacityModel
from ..gridwalk import core_stats_snapshot
from ..machines import GPUMachine, TPUMachine
from .backends import GPUBackend, PallasBackend
from .invariants import ENGINE_CACHE_VERSION, InvariantCache
from .pool import TaskPool, guarded_call
from .protocol import (
    EvalResult,
    ExplorationReport,
    PrunedConfig,
    RejectedSpec,
    SkipConfig,
    SkippedConfig,
)

# Items advanced per cell per refinement round: big enough to keep the pool
# batched, small enough that the prune threshold tightens early.
_ROUND_CHUNK = 16

# Bump when the checkpoint record schema changes; stale-version cells are
# ignored on load (re-priced), never migrated.
_CKPT_VERSION = 1

# Every checkpoint frame starts with this tag, ahead of its pickle: a journal
# written by the reference engine (bare pickles of its own classes) is never
# unpickled here, so reading one never imports the reference's modules.
_CKPT_MAGIC = b"repro_torch-sweep-ckpt\x00"

# The errors a task or a combine may raise that drop a configuration with a
# recorded reason; anything else is a programming error and propagates.
ESTIMATION_ERRORS = (SkipConfig, ValueError, RuntimeError, ArithmeticError)


class SweepCheckpoint:
    """Append-only journal of *completed* sweep cells (DESIGN.md §15).

    Each record is one cell's final outcome — the ranked entries plus its
    skip/prune records — keyed by a content digest of the cell's structural
    identity (backend state, items, machine, ``top_k``, sweep mode).  A
    cell commits with one fsync'd :class:`repro_torch.durable.Journal` append the
    moment it finishes, so a SIGKILL at any point loses at most the cell
    that was mid-commit; ``Explorer(resume=path)`` replays the journal and
    restores completed cells without re-pricing them.  Keys exclude the
    workload *name* (a label): structurally identical cells priced under
    different names restore from one record, exactly like live cell-sharing.
    """

    def __init__(self, path: str | os.PathLike):
        self.path = os.fspath(path)
        self._journal = durable.Journal(self.path)
        self._cells: dict = {}
        self.torn = False
        with obs.span("durable.recover", cat="engine", path=self.path):
            payloads, self.torn = self._journal.recover()
            for raw in payloads:
                if not raw.startswith(_CKPT_MAGIC):
                    continue
                try:
                    rec = pickle.loads(raw[len(_CKPT_MAGIC):])
                except Exception:
                    continue
                if not (isinstance(rec, dict) and rec.get("kind") == "cell"
                        and rec.get("version") == _CKPT_VERSION
                        and rec.get("engine") == ENGINE_CACHE_VERSION):
                    continue
                self._cells[rec.get("key")] = rec

    def __len__(self) -> int:
        return len(self._cells)

    def get(self, key: str | None):
        return self._cells.get(key) if key else None

    def put(self, key: str, record: dict) -> bool:
        """Durably commit one completed cell; False when the record cannot
        be pickled or the append fails (the sweep continues uncheckpointed
        — durability is an accelerator, not a correctness dependency)."""
        record = {"kind": "cell", "version": _CKPT_VERSION,
                  "engine": ENGINE_CACHE_VERSION, "key": key, **record}
        try:
            raw = _CKPT_MAGIC + pickle.dumps(record,
                                             protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            return False
        try:
            self._journal.append(raw)
        except OSError:
            return False
        self._cells[key] = record
        return True


@dataclass
class Workload:
    """One kernel as seen by every backend the sweep may touch.

    ``gpu_spec`` feeds GPU machines (with ``gpu_configs`` or the paper's
    eq.-6 grid); ``tpu_candidates`` — ``(config_dict, PallasKernelSpec)``
    pairs, typically from a kernel generator's ``candidate_specs`` — feed
    TPU machines.
    """

    name: str
    gpu_spec: object | None = None
    gpu_configs: Sequence | None = None
    tpu_candidates: Sequence | None = None
    capacity: CapacityModel | None = None


def _prunable(backend) -> bool:
    return all(
        hasattr(backend, m)
        for m in ("bound_tasks", "tiers", "tier_bound", "primary_time")
    )


@dataclass
class _Item:
    """Per-configuration refinement state inside one pruned cell."""

    index: int
    item: object
    bound: float = float("-inf")
    tier: int = 0                 # next tier to resolve
    tiers: list | None = None     # built lazily — pruned items never need it
    values: dict = dc_field(default_factory=dict)
    done: bool = False


def _backend_signature(backend):
    if isinstance(backend, GPUBackend):
        cap = backend.capacity
        return ("gpu", backend.spec, backend.domain,
                tuple(sorted(cap.fits.items())))
    if isinstance(backend, PallasBackend):
        return ("pallas",)
    return None


def _items_signature(items):
    try:
        # dict configs hash by insertion-ordered items: generators emit a
        # stable field order, and an order mismatch merely forgoes sharing
        sig = tuple(
            (tuple(it[0].items()), it[1])
            if isinstance(it, tuple) and len(it) == 2
            and isinstance(it[0], dict) else it
            for it in items
        )
        hash(sig)
        return sig
    except TypeError:
        return None


def _cell_signature(backend, items, machine):
    """Value signature of one cell, or None when not signable.

    Two cells with equal signatures price identically (combine is a pure
    function of backend state, item, machine), differing only in workload
    name — the suite's per-layer plans repeat the same few distinct cells
    hundreds of times, so the engine evaluates each equivalence class once
    and clones the results.  Unhashable pieces opt the cell out of sharing
    (correct, just slower).
    """
    backend_sig = _backend_signature(backend)
    items_sig = _items_signature(items)
    if backend_sig is None or items_sig is None:
        return None
    try:
        sig = (backend_sig, items_sig, machine)
        hash(sig)  # probe hashability once; unhashable -> no sharing
        return sig
    except TypeError:
        return None


def _ckpt_key(run, top_k, machine_axis, strict) -> str | None:
    """Content digest identifying one cell across processes, or None when
    the cell is not checkpointable (unsignable state, or state the canonical
    wire codec cannot encode).  Built on the serve-layer codec rather than
    pickle: pickle bytes depend on object-graph sharing, the canonical JSON
    encoding depends only on values — the property a cross-process resume
    key needs.  ``top_k``/mode/strictness are part of the identity because
    they change what a "completed cell" contains."""
    sig = _cell_signature(run.backend, run.items, run.machine)
    if sig is None:
        return None
    try:
        from repro_torch.serve.schema import encode

        body = encode((ENGINE_CACHE_VERSION, _CKPT_VERSION, sig, top_k,
                       bool(machine_axis), bool(strict)))
        text = json.dumps(body, sort_keys=True, separators=(",", ":"))
    except Exception:
        return None
    return hashlib.sha256(text.encode()).hexdigest()


_AXIS_METHODS = ("geometry_key", "machine_axis_tasks", "batch_order",
                 "machine_axis_combine")


class _AxisGroup:
    """Runs sharing (backend state, items, machine geometry) mid-sweep:
    structure resolves once, the rate stage runs batched across the
    machine axis, each run keeps its own (workload, machine) results."""

    def __init__(self, backend, items):
        self.backend = backend
        self.items = items
        self.runs: list = []      # _CellRun per machine column


class _CellRun:
    """One (workload, backend, items, machine) cell mid-sweep."""

    def __init__(self, wname, backend, items, machine, top_k, prune):
        self.wname = wname
        self.backend = backend
        self.items = items
        self.machine = machine
        self.top_k = top_k
        self.prune = prune
        self.results: list = []          # combined EvalResults
        self.skips: list = []            # SkippedConfig
        self.pruned: list = []           # PrunedConfig
        self._times: list = []           # sorted primary times of results
        self.states: list = []           # _Item, bound order (prune mode)
        self._ranked: list | None = None
        self.ckpt_key: str | None = None   # checkpoint identity (resume mode)
        self.ckpt_done = False             # restored or already committed

    @property
    def threshold(self) -> float:
        """k-th best refined primary time, +inf until k results exist."""
        if self.top_k is None or len(self._times) < self.top_k:
            return float("inf")
        return self._times[self.top_k - 1]

    def add_result(self, result) -> None:
        self.results.append(result)
        if self.prune:
            bisect.insort(self._times, self.backend.primary_time(result))

    def ranked_entries(self) -> list:
        # composite key == stable sort over enumeration order (ties break
        # toward the earlier-enumerated configuration, as the exhaustive
        # path has always done); memoized — cell-sharing reads it per clone
        if self._ranked is None:
            out = sorted(self.results,
                         key=lambda r: (*self.backend.sort_key(r), r.index))
            self._ranked = out[: self.top_k] if self.top_k is not None else out
        return self._ranked


class Explorer:
    """Staged, memoized, optionally parallel + pruned config-space search.

    An Explorer is reentrant: concurrent callers (threaded clients of
    ``repro_torch.api.price``) may issue
    sweeps against one shared instance — ``_sweep`` serializes them behind a
    lock so cache statistics deltas, ``hold()`` scoping, and persistence
    stay coherent.  The cross-sweep memoization then makes the serialized
    sweeps cheap: whatever the first request priced, the rest reuse.
    """

    def __init__(self, *, parallel: bool = False, max_workers: int | None = None,
                 cache: InvariantCache | None = None,
                 cache_path: str | None = None, strict: bool = False,
                 cache_max_entries: int | None = None,
                 cache_max_bytes: int | None = None,
                 trace_out: str | None = None,
                 resume: str | os.PathLike | None = None):
        self.parallel = parallel
        self.max_workers = max_workers
        self.trace_out = trace_out
        if trace_out:
            obs.enable()
        # crash-consistent sweeps (DESIGN.md §15): completed cells journal
        # to ``resume`` as they finish, and a later Explorer pointed at the
        # same path restores them instead of re-pricing
        self.resume_path = os.fspath(resume) if resume is not None else None
        self._ckpt = (SweepCheckpoint(self.resume_path)
                      if self.resume_path else None)
        if cache is not None and cache_path is not None:
            raise ValueError("pass either cache or cache_path, not both")
        if cache is not None and (cache_max_entries is not None
                                  or cache_max_bytes is not None):
            raise ValueError("cache budgets configure the explorer-owned "
                             "cache; set them on the InvariantCache you "
                             "pass instead")
        if cache is None:
            cache = InvariantCache(path=cache_path,
                                   max_entries=cache_max_entries,
                                   max_bytes=cache_max_bytes)
        self.cache = cache
        self.strict = strict
        self._sweep_lock = threading.RLock()

    # ---- single-cell entry points --------------------------------------
    def _rank_gpu(self, spec, machine: GPUMachine, configs=None, *,
                  capacity: CapacityModel | None = None,
                  total_threads: int = 1024, strict: bool | None = None,
                  top_k: int | None = None, progress=None) -> ExplorationReport:
        """Rank launch configurations of one kernel on one GPU machine.

        ``top_k`` switches to the tiered bound-then-refine search: only the
        top-k ranking is returned (bitwise identical to exhaustive search),
        with bound-eliminated configurations in ``report.pruned``.
        """
        if configs is None:
            from ..selector import enumerate_gpu_configs

            configs = enumerate_gpu_configs(total_threads)
        backend = GPUBackend(spec, capacity)
        return self._sweep(
            [(spec.name, backend, list(configs), machine)],
            strict=strict, top_k=top_k, progress=progress,
        )

    # ---- sweep front-end ----------------------------------------------
    def _explore(self, workloads, machines, configs=None, *,
                 strict: bool | None = None, top_k: int | None = None,
                 progress=None, machine_axis: bool = False) -> ExplorationReport:
        """Price every workload on every machine in one call.

        ``workloads``: Workload instances (a bare KernelSpec is promoted to a
        GPU-only workload).  ``machines``: GPUMachine / TPUMachine mix.
        ``configs`` optionally overrides the GPU config list for all
        workloads.  Machines a workload defines no candidates for are
        recorded in ``report.skipped`` rather than silently ignored.
        ``top_k`` enables per-cell pruned search; ``progress(done, total)``
        is called as configurations reach a terminal state.

        ``machine_axis=True`` switches to batched design-space evaluation
        (DESIGN.md §11): cells sharing (workload structure, machine
        geometry) price their structure once and run the rate/limiter stage
        as one (configs x machines) array program, then build the selected
        per-machine top-k entries through the scalar combine — results are
        bitwise identical to the per-machine path.  Intended with ``top_k``
        (full rankings fall back to per-entry scalar assembly).
        """
        workloads = [
            w if isinstance(w, Workload) else Workload(name=w.name, gpu_spec=w)
            for w in _as_list(workloads)
        ]
        machines = _as_list(machines)
        cells, undefined = self._build_cells(workloads, machines, configs)
        report = self._sweep(cells, strict=strict, top_k=top_k,
                             progress=progress, machine_axis=machine_axis)
        for w, m, reason in undefined:
            report.skipped.append(
                SkippedConfig(w.name, m.name, None, reason))
        return report

    @staticmethod
    def _build_cells(workloads, machines, configs=None):
        """Expand (workload, machine) pairs into sweep cells, collecting
        pairs with no applicable backend/candidates as skip records."""
        cells, undefined = [], []
        for w in workloads:
            for m in machines:
                if isinstance(m, GPUMachine):
                    if w.gpu_spec is None:
                        undefined.append((w, m, "no GPU kernel spec defined"))
                        continue
                    if isinstance(w.gpu_spec, RejectedSpec):
                        # a frontend tracer rejection travels inside the
                        # workload and is recorded by the engine directly —
                        # no post-sweep report mutation (DESIGN.md §12)
                        undefined.append((w, m, w.gpu_spec.reason))
                        continue
                    gpu_configs = configs if configs is not None else w.gpu_configs
                    if gpu_configs is None:
                        from ..selector import enumerate_gpu_configs

                        gpu_configs = enumerate_gpu_configs()
                    cells.append((w.name, GPUBackend(w.gpu_spec, w.capacity),
                                  list(gpu_configs), m))
                elif isinstance(m, TPUMachine):
                    if w.tpu_candidates is None:
                        undefined.append(
                            (w, m, "no Pallas candidates defined"))
                        continue
                    cells.append((w.name, PallasBackend(),
                                  list(w.tpu_candidates), m))
                else:
                    undefined.append(
                        (w, m, f"no backend for machine type "
                               f"{type(m).__name__}"))
        return cells, undefined

    # ---- graceful degradation: bound-only ranking (DESIGN.md §13) -------
    def bound_rank(self, workloads, machines, *, top_k: int | None = None,
                   configs=None) -> ExplorationReport:
        """Rank every cell by its tier-1 closed-form bound only.

        The degradation path for deadline-bound service requests: evaluates
        just the cheap bound tasks (cache-shared with full sweeps — a warm
        cache makes this near-free) and orders configurations by their
        sound lower bound on primary time.  No grid walks, no wave model,
        no worker pool.  Entries carry ``estimate=None``, ``perf=1/bound``
        and ``limiter="bound"`` so they cannot be mistaken for exact
        results; cells whose backend has no bound protocol are recorded as
        skips rather than guessed at.
        """
        workloads = [
            w if isinstance(w, Workload) else Workload(name=w.name, gpu_spec=w)
            for w in _as_list(workloads)
        ]
        machines = _as_list(machines)
        cells, undefined = self._build_cells(workloads, machines, configs)
        with self._sweep_lock:
            with obs.span("engine.bound_rank", kind="degraded",
                          cells=len(cells)):
                report = self._bound_sweep(cells, top_k)
            if self.trace_out:
                obs.write_trace(self.trace_out)
        for w, m, reason in undefined:
            report.skipped.append(
                SkippedConfig(w.name, m.name, None, reason))
        return report

    def _bound_sweep(self, cells, top_k) -> ExplorationReport:
        t0 = time.perf_counter()
        hits0, misses0 = self.cache.hits, self.cache.misses
        report = ExplorationReport()
        evals = 0
        with self.cache.hold():
            for wname, backend, items, machine in cells:
                if not _prunable(backend):
                    report.skipped.append(SkippedConfig(
                        wname, machine.name, None,
                        "degraded pricing: backend has no closed-form "
                        "bound protocol"))
                    continue
                rows = []
                for idx, item in enumerate(items):
                    tasks = backend.bound_tasks(item, machine)
                    for t in tasks:
                        if self.cache.lookup(t.key) is None:
                            self.cache.store(t.key,
                                             guarded_call(t.fn, t.args))
                            evals += 1
                    values: dict = {}
                    err = self._read_values(tasks, values, strict=False)
                    if err is not None:
                        report.skipped.append(SkippedConfig(
                            wname, machine.name, _item_config(item),
                            f"{type(err).__name__}: {err}"))
                        continue
                    bound = backend.tier_bound(item, machine, values)
                    rows.append((bound, idx, item))
                # best (lowest) bound first; index breaks ties exactly like
                # the exhaustive ranking's stable sort
                rows.sort(key=lambda r: (r[0], r[1]))
                if top_k is not None:
                    rows = rows[:top_k]
                for bound, idx, item in rows:
                    report.entries.append(EvalResult(
                        workload=wname, machine=machine.name,
                        backend=backend.name, index=idx,
                        config=_item_config(item), estimate=None,
                        perf=1.0 / max(bound, 1e-30), limiter="bound"))
        report.metrics = {
            "engine.sweep.degraded": 1,
            "engine.sweep.bound_evals": evals,
            "engine.cache.hits": self.cache.hits - hits0,
            "engine.cache.misses": self.cache.misses - misses0,
        }
        report.cache_stats = cache_stats_view(report.metrics)
        report.wall_time_s = time.perf_counter() - t0
        self.save_cache()
        return report

    def _explore_plans(self, plans, machines, *,
                       strict: bool | None = None, top_k: int | None = None,
                       progress=None,
                       machine_axis: bool = False) -> ExplorationReport:
        """Price a batch of named workload plans in ONE sweep.

        ``plans``: mapping plan name -> iterable of ``Workload``.  Workload
        names are namespaced as ``"<plan>::<workload>"`` in the report, so
        many plans (e.g. the model suite's per-model kernel plans) share a
        single enumerate/dedupe/evaluate pass — and therefore the invariant
        cache — without name collisions.  Filter per plan with
        ``report.ranking(f"{plan}::{workload}", machine)``.
        """
        namespaced = [
            dataclasses.replace(w, name=f"{pname}::{w.name}")
            for pname, wls in plans.items()
            for w in wls
        ]
        return self._explore(namespaced, machines, strict=strict, top_k=top_k,
                             progress=progress, machine_axis=machine_axis)

    # ---- persistence ---------------------------------------------------
    def save_cache(self) -> int:
        """Persist the invariant cache if it has a path; returns entries
        written (0 when not persistent or already clean)."""
        with self._sweep_lock:
            if self.cache.path and self.cache.dirty:
                with obs.span("engine.save_cache"):
                    return self.cache.save()
            return 0

    # ---- the staged core ----------------------------------------------
    def _sweep(self, cells, *, strict: bool | None = None,
               top_k: int | None = None, progress=None,
               machine_axis: bool = False) -> ExplorationReport:
        # Reentrancy: one sweep at a time per Explorer.  Concurrent service
        # requests queue here; the winner warms the invariant cache, so the
        # serialized followers are mostly cache replays.
        kind = ("machine_axis" if machine_axis
                else "pruned" if top_k is not None else "exhaustive")
        with self._sweep_lock:
            with obs.span("engine.sweep", kind=kind, cells=len(cells)):
                report = self._sweep_impl(cells, strict=strict, top_k=top_k,
                                          progress=progress,
                                          machine_axis=machine_axis)
            if self.trace_out:
                obs.write_trace(self.trace_out)
            return report

    def _sweep_impl(self, cells, *, strict: bool | None = None,
                    top_k: int | None = None, progress=None,
                    machine_axis: bool = False) -> ExplorationReport:
        strict = self.strict if strict is None else strict
        t0 = time.perf_counter()
        hits0, misses0 = self.cache.hits, self.cache.misses
        evict0 = self.cache.evictions
        core0 = core_stats_snapshot()
        stats = {"pool_tasks": 0, "bound_evals": 0, "shared_cells": 0}
        # cell-level dedupe: structurally identical cells (equal backend
        # state, items, machine) are priced once and cloned per name — the
        # suite's per-layer plans repeat a handful of distinct cells
        # hundreds of times
        runs, sources, by_sig = [], [], {}
        for wname, backend, items, machine in cells:
            sig = _cell_signature(backend, items, machine)
            owner = by_sig.get(sig) if sig is not None else None
            if owner is not None:
                sources.append((wname, owner))
                stats["shared_cells"] += 1
                continue
            run = _CellRun(wname, backend, items, machine, top_k,
                           prune=top_k is not None and _prunable(backend))
            runs.append(run)
            sources.append((wname, run))
            if sig is not None:
                by_sig[sig] = run
        total_items = sum(len(run.items) for _, run in sources)
        done_items = 0

        def _advance(n):
            nonlocal done_items
            done_items += n
            if progress and n:
                progress(done_items, total_items)

        # checkpoint restore (DESIGN.md §15): cells already completed by an
        # earlier (possibly killed) process come back verbatim from the
        # resume journal and skip every pricing stage below
        live_runs = runs
        stats["resumed_cells"] = 0
        if self._ckpt is not None:
            live_runs = []
            for run in runs:
                run.ckpt_key = _ckpt_key(run, top_k, machine_axis, strict)
                rec = self._ckpt.get(run.ckpt_key)
                if rec is not None and self._restore_run(run, rec):
                    stats["resumed_cells"] += 1
                    _advance(len(run.items))
                else:
                    live_runs.append(run)

        # machine-axis grouping (DESIGN.md §11): runs whose backend supports
        # batched evaluation and whose (backend state, items, machine
        # geometry) match become columns of one axis group; the rest flow
        # through the per-machine paths unchanged
        axis_groups, scalar_runs = [], live_runs
        if machine_axis:
            scalar_runs, by_axis = [], {}
            for run in live_runs:
                key = self._axis_key(run)
                if key is None:
                    scalar_runs.append(run)
                    continue
                grp = by_axis.get(key)
                if grp is None:
                    grp = _AxisGroup(run.backend, run.items)
                    by_axis[key] = grp
                    axis_groups.append(grp)
                run.prune = False      # ranked by the batch, not the tiers
                grp.runs.append(run)
            stats["geometry_groups"] = len(axis_groups)
            stats["machines_batched"] = sum(
                len(g.runs) for g in axis_groups)
            share: dict = {}
            for key, grp in by_axis.items():
                label = str(key[-1])
                share[label] = share.get(label, 0) + len(grp.runs)
            stats["geometry_share"] = share

        with TaskPool(parallel=self.parallel,
                      max_workers=self.max_workers) as pool, \
                self.cache.hold():
            exhaustive = [r for r in scalar_runs if not r.prune]
            pruned_runs = [r for r in scalar_runs if r.prune]
            if exhaustive:
                with obs.span("engine.exact", cells=len(exhaustive)):
                    self._run_exhaustive(exhaustive, pool, strict, stats,
                                         _advance)
            if pruned_runs:
                self._run_pruned(pruned_runs, pool, strict, stats, _advance)
            if axis_groups:
                with obs.span("engine.axis", groups=len(axis_groups)):
                    self._run_machine_axis(axis_groups, pool, strict, stats,
                                           _advance)

        report = ExplorationReport()
        with obs.span("engine.rank", cells=len(sources)):
            for wname, run in sources:
                if run.wname == wname:
                    report.entries.extend(run.ranked_entries())
                    report.skipped.extend(run.skips)
                    report.pruned.extend(run.pruned)
                    continue
                # direct construction: dataclasses.replace dominated suite
                # sweeps at ~180k clones per run
                report.entries.extend(
                    EvalResult(wname, e.machine, e.backend, e.index, e.config,
                               e.estimate, e.perf, e.limiter)
                    for e in run.ranked_entries())
                report.skipped.extend(
                    SkippedConfig(wname, s.machine, s.config, s.reason)
                    for s in run.skips)
                report.pruned.extend(
                    PrunedConfig(wname, p.machine, p.config, p.bound,
                                 p.threshold)
                    for p in run.pruned)
                _advance(len(run.items))
        # canonical per-sweep metric deltas (a reused Explorer's cache is
        # cumulative); report.cache_stats is the backward-compatible view
        metrics = {
            "engine.cache.hits": self.cache.hits - hits0,
            "engine.cache.misses": self.cache.misses - misses0,
            "engine.cache.entries": len(self.cache),
            "engine.cache.evictions": self.cache.evictions - evict0,
            "engine.sweep.pool_tasks": stats["pool_tasks"],
            "engine.sweep.bound_evals": stats["bound_evals"],
            "engine.sweep.cells": len(runs),
            "engine.sweep.shared_cells": stats["shared_cells"],
            "engine.sweep.evaluated": sum(len(r.results) for r in runs),
            "engine.sweep.pruned": sum(len(r.pruned) for r in runs),
            "engine.sweep.resumed_cells": stats["resumed_cells"],
        }
        for k in ("geometry_groups", "machines_batched", "geometry_share"):
            if k in stats:
                metrics[f"engine.axis.{k}"] = stats[k]
        # self-healing pool events (rebuilds after crashed/hung workers,
        # quarantined tasks) surface on the report so service callers can
        # alert; the legacy view carries them only when an event fired
        metrics.update(
            {f"pool.health.{k}": v for k, v in pool.health.items()})
        # cache-metric core deltas (DESIGN §10).  Process-local: tasks that
        # ran in pool workers count in the worker, not here, so parallel
        # sweeps under-report — serial sweeps (and the cachesim benches)
        # see the full picture.
        metrics.update({
            f"core.{k}": v - core0[k]
            for k, v in core_stats_snapshot().items()
        })
        report.metrics = metrics
        report.cache_stats = cache_stats_view(metrics)
        report.wall_time_s = time.perf_counter() - t0
        self.save_cache()
        return report

    # ---- shared plumbing ----------------------------------------------
    def _resolve_batch(self, tasks, pool, stats) -> None:
        """Dedupe a batch of tasks against the cache and evaluate the
        missing ones through the pool (outcomes stored, order-stable)."""
        pending = {}
        for t in tasks:
            if t.key in pending:
                self.cache.count_hit()
            elif self.cache.lookup(t.key) is None:
                pending[t.key] = (t.fn, t.args)
        outcomes = pool.run(list(pending.values()))
        for key, outcome in zip(pending, outcomes):
            self.cache.store(key, outcome)
        stats["pool_tasks"] += len(pending)

    def _read_values(self, tasks, values, strict):
        """Copy resolved task outcomes into ``values``; return the first
        estimation error (or raise a programming error / strict error)."""
        for t in tasks:
            status, val = self.cache.peek(t.key)
            if status == "err":
                # estimation errors become skips; anything else is a
                # programming error and propagates, matching what the
                # monolithic path (and the combine stage) would do
                if not isinstance(val, ESTIMATION_ERRORS):
                    raise val
                if strict and not isinstance(val, SkipConfig):
                    raise val
                return val
            values[t.key] = val
        return None

    def _combine(self, run, item, index, values, strict) -> bool:
        """Fold values into a result (True) or a recorded skip (False)."""
        try:
            config, est, perf, limiter = run.backend.combine(
                item, run.machine, values)
        except ESTIMATION_ERRORS as exc:
            if strict and not isinstance(exc, SkipConfig):
                raise
            run.skips.append(SkippedConfig(
                run.wname, run.machine.name, _item_config(item),
                f"{type(exc).__name__}: {exc}"))
            return False
        run.add_result(EvalResult(
            workload=run.wname, machine=run.machine.name,
            backend=run.backend.name, index=index, config=config,
            estimate=est, perf=perf, limiter=limiter))
        return True

    def _skip(self, run, item, err) -> None:
        run.skips.append(SkippedConfig(
            run.wname, run.machine.name, _item_config(item),
            f"{type(err).__name__}: {err}"))

    # ---- sweep checkpointing (DESIGN.md §15) ----------------------------
    def _restore_run(self, run, rec) -> bool:
        """Rebuild a completed cell from its checkpoint record.  Entries
        are re-labelled with this sweep's workload name (the record may
        have been written under a plan-prefixed or coalesced alias); a
        record that fails to rebuild is ignored — the cell re-prices."""
        try:
            entries = [EvalResult(run.wname, e.machine, e.backend, e.index,
                                  e.config, e.estimate, e.perf, e.limiter)
                       for e in rec["entries"]]
            skips = [SkippedConfig(run.wname, s.machine, s.config, s.reason)
                     for s in rec["skips"]]
            pruned = [PrunedConfig(run.wname, p.machine, p.config, p.bound,
                                   p.threshold) for p in rec["pruned"]]
        except Exception:
            return False
        run.results = list(entries)
        run._ranked = entries
        run.skips = skips
        run.pruned = pruned
        run.ckpt_done = True
        return True

    def _ckpt_store(self, run) -> None:
        """Durably commit a just-completed cell to the resume journal."""
        if self._ckpt is None or run.ckpt_key is None or run.ckpt_done:
            return
        run.ckpt_done = True
        self._ckpt.put(run.ckpt_key, {
            "wname": run.wname,
            "entries": run.ranked_entries(),
            "skips": run.skips,
            "pruned": run.pruned,
        })

    # ---- exhaustive path -----------------------------------------------
    def _run_exhaustive(self, runs, pool, strict, stats, advance) -> None:
        cell_tasks = []
        all_tasks = []
        for run in runs:
            tasks_per_item = [
                run.backend.structural_tasks(it, run.machine)
                for it in run.items
            ]
            cell_tasks.append(tasks_per_item)
            for tl in tasks_per_item:
                all_tasks.extend(tl)
        self._resolve_batch(all_tasks, pool, stats)
        for run, tasks_per_item in zip(runs, cell_tasks):
            for idx, (item, tl) in enumerate(zip(run.items, tasks_per_item)):
                values = {}
                err = self._read_values(tl, values, strict)
                if err is not None:
                    self._skip(run, item, err)
                else:
                    self._combine(run, item, idx, values, strict)
                advance(1)
            self._ckpt_store(run)

    # ---- tiered bound-then-refine path ----------------------------------
    def _run_pruned(self, runs, pool, strict, stats, advance) -> None:
        # bound stage: resolve the cheap bound tasks for every item in one
        # batched pool pass (cached — warm runs and extent-sharing configs
        # pay nothing), then order each cell's items best-bound-first
        with obs.span("engine.bounds", cells=len(runs)) as _bsp:
            bound_tasks_per_run = []
            all_bound_tasks = []
            for run in runs:
                per_item = [run.backend.bound_tasks(item, run.machine)
                            for item in run.items]
                bound_tasks_per_run.append(per_item)
                for tl in per_item:
                    all_bound_tasks.extend(tl)
            pool_before = stats["pool_tasks"]
            self._resolve_batch(all_bound_tasks, pool, stats)
            # bound evaluations are accounted separately from structural work
            stats["bound_evals"] += stats["pool_tasks"] - pool_before
            stats["pool_tasks"] = pool_before
            _bsp.add(bound_evals=stats["bound_evals"])

            for run, per_item in zip(runs, bound_tasks_per_run):
                states = []
                for idx, (item, tl) in enumerate(zip(run.items, per_item)):
                    st = _Item(index=idx, item=item)
                    err = self._read_values(tl, st.values, strict)
                    if err is not None:
                        self._skip(run, item, err)
                        st.done = True
                        advance(1)
                    else:
                        st.bound = run.backend.tier_bound(item, run.machine,
                                                          st.values)
                    states.append(st)
                # stable best-bound-first order; index breaks ties so the
                # refinement schedule (and thus every threshold update) is
                # deterministic
                run.states = sorted(states, key=lambda s: (s.bound, s.index))

        # refinement rounds: each round advances the best-bound frontier of
        # every cell by one tier (cross-cell batched through one pool call),
        # then re-bounds and prunes against the tightening k-th-best time.
        # The small per-round chunk is load-bearing for prune quality, not
        # just batching: the threshold only tightens as chunks *complete*,
        # and most pruning happens when later items' (re-tightened) bounds
        # meet an already-converged threshold — advancing every survivor at
        # once would freeze the threshold at its seed value and refine
        # nearly everything.
        with obs.span("engine.refine", cells=len(runs)) as sp:
            sp.add(rounds=self._refine_loop(runs, pool, strict, stats,
                                            advance))

    def _refine_loop(self, runs, pool, strict, stats, advance) -> int:
        """Refinement rounds of the pruned path; returns rounds run."""
        rounds = 0
        while True:
            round_work = []  # (run, state, tier tasks)
            for run in runs:
                chunk = 0
                for st in run.states:
                    if st.done:
                        continue
                    if st.bound > run.threshold:
                        run.pruned.append(PrunedConfig(
                            run.wname, run.machine.name,
                            _item_config(st.item), st.bound, run.threshold))
                        st.done = True
                        advance(1)
                        continue
                    if chunk >= _ROUND_CHUNK:
                        continue
                    chunk += 1
                    if st.tiers is None:
                        st.tiers = [list(t) for t in
                                    run.backend.tiers(st.item, run.machine)]
                    round_work.append((run, st, st.tiers[st.tier]))
            # checkpoint cells that reached completion since the last round
            # (combines in the previous round, prunes in this pass) — the
            # per-round granularity is what bounds loss under SIGKILL
            if self._ckpt is not None:
                for run in runs:
                    if not run.ckpt_done and all(st.done
                                                 for st in run.states):
                        self._ckpt_store(run)
            if not round_work:
                return rounds
            rounds += 1
            self._resolve_batch(
                [t for _, _, tasks in round_work for t in tasks], pool, stats)
            for run, st, tasks in round_work:
                err = self._read_values(tasks, st.values, strict)
                if err is not None:
                    self._skip(run, st.item, err)
                    st.done = True
                    advance(1)
                    continue
                st.tier += 1
                if st.tier >= len(st.tiers):
                    self._combine(run, st.item, st.index, st.values, strict)
                    st.done = True
                    advance(1)
                else:
                    st.bound = run.backend.tier_bound(
                        st.item, run.machine, st.values)

    # ---- machine-axis batched path (DESIGN.md §11) ----------------------
    @staticmethod
    def _axis_key(run):
        """Grouping key for batched machine-axis evaluation, or None when
        the run must take a per-machine path (backend without the batched
        protocol, or unsignable state)."""
        backend = run.backend
        if not all(hasattr(backend, m) for m in _AXIS_METHODS):
            return None
        backend_sig = _backend_signature(backend)
        items_sig = _items_signature(run.items)
        if backend_sig is None or items_sig is None:
            return None
        try:
            gkey = backend.geometry_key(run.machine)
            key = (backend_sig, items_sig, type(run.machine).__name__, gkey)
            hash(key)
            return key
        except (TypeError, AttributeError):
            return None

    def _run_machine_axis(self, groups, pool, strict, stats, advance):
        """Structure once per geometry group, one batched rate program per
        group, scalar combine only for the selected per-machine entries —
        so every returned estimate is bitwise identical to the per-machine
        path by construction."""
        per_group_tasks = []
        all_tasks = []
        for g in groups:
            rep = g.runs[0].machine
            tasks_per_item = [g.backend.machine_axis_tasks(it, rep)
                              for it in g.items]
            per_group_tasks.append(tasks_per_item)
            for tl in tasks_per_item:
                all_tasks.extend(tl)
        self._resolve_batch(all_tasks, pool, stats)
        for g, tasks_per_item in zip(groups, per_group_tasks):
            machines = [r.machine for r in g.runs]
            live_idx, live_values, item_errs = [], [], []
            for idx, tl in enumerate(tasks_per_item):
                values: dict = {}
                err = self._read_values(tl, values, strict)
                if err is not None:
                    item_errs.append((idx, err))
                else:
                    live_idx.append(idx)
                    live_values.append(values)
            live_items = [g.items[i] for i in live_idx]
            if live_items:
                with obs.span("engine.rate", items=len(live_items),
                              machines=len(machines)):
                    orders, skip_lists = g.backend.batch_order(
                        live_items, live_values, machines)
            else:
                orders = [[] for _ in machines]
                skip_lists = [[] for _ in machines]
            for run, order, skiplist in zip(g.runs, orders, skip_lists):
                for idx, err in item_errs:
                    self._skip(run, g.items[idx], err)
                for pos, reason in skiplist:
                    run.skips.append(SkippedConfig(
                        run.wname, run.machine.name,
                        _item_config(live_items[pos]), reason))
                sel = list(order)
                if run.top_k is not None:
                    sel = sel[: run.top_k]
                for pos in sel:
                    try:
                        config, est, perf, limiter = (
                            g.backend.machine_axis_combine(
                                live_items[pos], run.machine,
                                live_values[pos]))
                    except ESTIMATION_ERRORS as exc:
                        if strict and not isinstance(exc, SkipConfig):
                            raise
                        run.skips.append(SkippedConfig(
                            run.wname, run.machine.name,
                            _item_config(live_items[pos]),
                            f"{type(exc).__name__}: {exc}"))
                        continue
                    run.add_result(EvalResult(
                        workload=run.wname, machine=run.machine.name,
                        backend=g.backend.name, index=live_idx[pos],
                        config=config, estimate=est, perf=perf,
                        limiter=limiter))
                advance(len(run.items))
                self._ckpt_store(run)


def _item_config(item):
    """The user-facing config of a backend item ((config, spec) or config)."""
    if isinstance(item, tuple) and len(item) == 2:
        return item[0]
    return item


def _as_list(x):
    if x is None:
        return []
    try:
        return list(x)
    except TypeError:
        return [x]
