"""Batched parallel task evaluation with deterministic result ordering.

Structural tasks are pure and independent, so they parallelize across a
process pool (the estimator is pure Python; threads would serialize on the
GIL).  Results are gathered in submission order — parallelism never changes
what the engine computes, only how fast.

Every task is wrapped so worker exceptions come back as values: the engine
turns them into skipped-config records (or re-raises under strict mode)
instead of tearing down the whole sweep.

Tasks are submitted in *chunks* of roughly ``4 x workers`` batches per run:
a suite sweep produces thousands of sub-millisecond structural tasks, and
one future per task makes pickling/IPC the dominant cost.  Chunking keeps
every worker busy while amortizing the round-trip; flattening the chunked
results preserves submission order exactly.

Failure model (DESIGN.md §13): a chunk whose worker crashes
(``BrokenProcessPool``) or blows the per-chunk deadline does not fail the
sweep.  The pool terminates and rebuilds the executor, then retries the
failed chunks with bounded exponential backoff.  Because tasks are pure,
a retried chunk recomputes exactly what the lost one would have — recovery
is bitwise invisible.  Chunks that keep failing are split to single-task
retries; a task that still fails alone is *quarantined*: its outcome
becomes ``("err", PoisonTaskError(...))``, which the engine records as a
skipped config (or raises under strict mode) — never a wrong number, never
a hang.  ``TaskPool.health`` counts rebuilds/retries/hangs/quarantines for
observability.

Durability boundary (DESIGN.md §15): everything here is *in-memory*
recovery within one sweep — workers hold no files and write no journals,
so a SIGKILL of the parent process loses at most the in-flight chunks.
Crash consistency across process death lives one layer up: the Explorer
checkpoints each completed cell to its sweep journal, and a resumed run
simply re-prices the cells whose tasks died with the pool.  Tasks are
pure, so re-running them is bitwise invisible.

A copy of ``repro.core.engine.pool`` whose start method also refuses
``fork`` once the parent has started CUDA (``_context``): a forked child of
a process with a CUDA context cannot use it and may hang.  The workers do
numpy arithmetic only and never touch the card.  The ``forkserver`` it
then starts is a process of its own that outlives the pools and, by
default, the parent too: ``stop_helpers`` stops and reaps it, and runs at
exit once a pool has started one.
"""
from __future__ import annotations

import atexit
import concurrent.futures
import multiprocessing
import os
import sys
import time
from concurrent.futures import ProcessPoolExecutor
from typing import Sequence

from repro_torch import faults, obs
from repro_torch.obs.metrics import CounterGroup

# Chunks submitted per worker per run: enough slack for load balancing
# between uneven task costs, few enough that IPC stays amortized.
_CHUNKS_PER_WORKER = 4

# Backoff between retry rounds: base * 2^round, capped (a sweep should
# recover from a crashed worker in well under a second).
_BACKOFF_CAP_S = 1.0


class PoisonTaskError(RuntimeError):
    """A task quarantined after repeatedly killing or wedging workers.

    Subclasses ``RuntimeError`` so the engine's outcome reader records it
    as a skipped config instead of aborting the sweep (strict mode still
    raises it).
    """


def guarded_call(fn, args) -> tuple:
    """Run one task, capturing the outcome as ``("ok", value)`` or
    ``("err", exception)``."""
    try:
        return ("ok", fn(*args))
    except Exception as exc:  # noqa: BLE001 — outcome-ified for the engine
        return ("err", exc)


def guarded_batch(calls: Sequence[tuple]) -> list:
    """Worker-side loop over one chunk of ``(fn, args)`` calls."""
    return [guarded_call(fn, args) for fn, args in calls]


def _pool_batch(calls: Sequence[tuple], ctx: tuple | None = None):
    """Worker-process chunk entry point.

    The crash/hang fault-injection sites live only here — never on the
    serial path — so an injected worker fault can kill a *pool worker* but
    never the parent.  ``ensure_env_plan`` makes forked workers (which
    inherit parent module state from before the plan was installed) and
    spawned/forkserver workers (fresh interpreters) adopt the env plan.

    ``ctx`` is the parent's telemetry context (``obs.current_context()``),
    shipped through task metadata under the same fork/spawn discipline as
    the fault plan.  When present, the chunk runs under a ``pool.chunk``
    child span and returns ``("obs", outcomes, records)`` so the parent can
    merge the worker's spans into its timeline; when absent (telemetry
    disabled) the return shape is the plain outcome list, unchanged.
    """
    faults.ensure_env_plan()
    faults.crash_point("pool.worker_crash")
    faults.hang_point("pool.worker_hang")
    if ctx is None:
        return guarded_batch(calls)
    obs.adopt(ctx)
    with obs.span("pool.chunk", "pool", tasks=len(calls)):
        out = guarded_batch(calls)
    return ("obs", out, obs.drain())


def default_workers() -> int:
    """Worker count: CPUs actually *available* to this process, optionally
    capped by ``REPRO_MAX_WORKERS``.

    ``os.cpu_count()`` reports the host's cores, which oversubscribes
    affinity-restricted CI containers — prefer ``os.process_cpu_count()``
    (3.13+) or the scheduler affinity mask where the platform has them.
    The env var can only lower the count (a cap, not an override).
    """
    avail = None
    if hasattr(os, "process_cpu_count"):
        avail = os.process_cpu_count()
    elif hasattr(os, "sched_getaffinity"):
        try:
            avail = len(os.sched_getaffinity(0))
        except OSError:
            avail = None
    n = avail or os.cpu_count() or 1
    env = os.environ.get("REPRO_MAX_WORKERS")
    if env:
        try:
            cap = int(env)
        except ValueError:
            cap = 0
        if cap > 0:
            n = min(n, cap)
    return max(n, 1)


def _cuda_started() -> bool:
    """Whether this process has a CUDA context.  Asks ``torch`` only when
    something already imported it: the engine itself never loads torch."""
    torch = sys.modules.get("torch")
    cuda = getattr(torch, "cuda", None)
    try:
        return bool(cuda is not None and cuda.is_initialized())
    except Exception:  # noqa: BLE001 — a half-imported torch: assume started
        return True


def _fork_safe() -> bool:
    """Plain fork is unsafe once a runtime that starts threads is loaded
    (jax/XLA — tested by name, never imported here) or CUDA has started."""
    return "jax" not in sys.modules and not _cuda_started()


def _context():
    """Pick a start method: plain fork is fastest, but forking a process
    whose XLA/JAX runtime already spawned threads, or that holds a CUDA
    context, can deadlock — fall back to forkserver (workers fork from a
    clean server process), then spawn, then serial (``None``) when
    ``__main__`` cannot be re-imported by a fresh interpreter."""
    methods = multiprocessing.get_all_start_methods()
    if "fork" in methods and _fork_safe():
        return multiprocessing.get_context("fork")
    if "forkserver" in methods and _main_reimportable():
        return multiprocessing.get_context("forkserver")
    if "spawn" in methods and _main_reimportable():
        return multiprocessing.get_context("spawn")
    return None  # no safe pool (fork unsafe + un-reimportable main): serial


_stops_at_exit = False


def stop_helpers() -> None:
    """Stop the forkserver and resource-tracker processes that a pool's
    start method started in this process, and reap them.  Call it when no
    pool is open; a later pool starts them again."""
    from multiprocessing import forkserver, resource_tracker

    # the tracker's pipe is shared with the forkserver: stop that first
    for helper in (forkserver._forkserver, resource_tracker._resource_tracker):
        stop = getattr(helper, "_stop", None)
        if stop is not None:
            stop()


def _main_reimportable() -> bool:
    """Non-fork start methods re-run __main__ in the worker; that breaks for
    stdin/interactive parents, so detect a real module or file."""
    main = sys.modules.get("__main__")
    if main is None:
        return False
    if getattr(main, "__spec__", None) is not None:  # python -m ...
        return True
    path = getattr(main, "__file__", None)
    return bool(path) and os.path.exists(path)


def _chunk(calls: list, n_chunks: int) -> list:
    size = max(1, -(-len(calls) // n_chunks))
    return [calls[i:i + size] for i in range(0, len(calls), size)]


def _default_deadline() -> float | None:
    env = os.environ.get("REPRO_POOL_DEADLINE_S")
    if not env:
        return None
    try:
        v = float(env)
    except ValueError:
        return None
    return v if v > 0 else None


class TaskPool:
    """A reusable, self-healing worker pool for one exploration sweep.

    The tiered search evaluates tasks in several rounds (bound, refine
    tiers, final combine inputs); spinning a fresh ``ProcessPoolExecutor``
    per round would pay worker startup each time.  ``TaskPool`` creates the
    executor lazily on the first non-trivial round and reuses it; a warm
    (fully cached) sweep never forks at all.

    ``chunk_deadline_s`` bounds how long one chunk may run before its
    worker is presumed hung (default from ``REPRO_POOL_DEADLINE_S``; None
    disables the deadline).  ``max_retries`` bounds consecutive
    *no-progress* rounds — a round that resolves at least one chunk resets
    the budget, so a long recovery is never mistaken for a poison task.

    Use as a context manager; ``run`` evaluates one round of calls.
    """

    def __init__(
        self,
        parallel: bool = False,
        max_workers: int | None = None,
        *,
        chunk_deadline_s: float | None = None,
        max_retries: int = 3,
        backoff_base_s: float = 0.05,
    ):
        self.parallel = parallel
        self.workers = max_workers or default_workers()
        self.chunk_deadline_s = (
            chunk_deadline_s if chunk_deadline_s is not None
            else _default_deadline())
        self.max_retries = max_retries
        self.backoff_base_s = backoff_base_s
        self.health = CounterGroup("pool.health", {
            "rebuilds": "executors torn down and rebuilt after a failure",
            "retries": "retry rounds over failed chunks",
            "hung_chunks": "chunks past the per-chunk deadline",
            "broken_pools": "worker-death (BrokenProcessPool) events",
            "quarantined": "tasks outcome-ified as PoisonTaskError",
        })
        self._executor = None
        self._broken = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False

    def close(self) -> None:
        if self._executor is not None:
            self._executor.shutdown()
            self._executor = None

    def _ensure_executor(self):
        global _stops_at_exit
        if self._executor is None and not self._broken:
            ctx = _context()
            if ctx is None:
                self._broken = True
                return None
            if ctx.get_start_method() != "fork" and not _stops_at_exit:
                atexit.register(stop_helpers)
                _stops_at_exit = True
            try:
                self._executor = ProcessPoolExecutor(
                    max_workers=self.workers, mp_context=ctx)
            except (OSError, ValueError, RuntimeError):
                self._broken = True
        return self._executor

    def _kill_executor(self) -> None:
        """Tear down an executor presumed broken or hung.  ``shutdown``
        alone would join hung workers forever, so terminate them first."""
        ex, self._executor = self._executor, None
        if ex is None:
            return
        for proc in list(getattr(ex, "_processes", {}).values()):
            try:
                proc.terminate()
            except Exception:  # noqa: BLE001 — already-dead workers
                pass
        try:
            ex.shutdown(wait=False, cancel_futures=True)
        except Exception:  # noqa: BLE001
            pass

    def _backoff(self, stall: int) -> None:
        delay = min(self.backoff_base_s * (2 ** max(stall - 1, 0)),
                    _BACKOFF_CAP_S)
        if delay > 0:
            time.sleep(delay)

    def run(self, calls: Sequence[tuple]) -> list:
        """Evaluate ``[(fn, args), ...]``, outcomes in input order."""
        calls = list(calls)
        if not calls:
            return []
        with obs.span("pool.run", "pool", tasks=len(calls)):
            if not (self.parallel and self.workers > 1 and len(calls) > 1):
                return guarded_batch(calls)
            if self._ensure_executor() is None:
                return guarded_batch(calls)
            return self._run_parallel(calls)

    def _run_parallel(self, calls: list) -> list:
        outcomes: list = [None] * len(calls)
        groups = _chunk(list(range(len(calls))),
                        self.workers * _CHUNKS_PER_WORKER)
        stall = 0       # consecutive rounds that resolved nothing
        split = False   # already escalated to single-task groups?
        # telemetry context rides in the chunk payload (like the fault
        # plan): workers under any start method parent their spans here
        ctx = obs.current_context()
        while groups:
            ex = self._ensure_executor()
            if ex is None:
                # pool permanently unavailable: finish in-process (the
                # legacy fallback; injected faults never fire here)
                for g in groups:
                    for i, out in zip(g, guarded_batch(
                            [calls[i] for i in g])):
                        outcomes[i] = out
                return outcomes
            futures = [(g, ex.submit(_pool_batch,
                                     [calls[i] for i in g], ctx))
                       for g in groups]
            failed, broken, progress = [], False, False
            for g, f in futures:
                try:
                    if broken:
                        # executor already condemned: only harvest results
                        # that finished before the failure, don't wait
                        if not f.done():
                            failed.append(g)
                            continue
                        res = f.result(timeout=0)
                    else:
                        res = f.result(timeout=self.chunk_deadline_s)
                except concurrent.futures.TimeoutError:
                    broken = True
                    self.health["hung_chunks"] += 1
                    failed.append(g)
                    continue
                except (OSError, RuntimeError):
                    # BrokenProcessPool and friends — a worker died
                    broken = True
                    self.health["broken_pools"] += 1
                    failed.append(g)
                    continue
                if isinstance(res, tuple) and res and res[0] == "obs":
                    obs.ingest(res[2])
                    res = res[1]
                for i, out in zip(g, res):
                    outcomes[i] = out
                progress = True
            if not failed:
                return outcomes
            if broken:
                self._kill_executor()
                self.health["rebuilds"] += 1
            stall = 0 if progress else stall + 1
            if stall > self.max_retries:
                if not split:
                    # one fresh budget with every failed task isolated in
                    # its own chunk — separates the poison task from its
                    # innocent chunk-mates
                    split, stall = True, 0
                    groups = [[i] for g in failed for i in g]
                else:
                    for g in failed:
                        for i in g:
                            outcomes[i] = ("err", PoisonTaskError(
                                "task quarantined: worker crashed or hung "
                                f"{self.max_retries + 1} times in a row"))
                        self.health["quarantined"] += len(g)
                    return outcomes
            else:
                groups = failed
            self.health["retries"] += 1
            self._backoff(stall)
        return outcomes


def run_tasks(
    calls: Sequence[tuple],
    parallel: bool = False,
    max_workers: int | None = None,
) -> list:
    """Evaluate ``[(fn, args), ...]`` and return outcomes in input order.

    One-shot wrapper over ``TaskPool`` (kept for API compatibility and
    single-round callers): ``parallel=True`` uses a process pool (never
    ``fork`` once CUDA has started, ``_context``), falling back to the
    serial path when only one worker is available, the batch is tiny, or
    no usable multiprocessing start method exists.
    """
    with TaskPool(parallel=parallel, max_workers=max_workers) as pool:
        return pool.run(calls)
