"""Structured spans: nested, thread-safe, cross-process phase timing.

A copy of ``repro.obs.spans``.

A span is one timed phase of the pipeline (``engine.exact``, ``pool.chunk``,
``serve.price`` ...) recorded as a context manager:

    with obs.span("engine.sweep", kind="pruned") as sp:
        ...
        sp.add(cells=12)           # counters attached at exit

Design constraints (DESIGN.md §14):

  * **off by default, near-zero overhead** — ``span()`` performs exactly one
    module-global flag check when telemetry is disabled and returns a shared
    no-op singleton; no allocation beyond the caller's kwargs, no locking,
    no clock reads.  The overhead contract (<2% disabled on the paper-grid
    cold sweep) is gated by ``benchmarks/bench_obs.py``;
  * **thread safety** — finished records append under one lock; the active
    span stack is thread-local, so concurrent scheduler/client threads nest
    independently;
  * **cross-process merge** — timestamps are ``time.perf_counter_ns`` based
    (CLOCK_MONOTONIC on Linux: one clock across fork/spawn children on the
    same host), so pool-worker spans shipped back with chunk results align
    with the parent timeline.  ``current_context()`` captures the parent
    identity that travels in task metadata; workers ``adopt()`` it, record
    child spans, and ``drain()`` them into the chunk return value — the same
    env/metadata discipline as ``faults.ensure_env_plan``.

Records are plain named tuples — cheap to pickle across the pool boundary
and stable for exporters (``obs.export``).
"""
from __future__ import annotations

import itertools
import os
import threading
import time
from typing import NamedTuple


class SpanRecord(NamedTuple):
    """One finished span.  Times are microseconds; ``t0_us`` is on the
    host-wide monotonic clock so records from different processes share a
    timeline."""

    name: str
    cat: str
    trace_id: str
    span_id: str          # "<pid hex>.<seq>" — unique across processes
    parent_id: str | None
    pid: int
    tid: int
    t0_us: float
    dur_us: float
    cpu_us: float         # thread CPU time consumed inside the span
    args: dict


_enabled = False
_lock = threading.Lock()
_records: list = []
_trace_id: str | None = None
_ids = itertools.count(1)
_owner_pid = os.getpid()
_tls = threading.local()


def _fork_check() -> None:
    """Reset inherited collector state in a forked child.

    A fork()ed pool worker inherits the parent's finished records and the
    forking thread's span stack; both belong to the parent's timeline, so
    the first touch in a new pid starts clean (the parent keeps its own
    copies untouched)."""
    global _owner_pid, _records
    if os.getpid() != _owner_pid:
        _owner_pid = os.getpid()
        _records = []
        _tls.__dict__.clear()


def enabled() -> bool:
    return _enabled


def enable() -> None:
    """Turn span collection on (idempotent; keeps existing records)."""
    global _enabled, _trace_id
    _fork_check()
    if _trace_id is None:
        _trace_id = f"{os.getpid():x}-{time.time_ns():x}"
    _enabled = True


def disable() -> None:
    """Stop collecting (records already gathered are kept until reset)."""
    global _enabled
    _enabled = False


def reset() -> None:
    """Drop every collected record (enablement is unchanged)."""
    _fork_check()
    with _lock:
        _records.clear()


def spans() -> list:
    """Snapshot of the finished records collected so far."""
    _fork_check()
    with _lock:
        return list(_records)


def drain() -> list:
    """Detach and return every collected record (worker-side harvest)."""
    _fork_check()
    with _lock:
        out = list(_records)
        _records.clear()
    return out


def ingest(records) -> None:
    """Merge records harvested elsewhere (pool workers, remote daemons)
    into this process's timeline."""
    if not records:
        return
    _fork_check()
    recs = [r if isinstance(r, SpanRecord) else SpanRecord(*r)
            for r in records]
    with _lock:
        _records.extend(recs)


# ---------------------------------------------------------------------------
# Context propagation (fork and spawn workers alike)
# ---------------------------------------------------------------------------
def current_context() -> tuple | None:
    """(trace_id, parent span id) identifying the innermost active span.

    None when telemetry is disabled — callers pass the context through task
    metadata (pickled with the chunk), so a disabled sweep ships nothing.
    """
    if not _enabled:
        return None
    stack = getattr(_tls, "stack", None)
    if stack:
        return (stack[-1].trace_id, stack[-1].span_id)
    return (_trace_id, None)


def adopt(ctx: tuple) -> None:
    """Worker-side: enable collection with spans parented under ``ctx``.

    Safe under every start method: fork children reset inherited state via
    ``_fork_check``; spawn/forkserver children start fresh and are enabled
    here, driven purely by the task metadata (no env inheritance needed).
    """
    global _enabled
    _fork_check()
    _tls.remote = (ctx[0], ctx[1])
    _enabled = True


class _NullSpan:
    """Shared disabled-path singleton: every method is a no-op."""

    __slots__ = ()
    enabled = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def add(self, **counters):
        pass


_NULL = _NullSpan()


class _Span:
    __slots__ = ("name", "cat", "args", "trace_id", "span_id", "parent_id",
                 "_t0", "_cpu0")
    enabled = True

    def __init__(self, name: str, cat: str, args: dict):
        self.name = name
        self.cat = cat
        self.args = args

    def add(self, **counters) -> None:
        """Attach counters/attributes; they ride in the record's args."""
        self.args.update(counters)

    def __enter__(self):
        _fork_check()
        stack = getattr(_tls, "stack", None)
        if stack is None:
            stack = _tls.stack = []
        if stack:
            self.trace_id = stack[-1].trace_id
            self.parent_id = stack[-1].span_id
        else:
            remote = getattr(_tls, "remote", None)
            if remote is not None:
                self.trace_id, self.parent_id = remote
            else:
                self.trace_id, self.parent_id = _trace_id or "", None
        self.span_id = f"{os.getpid():x}.{next(_ids)}"
        stack.append(self)
        self._cpu0 = time.thread_time_ns()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        dur = time.perf_counter_ns() - self._t0
        cpu = time.thread_time_ns() - self._cpu0
        stack = getattr(_tls, "stack", None)
        if stack and stack[-1] is self:
            stack.pop()
        elif stack and self in stack:       # mispaired exit: stay consistent
            stack.remove(self)
        if exc_type is not None:
            self.args.setdefault("error", exc_type.__name__)
        rec = SpanRecord(self.name, self.cat, self.trace_id, self.span_id,
                         self.parent_id, os.getpid(), threading.get_ident(),
                         self._t0 / 1e3, dur / 1e3, cpu / 1e3, self.args)
        with _lock:
            _records.append(rec)
        return False


def span(name: str, cat: str = "phase", **args):
    """Open a span context manager (``_NULL`` no-op while disabled)."""
    if not _enabled:
        return _NULL
    return _Span(name, cat, args)


__all__ = [
    "SpanRecord", "span", "enable", "disable", "enabled", "reset",
    "spans", "drain", "ingest", "adopt", "current_context",
]
