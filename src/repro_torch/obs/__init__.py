"""Unified telemetry for the pricing pipeline (DESIGN.md §14).

The port's copy of ``repro.obs``, so that the port never imports the JAX
package; the environment variable keeps its name.

Zero-dependency observability substrate: structured spans over every
pipeline phase (frontend trace/lower, bound tiers, exact pricing, cachesim
replay, rate stage, pool chunks, scheduler, daemon ops), a documented
metrics registry absorbing the historical scattered counters, and exporters
(Chrome trace-event / Perfetto JSON, phase-time table, daemon ``trace`` op).

Off by default; enable with any of

  * ``REPRO_TRACE_OUT=trace.json`` in the environment — collection starts
    at import and the merged trace is written at interpreter exit;
  * ``Explorer(trace_out="trace.json")`` — per-sweep dumps;
  * ``obs.enable()`` programmatically.

The disabled path costs one flag check per ``obs.span`` call site
(<2% on the paper-grid cold sweep, gated by ``benchmarks/bench_obs.py``),
and rankings are bitwise identical with telemetry on or off.
"""
from __future__ import annotations

import atexit
import multiprocessing
import os

from . import metrics
from .export import chrome_trace, summary, write_trace
from .spans import (
    SpanRecord,
    adopt,
    current_context,
    disable,
    drain,
    enable,
    enabled,
    ingest,
    reset,
    span,
    spans,
)

TRACE_ENV = "REPRO_TRACE_OUT"

_env_out = os.environ.get(TRACE_ENV)
if _env_out:
    enable()

    def _dump_env_trace(path=_env_out):
        # pool workers inherit the env; only the parent merges + dumps
        # (workers ship their spans back through the chunk results)
        if multiprocessing.parent_process() is not None:
            return
        if spans():
            write_trace(path)

    atexit.register(_dump_env_trace)


__all__ = [
    "SpanRecord", "span", "enable", "disable", "enabled", "reset",
    "spans", "drain", "ingest", "adopt", "current_context",
    "chrome_trace", "write_trace", "summary", "metrics", "TRACE_ENV",
]
