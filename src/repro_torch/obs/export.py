"""Exporters: Chrome trace-event JSON (Perfetto-loadable) and a human
phase-time table.  A copy of ``repro.obs.export``.

``chrome_trace`` emits the classic trace-event format — complete ("X")
events with microsecond ``ts``/``dur`` plus process-name metadata — which
both ``chrome://tracing`` and https://ui.perfetto.dev open directly.  Spans
from pool workers keep their own ``pid`` and render as separate tracks on
the shared monotonic timeline.
"""
from __future__ import annotations

import json
import os

from . import spans as _spans


def chrome_trace(records=None) -> dict:
    """Trace-event dict for ``records`` (default: everything collected)."""
    records = _spans.spans() if records is None else list(records)
    main_pid = os.getpid()
    events = []
    for r in records:
        args = {"span_id": r.span_id, "cpu_ms": round(r.cpu_us / 1e3, 3)}
        if r.parent_id:
            args["parent_id"] = r.parent_id
        args.update(r.args)
        events.append({
            "name": r.name, "cat": r.cat, "ph": "X",
            "ts": round(r.t0_us, 3), "dur": round(r.dur_us, 3),
            "pid": r.pid, "tid": r.tid, "args": args,
        })
    for pid in sorted({r.pid for r in records}):
        label = "repro_torch" if pid == main_pid else f"pool-worker-{pid}"
        events.append({"name": "process_name", "ph": "M", "pid": pid,
                       "tid": 0, "args": {"name": label}})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


def write_trace(path: str, records=None) -> str:
    """Dump ``chrome_trace`` JSON to ``path``; returns the path.

    Atomic (``durable.atomic_write``): a crash mid-export — e.g. the
    daemon killed while flushing its trace on exit — leaves the previous
    trace intact rather than a truncated JSON no viewer can open.
    """
    from repro_torch import durable

    return durable.atomic_write(path, json.dumps(chrome_trace(records)))


def summary(records=None) -> str:
    """Aligned per-phase table: count, wall/CPU totals, share of the
    top-level wall time (the human counterpart of the trace dump)."""
    records = _spans.spans() if records is None else list(records)
    if not records:
        return "no spans recorded (telemetry disabled or reset)"
    root_wall_us = sum(r.dur_us for r in records if r.parent_id is None)
    agg: dict = {}
    for r in records:
        row = agg.setdefault(r.name, [0, 0.0, 0.0])
        row[0] += 1
        row[1] += r.dur_us
        row[2] += r.cpu_us
    rows = [("span", "count", "wall ms", "cpu ms", "% top")]
    for name, (n, wall, cpu) in sorted(agg.items(), key=lambda kv: -kv[1][1]):
        share = 100.0 * wall / root_wall_us if root_wall_us else 0.0
        rows.append((name, str(n), f"{wall / 1e3:.2f}", f"{cpu / 1e3:.2f}",
                     f"{share:.1f}"))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = ["  ".join(c.ljust(w) for c, w in zip(r, widths)).rstrip()
             for r in rows]
    lines.insert(1, "-" * len(lines[0]))
    return "\n".join(lines)


__all__ = ["chrome_trace", "write_trace", "summary"]
