"""The device trace of a traced run, reduced to what the metric readers need.

``torch.profiler`` records the window; its Chrome trace is read back and
each device operation (kernel, memcpy, memset) is classed by origin:
``torch`` when PyTorch launched it inside one of its own ops (``aten::``),
``program`` otherwise.  The class comes from the launch: the profiler's
correlation id ties a device op to the runtime call that made it, and the
innermost host op (``cpu_op`` or annotation) running on that thread at the
call names its origin.  So a port kernel that is renamed or added keeps its
class, and so does a copy the port makes itself (the stencil's constant-bank
fill).  Only where no launching call is found does the name decide
(PyTorch's namespaces, and copies and fills).
"""
from __future__ import annotations

import json
import os
import re
import tempfile

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
_TORCH_NAME = re.compile(r"\bat::|at_cuda_detail|\bc10::|\bcub::|^Memcpy|^Memset")


def profiler(device_type: str):
    """A profiler over the host and, on the card, the device."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device_type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def events(prof) -> list:
    """The profiler's Chrome trace events (written to a temporary file under
    ``TMPDIR`` and removed)."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as fh:
            data = json.load(fh)
    finally:
        os.unlink(path)
    return data["traceEvents"] if isinstance(data, dict) else data


def _launchers(host: list) -> dict:
    """Correlation id -> name of the innermost op or annotation around the
    runtime call with that id, on the call's own thread."""
    by_tid: dict = {}
    for h in host:
        by_tid.setdefault(h["tid"], []).append(h)
    out = {}
    for evs in by_tid.values():
        # at one start time an op opens before the calls inside it
        evs.sort(key=lambda h: (h["ts"], h["corr"] is not None, -h["dur"]))
        stack = []
        for h in evs:
            while stack and stack[-1]["ts"] + stack[-1]["dur"] < h["ts"]:
                stack.pop()
            if h["corr"] is not None:
                out[h["corr"]] = stack[-1]["name"] if stack else None
            elif h["cat"] in ("cpu_op", "user_annotation"):
                stack.append(h)
    return out


def classify(trace_events: list) -> tuple:
    """(device ops, host ops) of a Chrome trace.  A device op is
    ``{"name", "ts", "dur", "origin"}`` (microseconds), sorted by start; a
    host op ``{"name", "ts", "dur", "cat", "tid", "corr"}``."""
    host, dev = [], []
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat in HOST_CATS:
            corr = (ev.get("args") or {}).get("correlation") if cat.startswith("cuda_") else None
            host.append({"name": ev["name"], "ts": float(ev["ts"]), "dur": float(ev.get("dur", 0.0)),
                         "cat": cat, "tid": ev.get("tid"), "corr": corr})
        elif cat in DEVICE_CATS:
            dev.append(ev)
    launcher = _launchers(host)
    ops = []
    for ev in dev:
        corr = (ev.get("args") or {}).get("correlation")
        link = launcher.get(corr)
        if link is not None:
            origin = "torch" if link.startswith("aten::") else "program"
        else:
            origin = "torch" if _TORCH_NAME.search(ev["name"]) else "program"
        ops.append({"name": ev["name"], "ts": float(ev["ts"]), "dur": float(ev.get("dur", 0.0)),
                    "origin": origin})
    ops.sort(key=lambda o: o["ts"])
    host.sort(key=lambda o: o["ts"])
    return ops, host


def busy_intervals(ops: list) -> list:
    """The union of the device ops' intervals, as sorted (start, end) pairs."""
    out = []
    for op in ops:
        s, e = op["ts"], op["ts"] + op["dur"]
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(p) for p in out]


def _short(name: str, n: int = 120) -> str:
    return name if len(name) <= n else name[:n - 3] + "..."


def breakdown(ops: list, host: list, top: int = 10) -> dict:
    """The device ops that took most time, summed by name, and the longest
    idle gaps, each named by the innermost host op running at its start."""
    by_name: dict = {}
    for op in ops:
        by_name[op["name"]] = by_name.get(op["name"], 0.0) + op["dur"]
    device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    spans = busy_intervals(ops)
    gaps = sorted(((spans[i + 1][0] - spans[i][1], spans[i][1]) for i in range(len(spans) - 1)),
                  reverse=True)[:top]
    idle = []
    for length, at in gaps:
        inner = None
        for h in host:
            if h["ts"] > at:
                break
            if h["ts"] + h["dur"] >= at and (inner is None or h["ts"] >= inner["ts"]):
                inner = h
        idle.append([_short(inner["name"]) if inner else "host: no op", length * 1e-6])
    return {"device_ops": [[_short(n), d * 1e-6] for n, d in device_ops], "idle_gaps": idle}


def in_range(ops: list, t0: float, t1: float) -> list:
    """The device ops that start within [t0, t1] (microseconds)."""
    return [op for op in ops if t0 <= op["ts"] <= t1]
