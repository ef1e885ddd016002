"""Run one cell of the port's benchmark.

Everything that belongs to one cell, configuration, family or metric sits
in a file of its own, found by the name ``BENCHMARK.json`` gives it:

* ``workloads/<cell>.json``: its configuration, the entry point's config
  (``entry``: null ranks, an object pins), the candidate space of
  ``pick_efficiency_pct`` (``candidates``, or null) and its ``why``;
* ``configs/<config>.json``: the sizes as run, the family's ``driver``
  and the limit of each compared output (``limits``);
* ``drivers/<family>.py``: fields from the seed, a step of the program,
  a step of the reference (see ``drivers/__init__.py``);
* ``metrics/<metric>.py``: ``read(rec)`` returns the metric from the
  run's records, or None when the run has nothing it reads.

A run: the fields are made on the device from the seed; one step (a
ranked cell ranks at it) and then ``WARMUP_STEPS`` steps of the window's
own loop warm the kernels and the allocator; then the window is a closed
time loop, each step fed the previous step's output, for ``seconds``,
with a CUDA event before each step; it ends in a synchronize.  The first
step, one drawn from the seed and the last are held against the
reference once the window has closed.
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path

from portbench import trace as T

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "repro"})
CANDIDATE_REPS = 3
WARMUP_STEPS = 8   # of the window's own loop, so its kept fields find cached blocks
LOOKAHEAD = 8      # steps the host may run ahead of the device


class Refused(Exception):
    """The run cannot give a result; ``code`` is its exit code."""

    def __init__(self, message: str, code: int = 2):
        super().__init__(message)
        self.code = code


def cache_bytecode(root: Path = ROOT) -> None:
    """Keep the compiled bytecode of every module this process imports in
    the checkout (``.portbench-cache/pyc``), written by the first run and
    read by the next, even where the environment asks for none: otherwise
    each run compiles all of ``torch`` again, seconds of set-up that vary
    from run to run."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = str(root / ".portbench-cache" / "pyc")


def manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def load_json(kind: str, name: str, bench: Path = BENCH) -> dict:
    path = bench / kind / f"{name}.json"
    if not path.is_file():
        raise Refused(f"no {kind[:-1]} file {path}")
    return json.loads(path.read_text())


def load_module(kind: str, name: str, bench: Path = BENCH):
    path = bench / kind / f"{name}.py"
    if not path.is_file():
        raise Refused(f"no {kind[:-1]} file {path}")
    spec = importlib.util.spec_from_file_location(
        f"portbench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metrics_for(man: dict, workload: str, trace: bool) -> list:
    """The manifest's metrics this cell reports in a run of this kind."""
    group = man["per_layer"] if trace else man["end_to_end"]
    return [m for m in group if workload in m.get("workloads", [workload])]


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is the JAX stack's or the JAX
    package's, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & FORBIDDEN)


class Clock:
    """Marks on the device's stream (CUDA events) or, on the CPU, the host."""

    def __init__(self, torch, device_type: str):
        self.torch = torch
        self.cuda = device_type == "cuda"

    def mark(self):
        if not self.cuda:
            return time.perf_counter()
        ev = self.torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def wait(self, mark) -> None:
        if self.cuda:
            mark.synchronize()

    def sync(self) -> None:
        if self.cuda:
            self.torch.cuda.synchronize()

    def ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3


def _annotate(torch, on: bool, name: str):
    return torch.profiler.record_function(name) if on else contextlib.nullcontext()


def window(torch, clock, step, fields, mid: int, traced: bool = False, *,
           seconds: float = math.inf, steps: int | None = None) -> dict:
    """The time loop: steps back to back for ``seconds`` of host time (or
    ``steps`` steps), the host at most ``LOOKAHEAD`` steps ahead of the
    device.  Keeps the inputs and outputs of the first step, of step
    ``mid`` and of the last."""
    marks, keep = [], {}
    prev = fields
    end = time.perf_counter() + seconds
    i = 0
    while True:
        if i >= LOOKAHEAD:
            with _annotate(torch, traced, "portbench.wait"):
                clock.wait(marks[i - LOOKAHEAD])
        if time.perf_counter() >= end or i == steps:
            break
        marks.append(clock.mark())
        with _annotate(torch, traced, "portbench.step"):
            out = step(fields)
        if i == 0:
            keep["first"] = (fields, out)
        if i == mid:
            keep["mid"] = (fields, out)
        prev, fields = fields, out
        i += 1
    last = clock.mark()
    clock.sync()
    if i:
        keep["last"] = (prev, fields)
    marks.append(last)
    step_ms = [clock.ms(a, b) for a, b in zip(marks, marks[1:])]
    return {"steps": i, "step_ms": step_ms, "window_ms": clock.ms(marks[0], last) if i else 0.0,
            "keep": keep}


def rel_err(torch, got, want) -> float:
    """max |got - want| over max |want|; inf when ``got`` is not finite or
    its shape differs."""
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        return math.inf
    scale = float(want.abs().max())
    return float((got - want).abs().max()) / (scale if scale > 0 else 1.0)


def check(torch, driver, operands, config, keep: dict) -> dict:
    """Each kept step's outputs against the reference's step from the same
    inputs: ``{"<output>.<step>": (error, limit)}``."""
    out = {}
    for tag in ("first", "mid", "last"):
        if tag not in keep:
            continue
        given, got = keep[tag]
        want = driver.reference_step(given, operands, config)
        for name, g, w in zip(driver.OUTPUTS, got, want):
            out[f"{name}.{tag}"] = (rel_err(torch, g, w), float(config["limits"][name]))
        del want
    return out


def sweep(torch, clock, driver, fields, operands, config, space: list, device_type: str) -> list:
    """Each candidate of the space run through the entry point, pinned, on
    the same fields: the device ms a call in the program's own kernels
    (None where the candidate does not run on this domain)."""
    runs = []
    for cand in space:
        try:
            driver.program_step(fields, operands, config, cand)
            runs.append(cand)
        except ValueError:
            pass
    clock.sync()
    with T.profiler(device_type) as prof:
        for i, cand in enumerate(runs):
            with torch.profiler.record_function(f"portbench.candidate.{i}"):
                for _ in range(CANDIDATE_REPS):
                    driver.program_step(fields, operands, config, cand)
                clock.sync()
    ops, host = T.classify(T.events(prof))
    spans = {h["name"]: h for h in host if h["cat"] == "user_annotation"}
    out = [{"config": c, "kernel_ms": None} for c in space if c not in runs]
    for i, cand in enumerate(runs):
        h = spans.get(f"portbench.candidate.{i}")
        mine = [o for o in T.in_range(ops, h["ts"], h["ts"] + h["dur"])
                if o["origin"] == "program"] if h else []
        ms = sum(o["dur"] for o in mine) / CANDIDATE_REPS * 1e-3 if mine else None
        out.append({"config": cand, "kernel_ms": ms})
    return out


def run_cell(man: dict, name: str, seed: int, seconds: float, trace: bool, *,
             device: str = "cuda", bench: Path = BENCH, control: str | None = None,
             t0: float | None = None) -> dict:
    """One run of cell ``name``; returns the result line as a dict.  Raises
    ``Refused`` where it cannot give one."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = next((w for w in man["workloads"] if w["name"] == name), None)
    if cell is None:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    import torch

    parts = {"import_torch": time.perf_counter() - t0}
    if device == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
            raise Refused(f"cell {name} needs {cell['chips']} CUDA device(s); "
                          f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                          "available", 3)
    work = load_json("workloads", name, bench)
    config = load_json("configs", work["config"], bench)
    driver = load_module("drivers", config["driver"], bench)
    readers = {m["name"]: load_module("metrics", m["name"], bench)
               for m in metrics_for(man, name, trace)}
    clock = Clock(torch, device)
    seed = int(seed) & (2**64 - 1)
    fields, operands = driver.init(config, seed, device)
    clock.sync()
    parts["fields"] = time.perf_counter() - t0
    if control is None:
        def step(f):
            return driver.program_step(f, operands, config, work["entry"])
    elif control == "fp32":
        def step(f):
            return driver.reference_step(f, operands, config, torch.float32)
    else:
        raise Refused(f"unknown control {control!r}")

    obs = None
    if trace and control is None:
        from repro_torch import obs

        obs.reset()
        obs.enable()
    step(fields)
    clock.sync()
    parts["first_step"] = time.perf_counter() - t0
    tail = window(torch, clock, step, fields, mid=2, steps=WARMUP_STEPS)["step_ms"][-4:]
    spans = []
    if obs is not None:
        spans = obs.spans()
        obs.disable()
    est = max(sum(tail) / len(tail), 1e-3)
    mid = random.Random(seed).randint(1, max(1, int(0.5 * seconds * 1e3 / est)))
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()     # the peak is the window's, not the warm-up's
    setup_s = time.perf_counter() - t0

    with T.profiler(device) if trace else contextlib.nullcontext() as prof:
        win = window(torch, clock, step, fields, mid, trace, seconds=seconds)
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    keep = win.pop("keep")
    del fields

    rec = {"setup_s": setup_s, "points": driver.points(config), "bound_ms": driver.bound_ms(config),
           "spans": spans, "device_ops": None, "candidates": None, **win}
    dev = {"platform": "gpu" if device == "cuda" else "cpu",
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
           "count": cell["chips"], "memory_peak_bytes": int(peak)}
    result_breakdown = None
    if trace:
        ops, host = T.classify(T.events(prof))
        del prof
        busy = T.busy_intervals(ops)
        rec["device_ops"] = ops
        rec["busy_ms"] = sum(e - s for s, e in busy) * 1e-3
        dev["busy_s"] = rec["busy_ms"] * 1e-3
        dev["window_s"] = win["window_ms"] * 1e-3
        result_breakdown = T.breakdown(ops, host)
        if work.get("candidates") and control is None:
            space = load_json("configs", work["candidates"], bench)["candidates"]
            rec["candidates"] = sweep(torch, clock, driver, keep["first"][0], operands, config,
                                      space, device)
    checks = check(torch, driver, operands, config, keep)
    del keep
    failed = sum(1 for tag in ("first", "mid", "last")
                 if any(v > lim for k, (v, lim) in checks.items() if k.endswith("." + tag)))
    metrics = {}
    for m in metrics_for(man, name, trace):
        value = readers[m["name"]].read(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(checks) and failed == 0 and win["steps"] > 0,
              "attempted": win["steps"], "failed": failed, "metrics": metrics, "device": dev}
    if result_breakdown is not None:
        result["breakdown"] = result_breakdown
    result["setup_parts_s"] = parts   # seconds from the start to the end of each
    # a non-finite output reads as the largest double, so the line stays JSON
    result["checks"] = {k: {"value": min(v, sys.float_info.max), "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
