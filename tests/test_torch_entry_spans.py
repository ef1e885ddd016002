"""The measurement inside the stencil and LBM entry points: the ``obs``
spans of a step (``*.step`` around ``*.pad``, ``*.launch`` and the LBM's
``lbm.phase_sum``), their mirror into a recording ``torch.profiler``, the
launch and ranking-memo counter groups, and the device trace's ``origin``
under the new annotations.  The card-only case traces a short loop of two
benchmark cells at their own size and attributes every device op to a
span."""
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from portbench import harness
from portbench import trace as T
from repro_torch import obs
from repro_torch.kernels.lbm_d3q15 import generator as LG
from repro_torch.kernels.lbm_d3q15 import kernel as LK
from repro_torch.kernels.lbm_d3q15.ops import lbm_step
from repro_torch.kernels.stencil3d25 import generator as SG
from repro_torch.kernels.stencil3d25 import kernel as SK
from repro_torch.kernels.stencil3d25.ops import star_stencil
from repro_torch.obs import metrics

STAR_DOMAIN = (5, 8, 12)
LBM_DOMAIN = (4, 4, 6)
CHILDREN = {"stencil.step": ["stencil.pad", "stencil.launch"],
            "lbm.step": ["lbm.pad", "lbm.launch", "lbm.phase_sum"]}


@pytest.fixture(autouse=True)
def _clean_obs():
    """Telemetry is process-global: every test starts and ends off and empty."""
    obs.disable()
    obs.reset()
    yield
    obs.disable()
    obs.reset()


def _star(config=None, domain=STAR_DOMAIN):
    src = torch.rand(domain, dtype=torch.float64, generator=torch.Generator().manual_seed(3))
    return star_stencil(src, r=1, config=config)


def _lbm(config=None, domain=LBM_DOMAIN):
    phase = torch.rand(domain, dtype=torch.float64, generator=torch.Generator().manual_seed(4))
    return lbm_step(phase.expand(15, *domain) / 15, phase, tau=1.2, config=config)


CALLS = {"stencil.step": lambda: _star({"variant": "ring"}),
         "lbm.step": lambda: _lbm({"variant": "ytile", "ty": 2})}


def _count_record_function(monkeypatch) -> list:
    """Every ``torch.profiler.record_function`` opened, by name."""
    opened, real = [], torch.profiler.record_function

    def counting(name, *a, **k):
        opened.append(name)
        return real(name, *a, **k)

    monkeypatch.setattr(torch.profiler, "record_function", counting)
    return opened


@pytest.mark.parametrize("step", list(CALLS))
def test_a_call_records_its_spans_nested(step, monkeypatch):
    opened = _count_record_function(monkeypatch)
    obs.enable()
    CALLS[step]()
    obs.disable()
    recs = {r.name: r for r in obs.spans()}
    assert set(recs) == {step, *CHILDREN[step]}
    top = recs[step]
    assert top.parent_id is None and top.args["variant"] in ("ring", "ytile")
    kids = sorted((recs[n] for n in CHILDREN[step]), key=lambda r: r.t0_us)
    assert [r.name for r in kids] == CHILDREN[step]
    assert all(r.parent_id == top.span_id for r in kids)
    assert all(top.t0_us <= r.t0_us and r.t0_us + r.dur_us <= top.t0_us + top.dur_us
               for r in kids)
    assert opened == []          # no profiler records: no annotation is opened


@pytest.mark.parametrize("step", list(CALLS))
def test_off_records_nothing_and_opens_no_annotation(step, monkeypatch):
    opened = _count_record_function(monkeypatch)
    with T.profiler("cpu"):
        CALLS[step]()
    CALLS[step]()
    assert obs.spans() == [] and opened == []


@pytest.mark.parametrize("step", list(CALLS))
def test_spans_are_the_profilers_annotations(step, monkeypatch):
    opened = _count_record_function(monkeypatch)
    obs.enable()
    with T.profiler("cpu") as prof:
        CALLS[step]()
    obs.disable()
    names = [step, *CHILDREN[step]]
    assert sorted(opened) == sorted(names)
    _ops, host = T.classify(T.events(prof))
    notes = {h["name"]: h for h in host if h["cat"] == "user_annotation" and h["name"] in names}
    assert set(notes) == set(names)
    top = notes[step]
    for name in CHILDREN[step]:
        h = notes[name]
        assert top["ts"] <= h["ts"] and h["ts"] + h["dur"] <= top["ts"] + top["dur"]
        assert h["tid"] == top["tid"]
    # the aten ops the pad and the sum run sit inside their spans, never around them
    aten = [h for h in host if h["cat"] == "cpu_op" and h["name"].startswith("aten::")]
    pad = notes[CHILDREN[step][0]]
    assert any(pad["ts"] <= h["ts"] <= pad["ts"] + pad["dur"] for h in aten)


@pytest.mark.parametrize("memo,call,domain", [
    (SG, _star, (3, 6, 10)),
    (LG, _lbm, (3, 4, 4)),
], ids=["stencil3d25", "lbm_d3q15"])
def test_rank_memo_counts_one_miss_then_hits(memo, call, domain, monkeypatch):
    monkeypatch.setattr(memo, "_RANKINGS", {})
    before = metrics.snapshot()
    obs.enable()
    for _ in range(3):
        call(None, domain)
    obs.disable()
    family = memo.__name__.split(".")[-2]
    got = metrics.delta(before)
    assert (got[f"kernels.{family}.rank_memo.misses"],
            got[f"kernels.{family}.rank_memo.hits"]) == (1, 2)
    # the ranking runs in the first step's own time, outside pad and launch
    recs = obs.spans()
    by_id = {r.span_id: r for r in recs}

    def outermost(r):
        while r.parent_id in by_id:
            r = by_id[r.parent_id]
        return r

    steps = sorted((r for r in recs if r.name.endswith(".step")), key=lambda r: r.t0_us)
    engine = [r for r in recs if r.name.startswith("engine.")]
    assert engine and len(steps) == 3
    assert {outermost(r).span_id for r in engine} == {steps[0].span_id}
    assert all(by_id[r.parent_id].name.endswith(".step") for r in recs
               if r.name.endswith((".pad", ".launch", ".phase_sum")))
    assert not any(by_id[r.parent_id].name.endswith((".pad", ".launch", ".phase_sum"))
                   for r in recs if r.parent_id in by_id)


def test_counter_groups_are_registered_and_documented():
    described = metrics.describe()
    for group in (SK.LAUNCHES, LK.LAUNCHES, SG.RANK_MEMO, LG.RANK_MEMO):
        assert isinstance(group, metrics.CounterGroup) and isinstance(group, dict)
        for field in group:
            assert described[f"{group.name}.{field}"].doc
        assert set(group) <= {k.split(".")[-1] for k in metrics.snapshot()
                              if k.startswith(group.name + ".")}
    assert SK.LAUNCHES.name == "kernels.stencil3d25.launches"
    assert LK.LAUNCHES.name == "kernels.lbm_d3q15.launches"
    # the wrappers' plain versions on the CPU launch nothing
    before = dict(SK.LAUNCHES), dict(LK.LAUNCHES)
    _star({"variant": "ring"})
    _lbm({"variant": "ytile", "ty": 2})
    assert (dict(SK.LAUNCHES), dict(LK.LAUNCHES)) == before


def _synthetic_trace(annotated: bool) -> list:
    """A Chrome trace of one stencil step and one phase sum: the pad's copy
    and fill under ``aten::`` ops, the kernel and the bank's copy from the
    program's own calls, the sum under ``aten::sum``; with or without the
    program's annotations around them."""
    def host(name, cat, ts, dur, corr=None):
        ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 7, "pid": 1}
        if corr is not None:
            ev["args"] = {"correlation": corr}
        return ev

    def device(name, cat, ts, corr):
        return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": 5.0, "tid": 0,
                "pid": 0, "args": {"correlation": corr}}

    evs = [host("portbench.step", "user_annotation", 0.0, 200.0),
           host("aten::constant_pad_nd", "cpu_op", 3.0, 30.0),
           host("aten::fill_", "cpu_op", 4.0, 5.0),
           host("cudaLaunchKernel", "cuda_runtime", 5.0, 1.0, 1),
           host("aten::copy_", "cpu_op", 20.0, 5.0),
           host("cudaLaunchKernel", "cuda_runtime", 21.0, 1.0, 2),
           host("cudaMemcpyAsync", "cuda_runtime", 45.0, 1.0, 3),
           host("cuLaunchKernel", "cuda_driver", 50.0, 1.0, 4),
           host("aten::sum", "cpu_op", 110.0, 20.0),
           host("cudaLaunchKernel", "cuda_runtime", 115.0, 1.0, 5),
           device("void at::native::vectorized_elementwise_kernel<4, FillFunctor>", "kernel",
                  300.0, 1),
           device("void at::native::elementwise_kernel<128, 2, copy>", "kernel", 310.0, 2),
           device("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 320.0, 3),
           device("void star_zmarch_kernel<double, 4>", "kernel", 330.0, 4),
           device("void at::native::reduce_kernel<128, 4, ReduceOp<double>>", "kernel", 340.0, 5)]
    if annotated:
        evs += [host("stencil.step", "user_annotation", 1.0, 100.0),
                host("stencil.pad", "user_annotation", 2.0, 35.0),
                host("stencil.launch", "user_annotation", 40.0, 20.0),
                host("lbm.phase_sum", "user_annotation", 105.0, 30.0)]
    return evs


def test_annotations_leave_every_ops_origin_as_it_was():
    plain, _ = T.classify(_synthetic_trace(False))
    marked, host = T.classify(_synthetic_trace(True))
    want = ["torch", "torch", "program", "program", "torch"]
    assert [o["origin"] for o in plain] == [o["origin"] for o in marked] == want
    assert [o["name"] for o in plain] == [o["name"] for o in marked]
    assert {h["name"] for h in host if h["cat"] == "user_annotation"} >= {
        "stencil.step", "stencil.pad", "stencil.launch", "lbm.phase_sum"}


# ---- on the card -------------------------------------------------------------
PROGRAM = ("stencil.", "lbm.")


def _op_spans(trace_events) -> list:
    """For each device op, in ``trace.classify``'s order, the names of the
    annotations around the runtime call that launched it, outermost first."""
    calls, notes, dev = {}, [], []
    for ev in trace_events:
        if ev.get("ph") != "X":
            continue
        cat = ev.get("cat", "")
        if cat == "user_annotation":
            notes.append(ev)
        elif cat in ("cuda_runtime", "cuda_driver"):
            calls[(ev.get("args") or {}).get("correlation")] = ev
        elif cat in T.DEVICE_CATS:
            dev.append(ev)
    dev.sort(key=lambda e: float(e["ts"]))
    notes.sort(key=lambda n: (float(n["ts"]), -float(n.get("dur", 0.0))))
    out = []
    for ev in dev:
        call = calls.get((ev.get("args") or {}).get("correlation"))
        out.append([] if call is None else [
            n["name"] for n in notes
            if n.get("tid") == call.get("tid")
            and float(n["ts"]) <= float(call["ts"]) <= float(n["ts"]) + float(n.get("dur", 0.0))])
    return out


def test_op_spans_of_the_synthetic_trace():
    spans = [[n for n in s if n.startswith(PROGRAM)] for s in _op_spans(_synthetic_trace(True))]
    assert spans == [["stencil.step", "stencil.pad"]] * 2 + [["stencil.step", "stencil.launch"]] * 2 \
        + [["lbm.phase_sum"]]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["star25.ring", "lbm15.ranked"])
def test_traced_loop_puts_every_device_op_under_a_span(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    work = harness.load_json("workloads", cell)
    config = harness.load_json("configs", work["config"])
    driver = harness.load_module("drivers", config["driver"])
    clock = harness.Clock(torch, "cuda")
    fields, operands = driver.init(config, 2**31 + 17, "cuda")

    def step(f):
        return driver.program_step(f, operands, config, work["entry"])

    obs.enable()
    harness.window(torch, clock, step, fields, mid=0, steps=4)
    with T.profiler("cuda") as prof:
        win = harness.window(torch, clock, step, fields, mid=0, traced=True, steps=20)
    obs.disable()
    evs = T.events(prof)
    ops, _host = T.classify(evs)
    spans = _op_spans(evs)
    assert len(spans) == len(ops) and ops
    launch, pad, phase_sum = 0.0, 0.0, 0.0
    for op, names in zip(ops, spans):
        mine = [n for n in names if n.startswith(PROGRAM)]
        assert mine and mine[0].endswith(".step"), (op["name"], names)
        if op["origin"] == "program" and mine[-1].endswith(".pad"):
            assert "halo_pad" in op["name"], (op["name"], names)   # the pad is the program's
            pad += op["dur"]
        elif op["origin"] == "program":
            assert mine[-1].endswith(".launch"), (op["name"], names)
            launch += op["dur"]
        else:       # PyTorch's only op left in a step is the LBM's phase sum
            assert mine[-1] == "lbm.phase_sum", (op["name"], names)
            phase_sum += op["dur"]
    rec = {"device_ops": ops, "steps": win["steps"]}
    glue = harness.load_module("metrics", "glue_ms_per_step").read(rec)
    assert phase_sum * 1e-3 / win["steps"] == pytest.approx(glue, rel=5e-3)
    assert launch > 0 and pad > 0 and (phase_sum > 0) == cell.startswith("lbm")
