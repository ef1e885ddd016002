"""The port's pricing front door (``repro_torch.api``) against ``repro.api``.

The same requests — five GPU kernel specs at small domains on the H100 and
on a 1/8-scaled A100, hand-built Pallas specs on the TPU v5e — go through
both packages' ``price``: the rankings must agree bitwise, field by field,
exhaustive and pruned to a top-k (the pooled sweep is held to these in
``test_torch_engine.py``).  Also: the codec round-trips a request exactly
and writes the reference's bytes, a newer request version is refused, a
traced kernel (a Triton launcher here, the Pallas builder there) prices
and bounds as the reference's, and the paper-loop example ranks through
``price`` and runs its winners on the CPU.
"""
import dataclasses
import functools
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro.core import access as ref_access  # noqa: E402
from repro.core import machines as ref_machines  # noqa: E402
from repro.core import specs as ref_specs  # noqa: E402
from repro.core import tpu_adapt as ref_tpu  # noqa: E402
from repro.core.engine import Workload as RefWorkload  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
from repro_torch import api  # noqa: E402
from repro_torch.core import machines, specs, tpu_adapt  # noqa: E402
from repro_torch.core.engine import Explorer, Workload  # noqa: E402
from repro_torch.core.selector import enumerate_gpu_configs  # noqa: E402
from repro_torch.serve import schema  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ESTIMATE_FIELDS = ("kernel", "machine", "lups", "l1_cycles_per_lup",
                   "l2_l1_load_per_lup", "l2_l1_store_per_lup",
                   "dram_load_per_lup", "dram_store_per_lup", "flops_per_lup",
                   "perf_lups", "limiter", "limiter_rates")

# 1/8-scaled A100 (tests/test_engine.py's SMALL), in each package's class
_SMALL = dict(name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
              l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8,
              l2_bw=5000e9 / 8, peak_flops_dp=9.7e12 / 8)
SMALL = machines.GPUMachine(**_SMALL)
REF_SMALL = ref_machines.GPUMachine(**_SMALL)
MACHINES = {"H100": (machines.H100, ref_machines.H100), "A100/8": (SMALL, REF_SMALL)}

TRANSPOSE_SHAPE = (96, 160)


def _ref_copy(obj):
    """The reference's instance of a port dataclass with the same fields."""
    if dataclasses.is_dataclass(obj):
        cls = getattr(ref_access, type(obj).__name__)
        return cls(**{f.name: _ref_copy(getattr(obj, f.name))
                      for f in dataclasses.fields(obj)})
    if isinstance(obj, tuple):
        return tuple(_ref_copy(x) for x in obj)
    return obj


# name -> (port spec, reference spec) at small domains; the reference has
# the transpose's spec only from its tracer, which test_torch_core.py pins
# equal to the port's hand-written one, so the reference gets a copy of it
SPECS = {
    "star_stencil_3d": lambda: (specs.star_stencil_3d(2, (24, 32, 64)),
                                ref_specs.star_stencil_3d(2, (24, 32, 64))),
    "lbm_d3q15": lambda: (specs.lbm_d3q15((6, 12, 20)),
                          ref_specs.lbm_d3q15((6, 12, 20))),
    "stencil_2d5pt": lambda: (specs.stencil_2d5pt((64, 128)),
                              ref_specs.stencil_2d5pt((64, 128))),
    "transpose_pad": lambda: (specs.transpose_pad(TRANSPOSE_SHAPE),
                              _ref_copy(specs.transpose_pad(TRANSPOSE_SHAPE))),
    "matmul_naive": lambda: (specs.matmul_naive(64, 48, 80, 4),
                             ref_specs.matmul_naive(64, 48, 80, 4)),
}
MODES = {"exhaustive": None, "top_k": 7}


def _requests(top_k):
    """One request of all five specs on both machines, in each package."""
    pairs = [SPECS[name]() for name in SPECS]
    configs = tuple(enumerate_gpu_configs())
    mine = api.PriceRequest(
        workloads=[Workload(name, gpu_spec=p, gpu_configs=configs)
                   for name, (p, _) in zip(SPECS, pairs)],
        machines=[m for m, _ in MACHINES.values()], top_k=top_k)
    ref_configs = tuple(_ref_copy(c) for c in configs)
    ref = ref_api.PriceRequest(
        workloads=[RefWorkload(name, gpu_spec=r, gpu_configs=ref_configs)
                   for name, (_, r) in zip(SPECS, pairs)],
        machines=[r for _, r in MACHINES.values()], top_k=top_k)
    return mine, ref


@functools.cache
def _priced(mode):
    mine, ref = _requests(MODES[mode])
    return api.price(mine), ref_api.price(ref)


def _fields(obj) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


def assert_entries_equal(mine, ref):
    """Rankings equal bitwise, entry by entry, field by field."""
    assert len(mine) == len(ref) > 0
    for m, f in zip(mine, ref):
        assert (m.workload, m.machine, m.backend, m.index, m.perf, m.limiter) == (
            f.workload, f.machine, f.backend, f.index, f.perf, f.limiter)
        assert (m.config.block, m.config.folding) == (f.config.block, f.config.folding)
        for name in ESTIMATE_FIELDS:
            assert getattr(m.estimate, name) == getattr(f.estimate, name), name
        assert _fields(m.estimate.dram_breakdown) == _fields(f.estimate.dram_breakdown)
        assert _fields(m.estimate.l2_breakdown) == _fields(f.estimate.l2_breakdown)


@pytest.mark.parametrize("machine", list(MACHINES))
@pytest.mark.parametrize("spec", list(SPECS))
@pytest.mark.parametrize("mode", list(MODES))
def test_price_bitwise_equals_reference(mode, spec, machine):
    mine, ref = _priced(mode)
    machine = MACHINES[machine][0].name
    assert_entries_equal(mine.ranking(spec, machine), ref.ranking(spec, machine))
    want = 168 if MODES[mode] is None else MODES[mode]
    assert len(mine.ranking(spec, machine)) == want
    def pruned(report):
        return [(p.config.block, p.config.folding, p.bound, p.threshold)
                for p in report.pruned_for(spec, machine)]
    assert pruned(mine.report) == pruned(ref.report)
    assert mine.skipped == [] and ref.skipped == []


@pytest.mark.parametrize("mode", list(MODES))
def test_sweep_statistics_equal_reference(mode):
    mine, ref = _priced(mode)
    assert mine.cache_stats == ref.cache_stats
    assert {k: v for k, v in mine.report.metrics.items()} == ref.report.metrics
    if MODES[mode] is not None:
        assert 0 < mine.report.prune_rate == ref.report.prune_rate


def test_top_k_is_the_exhaustive_head():
    full, _ = _priced("exhaustive")
    top, _ = _priced("top_k")
    for spec in SPECS:
        for machine, _ in MACHINES.values():
            head = full.ranking(spec, machine.name)[:MODES["top_k"]]
            assert_entries_equal(top.ranking(spec, machine.name), head)


def test_machine_axis_equals_reference_and_per_machine():
    spec, ref_spec = SPECS["star_stencil_3d"]()
    pair = [machines.A100, machines.A100_80G]
    mine = api.price(api.PriceRequest(workloads=[spec], machines=pair, top_k=5,
                                      machine_axis=True))
    ref = ref_api.price(ref_api.PriceRequest(
        workloads=[ref_spec], machines=[ref_machines.A100, ref_machines.A100_80G],
        top_k=5, machine_axis=True))
    assert_entries_equal(mine.entries, ref.entries)
    assert mine.cache_stats == ref.cache_stats
    assert mine.cache_stats["geometry_groups"] == 1
    for m in pair:
        alone = api.price(api.gpu_request(spec, m, top_k=5))
        assert_entries_equal(mine.ranking(spec.name, m.name), alone.entries)


def test_price_bounds_equals_reference():
    spec, ref_spec = SPECS["star_stencil_3d"]()
    mine = api.price_bounds(api.gpu_request(spec, "H100", top_k=10))
    ref = ref_api.price_bounds(ref_api.gpu_request(ref_spec, "H100", top_k=10))
    assert mine.degraded and ref.degraded
    assert [(e.config.block, e.config.folding, e.perf, e.limiter) for e in mine.entries] == \
        [(e.config.block, e.config.folding, e.perf, e.limiter) for e in ref.entries]
    assert mine.cache_stats == ref.cache_stats


# ---- the TPU half: hand-built Pallas specs ---------------------------------
def _pallas_candidates(pkg, elem_bytes=8):
    """(config, PallasKernelSpec) pairs of a replane-style stencil and a
    blocked GEMM, built by hand in ``pkg`` (the port's or the reference's
    ``tpu_adapt``): no tracing.  The 1024 x 1024 GEMM block is past VMEM."""
    Op, Mm, Spec = pkg.OperandSpec, pkg.MatmulShape, pkg.PallasKernelSpec
    out = []
    for ty in (8, 16, 32):
        out.append(({"variant": "replane", "ty": ty}, Spec(
            name="star_replane", grid=(64, 512 // ty),
            operands=(Op("src", (9, ty + 8, 648), elem_bytes, grid_deps=(0, 1)),
                      Op("out", (1, ty, 640), elem_bytes, grid_deps=(0, 1),
                         is_output=True)),
            vpu_elems_per_step=25.0 * ty * 640, vpu_shape=(ty, 640),
            work_per_step=ty * 640.0, elem_bytes=elem_bytes)))
    for b in (128, 256, 1024):
        out.append(({"bm": b, "bk": 128, "bn": b}, Spec(
            name="matmul", grid=(4096 // b, 4096 // b, 32),
            operands=(Op("a", (b, 128), 2, grid_deps=(0, 2)),
                      Op("b", (128, b), 2, grid_deps=(2, 1)),
                      Op("c", (b, b), 4, grid_deps=(0, 1), is_output=True, n_buffers=1)),
            matmuls_per_step=(Mm(b, 128, b),), scratch_bytes=b * b * 4 * 32,
            work_per_step=2.0 * b * b * 128, elem_bytes=2)))
    return out


def test_hand_built_pallas_spec_prices_as_reference():
    for (cfg, mine), (_, ref) in zip(_pallas_candidates(tpu_adapt),
                                     _pallas_candidates(ref_tpu)):
        a = tpu_adapt.estimate_pallas(mine, machines.TPU_V5E)
        b = ref_tpu.estimate_pallas(ref, ref_machines.TPU_V5E)
        assert _fields(a) == _fields(b), cfg
        assert tpu_adapt.pallas_time_floor(mine) == ref_tpu.pallas_time_floor(ref)
    assert _fields(machines.TPU_V5E) == _fields(ref_machines.TPU_V5E)


@pytest.mark.parametrize("top_k", [None, 2])
def test_pallas_request_bitwise_equals_reference(top_k):
    mine = api.price(api.pallas_request(_pallas_candidates(tpu_adapt), "TPUv5e",
                                        workload="tpu", top_k=top_k))
    ref = ref_api.price(ref_api.pallas_request(_pallas_candidates(ref_tpu), "TPUv5e",
                                               workload="tpu", top_k=top_k))
    assert [(e.index, e.config, _fields(e.estimate)) for e in mine.entries] == \
        [(e.index, e.config, _fields(e.estimate)) for e in ref.entries]
    assert [(s.config, s.reason) for s in mine.skipped] == \
        [(s.config, s.reason) for s in ref.skipped]
    if top_k is None:   # a pruned candidate's VMEM check never runs
        assert [s.config for s in mine.skipped] == [{"bm": 1024, "bk": 128, "bn": 1024}]
    assert len(mine.entries) == (top_k or 5)


# ---- request and result codec ----------------------------------------------
def test_request_round_trips_exactly_and_encodes_as_reference():
    mine, ref = _requests(5)
    assert schema.decode(schema.encode(mine)) == mine
    assert schema.loads(schema.dumps(mine)) == mine
    # the wire tags are class names, never module paths: the same request
    # is the same bytes, and the same digest, in both packages
    assert schema.dumps(mine) == ref_schema.dumps(ref)
    assert schema.request_digest(mine) == ref_schema.request_digest(ref)
    assert schema.SCHEMA_VERSION == ref_schema.SCHEMA_VERSION


def test_result_round_trips_exactly():
    result, _ = _priced("top_k")
    back = schema.loads(schema.dumps(result))
    assert back == result
    assert result.to_json_dict() == schema.encode(result)
    assert_entries_equal(back.entries, result.entries)


def test_future_request_version_is_refused():
    spec, _ = SPECS["stencil_2d5pt"]()
    request = dataclasses.replace(api.gpu_request(spec, "H100"),
                                  version=api.API_VERSION + 1)
    for fn in (api.price, api.price_bounds):
        with pytest.raises(ValueError, match="newer"):
            fn(request)
    with pytest.raises(ValueError, match="schema version"):
        schema.loads(schema.dumps(request).replace('"schema_version":1', '"schema_version":2'))


def _traced_requests(top_k):
    """A Triton kernel traced by the port and the same kernel as a Pallas
    builder traced by the reference (under the test-only ``pl.load`` shim
    its tracer patches), at one tiling: one payload, two packages."""
    import jax
    import jax.numpy as jnp
    from jax.experimental import pallas as pl

    from repro.frontend import arg as ref_arg
    from repro_torch.frontend import arg
    from repro_torch.frontend.triton_kernels import scale_shift

    (Y, X), (by, bx) = (96, 256), (32, 128)

    def kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0 + 1.0

    def builder(x):
        return pl.pallas_call(
            kernel, grid=(Y // by, X // bx),
            in_specs=[pl.BlockSpec((by, bx), lambda i, j: (i, j))],
            out_specs=pl.BlockSpec((by, bx), lambda i, j: (i, j)),
            out_shape=jax.ShapeDtypeStruct((Y, X), jnp.float32), interpret=True)(x)

    mine = api.kernel_request(scale_shift(block=(by, bx)), [arg("x", (Y, X))],
                              [SMALL, "H100", "TPUv5e"], name="ss", top_k=top_k)
    ref = ref_api.kernel_request(builder, [ref_arg("x", (Y, X))],
                                 [REF_SMALL, "H100", "TPUv5e"], name="ss", top_k=top_k)
    return mine, ref


@pytest.mark.parametrize("top_k", [None, 3])
def test_traced_request_prices_and_bounds_as_reference(top_k, monkeypatch):
    from jax.experimental import pallas

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pallas, "load", load, raising=False)
    monkeypatch.setattr(pallas, "store", store, raising=False)
    mine, ref = _traced_requests(top_k)
    assert schema.encode(mine) == ref_schema.encode(ref)
    for fn, ref_fn in ((api.price, ref_api.price), (api.price_bounds, ref_api.price_bounds)):
        got, want = fn(mine), ref_fn(ref)
        assert got.degraded == want.degraded == (fn is api.price_bounds)
        for machine in (SMALL.name, "H100-SXM5-80G", "TPUv5e"):
            assert got.ranking("ss", machine), machine
            assert schema.encode(got.ranking("ss", machine)) == \
                ref_schema.encode(want.ranking("ss", machine))
        assert got.skipped == [] and want.skipped == []


def test_unknown_machine_names_raise():
    with pytest.raises(KeyError, match="known"):
        api.price(api.PriceRequest(machines=["H200"]))
    assert machines.get_machine("H100") is machines.H100
    assert set(machines.MACHINES) == set(ref_machines.MACHINES)


def test_engine_is_reused_across_requests():
    spec, _ = SPECS["stencil_2d5pt"]()
    engine = Explorer()
    first = api.price(api.gpu_request(spec, "H100"), engine=engine)
    again = api.price(api.gpu_request(spec, "H100"), engine=engine)
    assert first.cache_stats["misses"] > 0
    assert again.cache_stats["misses"] == 0 and again.cache_stats["pool_tasks"] == 0
    assert_entries_equal(again.entries, first.entries)


# ---- the paper-loop example ------------------------------------------------
def _example():
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_stencil_codegen
    finally:
        sys.path.remove(str(ROOT / "examples"))
    return torch_stencil_codegen


def _ref_tpu_sweep(monkeypatch, st_dom, lbm_dom):
    """The reference example's TPU sweep at these domains, its candidates
    traced under a test-only shim for the ``pl.load`` / ``pl.store`` that
    jax 0.9.0 no longer has (its caches cleared after)."""
    from jax.experimental import pallas as pl

    from repro.kernels.lbm_d3q15 import generator as ref_lbm
    from repro.kernels.stencil3d25 import generator as ref_st

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    with monkeypatch.context() as m:
        m.setattr(pl, "load", load, raising=False)
        m.setattr(pl, "store", store, raising=False)
        try:
            return ref_api.price(ref_api.PriceRequest(
                workloads=[
                    RefWorkload("stencil3d25", tpu_candidates=list(
                        ref_st.candidate_specs(4, st_dom, elem_bytes=8))),
                    RefWorkload("lbm_d3q15", tpu_candidates=list(
                        ref_lbm.candidate_specs(lbm_dom, elem_bytes=8))[:5]),
                ],
                machines=[ref_machines.TPU_V5E])).report
        finally:
            ref_st._candidates.cache_clear()
            ref_lbm._candidates.cache_clear()


def test_example_ranks_through_price_and_runs_the_winners(capsys, monkeypatch):
    from repro_torch.kernels.lbm_d3q15.generator import rank_configs as lbm_rank
    from repro_torch.kernels.stencil3d25.generator import rank_configs as st_rank

    ex = _example()
    st_dom, lbm_dom = (16, 24, 40), (6, 16, 16)
    out = ex.main(device="cpu", stencil_domain=st_dom, lbm_domain=lbm_dom, show=3)
    result = out["result"]
    assert isinstance(result, api.PriceResult)
    for name, ranked in (("stencil3d25", st_rank(ex.R, st_dom, 8)),
                         ("lbm_d3q15", lbm_rank(lbm_dom, 8))):
        entries = result.ranking(name)
        assert len(entries) == len(ranked) == 168
        assert [(e.config, e.perf) for e in entries] == [(rc.launch, rc.perf) for rc in ranked]
    assert out["stencil"]["launch"] == st_rank(ex.R, st_dom, 8)[0].launch
    assert out["lbm"]["launch"] == lbm_rank(lbm_dom, 8)[0].launch
    assert out["stencil"]["max_abs_err"] <= ex.TOL["atol"]
    assert out["lbm"]["max_abs_err"] <= ex.TOL["atol"]
    text = capsys.readouterr().out
    assert "{'variant': 'ring'}" in text and "{'variant': 'ytile', 'ty': 8}" in text
    assert "168 launches ranked" in text
    # the TPU sweep, as the reference's example prices it
    tpu, want = out["tpu"].report, _ref_tpu_sweep(monkeypatch, st_dom, lbm_dom)
    for name in ("stencil3d25", "lbm_d3q15"):
        mine, ref = tpu.ranking(name), want.ranking(name)
        assert [(e.config, e.limiter, dataclasses.astuple(e.estimate)) for e in mine] == [
            (e.config, e.limiter, dataclasses.astuple(e.estimate)) for e in ref]
        assert [(s.config, s.reason) for s in tpu.skipped_for(name)] == [
            (s.config, s.reason) for s in want.skipped_for(name)]
        for e in mine:
            assert f"  {str(e.config):38s} {e.estimate.bytes_per_work:6.1f} B/" in text
    assert len(tpu.ranking("stencil3d25")) == 3 and len(tpu.ranking("lbm_d3q15")) == 2
    assert f"TPU v5e: stencil 3D25pt, domain {st_dom}, f64" in text


def test_example_never_falls_back_to_the_cpu(monkeypatch):
    ex = _example()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ex.main(stencil_domain=(16, 24, 40), lbm_domain=(6, 10, 16))
