"""The port's model suite (``repro_torch.suite``), its configs and the API's
plan requests against ``repro.suite`` / ``repro.api``.

The reference prices a plan's TPU half from traced Pallas specs, and its
tracer fails on the installed jax.  The tests therefore give it, inside the
test, the hand-written forms its own ``tests/test_frontend.py`` pins the
traced specs to (``ref_declared``); the port declares the same forms
(``tpu_candidate_specs``), which are also held to the reference's traced
specs under the tracer's test-only ``pl.load`` shim.  Then every lowered
plan, every suite report (all ten archs x four shapes, five machines,
exhaustive and top-1) and the wire forms must equal the reference's
exactly.
"""
import dataclasses
import functools
import runpy
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro import api as ref_api  # noqa: E402
from repro import configs as ref_configs  # noqa: E402
from repro import suite as ref_suite  # noqa: E402
from repro.core import machines as ref_machines  # noqa: E402
from repro.core import roofline as ref_roofline  # noqa: E402
from repro.core import tpu_adapt as ref_tpu  # noqa: E402
from repro.layers import shapes as ref_shapes  # noqa: E402
from repro.serve import schema as ref_schema  # noqa: E402
from repro_torch import api, configs, suite  # noqa: E402
from repro_torch.core import machines, roofline, tpu_adapt  # noqa: E402
from repro_torch.core.engine import Explorer, Workload  # noqa: E402
from repro_torch.kernels.flash_attention import generator as flash_gen  # noqa: E402
from repro_torch.kernels.matmul import generator as matmul_gen  # noqa: E402
from repro_torch.layers import shapes  # noqa: E402
from repro_torch.serve import schema  # noqa: E402
from repro_torch.suite import lowering, report  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
ARCHS = list(ref_configs.ARCHS)
SHAPES = list(ref_configs.SHAPES)

# 1/8-scaled A100 (tests/test_suite.py's SMALL_GPU), in each package's class
_SMALL = dict(name="A100/8", n_sms=13, clock_hz=1.41e9, l1_bytes=192 * 1024,
              l2_bytes=20 * 1024 * 1024 // 8, dram_bw=1400e9 / 8,
              l2_bw=5000e9 / 8, peak_flops_dp=9.7e12 / 8)
SMALL = machines.GPUMachine(**_SMALL)
REF_SMALL = ref_machines.GPUMachine(**_SMALL)
NAMED = ["V100", "A100", "H100", "TPUv5e"]


# ---------------------------------------------------------------------------
# the reference's TPU candidates in the hand-written form its tests pin
# ---------------------------------------------------------------------------
def _ref_matmul_specs(M, K, N, elem_bytes):
    from repro.kernels.matmul.generator import _space

    out = []
    for cfg in _space(M, K, N):
        bm, bk, bn = cfg["bm"], cfg["bk"], cfg["bn"]
        out.append((cfg, ref_tpu.PallasKernelSpec(
            name=f"mm_{bm}x{bk}x{bn}", grid=(M // bm, N // bn, K // bk),
            operands=(
                ref_tpu.OperandSpec("a", (bm, bk), elem_bytes, grid_deps=(0, 2)),
                ref_tpu.OperandSpec("b", (bk, bn), elem_bytes, grid_deps=(1, 2)),
                ref_tpu.OperandSpec("o", (bm, bn), elem_bytes, grid_deps=(0, 1),
                                    is_output=True),
            ),
            matmuls_per_step=(ref_tpu.MatmulShape(bm, bk, bn),),
            scratch_bytes=bm * bn * 4,
            work_per_step=2.0 * bm * bk * bn, elem_bytes=elem_bytes)))
    return tuple(out)


def _ref_flash_specs(B, Hq, Hkv, Sq, Skv, D, causal, elem_bytes):
    from repro.kernels.flash_attention.generator import _space

    tri = 0.5 if causal and Sq == Skv else 1.0
    out = []
    for cfg in _space(Sq, Skv):
        bq, bk = cfg["bq"], cfg["bk"]
        out.append((cfg, ref_tpu.PallasKernelSpec(
            name=f"fa_{bq}x{bk}", grid=(B * Hq, Sq // bq, Skv // bk),
            operands=(
                ref_tpu.OperandSpec("q", (1, 1, bq, D), elem_bytes, grid_deps=(0, 1)),
                ref_tpu.OperandSpec("k", (1, 1, bk, D), elem_bytes, grid_deps=(0, 2)),
                ref_tpu.OperandSpec("v", (1, 1, bk, D), elem_bytes, grid_deps=(0, 2)),
                ref_tpu.OperandSpec("o", (1, 1, bq, D), elem_bytes, grid_deps=(0, 1),
                                    is_output=True),
            ),
            matmuls_per_step=(ref_tpu.MatmulShape(bq, D, bk),
                              ref_tpu.MatmulShape(bq, bk, D)),
            vpu_elems_per_step=6.0 * bq * bk * tri, vpu_shape=(bq, bk),
            scratch_bytes=(bq * D + 2 * bq * 128) * 4,
            work_per_step=float(bq * bk) * tri, elem_bytes=elem_bytes)))
    return tuple(out)


@pytest.fixture
def ref_declared(monkeypatch):
    """The reference's generators give the hand-written specs (memoised per
    shape, as its ``lru_cache`` does) and its suite starts a fresh candidate
    memo, so no such spec outlives the test."""
    import repro.kernels.flash_attention.generator as ref_flash
    import repro.kernels.matmul.generator as ref_matmul
    import repro.suite.lowering as ref_lowering

    monkeypatch.setattr(ref_matmul, "_candidates", functools.lru_cache(None)(_ref_matmul_specs))
    monkeypatch.setattr(ref_flash, "_candidates", functools.lru_cache(None)(_ref_flash_specs))
    monkeypatch.setattr(ref_lowering, "_candidate_memo", {})


def _wire(obj, codec):
    """``codec.encode(obj)`` with every ``wall_time_s`` field dropped."""
    def strip(node):
        if isinstance(node, dict):
            return {k: strip(v) for k, v in node.items() if k != "wall_time_s"}
        if isinstance(node, list):
            return [strip(x) for x in node]
        return node

    return strip(codec.encode(obj))


def _json(suite_report) -> dict:
    out = suite_report.to_json()
    del out["wall_time_s"]
    return out


# ---------------------------------------------------------------------------
# configs and layer shapes
# ---------------------------------------------------------------------------
def test_arch_registry_equals_reference():
    assert configs.ARCHS == ref_configs.ARCHS
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in ref_configs.SHAPES.items()}
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_shapes_equal_reference(arch):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    assert type(cfg).__module__.startswith("repro_torch.")
    for mine, theirs in ((cfg, ref), (cfg.reduced(), ref.reduced())):
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs)
        assert (mine.resolved_head_dim, mine.padded_vocab, mine.is_sub_quadratic) == (
            theirs.resolved_head_dim, theirs.padded_vocab, theirs.is_sub_quadratic)
        assert [s.name for s in configs.valid_cells(mine)] == [
            s.name for s in ref_configs.valid_cells(theirs)]
        hd = mine.resolved_head_dim
        for fn, args in (
                ("attention_proj_shapes", (mine.d_model, mine.n_heads, mine.n_kv, hd)),
                ("mlp_shapes", (mine.d_model, mine.d_ff, mine.mlp)),
                ("moe_shapes", (mine.d_model, mine.d_ff, max(mine.n_experts, 1), mine.mlp)),
                ("mamba2_dims", (mine.d_model, mine.ssm_state, mine.ssm_head_dim)),
                ("rwkv6_dims", (mine.d_model, mine.ssm_head_dim)),
                ("rwkv6_channel_mix_shapes", (mine.d_model, mine.d_ff))):
            assert getattr(shapes, fn)(*args) == getattr(ref_shapes, fn)(*args), fn
    assert (shapes.MAMBA_CHUNK, shapes.RWKV_CHUNK) == (ref_shapes.MAMBA_CHUNK,
                                                      ref_shapes.RWKV_CHUNK)


# ---------------------------------------------------------------------------
# the declared TPU specs
# ---------------------------------------------------------------------------
def _assert_specs_equal(mine, theirs):
    """Equal configs and specs field by field (each package's classes), the
    same wire encoding, and the same Pallas estimate on the TPU v5e."""
    assert [c for c, _ in mine] == [c for c, _ in theirs]
    for (_, a), (_, b) in zip(mine, theirs):
        assert isinstance(a, tpu_adapt.PallasKernelSpec)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert schema.encode(a) == ref_schema.encode(b)
        ea = tpu_adapt.estimate_pallas(a, machines.TPU_V5E)
        eb = ref_tpu.estimate_pallas(b, ref_machines.TPU_V5E)
        assert dataclasses.astuple(ea) == dataclasses.astuple(eb)
    assert len(mine) == len(theirs) > 0


@pytest.mark.parametrize("M,K,N", [(512, 512, 512), (128, 256, 384), (4096, 2048, 3072),
                                   (1024, 4096, 14336), (4096, 2048, 49408)])
def test_matmul_declared_specs_equal_handwritten(M, K, N):
    mine = list(matmul_gen.tpu_candidate_specs(M, K, N, 2))
    _assert_specs_equal(mine, _ref_matmul_specs(M, K, N, 2))
    # memoised per shape: repeated layers share the candidate objects
    assert all(a is b for (_, a), (_, b) in zip(mine, matmul_gen.tpu_candidate_specs(M, K, N, 2)))
    assert [c for c, _ in mine] == list(matmul_gen.tpu_space(M, K, N))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Hq,Hkv,Sq,Skv,D", [(2, 8, 2, 512, 512, 64), (1, 32, 8, 4096, 4096, 64),
                                             (1, 32, 8, 512, 384, 64), (4, 8, 8, 256, 1536, 96)])
def test_flash_declared_specs_equal_handwritten(B, Hq, Hkv, Sq, Skv, D, causal):
    mine = list(flash_gen.tpu_candidate_specs(B, Hq, Hkv, Sq, Skv, D, causal, 2))
    _assert_specs_equal(mine, _ref_flash_specs(B, Hq, Hkv, Sq, Skv, D, causal, 2))
    assert all(a is b for (_, a), (_, b) in zip(
        mine, flash_gen.tpu_candidate_specs(B, Hq, Hkv, Sq, Skv, D, int(causal), 2)))


def test_declared_specs_equal_traced_reference(monkeypatch):
    """The reference's traced specs themselves, at small shapes: its tracer
    patches ``pl.load`` and ``pl.store``, which jax 0.9.0 no longer has, so a
    test-only shim gives it something to patch (as ``test_torch_core.py``
    does for the transpose); the caches are cleared after."""
    from jax.experimental import pallas

    import repro.kernels.flash_attention.generator as ref_flash
    import repro.kernels.matmul.generator as ref_matmul

    def load(ref, idx):
        return ref[idx]

    def store(ref, idx, val):
        ref[idx] = val

    monkeypatch.setattr(pallas, "load", load, raising=False)
    monkeypatch.setattr(pallas, "store", store, raising=False)
    try:
        _assert_specs_equal(list(matmul_gen.tpu_candidate_specs(256, 512, 384, 2)),
                            list(ref_matmul.candidate_specs(256, 512, 384, 2)))
        for causal in (True, False):
            for shape in ((1, 4, 2, 256, 256, 64), (2, 4, 4, 256, 384, 32)):
                _assert_specs_equal(list(flash_gen.tpu_candidate_specs(*shape, causal, 2)),
                                    list(ref_flash.candidate_specs(*shape, causal, 2)))
    finally:
        ref_matmul._candidates.cache_clear()
        ref_flash._candidates.cache_clear()


# ---------------------------------------------------------------------------
# lowering
# ---------------------------------------------------------------------------
def _workload_fields(w):
    return (w.name, w.kind, w.role, w.params, w.count, w.backends)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_lower_model_equals_reference(arch, shape):
    cfg, ref = configs.get_config(arch), ref_configs.get_config(arch)
    try:
        want = ref_suite.lower_model(ref, shape)
    except ref_suite.lowering.UnsupportedShape as exc:
        with pytest.raises(lowering.UnsupportedShape, match="cannot lower"):
            suite.lower_model(cfg, shape)
        assert not cfg.is_sub_quadratic and "quadratic" in str(exc)
        return
    for batch in (1, 2):
        plan = suite.lower_model(cfg, shape, batch)
        if batch == 2:
            want = ref_suite.lower_model(ref, shape, batch)
        assert [_workload_fields(w) for w in plan.workloads] == [
            _workload_fields(w) for w in want.workloads]
        assert (plan.shape.name, plan.batch, plan.kind_counts(), plan.role_counts()) == (
            want.shape.name, want.batch, want.kind_counts(), want.role_counts())
        assert [(_workload_fields(w), c) for w, c in plan.distinct()] == [
            (_workload_fields(w), c) for w, c in want.distinct()]
        for backend in ("gpu", "tpu"):
            assert plan.total_flops(backend) == want.total_flops(backend)
        assert [w.flops() for w in plan.workloads] == [w.flops() for w in want.workloads]


@pytest.mark.parametrize("shape", SHAPES)
def test_lower_all_equals_reference(shape):
    mine, want = suite.lower_all(shape), ref_suite.lower_all(shape)
    assert list(mine) == list(want)
    assert [len(p.workloads) for p in mine.values()] == [len(p.workloads) for p in want.values()]
    sub = suite.lower_all(shape, archs=["whisper-base", "phi3-mini-3.8b"])
    assert list(sub) == [a for a in ("whisper-base", "phi3-mini-3.8b") if a in want]


def test_plan_workloads_share_candidates_and_specs():
    """Repeated layers share one candidate list and one GPU spec object per
    structural class (the engine's cell dedupe compares by identity)."""
    plan = suite.lower_model(configs.get_config("phi3-mini-3.8b"), "train_4k")
    wls = plan.engine_workloads()
    by_role: dict = {}
    for w, kw in zip(wls, plan.workloads):
        by_role.setdefault(kw.role, []).append(w)
    for role, group in by_role.items():
        assert all(w.tpu_candidates is group[0].tpu_candidates for w in group), role
        assert all(w.gpu_spec is group[0].gpu_spec for w in group), role
    fa = by_role["attn.core[fa]"][0]
    assert fa.gpu_spec is None and fa.gpu_configs is None and fa.tpu_candidates
    qk = by_role["attn.core[qk]"][0]
    assert qk.tpu_candidates is None and len(qk.gpu_configs) == len(suite.SUITE_GPU_BLOCKS)


# ---------------------------------------------------------------------------
# pricing: price(plan_request(...)) against the reference, exactly
# ---------------------------------------------------------------------------
def _valid_archs(shape):
    return [a for a in ARCHS
            if any(s.name == shape for s in configs.valid_cells(configs.get_config(a)))]


@pytest.mark.parametrize("top_k", [None, 1], ids=["exhaustive", "top1"])
@pytest.mark.parametrize("shape", SHAPES)
def test_suite_report_equals_reference(ref_declared, shape, top_k):
    archs = _valid_archs(shape)
    mine = api.price(api.plan_request({a: api.PlanRef(a, shape) for a in archs},
                                      [SMALL, *NAMED], top_k=top_k))
    want = ref_api.price(ref_api.plan_request({a: ref_api.PlanRef(a, shape) for a in archs},
                                              [REF_SMALL, *NAMED], top_k=top_k))
    got = mine.suite
    assert isinstance(got, report.SuiteReport)
    assert len(got.reports) == len(archs) * 5
    assert all(r.complete and r.rows for r in got.reports.values())
    assert _json(got) == _json(want.suite)
    assert _wire(got, schema) == _wire(want.suite, ref_schema)
    assert got.table() == want.suite.table()
    for model in got.models():
        for machine, _ in got.machine_ranking(model):
            r, w = got.get(model, machine), want.suite.get(model, machine)
            assert r.by_role() == w.by_role()
            assert r.roofline.row() == w.roofline.row()


def test_plan_ref_resolves_like_inline_plan():
    plan = suite.lower_model(configs.get_config("whisper-base"), "train_4k")
    inline = api.price(api.plan_request({"w": plan}, ["TPUv5e", SMALL])).suite
    by_ref = api.price(api.plan_request({"w": api.PlanRef("whisper-base", "train_4k")},
                                        ["TPUv5e", SMALL])).suite
    assert _json(inline) == _json(by_ref)
    assert api.PlanRef("whisper-base").resolve().shape.name == "train_4k"


def test_plan_request_wire_and_result_equal_reference(ref_declared):
    refs = {"g": ("granite-3-2b", "decode_32k", 1), "r": ("rwkv6-1.6b", "long_500k", 1)}
    mine = api.plan_request({k: api.PlanRef(*v) for k, v in refs.items()}, ["H100", "TPUv5e"],
                            top_k=2)
    want = ref_api.plan_request({k: ref_api.PlanRef(*v) for k, v in refs.items()},
                                ["H100", "TPUv5e"], top_k=2)
    assert schema.dumps(mine) == ref_schema.dumps(want)
    assert schema.request_digest(mine) == ref_schema.request_digest(want)
    assert schema.loads(schema.dumps(mine)) == mine
    result, ref_result = api.price(mine), ref_api.price(want)
    assert _wire(result, schema) == _wire(ref_result, ref_schema)
    back = schema.loads(schema.dumps(result))
    assert _json(back.suite) == _json(result.suite)
    assert [dataclasses.astuple(r) for r in back.suite.get("g", "H100-SXM5-80G").rows] == [
        dataclasses.astuple(r) for r in result.suite.get("g", "H100-SXM5-80G").rows]


def test_suite_reports_round_trip_through_the_codec():
    got = api.price(api.plan_request({"w": api.PlanRef("whisper-base")}, ["TPUv5e", "H100"])).suite
    back = report.SuiteReport.from_wire(got.to_wire())
    assert back.machine_ranking("w") == got.machine_ranking("w")
    assert _json(back) == _json(got) and back.wall_time_s == got.wall_time_s
    for value in (got.get("w", "TPUv5e"), got.get("w", "TPUv5e").rows[0],
                  got.get("w", "TPUv5e").roofline, api.PlanRef("mixtral-8x7b", "prefill_32k", 2)):
        assert schema.loads(schema.dumps(value)) == value
    with pytest.raises(TypeError, match="not SuiteReport"):
        report.SuiteReport.from_wire(schema.encode(api.PlanRef("whisper-base")))
    payload = got.to_json()
    assert payload["schema"] == {"kind": "suite_report", "version": schema.SCHEMA_VERSION}
    assert {c["machine"] for c in payload["cells"]} == {"TPUv5e", "H100-SXM5-80G"}


def test_price_bounds_takes_plans(ref_declared):
    refs = {"p": ("phi3-mini-3.8b", "train_4k", 1)}
    mine = api.price_bounds(api.plan_request({k: api.PlanRef(*v) for k, v in refs.items()},
                                             [SMALL, "TPUv5e"], top_k=3))
    want = ref_api.price_bounds(ref_api.plan_request(
        {k: ref_api.PlanRef(*v) for k, v in refs.items()}, [REF_SMALL, "TPUv5e"], top_k=3))
    assert mine.degraded and mine.suite is None
    assert len(mine.entries) > 0
    assert _wire(mine.report, schema) == _wire(want.report, ref_schema)


# ---------------------------------------------------------------------------
# the engine's plan sweep and the structural memo
# ---------------------------------------------------------------------------
def test_explore_plans_namespaces_and_shares_cache():
    cands = list(matmul_gen.tpu_candidate_specs(128, 128, 128))
    plans = {"p1": [Workload(name="w", tpu_candidates=cands)],
             "p2": [Workload(name="w", tpu_candidates=cands)]}
    rep = Explorer()._explore_plans(plans, [machines.TPU_V5E])
    assert {e.workload for e in rep.entries} == {"p1::w", "p2::w"}
    # identical candidate lists across plans collapse to ONE priced cell
    assert rep.cache_stats["cells"] == 1 and rep.cache_stats["shared_cells"] == 1
    assert rep.cache_stats["misses"] <= len(cands)
    p1 = rep.ranking("p1::w", machines.TPU_V5E.name)
    p2 = rep.ranking("p2::w", machines.TPU_V5E.name)
    assert [(e.config, e.estimate.total_time) for e in p1] == [
        (e.config, e.estimate.total_time) for e in p2]
    assert not hasattr(Explorer, "explore_plans") and not hasattr(suite, "price_plans")


def test_structural_memo_absorbs_repeated_layers():
    """Re-pricing a 32-layer model costs a handful of distinct structural
    evaluations (the reference's test, on the port's ``_price_plans``)."""
    plan = suite.lower_model(configs.get_config("phi3-mini-3.8b"), "train_4k")
    got = report._price_plans({"phi3": plan}, [machines.TPU_V5E],
                              explorer=Explorer(parallel=False))
    stats = got.cache_stats
    assert stats["shared_cells"] / (stats["shared_cells"] + stats["cells"]) > 0.5, stats
    # distinct structural classes bound the misses (pallas: 1 task a spec)
    assert stats["misses"] <= sum(len(w.tpu_candidates() or []) for w, _ in plan.distinct())
    assert stats["evaluated"] <= stats["misses"] + stats["hits"]
    tpu = got.get("phi3", machines.TPU_V5E.name)
    assert tpu.complete and tpu.time_s > 0
    assert tpu.flops == pytest.approx(plan.total_flops("tpu"))
    inline = api.price(api.plan_request({"phi3": plan}, [machines.TPU_V5E])).suite
    assert _json(got) == _json(inline)


# ---------------------------------------------------------------------------
# roofline
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("values", [(1e15, 1e11, 0.0, 1), (2e12, 5e12, 3e9, 4)])
def test_roofline_equals_reference(values):
    flops, hbm, wire, chips = values
    mine = roofline.report_from_values("cell", flops, hbm, wire, chips,
                                       model_flops_total=flops * 0.8)
    want = ref_roofline.report_from_values("cell", flops, hbm, wire, chips,
                                           model_flops_total=flops * 0.8)
    assert dataclasses.astuple(mine) == dataclasses.astuple(want)
    assert (mine.t_bound, mine.roofline_fraction, mine.row()) == (
        want.t_bound, want.roofline_fraction, want.row())
    assert roofline.format_roofline_table([mine]) == ref_roofline.format_roofline_table([want])


# ---------------------------------------------------------------------------
# the example and the smoke's constants
# ---------------------------------------------------------------------------
def _example_lines(text: str) -> list:
    return [line for line in text.splitlines() if not line.startswith("priced in")]


def test_example_prints_the_reference_examples_lines(ref_declared, capsys, monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT / "examples"))
    sys.modules.pop("torch_model_pricing", None)
    import torch_model_pricing as example

    out = example.main()
    mine = capsys.readouterr().out
    runpy.run_path(str(ROOT / "examples" / "model_pricing.py"), run_name="__main__")
    want = capsys.readouterr().out
    assert _example_lines(mine) == _example_lines(want)
    assert out["winner"][0] == "TPUv5e" and out["suite"] is out["result"].suite
    assert len(out["plan"].workloads) == 257


def test_smoke_model_pricing_constants_equal_reference(ref_declared):
    import chip_smoke

    want = ref_api.price(ref_api.plan_request(
        {"mixtral-8x7b": ref_api.PlanRef("mixtral-8x7b")},
        [ref_machines.V100, ref_machines.A100, ref_machines.TPU_V5E])).suite
    assert chip_smoke.MODEL_PRICING_ROWS == {
        machine: (r.time_s, r.flops, r.hbm_bytes, r.roofline.dominant, len(r.rows))
        for (_, machine), r in want.reports.items()}
    granite = ref_api.price(ref_api.plan_request(
        {"granite-3-2b": ref_api.PlanRef("granite-3-2b", "train_4k")}, ["H100"])).suite
    r = granite.get("granite-3-2b", "H100-SXM5-80G")
    assert chip_smoke.GRANITE_H100 == (r.time_s, r.flops, r.hbm_bytes, r.roofline.dominant)
    assert chip_smoke.GRANITE_H100_ROLES == r.by_role()
