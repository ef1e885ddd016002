"""The frozen yardstick: references against the port's entry points on the
CPU, the bound arithmetic against the chip smoke's, the trace's classes and
the metric readers on records made by hand."""
from __future__ import annotations

import ast
import json
from pathlib import Path

import pytest
import torch

from portbench import bounds, harness
from portbench import trace as T
from portbench.reference import lbm as ref_lbm
from portbench.reference import star as ref_star

ROOT = Path(__file__).resolve().parents[2]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert _imports(path) <= {"__future__", "torch"}


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    for path in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(path) & harness.FORBIDDEN, path
        assert "benchmarks/" not in path.read_text() or path.parent.name == "tests", path


@pytest.mark.parametrize("entry", [None, {"variant": "ring"}, {"variant": "ytile_ring", "ty": 8},
                                   {"block": [8, 4, 2], "folding": [1, 2, 1]}])
@pytest.mark.parametrize("r", [1, 4])
def test_star_reference_agrees_with_star_stencil(entry, r):
    from repro_torch.kernels.stencil3d25.ops import star_stencil

    g = torch.Generator().manual_seed(5)
    u = torch.rand((11, 16, 13), generator=g, dtype=torch.float64)
    w = torch.rand((6 * r + 1,), generator=g, dtype=torch.float64)
    got = star_stencil(u, w, r=r, config=entry)
    want = ref_star.step(u, w, r)
    torch.testing.assert_close(got, want, rtol=1e-14, atol=1e-14)


def test_star_reference_blocks_agree_with_one_block(monkeypatch):
    g = torch.Generator().manual_seed(6)
    u = torch.rand((37, 9, 10), generator=g, dtype=torch.float64)
    w = ref_star.uniform_weights(4, torch.float64, "cpu")
    whole = ref_star.step(u, w, 4)
    monkeypatch.setattr(ref_star, "BLOCK_PLANES", 5)
    torch.testing.assert_close(ref_star.step(u, w, 4), whole, rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("entry", [None, {"variant": "ytile", "ty": 8},
                                   {"block": [16, 4, 1], "folding": [1, 1, 2]}])
def test_lbm_reference_agrees_with_lbm_step(entry):
    from repro_torch.kernels.lbm_d3q15.ops import lbm_step

    g = torch.Generator().manual_seed(8)
    phase = torch.rand((9, 16, 12), generator=g, dtype=torch.float64)
    pdf = ref_lbm.equilibrium(phase) + 1e-3 * torch.rand((15, 9, 16, 12), generator=g,
                                                        dtype=torch.float64)
    got = lbm_step(pdf, phase, tau=1.2, kappa=0.15, config=entry)
    want = ref_lbm.step(pdf, phase, 1.2, 0.15)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-14, atol=1e-15)


def test_lbm_reference_blocks_agree_with_one_block(monkeypatch):
    g = torch.Generator().manual_seed(9)
    phase = torch.rand((23, 6, 7), generator=g, dtype=torch.float64)
    pdf = ref_lbm.equilibrium(phase)
    whole = ref_lbm.step(pdf, phase, 1.2, 0.15)
    monkeypatch.setattr(ref_lbm, "BLOCK_PLANES", 4)
    for a, b in zip(ref_lbm.step(pdf, phase, 1.2, 0.15), whole):
        torch.testing.assert_close(a, b, rtol=1e-15, atol=1e-15)


def test_lbm_velocities_and_weights_are_the_specs():
    from repro_torch.core.specs import D3Q15_VELOCITIES
    from repro_torch.kernels.lbm_d3q15.ref import WEIGHTS

    assert ref_lbm.VELOCITIES == D3Q15_VELOCITIES and ref_lbm.WEIGHTS == WEIGHTS


@pytest.mark.parametrize("tau,bounded", [(0.8, False), (1.2, True)])
def test_lbm_loop_stays_bounded_at_the_configured_tau(tau, bounded):
    """At the port's default tau 0.8 this step grows any disturbance, so a
    time loop overflows; at the configuration's 1.2 it stays in range."""
    config = json.loads((ROOT / "portbench/configs/lbm-d3q15-paper-fp64.json").read_text())
    assert config["tau"] == 1.2
    g = torch.Generator().manual_seed(10)
    phase = torch.rand((12, 12, 12), generator=g, dtype=torch.float64)
    pdf = ref_lbm.equilibrium(phase)
    for _ in range(150):
        pdf, phase = ref_lbm.step(pdf, phase, tau, 0.15)
    peak = float(phase.abs().max()) if bool(torch.isfinite(phase).all()) else float("inf")
    assert (peak <= 1.0) == bounded


def test_star_loop_stays_in_the_unit_interval():
    g = torch.Generator().manual_seed(11)
    u = torch.rand((10, 12, 14), generator=g, dtype=torch.float64)
    w = ref_star.uniform_weights(4, torch.float64, "cpu")
    for _ in range(50):
        u = ref_star.step(u, w, 4)
    assert float(u.min()) >= 0.0 and float(u.max()) <= 1.0


def test_bounds_reproduce_the_chip_smoke():
    import chip_smoke

    assert round(bounds.star_bound((512, 512, 640), 4, 8)[0], 4) == 0.8188
    assert round(bounds.lbm_bound((256, 256, 256), 8)[0], 4) == 1.2430
    assert bounds.HBM_BYTES_PER_S == chip_smoke.HBM_BYTES_PER_S
    assert bounds.PEAK_FLOPS == chip_smoke.PEAK_FLOPS
    padded = torch.empty((520, 520, 648), dtype=torch.float64, device="meta")
    assert bounds.star_bound((512, 512, 640), 4, 8) == chip_smoke.bound(padded, 4)
    pdf_p = torch.empty((15, 258, 258, 258), dtype=torch.float64, device="meta")
    phase_p = torch.empty((258, 258, 258), dtype=torch.float64, device="meta")
    assert bounds.lbm_bound((256, 256, 256), 8) == chip_smoke.lbm_bound(pdf_p, phase_p)
    from repro_torch.core.specs import lbm_d3q15

    assert bounds.LBM_FLOPS_PER_POINT == lbm_d3q15((256, 256, 256), 8).flops_per_point


def _ev(name, cat, ts, dur, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": 1, "args": args}


TRACE = [
    _ev("portbench.step", "user_annotation", 0, 100),
    _ev("aten::constant_pad_nd", "cpu_op", 1, 20),
    _ev("aten::copy_", "cpu_op", 5, 10),
    _ev("cudaLaunchKernel", "cuda_runtime", 6, 2, correlation=10),
    _ev("cudaMemcpyToSymbolAsync", "cuda_runtime", 30, 2, correlation=12),
    _ev("cudaLaunchKernel", "cuda_runtime", 33, 2, correlation=11),
    _ev("void at::native::elementwise_kernel<128>", "kernel", 10, 30, correlation=10),
    _ev("void my_renamed_kernel<double>", "kernel", 45, 50, correlation=11),
    _ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 41, 4, correlation=12),
    _ev("void at::native::reduce_kernel<4>", "kernel", 120, 10, correlation=13),
    _ev("portbench.step", "gpu_user_annotation", 0, 200),
]


def test_trace_classes_by_origin():
    ops, host = T.classify(TRACE)
    origin = {o["name"][:12]: o["origin"] for o in ops}
    # the pad's copy came from an aten op; the kernel and the bank's copy from the
    # port's own calls; the sum's kernel has no launching call, so its name decides
    assert origin == {"void at::nat": "torch", "void my_rena": "program", "Memcpy DtoD ": "program"}
    assert T.classify([dict(e, cat="kernel") if e["name"].startswith("Memcpy") else e
                       for e in TRACE if e["cat"] != "cuda_runtime"])[0][1]["origin"] == "torch"
    assert [o["ts"] for o in ops] == [10, 41, 45, 120]
    assert T.busy_intervals(ops) == [(10, 40), (41, 95), (120, 130)]
    b = T.breakdown(ops, host)
    assert b["device_ops"][0] == ["void my_renamed_kernel<double>", pytest.approx(50e-6)]
    assert b["idle_gaps"] == [["portbench.step", pytest.approx(25e-6)],
                              ["portbench.step", pytest.approx(1e-6)]]
    assert T.breakdown(ops, [])["idle_gaps"][0] == ["host: no op", pytest.approx(25e-6)]


def test_per_layer_readers_on_a_record():
    ops = [{"name": "a", "ts": 0, "dur": 1000.0, "origin": "torch"},
           {"name": "k", "ts": 1000, "dur": 2000.0, "origin": "program"},
           {"name": "a", "ts": 3000, "dur": 1000.0, "origin": "torch"},
           {"name": "k", "ts": 4000, "dur": 2000.0, "origin": "program"}]
    rec = {"steps": 2, "window_ms": 6.5, "step_ms": [3.2, 3.3], "points": 10**6, "bound_ms": 1.0,
           "setup_s": 12.5, "device_ops": ops, "busy_ms": 6.0, "spans": [],
           "candidates": [{"config": {}, "kernel_ms": 1.5}, {"config": {}, "kernel_ms": None}]}
    read = {n: harness.load_module("metrics", n).read for n in
            ("glups", "step_p95_ms", "setup_s", "step_mfu_pct", "glue_ms_per_step",
             "kernel_roofline_pct", "device_idle_pct", "rank_s", "pick_efficiency_pct")}
    assert read["glups"](rec) == pytest.approx(2 * 10**6 / 6.5e-3 / 1e9)
    assert read["step_p95_ms"](rec) == 3.3
    assert read["setup_s"](rec) == 12.5
    assert read["step_mfu_pct"](rec) == pytest.approx(100 / 3.25)
    assert read["glue_ms_per_step"](rec) == pytest.approx(1.0)
    assert read["kernel_roofline_pct"](rec) == pytest.approx(50.0)
    assert read["device_idle_pct"](rec) == pytest.approx(100 * 0.5 / 6.5)
    assert read["rank_s"](rec) is None
    assert read["pick_efficiency_pct"](rec) == pytest.approx(75.0)
    rec["candidates"] = [{"config": {}, "kernel_ms": 2.5}]
    assert read["pick_efficiency_pct"](rec) == pytest.approx(100.0)
    for name in ("glue_ms_per_step", "kernel_roofline_pct", "device_idle_pct",
                 "pick_efficiency_pct"):
        assert read[name](dict(rec, device_ops=None)) is None
