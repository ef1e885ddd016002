"""The harness's CPU dry path at tiny domains: a cell added as files alone,
the result line's keys, the control and the faults that ``correct`` has to
catch, and the check that nothing loads the JAX stack or package."""
from __future__ import annotations

import copy
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = harness.manifest(ROOT)
TINY = {"star25-r4-paper-fp64": [12, 16, 20], "lbm-d3q15-paper-fp64": [8, 16, 12]}
RESULT_KEYS = ["correct", "attempted", "failed", "metrics", "device", "setup_parts_s", "checks"]
SECONDS = 0.2


@pytest.fixture(scope="module")
def bench(tmp_path_factory) -> Path:
    """A copy of the benchmark's files with every configuration at a tiny
    domain."""
    dst = tmp_path_factory.mktemp("bench") / "portbench"
    shutil.copytree(ROOT / "portbench", dst, ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, domain in TINY.items():
        path = dst / "configs" / f"{name}.json"
        data = json.loads(path.read_text())
        data["domain"] = domain
        path.write_text(json.dumps(data))
    return dst


def _run(bench, cell, seed=2**31 + 11, trace=False, man=MAN, **kw):
    return harness.run_cell(man, cell, seed, SECONDS, trace, device="cpu", bench=bench, **kw)


@pytest.mark.parametrize("cell", ["star25.ring", "lbm15.ytile8"])
def test_dry_run_is_correct_with_the_contract_keys(bench, cell):
    res = _run(bench, cell)
    assert list(res) == RESULT_KEYS
    assert res["correct"] and res["failed"] == 0 and res["attempted"] > 1
    assert set(res["metrics"]) == {"glups", "step_p95_ms", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in res["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(res["device"])
    tags = {k.split(".")[1] for k in res["checks"]}
    assert tags == {"first", "mid", "last"} or tags == {"first", "last"}
    json.loads(json.dumps(res))


def test_traced_dry_run_keys(bench):
    res = _run(bench, "star25.ring", trace=True)
    assert list(res) == RESULT_KEYS[:5] + ["breakdown"] + RESULT_KEYS[5:]
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # no device ops on the CPU: the trace's metrics say nothing rather than 0
    assert set(res["metrics"]) <= {"step_mfu_pct"}


def test_same_seed_same_fields(bench):
    config = harness.load_json("configs", "lbm-d3q15-paper-fp64", bench)
    driver = harness.load_module("drivers", "lbm", bench)
    a, _ = driver.init(config, 2**32 + 5, "cpu")
    b, _ = driver.init(config, 2**32 + 5, "cpu")
    c, _ = driver.init(config, 2**32 + 6, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[1], c[1])


def test_cell_added_as_files_alone(bench, tmp_path):
    """A new configuration, cell and per-layer metric are new files and
    manifest entries; no file already there changes."""
    dst = tmp_path / "portbench"
    shutil.copytree(bench, dst)
    before = {p: p.read_bytes() for p in dst.rglob("*") if p.is_file()}
    (dst / "configs" / "star-r2-tiny.json").write_text(json.dumps({
        "name": "star-r2-tiny", "source": "https://arxiv.org/abs/2204.14242", "driver": "star",
        "domain": [6, 8, 10], "r": 2, "dtype": "float64", "reduced": [], "limits": {"u": 1e-11}}))
    (dst / "workloads" / "star2.tiny.json").write_text(json.dumps({
        "name": "star2.tiny", "config": "star-r2-tiny", "traffic": "loop.ring",
        "entry": {"variant": "ring"}, "candidates": None,
        "why": "a throwaway cell"}))
    (dst / "metrics" / "steps_seen.py").write_text("def read(rec):\n    return rec['steps']\n")
    man = copy.deepcopy(MAN)
    man["configs"].append({"name": "star-r2-tiny", "source": "https://arxiv.org/abs/2204.14242",
                           "file": "portbench/configs/star-r2-tiny.json", "reduced": [],
                           "why": "throwaway"})
    man["workloads"].append({"name": "star2.tiny", "config": "star-r2-tiny",
                             "traffic": "loop.ring", "chips": 1, "why": "throwaway"})
    man["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                             "source": "host_clock", "layer": "device", "moves": "glups",
                             "workloads": ["star2.tiny"]})
    plain = _run(dst, "star2.tiny", man=man)
    traced = _run(dst, "star2.tiny", man=man, trace=True)
    assert plain["correct"] and traced["correct"]
    assert traced["metrics"]["steps_seen"]["value"] == traced["attempted"]
    assert "steps_seen" not in plain["metrics"]
    assert all(before[p] == p.read_bytes() for p in before)


@pytest.mark.parametrize("cell", ["star25.ring", "lbm15.ytile8"])
def test_fp32_control_is_not_correct(bench, cell):
    res = _run(bench, cell, control="fp32")
    assert not res["correct"] and res["failed"] >= 1
    assert max(c["value"] for c in res["checks"].values()) > 1e-9


def _unchanged(kernel, halo):
    def fault(padded, *a, **k):
        sl = (slice(None),) * (padded.dim() - 3) + (slice(halo, -halo),) * 3
        return padded[sl].clone()     # the step returns its state unchanged
    return fault


def _half(kernel, halo):
    def fault(padded, *a, **k):
        out = kernel(padded, *a, **k)
        sl = (slice(None),) * (padded.dim() - 3) + (slice(halo, -halo),) * 3
        z = out.shape[-3] // 2
        out[..., z:, :, :] = padded[sl][..., z:, :, :]   # half the planes left as they were
        return out
    return fault


def _altered(kernel, halo):
    def fault(padded, *a, **k):
        out = kernel(padded, *a, **k)
        out.view(-1)[out.numel() // 3] += 1e-6     # one answer altered where it is made
        return out
    return fault


KERNELS = {
    "star25.ring": ("repro_torch.kernels.stencil3d25.ops", ("star_pointwise", "star_zmarch"), 4),
    "lbm15.ytile8": ("repro_torch.kernels.lbm_d3q15.ops", ("lbm_pointwise", "lbm_ytile"), 1),
}


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", list(KERNELS))
def test_faults_in_the_timed_path_are_not_correct(bench, monkeypatch, cell, fault):
    import importlib

    module, names, halo = KERNELS[cell]
    ops = importlib.import_module(module)
    for name in names:
        monkeypatch.setattr(ops, name, fault(getattr(ops, name), halo))
    res = _run(bench, cell)
    assert not res["correct"] and res["failed"] >= 1


def test_ranked_cell_reads_the_ranking_spans(bench):
    res = _run(bench, "lbm15.ranked", seed=7, trace=True)
    assert res["correct"]
    # a fresh domain in this process: the first call ranks, under the spans
    assert res["metrics"]["rank_s"]["value"] > 0


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "reprox", "jaxtyping", "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert harness.forbidden_modules() == [m for m in ("flax", "jax", "jaxlib", "repro")
                                           if m in sys.modules]
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro" in harness.forbidden_modules()


def test_a_run_loads_neither_jax_nor_the_jax_package(bench):
    code = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]\n"
            "from pathlib import Path\n"
            "from portbench import harness\n"
            f"r = harness.run_cell(harness.manifest(Path({str(ROOT)!r})), 'star25.ring', 3, 0.1,"
            f" True, device='cpu', bench=Path({str(bench)!r}))\n"
            "assert r['correct']\n"
            "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_command_without_a_card_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", "star25.ring",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
