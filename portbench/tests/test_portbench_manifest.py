"""BENCHMARK.json against the benchmark's contract, and every name in it
found from its own file."""
from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parents[2]
MAN = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|proj|head|expan|per_tok")


def _line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_keys_and_sizes():
    assert set(MAN) == KEYS["top"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) and ".." not in p
                                                   and not p.startswith("/") for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert 1 <= len(MAN["command"]) <= 32 and all(_line(w) for w in MAN["command"])
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in MAN[group]:
            extra = set(entry) - KEYS[group] - ({"workloads"} if "_" in group else set())
            assert KEYS[group] <= set(entry) and not extra, (group, entry["name"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_units_and_lines(group):
    names = [e["name"] for e in MAN[group]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for e in MAN[group]:
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group in ("configs", "workloads", "per_layer"):
                assert _line(e[key]), (e["name"], key)
        for key in ("config", "traffic"):
            if key in e:
                assert NAME.match(e[key])


def test_configs_cells_and_metrics_agree():
    configs = {c["name"] for c in MAN["configs"]}
    used = {w["config"] for w in MAN["workloads"]}
    assert used == configs
    assert len({(w["config"], w["traffic"]) for w in MAN["workloads"]}) == len(MAN["workloads"])
    assert all(w["chips"] in (1, 4) for w in MAN["workloads"])
    four = sum(w["chips"] == 4 for w in MAN["workloads"])
    assert four <= max(1, len(MAN["workloads"]) // 4)
    for c in MAN["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in MAN["paths"]))
        assert c["source"].startswith("https://") and len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in MAN["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["per_layer"]:
        assert m["moves"] in e2e and set(m.get("workloads", cells)) <= cells
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in cells:
        assert any(w in m.get("workloads", [w]) for m in MAN["per_layer"])
        assert sum(w in m.get("workloads", [w]) for m in MAN["end_to_end"]) >= 2


def test_check_length_fits_the_budget():
    n = len(MAN["workloads"])
    total = lambda cells: (2 + 14 * cells) * (MAN["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert total(24) <= 43200 and total(n) <= 43200


def test_command_names_only_files_under_paths():
    words = MAN["command"][1:]
    assert words[:2] == ["-m", "portbench.run"]
    assert (ROOT / "portbench" / "run.py").is_file()


@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_each_cell_found_by_name(cell):
    entry = next(w for w in MAN["workloads"] if w["name"] == cell)
    work = harness.load_json("workloads", cell)
    assert (work["name"], work["config"], work["traffic"], work["why"]) == (
        cell, entry["config"], entry["traffic"], entry["why"])
    config = harness.load_json("configs", work["config"])
    assert config["name"] == work["config"]
    driver = harness.load_module("drivers", config["driver"])
    for fn in ("init", "program_step", "reference_step", "points", "bound_ms"):
        assert callable(getattr(driver, fn))
    assert set(config["limits"]) == set(driver.OUTPUTS)
    if work["candidates"]:
        space = harness.load_json("configs", work["candidates"])
        assert space["config"] == config["name"] and len(space["candidates"]) > 100


@pytest.mark.parametrize("config", [c["name"] for c in MAN["configs"]])
def test_each_config_file_holds_what_is_run(config):
    entry = next(c for c in MAN["configs"] if c["name"] == config)
    data = json.loads((ROOT / entry["file"]).read_text())
    assert data["name"] == config and data["source"] == entry["source"]
    assert data["reduced"] == entry["reduced"] and data["dtype"] == "float64"


@pytest.mark.parametrize("metric", [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]])
def test_each_metric_found_by_name(metric):
    assert callable(harness.load_module("metrics", metric).read)


def test_missing_files_are_refused(tmp_path):
    with pytest.raises(harness.Refused):
        harness.load_json("workloads", "no.such.cell", tmp_path)
    with pytest.raises(harness.Refused):
        harness.load_module("metrics", "no_such_metric", tmp_path)
