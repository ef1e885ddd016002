"""The port's dry run (``repro_torch.launch.dryrun``, ``launch.calibrate``)
against the reference's (``repro.launch.dryrun``, ``repro.launch.calibrate``).

The analytic half (``count_params``, ``model_flops``, ``cell_input_specs``,
``analytic_bytes``) equals the reference's exactly for the ten full configs,
every valid cell and the (1, 1), (16, 16) and (2, 16, 16) meshes (stand-in
records of sizes on both sides).  The counted half: the command's
``--local`` row (one device) and its row without ``--local`` (the (16, 16)
production mesh, ``tests/test_torch_dryrun_mesh.py`` for the rest), and the
raw whole-step count against the calibrated one on one device, where the
bands come from the reduced configs (as these comparisons read when the
bounds were set):

* prefill and decode: equal for the attention archs (1.0000) and a
  recurrent arch's decode (1.0000-1.0004), within ``STEP_REL``.  The
  recurrent archs' calibrated prefill blocks run their scans at
  the calibration's chunk hint, max(256, S/8), where the step runs
  ``layers.shapes``' 32 and 64: more work inside a chunk, so the raw count
  reads below the calibrated one.  internvl2-76b's prefill also runs its
  vision tokens, which the calibration leaves out: (S + N) / S of it.
  whisper-base's decode recomputes cross-attention from the encoder's
  output at every step, which the calibration leaves out too.
* train, remat on: raw over calibrated product FLOPs read 0.933-0.979 for
  the attention archs (the head's forward runs once, and a block's
  recompute stops before its last product), 0.770-0.801 for the recurrent
  ones: ``TRAIN_RAW_BAND``.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices:
the fixture initialises jax first and puts the variable back, and the
command runs in a subprocess without it.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import jax  # noqa: E402

from repro_torch.configs import SHAPES, get_config, valid_cells  # noqa: E402
from repro_torch.configs.base import ShapeSpec  # noqa: E402
from repro_torch.launch import calibrate, dryrun  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEP_REL = 1e-2
TRAIN_RAW_BAND = {"attn": (0.90, 1.00), "recurrent": (0.75, 0.85)}
MESHES = {"1x1": ((1, 1), ("data", "model")), "16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the keys of the reference's row (src/repro/launch/dryrun.py:lower_cell),
# beside its report's
ROW_KEYS = {"arch", "shape", "mesh", "compile_s", "model_flops", "n_params", "kv_int8",
            "raw_cost_analysis", "calibrated_unfused_bytes", "analytic_bytes", "collectives",
            "memory"}


class StandInMesh:
    """A mesh as the sharding and cost rules read it: axis names and a
    device array of its shape."""

    def __init__(self, shape, axes):
        self.axis_names = axes
        self.devices = np.empty(shape, dtype=object)


@pytest.fixture(scope="module")
def ref():
    """``repro.launch.dryrun``, imported after jax has its devices, with
    ``XLA_FLAGS`` put back as it was."""
    jax.devices()
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as rd
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return rd


def _spec_leaves(tree) -> list:
    return [(tuple(p), tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for p, t in flatten_with_path(tree)]


def _ref_spec_leaves(tree) -> list:
    return [(tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in p), tuple(x.shape),
             str(x.dtype)) for p, x in jax.tree_util.tree_flatten_with_path(tree)[0]]


@pytest.mark.parametrize("arch", sorted(dryrun.ALL_ARCHS))
def test_analytic_half_equals_reference(ref, arch):
    from repro.configs import SHAPES as REF_SHAPES
    from repro.configs import get_config as ref_config
    from repro.launch.calibrate import analytic_bytes as ref_analytic_bytes

    cfg, rcfg = get_config(arch), ref_config(arch)
    p, rp = dryrun.params_struct(cfg), ref.params_struct(rcfg)
    assert dryrun.count_params(p) == ref.count_params(rp)
    total, active = dryrun.count_params(p)
    assert active == total  # the reference never discounts experts
    assert _spec_leaves(p) == _ref_spec_leaves(rp)
    n_params = sum(math.prod(t.shape) for t in leaves(p))
    for shape in valid_cells(cfg):
        rshape = REF_SHAPES[shape.name]
        assert dryrun.model_flops(cfg, shape, p) == ref.model_flops(rcfg, rshape, rp)
        kv = dryrun.kv_int8_for(cfg, shape)
        got = dryrun.cell_input_specs(dataclasses.replace(cfg, kv_int8=kv), shape)
        want = ref.cell_input_specs(dataclasses.replace(rcfg, kv_int8=kv), rshape)
        assert _spec_leaves(got) == _ref_spec_leaves(want), shape.name
        for mshape, axes in MESHES.values():
            mesh = StandInMesh(mshape, axes)
            mb = dryrun.train_microbatches(cfg, shape, mesh) if shape.kind == "train" else 1
            assert dryrun.analytic_bytes(cfg, shape, mesh, mb, n_params) == ref_analytic_bytes(
                rcfg, rshape, mesh, mb, n_params), (shape.name, mshape)


def test_microbatch_and_int8_rules():
    """The reference's rules, as its lower_cell computes them inline: a
    per-device microbatch of about 1 (at most 8; 4 for MoE), and the int8
    cache where a bf16 cache over 512 devices would pass 8 GB."""
    mesh = StandInMesh(*MESHES["16x16"])
    local = make_local_mesh("meta")
    assert dryrun.train_microbatches(get_config("granite-3-2b"), SHAPES["train_4k"], mesh) == 8
    assert dryrun.train_microbatches(get_config("mixtral-8x7b"), SHAPES["train_4k"], mesh) == 4
    assert dryrun.train_microbatches(get_config("granite-3-2b"), SHAPES["train_4k"], local) == 8
    assert dryrun.train_microbatches(get_config("granite-3-2b"),
                                     ShapeSpec("x", 512, 8, "train"), local) == 8
    picked = {(a, s.name) for a in dryrun.ALL_ARCHS for s in valid_cells(get_config(a))
              if dryrun.kv_int8_for(get_config(a), s)}
    for arch in dryrun.ALL_ARCHS:
        cfg = get_config(arch)
        for s in valid_cells(cfg):
            if s.kind in ("decode", "long_decode") and cfg.block_pattern != "rwkv":
                cap = min(s.seq_len, cfg.swa_window or s.seq_len)
                n_attn = (cfg.n_layers if cfg.block_pattern == "attn"
                          else cfg.n_layers // cfg.hybrid_attn_every)
                gb = (n_attn * 2 * s.global_batch * cfg.n_kv * cap * cfg.resolved_head_dim * 2
                      / 512 / 1e9)
                assert ((arch, s.name) in picked) == (gb > 8.0)
    assert picked == {("qwen1.5-32b", "decode_32k")}  # 64 layers of 40 KV heads: 10.7 GB


def test_params_struct_is_the_cpu_init_on_meta():
    for arch in dryrun.ALL_ARCHS:
        cfg = get_config(arch).reduced()
        meta = dryrun.params_struct(cfg)
        cpu = dryrun.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        assert _spec_leaves(meta) == _spec_leaves(cpu)
        assert all(t.device.type == "meta" for t in leaves(meta))


@pytest.mark.parametrize("arch", sorted(dryrun.ALL_ARCHS))
def test_raw_step_count_against_calibrated(arch):
    cfg = dataclasses.replace(get_config(arch).reduced(), remat=True)
    p = dryrun.params_struct(cfg)
    n_params = sum(t.numel() for t in leaves(p))
    mesh = make_local_mesh("meta")
    for kind, S, B, mb in (("prefill", 64, 2, 1), ("decode", 128, 2, 1), ("train", 256, 4, 2)):
        shape = ShapeSpec("x", S, B, kind)
        cal = calibrate.calibrated_cost(cfg, shape, mesh, microbatches=mb, n_params=n_params)
        raw = dryrun.step_cost(cfg, shape, p, mb)
        assert raw.collectives["total"]["count"] == 0
        if kind == "train":
            ratio = raw.dot_flops / cal.detail["dot_flops"]
            band = TRAIN_RAW_BAND["attn" if cfg.block_pattern == "attn" else "recurrent"]
            if arch == "internvl2-76b":  # the vision tokens run too
                band = (band[0], band[1] * (S + cfg.frontend_tokens) / S)
            assert band[0] <= ratio <= band[1], (kind, ratio)
            assert raw.peak_bytes > raw.argument_bytes > 0
        elif cfg.block_pattern != "attn" and kind == "prefill":
            assert raw.flops < cal.flops              # the hint's larger chunks
        elif arch == "internvl2-76b" and kind == "prefill":
            assert raw.flops / cal.flops == pytest.approx((S + cfg.frontend_tokens) / S,
                                                          rel=STEP_REL)
        elif arch == "whisper-base" and kind == "decode":
            assert raw.flops > cal.flops              # cross-attention recomputed
        else:
            assert raw.flops == pytest.approx(cal.flops, rel=STEP_REL), kind


def _command(*argv, tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", *argv], env=env,
                          cwd=tmp_path, capture_output=True, text=True, timeout=300)


def test_command_local_row_has_the_reference_keys(tmp_path):
    from repro.core.roofline import report_from_values as ref_report

    out = tmp_path / "row.json"
    res = _command("--local", "--arch", "granite-3-2b", "--shape", "decode_32k", "--out",
                   str(out), tmp_path=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    row = json.loads(out.read_text())
    want = set(ref_report("x", 1.0, 1.0, 0.0, 1).row()) | ROW_KEYS
    assert set(row) == want
    assert {"flops", "hbm_bytes", "coll_wire_bytes"} <= set(row["raw_cost_analysis"])
    assert (row["arch"], row["shape"], row["mesh"], row["kv_int8"]) == (
        "granite-3-2b", "decode_32k", "1x1", False)
    assert row["n_params"] == dryrun.count_params(dryrun.params_struct(
        get_config("granite-3-2b")))[0]
    assert row["memory"]["peak_bytes"] == row["memory"]["argument_bytes"] + row["memory"][
        "temp_bytes"] > 0
    # the decode step counted whole equals the calibrated blocks
    assert row["raw_cost_analysis"]["flops"] == pytest.approx(row["hlo_gflops"] * 1e9,
                                                              rel=STEP_REL)
    assert row["collectives"] == {} and row["t_collective_s"] == 0
    assert json.loads(res.stdout[res.stdout.index("{\n"):])["mesh"] == "1x1"


def test_command_without_local_names_not_ported(tmp_path):
    """The command without ``--local`` counts granite-3-2b's decode_32k on
    the (16, 16) production mesh (a ``fake`` group of 256 in its process):
    it exits 0 and writes the reference's keys, mesh "16x16" and the
    collectives it counted."""
    from repro.core.roofline import report_from_values as ref_report

    out = tmp_path / "row.json"
    res = _command("--arch", "granite-3-2b", "--shape", "decode_32k", "--out", str(out),
                   tmp_path=tmp_path)
    assert res.returncode == 0, res.stderr[-2000:]
    row = json.loads(out.read_text())
    assert set(row) == set(ref_report("x", 1.0, 1.0, 0.0, 1).row()) | ROW_KEYS
    assert (row["mesh"], row["kv_int8"]) == ("16x16", False)
    assert row["collectives"] and all(v["count"] > 0 for v in row["collectives"].values())
    assert row["coll_wire_GB"] > 0 and row["t_collective_s"] > 0
    assert row["raw_cost_analysis"]["flops"] == pytest.approx(row["hlo_gflops"] * 1e9,
                                                              rel=STEP_REL)


def test_smoke_dryrun_phase_runs_on_the_cpu_at_reduced_size(monkeypatch, capsys):
    """``chip_smoke.run_dryrun`` on the CPU at granite-3-2b's reduced
    config with remat on: D1's rows, D2's and D3's counts on meta and on the
    CPU equal, D2's calibrated products equal to ``train_work``'s with the
    masked halves, the predicted peaks within the band of the CPU run's."""
    import argparse

    import chip_smoke
    import repro_torch.configs

    real = repro_torch.configs.get_config

    def reduced(arch):
        return dataclasses.replace(real(arch).reduced(), remat=True)

    monkeypatch.setattr(repro_torch.configs, "get_config", reduced)
    monkeypatch.setattr(dryrun, "get_config", reduced)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 64)
    monkeypatch.setattr(chip_smoke, "LM_PROMPT", 64)
    monkeypatch.setattr(chip_smoke, "LM_GEN", 8)
    chip_smoke.run_dryrun(argparse.Namespace(seed=0), torch, torch.device("cpu"), 100.0, 10.0)
    out = capsys.readouterr().out.splitlines()
    d1 = [line for line in out if line.startswith("dryrun D1")]
    assert [line.split()[2].split("/")[1] for line in d1] == [
        s.name for s in valid_cells(reduced("granite-3-2b"))]
    assert sum(line.startswith("dryrun D2") for line in out) == 3
    assert sum(line.startswith("dryrun D3") for line in out) == 3
    assert out[-1].startswith("dryrun: D1-D3 in ") and "launching none" in out[-1]
