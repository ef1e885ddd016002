"""Checkpoints and ``launch.train`` across devices, on the CPU over ``gloo``.

A state placed on a (2, 2) ``data`` x ``model`` mesh (granite-3-2b reduced,
bf16 weights and fp32 moments after one step, four processes of
``tests/torch_sharded_worker.py``) is saved as full leaves by rank 0; it
restores on one device bit for bit, and that one-device state, saved
again, restores onto the mesh on its placements bit for bit.  Only rank 0
copies the gathered leaves to the host.

``python -m torch.distributed.run --nproc-per-node 4 -m
repro_torch.launch.train --reduced --device cpu --mesh 2x2 --steps 3``
runs and logs the losses of ``--mesh 1x1``.  In fp32 (``--param-dtype
float32``) they are equal as logged (4 decimals: within 1e-5 of values near
6.7), also after a resume from the sharded run's checkpoint.  In the
config's bf16 the sums that a mesh splits across ranks (a row-parallel
product's partial sums over 'model', the FSDP rows over 'data') are
rounded to bf16 before they are added, where one device rounds once: the
logged losses stay within ``tests/torch_train_parity.py``'s bf16 loss
bound, 2e-3 (a CPU run reads 1e-4).  In two microbatches with no
checkpoint (an empty ``--ckpt-dir``), fp32, the mesh logs one device's
losses too, and a line of each step's ms.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import torch_train_parity as tp  # noqa: E402

from repro_torch.checkpoint.ckpt import restore  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models.lm import init_params  # noqa: E402
from repro_torch.optim.adamw import OptConfig, init_opt_state  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
TIMEOUT_S = 300


def _env() -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


def _wait(procs) -> list:
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0].decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
    return outs


def test_a_mesh_checkpoint_restores_on_one_device_and_back(tmp_path):
    procs = [subprocess.Popen([sys.executable, str(TESTS / "torch_sharded_worker.py"), str(r),
                               "4", f"file://{tmp_path / 'pg'}", str(tmp_path), "ckpt"],
                              env=_env(), stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    _wait(procs)
    got = torch.load(tmp_path / "state.pt", weights_only=False)
    assert got["restored_equal"] == [True] * 4
    # rank 0 alone copies the gathered leaves to the host
    assert got["host_copies"] == [len(got["state"]), 0, 0, 0]
    cfg = get_config("granite-3-2b").reduced()
    plain = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    like = {"params": plain, "opt": init_opt_state(OptConfig(), plain)}
    state, step = restore(str(tmp_path / "mesh"), like)
    assert step == 1
    for a, b in zip(leaves(state), got["state"], strict=True):
        assert type(a) is torch.Tensor and a.dtype == b.dtype and torch.equal(a, b)
    assert {x.dtype for x in leaves(state["params"])} == {torch.bfloat16, torch.float32}


def _train(tmp_path, mesh: str, steps: int, ckpt: str, *extra):
    cmd = ["-m", "repro_torch.launch.train", "--reduced", "--device", "cpu", "--mesh", mesh,
           "--steps", str(steps), "--ckpt-dir", str(tmp_path / ckpt) if ckpt else "", *extra]
    if mesh != "1x1":
        cmd = ["-m", "torch.distributed.run", "--nproc-per-node", "4",
               "--rdzv-backend", "c10d", "--rdzv-endpoint", "localhost:0", *cmd]
    return subprocess.Popen([sys.executable, *cmd], env=_env(), cwd=tmp_path,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)


def _losses(out: str) -> dict:
    return {int(s): float(x) for s, x in re.findall(r"\[train\] step +(\d+) loss (\S+)", out)}


def test_launch_train_on_a_mesh_logs_the_one_device_losses(tmp_path):
    fp32 = ("--param-dtype", "float32")
    runs = _wait([_train(tmp_path, "2x2", 3, "bf16"), _train(tmp_path, "1x1", 3, "bf16-1"),
                  _train(tmp_path, "2x2", 3, "f32", *fp32), _train(tmp_path, "1x1", 5, "f32-1",
                                                                    *fp32)])
    bf16, bf16_one, f32, f32_one = map(_losses, runs)
    assert sorted(bf16) == sorted(bf16_one) == [0, 2]
    assert all(tp.rel(bf16[s], bf16_one[s]) <= tp.FP16["loss"] for s in bf16), (bf16, bf16_one)
    assert sorted(f32) == [0, 2] and sorted(f32_one) == [0, 4]
    assert f32[0] == f32_one[0], (f32, f32_one)
    assert sum(line.startswith("[train] done") for line in runs[0].splitlines()) == 1
    assert "recovery plan" not in runs[0] + runs[2]
    # the sharded run resumes from its checkpoint at step 3 and logs step 4
    resumed = _wait([_train(tmp_path, "2x2", 5, "f32", *fp32)])[0]
    assert "[train] resumed from step 3" in resumed
    assert _losses(resumed) == {4: f32_one[4]}, (resumed[-2000:], f32_one)


def test_launch_train_logs_step_times_and_keeps_no_checkpoint_without_a_directory(tmp_path):
    """``launch.train`` in two microbatches on the (2, 2) mesh against
    ``--mesh 1x1``, fp32, with an empty ``--ckpt-dir``: the same losses as
    logged (a microbatch holds the same rows on both), a line before the
    last with each step's ms and no peak memory on the CPU, and no
    checkpoint written."""
    extra = ("--param-dtype", "float32", "--microbatches", "2", "--global-batch", "8")
    runs = _wait([_train(tmp_path, mesh, 2, "", *extra) for mesh in ("2x2", "1x1")])
    mesh, one = map(_losses, runs)
    assert sorted(mesh) == [0, 1] and mesh == one, (mesh, one)
    for out in runs:
        lines = out.splitlines()
        timing = [line for line in lines if line.startswith("[train] timing: step ms")]
        assert len(timing) == 1 and timing[0].endswith("; peak GiB not measured (cpu)"), out
        assert len(re.findall(r"\d+\.\d\d", timing[0].split(";")[0])) == 2
        assert lines.index(timing[0]) + 1 == lines.index("[train] done at step 2")
    assert "resumed" not in runs[0] + runs[1]
    assert not any(tmp_path.rglob("manifest.json"))
