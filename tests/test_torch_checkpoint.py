"""The port's checkpoints (``repro_torch.checkpoint.ckpt``), fault runtime
(``repro_torch.runtime.fault``) and training launcher
(``repro_torch.launch.train``, ``examples/torch_train_lm.py``).

The reference's checks (``tests/test_checkpoint_and_fault.py``) run on the
port.  Checkpoints pass between the packages both ways, reduced
granite-3-2b's bf16 parameters with its optimiser state (with and without
the error feedback): the values equal bit for bit and the manifests'
``paths``, ``shapes`` and ``dtypes`` equal.  An async save copies every
leaf before it returns: a train step taken while its writer is held back
changes nothing saved.  ``launch.train.main`` on the CPU: four steps
straight equal two steps, an async save and a resume of two more, bit for
bit.
"""
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

from repro_torch import convert  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.checkpoint.ckpt import latest_step, prune, restore, save  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data.pipeline import DataConfig, batch_for_step  # noqa: E402
from repro_torch.models.lm import init_params  # noqa: E402
from repro_torch.optim.adamw import OptConfig, init_opt_state  # noqa: E402
from repro_torch.runtime.fault import (  # noqa: E402
    FailureDetector,
    StragglerTracker,
    elastic_mesh_shape,
    plan_recovery,
)
from repro_torch.train.step import make_train_step  # noqa: E402
from repro_torch.tree import flatten_with_path, leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(8, 8, generator=g), "b": torch.zeros(8)},
        "step": torch.tensor(7, dtype=torch.int32),
    }


# the reference's checks (tests/test_checkpoint_and_fault.py) on the port
def test_roundtrip(tmp_path):
    d = str(tmp_path)
    st = _state()
    save(d, 7, st)
    got, step = restore(d, st)
    assert step == 7
    np.testing.assert_array_equal(got["params"]["w"].numpy(), st["params"]["w"].numpy())


def test_latest_and_prune(tmp_path):
    d = str(tmp_path)
    for s in (1, 3, 5, 9):
        save(d, s, _state(s))
    assert latest_step(d) == 9
    prune(d, keep=2)
    assert latest_step(d) == 9
    assert sorted(os.listdir(d)) == ["step_000005", "step_000009"]


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = str(tmp_path)
    save(d, 2, _state())
    os.makedirs(os.path.join(d, "step_000008"))  # partial, no COMMIT
    assert latest_step(d) == 2
    got, step = restore(d, _state())
    assert step == 2


def test_async_save(tmp_path):
    d = str(tmp_path)
    handle = save(d, 4, _state(), blocking=False)
    handle.join(timeout=30)
    assert not handle.is_alive()
    assert latest_step(d) == 4


def test_failure_detector():
    clock = [0.0]
    det = FailureDetector(4, timeout_s=10.0, clock=lambda: clock[0])
    clock[0] = 5.0
    for h in range(3):
        det.heartbeat(h)
    clock[0] = 14.0  # hosts 0-2 heartbeat 9s ago (alive), host 3 14s ago (dead)
    dead = det.sweep()
    assert dead == [3]
    assert det.alive_hosts == [0, 1, 2]


def test_elastic_mesh_shapes():
    assert elastic_mesh_shape(512, 16) == (2, 16, 16)
    assert elastic_mesh_shape(511, 16) == (16, 16)   # lose a chip -> 1 pod
    assert elastic_mesh_shape(256, 16) == (16, 16)
    assert elastic_mesh_shape(130, 16) == (8, 16)
    assert elastic_mesh_shape(8, 16) is None


def test_straggler_tracker():
    tr = StragglerTracker(4, window=8, z_threshold=1.5)
    for step in range(8):
        for h in range(4):
            tr.record(h, 1.0 + (3.0 if h == 2 else 0.0))
    assert tr.stragglers() == [2]


def test_plan_recovery_flow():
    clock = [0.0]
    det = FailureDetector(8, timeout_s=10.0, clock=lambda: clock[0])
    tr = StragglerTracker(8)
    plan = plan_recovery(det, tr, chips_per_host=64, model_parallel=16,
                         latest_ckpt_step=123)
    assert plan.action == "continue"
    clock[0] = 20.0
    det.heartbeat(0)
    for h in range(1, 7):
        det.hosts[h].last_heartbeat = 15.0
    # host 7 times out
    plan = plan_recovery(det, tr, 64, 16, 123)
    assert plan.action == "remesh"
    assert plan.restore_step == 123
    assert plan.mesh_shape is not None
    assert 7 in plan.evicted_hosts


@pytest.mark.parametrize("seed", range(5))
def test_fault_runtime_matches_reference(seed):
    """The copied runtime decides as the reference's on random host
    histories: sweeps, stragglers, re-mesh shapes and recovery plans."""
    from repro.runtime import fault as jfault

    from repro_torch.runtime import fault

    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 9))
    clocks = [[0.0], [0.0]]
    sides = []
    for mod, clock in zip((fault, jfault), clocks):
        sides.append((mod, mod.FailureDetector(n, timeout_s=5.0, clock=lambda c=clock: c[0]),
                      mod.StragglerTracker(n, window=8, z_threshold=1.5)))
    for t in range(12):
        beats = rng.random(n) < 0.8
        times = rng.gamma(2.0, 0.5, n) * np.where(rng.random(n) < 0.1, 4.0, 1.0)
        plans = []
        for (mod, det, tr), clock in zip(sides, clocks):
            clock[0] = float(t)
            for h in range(n):
                if beats[h]:
                    det.heartbeat(h)
                tr.record(h, float(times[h]))
            plans.append(mod.plan_recovery(det, tr, chips_per_host=8, model_parallel=4,
                                           latest_ckpt_step=t))
        assert vars(plans[0]) == vars(plans[1])
    for chips in rng.integers(0, 1200, 20):
        assert fault.elastic_mesh_shape(int(chips), 8) == jfault.elastic_mesh_shape(int(chips), 8)


def _granite_states(compress: bool):
    """Reduced granite-3-2b's bf16 parameters and a nonzero optimiser state,
    as the reference's tree of jax arrays and the port's of tensors."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models.lm import init_params as jinit
    from repro.optim.adamw import OptState as JOptState

    jp = jinit(jget("granite-3-2b").reduced(), jax.random.PRNGKey(0))
    np_p = jax.tree.map(np.asarray, jp)
    rng = np.random.default_rng(1)
    draw = lambda: jax.tree.map(  # noqa: E731
        lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), np_p)
    np_opt = {"step": np.asarray(12, np.int32), "m": draw(), "v": draw(),
              "error": draw() if compress else None}
    jopt = JOptState(jnp.asarray(np_opt["step"]), *(
        None if np_opt[k] is None else jax.tree.map(jnp.asarray, np_opt[k])
        for k in ("m", "v", "error")))
    cfg = get_config("granite-3-2b").reduced()
    port = {"params": convert.lm_params_from_numpy(cfg, np_p, "cpu"),
            "opt": convert.opt_state_from_numpy(cfg, np_opt, "cpu")}
    return {"params": jp, "opt": jopt}, port


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.name == "bfloat16" else a


def _manifest(d, step) -> dict:
    return json.loads((Path(d) / f"step_{step:06d}" / "manifest.json").read_text())


@pytest.mark.parametrize("compress", [False, True])
def test_checkpoints_pass_between_the_packages_both_ways(tmp_path, compress):
    import jax

    from repro.checkpoint import ckpt as jckpt

    jstate, pstate = _granite_states(compress)
    want = [_bits(x) for x in jax.tree.leaves(jstate)]
    assert any(np.asarray(x).dtype.name == "bfloat16" for x in jax.tree.leaves(jstate))
    # JAX saves, the port restores
    jckpt.save(str(tmp_path / "j"), 5, jstate)
    like = convert.from_numpy(jax.tree.map(np.zeros_like, convert.to_numpy(pstate)), "cpu")
    got, step = restore(str(tmp_path / "j"), like)
    assert step == 5
    assert type(got["opt"]).__name__ == "OptState" and (got["opt"].error is None) != compress
    for g, w in zip(leaves(convert.to_numpy(got)), want, strict=True):
        assert g.dtype == w.dtype and g.shape == w.shape
        np.testing.assert_array_equal(g, w)
    assert got["params"]["embed"].dtype == torch.bfloat16
    # the port saves, JAX restores
    save(str(tmp_path / "p"), 5, pstate)
    back, step = jckpt.restore(str(tmp_path / "p"), jstate)
    assert step == 5
    for g, w in zip(jax.tree.leaves(back), want, strict=True):
        assert np.asarray(g).dtype == np.asarray(w).dtype or _bits(g).dtype == w.dtype
        np.testing.assert_array_equal(_bits(g), w)
    mj, mp = _manifest(tmp_path / "j", 5), _manifest(tmp_path / "p", 5)
    assert mj == mp
    assert mp["paths"][:2] == ["opt/step", "opt/m/embed"] and "params/layers/attn/wq" in mp["paths"]
    assert "bfloat16" in mp["dtypes"] and "int32" in mp["dtypes"]
    assert sorted(os.listdir(tmp_path / "p" / "step_000005")) == ["COMMIT", "manifest.json",
                                                                  "shard_0.npz"]


def test_restore_refuses_a_tree_of_other_paths_or_shapes(tmp_path):
    save(str(tmp_path), 1, _state())
    st = _state()
    st["params"]["w"] = torch.zeros(8, 9)
    with pytest.raises(ValueError, match="does not match"):
        restore(str(tmp_path), st)
    with pytest.raises(ValueError, match="does not match"):
        restore(str(tmp_path), {"params": _state()["params"]})
    assert restore(str(tmp_path / "none"), _state()) == (None, None)


def test_async_save_snapshots_before_it_returns(tmp_path, monkeypatch):
    """The writer is held back until a train step has written the
    parameters and moments in place: what was saved is the state before
    the step."""
    cfg = get_config("granite-3-2b").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    opt_cfg = OptConfig(lr=1e-2, warmup_steps=1, total_steps=10)
    opt = init_opt_state(opt_cfg, params)
    before = convert.to_numpy({"params": params, "opt": opt})
    gate = threading.Event()
    real = np.savez

    def held(*args, **kwargs):
        assert gate.wait(60)
        return real(*args, **kwargs)

    monkeypatch.setattr(ckpt.np, "savez", held)
    writer = save(str(tmp_path), 3, {"params": params, "opt": opt}, blocking=False)
    dc = DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(dc, 0).items()}
    params, opt, _ = make_train_step(cfg, opt_cfg)(params, opt, batch)
    assert latest_step(str(tmp_path)) is None
    gate.set()
    writer.join(60)
    assert not writer.is_alive()
    got, step = restore(str(tmp_path), {"params": params, "opt": opt})
    assert step == 3
    after = convert.to_numpy({"params": params, "opt": opt})
    moved = 0
    for (path, g), w, a in zip(flatten_with_path(convert.to_numpy(got)),
                               leaves(before), leaves(after), strict=True):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
        moved += not np.array_equal(w, a)
    assert moved > 10  # the step did write the parameters and moments


def _restored(d):
    cfg = get_config("granite-3-2b").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(9), device="cpu")
    got, step = restore(str(d), {"params": params, "opt": init_opt_state(OptConfig(), params)})
    return convert.to_numpy(got), step


def test_launch_train_resumes_bit_for_bit(tmp_path, capsys):
    """``main`` on the CPU: 4 steps straight against 2 steps (their async
    save at step 2 the only checkpoint) and a fresh ``main`` that resumes
    from it for 2 more; two microbatches.  In warmup (20 steps) the
    learning rate does not depend on ``--steps``."""
    from repro_torch.launch.train import main

    base = ["--reduced", "--device", "cpu", "--seq-len", "16", "--global-batch", "4",
            "--microbatches", "2", "--ckpt-every", "2"]
    assert main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "a")]) == 0
    assert main(base + ["--steps", "2", "--ckpt-dir", str(tmp_path / "b")]) == 0
    assert sorted(os.listdir(tmp_path / "b")) == ["step_000002"]
    assert _restored(tmp_path / "b")[0]["opt"].step == 2
    capsys.readouterr()
    assert main(base + ["--steps", "4", "--ckpt-dir", str(tmp_path / "b")]) == 0
    out = capsys.readouterr().out
    assert "[train] resumed from step 2" in out and "[train] done at step 4" in out
    a, sa = _restored(tmp_path / "a")
    b, sb = _restored(tmp_path / "b")
    assert sa == sb == 4 and int(a["opt"].step) == 4
    for (path, x), y in zip(flatten_with_path(a), leaves(b), strict=True):
        np.testing.assert_array_equal(x, y, err_msg=str(path))
    assert sorted(os.listdir(tmp_path / "a")) == ["step_000002", "step_000004"]


def test_launch_train_logs_and_runs_on_the_card_unless_asked(tmp_path, capsys, monkeypatch):
    from repro_torch.launch.train import main

    main(["--reduced", "--device", "cpu", "--steps", "12", "--seq-len", "8",
          "--global-batch", "2", "--ckpt-dir", str(tmp_path), "--ckpt-every", "5",
          "--compress-grads"])
    lines = capsys.readouterr().out.splitlines()
    assert [ln.split()[2] for ln in lines if ln.startswith("[train] step")] == ["0", "10", "11"]
    assert lines[-1] == "[train] done at step 12"
    # prune(keep=2) runs as step 10's writer starts, and the final save prunes nothing
    assert sorted(os.listdir(tmp_path)) == ["step_000005", "step_000010", "step_000012"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["--reduced", "--steps", "1", "--ckpt-dir", str(tmp_path / "x")])


def test_train_example_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    sys.path.insert(0, str(ROOT / "examples"))
    try:
        import torch_train_lm
    finally:
        sys.path.remove(str(ROOT / "examples"))
    assert torch_train_lm.main(["--device", "cpu", "--steps", "4", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path)]) == 0
    assert torch_train_lm.main(["--device", "cpu", "--steps", "6", "--ckpt-every", "2",
                                "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and out.rstrip().endswith(
        "done; final checkpoint at step 6")


def test_smoke_train_phase_runs_on_the_cpu_at_reduced_configs(monkeypatch, capsys):
    """``chip_smoke.run_train`` end to end on the CPU at every config's
    reduced size (sequences of 16): T1's checks hold and labels shifted by
    one position are rejected, T2's card-against-CPU comparison holds CPU
    against CPU, T3's resume is bit for bit under deterministic algorithms,
    T4 runs every other block pattern, and no port kernel is launched."""
    import argparse

    import chip_smoke
    import repro_torch.configs

    real = repro_torch.configs.get_config
    monkeypatch.setattr(repro_torch.configs, "get_config", lambda arch: real(arch).reduced())
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "cuda_ms", lambda torch, fn, warmup=3, reps=20: (
        fn(), 0.0)[1])
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 16)
    chip_smoke.run_train(argparse.Namespace(seed=0), torch, torch.device("cpu"))
    out = capsys.readouterr().out
    assert "rejected" in out and "launching none of the port's kernels" in out
    assert "equal bit for bit in every leaf" in out and "[train] resumed from step 2" in out
    assert [line.split(":")[0].split(" ")[2] for line in out.splitlines()
            if line.startswith("train T4")] == ["rwkv6-1.6b", "zamba2-2.7b", "whisper-base",
                                               "mixtral-8x7b,"]
    assert sum(line.startswith("train T2") for line in out.splitlines()) == 2


def test_opt_state_and_trees_cross_through_numpy():
    """``convert.opt_state_from_numpy`` takes the reference's OptState (or a
    mapping of its fields) and checks the moment trees' keys;
    ``convert.to_numpy`` keeps a tree's structure and gives bf16 as its
    bits."""
    cfg = get_config("granite-3-2b").reduced()
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    st = init_opt_state(OptConfig(compress_grads=True), params)
    np_st = convert.to_numpy(st)
    assert type(np_st).__name__ == "OptState" and np_st.step.dtype == np.int32
    back = convert.opt_state_from_numpy(cfg, np_st._asdict(), "cpu")
    assert all(torch.equal(a, b) for a, b in zip(leaves(back), leaves(st), strict=True))
    bits = convert.to_numpy(params)["embed"]
    assert bits.dtype == np.uint16
    assert torch.equal(torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16),
                       params["embed"])
    bad = dict(np_st._asdict(), m={**np_st.m, "extra": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="extra"):
        convert.opt_state_from_numpy(cfg, bad, "cpu")
    with pytest.raises(KeyError, match="OptState"):
        convert.opt_state_from_numpy(cfg, {"step": 0, "m": {}, "v": {}}, "cpu")
