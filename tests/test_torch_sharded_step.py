"""The port's steps sharded across devices (DTensor placements on a
``DeviceMesh``, ``repro_torch.train.sharding``) against the one-device
steps, on the CPU.

One spawn of four ``gloo`` processes (``tests/torch_sharded_worker.py``) on
a (2, 2) ``data`` x ``model`` mesh runs, in fp32 at the reduced configs,
each of the ten archs' train step (``loss_and_grads``, then the train step
with moments at step 3), granite-3-2b's in two microbatches, AdamW with
int8 compression on placed gradients (within 1e-6 of one device), and the
prefill and 3 decode steps of granite-3-2b, of a variant whose 3 query
heads and one KV head the model axis divides neither, and of one with int8
caches.  The MoE archs also run in two microbatches.  Each rank builds the same inputs from seeds, and the one-device
steps run here on the same ones.  The train steps are held at
``tests/torch_train_parity.py``'s fp32 bounds: loss and gradient norm
1e-5, gradients 1e-4 (gathered), updates 1e-3 and moments 1e-4 (relative
L2 over each leaf).

The MoE archs route in ``dp_size`` groups at a mesh, where one device
routes in one, so they are held instead to the reference's step at the
same mesh: ``tests/torch_sharded_reference.py`` in a subprocess with four
host devices, the port's weights, moments and batch carried across, and
``set_activation_axes`` on ``jax.make_mesh((2, 2), ...)``.

The decode steps' logits are held to the one-device steps' rows within
``tests/test_torch_lm.py``'s 5e-4, positions and cursors equal, K and V
(and the int8 codes' scales) within a bf16 step.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")  # the port's optional extra

import torch_sharded_worker as W  # noqa: E402
import torch_train_parity as tp  # noqa: E402

from repro_torch.configs import ARCHS  # noqa: E402
from repro_torch.models.lm import init_params  # noqa: E402
from repro_torch.optim.adamw import OptConfig  # noqa: E402
from repro_torch.train.step import (  # noqa: E402
    loss_and_grads,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TESTS = Path(__file__).resolve().parent
SPAWN_S = 120
MOE = sorted(tp.MOE_ARCHS)
DENSE = sorted(set(ARCHS) - tp.MOE_ARCHS)
CACHED_ROW_REL = 5e-4  # tests/test_torch_lm.py's
BF16_STEP = 2.0 ** -7


def _env(**extra) -> dict:
    env = dict(os.environ, OMP_NUM_THREADS="1", **extra)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src"), str(TESTS)] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    return env


# the reference's runs: each MoE arch in one microbatch, and in two
REF_NAMES = MOE + [f"{arch}:2" for arch in W.MICRO_MOE]


def _reference_inputs(path: Path) -> None:
    out = {}
    for name in REF_NAMES:
        arch, _, k = name.partition(":")
        params, opt, batch = W.inputs(W.train_config(arch), microbatches=int(k or 1))
        for kind, tree in (("p", params), ("m", opt.m), ("v", opt.v)):
            for i, x in enumerate(leaves(tree)):
                out[f"{name}/{kind}{i}"] = x.numpy()
        for k, x in batch.items():
            out[f"{name}/batch/{k}"] = x.numpy()
    np.savez(path, **out)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawn's results, then the reference's; the spawn must end
    within ``SPAWN_S`` seconds."""
    tmp = tmp_path_factory.mktemp("sharded")
    init = f"file://{tmp / 'pg'}"
    t0 = time.perf_counter()
    ranks = [subprocess.Popen([sys.executable, str(TESTS / "torch_sharded_worker.py"), str(r),
                               "4", init, str(tmp / "sharded.pt")], env=_env(),
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(4)]
    logs = []
    try:
        for p in ranks:
            left = max(1.0, SPAWN_S - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=left)[0].decode(errors="replace"))
        spawn_s = time.perf_counter() - t0
    finally:
        for p in ranks:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(ranks, logs)):
        assert p.returncode == 0, f"rank {r}:\n{log[-4000:]}"
    # the reference after the spawn, so that its XLA threads do not share
    # the spawn's time
    _reference_inputs(tmp / "ref_in.npz")
    ref_env = _env(XLA_FLAGS="--xla_force_host_platform_device_count=4", JAX_PLATFORMS="cpu")
    ref = subprocess.run([sys.executable, str(TESTS / "torch_sharded_reference.py"),
                          str(tmp / "ref_in.npz"), str(tmp / "ref_out.npz"), *REF_NAMES],
                         env=ref_env, capture_output=True, timeout=600)
    assert ref.returncode == 0, (ref.stdout + ref.stderr).decode(errors="replace")[-4000:]
    got = torch.load(tmp / "sharded.pt", weights_only=False)
    return {"sharded": got["results"], "seconds": got["seconds"], "spawn_s": spawn_s,
            "ref": dict(np.load(tmp / "ref_out.npz"))}


def _one_device(cfg, microbatches: int = 1) -> dict:
    params, opt, batch = W.inputs(cfg, microbatches=microbatches)
    out = {"old": [x.clone() for x in leaves(params)]}
    if microbatches == 1:
        loss, grads = loss_and_grads(cfg, params, batch)
        out.update(value_loss=float(loss), grads=[g.float() for g in leaves(grads)])
    new_p, new_opt, metrics = make_train_step(cfg, OptConfig(**W.OPT), microbatches)(
        params, opt, batch)
    out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               lr=float(metrics["lr"]), step=int(new_opt.step),
               params=[x.float() for x in leaves(new_p)], m=leaves(new_opt.m),
               v=leaves(new_opt.v))
    return out


def _held(what, got, want, old, bound) -> None:
    got = [np.asarray(g, np.float32) - (0 if old is None else o.numpy())
           for g, o in zip(got, old or got)]
    want = [np.asarray(w, np.float32) - (0 if old is None else o.numpy())
            for w, o in zip(want, old or want)]
    err = max(tp.rel_l2(g, w) for g, w in zip(got, want, strict=True))
    assert err <= bound, f"{what}: relative L2 error {err} > {bound}"


def _check(g: dict, want: dict, old: list, microbatches: int = 1) -> None:
    tol = tp.FP32
    assert g["step"] == want["step"] == 4
    assert g["same_tensors"] and g["placed"]
    assert tp.rel(g["lr"], want["lr"]) <= 1e-6
    assert tp.rel(g["loss"], want["loss"]) <= tol["loss"], (g["loss"], want["loss"])
    assert tp.rel(g["grad_norm"], want["grad_norm"]) <= tol["grad_norm"], (
        g["grad_norm"], want["grad_norm"])
    if microbatches == 1:
        assert all(g["grad_placements"]), "a gradient is not on its parameter's placements"
        assert tp.rel(g["value_loss"], want["value_loss"]) <= tol["loss"]
        _held("gradient", g["grads"], want["grads"], None, tol["grads"])
    _held("update", g["params"], want["params"], old, tol["update"])
    _held("m", g["m"], want["m"], None, tol["moments"])
    _held("v", g["v"], want["v"], None, tol["moments"])


def test_the_spawn_ends_within_its_limit(runs):
    assert runs["spawn_s"] <= SPAWN_S, runs["seconds"]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_each_mesh_axis_shards_some_leaf(runs, arch):
    assert runs["sharded"][arch]["axes"] == {"data", "model"}


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_train_step_matches_one_device(runs, arch):
    want = _one_device(W.train_config(arch))
    _check(runs["sharded"][arch], want, want["old"])


def test_sharded_microbatched_train_step_matches_one_device(runs):
    """Two microbatches, each the global batch's half, as one device's."""
    want = _one_device(W.train_config(W.MICRO_ARCH), microbatches=2)
    _check(runs["sharded"]["micro"], want, want["old"], microbatches=2)


def test_sharded_compressed_update_matches_one_device(runs):
    """AdamW with int8 compression and error feedback on placed gradients
    (granite-3-2b's one-device ones, moments from zero): each leaf's scale
    is the max over the whole leaf, so the update, the moments and the error
    feedback are the one-device ones within fp32 rounding."""
    got, want = runs["sharded"]["compress"], W.compressed_step(W.train_config(W.MICRO_ARCH))
    assert tp.rel(got["grad_norm"], want["grad_norm"]) <= 1e-6
    old = leaves(W.inputs(W.train_config(W.MICRO_ARCH))[0])
    _held("update", got["params"], want["params"], old, 1e-6)
    _held("m", got["m"], want["m"], None, 1e-6)
    _held("error", got["error"], want["error"], None, 1e-6)


def _reference(r, name: str, n: int, microbatches: int = 1) -> dict:
    """The reference's run ``name`` of ``n`` leaves, as ``_check`` reads it."""
    scalars, trees = ("loss", "grad_norm", "lr"), (("params", "param"), ("m", "m"), ("v", "v"))
    if microbatches == 1:
        scalars, trees = scalars + ("value_loss",), trees + (("grads", "grad"),)
    return {"step": int(r[f"{name}/step"]), **{k: float(r[f"{name}/{k}"]) for k in scalars},
            **{k: [r[f"{name}/{key}{i}"] for i in range(n)] for k, key in trees}}


@pytest.mark.parametrize("arch", MOE)
def test_sharded_moe_train_step_matches_the_reference_at_the_same_mesh(runs, arch):
    params, _, _ = W.inputs(W.train_config(arch))
    _check(runs["sharded"][arch], _reference(runs["ref"], arch, len(leaves(params))),
           leaves(params))


@pytest.mark.parametrize("arch", W.MICRO_MOE)
def test_sharded_microbatched_moe_train_step_matches_the_reference(runs, arch):
    """Two microbatches of a MoE arch at the mesh: each the global batch's
    half, routed in ``dp_size`` groups of its rows, as the reference's
    ``lax.scan`` over the reshaped batch takes them."""
    params, _, _ = W.inputs(W.train_config(arch), microbatches=2)
    want = _reference(runs["ref"], f"{arch}:2", len(leaves(params)), microbatches=2)
    _check(runs["sharded"]["micro", arch], want, leaves(params), microbatches=2)


def test_moe_at_the_mesh_routes_otherwise_than_one_device(runs):
    """The MoE's groups follow ``dp_size``: at the mesh mixtral's loss
    departs from one device's by far more than the fp32 bound."""
    one = _one_device(W.train_config("mixtral-8x7b"))
    assert tp.rel(runs["sharded"]["mixtral-8x7b"]["loss"], one["loss"]) > 100 * tp.FP32["loss"]


def _rows(got, want) -> float:
    g, w = got.float().numpy(), want.float().numpy()
    return float((np.linalg.norm(g - w, axis=-1)
                  / np.maximum(np.linalg.norm(w, axis=-1), 1e-30)).max())


@pytest.mark.parametrize("name", sorted(W.DECODES))
def test_sharded_decode_steps_match_one_device(runs, name):
    cfg = W.decode_config(name)
    got = runs["sharded"]["decode", name]
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    tokens, frontend = W.decode_inputs(cfg)
    prefill, decode = make_prefill_step(cfg, W.CAP), make_decode_step(cfg)
    want = []
    with torch.inference_mode():
        out, caches, enc = prefill(params, torch.from_numpy(tokens[:, :W.PROMPT]), frontend)
        want.append(out)
        for i in range(W.STEPS):
            tok = torch.from_numpy(tokens[:, W.PROMPT + i:W.PROMPT + i + 1])
            pos = torch.full((W.DEC_B, 1), W.PROMPT + i, dtype=torch.int32)
            out, caches = decode(params, tok, caches, pos, enc)
            want.append(out)
    for i, (g, w) in enumerate(zip(got["logits"], want, strict=True)):
        err = _rows(g, w)
        assert err <= CACHED_ROW_REL, f"{name} step {i}: logits rows {err}"
    kv = caches["kv"]
    for (field, w), g in zip(kv._asdict().items(), got["caches"]):
        if field in ("positions", "cursor"):
            assert torch.equal(g.to(w.dtype), w), field
        elif w is not None:
            w32 = w.float()
            assert torch.allclose(g, w32, rtol=BF16_STEP, atol=CACHED_ROW_REL), field
    # stacked (L, B, Hkv, C, D): batch over data, KV heads over model where
    # they divide it, else the cache's slots
    model = "S(2)" if cfg.n_kv % 2 == 0 else "S(3)"
    assert got["placements"]["k"] == got["placements"]["v"] == ("S(1)", model)


def test_smoke_shard_phase_runs_on_the_cpu_at_reduced_size(monkeypatch, capsys):
    """``chip_smoke.run_shard`` on the CPU at granite-3-2b's reduced config
    (sequences of 16) through a ``gloo`` group of one: its two steps run
    through DTensor, the first's loss and gradient norm hold to the plain
    step's, and the group is gone and the activation axes unset after."""
    import argparse

    import chip_smoke
    import repro_torch.configs
    from repro_torch.train import sharding

    real = repro_torch.configs.get_config
    monkeypatch.setattr(repro_torch.configs, "get_config", lambda arch: real(arch).reduced())
    for name in ("synchronize", "reset_peak_memory_stats", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(chip_smoke, "TRAIN_SEQ", 16)
    chip_smoke.run_shard(argparse.Namespace(seed=0), torch, torch.device("cpu"), 100.0, 0)
    out = capsys.readouterr().out.splitlines()
    assert [line.split()[3] for line in out if line.startswith("shard S1 [train]")] == [
        "step", "step", "timing:", "done"]
    assert out[-1].startswith("shard S1 granite-3-2b whole") and "launching none" in out[-1]
    assert not torch.distributed.is_initialized()
    assert sharding._ACT["dp"] is None and sharding.dp_size() == 1
