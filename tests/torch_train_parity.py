"""The port's train step against ``repro.train.step``'s on the same weights,
moments and batch: the shared part of ``tests/test_torch_train_step*.py``.

Weights come from the reference's ``init_params(cfg, PRNGKey(0))`` at the
reduced config (``param_dtype`` as asked), carried across by
``convert.lm_params_from_numpy``; the moments are drawn with numpy from a
seed (``m`` normal, ``v`` a square) at optimiser step 3 and carried across
by ``convert.opt_state_from_numpy``; the batch is ``batch_for_step``'s,
which both packages make alike.  Each side runs one train step; the
reference's gradients come from ``jax.value_and_grad`` of its ``loss_fn``,
the port's from ``train.step.loss_and_grads``.  Everything comes back as
numpy (bf16 as float32) for the comparison.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch import convert
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.optim.adamw import OptConfig
from repro_torch.train.step import loss_and_grads, make_train_step
from repro_torch.tree import flatten_with_path, path_str

B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
MOE_ARCHS = {"arctic-480b", "mixtral-8x7b"}


def data_config(cfg) -> DataConfig:
    return DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                      frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                      frontend_dim=cfg.frontend_dim if cfg.frontend else 0)


def f32(a) -> np.ndarray:
    return np.array(a, np.float32)  # a copy: the port writes its tensors in place


def moments(np_params, seed: int = 7) -> dict:
    """The optimiser state both sides start from, as numpy: step 3, ``m``
    normal at 1e-3, ``v`` the square of 1e-3 plus the size of another such
    draw, so that |m| stays within a few sqrt(v), as a real run's moments
    do (a tiny ``v`` under a large ``m`` would make the update a quotient of
    two roundings)."""
    import jax

    rng = np.random.default_rng(seed)
    m = jax.tree.map(lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), np_params)
    v = jax.tree.map(lambda a: np.square(1e-3 + np.abs(rng.normal(0, 1e-3, a.shape)))
                     .astype(np.float32),
                     np_params)
    return {"step": np.asarray(3, np.int32), "m": m, "v": v, "error": None}


@functools.lru_cache(maxsize=None)
def reference(arch: str, dtype: str, microbatches: int) -> dict:
    """The reference's step: {"paths", "params", "m", "v", "loss",
    "grad_norm", "grads" (one microbatch only), "step"}, leaves as float32
    numpy in JAX's order."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_config as jget
    from repro.models.lm import init_params
    from repro.optim.adamw import OptConfig as JOptConfig
    from repro.optim.adamw import OptState as JOptState
    from repro.train.step import loss_fn, make_train_step as jmake_train_step

    jcfg = dataclasses.replace(jget(arch).reduced(), param_dtype=dtype)
    jp = init_params(jcfg, jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jp)
    st = moments(np_params)
    jopt = JOptState(jnp.asarray(st["step"]), jax.tree.map(jnp.asarray, st["m"]),
                     jax.tree.map(jnp.asarray, st["v"]), None)
    batch = {k: jnp.asarray(v) for k, v in batch_for_step(data_config(jcfg), 0).items()}
    out = {"paths": [path_str(tuple(str(getattr(k, "key", getattr(k, "name", k))) for k in p))
                     for p, _ in jax.tree_util.tree_flatten_with_path(jp)[0]],
           "np_params": np_params, "np_opt": st}
    if microbatches == 1:
        loss, grads = jax.jit(jax.value_and_grad(functools.partial(loss_fn, jcfg)))(jp, batch)
        out["grads"] = [f32(g) for g in jax.tree.leaves(grads)]
        out["value_loss"] = float(loss)
    step = jax.jit(jmake_train_step(jcfg, JOptConfig(**OPT), microbatches=microbatches))
    new_p, new_opt, metrics = step(jp, jopt, batch)
    out.update(params=[f32(x) for x in jax.tree.leaves(new_p)],
               m=[f32(x) for x in jax.tree.leaves(new_opt.m)],
               v=[f32(x) for x in jax.tree.leaves(new_opt.v)],
               step=int(new_opt.step), loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]))
    return out


def port(arch: str, dtype: str, microbatches: int) -> dict:
    """The port's step on the reference's weights, moments and batch, in
    the same form as ``reference``'s."""
    ref = reference(arch, dtype, microbatches)
    cfg = dataclasses.replace(get_config(arch).reduced(), param_dtype=dtype)
    p = convert.lm_params_from_numpy(cfg, ref["np_params"], "cpu")
    opt = convert.opt_state_from_numpy(cfg, ref["np_opt"], "cpu")
    batch = {k: torch.from_numpy(v) for k, v in batch_for_step(data_config(cfg), 0).items()}
    out = {"paths": [path_str(pt) for pt, _ in flatten_with_path(p)],
           "old": [f32(t.float()) for _, t in flatten_with_path(p)]}
    if microbatches == 1:
        loss, grads = loss_and_grads(cfg, p, batch)
        out["grads"] = [t.float().numpy() for _, t in flatten_with_path(grads)]
        out["value_loss"] = float(loss)
    new_p, new_opt, metrics = make_train_step(cfg, OptConfig(**OPT), microbatches)(p, opt, batch)
    leaves = lambda tree: [f32(t.float()) for _, t in flatten_with_path(tree)]  # noqa: E731
    out.update(params=leaves(new_p), m=leaves(new_opt.m), v=leaves(new_opt.v),
               step=int(new_opt.step), loss=float(metrics["loss"]),
               grad_norm=float(metrics["grad_norm"]), lr=float(metrics["lr"]),
               same_tensors=new_p is p and all(a is b for (_, a), (_, b) in zip(
                   flatten_with_path(new_p), flatten_with_path(p))))
    return out


def rel_l2(got, want) -> float:
    """‖got − want‖ / ‖want‖ over the whole leaf, in float64 (0 where both
    are 0)."""
    g, w = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = float(np.linalg.norm(g - w))
    n = float(np.linalg.norm(w))
    return d / n if n else d


def worst(got: list, want: list, paths: list) -> tuple:
    """(the largest ``rel_l2`` over the leaves, its path)."""
    errs = [(rel_l2(g, w), p) for g, w, p in zip(got, want, paths, strict=True)]
    return max(errs)


# fp32: the two frameworks sum in other orders (a CPU run reads the loss and
# the gradient norm within 2.1e-7, a gradient leaf within 3.5e-6, an update
# (new minus old) within 1.2e-5, the moments within 1.9e-6)
FP32 = {"loss": 1e-5, "grad_norm": 1e-5, "grads": 1e-4, "update": 1e-3, "moments": 1e-4}
# bf16 (the dense, SSM and encoder archs): each side rounds to bf16 at some
# twenty places a value passes through two layers forward and back, 2^-9
# each, but not at the same places: a CPU run reads the loss within 4.0e-4,
# the gradient norm within 1.9e-3, a gradient leaf within 3.9e-2 (rwkv6's
# w_decay_a), the moments within 1.8e-2, an update within 4.5e-2 (a few
# bf16 steps of its parameter, and the two sides' steps part where their
# fp32 values straddle a rounding); the bounds are about twice those
FP16 = {"loss": 2e-3, "grad_norm": 1e-2, "grads": 8e-2, "update": 1e-1, "moments": 8e-2}


def rel(got: float, want: float) -> float:
    return abs(got - want) / abs(want)


def _held(what: str, got: list, want: list, paths: list, bound: float) -> None:
    err, path = worst(got, want, paths)
    assert err <= bound, f"{what} of {path}: relative L2 error {err} > {bound}"


def check(arch: str, dtype: str, microbatches: int) -> None:
    """The port's step against the reference's: the leaves' paths, the
    loss, the gradient norm and the learning rate, the step count, the
    gradients (one microbatch), the updates, the moments; and the port's
    tensors written in place."""
    import jax

    r, g = reference(arch, dtype, microbatches), port(arch, dtype, microbatches)
    tol = FP32 if dtype == "float32" else FP16
    assert g["paths"] == r["paths"]
    assert g["step"] == r["step"] == 4
    assert g["same_tensors"], "the train step must return the parameter tensors it was given"
    assert rel(g["lr"], r["lr"]) <= 1e-6
    assert rel(g["loss"], r["loss"]) <= tol["loss"], (g["loss"], r["loss"])
    assert rel(g["grad_norm"], r["grad_norm"]) <= tol["grad_norm"], (g["grad_norm"],
                                                                       r["grad_norm"])
    if microbatches == 1:
        assert rel(g["value_loss"], r["value_loss"]) <= tol["loss"]
        assert g["value_loss"] == g["loss"]
        _held("gradient", g["grads"], r["grads"], g["paths"], tol["grads"])
    old = [f32(x) for x in jax.tree.leaves(r["np_params"])]
    _held("update", [a - o for a, o in zip(g["params"], old)],
          [a - o for a, o in zip(r["params"], old)], g["paths"], tol["update"])
    _held("m", g["m"], r["m"], g["paths"], tol["moments"])
    _held("v", g["v"], r["v"], g["paths"], tol["moments"])
