"""One rank of the sharded-step checks of ``tests/test_torch_sharded_step.py``:
the port's train, prefill and decode steps (and AdamW with int8 gradient
compression) placed on a (2, 2) ``data`` x
``model`` mesh over ``gloo``, four processes on the CPU.

    python tests/torch_sharded_worker.py RANK WORLD INIT_FILE OUT_FILE
    python tests/torch_sharded_worker.py RANK WORLD INIT_FILE OUT_DIR ckpt

Every rank builds the same inputs from seeds (``inputs``), places them by
``repro_torch.train.sharding``'s specs and runs the steps; rank 0 writes
what they gave (``torch.save``), the DTensors gathered to full tensors,
for the test to hold against the one-device steps on the same inputs.
Imports torch and the port only.
"""
from __future__ import annotations

import dataclasses
import sys
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models.lm import init_params
from repro_torch.optim.adamw import OptConfig, OptState, apply_updates
from repro_torch.train import sharding
from repro_torch.train.step import (
    loss_and_grads,
    make_decode_step,
    make_prefill_step,
    make_train_step,
)
from repro_torch.tree import flatten_with_path, leaves, map_with_path

B, S = 4, 16
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
# the configs that also run in two microbatches: a dense one, held to one
# device, and the MoE ones, held to the reference at the same mesh (their
# groups, and the tokens capacity drops, follow a microbatch's rows)
MICRO_ARCH = "granite-3-2b"
MICRO_MOE = ("arctic-480b", "mixtral-8x7b")
# decode: prompt, steps and cache slots (tests/test_torch_lm.py's), batch 2
PROMPT, STEPS, CAP, DEC_B = 12, 3, 24, 2
# granite's reduced config with 3 query heads and one KV head, which the
# model axis of 2 divides neither: the scores and the cache's K and V go
# sequence-sharded (the reference's other branch); and with int8 caches
ODD_HEADS = {"n_heads": 3, "n_kv": 1}


def train_config(arch: str):
    return dataclasses.replace(get_config(arch).reduced(), param_dtype="float32")


DECODES = {"granite-3-2b": {}, "granite-3-2b/odd-heads": ODD_HEADS,
           "granite-3-2b/int8": {"kv_int8": True}}


def decode_config(name: str):
    return dataclasses.replace(train_config("granite-3-2b"), **DECODES[name])


def data_config(cfg, global_batch: int = B) -> DataConfig:
    return DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=global_batch,
                      frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                      frontend_dim=cfg.frontend_dim if cfg.frontend else 0)


def inputs(cfg, seed: int = 7, microbatches: int = 1):
    """(params, optimiser state at step 3, batch 0 of ``microbatches`` x B
    rows): the weights from a seeded generator, ``m`` normal at 1e-3 and
    ``v`` the square of 1e-3 plus the size of another such draw
    (``tests/torch_train_parity.py``'s moments), drawn with numpy from
    ``seed``.  Each microbatch has the shapes of one batch of B, so the
    sharded microbatches reuse DTensor's propagation of the plain step."""
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    rng = np.random.default_rng(seed)
    m = map_with_path(lambda _, x: torch.from_numpy(
        rng.normal(0, 1e-3, tuple(x.shape)).astype(np.float32)), params)
    v = map_with_path(lambda _, x: torch.from_numpy(np.square(
        1e-3 + np.abs(rng.normal(0, 1e-3, tuple(x.shape)))).astype(np.float32)), params)
    opt = OptState(torch.tensor(3, dtype=torch.int32), m, v, None)
    dc = data_config(cfg, B * microbatches)
    batch = {k: torch.from_numpy(a) for k, a in batch_for_step(dc, 0).items()}
    return params, opt, batch


def decode_inputs(cfg, seed: int = 11):
    """(tokens (DEC_B, PROMPT + STEPS), frontend embeddings or None), numpy
    from ``seed``."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (DEC_B, PROMPT + STEPS), dtype=np.int32)
    frontend = None
    if cfg.frontend:
        frontend = rng.standard_normal((DEC_B, cfg.frontend_tokens, cfg.frontend_dim),
                                       dtype=np.float32)
    return tokens, frontend


def full_leaves(tree) -> list:
    return [x.detach().float().clone() for x in leaves(sharding.gather(tree))]


def sharded_axes(params) -> set:
    """The mesh axes some leaf of ``params`` is sharded on."""
    out = set()
    for x in leaves(params):
        for name, p in zip(x.device_mesh.mesh_dim_names, x.placements):
            if p.is_shard():
                out.add(name)
    return out


def train_step(cfg, mesh, microbatches: int = 1) -> dict:
    """The sharded step, everything gathered: with one microbatch the train
    step's halves (``loss_and_grads``, then ``apply_updates``), the
    gradients kept; with more, ``make_train_step``."""
    params, opt, batch = inputs(cfg, microbatches=microbatches)
    specs = sharding.make_param_shardings(params, mesh)
    params = sharding.place(params, specs, mesh)
    opt = OptState(opt.step, sharding.place(opt.m, specs, mesh),
                   sharding.place(opt.v, specs, mesh), None)
    batch = sharding.place(batch, sharding.make_batch_shardings(batch, mesh), mesh)
    out = {"axes": sharded_axes(params)}
    if microbatches == 1:
        # the train step's two halves, the gradients kept between them
        loss, grads = loss_and_grads(cfg, params, batch)
        out.update(value_loss=float(loss), grads=full_leaves(grads),
                   grad_placements=[tuple(g.placements) == tuple(p.placements)
                                    for g, p in zip(leaves(grads), leaves(params))])
        new_p, new_opt, metrics = apply_updates(OptConfig(**OPT), opt, params, grads)
        metrics["loss"] = loss
    else:
        step = make_train_step(cfg, OptConfig(**OPT), microbatches)
        new_p, new_opt, metrics = step(params, opt, batch)
    out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               lr=float(metrics["lr"]), step=int(new_opt.step), params=full_leaves(new_p),
               m=full_leaves(new_opt.m), v=full_leaves(new_opt.v),
               same_tensors=all(a is b for a, b in zip(leaves(new_p), leaves(params))),
               placed=all(sharding.is_dtensor(x) for x in leaves(new_opt.m)))
    return out


def compressed_step(cfg, mesh=None) -> dict:
    """AdamW with int8 gradient compression, from a fresh optimiser state
    (the error feedback zero), on the one-device gradients of batch 0: on
    ``mesh`` the parameters, state and gradients placed by the parameters'
    specs, else on one device.  The same gradients on both sides, so the
    levels are the same where each leaf's scale (its max, over every
    shard) is: the gradient norm, parameters, moments and error feedback
    after it, full."""
    from repro_torch.optim.adamw import apply_updates, init_opt_state

    params, _, batch = inputs(cfg)
    _, grads = loss_and_grads(cfg, params, batch)
    if mesh is not None:
        specs = sharding.make_param_shardings(params, mesh)
        params, grads = sharding.place(params, specs, mesh), sharding.place(grads, specs, mesh)
    opt_cfg = OptConfig(**OPT, compress_grads=True)
    new_p, new_opt, info = apply_updates(opt_cfg, init_opt_state(opt_cfg, params), params,
                                         grads)
    return {"grad_norm": float(info["grad_norm"]), "params": full_leaves(new_p),
            "m": full_leaves(new_opt.m), "error": full_leaves(new_opt.error)}


def decode_steps(cfg, mesh) -> dict:
    """Prefill of PROMPT tokens into CAP slots, then STEPS teacher-forced
    decode steps, over bf16 caches placed by ``make_cache_shardings``:
    each step's logits and the caches after the last, gathered."""
    params = init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    params = sharding.place(params, sharding.make_param_shardings(params, mesh), mesh)
    tokens, frontend = decode_inputs(cfg)

    def put(a):
        if a is None:
            return None
        t = torch.from_numpy(a)
        return sharding.place(t, sharding.make_batch_shardings(t, mesh), mesh)

    prefill, decode = make_prefill_step(cfg, CAP), make_decode_step(cfg)
    logits = []
    with torch.no_grad():
        got, caches, enc = prefill(params, put(tokens[:, :PROMPT]), put(frontend))
        logits.append(sharding.full(got).clone())
        placed = {path[-1]: tuple(str(p) for p in x.placements)
                  for path, x in flatten_with_path(caches)}
        pos0 = PROMPT + (cfg.frontend_tokens if cfg.frontend == "vision" else 0)
        for i in range(STEPS):
            tok = put(tokens[:, PROMPT + i:PROMPT + i + 1])
            pos = put(np.full((DEC_B, 1), pos0 + i, np.int32))
            got, caches = decode(params, tok, caches, pos, enc)
            logits.append(sharding.full(got).clone())
    return {"logits": logits, "caches": full_leaves(caches), "placements": placed}


def run(rank: int, world: int, init: str, out_file: str) -> None:
    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank,
                                         world_size=world)
    try:
        from repro_torch.launch.mesh import make_mesh

        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sharding.set_activation_axes(mesh)
        res, secs = {}, {}
        for arch in sorted(ARCHS):
            t0 = time.perf_counter()
            res[arch] = train_step(train_config(arch), mesh)
            secs[arch] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["micro"] = train_step(train_config(MICRO_ARCH), mesh, microbatches=2)
        secs["micro"] = time.perf_counter() - t0
        for arch in MICRO_MOE:
            t0 = time.perf_counter()
            res["micro", arch] = train_step(train_config(arch), mesh, microbatches=2)
            secs["micro", arch] = time.perf_counter() - t0
        t0 = time.perf_counter()
        res["compress"] = compressed_step(train_config(MICRO_ARCH), mesh)
        secs["compress"] = time.perf_counter() - t0
        for name in DECODES:
            t0 = time.perf_counter()
            res["decode", name] = decode_steps(decode_config(name), mesh)
            secs["decode", name] = time.perf_counter() - t0
        if rank == 0:
            torch.save({"results": res, "seconds": secs}, out_file)
    finally:
        torch.distributed.destroy_process_group()


def run_ckpt(rank: int, world: int, init: str, out_dir: str) -> None:
    """The checkpoint round trip of ``tests/test_torch_sharded_ckpt.py``:
    granite-3-2b's reduced state (bf16 weights, fp32 moments) placed on the
    mesh and one train step taken; saved from the mesh to ``mesh/``; rank 0
    restores it on one device and saves that to ``one/``; every rank
    restores ``one/`` onto the mesh, once by the specs of a plain tree and
    once like a placed one.  Rank 0 writes the state before the
    save, gathered, whether the state restored from ``one/`` equals it
    bit for bit on every rank, and how many leaves each rank's save copied
    to the host, to ``state.pt``."""
    import os

    from repro_torch.checkpoint import ckpt
    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.optim.adamw import init_opt_state

    torch.set_num_threads(1)
    torch.distributed.init_process_group("gloo", init_method=init, rank=rank,
                                         world_size=world)
    try:
        mesh = make_mesh((2, 2), ("data", "model"), "cpu")
        sharding.set_activation_axes(mesh)
        cfg = get_config("granite-3-2b").reduced()

        def fresh():
            p = init_params(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
            return sharding.place(p, sharding.make_param_shardings(p, mesh), mesh)

        params = fresh()
        opt = init_opt_state(OptConfig(**OPT), params)
        batch = {k: torch.from_numpy(a) for k, a in batch_for_step(data_config(cfg), 0).items()}
        batch = sharding.place(batch, sharding.make_batch_shardings(batch, mesh), mesh)
        params, opt, _ = make_train_step(cfg, OptConfig(**OPT))(params, opt, batch)
        state = {"params": params, "opt": opt}
        want = [sharding.full(x).clone() for x in leaves(state)]
        # the leaves copied to the host by this rank's save
        real_copy, copies = ckpt.numpy_copy, []
        ckpt.numpy_copy = lambda t: copies.append(t.shape) or real_copy(t)
        try:
            save(os.path.join(out_dir, "mesh"), 1, state)
        finally:
            ckpt.numpy_copy = real_copy
        if rank == 0:
            plain = init_params(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
            like = {"params": plain, "opt": init_opt_state(OptConfig(**OPT), plain)}
            got, _ = restore(os.path.join(out_dir, "mesh"), like)
            save(os.path.join(out_dir, "one"), 1, got)
        torch.distributed.barrier()
        # by the specs of a plain tree (restore's shardings), and like a
        # placed tree's leaves
        plain = init_params(cfg, generator=torch.Generator().manual_seed(3), device="cpu")
        plain = {"params": plain, "opt": init_opt_state(OptConfig(**OPT), plain)}
        placed = fresh()
        placed = {"params": placed, "opt": init_opt_state(OptConfig(**OPT), placed)}
        same = True
        for back, step in (restore(os.path.join(out_dir, "one"), plain, mesh=mesh,
                                   shardings=sharding.make_param_shardings(plain, mesh)),
                           restore(os.path.join(out_dir, "one"), placed)):
            same = same and step == 1 and all(
                sharding.is_dtensor(b) and b.placements == x.placements
                for b, x in zip(leaves(back), leaves(state)) if sharding.is_dtensor(x))
            same = same and all(torch.equal(sharding.full(b), w)
                                for b, w in zip(leaves(back), want))
        flags = [None] * world
        torch.distributed.all_gather_object(flags, (bool(same), len(copies)))
        if rank == 0:
            torch.save({"state": want, "restored_equal": [f[0] for f in flags],
                        "host_copies": [f[1] for f in flags]}, os.path.join(out_dir, "state.pt"))
    finally:
        torch.distributed.destroy_process_group()


if __name__ == "__main__":
    if sys.argv[5:] == ["ckpt"]:
        run_ckpt(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        run(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4])
