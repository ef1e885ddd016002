"""Training launcher (a port of ``repro.launch.train``).

Builds the mesh, runs the train step with gradient accumulation, heartbeats
the failure detector, records step times for the straggler tracker,
checkpoints asynchronously and resumes from the newest committed
checkpoint, in the reference's order: restore, the batch iterator from the
resumed step, then each step (train step, heartbeat and straggler record,
``plan_recovery``, a log line every 10 steps, the periodic async save and
``prune(keep=2)``), then the final save, and a line of each step's ms and
each rank's peak device memory over the run.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --steps 100 [--mesh 1x1] [--device cpu] [--seed 0] \
        [--param-dtype float32] [--ckpt-dir DIR]

It runs on the card unless ``--device cpu`` asks for the CPU; ``--seed``
seeds the random weights (a ``torch.Generator``, where the reference draws
from ``PRNGKey(0)``).  ``--reduced`` is off by default, as in the
reference: without it the full config is built.  An empty ``--ckpt-dir``
keeps no checkpoint.  ``train()`` is the loop, for callers that bring their
own parameters (``chip_smoke.py`` trains granite-3-2b whole through it).

Across devices it runs under ``torch.distributed.run``, one process a
device:

    python -m torch.distributed.run --nproc-per-node 4 -m repro_torch.launch.train \
        --reduced --device cpu --mesh 2x2 --steps 3

With ``RANK`` and ``WORLD_SIZE`` set, ``main`` joins the process group
(``nccl`` on the card, ``gloo`` with ``--device cpu``), builds the
``DeviceMesh`` of ``--mesh`` (its devices must be the group's ranks), sets
the activation axes, and places the parameters, the optimiser state and
each batch by ``train.sharding``'s specs (the reference's ``device_put``
with its shardings).  Every rank draws the same weights from ``--seed`` and
builds the global batch, as the reference's launcher does (host 0 of 1),
and keeps its shard.  The detector and the straggler tracker count the
group's ranks as hosts; rank 0 alone prints the log lines and writes the
checkpoints.  ``--mesh 1x1`` (the default) places nothing.

One departure: a checkpoint labelled ``s`` holds the state after ``s``
steps, as the reference's final save does, so a resume from it takes batch
``s`` next.  The reference's periodic saves are labelled one short (its
``step_000050`` holds 51 steps, and a resume from it takes batch 50 a second
time); the port saves after step ``s - 1`` as ``s``, every ``ckpt_every``
steps, and skips the final save where that step is saved already.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from dataclasses import dataclass, replace

import torch

from repro_torch.checkpoint.ckpt import latest_step, prune, restore, save
from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import DataConfig, ShardedBatchIterator
from repro_torch.kernels import resolve_device
from repro_torch.launch.mesh import make_mesh
from repro_torch.models.lm import init_params
from repro_torch.optim.adamw import OptConfig, OptState, init_opt_state
from repro_torch.runtime.fault import FailureDetector, StragglerTracker, plan_recovery
from repro_torch.train import sharding
from repro_torch.train.sharding import set_activation_axes
from repro_torch.train.step import make_train_step
from repro_torch.tree import leaves


def parse_mesh(s: str, device="cuda"):
    dims = tuple(int(x) for x in s.split("x"))
    axes = {1: ("data",), 2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    return make_mesh(dims, axes, device)


def _hosts() -> tuple:
    """(this host's index, the number of hosts): ``torch.distributed``'s rank
    and world size where it is initialised, else (0, 1)."""
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _gather_step_times(host: int, n_hosts: int, dt: float) -> list:
    """(host, its step seconds) of every host: across a group of more than
    one rank gathered from all of them (one small collective a step), so
    that each rank's detector hears every host; else this host's own."""
    if n_hosts == 1:
        return [(host, dt)]
    times = [None] * n_hosts
    torch.distributed.all_gather_object(times, dt)
    return list(enumerate(times))


def _timing(step_s: list, device: torch.device, n_hosts: int) -> str:
    """The log line of each step's ms and each host's peak device memory
    since its last reset (``torch.cuda.max_memory_allocated``, gathered
    from every rank of a group; not measured on the CPU)."""
    ms = ", ".join(f"{s * 1e3:.2f}" for s in step_s) or "none"
    if device.type != "cuda":
        return f"[train] timing: step ms {ms}; peak GiB not measured (cpu)"
    peaks = [torch.cuda.max_memory_allocated(device) / 2 ** 30]
    if n_hosts > 1:
        peaks = [None] * n_hosts
        torch.distributed.all_gather_object(peaks, torch.cuda.max_memory_allocated(device)
                                            / 2 ** 30)
    return f"[train] timing: step ms {ms}; peak GiB " + ", ".join(f"{p:.3f}" for p in peaks)


@dataclass
class TrainResult:
    """What ``train`` did: the final parameters and optimiser state, the
    step it resumed from (0 without a checkpoint), and for each step it ran
    its loss, its gradient norm and its seconds (host clock, from the end of
    the step before, through the step's results reaching the host)."""
    params: dict
    opt: OptState
    start: int
    losses: list
    grad_norms: list
    step_s: list


def train(cfg: ArchConfig, params: dict, opt: OptState, *, opt_cfg: OptConfig,
          data: DataConfig, steps: int, microbatches: int = 1, ckpt_dir: str | None = None,
          ckpt_every: int = 50, log=print) -> TrainResult:
    """Train ``params`` from ``opt`` up to step ``steps`` on ``data``'s
    batches, on the parameters' device.  With ``ckpt_dir`` it resumes from
    the newest committed checkpoint there, saves asynchronously every
    ``ckpt_every`` steps (keeping two) and once at the end; ``None`` keeps
    no checkpoint.  ``params`` and ``opt`` are updated in place (the
    restored ones where it resumed); ``log`` takes the reference's printed
    lines, and before the last one each step's ms and each host's peak
    device memory since its last reset (``_timing``).  Placed parameters (DTensors) take each batch placed on their
    mesh, and their checkpoints are written by rank 0 and restored onto
    their placements."""
    start = 0
    if ckpt_dir is not None:
        got, step0 = restore(ckpt_dir, {"params": params, "opt": opt})
        if got is not None:
            params, opt = got["params"], got["opt"]
            start = step0
            log(f"[train] resumed from step {start}")

    first = leaves(params)[0]
    dev = first.device
    mesh = first.device_mesh if sharding.is_dtensor(first) else None
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    host, n_hosts = _hosts()
    writes = mesh is None or host == 0
    # every host builds the global batch, as the reference's launcher does
    it = ShardedBatchIterator(data, start_step=start)
    detector = FailureDetector(n_hosts=n_hosts)
    tracker = StragglerTracker(n_hosts=n_hosts)
    losses, norms, step_s, writers = [], [], [], []

    t_last = time.perf_counter()
    try:
        for _ in range(start, steps):
            step, batch = next(it)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            if mesh is not None:
                batch = sharding.place(batch, sharding.make_batch_shardings(batch, mesh), mesh)
            params, opt, metrics = step_fn(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            losses.append(loss)
            norms.append(gnorm)
            step_s.append(dt)
            # every host's heartbeat and step time, each rank holding them all
            for h, t in _gather_step_times(host, n_hosts, dt):
                detector.heartbeat(h)
                tracker.record(h, t)
            plan = plan_recovery(detector, tracker, chips_per_host=1, model_parallel=1,
                                 latest_ckpt_step=latest_step(ckpt_dir) if ckpt_dir else None)
            if plan.action != "continue":
                log(f"[train] recovery plan: {plan}")
            if step % 10 == 0 or step == steps - 1:
                log(f"[train] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} {dt * 1e3:.0f} ms")
            if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
                writers.append(save(ckpt_dir, step + 1, {"params": params, "opt": opt},
                                    blocking=False))
                if writes:
                    prune(ckpt_dir, keep=2)
    finally:
        it.close()
        for w in writers:
            if w is not None:
                w.join()
    if mesh is not None and n_hosts > 1:
        torch.distributed.barrier()  # rank 0's periodic saves are committed
    if ckpt_dir is not None and latest_step(ckpt_dir) != steps:
        save(ckpt_dir, steps, {"params": params, "opt": opt})
    log(_timing(step_s, dev, n_hosts))
    log(f"[train] done at step {steps}")
    return TrainResult(params, opt, start, losses, norms, step_s)


def join_group(device: torch.device) -> torch.device:
    """Under ``torch.distributed.run`` (``RANK`` and ``WORLD_SIZE`` set):
    join the process group, ``nccl`` on the card (this rank's
    ``LOCAL_RANK`` card), ``gloo`` on the CPU; returns the device to run
    on."""
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(device)
        torch.distributed.init_process_group("nccl", device_id=device)
    else:
        torch.distributed.init_process_group("gloo")
    return device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", help="reduced config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"),
                    help="where to checkpoint and resume; empty: no checkpoint")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    ap.add_argument("--param-dtype", choices=("bfloat16", "float32"),
                    help="the parameters' dtype (default: the config's)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.param_dtype:
        cfg = replace(cfg, param_dtype=args.param_dtype)
    device = resolve_device(args.device)
    group = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if group:
        device = join_group(device)
    try:
        mesh = parse_mesh(args.mesh, device)
        host, n_hosts = _hosts()
        if n_hosts != sharding.mesh_size(mesh):
            raise RuntimeError(f"--mesh {args.mesh} has {sharding.mesh_size(mesh)} devices "
                               f"and the process group {n_hosts} ranks")
        set_activation_axes(mesh)
        opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                            compress_grads=args.compress_grads)
        dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
                        frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                        frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
        params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(
            args.seed), device=device)
        if sharding.is_device_mesh(mesh):
            params = sharding.place(params, sharding.make_param_shardings(params, mesh), mesh)
        opt = init_opt_state(opt_cfg, params)
        log = print if host == 0 else (lambda *a: None)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        train(cfg, params, opt, opt_cfg=opt_cfg, data=dc, steps=args.steps,
              microbatches=args.microbatches, ckpt_dir=args.ckpt_dir or None,
              ckpt_every=args.ckpt_every, log=log)
    finally:
        if group:
            torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
