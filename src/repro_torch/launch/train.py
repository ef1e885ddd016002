"""Training launcher (a port of ``repro.launch.train``).

Builds the mesh, runs the train step with gradient accumulation, heartbeats
the failure detector, records step times for the straggler tracker,
checkpoints asynchronously and resumes from the newest committed
checkpoint, in the reference's order: restore, the batch iterator from the
resumed step, then each step (train step, heartbeat and straggler record,
``plan_recovery``, a log line every 10 steps, the periodic async save and
``prune(keep=2)``), then the final save.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --reduced --steps 100 [--mesh 1x1] [--device cpu] [--seed 0]

It runs on the card unless ``--device cpu`` asks for the CPU; ``--seed``
seeds the random weights (a ``torch.Generator``, where the reference draws
from ``PRNGKey(0)``).  ``--reduced`` is off by default, as in the
reference: without it the full config is built.  ``train()`` is the loop,
for callers that bring their own parameters (``chip_smoke.py`` trains
granite-3-2b whole through it).

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
from dataclasses import dataclass

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
    lines."""
    start = 0
    if ckpt_dir is not None:
        got, step0 = restore(ckpt_dir, {"params": params, "opt": opt})
        if got is not None:
            params, opt = got["params"], got["opt"]
            start = step0
            log(f"[train] resumed from step {start}")

    dev = leaves(params)[0].device
    step_fn = make_train_step(cfg, opt_cfg, microbatches=microbatches)
    host, n_hosts = _hosts()
    it = ShardedBatchIterator(data, host=host, n_hosts=n_hosts, start_step=start)
    detector = FailureDetector(n_hosts=n_hosts)
    tracker = StragglerTracker(n_hosts=n_hosts)
    losses, norms, step_s, writers = [], [], [], []

    t_last = time.perf_counter()
    try:
        for _ in range(start, steps):
            step, batch = next(it)
            batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
            params, opt, metrics = step_fn(params, opt, batch)
            loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
            dt = time.perf_counter() - t_last
            t_last = time.perf_counter()
            losses.append(loss)
            norms.append(gnorm)
            step_s.append(dt)
            detector.heartbeat(host)
            tracker.record(host, dt)
            plan = plan_recovery(detector, tracker, chips_per_host=1, model_parallel=1,
                                 latest_ckpt_step=latest_step(ckpt_dir) if ckpt_dir else None)
            if plan.action != "continue":
                log(f"[train] recovery plan: {plan}")
            if step % 10 == 0 or step == steps - 1:
                log(f"[train] step {step:5d} loss {loss:.4f} gnorm {gnorm:.3f} {dt * 1e3:.0f} ms")
            if ckpt_dir is not None and (step + 1) % ckpt_every == 0:
                writers.append(save(ckpt_dir, step + 1, {"params": params, "opt": opt},
                                    blocking=False))
                prune(ckpt_dir, keep=2)
    finally:
        it.close()
        for w in writers:
            w.join()
    if ckpt_dir is not None and latest_step(ckpt_dir) != steps:
        save(ckpt_dir, steps, {"params": params, "opt": opt})
    log(f"[train] done at step {steps}")
    return TrainResult(params, opt, start, losses, norms, step_s)


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
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    device = resolve_device(args.device)
    set_activation_axes(parse_mesh(args.mesh, device))
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps,
                        compress_grads=args.compress_grads)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq_len, global_batch=args.global_batch,
                    frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                    frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    opt = init_opt_state(opt_cfg, params)
    train(cfg, params, opt, opt_cfg=opt_cfg, data=dc, steps=args.steps,
          microbatches=args.microbatches, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    return 0


if __name__ == "__main__":
    sys.exit(main())
