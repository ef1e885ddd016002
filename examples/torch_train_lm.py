"""Training through the port: train a reduced LM for a few hundred steps.

The port of ``examples/train_lm.py``.  Exercises the training substrate:
the synthetic data pipeline, the train step with gradient accumulation
(``--microbatches``), AdamW, asynchronous checkpoints with auto-resume, and
the failure and straggler hooks, through ``repro_torch.launch.train.train``
at the reduced config of the selected arch, with random weights seeded by
``--seed``.  Run it again with the same ``--ckpt-dir`` and it resumes from
the newest committed checkpoint.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--arch granite-3-2b]
      [--steps 300] [--ckpt-dir DIR] [--device cpu]

The model runs on the card; the CPU runs it only when asked with
``--device cpu`` (``main(["--device", "cpu"])``).  Without a card and
without it, the script fails.
"""
from __future__ import annotations

import argparse
import os
import sys
import tempfile

import torch

from repro_torch.checkpoint.ckpt import latest_step
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.kernels import resolve_device
from repro_torch.launch.train import train
from repro_torch.models.lm import init_params
from repro_torch.optim.adamw import OptConfig, init_opt_state


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    device = resolve_device(args.device)
    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=args.steps)
    dc = DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8,
                    frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                    frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
    params = init_params(cfg, generator=torch.Generator(device=device).manual_seed(args.seed),
                         device=device)
    opt = init_opt_state(opt_cfg, params)
    train(cfg, params, opt, opt_cfg=opt_cfg, data=dc, steps=args.steps,
          microbatches=args.microbatches, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    print(f"done; final checkpoint at step {latest_step(args.ckpt_dir)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
