"""Where a whole model's train step spends its time on the card, and the
stacked parameters' views taken one way or the other, in turns.

    python -m repro_torch.train.ablate [--arch granite-3-2b] [--batch 8]
        [--seq 512] [--microbatches 2] [--rounds 3] [--seed 0]

Runs ``train.step.loss_and_grads`` at the full config (bf16, remat on) with
``models.lm``'s views as built (one ``unbind`` a stacked leaf, ``_unstack``)
and with a ``select`` a layer and leaf (``_index``), in turns (as built,
select, select, as built, ...), checking that the two give the same loss
and gradients bit for bit; times
``optim.adamw.apply_updates`` on the resulting fp32 gradients; then
profiles one call of each view with ``torch.profiler``: the kernels' time
by name, and the device's busy share of the call's wall time (the union
of the kernels' intervals).  Needs a card.
"""
from __future__ import annotations

import argparse
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, batch_for_step
from repro_torch.models import lm
from repro_torch.optim.adamw import OptConfig, init_opt_state, apply_updates
from repro_torch.train.step import loss_and_grads
from repro_torch.tree import leaves


def _selects(tree, n: int) -> list:
    """Layer ``i``'s views by a ``select`` a layer and leaf (``_index``)."""
    return [lm._index(tree, i) for i in range(n)]


def _timed(fn) -> tuple:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3, out


def _profile(fn, rows: int) -> list:
    """Lines: the call's wall ms, its kernels' summed ms and the device's
    busy share, then the ``rows`` kernels with the most time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in kernels)
    busy, end = 0.0, float("-inf")
    for s, e in spans:
        if e > end:
            busy += e - max(s, end)
            end = e
    by_name: dict = {}
    for e in kernels:
        t, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    total = sum(t for t, _ in by_name.values())
    out = [f"wall {wall:.1f} ms, {len(kernels)} kernels summing {total / 1e3:.1f} ms, the device "
           f"busy {busy / 1e3:.1f} ms ({busy / 1e3 / wall * 100:.1f} % of the wall)"]
    for name, (t, n) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:rows]:
        out.append(f"  {t / 1e3:9.2f} ms  x{n:6d}  {name[:120]}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--rows", type=int, default=15)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("train.ablate: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"card: {card.strip()}")
    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                            device=dev)
    dc = DataConfig(vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch,
                    frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                    frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch_for_step(dc, 0).items()}

    def call():
        return loss_and_grads(cfg, params, batch, args.microbatches)

    built = lm._unstack
    variants = {"unbind (as built)": built, "select a layer": _selects}
    _timed(call)  # cuBLAS's first calls
    ms: dict = {k: [] for k in variants}
    grads: dict = {}
    order = list(variants)
    for r in range(args.rounds):
        for name in (order if r % 2 == 0 else order[::-1]):
            lm._unstack = variants[name]
            try:
                t, (loss, g) = _timed(call)
            finally:
                lm._unstack = built
            ms[name].append(t)
            if name not in grads:
                grads[name] = (loss, g)
            del g
    (la, ga), (lb, gb) = grads.values()
    same = bool(torch.equal(la, lb)) and all(torch.equal(a, b) for a, b in
                                              zip(leaves(ga), leaves(gb), strict=True))
    print(f"{args.arch} (bf16, remat {cfg.remat}), loss_and_grads of {args.batch} x {args.seq} "
          f"in {args.microbatches} microbatches, {args.rounds} rounds in turns; the loss and "
          f"gradients of the two equal bit for bit: {same}")
    for name, t in ms.items():
        runs = ", ".join(f"{x:.1f}" for x in t)
        print(f"  {name}: median {statistics.median(t):.1f} ms ({runs})")
    del grads, gb

    opt_cfg = OptConfig(lr=1e-3, warmup_steps=20, total_steps=10)
    opt = init_opt_state(opt_cfg, params)
    upd = [_timed(lambda: apply_updates(opt_cfg, opt, params, ga))[0] for _ in range(3)]
    print(f"apply_updates on {sum(t.numel() for t in leaves(params)) / 1e9:.4f} B parameters "
          f"with fp32 gradients: {', '.join(f'{x:.1f}' for x in upd)} ms")
    del opt, ga
    torch.cuda.empty_cache()

    for name, fn in variants.items():
        lm._unstack = fn
        try:
            lines = _profile(call, args.rows)
        finally:
            lm._unstack = built
        print(f"profile, {name}: " + "\n".join(lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
