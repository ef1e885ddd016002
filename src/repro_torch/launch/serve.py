"""Serving launcher: a continuous batched prefill + decode loop (a port of
``repro.launch.serve``).

Maintains a decode batch of independent requests with per-slot positions;
finished slots are refilled from the (synthetic) request queue — a compact
continuous-batching scheduler over the framework's cache machinery.  As in
the reference, a wave's batch is static: a short last wave is padded with
repeats of its own requests, the decode positions of a vision arch start
after its patches, and decoding is greedy (``argmax``: the first maximum on
a tie, as ``jnp.argmax``).  Request ``r``'s prompt is drawn from a
``torch.Generator`` seeded ``100 + r`` (on the CPU, so it does not depend
on the device), where the reference seeds ``PRNGKey(100 + r)``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --reduced \
        --requests 8 [--kv-int8] [--device cpu] [--seed 0]

The model runs on the card unless ``--device cpu`` asks for the CPU.
``--reduced`` is ``store_true`` with ``default=True``, as in the reference:
it cannot be turned off from the command line, so the command always
serves the reduced config.  A full-width model is served by calling
``serve()`` with the full config, as ``chip_smoke.py`` does.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from dataclasses import dataclass, field

import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.train.step import make_decode_step, make_prefill_step


@dataclass
class Wave:
    """One wave of the loop: its requests, padded with repeats to the batch
    (``ids``), their prompts (B, S) and greedy tokens (B, gen_len); with
    ``keep_logits``, the prefill's last logits (B, V) and each decode
    step's (B, V), fp32."""
    ids: list
    prompts: torch.Tensor
    tokens: torch.Tensor
    prefill_logits: torch.Tensor | None = None
    decode_logits: list = field(default_factory=list)


@dataclass
class ServeResult:
    """What ``serve`` did: each request's generated tokens, the seconds of
    each wave's prefill and of each decode step (in order, every wave's),
    the loop's total seconds, and its waves."""
    outputs: dict
    prefill_s: list
    decode_s: list
    total_s: float
    waves: list


def request_prompt(cfg: ArchConfig, r: int, prompt_len: int) -> torch.Tensor:
    """Request ``r``'s prompt: ``prompt_len`` tokens in [0, vocab), int64 on
    the CPU, from a generator seeded ``100 + r``."""
    g = torch.Generator().manual_seed(100 + r)
    return torch.randint(0, cfg.vocab, (prompt_len,), generator=g)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def serve(cfg: ArchConfig, params: dict, *, batch: int, requests: int, prompt_len: int,
          gen_len: int, generator: torch.Generator, device="cuda", keep_logits: bool = False,
          log=print) -> ServeResult:
    """Answer ``requests`` synthetic requests in waves of ``batch``: a prefill
    of each wave's prompts into fresh caches of ``prompt_len + gen_len + 8``
    slots (and a vision arch's patches: the reference leaves them out, and
    its prefill then writes more tokens than the full cache has slots),
    then ``gen_len - 1`` greedy decode steps, under
    ``torch.inference_mode()``.  A frontend arch's embeddings are drawn once
    from ``generator`` (the same for every wave, as the reference's fixed
    key gives).  Each timed step runs to the card's finishing it (a
    synchronize), so no step's work hides under the next one's launches.
    ``log`` takes the reference's printed lines."""
    device = resolve_device(device)
    B, S = batch, prompt_len
    patches = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    capacity = patches + S + gen_len + 8
    prefill = make_prefill_step(cfg, capacity)
    decode = make_decode_step(cfg)
    frontend = None
    if cfg.frontend:
        frontend = torch.randn((B, cfg.frontend_tokens, cfg.frontend_dim), generator=generator,
                               device=generator.device).to(device)

    pending = list(range(requests))
    done = 0
    outputs: dict = {}
    prefill_s, decode_s, waves = [], [], []
    t0 = time.perf_counter()
    with torch.inference_mode():
        while pending or done < requests:
            # assemble a wave of up to B requests (static batch: pad with repeats)
            wave = pending[:B]
            pending = pending[B:]
            if not wave:
                break
            ids = (wave + wave * B)[:B]
            prompts = torch.stack([request_prompt(cfg, r, S) for r in ids]).to(device)
            _sync(device)
            t = time.perf_counter()
            logits, caches, enc = prefill(params, prompts, frontend)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            _sync(device)
            prefill_s.append(time.perf_counter() - t)
            record = Wave(ids, prompts, tok, logits if keep_logits else None)
            pos0 = S + patches
            gen = [tok]
            for i in range(gen_len - 1):
                t = time.perf_counter()
                positions = torch.full((B, 1), pos0 + i, dtype=torch.int32, device=device)
                logits, caches = decode(params, tok, caches, positions, enc)
                tok = logits.argmax(-1)[:, None].to(torch.int32)
                _sync(device)
                decode_s.append(time.perf_counter() - t)
                if keep_logits:
                    record.decode_logits.append(logits)
                gen.append(tok)
            record.tokens = torch.cat(gen, dim=1)
            waves.append(record)
            out = record.tokens.tolist()
            for j, r in enumerate(wave):
                outputs[r] = out[j]
                done += 1
            log(f"[serve] wave of {len(wave)} done ({done}/{requests})")
    dt = time.perf_counter() - t0
    log(f"[serve] {done} requests, {done * gen_len / dt:.1f} tok/s, kv_int8={cfg.kv_int8}")
    log(f"[serve] sample output req0: {outputs.get(0)}")
    return ServeResult(outputs, prefill_s, decode_s, dt, waves)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--reduced", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=24)
    ap.add_argument("--gen-len", type=int, default=12)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_int8=True)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=device)
    serve(cfg, params, batch=args.batch, requests=args.requests, prompt_len=args.prompt_len,
          gen_len=args.gen_len, generator=gen, device=device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
