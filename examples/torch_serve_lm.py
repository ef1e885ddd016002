"""Serving through the port: batched prefill + decode with KV caches.

The port of ``examples/serve_lm.py``.  Demonstrates the serving substrate
across architecture families: full attention (granite), sliding-window +
MoE (mixtral), attention-free (rwkv6), and the int8 KV-cache option.
Greedy-decodes a batch of synthetic prompts with random weights
(``repro_torch.models.lm.init_params``, seeded by ``--seed``) at the
reduced config.

Run:  PYTHONPATH=src python examples/torch_serve_lm.py [--arch mixtral-8x7b]
      [--kv-int8] [--device cpu]

The model runs on the card; the CPU runs it only when asked with
``--device cpu`` (``main(["--device", "cpu"])``).  Without a card and
without it, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.kernels import resolve_device
from repro_torch.models.lm import init_params
from repro_torch.train.step import make_decode_step, make_prefill_step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mixtral-8x7b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen-len", type=int, default=16)
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0, help="seed of the random weights")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch).reduced()
    if args.kv_int8:
        cfg = dataclasses.replace(cfg, kv_int8=True)
    device = resolve_device(args.device)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=device)
    B, S = args.batch, args.prompt_len
    # a vision arch's patches take cache slots too (the reference leaves them out)
    patches = cfg.frontend_tokens if cfg.frontend == "vision" else 0
    capacity = patches + S + args.gen_len + 8

    # the reference's keys 1 (prompts) and 2 (frontend), as CPU generators
    prompts = torch.randint(0, cfg.vocab, (B, S),
                            generator=torch.Generator().manual_seed(1)).to(device)
    frontend = (
        torch.randn((B, cfg.frontend_tokens, cfg.frontend_dim),
                    generator=torch.Generator().manual_seed(2)).to(device)
        if cfg.frontend else None
    )

    prefill = make_prefill_step(cfg, capacity)
    decode = make_decode_step(cfg)

    with torch.inference_mode():
        t0 = time.time()
        logits, caches, enc = prefill(params, prompts, frontend)
        tok = logits.argmax(-1)[:, None].to(torch.int32)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        print(f"prefill {B}x{S} in {time.time()-t0:.2f}s "
              f"(kv_int8={cfg.kv_int8})")

        pos0 = S + patches
        generated = [tok]
        t0 = time.time()
        for i in range(args.gen_len - 1):
            positions = torch.full((B, 1), pos0 + i, dtype=torch.int32, device=device)
            logits, caches = decode(params, tok, caches, positions, enc)
            tok = logits.argmax(-1)[:, None].to(torch.int32)
            generated.append(tok)
        out = torch.cat(generated, dim=1).tolist()
        dt = time.time() - t0
    print(f"decoded {args.gen_len} tokens/seq in {dt:.2f}s "
          f"({B*args.gen_len/dt:.1f} tok/s batch throughput)")
    for b in range(min(B, 2)):
        print(f"  seq{b}: {out[b]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
