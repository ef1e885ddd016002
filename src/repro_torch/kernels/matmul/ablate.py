"""Ablation of the bf16 GEMM's design choices on the card.

Builds variants of ``repro_torch/csrc/matmul.cu`` that each undo one
choice of the wgmma kernel, by a textual edit of the source, and times
them in turns with the kernel as built and ``torch.matmul`` on the
granite-3-2b layer's five GEMMs at 16384 tokens (the main path of
``chip_smoke.py``'s ``run_matmuls``), at the default tile 128x256x64:

* ``not persistent``: one CTA per output tile instead of one per SM;
* ``row raster``: tiles in plain row order instead of groups of 8 rows;
* ``no wgmma overlap``: each slab's wgmma group drained before the next
  is issued, instead of one group left in flight.

    python -m repro_torch.kernels.matmul.ablate [--rounds 30] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and the median time of each variant.  The variants
are built beside the kernels' libraries, under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

VARIANTS = {
    "not persistent": [("const int grid = tiles < sms ? tiles : sms;",
                        "const int grid = tiles;")],
    "row raster": [("constexpr int kGroupM = 8;", "constexpr int kGroupM = 1;")],
    "no wgmma overlap": [("wgmma_wait<1>();  // the slab before this one has been read",
                          "wgmma_wait<0>();")],
}
TILE = (128, 256, 64)
TOKENS = 16384


def build_variants() -> dict:
    """name -> ctypes library of each variant (and "as built"), every nvcc
    started at once."""
    from repro_torch.kernels import _build

    libs = {}
    for name, so in _build.build_variants("matmul", {"as built": [], **VARIANTS}).items():
        lib = ctypes.CDLL(str(so))
        lib.matmul_tiled_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.matmul_tiled_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.layers.shapes import attention_proj_shapes, mlp_shapes

    libs = build_variants()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    proj = attention_proj_shapes(CONFIG.d_model, CONFIG.n_heads, CONFIG.n_kv,
                                 CONFIG.resolved_head_dim)
    mlp = mlp_shapes(CONFIG.d_model, CONFIG.d_ff, CONFIG.mlp)
    gemms = []
    for (k, n), mult in ((proj["qkv"], 1), (proj["out"], 1), mlp["in"], mlp["out"]):
        a = torch.randn((TOKENS, k), device=dev, generator=gen).bfloat16()
        b = (torch.randn((k, n), device=dev, generator=gen) * k ** -0.5).bfloat16()
        gemms += [(a, b, torch.empty((TOKENS, n), device=dev, dtype=torch.bfloat16))] * mult
    stream = torch.cuda.current_stream().cuda_stream

    def layer(lib):
        def run():
            for a, b, c in gemms:
                rc = lib.matmul_tiled_launch(2, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                             a.shape[0], b.shape[1], a.shape[1], *TILE, stream)
                if rc:
                    raise RuntimeError(f"launch failed: {rc}")
        return run

    fns = {name: layer(lib) for name, lib in libs.items()}
    fns["torch.matmul"] = lambda: [torch.matmul(a, b) for a, b, _ in gemms]
    a, b, c = gemms[0]
    want = torch.matmul(a, b).float()
    for name, lib in libs.items():  # every variant still computes the product
        layer(lib)()
        if not torch.allclose(c.float(), want, rtol=1e-2, atol=1e-2):
            raise AssertionError(f"variant {name!r} disagrees with torch.matmul")
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(args.rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop))
    print(f"card: {card}")
    print(f"the layer's {len(gemms)} GEMMs at {TOKENS} tokens, tile {TILE}, in turns "
          f"({args.rounds} rounds, order reversed every other round):")
    base = statistics.median(times["as built"])
    for name in names:
        t = sorted(times[name])
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / base - 1) * 100:+.1f} % against as "
              f"built), quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
