"""Ablation of the GEMM kernels' design choices on the card.

Builds variants of ``repro_torch/csrc/matmul.cu`` that each undo one
choice, by a textual edit of the source, and times them in turns with the
kernel as built and ``torch.matmul``.

``--part bf16`` (the default): the wgmma kernel on the granite-3-2b
layer's five GEMMs at 16384 tokens (the main path of ``chip_smoke.py``'s
``run_matmuls``), at the default tile 128x256x64:

* ``not persistent``: one CTA per output tile instead of one per SM;
* ``row raster``: tiles in plain row order instead of groups of 8 rows;
* ``no wgmma overlap``: each slab's wgmma group drained before the next
  is issued, instead of one group left in flight.

``--part fp32``: the split-TF32 kernel on the layer's out GEMM
(16384 x 2048 x 2048), operands drawn in fp32, B split once beforehand,
at each instantiated tile and, at the default tile 128x128x32:

* ``one pass``: hi * B_hi alone (wrong numbers: a probe of the tensor
  cores' TF32 rate);
* ``not persistent``: as above;
* ``2 stages``: a 2-stage TMA ring instead of as many as fit;
* ``no slab sums``: the three passes summed straight into the tile's
  accumulator, without a second accumulator per slab;
* ``CUDA cores``: the fp32 CUDA-core kernel the split route replaced.

Each variant's error against an fp64 product (RMS and max abs) is printed
beside ``torch.matmul``'s with TF32 off and on, and every variant but the
one-pass probe is held to the smoke's fp32 tolerance.

    python -m repro_torch.kernels.matmul.ablate [--part bf16|fp32] [--rounds 30] [--seed 0]

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
    "not persistent": [("grid = tiles < sms ? tiles : sms;", "grid = tiles;")],
    "row raster": [("constexpr int kGroupM = 8;", "constexpr int kGroupM = 1;")],
    "no wgmma overlap": [("wgmma_wait<1>();  // the slab before this one has been read",
                          "wgmma_wait<0>();")],
}
F32_VARIANTS = {
    "one pass": [("constexpr int kPasses = 3;", "constexpr int kPasses = 1;")],
    "not persistent": VARIANTS["not persistent"],
    "2 stages": [("static constexpr int kStages = kFitStages;",
                  "static constexpr int kStages = 2;")],
    "no slab sums": [("constexpr bool kPromote = true;", "constexpr bool kPromote = false;")],
}
TILE = (128, 256, 64)
CUDA_CORE_TILE = (128, 128, 16)  # the fp32 CUDA-core kernel's one tile (matmul_tiled_launch)
TOKENS = 16384
F32_TOL = dict(rtol=1e-4, atol=8e-4)  # chip_smoke.py's GEMM_TOL[4]


def build_variants(variants: dict) -> dict:
    """name -> ctypes library of each variant (and "as built"), every nvcc
    started at once."""
    from repro_torch.kernels import _build

    libs = {}
    for name, so in _build.build_variants("matmul", {"as built": [], **variants}).items():
        lib = ctypes.CDLL(str(so))
        lib.matmul_tiled_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 3
                                            + [ctypes.c_int] * 6 + [ctypes.c_void_p])
        lib.matmul_tiled_launch.restype = ctypes.c_int
        lib.matmul_split_b_launch.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [
            ctypes.c_void_p]
        lib.matmul_split_b_launch.restype = ctypes.c_int
        lib.matmul_split_tf32_launch.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                                                 + [ctypes.c_void_p])
        lib.matmul_split_tf32_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def in_turns(torch, fns: dict, rounds: int) -> dict:
    """name -> sorted event times (ms) of each function, one run of each per
    round, the order reversed every other round."""
    names = list(fns)
    for name in names:
        fns[name]()
    torch.cuda.synchronize()
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            fns[name]()
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop))
    return {name: sorted(t) for name, t in times.items()}


def report(times: dict, base: str) -> None:
    ref = statistics.median(times[base])
    for name, t in times.items():
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} % against {base}), "
              f"quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms")


def checked(rc: int) -> None:
    if rc:
        raise RuntimeError(f"launch failed: {rc}")


def run_bf16(args, torch, card: str) -> None:
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.layers.shapes import attention_proj_shapes, mlp_shapes

    libs = build_variants(VARIANTS)
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
                checked(lib.matmul_tiled_launch(2, a.data_ptr(), b.data_ptr(), c.data_ptr(),
                                                a.shape[0], b.shape[1], a.shape[1], *TILE, stream))
        return run

    fns = {name: layer(lib) for name, lib in libs.items()}
    fns["torch.matmul"] = lambda: [torch.matmul(a, b) for a, b, _ in gemms]
    a, b, c = gemms[0]
    want = torch.matmul(a, b).float()
    for name, lib in libs.items():  # every variant still computes the product
        layer(lib)()
        if not torch.allclose(c.float(), want, rtol=1e-2, atol=1e-2):
            raise AssertionError(f"variant {name!r} disagrees with torch.matmul")
    times = in_turns(torch, fns, args.rounds)
    print(f"card: {card}")
    print(f"the layer's {len(gemms)} GEMMs at {TOKENS} tokens, tile {TILE}, in turns "
          f"({args.rounds} rounds, order reversed every other round):")
    report(times, "as built")


def run_fp32(args, torch, card: str) -> None:
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.matmul.kernel import TILES
    from repro_torch.layers.shapes import attention_proj_shapes

    libs = build_variants(F32_VARIANTS)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    k, n = attention_proj_shapes(CONFIG.d_model, CONFIG.n_heads, CONFIG.n_kv,
                                 CONFIG.resolved_head_dim)["out"]
    a = torch.randn((TOKENS, k), device=dev, generator=gen)
    b = torch.randn((k, n), device=dev, generator=gen) * k ** -0.5
    M, K, N = TOKENS, k, n
    hi, lo = torch.empty((N, K), device=dev), torch.empty((N, K), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    base = libs["as built"]
    split = lambda: checked(base.matmul_split_b_launch(b.data_ptr(), hi.data_ptr(), lo.data_ptr(),
                                                       K, N, stream))
    split()

    def gemm(lib, tile, out):
        return lambda: checked(lib.matmul_split_tf32_launch(
            a.data_ptr(), hi.data_ptr(), lo.data_ptr(), out.data_ptr(), M, N, K, *tile, stream))

    outs, fns = {}, {}
    for tile in TILES[4]:
        name = "as built" if tile == TILES[4][0] else f"as built {'x'.join(map(str, tile))}"
        outs[name] = torch.empty((M, N), device=dev)
        fns[name] = gemm(base, tile, outs[name])
    for name in F32_VARIANTS:
        outs[name] = torch.empty((M, N), device=dev)
        fns[name] = gemm(libs[name], TILES[4][0], outs[name])
    outs["CUDA cores"] = torch.empty((M, N), device=dev)
    fns["CUDA cores"] = lambda: checked(base.matmul_tiled_launch(
        4, a.data_ptr(), b.data_ptr(), outs["CUDA cores"].data_ptr(), M, N, K, *CUDA_CORE_TILE,
        stream))
    fns["torch.matmul"] = lambda: torch.matmul(a, b)

    def tf32_matmul():
        torch.backends.cuda.matmul.allow_tf32 = True
        try:
            return torch.matmul(a, b)
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    fns["torch.matmul TF32 (one pass, context)"] = tf32_matmul
    for name, out in outs.items():
        fns[name]()
    outs["torch.matmul"] = torch.matmul(a, b)
    outs["torch.matmul TF32 (one pass, context)"] = tf32_matmul()
    torch.cuda.synchronize()
    exact = a.double() @ b.double()
    errs = {}
    for name, out in outs.items():
        d = out.double() - exact
        errs[name] = (float(d.pow(2).mean().sqrt()), float(d.abs().max()))
        if name not in ("one pass", "torch.matmul TF32 (one pass, context)") and \
                not torch.allclose(out, outs["torch.matmul"], **F32_TOL):
            raise AssertionError(f"variant {name!r} disagrees with torch.matmul beyond {F32_TOL}")
    del exact
    split_t = in_turns(torch, {"split": split}, args.rounds)["split"]
    times = in_turns(torch, fns, args.rounds)
    rms0, max0 = errs["torch.matmul"]
    print(f"card: {card}")
    print(f"fp32 out GEMM {M}x{K}x{N}, operands drawn in fp32, B split beforehand (the split "
          f"pass alone: median {statistics.median(split_t):.4f} ms); error against an fp64 "
          f"product, RMS and max abs (x torch.matmul's with TF32 off):")
    for name, (rms, mx) in errs.items():
        print(f"  {name}: RMS {rms!r} ({rms / rms0:.3f}x), max abs {mx!r} ({mx / max0:.3f}x)")
    print(f"in turns ({args.rounds} rounds, order reversed every other round), the GEMM alone:")
    report(times, "as built")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("bf16", "fp32"), default="bf16")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    (run_bf16 if args.part == "bf16" else run_fp32)(args, torch, card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
