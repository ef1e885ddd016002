"""Ablation of the wgmma flash forward's design choices on the card.

Builds variants of ``repro_torch/csrc/flash_attention.cu`` that each undo
one choice of ``flash_fwd_wgmma_kernel``, by a textual edit of the source,
and times them in turns with the kernel as built, the ``mma.sync`` kernel
at (64, 64) and ``F.scaled_dot_product_attention`` at granite-3-2b's causal
prefill (B 4 × S 4096, Hq 32, Hkv 8, D 64, bf16: the main path of
``chip_smoke.py``'s ``run_flash``), at the tile (128, 128):

* ``no ping-pong``: the two consumer warpgroups issue their GEMMs freely
  instead of taking turns on the tensor cores (named barriers);
* ``no intra-warpgroup overlap``: a block's softmax waits for the previous
  block's P·V too, instead of only for its own Q·K^T;
* ``Q from shared memory``: Q·K^T reads Q from shared memory (both
  operands there) instead of from registers loaded once a tile;
* ``correction after P V``: O is rescaled once the previous P·V is done,
  on the critical path, instead of under the next Q·K^T;
* ``3-stage ring``: three K and V stages instead of two;
* ``not persistent``: one CTA per tile instead of one per SM;

and, as timing probes whose output is wrong and not checked, the kernel
without its exponentials, without its softmax, without P·V or without
Q·K^T: the time each saves (or adds) shows how far that piece sits on
the critical path.

    python -m repro_torch.kernels.flash_attention.ablate [--rounds 30] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and the median time of each variant.  Every variant
is first held to the smoke's tolerances against the plain version on the
first batch.  The variants are built under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys

VARIANTS = {
    "no ping-pong": [("constexpr bool kPingPong = true;", "constexpr bool kPingPong = false;")],
    "no intra-warpgroup overlap": [("constexpr bool kIntraOverlap = true;",
                                    "constexpr bool kIntraOverlap = false;")],
    "Q from shared memory": [("constexpr bool kQInRegs = true;", "constexpr bool kQInRegs = false;")],
    "correction after P V": [("constexpr bool kRescaleInTurn = true;",
                              "constexpr bool kRescaleInTurn = false;")],
    "3-stage ring": [("constexpr int kFaStages = 2;", "constexpr int kFaStages = 3;")],
    "not persistent": [("const int grid = tiles < sms ? tiles : sms;", "const int grid = tiles;")],
}
# timing probes: each drops one piece of the work, so its output is wrong
# and not checked; the time saved bounds what that piece costs in the
# kernel as built
PROBES = {
    "probe: no exponentials": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                                "y = x;")],
    "probe: no softmax": [("        SOFTMAX(0);\n", "        corr[0] = corr[1] = 1.f;\n"),
                          ("          SOFTMAX(j);\n", "          corr[0] = corr[1] = 1.f;\n")],
    "probe: no P V": [("          pv_gemm<D>(o, p, sv + pst * T::kTileBytes);\n", ""),
                      ("        pv_gemm<D>(o, p, sv + lst * T::kTileBytes);\n", "")],
    "probe: no Q K^T": [("        QK(s0);\n", ""), ("          QK(st);\n", "")],
}
PREFILL = (4, 4096)
ATOL, ROW_REL = 3e-2, 2e-2  # chip_smoke.FLASH_TOL / FLASH_ROW_REL for bf16


def build_variants() -> dict:
    """name -> ctypes library of each variant (and "as built"), every nvcc
    started at once."""
    from repro_torch.kernels import _build

    libs = {}
    for name, so in _build.build_variants("flash_attention",
                                          {"as built": [], **VARIANTS, **PROBES}).items():
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd_launch.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4
                                         + [ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int,
                                                                 ctypes.c_void_p])
        lib.flash_fwd_launch.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    libs = build_variants()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    B, S = PREFILL
    q = torch.randn((B, Hq, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn((B, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream().cuda_stream

    def fwd(lib, tile):
        def run():
            rc = lib.flash_fwd_launch(2, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                      B, Hq, Hkv, S, S, D, *tile, D ** -0.5, 1, stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")
        return run

    fns = {name: fwd(lib, (128, 128)) for name, lib in libs.items()}
    fns["mma.sync (64, 64)"] = fwd(libs["as built"], (64, 64))
    fns["F.scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    want = attention_ref(q[:1], k[:1], v[:1], True).float()
    for name in fns:  # every variant still computes the attention
        if name.startswith("F.") or name in PROBES:
            continue
        fns[name]()
        torch.cuda.synchronize()
        err, rel = float((out[:1].float() - want).abs().max()), row_rel_err(out[:1], want)
        if err > ATOL or rel > ROW_REL:
            raise AssertionError(f"variant {name!r} disagrees with the plain version: max abs "
                                 f"{err}, row relative {rel}")
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
    print(f"causal prefill B {B} x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, tile (128, 128), in "
          f"turns ({args.rounds} rounds, order reversed every other round):")
    base = statistics.median(times["as built"])
    for name in names:
        t = sorted(times[name])
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / base - 1) * 100:+.1f} % against as "
              f"built), quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
