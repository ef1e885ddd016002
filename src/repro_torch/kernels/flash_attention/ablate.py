"""Ablation of the flash kernels' design choices on the card.

Builds variants of ``repro_torch/csrc/flash_attention.cu`` that each undo
one design choice, by a textual edit of the source, and times them in
turns with the kernel as built and ``F.scaled_dot_product_attention``.

The forward (``--part fwd``), ``flash_fwd_wgmma_kernel`` at granite-3-2b's
causal prefill (B 4 × S 4096, Hq 32, Hkv 8, D 64, bf16: the main path of
``chip_smoke.py``'s ``run_flash``), at the tile (128, 128), beside the
``mma.sync`` kernel at (64, 64):

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

The decode (``--part decode``), ``flash_decode_tma_kernel`` at
granite-3-2b's ``decode_32k`` (B 128, a 32768-token cache, bf16: the
decode main path of ``run_flash``) and at B 8 on the same cache's first 8
sequences (split-KV):

* ``decode: 3 stages``: K and V rings of 3 blocks instead of 6 at D 64;
* ``decode: 2 stages, 2 consumer warps``: rings of 2 blocks, which three
  warps cannot share (each stage serves one warp), so two warps;
* ``decode: one consumer warp``: one warp takes every block;
* ``decode: p rounded to bf16 once``: P·V on bf16(p) alone, without the
  low part (its row error against the fp32 plain version is printed);
* ``decode: not persistent``: one CTA per unit instead of one per SM;
* ``decode: CUDA-core kernel``: the route forced to ``"cuda_cores"``,
  ``flash_decode_core_kernel`` on bf16 at D 64, with no split;
* at B 8 only, the kernel as built with its splits forced to 1, 2, 4, 8
  and 16 (each but ``kernel.decode_splits``'s choice);

and the probes ``loads only`` (the producer's ring with consumers that
only release the stages: the ring's own ceiling) and ``no softmax``.
Then the CUDA-core kernel on the same cache's first 8 sequences in fp32,
and in bf16 at head dim 32 (``run_core_decode``'s two cases), as built
(its split count from ``kernel.decode_splits``) against

* ``decode core: 3 consumer warps`` and ``decode core: one consumer
  warp``, instead of 6 where the ring's stages allow;
* ``decode core: not persistent``: one CTA per unit instead of one per SM;
* its splits forced to 1, 2 and 4 (each but the chosen count);
* ``old kernel``, with ``--base`` (a checkout of the commit before the
  redesign, e.g. ``git archive 8a5a615`` unpacked): the previous
  CUDA-core kernel from there, one CTA per (b, KV head) at bk 512;
* the library call, ``F.scaled_dot_product_attention`` in fp32 under
  the math backend, the only one that takes fp32 with ``enable_gqa``.

    python -m repro_torch.kernels.flash_attention.ablate [--part all|fwd|decode] [--base DIR] [--rounds 30] [--seed 0]

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and the median time of each variant.  Every variant
is first held to the smoke's tolerances against the plain version (the
forward on the first batch, the decode on batches 0-15, fp32 on batches
0-7).  The variants are built under ``repro_torch/.build/ablate``.
"""
from __future__ import annotations

import argparse
import ctypes
import statistics
import subprocess
import sys
from pathlib import Path

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
_DEC_SOFTMAX = ("      dec_softmax<ROWS>(s, m, l, corr, c, kb * kDecBlock, Skv);\n",
                "      corr[0] = corr[1] = 1.f;\n")
DECODE_VARIANTS = {
    "decode: 3 stages": [("constexpr int kDecStagesD64 = 6;", "constexpr int kDecStagesD64 = 3;")],
    "decode: 2 stages, 2 consumer warps": [
        ("constexpr int kDecStagesD64 = 6;", "constexpr int kDecStagesD64 = 2;"),
        ("constexpr int kDecConsumers = 3;", "constexpr int kDecConsumers = 2;"),
        ("constexpr int kDecStagesD128 = 3;", "constexpr int kDecStagesD128 = 2;")],
    "decode: one consumer warp": [("constexpr int kDecConsumers = 3;",
                                   "constexpr int kDecConsumers = 1;")],
    "decode: p rounded to bf16 once": [("constexpr int kDecPSplit = 1;",
                                        "constexpr int kDecPSplit = 0;")],
    "decode: not persistent": [("const int grid = units < sms ? units : sms;",
                                "const int grid = units;")],
    "decode: CUDA-core kernel": [  # the route, and the bf16 instantiations it needs back
        ("  if (elem_bytes == 2 && (D == 64 || D == 128)) return kRouteTmaMma;\n", ""),
        ("      if (elem_bytes == 2) DEC(bf16, 32);\n",
         "      if (elem_bytes == 2 && D == 32) DEC(bf16, 32);\n"
         "      if (elem_bytes == 2 && D == 64) DEC(bf16, 64);\n"
         "      if (elem_bytes == 2) break;\n")],
}
CORE_VARIANTS = {
    "decode core: 3 consumer warps": [("constexpr int kCoreMaxConsumers = 6;",
                                       "constexpr int kCoreMaxConsumers = 3;")],
    "decode core: one consumer warp": [("constexpr int kCoreMaxConsumers = 6;",
                                        "constexpr int kCoreMaxConsumers = 1;")],
    "decode core: not persistent": [("const int ctas = units < sms ? units : sms;",
                              "const int ctas = units;")],
}
OLD = "old kernel"
CORE_FORCED_SPLITS = (1, 2, 4)        # at B 8 in fp32, beside decode_splits's choice
ATOL32, ROW_REL32 = 2e-3, 1e-4        # chip_smoke.FLASH_TOL / FLASH_ROW_REL for fp32
DECODE_PROBES = {
    "decode probe: loads only": [("      dec_qk<D>(s, qf, sk + st * T::kTileBytes);\n", ""),
                                 _DEC_SOFTMAX,
                                 ("      dec_pv<D, ROWS>(o, s, sv + st * T::kTileBytes);\n", "")],
    "decode probe: no softmax": [_DEC_SOFTMAX],
}
DECODE_FORCED_SPLITS = (1, 2, 4, 8, 16)  # at B 8, beside decode_splits's choice
DECODE_OLD_BK = 512                   # the CUDA-core kernel's block at the model's cache
DECODE_SMALL_B = 8
DECODE_SLICE = 16                     # batches of the decode's check
QUEUED_CALLS = 10                     # calls back to back in a queued run
PREFILL = (4, 4096)
ATOL, ROW_REL = 3e-2, 2e-2  # chip_smoke.FLASH_TOL / FLASH_ROW_REL for bf16


def variant_edits(part: str = "all") -> dict:
    """name -> textual edits of each variant and probe of ``part`` ("fwd",
    "decode" or "all"), and "as built" (no edit)."""
    edits = {"as built": []}
    if part in ("all", "fwd"):
        edits.update({**VARIANTS, **PROBES})
    if part in ("all", "decode"):
        edits.update({**DECODE_VARIANTS, **DECODE_PROBES, **CORE_VARIANTS})
    return edits


def old_source(base: Path) -> Path:
    """The previous ``flash_attention.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo, ValueError
    when it does not hold the previous CUDA-core decode."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    if "flash_decode_kernel(const T* __restrict__ Q" not in path.read_text():
        raise ValueError(f"{path} does not hold the previous CUDA-core decode "
                         f"(flash_decode_kernel)")
    return path


def build_variants(part: str = "all", base: Path | None = None) -> dict:
    """name -> ctypes library of each variant of ``part`` and "as built",
    and with a ``base`` checkout the old kernel, every nvcc started at
    once."""
    from repro_torch.kernels import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    paths = _build.build_variants("flash_attention", variant_edits(part))
    if base is not None and part in ("all", "decode"):
        paths[OLD] = _build.build_variants("flash_attention", {OLD: []}, old_source(base))[OLD]
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        lib.flash_fwd_launch.argtypes = [I] + [P] * 4 + [I] * 8 + [F, I, P]
        # the old kernel's launcher took the block bk, its combine wrote bf16
        # only and took no output width
        lib.flash_decode_launch.argtypes = [I] + [P] * 5 + [I] * (7 if name == OLD else 6) + [F, P]
        lib.flash_decode_combine_launch.argtypes = [P, P, I, I, I] + ([] if name == OLD else [I]) + [P]
        for fn in (lib.flash_fwd_launch, lib.flash_decode_launch, lib.flash_decode_combine_launch):
            fn.restype = I
        libs[name] = lib
    return libs


def in_turns(torch, fns: dict, rounds: int, calls: int = 1) -> dict:
    """name -> sorted CUDA-event times of each of ``fns``, one run each a
    round, the order reversed every other round; a run is ``calls`` calls
    back to back (the time divided by ``calls``), which leaves the host's
    launch overhead out of it when ``calls`` > 1."""
    names = list(fns)
    times = {name: [] for name in names}
    for r in range(rounds):
        for name in names if r % 2 == 0 else names[::-1]:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(calls):
                fns[name]()
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop) / calls)
    return {name: sorted(t) for name, t in times.items()}


def report(times: dict, base: str) -> None:
    ref = statistics.median(times[base])
    for name, t in times.items():
        med = statistics.median(t)
        print(f"  {name}: median {med:.4f} ms ({(med / ref - 1) * 100:+.1f} % against {base}), "
              f"quartiles {t[len(t) // 4]:.4f}-{t[3 * len(t) // 4]:.4f} ms", flush=True)


def ablate_fwd(torch, libs: dict, rounds: int, gen, dev) -> None:
    import torch.nn.functional as F

    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

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

    names = ["as built", *VARIANTS, *PROBES]
    fns = {name: fwd(libs[name], (128, 128)) for name in names}
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
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = in_turns(torch, fns, rounds)
    print(f"causal prefill B {B} x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, tile (128, 128), in "
          f"turns ({rounds} rounds, order reversed every other round):")
    report(times, "as built")


def ablate_decode(torch, libs: dict, rounds: int, gen, dev) -> None:
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    shape = SHAPES["decode_32k"]
    B, Skv = shape.global_batch, shape.seq_len
    q = torch.randn((B, Hq, 1, D), device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen, dtype=torch.bfloat16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    bound_bytes = lambda b: 2 * b * Hkv * Skv * D * 2 / 3.35e12 * 1e3  # noqa: E731

    for b in (B, DECODE_SMALL_B):
        qb, kb, vb = q[:b], k[:b], v[:b]
        chosen = FK.decode_splits(b, Hkv, 1, Skv, sms)
        outs = {}

        def dec(lib, splits, name):
            out = torch.empty_like(qb)
            part = (torch.empty((b, Hq, splits, D + 2), device=dev, dtype=torch.float32)
                    if splits > 1 else None)
            outs[name] = out

            def run():
                rc = lib.flash_decode_launch(2, qb.data_ptr(), kb.data_ptr(), vb.data_ptr(),
                                             out.data_ptr(), None if part is None else part.data_ptr(),
                                             b, Hq, Hkv, Skv, D, splits, D ** -0.5, stream)
                if rc == 0 and part is not None:
                    rc = lib.flash_decode_combine_launch(part.data_ptr(), out.data_ptr(), b * Hq, D,
                                                         splits, 2, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed: {rc}")
            return run

        fns = {"as built": dec(libs["as built"], chosen, "as built")}
        for name in (*DECODE_VARIANTS, *DECODE_PROBES):
            splits = 1 if name == "decode: CUDA-core kernel" else chosen
            fns[name] = dec(libs[name], splits, name)
        if b == DECODE_SMALL_B:
            for n in DECODE_FORCED_SPLITS:
                if n != chosen:
                    fns[f"splits {n}"] = dec(libs["as built"], n, f"splits {n}")
        fns["F.scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
            qb, kb, vb, enable_gqa=True)
        for fn in fns.values():
            fn()
        torch.cuda.synchronize()
        n = min(b, DECODE_SLICE)
        want32 = attention_ref(qb[:n].float(), kb[:n].float(), vb[:n].float(), False)
        want = want32.bfloat16()
        errs = []
        for name, out in outs.items():
            if name in DECODE_PROBES:
                continue
            err, rel = float((out[:n].float() - want.float()).abs().max()), row_rel_err(out[:n], want)
            if err > ATOL or rel > ROW_REL:
                raise AssertionError(f"B {b} variant {name!r} disagrees with the plain version: "
                                     f"max abs {err}, row relative {rel}")
            errs.append(f"{name} {rel:.3e}")
        print(f"decode B {b} x {Skv}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16: row relative error on batches "
              f"0-{n - 1} against the fp32 plain version: {row_rel_err(want, want32):.3e} (its own "
              f"bf16 rounding); " + "; ".join(
                  f"{name} {row_rel_err(outs[name][:n], want32):.3e}" for name in outs
                  if name not in DECODE_PROBES), flush=True)
        del want, want32
        for calls, n_rounds in ((1, rounds), (QUEUED_CALLS, max(1, rounds // 3))):
            times = in_turns(torch, fns, n_rounds, calls)
            print(f"decode B {b} x {Skv}, splits chosen {chosen} on {sms} SMs, byte bound "
                  f"{bound_bytes(b):.4f} ms, in turns ({n_rounds} rounds, order reversed every "
                  f"other round), {calls} call(s) back to back a run:")
            report(times, "as built")
    del q, k, v
    torch.cuda.empty_cache()
    ablate_decode_f32(torch, libs, rounds, gen, dev)


def ablate_decode_f32(torch, libs: dict, rounds: int, gen, dev) -> None:
    """The CUDA-core decode at B 8 of ``decode_32k``'s cache, in fp32 and in
    bf16 at head dim 32."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs import SHAPES
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    B, Skv = DECODE_SMALL_B, SHAPES["decode_32k"].seq_len
    q = torch.randn((B, Hq, 1, D), device=dev, generator=gen)
    k = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen)
    v = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    stream = torch.cuda.current_stream().cuda_stream
    chosen = FK.decode_splits(B, Hkv, FK.decode_chunks("cuda_cores", Hq // Hkv), Skv, sms)
    for label, qc, kc, vc in (("fp32", q, k, v),
                              ("bf16 D 32", *(t[..., :32].bfloat16().contiguous()
                                              for t in (q, k, v)))):
        eb, d = qc.element_size(), qc.shape[-1]
        atol, row_rel = (ATOL32, ROW_REL32) if eb == 4 else (ATOL, ROW_REL)
        outs = {}

        def dec(lib, splits, name):
            out = torch.empty_like(qc)
            part = (torch.empty((B, Hq, splits, d + 2), device=dev, dtype=torch.float32)
                    if splits > 1 else None)
            outs[name] = out

            bk = (DECODE_OLD_BK,) if name == OLD else ()  # the old kernel's block

            def run():
                rc = lib.flash_decode_launch(eb, qc.data_ptr(), kc.data_ptr(), vc.data_ptr(),
                                             out.data_ptr(),
                                             None if part is None else part.data_ptr(), B, Hq,
                                             Hkv, Skv, d, *bk, splits, d ** -0.5, stream)
                if rc == 0 and part is not None:
                    rc = lib.flash_decode_combine_launch(part.data_ptr(), out.data_ptr(), B * Hq,
                                                         d, splits, eb, stream)
                if rc:
                    raise RuntimeError(f"{name}: launch failed: {rc}")
            return run

        fns = {"as built": dec(libs["as built"], chosen, "as built")}
        for name in CORE_VARIANTS:
            fns[name] = dec(libs[name], chosen, name)
        for n in CORE_FORCED_SPLITS:
            if n != chosen:
                fns[f"splits {n}"] = dec(libs["as built"], n, f"splits {n}")
        if OLD in libs:
            fns[OLD] = dec(libs[OLD], 1, OLD)
        want = attention_ref(qc, kc, vc, False)
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            err = float((outs[name].float() - want.float()).abs().max())
            rel = row_rel_err(outs[name], want)
            if err > atol or rel > row_rel:
                raise AssertionError(f"{label} variant {name!r} disagrees with the plain "
                                     f"version: max abs {err}, row relative {rel}")
        del want

        def sdpa(qc=qc, kc=kc, vc=vc):
            if qc.dtype == torch.float32:  # the only backend that takes fp32 with enable_gqa
                with sdpa_kernel([SDPBackend.MATH]):
                    return F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True)
            return F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True)

        fns["F.scaled_dot_product_attention"] = sdpa
        bound = 2 * kc.numel() * eb / 3.35e12 * 1e3
        for calls, n_rounds in ((1, rounds), (QUEUED_CALLS, max(1, rounds // 3))):
            times = in_turns(torch, fns, n_rounds, calls)
            print(f"decode {label} B {B} x {Skv}, Hq {Hq}, Hkv {Hkv} (cuda_cores), splits chosen "
                  f"{chosen} on {sms} SMs, byte bound {bound:.4f} ms, in turns ({n_rounds} "
                  f"rounds), {calls} call(s) back to back a run:", flush=True)
            report(times, "as built")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "fwd", "decode"), default="all")
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout of the commit before the CUDA-core decode's redesign, whose "
                         "kernel is timed as the old kernel (left out without it)")
    ap.add_argument("--rounds", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    libs = build_variants(args.part, args.base)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    if args.part in ("all", "fwd"):
        ablate_fwd(torch, libs, args.rounds, gen, dev)
        torch.cuda.empty_cache()
    if args.part in ("all", "decode"):
        ablate_decode(torch, libs, args.rounds, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
