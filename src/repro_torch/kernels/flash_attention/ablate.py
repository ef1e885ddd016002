"""Ablation of the flash kernels' design choices on the card.

Builds variants of ``repro_torch/csrc/flash_attention.cu`` that each undo
one design choice, by a textual edit of the source, and times them in
turns with the kernel as built and ``F.scaled_dot_product_attention``.

The forward (``--part fwd``), ``flash_fwd_wgmma_kernel`` at granite-3-2b's
causal prefill (B 4 × S 4096, Hq 32, Hkv 8, D 64, bf16: the main path of
``chip_smoke.py``'s ``run_flash``), at the tile (128, 128), beside the
same kernel at (64, 64):

* ``no ping-pong``: the two consumer warpgroups issue their GEMMs freely
  instead of taking turns on the tensor cores (named barriers);
* ``no intra-warpgroup overlap``: a block's softmax waits for the previous
  block's P·V too, instead of only for its own Q·K^T;
* ``Q from shared memory``: Q·K^T reads Q from shared memory (both
  operands there) instead of from registers loaded once a tile;
* ``correction after P V``: O is rescaled once the previous P·V is done,
  on the critical path, instead of under the next Q·K^T;
* ``3-stage ring``: three K and V stages instead of two (at (128, 128));
* ``not persistent``: one CTA per tile instead of one per SM;
* ``stride tile order``: CTA i takes tiles i, i + n, i + 2n, ... (n CTAs)
  instead of rounds that alternate direction;

and, as timing probes whose output is wrong and not checked, the kernel
without its exponentials, without its softmax, without P·V or without
Q·K^T: the time each saves (or adds) shows how far that piece sits on
the critical path.  Then the same kernel at the head dims it pads in
shared memory, zamba2-2.7b's D 80 and phi3-mini-3.8b's D 96 (32 query and
32 KV heads each, causal B 1 × 4096, bf16, (128, 128): ``chip_smoke.py``'s
``run_head_dims``), and at mixtral-8x7b's D 128 (32 and 8), as built
against ``fwd: P V over the padded width`` (at D 80 and 96 only): P·V
over the 128 columns of the two boxes (V's zero columns giving O's zero
columns) instead of at N = D (wgmma m64n80k16, m64n96k16);
``stride tile order``, SDPA and, with ``--base`` (a checkout of the commit
before, e.g. ``git archive b905bb3`` unpacked), the ``old kernel``: the
forward from there, at granite's D 64 too.

The forward at (64, 64) (``--part fwd64``), the same kernel at KV blocks
of 64 keys, its two consumers on two adjacent q blocks of 64 rows sharing
one ring, at granite-3-2b's causal prefill (as ``--part fwd``), as built
against

* ``fwd64: 2 stages`` and ``fwd64: 4 stages``: K and V rings of two or
  four stages instead of three;
* ``fwd64: 6 stages``: six;
* ``fwd64: one q block a CTA``: one consumer warpgroup a CTA on one q
  block with a ring of its own, two CTAs an SM (``kFa64Pair`` off);
* ``fwd64: softmax reductions as chains``: a block's row max and sum as
  chains of 15 operations instead of trees 4 deep (``kTreeReduce``);
* ``fwd64: a quarter of the exponentials on the FMA pipe``: every fourth
  n8 tile's exponentials of an unmasked block by a degree-4 polynomial
  (``EX2_POLY``, inserted into the source) instead of the MUFU's
  ``ex2.approx``, to show whether the MUFU is the limit;
* ``fwd64: warpgroup index not broadcast``: ``threadIdx.x / 128`` as it
  is, which the compiler cannot prove uniform, so each consumer's block
  count, derived from it, reads as divergent;
* the (128, 128) switches that apply at (64, 64) too (``no ping-pong``,
  ``no intra-warpgroup overlap``, ``Q from shared memory``, ``correction
  after P V``, ``not persistent``, ``stride tile order``) and the probes;
* the kernel at (128, 128), as built; SDPA; and, with ``--base`` (a
  checkout of the parent commit, e.g. ``git archive 4e138d5`` unpacked),
  the ``old kernel``: the FA2 ``mma.sync`` kernel at (64, 64) from there,
  and that library's (128, 128) kernel beside this one's, twice (``old
  kernel (128, 128), again``: the same launch under a second name, whose
  difference from the first is the spread of the turns).

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

The fp32 forward (``--part fwd32``), ``flash_fwd_tf32_kernel`` at
granite-3-2b's causal prefill in fp32 (B 1 × S 4096, Hq 32, Hkv 8, D 64,
operands drawn in fp32: ``chip_smoke.py``'s fp32 prefill), at the tile
(128, 128), beside (64, 64):

* ``fwd32: one TF32 pass``: both products on hi parts alone; timed, and
  shown to fail the error gate (its error against an fp64 attention
  beyond 3× that of SDPA's math backend);
* ``fwd32: 4 consumer warps``: 64 query rows a CTA instead of 128;
* ``fwd32: 4 stages``: a ring of four K and V stages instead of two;
* ``fwd32: small products summed in``: lo·hi and hi·lo added into the
  hi·hi accumulator on the tensor cores (its error is printed);
* ``fwd32: lo rounded``: lo = x - hi rounded to TF32 (two more integer
  operations a split) instead of handed to the MMA as it is;
* ``fwd32: hi by cvt.rna``: hi rounded by ``cvt.rna.tf32.f32`` instead
  of its two integer operations (the same bits; lo as built);
* ``old kernel``, with ``--base`` (a checkout of the parent commit,
  e.g. ``git archive 2c181c5`` unpacked): the CUDA-core
  ``flash_fwd_f32_kernel`` from there;
* the library call, SDPA under the math backend;

and the probes ``fwd32 probe: no split`` (hi the raw fp32 bits, lo zero,
the three passes still run), ``no softmax``, ``no P V`` and ``no Q K^T``.

Each variant's RMS and max abs error against an fp64 attention is
printed beside the math backend's (TF32 off).

    python -m repro_torch.kernels.flash_attention.ablate [--part all|fwd|fwd64|decode|fwd32] [--base DIR] [--rounds 30] [--seed 0]

``--base`` takes a checkout that holds the old kernel of each part asked
for: the CUDA-core decode before its redesign for ``decode`` (e.g. ``git
archive 8a5a615``, which holds the old fp32 forward and the wgmma forward
at D 64 and 128 only too, so it serves ``all``), the CUDA-core fp32
forward for ``fwd32``, the wgmma forward at D 64 and 128 only for
``fwd`` (at the head dims its library does not route to that kernel it
is timed on what it runs there), the ``mma.sync`` forward for ``fwd64``.
An old library's ``flash_fwd_launch`` takes no reference blocks.

Needs a CUDA device and nvcc (exits nonzero without); prints the card's
name and power limit and the median time of each variant.  Every variant
(but the one-pass forward) is first held to the smoke's tolerances
against the plain version (the forward on the first batch, the decode on
batches 0-15, fp32 on batches 0-7).  The variants are built under
``repro_torch/.build/ablate``.
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
    "not persistent": [("const int grid = tiles < slots ? tiles : slots;", "const int grid = tiles;")],
    "stride tile order": [("constexpr bool kSnakeTiles = true;", "constexpr bool kSnakeTiles = false;")],
}
STRIDE = "stride tile order"  # timed at the head dims too
# the forward at the head dims the wgmma kernel pads (ablate_head_dims)
HEAD_DIM_VARIANTS = {
    "fwd: P V over the padded width": [("constexpr bool kPvExactWidth = true;",
                                        "constexpr bool kPvExactWidth = false;")],
}
# 2^x on the FMA and integer pipes instead of the MUFU: x = n + f with n the
# nearest integer (the 1.5 * 2^23 rounding trick) and f in [-1/2, 1/2], 2^f
# by a degree-4 polynomial (relative error 2.7e-6), n added to the exponent
# bits; 0 below 2^-125 (ex2.approx.ftz: below 2^-126)
EX2_POLY = """__device__ __forceinline__ float ex2_poly(float x) {
  const float t = fmaxf(x, -127.f) + 12582912.f;
  const float f = x - (t - 12582912.f);
  float p = fmaf(0.009570102f, f, 0.055917863f);
  p = fmaf(p, f, 0.24024744f);
  p = fmaf(p, f, 0.69312179f);
  p = fmaf(p, f, 0.99999928f);
  const float y = __int_as_float(__float_as_int(p) + (__float_as_int(t) << 23));
  return x < -125.f ? 0.f : y;
}

"""
# the forward at (64, 64) (ablate_fwd64), beside VARIANTS' "no ping-pong"
FWD64_VARIANTS = {
    "fwd64: 2 stages": [("constexpr int kFa64Stages = 3;", "constexpr int kFa64Stages = 2;")],
    "fwd64: 4 stages": [("constexpr int kFa64Stages = 3;", "constexpr int kFa64Stages = 4;")],
    "fwd64: 6 stages": [("constexpr int kFa64Stages = 3;", "constexpr int kFa64Stages = 6;")],
    "fwd64: one q block a CTA": [("constexpr bool kFa64Pair = true;",
                                  "constexpr bool kFa64Pair = false;")],
    "fwd64: softmax reductions as chains": [("constexpr bool kTreeReduce = true;",
                                             "constexpr bool kTreeReduce = false;")],
    "fwd64: a quarter of the exponentials on the FMA pipe": [
        ("// The largest (kSum: the sum) of row r's", EX2_POLY + "// The largest (kSum: the sum) of row r's"),
        ("      x = kMask ? ex2(x - m[e >> 1]) : ex2(fmaf(x, c, -m[e >> 1]));\n",
         "      x = kMask ? ex2(x - m[e >> 1])\n"
         "          : j % 4 == 3 ? ex2_poly(fmaf(x, c, -m[e >> 1])) : ex2(fmaf(x, c, -m[e >> 1]));\n")],
    "fwd64: warpgroup index not broadcast": [
        ("  const int wg = kSame ? threadIdx.x / 128 : __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);",
         "  const int wg = threadIdx.x / 128;")],
}
# the (128, 128) switches that apply at (64, 64) too, timed there as well
FWD64_SHARED = {name: edits for name, edits in VARIANTS.items() if name != "3-stage ring"}
HEAD_DIMS_TIMED = (("zamba2-2.7b", 32, 32, 80), ("phi3-mini-3.8b", 32, 32, 96),
                   ("mixtral-8x7b", 32, 8, 128))
# timing probes: each drops one piece of the work, so its output is wrong
# and not checked; the time saved bounds what that piece costs in the
# kernel as built
PROBES = {
    "probe: no exponentials": [('asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));',
                                "y = x;")],
    "probe: no softmax": [("        SOFTMAX(0);\n", "        corr[0] = corr[1] = 1.f;\n"),
                          ("          SOFTMAX(j);\n", "          corr[0] = corr[1] = 1.f;\n")],
    "probe: no P V": [("          pv_gemm<D, BK>(o, p, sv + pst * T::kKvBytes);\n", ""),
                      ("        pv_gemm<D, BK>(o, p, sv + lst * T::kKvBytes);\n", "")],
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
    "decode: CUDA-core kernel": [  # the route, and the bf16 instantiation it needs back
        ("  if (elem_bytes == 2 && (D == 64 || D == 128)) return kRouteTmaMma;\n", ""),
        ("        if (D == 32) DEC(bf16, 32);\n",
         "        if (D == 32) DEC(bf16, 32);\n        if (D == 64) DEC(bf16, 64);\n")],
}
CORE_VARIANTS = {
    "decode core: 3 consumer warps": [("constexpr int kCoreMaxConsumers = 6;",
                                       "constexpr int kCoreMaxConsumers = 3;")],
    "decode core: one consumer warp": [("constexpr int kCoreMaxConsumers = 6;",
                                        "constexpr int kCoreMaxConsumers = 1;")],
    "decode core: not persistent": [("const int ctas = units < sms ? units : sms;",
                              "const int ctas = units;")],
}
FWD32_VARIANTS = {
    "fwd32: one TF32 pass": [("constexpr int kT32Passes = 3;", "constexpr int kT32Passes = 1;")],
    "fwd32: 4 consumer warps": [("constexpr int kT32MaxConsumers = 8;",
                                 "constexpr int kT32MaxConsumers = 4;")],
    "fwd32: 4 stages": [("constexpr int kT32MaxStages = 2;", "constexpr int kT32MaxStages = 4;")],
    "fwd32: small products summed in": [("constexpr bool kT32SmallApart = true;",
                                         "constexpr bool kT32SmallApart = false;")],
    "fwd32: lo rounded": [("constexpr bool kT32LoRound = false;", "constexpr bool kT32LoRound = true;")],
    "fwd32: hi by cvt.rna": [("constexpr bool kT32CvtRna = false;", "constexpr bool kT32CvtRna = true;")],
}
# timing probes of the fp32 forward: each drops a piece of the work, so its
# output is wrong and not checked
FWD32_PROBES = {
    "fwd32 probe: no split": [("  hi = tf32_rna(x);\n  const float rest = x - __uint_as_float(hi);\n"
                               "  lo = kT32Passes != 3 ? 0u : kT32LoRound ? tf32_rna(rest) : "
                               "__float_as_uint(rest);\n", "  hi = __float_as_uint(x);\n  lo = 0u;\n")],
    "fwd32 probe: no softmax": [
        ("        softmax_block<true>(s, m, l, corr, c, j * kT32Block, key_lim);\n",
         "        corr[0] = corr[1] = 1.f;\n"),
        ("        softmax_block<false>(s, m, l, corr, c, j * kT32Block, key_lim);\n",
         "        corr[0] = corr[1] = 1.f;\n")],
    "fwd32 probe: no P V": [
        ("    if (work) pv_tf32<D>(o, s, corr, sv + st * (T::kTileBytes / 4), lane);\n", "")],
    "fwd32 probe: no Q K^T": [
        ("    if (work) qk_tf32<D>(s, qw, sk + st * (T::kTileBytes / 4), lane);\n",
         "    if (work) for (float& x : s) x = 0.f;\n")],
}
ONE_PASS = "fwd32: one TF32 pass"   # fails the error gate by design: timed, not checked
F32_GATE = 3.0                      # chip_smoke.F32_GATE: error within 3x SDPA math's (TF32 off)
OLD = "old kernel"
# the text that marks each part's old kernel in a --base checkout
OLD_MARKERS = {"decode": "flash_decode_kernel(const T* __restrict__ Q",
               "fwd32": "flash_fwd_f32_kernel(",
               "fwd": 'static_assert(D == 64 || D == 128, "wgmma forward head dim");',
               "fwd64": "flash_fwd_bf16_kernel("}
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
    "fwd64", "decode", "fwd32" or "all"), and "as built" (no edit)."""
    edits = {"as built": []}
    if part in ("all", "fwd"):
        edits.update({**VARIANTS, **PROBES, **HEAD_DIM_VARIANTS})
    if part in ("all", "fwd64"):
        edits.update({**FWD64_VARIANTS, **FWD64_SHARED, **PROBES})
    if part in ("all", "decode"):
        edits.update({**DECODE_VARIANTS, **DECODE_PROBES, **CORE_VARIANTS})
    if part in ("all", "fwd32"):
        edits.update({**FWD32_VARIANTS, **FWD32_PROBES})
    return edits


def old_source(base: Path, part: str = "decode") -> Path:
    """The previous ``flash_attention.cu`` in the checkout ``base``;
    FileNotFoundError when it is not a checkout of the repo, ValueError
    when it does not hold the old kernel of ``part`` (of both for "all")."""
    path = Path(base) / "src" / "repro_torch" / "csrc" / "flash_attention.cu"
    if not path.is_file():
        raise FileNotFoundError(f"{path} not found: --base takes a checkout of the repo")
    text = path.read_text()
    for name, marker in OLD_MARKERS.items():
        if part in ("all", name) and marker not in text:
            raise ValueError(f"{path} does not hold the old kernel of --part {name} ({marker!r})")
    return path


def build_variants(part: str = "all", base: Path | None = None) -> dict:
    """name -> ctypes library of each variant of ``part`` and "as built",
    and with a ``base`` checkout the old kernel, every nvcc started at
    once."""
    from repro_torch.kernels import _build

    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    paths = _build.build_variants("flash_attention", variant_edits(part))
    old_decode = False
    if base is not None:
        src = old_source(base, part)
        old_decode = OLD_MARKERS["decode"] in src.read_text()
        paths[OLD] = _build.build_variants("flash_attention", {OLD: []}, src)[OLD]
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        # an old library's forward launcher took no reference blocks
        lib.flash_fwd_launch.argtypes = [I] + [P] * 4 + [I] * (8 if name == OLD else 10) + [F, I, P]
        lib.flash_fwd_route.argtypes = [I] * 4
        # the old decode's launcher took the block bk, its combine wrote bf16
        # only and took no output width
        old = name == OLD and old_decode
        lib.flash_decode_launch.argtypes = [I] + [P] * 5 + [I] * (7 if old else 6) + [F, P]
        lib.flash_decode_combine_launch.argtypes = [P, P, I, I, I] + ([] if old else [I]) + [P]
        for fn in (lib.flash_fwd_launch, lib.flash_fwd_route, lib.flash_decode_launch,
                   lib.flash_decode_combine_launch):
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


def fwd_launch(lib, name: str, q, k, v, out, tile, stream) -> None:
    """The causal forward of ``lib`` (the variant ``name``) at ``tile``, its
    rows that see no key on the same blocks; an old library's launcher takes
    no reference blocks."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    blocks = () if name == OLD else tuple(tile)
    rc = lib.flash_fwd_launch(q.element_size(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), B, Hq, Hkv, Sq, Skv, D, *tile, *blocks, D ** -0.5, 1,
                              stream)
    if rc:
        raise RuntimeError(f"{name}: launch failed: {rc}")


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

    def fwd(name, tile):
        return lambda: fwd_launch(libs[name], name, q, k, v, out, tile, stream)

    names = ["as built", *VARIANTS, *PROBES, *((OLD,) if OLD in libs else ())]
    fns = {name: fwd(name, (128, 128)) for name in names}
    fns["(64, 64)"] = fwd("as built", (64, 64))
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


def ablate_fwd64(torch, libs: dict, rounds: int, gen, dev) -> None:
    """The bf16 forward at (64, 64) at granite-3-2b's causal prefill: as
    built, ``FWD64_VARIANTS``, no ping-pong, the kernel at (128, 128), SDPA
    and, with ``--base``, the old ``mma.sync`` kernel, in turns, each first
    held to the smoke's tolerances on the first batch."""
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
    names = ["as built", *FWD64_VARIANTS, *FWD64_SHARED, *PROBES,
             *((OLD,) if OLD in libs else ())]
    fns = {name: (lambda name=name: fwd_launch(libs[name], name, q, k, v, out, (64, 64), stream))
           for name in names}
    fns["(128, 128)"] = lambda: fwd_launch(libs["as built"], "as built", q, k, v, out, (128, 128),
                                           stream)
    if OLD in libs:  # the parent's (128, 128) kernel, which this slice templated on the block
        fns["old kernel (128, 128)"] = lambda: fwd_launch(libs[OLD], OLD, q, k, v, out, (128, 128),
                                                          stream)
        fns["old kernel (128, 128), again"] = fns["old kernel (128, 128)"]
    want = attention_ref(q[:1], k[:1], v[:1], True).float()
    errs = []
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        if name in PROBES:
            continue
        err, rel = float((out[:1].float() - want).abs().max()), row_rel_err(out[:1], want)
        if err > ATOL or rel > ROW_REL:
            raise AssertionError(f"fwd64 variant {name!r} disagrees with the plain version: max "
                                 f"abs {err}, row relative {rel}")
        errs.append(f"{name} {err:.3e} / {rel:.3e}")
    del want
    fns["F.scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True)
    times = in_turns(torch, fns, rounds)
    print(f"causal prefill B {B} x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, tile (64, 64): max abs "
          f"/ row relative error against the plain version on batch 0: {'; '.join(errs)}; in "
          f"turns ({rounds} rounds, order reversed every other round):", flush=True)
    report(times, "as built")


def ablate_head_dims(torch, libs: dict, rounds: int, gen, dev) -> None:
    """The bf16 forward at (128, 128) at zamba2-2.7b's D 80,
    phi3-mini-3.8b's D 96 and mixtral-8x7b's D 128, causal B 1 × 4096: as
    built (wgmma; D 80 and 96 padded to 128 columns in shared memory),
    ``HEAD_DIM_VARIANTS`` (at D 80 and 96, where they differ), the stride
    tile order, the old kernel where ``--base`` gave one, and SDPA in turns,
    each variant first held to the smoke's tolerances."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention.kernel import FWD_ROUTES
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    route_names = {number: name for name, number in FWD_ROUTES.items()}
    S = PREFILL[1]
    stream = torch.cuda.current_stream().cuda_stream
    for cfg, Hq, Hkv, D in HEAD_DIMS_TIMED:
        q = torch.randn((1, Hq, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
        k = torch.randn((1, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
        v = torch.randn((1, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
        outs, fns = {}, {}
        names = ["as built", *(HEAD_DIM_VARIANTS if D % 64 else ()), STRIDE]
        old_route = route_names.get(libs[OLD].flash_fwd_route(2, D, 128, 128)) if OLD in libs else None
        if old_route:  # an old library that serves this head dim
            names.append(OLD)
        for name in names:
            out = outs[name] = torch.empty_like(q)

            fns[name] = lambda name=name, out=out: fwd_launch(libs[name], name, q, k, v, out,
                                                              (128, 128), stream)
        want = attention_ref(q, k, v, True).float()
        errs = []
        for name, fn in fns.items():
            fn()
            torch.cuda.synchronize()
            err, rel = float((outs[name].float() - want).abs().max()), row_rel_err(outs[name], want)
            if err > ATOL or rel > ROW_REL:
                raise AssertionError(f"{cfg} D {D} variant {name!r} disagrees with the plain "
                                     f"version: max abs {err}, row relative {rel}")
            errs.append(f"{name} {err:.3e} / {rel:.3e}")
        del want, outs
        fns["F.scaled_dot_product_attention"] = lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True)
        flops = 4.0 * D * Hq * S * (S + 1) / 2  # the causal triangle's Q K^T and P V
        times = in_turns(torch, fns, rounds)
        print(f"{cfg} causal prefill B 1 x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, bf16, (128, 128)"
              f"{f' (the old kernel: {old_route})' if old_route else ''}: max "
              f"abs / row relative error against the plain version: {'; '.join(errs)}; in turns "
              f"({rounds} rounds, order reversed every other round), operation bound "
              f"{flops / 989e12 * 1e3:.4f} ms at 989 TFLOP/s:", flush=True)
        report(times, "as built")
        del q, k, v
        torch.cuda.empty_cache()


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


def ablate_fwd32(torch, libs: dict, rounds: int, gen, dev) -> None:
    """The fp32 forward at granite-3-2b's causal prefill, B 1 × 4096,
    operands drawn in fp32 (a value drawn in bf16 is exact in TF32, so one
    pass would pass a check on it)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention.ref import attention_fp64_ref, attention_ref, row_rel_err

    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    S = PREFILL[1]
    q = torch.randn((1, Hq, S, D), device=dev, generator=gen)
    k = torch.randn((1, Hkv, S, D), device=dev, generator=gen)
    v = torch.randn((1, Hkv, S, D), device=dev, generator=gen)
    stream = torch.cuda.current_stream().cuda_stream
    outs, fns = {}, {}

    def fwd(name, lib, tile):
        out = outs[name] = torch.empty_like(q)
        fns[name] = lambda: fwd_launch(lib, name, q, k, v, out, tile, stream)

    for name in ("as built", *FWD32_VARIANTS, *FWD32_PROBES, *((OLD,) if OLD in libs else ())):
        fwd(name, libs[name], (128, 128))
    fwd("as built (64, 64)", libs["as built"], (64, 64))

    def sdpa():  # the only backend that takes fp32 with enable_gqa
        with sdpa_kernel([SDPBackend.MATH]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)

    want, exact = attention_ref(q, k, v, True), attention_fp64_ref(q, k, v, True)

    def errors(x):
        d = x.double() - exact
        return float(d.pow(2).mean().sqrt()), float(d.abs().max())

    lib_err = errors(sdpa())
    gate = (F32_GATE * lib_err[0], F32_GATE * lib_err[1])
    print(f"fp32 prefill B 1 x S {S}, Hq {Hq}, Hkv {Hkv}, D {D}, causal: error against an fp64 "
          f"attention, RMS and max abs: SDPA math (TF32 off) {lib_err[0]:.4e}, {lib_err[1]:.4e}; "
          f"the gate is {F32_GATE}x", flush=True)
    for name, fn in fns.items():
        fn()
        torch.cuda.synchronize()
        err = errors(outs[name])
        passes = err[0] <= gate[0] and err[1] <= gate[1]
        if name in FWD32_PROBES:
            continue
        if name == ONE_PASS and passes:
            raise AssertionError(f"the {F32_GATE}x error gate passes a one-pass TF32 product {err}")
        if name != ONE_PASS:
            atol, rel = float((outs[name] - want).abs().max()), row_rel_err(outs[name], want)
            if atol > ATOL32 or rel > ROW_REL32:
                raise AssertionError(f"variant {name!r} disagrees with the plain version: max abs "
                                     f"{atol}, row relative {rel}")
        print(f"  {name}: RMS {err[0]:.4e} ({err[0] / lib_err[0]:.3f}x), max abs {err[1]:.4e} "
              f"({err[1] / lib_err[1]:.3f}x): the gate {'passes' if passes else 'rejects'} it",
              flush=True)
    del want, exact, outs
    fns["F.scaled_dot_product_attention (math)"] = sdpa
    flops = 4.0 * D * Hq * S * (S + 1) / 2  # the causal triangle's Q K^T and P V
    times = in_turns(torch, fns, rounds)
    print(f"fp32 prefill in turns ({rounds} rounds, order reversed every other round); bounds: "
          f"three TF32 passes {3 * flops / 494.7e12 * 1e3:.4f} ms at 494.7 TFLOP/s, one fp32 pass "
          f"on the CUDA cores {flops / 67e12 * 1e3:.4f} ms at 67:")
    report(times, "as built")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--part", choices=("all", "fwd", "fwd64", "decode", "fwd32"), default="all")
    ap.add_argument("--base", type=Path, default=None,
                    help="a checkout that holds the old kernel of the part (the CUDA-core decode "
                         "before its redesign, the CUDA-core fp32 forward, the wgmma forward at D "
                         "64 and 128 only, the mma.sync forward at (64, 64)), timed as the old "
                         "kernel (left out without it)")
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
        ablate_head_dims(torch, libs, args.rounds, gen, dev)
        torch.cuda.empty_cache()
    if args.part in ("all", "fwd64"):
        ablate_fwd64(torch, libs, args.rounds, gen, dev)
        torch.cuda.empty_cache()
    if args.part in ("all", "decode"):
        ablate_decode(torch, libs, args.rounds, gen, dev)
        torch.cuda.empty_cache()
    if args.part in ("all", "fwd32"):
        ablate_fwd32(torch, libs, args.rounds, gen, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
