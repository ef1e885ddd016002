#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port on one NVIDIA H100.

Runs every ported path through the port's own entry points, and builds the CUDA kernels from ``src/repro_torch/csrc``
with nvcc first (one nvcc per source, in parallel):

* the §5.2 stencil (range-4 star, 25 points, domain (512, 512, 640), fp64):
  ranks all 168 launches of the per-point kernel analytically on the H100
  and runs ``star_stencil`` at the winning launch; then stencils with two
  sets of weights on two streams at once (the constant bank's guard) and
  a range of 9, past the bank;
* the §5.3 D3Q15 Allen-Cahn LBM (domain (256, 256, 256), fp64): ranks all
  168 launches of the per-point LBM kernel and runs ``lbm_step`` at the
  winning launch;
* the weighted 2D 5-point Jacobi sweep (domain (4096, 4096), fp64): ranks
  the 22 of the 168 launches that fill the 2D domain's depth and runs
  ``jacobi_step`` at the winning launch;
* the 2D transpose ((8192, 8192), fp32): ranks the 22 launches that fill
  the domain's depth and runs ``transpose`` at the winning launch;
* the attention path at granite-3-2b's full width (bf16): ``tuned_matmul``
  on the GEMMs of one layer at 16384 tokens (and on the out GEMM in fp32,
  three TF32 passes held to an fp64 product), ``flash_attention`` on a causal
  prefill (B 4, S 4096, also at two configs of the reference's space, which
  run the kernel's own tile; causal Sq > Skv, whose rows that see no key
  take the reference kernel's value at each config; in fp32 at B 1, three
  TF32 passes held to an fp64 attention; and the head dims 80, 96 and 128
  of the repo's other configs in both dtypes) and on one decode token
  against a 32k cache
  (B 128, and B 8 with the cache split across the SMs, in bf16 and, on
  the CUDA-core decode, in fp32 and in bf16 at head dim 32), and
  ``attention_apply(use_pallas=True)`` on (4, 4096, 2048);
  the GEMMs are also timed in turns with ``torch.matmul``, and the prefill's
  two tiles in turns with ``F.scaled_dot_product_attention``, since the
  card slows under sustained tensor-core load;
* the tpu phase ("tpu P1"), after the paths: the TPU side of the
  generators, each paper-loop generator's Pallas space ranked with
  ``tpu_rank_configs`` on the TPU v5e at the paths' domains and dtypes (the
  stencil's and the LBM's fp64, Jacobi's fp64 and fp32, the transpose's
  fp32), the TPU winner's config run on the card by the path's entry
  point and held to its plain version, its kernel timed beside its bound
  and the H100-ranked launch of the same phase;
* the layers phase: the rest of the layer library at the full width of
  the repo's configs, bf16, random weights from ``--seed``: granite-3-2b's
  rmsnorm and SwiGLU and whisper-base's layernorm and GELU MLP against
  their fp32 evaluation (L1); granite-3-2b's attention through a full KV
  cache, bf16 and int8, a 4096-token prefill and 16 decode steps against
  attention without a cache (L2); mixtral-8x7b's sliding window through a
  ring cache that wraps (L3); one mixtral-8x7b MoE layer, top-1 against the
  dense argmax-expert oracle and top-2 with its dropped pairs adding
  nothing (L4); zamba2-2.7b's Mamba2 and rwkv6-1.6b's time and channel mix
  chunked at S 4096 and against their exact recurrences (L5); each timed
  beside its bound, and none launching the port's kernels;
* the lm phase: whole models served through the port's LM stack
  (``repro_torch.models.lm``, ``train.step``, ``launch.serve``), bf16,
  random weights from ``--seed``: granite-3-2b whole (40 layers) through
  ``launch.serve``'s loop at B 4, 8 requests, prompt 512, 64 tokens, its
  prefill and decode logits held to ``forward`` without caches
  (teacher-forced over each prompt and its tokens) and to an fp32
  evaluation, two wrong decode steps rejected by the same bound (M1); the
  same model over an int8 cache held to M1's logits (M2); rwkv6-1.6b,
  zamba2-2.7b, whisper-base and 2 of mixtral-8x7b's 32 layers through a
  prefill and 8 decode steps at B 2, timed in bf16 and held in fp32 to
  their teacher-forced forward, the MoE's routing held equal (M3); each
  beside its bound, and none launching the port's kernels;
* the train phase: the training half of the LM stack (``data``,
  ``optim.adamw``, ``train.step``, ``checkpoint``, ``runtime.fault``,
  ``launch.train``), bf16, random weights from ``--seed``: granite-3-2b
  whole trained through ``launch.train.train`` at global batch 8 x 512 in
  two microbatches, remat on, 6 steps, timed beside its bound, its first
  batch's loss, gradient norm and gradients held to an fp32 evaluation on
  the card, labels shifted by one position rejected, one microbatch held
  to two (T1); ``apply_updates`` on four of its leaves, card against CPU,
  with and without int8 compression (T2); 2 layers of it at full width
  trained 4 steps straight and 2 + an async save + a resume of 2, bit for
  bit under deterministic algorithms, and its checkpoint's save and restore
  timed (T3); rwkv6-1.6b, zamba2-2.7b, whisper-base and 2 of mixtral-8x7b's
  layers, two train steps each at B 2 x 512, the first's loss and gradient
  norm held to fp32 (T4); none launching the port's kernels;
* the shard phase: ``train.sharding``'s specs applied as DTensor
  placements on a (1, 1) ``DeviceMesh`` ('data', 'model') of a one-rank
  ``nccl`` group: granite-3-2b whole, bf16, from ``--seed``, two train
  steps through ``launch.train.train`` at 8 x 512 in two microbatches,
  every batch placed, timed beside T1's median, the first step's loss and
  gradient norm held to the plain step's on the same weights and batch,
  its peak memory to T1's plus a margin (S1); none launching the port's
  kernels;
* the dryrun phase: the model-level dry run (``core.cost.count_cost``,
  ``launch.calibrate``, ``launch.dryrun``) at granite-3-2b's full width:
  every valid cell through ``lower_cell`` on meta stand-ins, timed, with its
  dominant term, bound and predicted peak (D1); T1's train step and M1's
  decode step each counted on meta (calibrated and whole) and on the card,
  their product FLOPs held equal, the calibrated train products to
  ``train_work``'s, the predicted peak to ``torch.cuda.max_memory_allocated``
  over an uncounted step, each placed on the card's data-sheet peaks beside
  the step's median from the train and lm phases (D2, D3); none launching
  the port's kernels; then the dry run on the reference's production meshes
  (D4): granite-3-2b's decode_32k through ``lower_cell`` on (16, 16) and a
  train cell on (2, 16, 16), each counted as rank 0's program on ``meta``
  shards under a ``fake`` process group opened and closed inside the phase,
  the decode's products times 256 held equal to one device's and each raw
  count held to the calibrated one;
* the api phase: ``examples/torch_stencil_codegen.main`` at the
  paper's domains (one ``repro_torch.api.price`` sweep of both paths' 168
  launches, then ``star_pointwise`` and ``lbm_pointwise`` at the winners
  against ``ref.py``), its rankings against the generators' bitwise, one
  ranking of each path timed four ways (serial; the pooled engine, started
  after CUDA, so never by ``fork``; pooled top-10; the same engine warm)
  with the pooled sweep's spans, and ``torch.sum`` streaming reads at an
  L2-resident footprint and at the two paths' DRAM footprints beside the
  H100 model's ``l2_bw`` and ``dram_bw``; then it stops the pool's
  forkserver, and fails if any process it started is still there;
* the sim phase, after it: ``examples/torch_quickstart.main`` on the card
  (the H100 ranking of r = 4 at (192, 192, 256), its winner run by
  ``star_pointwise`` against ``ref.py`` and timed); the paper's volume
  check, the LRU cache simulator's DRAM bytes a point (``core.cachesim``,
  on the host) beside the estimator's for the ranked winners of both
  paths and the quickstart's, each held to the reference's numbers, and
  the DRAM rates they imply at the kernels' measured times;
  ``examples/torch_design_space.main`` on the pooled engine started after
  CUDA, held to a serial sweep and to ``price`` on its A100 anchor; then
  the pool's forkserver stopped as after the api phase;
* the suite phase, after it: ``examples/torch_model_pricing.main`` (the
  mixtral-8x7b plan priced on V100, A100 and TPU-v5e through
  ``price(plan_request(...))``), its rows held to the reference's; a
  ``plan_request`` for granite-3-2b's ``train_4k`` plan on ``H100``
  through the wire codec and ``price``; then one forward pass of that plan
  at full width on the card: every distinct GEMM class through
  ``tuned_matmul`` in bf16 and the attention core through
  ``flash_attention`` (B 1, 32/8 heads, S 4096, D 64, causal), each held
  against its plain version and timed beside the suite's H100 price of it
  and its bf16 bound; then the pass against the suite's H100 price;
* the serve phase: ``python -m repro_torch.serve`` started as a
  process (pooled, ``--resume``, a pid file); the api phase's request
  priced cold through its socket and held to the api phase's in-process
  ``price`` byte for byte, the two paths' own requests coalesced behind it
  and held to their solo rankings, both spaces in fp32 on the warm daemon;
  200 memo hits each of the full report and of a top-5 request;
  ``star_pointwise`` and ``lbm_pointwise`` at the served winners (the
  generators') against ``ref.py``, timed; a SIGTERM drain, a ``--resume``
  restart answering warm with the same bytes to a client built while the
  daemon was down, the ``shutdown`` op; then a ``PricingDaemon`` in this
  process on a pooled engine (``forkserver`` after CUDA), and no child
  process left;
* the frontend phase, last (``repro_torch.frontend`` with the installed
  Triton): ``examples/torch_price_my_kernel.main`` on the card, the
  ``@triton.jit`` scale_shift at 4096 x 4096 fp32 traced, priced on V100,
  A100, H100 and TPU-v5e through ``kernel_request``, launched and held to
  x * 2 + 1 within one ulp, timed beside the H100 prediction, its bound and
  eager ``x * 2.0 + 1.0`` (F1); each tracer fixture (the 5-point Jacobi
  sweep at 4096^2 fp64, the r = 4 star at 256^3 fp64, a 4096^3 bf16 GEMM,
  an 8192 x 4096 fp32 transpose) traced from its ``@triton.jit`` kernel,
  its GPU spec equal on the wire to ``core.specs``', launched and held to
  its plain version, timed beside its H100 prediction, bound and library
  call (F2); F1's traced request through ``python -m repro_torch.serve``,
  equal on the wire to in-process ``price`` (F3).

Each path's pinned variants (the z-march stencils, the y-tiled LBM, the
y-tiled Jacobi sweep, the tiled transpose, the second GEMM and flash tiles)
run too, in the path's second dtype as well (fp32 beside fp64 and bf16),
and every kernel is held against its plain PyTorch version on the card.  It then times each kernel beside its bound, its plain
version and, where one exists, one library call that computes the same
function, and times every priced launch of the stencil paths (all 168 on
the 2D paths, the skipped ones too) to rank the estimator against the card,
then times the ten fastest and the predicted best again, 20 runs each.

    python3 chip_smoke.py [--seed N]

Run from the root of a checkout.  It exits nonzero, and prints no result,
without a CUDA device or without the repository beside it.  The last line
of its output is ``{"ok": true, "device": {...}}``; the line before it is
the ``{"kernels": [...]}`` record.
"""
from __future__ import annotations

import argparse
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
R = 4
DOMAIN = (512, 512, 640)          # (Z, Y, X), paper §5.2
EDGE_DOMAIN = (509, 511, 637)     # no block extent divides it: edge guards run
WIDE_R = 9                        # a range past the constant bank: the generic kernels
WIDE_DOMAIN = (64, 128, 256)      # its field (Z, Y, X)
WIDE_YTILE = {"variant": "ytile_ring", "ty": 32}  # ty >= 2r divides Y; fp64 ring fits 32x8
STREAM_ROUNDS = 3                 # rounds of launches in turns on two streams
ZMARCH_VARIANTS = ({"variant": "ring"},
                   {"variant": "ytile_ring", "ty": 8},
                   {"variant": "ytile_ring", "ty": 16})
EDGE_LAUNCHES = (((16, 2, 32), (1, 1, 1)), ((32, 8, 4), (1, 2, 1)),
                 ((64, 4, 4), (1, 1, 2)), ((1024, 1, 1), (1, 1, 1)),
                 ((8, 16, 8), (1, 2, 1)), ((4, 4, 64), (1, 1, 2)))
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {8: 33.5e12, 4: 67e12}
# tolerances: the kernels sum the taps in the plain version's order, but the
# compiler contracts multiply-adds into FMAs, which round once instead of twice
TOL = {8: dict(rtol=1e-12, atol=1e-12), 4: dict(rtol=1e-5, atol=1e-5)}
SOURCE = "src/repro_torch/csrc/stencil3d25.cu"
REPLACES = {
    "replane": "src/repro/kernels/stencil3d25/kernel.py:69",
    "ring": "src/repro/kernels/stencil3d25/kernel.py:102",
    "ytile_ring": "src/repro/kernels/stencil3d25/kernel.py:145",
}
LBM_DOMAIN = (256, 256, 256)          # (Z, Y, X), paper §5.3
LBM_EDGE_DOMAIN = (61, 127, 251)      # no block extent divides it
LBM_YTILE_EDGE_DOMAIN = (61, 120, 251)  # 8 | Y, and no tile width divides X
LBM_YTILE_VARIANTS = ({"variant": "ytile", "ty": 8}, {"variant": "ytile", "ty": 16})
LBM_SOURCE = "src/repro_torch/csrc/lbm_d3q15.cu"
LBM_REPLACES = {
    "replane": "src/repro/kernels/lbm_d3q15/kernel.py:84",
    "ytile": "src/repro/kernels/lbm_d3q15/kernel.py:141",
}
JACOBI_DOMAIN = (4096, 4096)             # (Y, X), core/specs.py:stencil_2d5pt's default
JACOBI_EDGE_DOMAIN = (1021, 2043)        # no block extent divides either side
JACOBI_YTILE_EDGE_DOMAIN = (1008, 2043)  # 8 | Y and 16 | Y, and no tile width divides X
JACOBI_WEIGHTS = (0.5, 0.125)
JACOBI_YTILE_VARIANTS = ({"variant": "ytile", "ty": 8}, {"variant": "ytile", "ty": 16})
JACOBI_SOURCE = "src/repro_torch/csrc/jacobi2d.cu"
JACOBI_ROUNDS = 20                       # rounds of the Jacobi kernels, F.conv2d, a copy in turns
JACOBI_REPLACES = {
    "rowstream": "src/repro/kernels/jacobi2d/kernel.py:49",
    "ytile": "src/repro/kernels/jacobi2d/kernel.py:81",
}
TRANSPOSE_SHAPE = (8192, 8192)           # (M, N), benchmarks/bench_trace_extract.py:76
TRANSPOSE_EDGE_SHAPE = (2045, 1021)      # non-square, no side a multiple of 32
TRANSPOSE_TILES = ({"bm": 32, "bn": 32}, {"bm": 128, "bn": 128})
TRANSPOSE_SOURCE = "src/repro_torch/csrc/transpose_pad.cu"
TRANSPOSE_REPLACES = "src/repro/kernels/transpose_pad/kernel.py:29"
TRANSPOSE_ROUNDS = 30                    # rounds of the fp64 transpose and its library call in turns
# the attention path at granite-3-2b's width (src/repro/configs/granite3_2b.py)
T_TOKENS = 4 * 4096                      # tokens of the layer's GEMMs
PREFILL = (4, 4096)                      # (B, S) of the prefill and of the layer
DECODE_SLICE = 16                        # batch slice of the decode check
DECODE_SMALL_B = 8                       # one user at low concurrency: the split-KV decode
QUEUED_CALLS = 10                        # calls back to back in a queued timing
MATMUL_EDGE_SHAPES = ((1000, 2056, 776), (129, 40, 264))  # (M, K, N), no tile divides them
MATMUL_MANY_TILES = (8200, 264, 8200)    # > 132 x 4 tiles: each persistent CTA walks many
MATMUL_F32_TAIL = (300, 1028, 260)       # fp32 only (K % 8 = 4): a K tail of 4 in the last slab
FLAT_LAUNCHES = 22                       # of the 168, those with z extent bz·fz = 1
PEAK_BF16_FLOPS = 989e12                 # H100 SXM data sheet, dense bf16 tensor cores
PEAK_TF32_FLOPS = 494.7e12               # H100 SXM data sheet, dense TF32 tensor cores
# tolerances on the card: bf16 GEMM against the fp32-accumulated product cast
# to bf16; fp32 GEMM as tests/test_kernels.py:61 (different sum orders);
# flash as tests/test_kernels.py:102 (bf16) and 2e-3 (fp32)
GEMM_TOL = {2: dict(rtol=1e-2, atol=1e-2), 4: dict(rtol=1e-4, atol=8e-4)}
# the fp32 GEMM runs on TF32 tensor cores in three passes: its RMS and max
# abs error against an fp64 product may be at most this many times those of
# torch.matmul with TF32 off (one TF32 pass reads hundreds of times)
F32_GATE = 3.0
FLASH_TOL = {2: dict(rtol=0.0, atol=3e-2), 4: dict(rtol=0.0, atol=2e-3)}
# an attention output is a softmax average, about sqrt(e / Skv) in size far
# from the first keys (0.009 at a 32k cache), so FLASH_TOL alone passes a
# kernel that skips a block of keys; every output row (a query row's D
# values, a token's d_model values) is also held to this relative L2 bound,
# and run_flash shows that an output missing one KV block fails it
FLASH_ROW_REL = {2: 2e-2, 4: 1e-4}
FLASH_ROUNDS = 30                        # rounds of the prefill's tiles and SDPA in turns
# configs of the reference's space (not the kernel's tiles): they run the
# kernel at its default tile
FLASH_REFERENCE_CONFIGS = ({"bq": 256, "bk": 128}, {"bq": 128, "bk": 512})
MATMUL_REFERENCE_CONFIG = {"bm": 128, "bk": 128, "bn": 128}
# causal with Sq > Skv (B, Hq, Hkv, Sq, Skv): rows 0-127 see no key; each
# config's blocks decide their value (0 at the kernel's tiles, the mean of V
# over keys 0-127 at (256, 128), over all 384 at (512, 128))
NO_KEY_SHAPE = (1, 32, 8, 512, 384)
NO_KEY_CONFIGS = ({"bq": 128, "bk": 128}, {"bq": 64, "bk": 64}, {"bq": 256, "bk": 128},
                  {"bq": 512, "bk": 128})
NO_KEY_FP32_TOL = 1e-6  # fp32 no-key rows: V summed on the tensor cores in their own order
# the head dims of the repo's configs beyond granite-3-2b's 64 (src/repro/configs:
# d_model / n_heads), with their query and KV heads: checked in both dtypes
HEAD_DIM_CONFIGS = (("zamba2-2.7b", 32, 32, 80), ("phi3-mini-3.8b", 32, 32, 96),
                    ("mixtral-8x7b", 32, 8, 128))
# timed at full width, B 1 x 4096 causal: the fp32 forward at D 128, the bf16
# wgmma forward at D 80 and 96 (D padded to 128 columns in shared memory)
HEAD_DIM_TIMED = (("mixtral-8x7b", 32, 8, 128, "float32"), ("zamba2-2.7b", 32, 32, 80, "bfloat16"),
                  ("phi3-mini-3.8b", 32, 32, 96, "bfloat16"))
MATMUL_SOURCE = "src/repro_torch/csrc/matmul.cu"
MATMUL_REPLACES = "src/repro/kernels/matmul/kernel.py:42"
FLASH_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
FLASH_REPLACES = {"fwd": "src/repro/kernels/flash_attention/kernel.py:77",
                  "decode": "src/repro/kernels/flash_attention/kernel.py:144"}


def say(*parts) -> None:
    print(*parts, flush=True)


PTXAS_TYPES = {"d": "double", "f": "float", "i": "int", "l": "long"}
# "name<args>" of each compiled kernel -> its ptxas line on registers (and
# spills), filled when main() builds the kernels
REGISTERS: dict = {}


def ptxas_kernel_name(line: str) -> str:
    """``name<args>`` of the kernel a ptxas "Compiling entry function" line
    names: the last component of its mangled name and its template
    arguments (integers and the scalar types)."""
    m = re.search(r"_ZN(\w+)", line)
    if not m:
        return "?"
    rest, name = m.group(1), "?"
    while rest[:1].isdigit():
        n = int(re.match(r"\d+", rest).group())
        digits = len(str(n))
        name, rest = rest[digits:digits + n], rest[digits + n:]
    args = []
    if rest.startswith("I"):
        rest = rest[1:]
        while rest and rest[0] != "E":
            lit = re.match(r"L[ib](\d+)E", rest)
            if lit:
                args.append(lit.group(1))
                rest = rest[lit.end():]
            elif rest[0] in PTXAS_TYPES:
                args.append(PTXAS_TYPES[rest[0]])
                rest = rest[1:]
            else:
                break
    return name + (f"<{', '.join(args)}>" if args else "")


def registers(kernel: str) -> str:
    """ptxas's report for ``kernel`` (``name<args>``), or "not reported"."""
    return REGISTERS.get(kernel, "not reported")


def live_children() -> list:
    """``(pid, state, command)`` of every process whose parent is this one,
    zombies too, from ``/proc``."""
    import os

    me, found = os.getpid(), []
    for stat in Path("/proc").glob("[0-9]*/stat"):
        try:
            text = stat.read_text()
        except OSError:  # gone meanwhile
            continue
        state, ppid = text[text.rindex(")") + 2:].split()[:2]
        if int(ppid) == me:
            command = text[text.index("(") + 1:text.rindex(")")]
            found.append((int(stat.parent.name), state, command))
    return found


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def cuda_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median device time of ``fn`` over ``reps`` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return statistics.median(times)


def interleaved_ms(torch, fns: dict, rounds: int, calls: int = 1) -> dict:
    """Median device time of each of ``fns`` (name -> callable), one run of
    each per round, in turns, the order reversed every other round.  With
    ``calls`` > 1 each run is that many calls back to back between the two
    events, divided by ``calls``: the host then queues the next call while
    the card runs the last, so the time is the card's alone, without the
    host's launch overhead that a single call on an idle card includes."""
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
            for _ in range(calls):
                fns[name]()
            stop.record()
            stop.synchronize()
            times[name].append(start.elapsed_time(stop) / calls)
    return {name: statistics.median(t) for name, t in times.items()}


def star_footprint(domain: tuple, r: int) -> int:
    """Elements of the halo-padded input that a range-r star over ``domain``
    reads: the domain box and r layers on each of its six faces (the star
    never reaches the padding's edges and corners)."""
    Z, Y, X = domain
    return Z * Y * X + 2 * r * (Y * X + Z * X + Z * Y)


def bound(padded, r: int) -> tuple:
    """Least time (ms) the card needs for one stencil on ``padded``: each
    input element the star reads read once and each output written once at
    the HBM rate, against (6r+1) multiplies + 6r adds per point at the peak
    rate."""
    eb = padded.element_size()
    domain = tuple(n - 2 * r for n in padded.shape)
    pts = domain[0] * domain[1] * domain[2]
    t_bytes = (star_footprint(domain, r) + pts) * eb / HBM_BYTES_PER_S * 1e3
    t_ops = (12 * r + 1) * pts / PEAK_FLOPS[eb] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check(torch, got, want, elem_bytes: int, what: str) -> float:
    """Max abs error of ``got`` against the plain version; raises when the
    shapes differ, a value is not finite, or the tolerance is exceeded."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL[elem_bytes]):
        raise AssertionError(f"{what}: max abs error {err!r} exceeds {TOL[elem_bytes]}")
    return err


def star_conv_weight(torch, weights, r: int):
    """(1, 1, 2r+1, 2r+1, 2r+1) conv3d weight equal to the star's weights on
    its 6r+1 taps and zero elsewhere (conv3d correlates: tap offset s sits at
    index r + s)."""
    k = torch.zeros((2 * r + 1,) * 3, dtype=weights.dtype, device=weights.device)
    k[r, r, r] = weights[0]
    w = 1
    for axis in range(3):
        for o in range(1, r + 1):
            for s in (-o, o):
                idx = [r, r, r]
                idx[axis] += s
                k[tuple(idx)] = weights[w]
                w += 1
    return k.view(1, 1, *k.shape)


def kernel_modules() -> tuple:
    """The wrapper module of every kernel package."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.jacobi2d import kernel as JK
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.transpose_pad import kernel as TK

    return K, LK, JK, TK, MK, FK


def reset_counts() -> None:
    """Every wrapper's launch count to 0, just before a path is driven."""
    for module in kernel_modules():
        module.reset_launch_counts()


RETIME_TOP = 10                          # launches re-timed at 20 repetitions


def rank_vs_card(torch, label: str, ranked, run, n_pts: int, flat: bool = False) -> None:
    """Time every priced launch with ``run(launch)`` (1 warm-up + median of
    5) and print the ranking's quality against the card (the paper's §5.8
    criterion: efficiency of the predicted best, Spearman), the top-ranked
    launch's place, the fastest and slowest launches, and the launches with
    bz = 1 beside those with bz > 1 (on a 2D domain, read as (1, Y, X), a
    bz > 1 launch keeps only its tz = 0 threads busy, which the GPU model
    does not price).  ``ranked`` is the core's ranking of all 168; with
    ``flat`` the quality is printed again over the launches a 2D generator
    keeps (``kernels.fills_depth``).  Then the ``RETIME_TOP`` fastest
    measured launches and the predicted best are timed again (3 warm-ups,
    median of 20), and the predicted best's place is read from those."""
    from repro_torch.core.selector import ranking_quality
    from repro_torch.kernels import fills_depth

    ms = []
    for rc in ranked:
        launch = rc.launch
        ms.append(cuda_ms(torch, lambda: run(launch), warmup=1, reps=5))
    groups = [("", list(range(len(ranked))))]
    if flat:
        groups.append((" kept (z extent 1)",
                       [i for i, rc in enumerate(ranked) if fills_depth(rc.launch)]))
    for name, idx in groups:
        sub, sub_ms = [ranked[i] for i in idx], [ms[i] for i in idx]
        quality = ranking_quality([rc.perf for rc in sub],
                                  [n_pts / (t * 1e-3) for t in sub_ms])
        best_i = min(range(len(sub_ms)), key=sub_ms.__getitem__)
        top_place = 1 + sum(t < sub_ms[0] for t in sub_ms)
        say(f"{label} ranking vs card{name} ({len(sub)} launches): efficiency "
            f"{quality['efficiency']:.4f}, Spearman {quality['spearman']:.4f}; predicted best "
            f"{sub[0].launch.block}/{sub[0].launch.folding} measures {sub_ms[0]:.4f} ms "
            f"(place {top_place}); measured best "
            f"{sub[best_i].launch.block}/{sub[best_i].launch.folding} {sub_ms[best_i]:.4f} ms "
            f"(predicted place {best_i + 1}, {n_pts / sub[best_i].perf * 1e3:.4f} ms "
            f"predicted); slowest {max(sub_ms):.4f} ms")
    for name, keep in (("bz = 1", lambda b: b == 1), ("bz > 1", lambda b: b > 1)):
        group = sorted(t for rc, t in zip(ranked, ms) if keep(rc.launch.block[2]))
        top20 = sum(keep(rc.launch.block[2]) for rc in ranked[:20])
        if group:
            say(f"  {label} {name}: {len(group)} launches ({top20} of the top 20 ranked), "
                f"fastest {group[0]:.4f} ms, median {statistics.median(group):.4f} ms, "
                f"slowest {group[-1]:.4f} ms")
    retime_place(torch, label, ranked, run, ms)


def retime_place(torch, label: str, ranked, run, ms: list) -> int:
    """The predicted best's place among all launches once the ``RETIME_TOP``
    fastest of the 5-run timings ``ms`` and the predicted best itself are
    timed again at 20 repetitions (3 warm-ups): those launches take their
    20-run medians, the rest keep their 5-run ones.  Prints and returns it."""
    top = sorted(range(len(ms)), key=ms.__getitem__)[:RETIME_TOP]
    again = {}
    for i in sorted(set(top) | {0}):
        launch = ranked[i].launch
        again[i] = cuda_ms(torch, lambda: run(launch), warmup=3, reps=20)
    times = [again.get(i, t) for i, t in enumerate(ms)]
    place = 1 + sum(t < times[0] for t in times)
    order = sorted(again, key=again.__getitem__)
    say(f"  {label} re-timed (3 warm-ups, median of 20): the {len(top)} fastest of the "
        f"5-run timings and the predicted best {ranked[0].launch.block}/"
        f"{ranked[0].launch.folding}: it measures {again[0]:.4f} ms (5-run "
        f"{ms[0]:.4f}), place {place} of {len(ms)} (5-run place "
        f"{1 + sum(t < ms[0] for t in ms)}); re-timed fastest "
        + ", ".join(f"{ranked[i].launch.block}/{ranked[i].launch.folding} {again[i]:.4f} ms"
                    f" (predicted place {i + 1})" for i in order[:3]))
    return place


def run_stencil(args, torch, dev) -> list:
    """The stencil path (phases 3-7): rank, main path, edges, z-march
    variants, fp32, times and the ranking against the card.  Returns the
    kernels' records; its tensors are freed when it returns."""
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import best_config, rank_configs
    from repro_torch.kernels.stencil3d25.ops import star_stencil, zmarch_tile
    from repro_torch.kernels.stencil3d25.ref import (
        one_hot_points,
        one_hot_stencil,
        pad_input,
        star_stencil_ref,
        star_weights,
    )

    # 3. the ranking: every launch priced on the H100, nothing run
    t0 = time.perf_counter()
    ranked = rank_configs(R, DOMAIN, 8, H100)
    t_rank = time.perf_counter() - t0
    n_pts = DOMAIN[0] * DOMAIN[1] * DOMAIN[2]
    say(f"ranking: {len(ranked)} launches priced on {H100.name} in {t_rank:.2f} s "
        f"(r={R}, domain {DOMAIN}, fp64)")
    if len(ranked) != 168:
        raise AssertionError(f"expected 168 priced launches, got {len(ranked)}")
    for i, rc in enumerate(ranked[:5]):
        say(f"  #{i + 1} block {rc.launch.block} folding {rc.launch.folding}: "
            f"{rc.perf / 1e9:.2f} GLUP/s predicted ({n_pts / rc.perf * 1e3:.3f} ms), "
            f"{rc.estimate.limiter}-limited")
    for s in ranked.skipped:
        say(f"  skipped {s.config}: {s.reason}")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    w64 = star_weights(R, torch.float64, dev)
    padded = pad_input(src, R)
    kernels = []

    # 4. the main path: star_stencil(config=None) ranks and runs star_pointwise
    best = best_config(R, DOMAIN, 8, H100)
    reset_counts()
    out = star_stencil(src, r=R)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    if launches["star_pointwise"] < 1:
        raise AssertionError(f"main path launched no star_pointwise: {launches}")
    pw = dict(K.LAST_POINTWISE)
    ref64 = star_stencil_ref(padded, w64, R)
    err = check(torch, out, ref64, 8, "star_stencil(config=None) fp64")
    pw_kernel = (f"star_pointwise_kernel<double, {R}, "
                 f"{'int' if pw['offset_bits'] == 32 else 'long'}>")
    say(f"main path: star_stencil(src, r={R}) fp64 at block {best.launch.block} "
        f"folding {best.launch.folding}; launches {launches}; max abs error {err!r} "
        f"(tolerance {TOL[8]}: FMA contraction, same tap order); {pw['offset_bits']}-bit "
        f"offsets, weights from the {pw['weights']}; "
        f"{pw_kernel}: {registers(pw_kernel)}")
    if pw["weights"] != "constant bank":
        raise AssertionError(f"star_pointwise at r={R} took its weights from the {pw['weights']}")
    del out
    kernels.append({"name": "star_pointwise", "config": None,
                    "launches": launches["star_pointwise"], "max_abs_err": err,
                    "replaces": REPLACES["replane"], "source": SOURCE,
                    "offset_bits": pw["offset_bits"], "weights": pw["weights"]})

    # 5. folding and edge coverage at pinned launches on a domain that no
    # block extent divides
    src_e = torch.randn(EDGE_DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    ref_e = star_stencil_ref(pad_input(src_e, R), w64, R)
    w32 = star_weights(R, torch.float32, dev)
    src_e32 = src_e.float()
    ref_e32 = star_stencil_ref(pad_input(src_e32, R), w32, R)
    for block, fold in EDGE_LAUNCHES:
        cfg = {"block": block, "folding": fold}
        e64 = check(torch, star_stencil(src_e, r=R, config=cfg), ref_e, 8, f"edge {cfg} fp64")
        e32 = check(torch, star_stencil(src_e32, r=R, config=cfg), ref_e32, 4,
                    f"edge {cfg} fp32")
        say(f"edge {EDGE_DOMAIN} block {block} folding {fold}: max abs error "
            f"fp64 {e64!r}, fp32 {e32!r}")
    for cfg in ZMARCH_VARIANTS[:1]:
        e64 = check(torch, star_stencil(src_e, r=R, config=cfg), ref_e, 8, f"edge {cfg} fp64")
        say(f"edge {EDGE_DOMAIN} {cfg}: max abs error fp64 {e64!r}")

    # 6. the z-march variants, each through the entry point with its own
    # launch count
    for cfg in ZMARCH_VARIANTS:
        reset_counts()
        out = star_stencil(src, r=R, config=cfg)
        torch.cuda.synchronize()
        launches = dict(K.LAUNCHES)
        if launches["star_zmarch"] < 1:
            raise AssertionError(f"{cfg} launched no star_zmarch: {launches}")
        zm = dict(K.LAST_ZMARCH)
        err = check(torch, out, ref64, 8, f"star_stencil({cfg}) fp64")
        tile = zmarch_tile(cfg, R, DOMAIN, 8)
        zm_kernel = f"star_zmarch_kernel<double, {R}, {K.zmarch_rows(*tile)}>"
        say(f"z-march {cfg} fp64: LAST_ZMARCH {zm}; "
            f"{K.zmarch_smem_bytes(R, *tile, 8, zm['stages'])} B shared memory; launches "
            f"{launches}; max abs error {err!r} (tolerance {TOL[8]}: z taps summed as "
            f"ref.star_stencil_zsum_ref orders them); {zm_kernel}: {registers(zm_kernel)}")
        del out
        name = (f"star_zmarch[ring,{zm['route']}]" if cfg["variant"] == "ring"
                else f"star_zmarch[ytile_ring,ty={cfg['ty']},{zm['route']}]")
        kernels.append({"name": name, "config": cfg,
                        "launches": launches["star_zmarch"], "max_abs_err": err,
                        "replaces": REPLACES[cfg["variant"]], "source": SOURCE,
                        "zmarch_route": zm["route"], "stages": zm["stages"],
                        "threads": zm["threads"], "segments": zm["segments"]})

    # fp32: the main path and every z-march variant at the paper size
    src32 = src.float()
    padded32 = pad_input(src32, R)
    ref32 = star_stencil_ref(padded32, w32, R)
    best32 = best_config(R, DOMAIN, 4, H100)
    for cfg in (None,) + ZMARCH_VARIANTS:
        err = check(torch, star_stencil(src32, r=R, config=cfg), ref32, 4,
                    f"star_stencil({cfg}) fp32")
        say(f"fp32 star_stencil(config={cfg}): max abs error {err!r} (atol 1e-5)"
            + (f"; launch block {best32.launch.block} folding {best32.launch.folding}"
               if cfg is None else ""))

    del src_e, ref_e, src_e32, ref_e32, ref32, ref64
    run_stencil_streams(torch, padded, best.launch, gen)
    run_stencil_wide_range(torch, dev, gen, best.launch)

    # one-hot: a 1 at the centre and r inside each face of the paper's field
    # gives exactly the weights on each star, bit for bit, through the ranked
    # launch and every z-march variant on both routes (the rows of the
    # paper's field are 16-byte multiples, so cp.async is pinned)
    pts = one_hot_points(DOMAIN, R)
    for eb, w in ((8, w64), (4, w32)):
        hot = torch.zeros_like(padded if eb == 8 else padded32)
        for p in pts:
            hot[p] = 1
        want = one_hot_stencil(DOMAIN, R, w, pts)
        runs = {"star_pointwise": lambda: K.star_pointwise(hot, w, R, best.launch)}
        for cfg in ZMARCH_VARIANTS:
            tile = zmarch_tile(cfg, R, DOMAIN, eb)
            for route in K.ZMARCH_ROUTES:
                runs[f"star_zmarch {cfg} {route}"] = (
                    lambda tile=tile, route=route: K.star_zmarch(hot, w, R, *tile, route=route))
        for what, run in runs.items():
            if not torch.equal(run(), want):
                raise AssertionError(f"one-hot fp{eb * 8}: {what} does not give the weights "
                                     f"bit for bit")
        say(f"one-hot fp{eb * 8} at {DOMAIN}, ones at {pts}: {len(runs)} runs "
            f"({', '.join(runs)}) equal the weights on each star bit for bit")
        del hot, want

    # 7. times at the paper size on the pre-padded input
    conv_w = {8: star_conv_weight(torch, w64, R), 4: star_conv_weight(torch, w32, R)}
    inputs = {8: (padded, w64, best), 4: (padded32, w32, best32)}
    lib_ms = {}
    for eb, (pad_x, w, rc) in inputs.items():
        x5 = pad_x.view(1, 1, *pad_x.shape)
        conv = F.conv3d(x5, conv_w[eb])[0, 0]
        conv_err = float((conv - star_stencil_ref(pad_x, w, R)).abs().max())
        del conv
        lib_ms[eb] = cuda_ms(torch, lambda: F.conv3d(x5, conv_w[eb]), warmup=1, reps=5)
        say(f"library F.conv3d ({2 * R + 1}^3 = {(2 * R + 1) ** 3} taps, zero off the star, "
            f"where the stencil does {6 * R + 1}) fp{eb * 8}: {lib_ms[eb]:.4f} ms (median of 5), "
            f"max abs diff to the plain version {conv_err!r} (cudnn.allow_tf32=False)")
    for eb, (pad_x, w, rc) in inputs.items():
        plain = cuda_ms(torch, lambda: star_stencil_ref(pad_x, w, R), warmup=1, reps=5)
        b_ms, b_by = bound(pad_x, R)
        for k in kernels:
            if k["config"] is None:
                launch = rc.launch
                ms = cuda_ms(torch, lambda: K.star_pointwise(pad_x, w, R, launch))
                pred = (f"; predicted {n_pts / rc.perf * 1e3:.4f} ms at block "
                        f"{launch.block} folding {launch.folding}")
            else:
                tile = zmarch_tile(k["config"], R, DOMAIN, eb)
                ms = cuda_ms(torch, lambda: K.star_zmarch(pad_x, w, R, *tile))
                pred = f"; not priced by the GPU model (tile {tile[0]}x{tile[1]})"
            say(f"time {k['name']} fp{eb * 8}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms * 100:.1f}% of bound; plain {plain:.4f} ms (median of 5); "
                f"library {lib_ms[eb]:.4f} ms{pred}")
            if eb == 8:
                k.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
                         library_ms=lib_ms[eb])
    # the ranking against the card: every priced launch of star_pointwise, fp64
    rank_vs_card(torch, "stencil", ranked,
                 lambda launch: K.star_pointwise(padded, w64, R, launch), n_pts)
    call_ms = cuda_ms(torch, lambda: star_stencil(src, r=R))
    say(f"time star_stencil(src, r={R}) fp64 incl. pad: {call_ms:.4f} ms; "
        f"fp32: {cuda_ms(torch, lambda: star_stencil(src32, r=R)):.4f} ms")

    return kernels


def run_stencil_streams(torch, padded, launch, gen) -> None:
    """The constant bank's guard at the paper size: stencils with two sets of
    weights launched in turns on two streams (the ranked per-point launch
    and the ring z-march), each output against the plain version of its own
    weights; every fill of the bank on the other stream waits for the
    bank's last launch."""
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.ref import star_stencil_ref

    eb = padded.element_size()
    ws = [torch.randn(6 * R + 1, dtype=padded.dtype, device=padded.device, generator=gen)
          for _ in range(2)]
    wants = [star_stencil_ref(padded, w, R) for w in ws]
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream())
    runs = {"star_pointwise": lambda w: K.star_pointwise(padded, w, R, launch),
            "star_zmarch ring": lambda w: K.star_zmarch(padded, w, R, *K.ring_tile(R, eb))}
    before = K.bank_counts()
    errs = {}
    for _ in range(STREAM_ROUNDS):
        for name, run in runs.items():
            outs = []
            for j, st in enumerate(streams):
                with torch.cuda.stream(st):
                    outs.append(run(ws[j]))
            torch.cuda.synchronize()
            for j, out in enumerate(outs):
                e = check(torch, out, wants[j], eb, f"{name} on stream {j} of 2")
                errs[name] = max(errs.get(name, 0.0), e)
            del outs
    after = K.bank_counts()
    n = STREAM_ROUNDS * len(runs) * len(streams)
    fills, waits = after["fills"] - before["fills"], after["waits"] - before["waits"]
    if fills != n or waits < n - 1:
        raise AssertionError(f"{n} launches on two streams made {fills} bank fills and {waits} "
                             f"waits")
    say(f"two streams fp{eb * 8} at {DOMAIN}, different weights, {n} launches in turns "
        f"({', '.join(runs)}): each output equals its own weights' plain version (max abs error "
        + ", ".join(f"{k} {v!r}" for k, v in errs.items())
        + f"); constant bank fills {fills}, of which {waits} waited for the other stream")
    del wants


def run_stencil_wide_range(torch, dev, gen, launch) -> None:
    """A range past the constant bank through the entry point: the per-point
    kernel at ``launch`` (r = 4's ranked one: ranking r = WIDE_R takes tens
    of seconds on the host) and a y-tiled z-march at r = WIDE_R, whose
    generic kernels read the weights tensor, against the plain version."""
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.ops import star_stencil
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

    r = WIDE_R
    src = torch.randn(WIDE_DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    want = star_stencil_ref(pad_input(src, r), star_weights(r, torch.float64, dev), r)
    fills = K.bank_counts()["fills"]
    parts = []
    for cfg in ({"block": launch.block, "folding": launch.folding}, WIDE_YTILE):
        out = star_stencil(src, r=r, config=cfg)
        torch.cuda.synchronize()
        err = check(torch, out, want, 8, f"star_stencil(r={r}, config={cfg}) fp64")
        last = K.LAST_POINTWISE if "block" in cfg else K.LAST_ZMARCH
        if last["weights"] != "tensor":
            raise AssertionError(f"r={r} {cfg}: weights from the {last['weights']}")
        parts.append(f"config={cfg}: max abs error {err!r}, {dict(last)}")
        del out
    if K.bank_counts()["fills"] != fills:
        raise AssertionError(f"r={r} filled the constant bank")
    say(f"r={r} fp64 at {WIDE_DOMAIN} ({6 * r + 1} taps, past the constant bank's r <= "
        f"{K.UNROLLED_R}): " + "; ".join(parts) + "; the bank was not filled")


def lbm_bound(pdf_p, phase_p) -> tuple:
    """Least time (ms) the card needs for one LBM step on the padded fields:
    each input element the step reads read once (every PDF pulls one
    Z x Y x X box of its padded field; the phase field's 7-point footprint)
    and each output PDF written once at the HBM rate, against the spec's
    flops per point (``core.specs.lbm_d3q15``) at the peak rate."""
    from repro_torch.core.specs import lbm_d3q15

    eb = pdf_p.element_size()
    domain = tuple(n - 2 for n in phase_p.shape)
    pts = domain[0] * domain[1] * domain[2]
    reads = 15 * pts + star_footprint(domain, 1)
    t_bytes = (reads + 15 * pts) * eb / HBM_BYTES_PER_S * 1e3
    t_ops = lbm_d3q15(domain, eb).flops_per_point * pts / PEAK_FLOPS[eb] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def ytile_line(LK, ring: dict, eb: int) -> str:
    """An ``lbm_ytile`` launch (``LAST_YTILE``) in words: tile, route, ring
    stages and their shared memory, points a thread, CTAs and the output
    planes each marches at most."""
    ty, tx = ring["tile"]
    return (f"tile {ty}x{tx}, route {ring['route']}, {ring['stages']} ring stages "
            f"({LK.ytile_smem_bytes(ty, tx, eb, ring['stages'], ring['route'])} B shared "
            f"memory), "
            f"{ring['points']} points a thread, {ring['ctas']} CTAs of {LK.YTILE_THREADS} "
            f"threads, at most {LK.ytile_slab(LBM_DOMAIN, ty, tx, ring['ctas'])} planes a CTA")


def run_lbm(args, torch, dev) -> list:
    """The LBM path: rank, main path (``lbm_step(config=None)``), edges,
    y-tile variants, fp32, times and the ranking against the card.  Returns
    the kernels' records; its tensors are freed when it returns."""
    from repro_torch.core.machines import H100
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.lbm_d3q15.generator import best_config, rank_configs
    from repro_torch.kernels.lbm_d3q15.ops import lbm_step
    from repro_torch.kernels.lbm_d3q15.ref import WEIGHTS, lbm_step_ref, pad_inputs
    from repro_torch.kernels.stencil3d25 import kernel as K

    # L1. the ranking: every launch of the per-point LBM kernel priced on the H100
    t0 = time.perf_counter()
    ranked = rank_configs(LBM_DOMAIN, 8, H100)
    t_rank = time.perf_counter() - t0
    n_pts = LBM_DOMAIN[0] * LBM_DOMAIN[1] * LBM_DOMAIN[2]
    say(f"lbm ranking: {len(ranked)} launches priced on {H100.name} in {t_rank:.2f} s "
        f"(D3Q15, domain {LBM_DOMAIN}, fp64)")
    if len(ranked) != 168:
        raise AssertionError(f"expected 168 priced LBM launches, got {len(ranked)}")
    for i, rc in enumerate(ranked[:5]):
        say(f"  #{i + 1} block {rc.launch.block} folding {rc.launch.folding}: "
            f"{rc.perf / 1e9:.2f} GLUP/s predicted ({n_pts / rc.perf * 1e3:.4f} ms), "
            f"{rc.estimate.limiter}-limited")
    for s in ranked.skipped:
        say(f"  skipped {s.config}: {s.reason}")

    # the state of tests/test_kernels.py: phase = sigmoid(randn), pdf[q] = w_q * phase;
    # with ``independent``, every PDF is drawn on its own (uniform in [0, 1)), so
    # that a kernel pulling PDF q from another PDF of its weight class shows
    gen = torch.Generator(device=dev).manual_seed(args.seed)

    def state(domain, dtype=torch.float64, independent=False):
        phase = torch.sigmoid(torch.randn(domain, dtype=torch.float64, device=dev,
                                          generator=gen))
        if independent:
            pdf = torch.rand((15, *domain), dtype=torch.float64, device=dev, generator=gen)
        else:
            pdf = torch.stack([w * phase for w in WEIGHTS])
        return pdf.to(dtype), phase.to(dtype)

    pdf, phase = state(LBM_DOMAIN)
    pdf_p, phase_p = pad_inputs(pdf, phase)
    ref_pdf, ref_phase = lbm_step_ref(pdf_p, phase_p)
    kernels = []

    # L2. the main path: lbm_step(config=None) ranks and runs lbm_pointwise
    reset_counts()
    out, out_phase = lbm_step(pdf, phase)
    torch.cuda.synchronize()
    launches = {**K.LAUNCHES, **LK.LAUNCHES}
    ran_at = LK.LAST_LAUNCH["lbm_pointwise"]
    if launches["lbm_pointwise"] < 1:
        raise AssertionError(f"LBM main path launched no lbm_pointwise: {launches}")
    if ran_at != ranked[0].launch:
        raise AssertionError(f"lbm_pointwise ran at {ran_at}, the top-ranked launch is "
                             f"{ranked[0].launch}")
    err = check(torch, out, ref_pdf, 8, "lbm_step(config=None) fp64 PDFs")
    err_phase = check(torch, out_phase, ref_phase, 8, "lbm_step(config=None) fp64 phase")
    say(f"lbm main path: lbm_step(pdf, phase) fp64 at block {ran_at.block} folding "
        f"{ran_at.folding} (top-ranked of {len(ranked)}); launches {launches}; max abs "
        f"error PDFs {err!r}, phase {err_phase!r} (tolerance {TOL[8]})")
    del out, out_phase
    kernels.append({"name": "lbm_pointwise", "config": None, "source": LBM_SOURCE,
                    "launches": launches["lbm_pointwise"], "max_abs_err": err,
                    "replaces": LBM_REPLACES["replane"]})

    # L3. folding and edge coverage at pinned launches on a domain that no
    # block extent divides, and a y-tile whose tiles overhang the edge; then
    # the ranked launch and a y-tile on independent random PDFs
    ranked_cfg = {"block": ranked[0].launch.block, "folding": ranked[0].launch.folding}
    for domain, configs, independent in (
            (LBM_EDGE_DOMAIN, [{"block": b, "folding": f} for b, f in EDGE_LAUNCHES], False),
            (LBM_YTILE_EDGE_DOMAIN, [LBM_YTILE_VARIANTS[0]], False),
            (LBM_YTILE_EDGE_DOMAIN, [ranked_cfg, LBM_YTILE_VARIANTS[0]], True)):
        pdf_e, phase_e = state(domain, independent=independent)
        pdfs = "independent random PDFs" if independent else "pdf[q] = w_q * phase"
        for eb, dtype in ((8, torch.float64), (4, torch.float32)):
            pdf_t, phase_t = pdf_e.to(dtype), phase_e.to(dtype)
            want = lbm_step_ref(*pad_inputs(pdf_t, phase_t))[0]
            errs = [check(torch, lbm_step(pdf_t, phase_t, config=cfg)[0], want, eb,
                          f"lbm edge {domain} {cfg} fp{eb * 8} ({pdfs})") for cfg in configs]
            for cfg, e in zip(configs, errs):
                say(f"lbm edge {domain} {cfg} fp{eb * 8} ({pdfs}): max abs error {e!r}")
        del pdf_e, phase_e, pdf_t, phase_t, want

    # L4. the y-tile variants, each through the entry point with its own
    # launch count; then the other route on the same input
    for cfg in LBM_YTILE_VARIANTS:
        reset_counts()
        out, out_phase = lbm_step(pdf, phase, config=cfg)
        torch.cuda.synchronize()
        launches = {**K.LAUNCHES, **LK.LAUNCHES}
        if launches["lbm_ytile"] < 1:
            raise AssertionError(f"{cfg} launched no lbm_ytile: {launches}")
        ring = dict(LK.LAST_YTILE)
        err = check(torch, out, ref_pdf, 8, f"lbm_step({cfg}) fp64 PDFs")
        err_phase = check(torch, out_phase, ref_phase, 8, f"lbm_step({cfg}) fp64 phase")
        del out, out_phase
        ty, tx = ring["tile"]
        say(f"lbm y-tile {cfg} fp64: {ytile_line(LK, ring, 8)}; launches {launches}; "
            f"max abs error PDFs {err!r}, phase {err_phase!r}")
        other = "cp_async" if ring["route"] == "tma" else "tma"
        if LK.ytile_route(ty, tx, LBM_DOMAIN[2] + 2, 8, phase_p.data_ptr()) == "tma":
            e2 = check(torch, LK._ytile(pdf_p, phase_p, ty, tx, route=other), ref_pdf, 8,
                       f"lbm_ytile {ty}x{tx} fp64 route {other}")
            say(f"lbm y-tile {cfg} fp64 route {other}: max abs error PDFs {e2!r}")
        kernels.append({"name": f"lbm_ytile[ty={cfg['ty']}]", "config": cfg,
                        "source": LBM_SOURCE, "launches": launches["lbm_ytile"],
                        "max_abs_err": err, "replaces": LBM_REPLACES["ytile"],
                        "ytile_fp64": ring})

    # L5. fp32: the main path and both y-tile variants at the paper size
    pdf32, phase32 = pdf.float(), phase.float()
    pdf32_p, phase32_p = pad_inputs(pdf32, phase32)
    ref32 = lbm_step_ref(pdf32_p, phase32_p)
    best32 = best_config(LBM_DOMAIN, 4, H100)
    for cfg in (None,) + LBM_YTILE_VARIANTS:
        got, got_phase = lbm_step(pdf32, phase32, config=cfg)
        err = check(torch, got, ref32[0], 4, f"lbm_step({cfg}) fp32 PDFs")
        err_phase = check(torch, got_phase, ref32[1], 4, f"lbm_step({cfg}) fp32 phase")
        say(f"fp32 lbm_step(config={cfg}): max abs error PDFs {err!r}, phase {err_phase!r}"
            + (f"; launch block {best32.launch.block} folding {best32.launch.folding}"
               if cfg is None else f"; {ytile_line(LK, LK.LAST_YTILE, 4)}"))
        if cfg is not None:
            for k in kernels:
                if k["config"] == cfg:
                    k["ytile_fp32"] = dict(LK.LAST_YTILE)
    del got, got_phase, ref32, ref_pdf, ref_phase

    # L6. times at the paper size on the pre-padded input
    inputs = {8: (pdf, phase, pdf_p, phase_p, ranked[0]),
              4: (pdf32, phase32, pdf32_p, phase32_p, best32)}
    say("lbm library: none (no single PyTorch call computes the collide-and-stream step)")
    for eb, (pdf_x, phase_x, pdf_xp, phase_xp, rc) in inputs.items():
        plain = cuda_ms(torch, lambda: lbm_step_ref(pdf_xp, phase_xp), warmup=1, reps=5)
        b_ms, b_by = lbm_bound(pdf_xp, phase_xp)
        for k in kernels[-3:]:
            if k["config"] is None:
                launch = rc.launch
                ms = cuda_ms(torch, lambda: LK.lbm_pointwise(pdf_xp, phase_xp, launch))
                pred = (f"; predicted {n_pts / rc.perf * 1e3:.4f} ms at block "
                        f"{launch.block} folding {launch.folding} "
                        f"({rc.estimate.limiter}-limited)")
            else:
                tile = LK.ytile_tile(k["config"]["ty"], eb)
                ms = cuda_ms(torch, lambda: LK.lbm_ytile(pdf_xp, phase_xp, *tile))
                pred = (f"; {ytile_line(LK, LK.LAST_YTILE, eb)}; not priced by the GPU "
                        f"model")
            say(f"time {k['name']} fp{eb * 8}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
                f"{b_ms / ms * 100:.1f}% of bound; plain {plain:.4f} ms (median of 5); "
                f"library none{pred}")
            if eb == 8:
                k.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=None)
            else:
                k.update(fp32_ms=ms, fp32_bound_ms=b_ms, fp32_plain_ms=plain)
        new_pdf = lbm_step(pdf_x, phase_x)[0]
        call_ms = cuda_ms(torch, lambda: lbm_step(pdf_x, phase_x))
        pad_ms = cuda_ms(torch, lambda: pad_inputs(pdf_x, phase_x))
        sum_ms = cuda_ms(torch, lambda: new_pdf.sum(0))
        say(f"time lbm_step(pdf, phase) fp{eb * 8} incl. pad and phase sum: {call_ms:.4f} ms; "
            f"of which pad_inputs {pad_ms:.4f} ms, new_pdf.sum(0) {sum_ms:.4f} ms")
        del new_pdf

    # L7. the ranking against the card: every priced launch of lbm_pointwise, fp64
    rank_vs_card(torch, "lbm", ranked,
                 lambda launch: LK.lbm_pointwise(pdf_p, phase_p, launch), n_pts)
    return kernels


def say_skipped(ranked) -> None:
    """Print a 2D generator's skipped decisions, grouped by reason: the
    shared-memory variants by name, the launches deeper than the domain by
    count (``kernels.DEPTH_REASON``)."""
    from repro_torch.kernels import DEPTH_REASON

    by_reason = {}
    for sk in ranked.skipped:
        by_reason.setdefault(sk.reason, []).append(sk.config)
    for reason, configs in by_reason.items():
        what = f"{len(configs)} launches" if reason == DEPTH_REASON else configs
        say(f"  skipped {what}: {reason}")
    if len(by_reason.get(DEPTH_REASON, ())) != 168 - FLAT_LAUNCHES:
        raise AssertionError(f"expected {168 - FLAT_LAUNCHES} launches skipped for depth")


def jacobi_bound(padded) -> tuple:
    """Least time (ms) the card needs for one Jacobi sweep on the padded
    (Y+2, X+2) field: the Y x X box and one halo row and column on each face
    (no corners) read once and the output written once at the HBM rate,
    against the spec's 5 flops per point at the peak rate."""
    eb = padded.element_size()
    Y, X = (n - 2 for n in padded.shape)
    t_bytes = (2 * Y * X + 2 * (Y + X)) * eb / HBM_BYTES_PER_S * 1e3
    t_ops = 5 * Y * X / PEAK_FLOPS[eb] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def jacobi_conv_weight(torch, dtype, device):
    """(1, 1, 3, 3) conv2d weight of the 5-point sweep: wc at the centre, wn
    on the four neighbours, zero in the corners."""
    wc, wn = JACOBI_WEIGHTS
    k = torch.tensor([[0.0, wn, 0.0], [wn, wc, wn], [0.0, wn, 0.0]], dtype=dtype, device=device)
    return k.view(1, 1, 3, 3)


def jacobi_instance(JK, k: dict, eb: int, launch) -> str:
    """``name<args>`` of the instantiation the Jacobi kernel record ``k``
    runs on ``eb``-byte elements: ``jacobi_pointwise`` at ``launch`` (its
    fold rows), or the y-tile at the columns a consumer its launch recorded."""
    T = "double" if eb == 8 else "float"
    if k["config"] is None:
        return f"jacobi_pointwise_kernel<{T}, {JK.pointwise_fold_rows(launch)}>"
    ring = k["ytile_fp64" if eb == 8 else "ytile_fp32"]
    return f"jacobi_ytile_kernel<{T}, {ring['columns']}>"


def jacobi_ring_line(ring: dict) -> str:
    """A ``jacobi_ytile`` launch (``LAST_YTILE``) in words: tile, route, ring
    depth and CTAs."""
    ty, tx = ring["tile"]
    return (f"tile {ty}x{tx}, route {ring['route']}, ring {ring['stages']} slots of "
            f"{ring['rows']} rows ({ring['ring_bytes']} B), {ring['columns']} column(s) a "
            f"consumer, {ring['ctas']} CTAs of {ring['threads']} threads")


def run_jacobi(args, torch, dev) -> list:
    """The Jacobi path: rank, main path (``jacobi_step(src)``), edges, y-tile
    variants, fp32, times and the ranking against the card.  Returns the
    kernels' records; its tensors are freed when it returns."""
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.core.selector import rank_gpu_configs
    from repro_torch.core.specs import stencil_2d5pt
    from repro_torch.kernels.jacobi2d import kernel as JK
    from repro_torch.kernels.jacobi2d.generator import best_config, rank_configs
    from repro_torch.kernels.jacobi2d.ops import jacobi_step
    from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref, pad_input

    # J1. the ranking: every launch of the per-point kernel priced on the H100
    t0 = time.perf_counter()
    ranked = rank_configs(JACOBI_DOMAIN, 8, H100)
    t_rank = time.perf_counter() - t0
    n_pts = JACOBI_DOMAIN[0] * JACOBI_DOMAIN[1]
    say(f"jacobi ranking: {len(ranked)} launches kept, priced on {H100.name} in {t_rank:.2f} s "
        f"(2D 5-point, domain {JACOBI_DOMAIN}, fp64)")
    if len(ranked) != FLAT_LAUNCHES:
        raise AssertionError(f"expected {FLAT_LAUNCHES} kept Jacobi launches, got {len(ranked)}")
    for i, rc in enumerate(ranked[:5]):
        say(f"  #{i + 1} block {rc.launch.block} folding {rc.launch.folding}: "
            f"{rc.perf / 1e9:.2f} GLUP/s predicted ({n_pts / rc.perf * 1e3:.4f} ms), "
            f"{rc.estimate.limiter}-limited")
    say_skipped(ranked)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    src = torch.randn(JACOBI_DOMAIN, dtype=torch.float64, device=dev, generator=gen)
    padded = pad_input(src)
    ref64 = jacobi_padded_ref(padded, JACOBI_WEIGHTS)
    kernels = []

    # J2. the main path: jacobi_step(src) ranks and runs jacobi_pointwise
    reset_counts()
    out = jacobi_step(src, JACOBI_WEIGHTS)
    torch.cuda.synchronize()
    launches = dict(JK.LAUNCHES)
    ran_at = JK.LAST_LAUNCH["jacobi_pointwise"]
    if launches["jacobi_pointwise"] < 1:
        raise AssertionError(f"Jacobi main path launched no jacobi_pointwise: {launches}")
    if ran_at != ranked[0].launch:
        raise AssertionError(f"jacobi_pointwise ran at {ran_at}, the top-ranked launch is "
                             f"{ranked[0].launch}")
    err = check(torch, out, ref64, 8, "jacobi_step(src) fp64")
    pw = dict(JK.LAST_POINTWISE)
    if pw["fold_rows"] != ran_at.folding[1]:
        raise AssertionError(f"the ranked launch {ran_at} ran the fold instance {pw}")
    say(f"jacobi main path: jacobi_step(src) fp64 at block {ran_at.block} folding "
        f"{ran_at.folding} (top-ranked of {len(ranked)}); launches {launches}; max abs "
        f"error {err!r} (tolerance {TOL[8]}); compile-time fold of {pw['fold_rows']} rows")
    del out
    kernels.append({"name": "jacobi_pointwise", "config": None, "source": JACOBI_SOURCE,
                    "launches": launches["jacobi_pointwise"], "max_abs_err": err,
                    "replaces": JACOBI_REPLACES["rowstream"]})

    # J3. folding and edge coverage at pinned launches on a domain that no
    # block extent divides, and a y-tile whose tiles overhang the x edge
    for domain, configs in (
            (JACOBI_EDGE_DOMAIN, [{"block": b, "folding": f} for b, f in EDGE_LAUNCHES]),
            (JACOBI_YTILE_EDGE_DOMAIN, list(JACOBI_YTILE_VARIANTS))):
        src_e = torch.randn(domain, dtype=torch.float64, device=dev, generator=gen)
        for eb, dtype in ((8, torch.float64), (4, torch.float32)):
            src_t = src_e.to(dtype)
            want = jacobi_padded_ref(pad_input(src_t), JACOBI_WEIGHTS)
            for cfg in configs:
                e = check(torch, jacobi_step(src_t, JACOBI_WEIGHTS, cfg), want, eb,
                          f"jacobi edge {domain} {cfg} fp{eb * 8}")
                say(f"jacobi edge {domain} {cfg} fp{eb * 8}: max abs error {e!r}")
        del src_e, src_t, want

    # J4. the y-tile variants, each through the entry point with its own
    # launch count; then fp32 on the main path and both y-tiles
    for cfg in JACOBI_YTILE_VARIANTS:
        reset_counts()
        out = jacobi_step(src, JACOBI_WEIGHTS, cfg)
        torch.cuda.synchronize()
        launches = dict(JK.LAUNCHES)
        if launches["jacobi_ytile"] < 1:
            raise AssertionError(f"{cfg} launched no jacobi_ytile: {launches}")
        err = check(torch, out, ref64, 8, f"jacobi_step({cfg}) fp64")
        ring = dict(JK.LAST_YTILE)
        say(f"jacobi y-tile {cfg} fp64: {jacobi_ring_line(ring)}; launches {launches}; max "
            f"abs error {err!r}")
        del out
        kernels.append({"name": f"jacobi_ytile[ty={cfg['ty']}]", "config": cfg,
                        "source": JACOBI_SOURCE, "launches": launches["jacobi_ytile"],
                        "max_abs_err": err, "replaces": JACOBI_REPLACES["ytile"],
                        "ytile_fp64": ring})
    src32 = src.float()
    padded32 = pad_input(src32)
    ref32 = jacobi_padded_ref(padded32, JACOBI_WEIGHTS)
    best32 = best_config(JACOBI_DOMAIN, 4, H100)
    for i, cfg in enumerate((None,) + JACOBI_YTILE_VARIANTS):
        err = check(torch, jacobi_step(src32, JACOBI_WEIGHTS, cfg), ref32, 4,
                    f"jacobi_step({cfg}) fp32")
        if cfg is None:
            pw = JK.LAST_POINTWISE
            what = (f"launch block {best32.launch.block} folding {best32.launch.folding}, "
                    f"compile-time fold of {pw['fold_rows']} rows")
        else:
            kernels[-3 + i]["ytile_fp32"] = dict(JK.LAST_YTILE)
            what = jacobi_ring_line(JK.LAST_YTILE)
        say(f"fp32 jacobi_step(config={cfg}): max abs error {err!r}; {what}")
    del ref32, ref64

    # J5. times at the paper size on the pre-padded input, three ways: single
    # calls on an idle card (the wrapper's host time before the launch
    # included), in turns, and queued (QUEUED_CALLS back to back: the card's
    # time alone), beside F.conv2d and a copy of the same bytes
    inputs = {8: (src, padded, ranked[0]), 4: (src32, padded32, best32)}
    for eb, (src_x, pad_x, rc) in inputs.items():
        x4 = pad_x.view(1, 1, *pad_x.shape)
        weight = jacobi_conv_weight(torch, pad_x.dtype, dev)
        conv_err = float((F.conv2d(x4, weight)[0, 0]
                          - jacobi_padded_ref(pad_x, JACOBI_WEIGHTS)).abs().max())
        plain = cuda_ms(torch, lambda: jacobi_padded_ref(pad_x, JACOBI_WEIGHTS), warmup=1, reps=5)
        b_ms, b_by = jacobi_bound(pad_x)
        # a copy of a (Y, X) field: what the bound counts, read once and written once
        copy_src = torch.empty(JACOBI_DOMAIN, dtype=pad_x.dtype, device=dev).uniform_()
        copy_dst = torch.empty_like(copy_src)
        launch = rc.launch
        fns = {"jacobi_pointwise": lambda: JK.jacobi_pointwise(pad_x, launch, JACOBI_WEIGHTS)}
        for k in kernels[-2:]:
            tile = JK.ytile_tile(k["config"]["ty"], eb)
            fns[k["name"]] = lambda tile=tile: JK.jacobi_ytile(pad_x, *tile, JACOBI_WEIGHTS)
        fns["F.conv2d"] = lambda: F.conv2d(x4, weight)
        fns["copy"] = lambda: copy_dst.copy_(copy_src)
        single = {name: cuda_ms(torch, fn) for name, fn in fns.items()}
        turns = interleaved_ms(torch, fns, JACOBI_ROUNDS)
        queued = interleaved_ms(torch, fns, JACOBI_ROUNDS, QUEUED_CALLS)
        say(f"jacobi fp{eb * 8} {JACOBI_DOMAIN}: bound {b_ms:.4f} ms ({b_by}); single call / in "
            f"turns ({JACOBI_ROUNDS} rounds) / queued ({QUEUED_CALLS} calls back to back, "
            f"{JACOBI_ROUNDS} rounds); plain {plain:.4f} ms (median of 5); F.conv2d (3x3 weight, "
            f"zero corners, cudnn.allow_tf32=False) max abs diff to the plain version "
            f"{conv_err!r}; {card_line()}")
        for name in fns:
            ms3 = (single[name], turns[name], queued[name])
            say(f"  time {name} fp{eb * 8}: {ms3[0]:.4f} / {ms3[1]:.4f} / {ms3[2]:.4f} ms, "
                + " / ".join(f"{b_ms / t * 100:.1f}" for t in ms3) + "% of bound; queued "
                f"{queued[name] / queued['F.conv2d']:.4f}x F.conv2d, "
                f"{queued[name] / queued['copy']:.4f}x the copy")
        for k in kernels[-3:]:
            ran = jacobi_instance(JK, k, eb, launch)
            if ran not in REGISTERS:
                raise AssertionError(f"ptxas reported no registers for {ran}, the instantiation "
                                     f"{k['name']} fp{eb * 8} ran; it reported "
                                     f"{sorted(n for n in REGISTERS if n.startswith('jacobi'))}")
            if k["config"] is None:
                pred = (f"predicted {n_pts / rc.perf * 1e3:.4f} ms at block {launch.block} "
                        f"folding {launch.folding} ({rc.estimate.limiter}-limited)")
            else:
                pred = "not priced by the GPU model"
            say(f"  {k['name']} fp{eb * 8}: {pred}; {ran}: {registers(ran)}")
            rec = dict(ms=single[k["name"]], in_turns_ms=turns[k["name"]],
                       queued_ms=queued[k["name"]], plain_ms=plain, bound_ms=b_ms,
                       bound_by=b_by, library_ms=single["F.conv2d"],
                       library_in_turns_ms=turns["F.conv2d"],
                       library_queued_ms=queued["F.conv2d"], copy_queued_ms=queued["copy"])
            k.update(rec if eb == 8 else {"fp32_" + key: v for key, v in rec.items()
                                          if key != "bound_by"})
        del copy_src, copy_dst
        call_ms = cuda_ms(torch, lambda: jacobi_step(src_x, JACOBI_WEIGHTS))
        pad_ms = cuda_ms(torch, lambda: pad_input(src_x))
        say(f"time jacobi_step(src) fp{eb * 8} incl. pad: {call_ms:.4f} ms; of which "
            f"pad_input {pad_ms:.4f} ms")

    # J6. the ranking against the card: all 168 launches of jacobi_pointwise as
    # the core prices them, kept and skipped, fp64
    core = rank_gpu_configs(stencil_2d5pt(JACOBI_DOMAIN, 8), H100)
    rank_vs_card(torch, "jacobi", core,
                 lambda launch: JK.jacobi_pointwise(padded, launch, JACOBI_WEIGHTS), n_pts,
                 flat=True)
    return kernels


def check_exact(torch, got, want, what: str) -> float:
    """A transpose only moves data: ``got`` must equal the plain version bit
    for bit; returns the max abs error (0.0)."""
    if got.shape != want.shape or got.dtype != want.dtype or not torch.equal(got, want):
        raise AssertionError(f"{what}: not equal to the plain version "
                             f"(got {tuple(got.shape)} {got.dtype})")
    return float((got - want).abs().max())


def run_transpose(args, torch, dev) -> list:
    """The transpose path: rank, main path (``transpose(x)``), edges, tiled
    variants, fp64, times and the ranking against the card.  Returns the
    kernels' records; its tensors are freed when it returns."""
    from repro_torch.core.machines import H100
    from repro_torch.core.selector import rank_gpu_configs
    from repro_torch.core.specs import transpose_pad
    from repro_torch.kernels.transpose_pad import kernel as TK
    from repro_torch.kernels.transpose_pad.generator import best_config, rank_configs
    from repro_torch.kernels.transpose_pad.ops import transpose
    from repro_torch.kernels.transpose_pad.ref import transpose_ref

    # T1. the ranking: every launch of the per-point kernel priced on the H100
    t0 = time.perf_counter()
    ranked = rank_configs(TRANSPOSE_SHAPE, 4, H100)
    t_rank = time.perf_counter() - t0
    n_pts = TRANSPOSE_SHAPE[0] * TRANSPOSE_SHAPE[1]
    say(f"transpose ranking: {len(ranked)} launches kept, priced on {H100.name} in "
        f"{t_rank:.2f} s (shape {TRANSPOSE_SHAPE}, fp32)")
    if len(ranked) != FLAT_LAUNCHES:
        raise AssertionError(f"expected {FLAT_LAUNCHES} kept transpose launches, "
                             f"got {len(ranked)}")
    for i, rc in enumerate(ranked[:5]):
        say(f"  #{i + 1} block {rc.launch.block} folding {rc.launch.folding}: "
            f"{rc.perf / 1e9:.2f} G elements/s predicted ({n_pts / rc.perf * 1e3:.4f} ms), "
            f"{rc.estimate.limiter}-limited")
    say_skipped(ranked)
    big = (2 * TRANSPOSE_SHAPE[0], 2 * TRANSPOSE_SHAPE[1])
    top_big = rank_configs(big, 4, H100)[0]
    say(f"  at {big} fp32 the top-ranked launch {top_big.launch.block}/"
        f"{top_big.launch.folding} is predicted at {big[0] * big[1] / top_big.perf * 1e3:.4f} ms "
        f"({top_big.estimate.limiter}-limited); its byte bound is "
        f"{2 * big[0] * big[1] * 4 / HBM_BYTES_PER_S * 1e3:.4f} ms")

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn(TRANSPOSE_SHAPE, dtype=torch.float32, device=dev, generator=gen)
    want = transpose_ref(x)
    kernels = []

    # T2. the main path: transpose(x) ranks and runs transpose_pointwise
    reset_counts()
    out = transpose(x)
    torch.cuda.synchronize()
    launches = dict(TK.LAUNCHES)
    ran_at = TK.LAST_LAUNCH["transpose_pointwise"]
    if launches["transpose_pointwise"] < 1:
        raise AssertionError(f"transpose main path launched no transpose_pointwise: {launches}")
    if ran_at != ranked[0].launch or ran_at.block[2] * ran_at.folding[2] != 1:
        raise AssertionError(f"transpose_pointwise ran at {ran_at}, the top-ranked launch is "
                             f"{ranked[0].launch}; both must have a z extent of 1")
    err = check_exact(torch, out, want, "transpose(x) fp32")
    say(f"transpose main path: transpose(x) fp32 at block {ran_at.block} folding "
        f"{ran_at.folding} (top-ranked of {len(ranked)}; "
        f"{ran_at.block[0] * ran_at.block[1]} of its {ran_at.threads} threads have points); "
        f"launches {launches}; equal to the plain version (max abs error {err!r})")
    del out
    kernels.append({"name": "transpose_pointwise", "config": None, "source": TRANSPOSE_SOURCE,
                    "launches": launches["transpose_pointwise"], "max_abs_err": err,
                    "replaces": TRANSPOSE_REPLACES})

    # T3. folding and edge coverage at pinned launches and both tiles on a
    # non-square shape with no side a multiple of 32
    x_e = torch.randn(TRANSPOSE_EDGE_SHAPE, dtype=torch.float64, device=dev, generator=gen)
    configs = [{"block": b, "folding": f} for b, f in EDGE_LAUNCHES] + list(TRANSPOSE_TILES)
    for dtype in (torch.float32, torch.float64):
        x_t = x_e.to(dtype)
        want_e = transpose_ref(x_t)
        for cfg in configs:
            check_exact(torch, transpose(x_t, cfg), want_e, f"transpose edge {cfg} {dtype}")
        say(f"transpose edge {TRANSPOSE_EDGE_SHAPE} {dtype}: equal to the plain version at "
            f"{configs}")
    del x_e, x_t, want_e

    # T4. the tiled variants, each through the entry point with its own
    # launch count; then fp64 on the main path and both tiles
    for cfg in TRANSPOSE_TILES:
        reset_counts()
        out = transpose(x, cfg)
        torch.cuda.synchronize()
        launches = dict(TK.LAUNCHES)
        if launches["transpose_tiled"] < 1:
            raise AssertionError(f"{cfg} launched no transpose_tiled: {launches}")
        err = check_exact(torch, out, want, f"transpose({cfg}) fp32")
        say(f"transpose tiled {cfg} fp32: launches {launches}; equal to the plain version")
        del out
        kernels.append({"name": f"transpose_tiled[{cfg['bm']}x{cfg['bn']}]", "config": cfg,
                        "source": TRANSPOSE_SOURCE, "launches": launches["transpose_tiled"],
                        "max_abs_err": err, "replaces": TRANSPOSE_REPLACES})
    x64 = x.double()
    want64 = transpose_ref(x64)
    best64 = best_config(TRANSPOSE_SHAPE, 8, H100)
    for cfg in (None,) + TRANSPOSE_TILES:
        check_exact(torch, transpose(x64, cfg), want64, f"transpose({cfg}) fp64")
        say(f"fp64 transpose(config={cfg}): equal to the plain version"
            + (f"; launch block {best64.launch.block} folding {best64.launch.folding}"
               if cfg is None else ""))
    del want, want64

    # T5. times at the paper size; the plain version, x.mT.contiguous(), is
    # PyTorch's own copy kernel and so also the library call
    for eb, (x_x, rc) in {4: (x, ranked[0]), 8: (x64, best64)}.items():
        plain = cuda_ms(torch, lambda: transpose_ref(x_x))
        b_ms = 2 * x_x.numel() * eb / HBM_BYTES_PER_S * 1e3
        for k in kernels[-3:]:
            if k["config"] is None:
                launch = rc.launch
                ms = cuda_ms(torch, lambda: TK.transpose_pointwise(x_x, launch))
                pred = (f"; predicted {n_pts / rc.perf * 1e3:.4f} ms at block "
                        f"{launch.block} folding {launch.folding} "
                        f"({rc.estimate.limiter}-limited)")
            else:
                bm, bn = k["config"]["bm"], k["config"]["bn"]
                ms = cuda_ms(torch, lambda: TK.transpose_tiled(x_x, bm, bn))
                pred = "; not priced by the GPU model"
            say(f"time {k['name']} fp{eb * 8}: {ms:.4f} ms, bound {b_ms:.4f} ms (bytes), "
                f"{b_ms / ms * 100:.1f}% of bound; plain = library x.mT.contiguous() "
                f"{plain:.4f} ms{pred}")
            if eb == 4:
                k.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by="bytes",
                         library_ms=plain)
        call_ms = cuda_ms(torch, lambda: transpose(x_x))
        say(f"time transpose(x) fp{eb * 8}: {call_ms:.4f} ms")
    # rule 2 orders redesigns by kernel / library time, compared in turns
    turns = {}
    for eb, (x_x, rc) in {8: (x64, best64), 4: (x, ranked[0])}.items():
        turns[eb] = interleaved_ms(torch, {
            "kernel": lambda: TK.transpose_pointwise(x_x, rc.launch),
            "library": lambda: transpose_ref(x_x)}, rounds=TRANSPOSE_ROUNDS)
        say(f"transpose_pointwise fp{eb * 8} at the kept top launch {rc.launch.block}/"
            f"{rc.launch.folding} in turns ({TRANSPOSE_ROUNDS} rounds) against "
            f"x.mT.contiguous(): {turns[eb]['kernel']:.4f} against {turns[eb]['library']:.4f} "
            f"ms, factor {turns[eb]['kernel'] / turns[eb]['library']:.4f} (above 1: slower than "
            f"the library); {card_line()}")
    kernels[0].update(in_turns_ms=turns[4]["kernel"], library_in_turns_ms=turns[4]["library"],
                      fp64_in_turns_ms=turns[8]["kernel"],
                      fp64_library_in_turns_ms=turns[8]["library"])
    del x64

    # T6. the ranking against the card: all 168 launches of transpose_pointwise
    # as the core prices them, kept and skipped, fp32
    core = rank_gpu_configs(transpose_pad(TRANSPOSE_SHAPE, 4), H100)
    rank_vs_card(torch, "transpose", core,
                 lambda launch: TK.transpose_pointwise(x, launch), n_pts, flat=True)
    return kernels


def bf16_bound(flops: float, n_bytes: float, fp32_flops: float = 0.0) -> tuple:
    """Least time (ms) for work of ``flops`` bf16 operations (and
    ``fp32_flops`` fp32 ones outside the tensor cores, TF32 being off)
    moving ``n_bytes``: the larger of the operations' and the HBM time."""
    t_ops = (flops / PEAK_BF16_FLOPS + fp32_flops / PEAK_FLOPS[4]) * 1e3
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def check_close(torch, got, want, what: str, rtol: float, atol: float) -> float:
    """Max abs error of ``got`` against the plain version in fp32; raises when
    the shapes or dtypes differ, a value is not finite, or the tolerance is
    exceeded."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{what}: got {tuple(got.shape)} {got.dtype}, "
                             f"want {tuple(want.shape)} {want.dtype}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not torch.allclose(g, w, rtol=rtol, atol=atol):
        raise AssertionError(f"{what}: max abs error {err!r} exceeds rtol {rtol}, atol {atol}")
    return err


def check_flash(torch, got, want, what: str, elem_bytes: int) -> tuple:
    """(max abs error, max row relative error) of an attention output
    against the plain version; raises unless both FLASH_TOL and
    FLASH_ROW_REL hold."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    err = check_close(torch, got, want, what, **FLASH_TOL[elem_bytes])
    rel = row_rel_err(got, want)
    if rel > FLASH_ROW_REL[elem_bytes]:
        raise AssertionError(f"{what}: row relative error {rel!r} exceeds "
                             f"{FLASH_ROW_REL[elem_bytes]}")
    return err, rel


def check_rejects(torch, wrong, want, what: str, elem_bytes: int) -> str:
    """Raise unless FLASH_ROW_REL rejects ``wrong``, an output computed with
    one KV block left out; report what each bound reads on it."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    rel = row_rel_err(wrong, want)
    if rel <= FLASH_ROW_REL[elem_bytes]:
        raise AssertionError(f"{what}: row bound {FLASH_ROW_REL[elem_bytes]} passes an output "
                             f"missing a KV block (row relative error {rel!r})")
    g, w = wrong.float(), want.float()
    verdict = "passes" if torch.allclose(g, w, **FLASH_TOL[elem_bytes]) else "rejects"
    return (f"{what}: max abs difference {float((g - w).abs().max())!r} ({FLASH_TOL[elem_bytes]} "
            f"{verdict} it), row relative error {rel!r} (the row bound "
            f"{FLASH_ROW_REL[elem_bytes]} rejects it)")


def run_matmuls(args, torch, dev) -> list:
    """The GEMMs of one granite-3-2b layer at T tokens through
    ``tuned_matmul`` (the main path, every launch counted), each against
    ``matmul_ref``; the second tile through its pinned config; fp32 and
    ragged shapes; times beside the bound, the plain version, ``torch.matmul``
    and the suite's CUDA-core price."""
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.matmul.generator import DEFAULT, SUITE_GPU_BLOCKS, TILES, suite_price
    from repro_torch.kernels.matmul.ops import tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.layers.shapes import attention_proj_shapes, mlp_shapes

    proj = attention_proj_shapes(CONFIG.d_model, CONFIG.n_heads, CONFIG.n_kv,
                                 CONFIG.resolved_head_dim)
    mlp = mlp_shapes(CONFIG.d_model, CONFIG.d_ff, CONFIG.mlp)
    gemms = [("qkv", proj["qkv"], 1), ("out", proj["out"], 1),
             ("mlp.in", *mlp["in"]), ("mlp.out", *mlp["out"])]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    x = torch.randn((T_TOKENS, max(k for _, (k, _), _ in gemms)), device=dev, generator=gen)
    operands = {}
    for name, (k, n), mult in gemms:
        w = torch.randn((k, n), device=dev, generator=gen) * k ** -0.5
        operands[name] = (x[:, :k].contiguous().bfloat16(), w.bfloat16().contiguous(), mult)
    del x
    say(f"matmul: granite-3-2b ({CONFIG.d_model} wide, d_ff {CONFIG.d_ff}) GEMMs of one layer "
        f"at T = {T_TOKENS} tokens, bf16; bound = max(flops / {PEAK_BF16_FLOPS / 1e12:.0f} "
        f"TFLOP/s, bytes / {HBM_BYTES_PER_S / 1e12:.2f} TB/s), the dense bf16 and HBM rates "
        f"of the H100 SXM data sheet (NVIDIA), the card named by `{card_line()}`")
    default = (DEFAULT[2]["bm"], DEFAULT[2]["bn"], DEFAULT[2]["bk"])
    tiles = [(t["bm"], t["bn"], t["bk"]) for t in TILES[2]]

    # M1. the main path: tuned_matmul on every GEMM of the layer (mlp.in twice)
    reset_counts()
    outs = {name: [tuned_matmul(a, b) for _ in range(mult)] for name, (a, b, mult) in operands.items()}
    torch.cuda.synchronize()
    launches = dict(MK.LAUNCHES)
    n_calls = sum(mult for _, _, mult in operands.values())
    if launches != {"matmul_tiled": n_calls, "matmul_split_b": 0} or \
            MK.LAST_LAUNCH["matmul_tiled"] != ("wgmma", default):
        raise AssertionError(f"matmul main path: launches {launches}, last "
                             f"{MK.LAST_LAUNCH['matmul_tiled']}; want {n_calls} at {default}")
    plain = {name: matmul_ref(a, b) for name, (a, b, _) in operands.items()}
    errs = {name: max(check_close(torch, o, plain[name], f"tuned_matmul {name} bf16", **GEMM_TOL[2])
                      for o in outs[name]) for name in operands}
    say(f"matmul main path: tuned_matmul at tile {default} on {list(operands)}; launches "
        f"{launches}; max abs error {errs} (rtol/atol {GEMM_TOL[2]})")
    del outs
    records = {default: {"name": f"matmul_tiled[{'x'.join(map(str, default))}]",
                         "launches": launches["matmul_tiled"], "max_abs_err": max(errs.values())}}

    # M2. the other tile through its pinned config, with its own launch count
    for tile in tiles:
        if tile == default:
            continue
        cfg = dict(zip(("bm", "bn", "bk"), tile))
        reset_counts()
        outs = {name: [tuned_matmul(a, b, cfg) for _ in range(mult)]
                for name, (a, b, mult) in operands.items()}
        torch.cuda.synchronize()
        launches = dict(MK.LAUNCHES)
        if launches != {"matmul_tiled": n_calls, "matmul_split_b": 0} or \
                MK.LAST_LAUNCH["matmul_tiled"] != ("wgmma", tile):
            raise AssertionError(f"{cfg}: launches {launches}")
        err = max(check_close(torch, o, plain[name], f"tuned_matmul {name} {cfg}", **GEMM_TOL[2])
                  for name in operands for o in outs[name])
        say(f"matmul tile {tile}: launches {launches}; max abs error {err!r}")
        del outs
        records[tile] = {"name": f"matmul_tiled[{'x'.join(map(str, tile))}]",
                         "launches": launches["matmul_tiled"], "max_abs_err": err}

    # M2b. a config of the reference's space runs the dtype's default tile
    a, b, _ = operands["out"]
    for dtype in (torch.bfloat16, torch.float32):
        ad, bd = a.to(dtype), b.to(dtype)
        eb = ad.element_size()
        ran = (MK.ROUTE[eb], tuple(DEFAULT[eb][key] for key in ("bm", "bn", "bk")))
        reset_counts()
        got = tuned_matmul(ad, bd, MATMUL_REFERENCE_CONFIG)
        torch.cuda.synchronize()
        if MK.LAUNCHES["matmul_tiled"] != 1 or MK.LAST_LAUNCH["matmul_tiled"] != ran:
            raise AssertionError(f"reference config {MATMUL_REFERENCE_CONFIG} {dtype}: launches "
                                 f"{dict(MK.LAUNCHES)}, ran {MK.LAST_LAUNCH['matmul_tiled']}")
        err = check_close(torch, got, matmul_ref(ad, bd), f"tuned_matmul out {dtype} "
                          f"{MATMUL_REFERENCE_CONFIG}", **GEMM_TOL[eb])
        say(f"matmul reference config {MATMUL_REFERENCE_CONFIG} on out {tuple(ad.shape)} x "
            f"{tuple(bd.shape)} {dtype}: ran {ran}; max abs error {err!r} ({GEMM_TOL[eb]})")
        del ad, bd, got

    # M3. both dtypes on ragged shapes (the fp32 main path is run_matmul_fp32)
    for shape in MATMUL_EDGE_SHAPES:
        for dtype in (torch.bfloat16, torch.float32):
            a = torch.randn(shape[:2], device=dev, generator=gen).to(dtype)
            b = (torch.randn(shape[1:], device=dev, generator=gen) * shape[1] ** -0.5).to(dtype)
            want = matmul_ref(a, b)
            for tile in MK.TILES[a.element_size()]:
                check_close(torch, MK.matmul_tiled(a, b, *tile), want,
                            f"matmul_tiled edge {shape} {dtype} {tile}",
                            **GEMM_TOL[a.element_size()])
        say(f"matmul edge {shape} (no tile divides it): every tile within tolerance in bf16 "
            f"and fp32")
    a = torch.randn(MATMUL_MANY_TILES[:2], device=dev, generator=gen).bfloat16()
    b = (torch.randn(MATMUL_MANY_TILES[1:], device=dev, generator=gen)
         * MATMUL_MANY_TILES[1] ** -0.5).bfloat16()
    want = matmul_ref(a, b)
    parts = []
    for tile in tiles:
        err = check_close(torch, MK.matmul_tiled(a, b, *tile), want,
                          f"matmul_tiled many tiles {MATMUL_MANY_TILES} {tile}", **GEMM_TOL[2])
        n_tiles = -(-a.shape[0] // tile[0]) * -(-b.shape[1] // tile[1])
        parts.append(f"{tile}: {n_tiles} tiles, max abs error {err!r}")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    say(f"matmul many tiles {MATMUL_MANY_TILES} bf16 on {sms} SMs: {'; '.join(parts)}")
    del a, b, want

    # M4. times of each GEMM at each tile, beside its bound, plain, library and price
    totals = {tile: 0.0 for tile in tiles}
    plain_total = lib_total = bound_total = 0.0
    by_total = {"bytes": 0.0, "operations": 0.0}
    for name, (a, b, mult) in operands.items():
        M, K = a.shape
        N = b.shape[1]
        b_ms, b_by = bf16_bound(2.0 * M * K * N, (M * K + K * N + M * N) * 2)
        plain_ms = cuda_ms(torch, lambda: matmul_ref(a, b), warmup=1, reps=5)
        lib_ms = cuda_ms(torch, lambda: torch.matmul(a, b))
        t0 = time.perf_counter()
        price = suite_price(M, K, N, 2)[0]
        t_price = time.perf_counter() - t0
        price_ms = M * K * N / price.perf * 1e3
        parts = []
        for tile in tiles:
            ms = cuda_ms(torch, lambda: MK.matmul_tiled(a, b, *tile))
            totals[tile] += mult * ms
            parts.append(f"{tile} {ms:.4f} ms ({2.0 * M * K * N / ms / 1e9:.1f} TFLOP/s, "
                         f"{b_ms / ms * 100:.1f}% of bound)")
        plain_total += mult * plain_ms
        lib_total += mult * lib_ms
        bound_total += mult * b_ms
        by_total[b_by] += mult * b_ms
        say(f"time matmul {name} {M}x{K}x{N} (x{mult}, {2.0 * M * K * N / 1e12:.3f} TFLOP): "
            f"{'; '.join(parts)}; bound {b_ms:.4f} ms ({b_by}); plain {plain_ms:.4f} ms; "
            f"library torch.matmul {lib_ms:.4f} ms; the suite's H100 price of matmul_naive at "
            f"its best of {len(SUITE_GPU_BLOCKS)} blocks, {price.launch.block}: "
            f"{price_ms:.4f} ms ({price.estimate.limiter}-limited, priced in {t_price:.2f} s; a "
            f"per-point CUDA-core model priced against a tiled tensor-core kernel, not a "
            f"prediction of it)")
    # M5. the five GEMMs as one batch, the tiles and torch.matmul in turns
    # (10 rounds, the order reversed every other round): the card slows
    # under sustained tensor-core load, so only turns compare them fairly
    def layer(fn):
        return lambda: [fn(a, b) for a, b, mult in operands.values() for _ in range(mult)]

    batches = {tile: layer(lambda a, b, t=tile: MK.matmul_tiled(a, b, *t)) for tile in tiles}
    batches["torch.matmul"] = layer(torch.matmul)
    turns = interleaved_ms(torch, batches, rounds=10)
    say(f"time the layer's {n_calls} GEMMs in turns (median of 10 rounds, each one batch): "
        + "; ".join(f"{k} {v:.4f} ms" for k, v in turns.items())
        + f"; bound {bound_total:.4f} ms; {card_line()}")
    kernels = []
    bound_by = max(by_total, key=by_total.get)
    for tile in tiles:
        say(f"time matmul_tiled {tile} over the layer's {n_calls} GEMMs: {totals[tile]:.4f} ms, "
            f"bound {bound_total:.4f} ms ({bound_by}), plain {plain_total:.4f} ms, library "
            f"{lib_total:.4f} ms")
        kernels.append({**records[tile], "config": dict(zip(("bm", "bn", "bk"), tile)),
                        "source": MATMUL_SOURCE, "replaces": MATMUL_REPLACES,
                        "ms": totals[tile], "plain_ms": plain_total, "bound_ms": bound_total,
                        "bound_by": bound_by, "library_ms": lib_total})
    return kernels


def gemm_errors(torch, got, exact) -> tuple:
    """(RMS, max abs) of ``got`` against the fp64 product ``exact``."""
    d = got.double() - exact
    return float(d.pow(2).mean().sqrt()), float(d.abs().max())


def tf32_matmul(torch, a, b):
    """``torch.matmul`` with TF32 allowed (one TF32 pass), the flag restored."""
    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        return torch.matmul(a, b)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def run_matmul_fp32(args, torch, dev) -> list:
    """The layer's out GEMM in fp32 through ``tuned_matmul`` (the main path:
    the split pass and the split-TF32 GEMM, each launch counted), operands
    drawn in fp32: a value drawn in bf16 is exact in TF32, so one TF32 pass
    would pass a check on it.  The kernel is held to ``matmul_ref`` within
    GEMM_TOL and to an fp64 product within F32_GATE times the error of
    ``torch.matmul`` with TF32 off, a gate shown to reject a one-pass TF32
    product; the split pass bit for bit against ``ref.split_tf32``; the
    other tile, a K tail; times beside both bounds, the plain version and
    ``torch.matmul``, in turns."""
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.matmul.generator import DEFAULT
    from repro_torch.kernels.matmul.ops import tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref, split_tf32
    from repro_torch.layers.shapes import attention_proj_shapes

    K, N = attention_proj_shapes(CONFIG.d_model, CONFIG.n_heads, CONFIG.n_kv,
                                 CONFIG.resolved_head_dim)["out"]
    M = T_TOKENS
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    a = torch.randn((M, K), device=dev, generator=gen)
    b = torch.randn((K, N), device=dev, generator=gen) * K ** -0.5
    default = (DEFAULT[4]["bm"], DEFAULT[4]["bn"], DEFAULT[4]["bk"])
    flops = 2.0 * M * K * N
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = (M * K + K * N + M * N) * 4 / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    cc_ms = flops / PEAK_FLOPS[4] * 1e3
    say(f"matmul fp32: the out GEMM {M}x{K}x{N}, operands drawn in fp32; bound "
        f"{b_ms:.4f} ms ({b_by}: three TF32 passes at {PEAK_TF32_FLOPS / 1e12:.1f} TFLOP/s, "
        f"the bytes {t_bytes:.4f} ms at {HBM_BYTES_PER_S / 1e12:.2f} TB/s); one fp32 pass on "
        f"the CUDA cores at {PEAK_FLOPS[4] / 1e12:.0f} TFLOP/s: {cc_ms:.4f} ms")

    want = matmul_ref(a, b)  # torch.matmul in fp32, TF32 off
    exact = a.double() @ b.double()
    off = gemm_errors(torch, want, exact)
    one = gemm_errors(torch, tf32_matmul(torch, a, b), exact)
    gate = tuple(F32_GATE * e for e in off)
    if one[0] <= gate[0] and one[1] <= gate[1]:
        raise AssertionError(f"the {F32_GATE}x error gate {gate} passes a one-pass TF32 product "
                             f"(RMS, max abs {one})")
    records = {}
    for tile in MK.TILES[4]:
        cfg = None if tile == default else dict(zip(("bm", "bn", "bk"), tile))
        reset_counts()
        got = tuned_matmul(a, b, cfg)
        torch.cuda.synchronize()
        launches = dict(MK.LAUNCHES)
        if launches != {"matmul_tiled": 1, "matmul_split_b": 1} or \
                MK.LAST_LAUNCH["matmul_tiled"] != ("split_tf32", tile):
            raise AssertionError(f"matmul fp32 {cfg}: launches {launches}, last "
                                 f"{MK.LAST_LAUNCH['matmul_tiled']}")
        err = check_close(torch, got, want, f"tuned_matmul out fp32 {cfg}", **GEMM_TOL[4])
        errs = gemm_errors(torch, got, exact)
        del got
        if errs[0] > gate[0] or errs[1] > gate[1]:
            raise AssertionError(f"matmul_split_tf32 {tile}: error against fp64 (RMS, max abs) "
                                 f"{errs} exceeds {F32_GATE}x torch.matmul's (TF32 off) {off}")
        say(f"matmul fp32 {'main path' if cfg is None else 'tile'}: tuned_matmul(config={cfg}) "
            f"ran split_tf32 at {tile}; launches {launches}; max abs error against matmul_ref "
            f"{err!r} ({GEMM_TOL[4]}); against fp64, RMS and max abs: kernel {errs[0]!r}, "
            f"{errs[1]!r}; torch.matmul TF32 off {off[0]!r}, {off[1]!r} "
            f"({errs[0] / off[0]:.3f}x, {errs[1] / off[1]:.3f}x; the gate is {F32_GATE}x); one "
            f"TF32 pass (torch.matmul, allow_tf32=True) {one[0]!r}, {one[1]!r} "
            f"({one[0] / off[0]:.1f}x, {one[1] / off[1]:.1f}x: the gate rejects it)")
        records[tile] = {"name": f"matmul_split_tf32[{'x'.join(map(str, tile))}]",
                         "config": dict(zip(("bm", "bn", "bk"), tile)),
                         "launches": launches["matmul_tiled"], "max_abs_err": err,
                         "split_b_launches": launches["matmul_split_b"]}
    del exact, want

    # the split pass, bit for bit against its plain version
    hi, lo = MK.split_b(b)
    phi, plo = split_tf32(b.mT)
    torch.cuda.synchronize()
    for got, plain, part in ((hi, phi, "hi"), (lo, plo, "lo")):
        if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
            raise AssertionError(f"matmul_split_b {part} differs from ref.split_tf32")
    del phi, plo
    say(f"matmul_split_b of B {tuple(b.shape)}: hi and lo ({N}, {K}) equal ref.split_tf32(b.mT) "
        f"bit for bit")
    tail = tuple(MATMUL_F32_TAIL)
    ta = torch.randn(tail[:2], device=dev, generator=gen)
    tb = torch.randn(tail[1:], device=dev, generator=gen) * tail[1] ** -0.5
    for tile in MK.TILES[4]:
        check_close(torch, MK.matmul_tiled(ta, tb, *tile), matmul_ref(ta, tb),
                    f"matmul_tiled fp32 K tail {tail} {tile}", **GEMM_TOL[4])
    say(f"matmul fp32 K tail {tail} (K % 32 = {tail[1] % 32}): every tile within {GEMM_TOL[4]}")
    del ta, tb

    # times: the GEMM alone on B's parts, the split pass alone, the call,
    # torch.matmul with TF32 off (the yardstick) and on (context)
    plain_ms = cuda_ms(torch, lambda: matmul_ref(a, b), warmup=1, reps=5)
    lib_ms = cuda_ms(torch, lambda: torch.matmul(a, b))
    tf32_ms = cuda_ms(torch, lambda: tf32_matmul(torch, a, b))
    split_ms = cuda_ms(torch, lambda: MK.split_b(b))
    split_plain = cuda_ms(torch, lambda: split_tf32(b.mT), warmup=1, reps=5)
    split_bound = (K * N * 4 + 2 * N * K * 4) / HBM_BYTES_PER_S * 1e3
    gemms = {records[t]["name"]: (lambda t=t: MK.split_tf32_gemm(a, hi, lo, t))
             for t in MK.TILES[4]}
    call = lambda: MK.matmul_tiled(a, b, *default)
    turns = interleaved_ms(torch, {**gemms, "matmul_tiled call": call,
                                   "torch.matmul": lambda: torch.matmul(a, b)}, rounds=10)
    call_ms = cuda_ms(torch, call)
    kernels = []
    for tile in MK.TILES[4]:
        rec = records[tile]
        ms = cuda_ms(torch, gemms[rec["name"]])
        rec.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms,
                   in_turns_ms=turns[rec["name"]], library_in_turns_ms=turns["torch.matmul"],
                   source=MATMUL_SOURCE, replaces=MATMUL_REPLACES)
        say(f"time {rec['name']} (the GEMM alone): {ms:.4f} ms ({flops / ms / 1e9:.1f} TFLOP/s "
            f"of fp32 product, {b_ms / ms * 100:.1f}% of the three-pass bound, "
            f"{cc_ms / ms:.2f}x the CUDA cores' ceiling rate); in turns {rec['in_turns_ms']:.4f} "
            f"against torch.matmul (TF32 off) {turns['torch.matmul']:.4f} ms "
            f"({rec['in_turns_ms'] / turns['torch.matmul']:.4f}x)")
        kernels.append(rec)
    say(f"time matmul fp32 out GEMM: the call matmul_tiled (split pass + GEMM) {call_ms:.4f} ms, "
        f"in turns {turns['matmul_tiled call']:.4f}; split pass alone {split_ms:.4f} ms (byte "
        f"bound {split_bound:.4f} ms, plain {split_plain:.4f} ms); plain {plain_ms:.4f} ms "
        f"(median of 5); library torch.matmul (allow_tf32=False) {lib_ms:.4f} ms; one TF32 pass "
        f"(allow_tf32=True, context, not a yardstick: it gives up fp32's accuracy) "
        f"{tf32_ms:.4f} ms; {card_line()}")
    kernels.append({"name": "matmul_split_b", "launches": records[default]["split_b_launches"],
                    "max_abs_err": 0.0, "ms": split_ms, "plain_ms": split_plain,
                    "bound_ms": split_bound, "bound_by": "bytes", "library_ms": None,
                    "source": MATMUL_SOURCE, "replaces": MATMUL_REPLACES})
    return kernels


def attention_bound(B, Hq, Hkv, Sq, Skv, D, causal, elem_bytes) -> tuple:
    """Least time (ms) for one attention call: q, k, v read once and o written
    once at the HBM rate, against 4·D operations (QK^T and PV) for every
    (query, key) pair the mask keeps at the bf16 tensor-core rate (the
    exponentials are not counted)."""
    off = Skv - Sq
    pairs = sum(max(0, min(Skv, i + off + 1)) for i in range(Sq)) if causal else Sq * Skv
    flops = 4.0 * D * B * Hq * pairs
    n_bytes = (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D) * elem_bytes
    return bf16_bound(flops, n_bytes) + (flops,)


def exp_floor(B, Hq, S, bq, bk, torch) -> tuple:
    """The exponentials the forward computes at tile (bq, bk) on a causal
    prefill of S (whole diagonal blocks, one per score, plus one correction
    per row and block), the causal triangle's own count, and the least time
    (ms) the card's MUFU units need for them at 16 ex2 a clock per SM, at
    the SM clock that ``nvidia-smi`` reads now and at its maximum."""
    blocks = sum(min(S // bk, (qb * bq + bq - 1) // bk + 1) for qb in range(S // bq))
    exps = B * Hq * blocks * bk * bq + B * Hq * blocks * bq
    triangle = B * Hq * S * (S + 1) // 2
    clocks = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                             "--format=csv,noheader,nounits"], capture_output=True, text=True,
                            check=True, timeout=60).stdout.split("\n")[0].split(",")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = [float(x) for x in clocks]
    return exps, triangle, sms, mhz, [exps / (16 * sms * f * 1e6) * 1e3 for f in mhz]


def sdpa_fp32(torch, q, k, v, causal: bool, what: str) -> float:
    """Time ``F.scaled_dot_product_attention`` on fp32 q, k, v (TF32 off) as
    dispatched and under ``sdpa_kernel`` for each backend that takes the
    call; name the backend the dispatched call took, by the one whose output
    equals the dispatched output bit for bit.  Returns the dispatched time."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    call = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    dispatched = call()
    parts, same = [], []
    for name in ("MATH", "EFFICIENT_ATTENTION", "FLASH_ATTENTION", "CUDNN_ATTENTION"):
        with sdpa_kernel([getattr(SDPBackend, name)]):
            try:
                out = call()
                torch.cuda.synchronize()
            except RuntimeError as exc:  # the backend does not take this call
                parts.append(f"{name} refuses ({str(exc).splitlines()[0][:80]})")
                continue
            parts.append(f"{name} {cuda_ms(torch, call):.4f} ms")
        if torch.equal(out, dispatched):
            same.append(name)
        del out
    ms = cuda_ms(torch, call)
    say(f"{what}: library F.scaled_dot_product_attention fp32 (allow_tf32=False, enable_gqa) "
        f"as dispatched {ms:.4f} ms, which took {' / '.join(same) or 'no backend named here'} "
        f"(its output equals that backend's bit for bit); per backend: {'; '.join(parts)}")
    return ms


def run_flash(args, torch, dev) -> list:
    """Prefill and decode at granite-3-2b's width through ``flash_attention``
    (the main path), each against ``attention_ref`` on batch slices; the
    pinned second tile; fp32; times beside the bound, the plain version and
    ``F.scaled_dot_product_attention``."""
    import torch.nn.functional as F

    from repro_torch.configs import SHAPES
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention.generator import DEFAULT, TILES
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    kernels = []

    def sliced_ref(q, k, v, causal, step):
        return torch.cat([attention_ref(q[i:i + step], k[i:i + step], v[i:i + step], causal)
                          for i in range(0, q.shape[0], step)])

    # F1. prefill: B x S causal, the main path at the default tile
    B, S = PREFILL
    q = torch.randn((B, Hq, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn((B, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    b_ms, b_by, flops = attention_bound(B, Hq, Hkv, S, S, D, True, 2)
    say(f"prefill: flash_attention(q, k, v, causal=True) at B={B}, Hq={Hq}, Hkv={Hkv}, S={S}, "
        f"D={D}, bf16: {flops / 1e12:.3f} TFLOP of the causal triangle, bound {b_ms:.4f} ms "
        f"({b_by})")
    # the plain version in fp32 (attention_ref computes in fp32 and casts to
    # q's dtype), to show how far the bf16 kernel is from the unrounded result
    want32 = sliced_ref(q.float(), k.float(), v.float(), True, 1)
    want = want32.to(torch.bfloat16)
    floor = row_rel_err(want, want32)
    default = (DEFAULT["bq"], DEFAULT["bk"])
    for cfg in (None,) + tuple(t for t in TILES if (t["bq"], t["bk"]) != default):
        reset_counts()
        out = flash_attention(q, k, v, causal=True, config=cfg)
        torch.cuda.synchronize()
        launches = dict(FK.LAUNCHES)
        tile = default if cfg is None else (cfg["bq"], cfg["bk"])
        if launches != {"flash_attention_fwd": 1, "flash_decode": 0, "flash_decode_combine": 0} \
                or FK.LAST_LAUNCH["flash_attention_fwd"] != (*tile, True) \
                or FK.fwd_route(torch.bfloat16, D, *tile) != "wgmma":
            raise AssertionError(f"prefill {cfg}: launches {launches}, last "
                                 f"{FK.LAST_LAUNCH['flash_attention_fwd']}, route "
                                 f"{FK.fwd_route(torch.bfloat16, D, *tile)} (want wgmma)")
        err, rel = check_flash(torch, out, want, f"flash_attention prefill {cfg}", 2)
        err32, rel32 = float((out.float() - want32).abs().max()), row_rel_err(out, want32)
        del out
        say(f"prefill flash_attention(config={cfg}) at (bq, bk) {tile} "
            f"({FK.fwd_route(torch.bfloat16, D, *tile)}): launches {launches}; "
            f"max abs error {err!r} ({FLASH_TOL[2]}), row relative error {rel!r} (bound "
            f"{FLASH_ROW_REL[2]}); against the fp32 plain version max abs {err32!r}, row "
            f"relative {rel32!r} (the plain version's own bf16 rounding: {floor!r})")
        kernels.append({"name": f"flash_attention_fwd[bq={tile[0]},bk={tile[1]}]",
                        "config": {"bq": tile[0], "bk": tile[1]}, "tile": tile,
                        "fwd_route": FK.fwd_route(torch.bfloat16, D, *tile),
                        "launches": launches["flash_attention_fwd"], "max_abs_err": err,
                        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES["fwd"]})
    # configs of the reference's space run the kernel at the default tile
    for cfg in FLASH_REFERENCE_CONFIGS:
        reset_counts()
        out = flash_attention(q, k, v, causal=True, config=cfg)
        torch.cuda.synchronize()
        if FK.LAUNCHES["flash_attention_fwd"] != 1 or \
                FK.LAST_LAUNCH["flash_attention_fwd"] != (*default, True) or \
                FO.LAST_CONFIG != {"config": cfg, "tile": default}:
            raise AssertionError(f"prefill reference config {cfg}: launches {dict(FK.LAUNCHES)}, "
                                 f"last {FK.LAST_LAUNCH['flash_attention_fwd']}, {FO.LAST_CONFIG}")
        err, rel = check_flash(torch, out, want, f"flash_attention prefill {cfg}", 2)
        del out
        say(f"prefill flash_attention(config={cfg}), a config of the reference's space: asked "
            f"{FO.LAST_CONFIG['config']}, ran (bq, bk) {FO.LAST_CONFIG['tile']} "
            f"({FK.fwd_route(torch.bfloat16, D, *default)}); max abs error {err!r} "
            f"({FLASH_TOL[2]}), row relative error {rel!r} (bound {FLASH_ROW_REL[2]})")
    # the row bound's reach: the last query block without KV block 0
    n = DEFAULT["bk"]
    wrong = want.clone()
    wrong[:, :, S - n:] = attention_ref(q[:, :, S - n:], k[:, :, n:], v[:, :, n:], True)
    say(check_rejects(torch, wrong, want, f"prefill with keys 0-{n - 1} left out of its last "
                                          f"{n} query rows", 2))
    del want, want32, wrong
    plain = cuda_ms(torch, lambda: sliced_ref(q, k, v, True, 1), warmup=1, reps=5)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True, enable_gqa=True)
    lib = cuda_ms(torch, sdpa)
    fwd = {rec["name"]: (lambda t=rec["tile"]: FK.flash_attention_fwd(q, k, v, *t, True))
           for rec in kernels}
    turns = interleaved_ms(torch, {**fwd, "sdpa": sdpa}, FLASH_ROUNDS)
    for rec in kernels:
        bq, bk = rec.pop("tile")
        ms = cuda_ms(torch, fwd[rec["name"]])
        rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                   in_turns_ms=turns[rec["name"]], library_in_turns_ms=turns["sdpa"])
        say(f"time {rec['name']} prefill bf16 ({rec['fwd_route']}): {ms:.4f} ms "
            f"({flops / ms / 1e9:.1f} TFLOP/s, {b_ms / ms * 100:.1f}% of bound); plain "
            f"{plain:.4f} ms (per-batch slices, median of 5); library "
            f"F.scaled_dot_product_attention(is_causal, enable_gqa) {lib:.4f} ms")
    say(f"prefill in turns ({FLASH_ROUNDS} rounds, order reversed every other round): "
        + "; ".join(f"{name} {ms:.4f} ms" for name, ms in turns.items())
        + f"; the default tile against SDPA: {turns[kernels[0]['name']] / turns['sdpa']:.4f}x")
    exps, triangle, sms, mhz, floors = exp_floor(B, Hq, S, *default, torch)
    say(f"prefill exponential floor at (bq, bk) {default}: {exps} exponentials computed (the "
        f"causal triangle has {triangle}) / (16 a clock x {sms} SMs x SM clock): "
        f"{floors[0]:.4f} ms at the clock read now ({mhz[0]:.0f} MHz), {floors[1]:.4f} ms at the "
        f"maximum ({mhz[1]:.0f} MHz); the tensor-core bound is {b_ms:.4f} ms")
    del q, k, v
    torch.cuda.empty_cache()
    run_no_key(torch, dev, gen)
    kernels += run_prefill_fp32(torch, dev, gen)
    torch.cuda.empty_cache()
    kernels += run_head_dims(torch, dev, gen)
    torch.cuda.empty_cache()

    # F2. decode: one token against a decode_32k cache, the main path
    # (flash_attention picks bk 512, which only the CUDA-core route uses)
    shape = SHAPES["decode_32k"]
    B, Skv = shape.global_batch, shape.seq_len
    q = torch.randn((B, Hq, 1, D), device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((B, Hkv, Skv, D), device=dev, generator=gen, dtype=torch.bfloat16)
    b_ms, b_by, flops = attention_bound(B, Hq, Hkv, 1, Skv, D, False, 2)
    say(f"decode: flash_attention(q, k, v) at B={B}, Skv={Skv} ({shape.name}), Hq={Hq}, "
        f"Hkv={Hkv}, D={D}, bf16: K+V {k.numel() * 4 / 1e9:.2f} GB "
        f"({k.numel()} elements each; 2^31 = {2 ** 31}), bound {b_ms:.4f} ms ({b_by})")
    reset_counts()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    launches, decode = dict(FK.LAUNCHES), dict(FK.LAST_DECODE)
    bk = FK.LAST_LAUNCH["flash_decode"]
    if launches != {"flash_attention_fwd": 0, "flash_decode": 1, "flash_decode_combine": 0} or \
            bk != 512 or decode != {"route": "tma_mma", "splits": 1}:
        raise AssertionError(f"decode main path: launches {launches}, bk {bk}, {decode}")
    err = rel = err32 = rel32 = floor = 0.0
    for i in range(0, B, DECODE_SLICE):
        sl = slice(i, i + DECODE_SLICE)
        w32 = attention_ref(q[sl].float(), k[sl].float(), v[sl].float(), True)
        w = w32.to(torch.bfloat16)
        e, r = check_flash(torch, out[sl], w, f"flash_attention decode batch {i}", 2)
        err, rel = max(err, e), max(rel, r)
        err32 = max(err32, float((out[sl].float() - w32).abs().max()))
        rel32 = max(rel32, row_rel_err(out[sl], w32))
        floor = max(floor, row_rel_err(w, w32))
        if i == 0:  # the row bound's reach: the cache's last block left out
            blind = check_rejects(torch, attention_ref(q[sl], k[sl, :, :-bk], v[sl, :, :-bk], True),
                                  w, f"decode batch 0-{DECODE_SLICE - 1} with the last {bk} "
                                  f"keys left out", 2)
        del w32, w
    del out
    say(f"decode main path: flash_decode ({decode['route']}, {decode['splits']} split; bk {bk}); "
        f"launches {launches}; max abs error {err!r} "
        f"({FLASH_TOL[2]}), row relative error {rel!r} (bound {FLASH_ROW_REL[2]}), against "
        f"attention_ref on batch slices of {DECODE_SLICE}; against the fp32 plain version max "
        f"abs {err32!r}, row relative {rel32!r} (the plain version's own bf16 rounding: "
        f"{floor!r})")
    say(blind)
    plain = cuda_ms(torch, lambda: [attention_ref(q[i:i + DECODE_SLICE], k[i:i + DECODE_SLICE],
                                                  v[i:i + DECODE_SLICE], True)
                                    for i in range(0, B, DECODE_SLICE)], warmup=1, reps=3)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    lib = cuda_ms(torch, sdpa)
    dec = lambda: FK.flash_decode(q, k, v, bk)
    main_ms = cuda_ms(torch, dec)
    turns = interleaved_ms(torch, {"flash_decode": dec, "sdpa": sdpa}, FLASH_ROUNDS)
    queued = interleaved_ms(torch, {"flash_decode": dec, "sdpa": sdpa}, 10, QUEUED_CALLS)
    say(f"time flash_decode bf16 B {B} ({decode['route']}, {decode['splits']} split): "
        f"{main_ms:.4f} ms ({b_ms / main_ms * 100:.1f}% of bound, "
        f"{k.numel() * 4 / (main_ms * 1e-3) / 1e9:.0f} GB/s); plain {plain:.4f} ms (batch slices "
        f"of {DECODE_SLICE}, median of 3); library F.scaled_dot_product_attention(enable_gqa) "
        f"{lib:.4f} ms; in turns ({FLASH_ROUNDS} rounds) {turns['flash_decode']:.4f} against SDPA "
        f"{turns['sdpa']:.4f} ms ({turns['flash_decode'] / turns['sdpa']:.4f}x); queued "
        f"({QUEUED_CALLS} calls back to back, in turns, 10 rounds: the card's time without the "
        f"host's launch overhead) {queued['flash_decode']:.4f} against SDPA {queued['sdpa']:.4f} "
        f"ms ({b_ms / queued['flash_decode'] * 100:.1f}% of bound); {card_line()}")
    kernels.append({"name": f"flash_decode[B={B}]", "config": {"bk": bk},
                    "decode_route": decode["route"], "splits": decode["splits"],
                    "launches": launches["flash_decode"], "max_abs_err": err,
                    "source": FLASH_SOURCE, "replaces": FLASH_REPLACES["decode"], "ms": main_ms,
                    "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                    "in_turns_ms": turns["flash_decode"], "library_in_turns_ms": turns["sdpa"],
                    "queued_ms": queued["flash_decode"], "library_queued_ms": queued["sdpa"]})
    kernels += run_small_decode(torch, q[:DECODE_SMALL_B], k[:DECODE_SMALL_B], v[:DECODE_SMALL_B])
    kernels += run_core_decode(torch, q[:DECODE_SMALL_B], k[:DECODE_SMALL_B], v[:DECODE_SMALL_B])
    return kernels


def run_no_key(torch, dev, gen) -> None:
    """Causal attention with Sq > Skv (``NO_KEY_SHAPE``) through
    ``flash_attention`` in bf16 and fp32 at each of ``NO_KEY_CONFIGS``: the
    rows that see no key hold the reference kernel's value at the config
    (``ref.attention_blocks_ref``: the mean of V over the keys of the KV
    blocks it computes, or 0), exactly in bf16 and to ``NO_KEY_FP32_TOL``
    in fp32; the other rows within the flash tolerances."""
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention import ops as FO
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_blocks_ref, no_key_keys

    B, Hq, Hkv, Sq, Skv = NO_KEY_SHAPE
    D, n = 64, Sq - Skv
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = (torch.randn((B, h, s, D), device=dev, generator=gen, dtype=dtype)
                   for h, s in ((Hq, Sq), (Hkv, Skv), (Hkv, Skv)))
        parts = []
        for cfg in NO_KEY_CONFIGS:
            reset_counts()
            out = flash_attention(q, k, v, causal=True, config=cfg)
            torch.cuda.synchronize()
            tile = FO.LAST_CONFIG["tile"]
            if FK.LAUNCHES["flash_attention_fwd"] != 1 or \
                    FK.LAST_LAUNCH["flash_attention_fwd"] != (*tile, True):
                raise AssertionError(f"no-key rows {cfg} {dtype}: launches {dict(FK.LAUNCHES)}")
            want = attention_blocks_ref(q, k, v, True, cfg["bq"], cfg["bk"])
            what = f"flash_attention Sq {Sq} > Skv {Skv} {dtype} {cfg}"
            check_close(torch, out, want, what, **FLASH_TOL[q.element_size()])
            nk = float((out[:, :, :n].float() - want[:, :, :n].float()).abs().max())
            if nk > (0.0 if dtype == torch.bfloat16 else NO_KEY_FP32_TOL):
                raise AssertionError(f"{what}: rows that see no key differ by {nk!r}")
            err, rel = check_flash(torch, out[:, :, n:], want[:, :, n:], what, q.element_size())
            keys = sorted(set(no_key_keys(Sq, Skv, cfg["bq"], cfg["bk"])[:n].tolist()))
            parts.append(f"{cfg} ran {tile} ({FK.fwd_route(dtype, D, *tile)}): no-key rows "
                         f"(the mean of V over the first {keys} keys) "
                         f"{'exact' if nk == 0 else f'within {nk!r}'}, others max abs {err!r}, "
                         f"row relative {rel!r}")
            del out, want
        say(f"rows that see no key, B {B}, Hq {Hq}, Hkv {Hkv}, Sq {Sq}, Skv {Skv}, D {D}, causal, "
            f"{dtype}, against attention_blocks_ref at each config: " + "; ".join(parts))
        del q, k, v


def f32_attention_bounds(B, Hq, Hkv, S, D) -> tuple:
    """(bound ms, bound_by, the CUDA cores' one-pass ms, flops) of a causal
    fp32 prefill: three TF32 passes at the tensor cores' rate against q, k,
    v and o moved once at the HBM rate; beside it one fp32 pass on the CUDA
    cores."""
    flops = attention_bound(B, Hq, Hkv, S, S, D, True, 4)[2]
    t_ops = 3 * flops / PEAK_TF32_FLOPS * 1e3
    t_bytes = (2 * B * Hq * S * D + 2 * B * Hkv * S * D) * 4 / HBM_BYTES_PER_S * 1e3
    b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
    return b_ms, b_by, flops / PEAK_FLOPS[4] * 1e3, flops


def sdpa_math(torch, q, k, v, causal: bool = True, tf32: bool = False):
    """``F.scaled_dot_product_attention`` under the math backend, the only
    one that takes fp32 with ``enable_gqa``; ``tf32`` allows TF32 in its
    products (one TF32 pass each), the flag restored."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    was = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        with sdpa_kernel([SDPBackend.MATH]):
            return F.scaled_dot_product_attention(q, k, v, is_causal=causal, enable_gqa=True)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = was


def run_prefill_fp32(torch, dev, gen) -> list:
    """F1b. The causal prefill in fp32 at granite-3-2b's width, B 1 × 4096,
    through ``flash_attention`` at both tiles (three TF32 passes,
    ``flash_fwd_tf32_kernel``), operands drawn in fp32: a value drawn in
    bf16 is exact in TF32, so one TF32 pass would pass a check on it.  Held
    to ``attention_ref`` (FLASH_TOL, FLASH_ROW_REL) and to an fp64 attention
    within F32_GATE times the error of SDPA's math backend with TF32 off, a
    gate shown to reject that backend with TF32 on (one TF32 pass a
    product); timed (median of 20 after 3 warm-ups) beside both bounds, the
    plain version and the math backend, and in turns with it."""
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.generator import DEFAULT
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_fp64_ref, attention_ref

    Hq, Hkv, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    S = PREFILL[1]
    q = torch.randn((1, Hq, S, D), device=dev, generator=gen)
    k = torch.randn((1, Hkv, S, D), device=dev, generator=gen)
    v = torch.randn((1, Hkv, S, D), device=dev, generator=gen)
    b_ms, b_by, cc_ms, flops = f32_attention_bounds(1, Hq, Hkv, S, D)
    say(f"prefill fp32: flash_attention(q, k, v, causal=True) at B=1, Hq={Hq}, Hkv={Hkv}, S={S}, "
        f"D={D}, operands drawn in fp32: {flops / 1e9:.2f} GFLOP of the causal triangle; bound "
        f"{b_ms:.4f} ms ({b_by}: three TF32 passes at {PEAK_TF32_FLOPS / 1e12:.1f} TFLOP/s); one "
        f"fp32 pass on the CUDA cores at {PEAK_FLOPS[4] / 1e12:.0f} TFLOP/s: {cc_ms:.4f} ms")
    want, exact = attention_ref(q, k, v, True), attention_fp64_ref(q, k, v, True)
    off = gemm_errors(torch, sdpa_math(torch, q, k, v), exact)
    one = gemm_errors(torch, sdpa_math(torch, q, k, v, tf32=True), exact)
    gate = tuple(F32_GATE * e for e in off)
    if one[0] <= gate[0] and one[1] <= gate[1]:
        raise AssertionError(f"the {F32_GATE}x error gate {gate} passes one TF32 pass (RMS, max "
                             f"abs {one})")
    default = (DEFAULT["bq"], DEFAULT["bk"])
    records = []
    for tile in FK.FWD_TILES:
        cfg = None if tile == default else {"bq": tile[0], "bk": tile[1]}
        reset_counts()
        out = flash_attention(q, k, v, causal=True, config=cfg)
        torch.cuda.synchronize()
        launches = dict(FK.LAUNCHES)
        if launches != {"flash_attention_fwd": 1, "flash_decode": 0, "flash_decode_combine": 0} \
                or FK.LAST_LAUNCH["flash_attention_fwd"] != (*tile, True):
            raise AssertionError(f"prefill fp32 {cfg}: launches {launches}, last "
                                 f"{FK.LAST_LAUNCH['flash_attention_fwd']}")
        err, rel = check_flash(torch, out, want, f"flash_attention prefill fp32 {cfg}", 4)
        errs = gemm_errors(torch, out, exact)
        del out
        if errs[0] > gate[0] or errs[1] > gate[1]:
            raise AssertionError(f"flash_attention_fwd fp32 {tile}: error against fp64 (RMS, max "
                                 f"abs) {errs} exceeds {F32_GATE}x the math backend's {off}")
        route = FK.fwd_route(torch.float32, D, *tile)
        say(f"prefill fp32 flash_attention(config={cfg}) at (bq, bk) {tile} ({route}): launches "
            f"{launches}; max abs error {err!r} ({FLASH_TOL[4]}), row relative error {rel!r} "
            f"(bound {FLASH_ROW_REL[4]}); against fp64, RMS and max abs: kernel {errs[0]!r}, "
            f"{errs[1]!r}; SDPA math TF32 off {off[0]!r}, {off[1]!r} ({errs[0] / off[0]:.3f}x, "
            f"{errs[1] / off[1]:.3f}x; the gate is {F32_GATE}x); one TF32 pass (the math backend, "
            f"allow_tf32=True) {one[0]!r}, {one[1]!r} ({one[0] / off[0]:.1f}x, "
            f"{one[1] / off[1]:.1f}x: the gate rejects it)")
        records.append({"name": f"flash_attention_fwd[fp32,bq={tile[0]},bk={tile[1]}]",
                        "config": {"bq": tile[0], "bk": tile[1]}, "tile": tile, "fwd_route": route,
                        "launches": launches["flash_attention_fwd"], "max_abs_err": err,
                        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES["fwd"]})
    del want, exact
    plain = cuda_ms(torch, lambda: attention_ref(q, k, v, True), warmup=1, reps=5)
    math = lambda: sdpa_math(torch, q, k, v)
    lib = cuda_ms(torch, math)
    fwd = {rec["name"]: (lambda t=rec["tile"]: FK.flash_attention_fwd(q, k, v, *t, True))
           for rec in records}
    turns = interleaved_ms(torch, {**fwd, "sdpa math": math}, FLASH_ROUNDS)
    for rec in records:
        rec.pop("tile")
        ms = cuda_ms(torch, fwd[rec["name"]])
        rec.update(ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by, library_ms=lib,
                   in_turns_ms=turns[rec["name"]],
                   library_in_turns_ms=turns["sdpa math"])
        say(f"time {rec['name']} prefill fp32 ({rec['fwd_route']}): {ms:.4f} ms (median of 20; "
            f"{flops / ms / 1e9:.1f} TFLOP/s of fp32 product, {b_ms / ms * 100:.1f}% of the "
            f"three-pass bound {b_ms:.4f}, {cc_ms / ms:.2f}x the CUDA cores' ceiling rate); in turns "
            f"({FLASH_ROUNDS} rounds) {rec['in_turns_ms']:.4f} against SDPA math "
            f"{turns['sdpa math']:.4f} ms ({rec['in_turns_ms'] / turns['sdpa math']:.4f}x); plain "
            f"{plain:.4f} ms (median of 5); library SDPA math (allow_tf32=False) {lib:.4f} ms; "
            f"{card_line()}")
    sdpa_fp32(torch, q, k, v, True, "prefill fp32 B=1")
    return records


def run_head_dims(torch, dev, gen) -> list:
    """F1c. The head dims of the repo's configs beyond granite-3-2b's 64
    (``HEAD_DIM_CONFIGS``), through ``flash_attention``: on small shapes
    the forward at both tiles (causal, Sq < Skv) and the decode, in bf16
    and fp32, each against the plain version; then at full width, B 1 ×
    4096 causal, the fp32 forward at D 128 against SDPA's math backend and
    the bf16 forward at D 80 and 96 (the wgmma kernel, which must be the
    route) against SDPA, in turns, beside their bounds and the plain
    version."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref

    def qkv(B, Hq, Hkv, Sq, Skv, D, dtype):
        return [torch.randn(shape, device=dev, generator=gen).to(dtype)
                for shape in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D))]

    for name, Hq, Hkv, D in HEAD_DIM_CONFIGS:
        for dtype in (torch.bfloat16, torch.float32):
            eb, parts = torch.tensor([], dtype=dtype).element_size(), []
            q, k, v = qkv(2, Hq, Hkv, 256, 384, D, dtype)
            want = attention_ref(q, k, v, True)
            for tile in FK.FWD_TILES:
                reset_counts()
                got = flash_attention(q, k, v, causal=True, config={"bq": tile[0], "bk": tile[1]})
                torch.cuda.synchronize()
                if dict(FK.LAUNCHES) != {"flash_attention_fwd": 1, "flash_decode": 0,
                                         "flash_decode_combine": 0}:
                    raise AssertionError(f"{name} D {D} {dtype} {tile}: launches {FK.LAUNCHES}")
                err, rel = check_flash(torch, got, want, f"{name} forward {dtype} {tile}", eb)
                parts.append(f"forward {tile} ({FK.fwd_route(dtype, D, *tile)}) max abs {err:.3e}, "
                             f"row relative {rel:.3e}")
            q, k, v = qkv(2, Hq, Hkv, 1, 1024, D, dtype)
            reset_counts()
            got = flash_attention(q, k, v)
            torch.cuda.synchronize()
            if FK.LAUNCHES["flash_decode"] != 1:
                raise AssertionError(f"{name} D {D} {dtype} decode: launches {FK.LAUNCHES}")
            err, rel = check_flash(torch, got, attention_ref(q, k, v, False),
                                   f"{name} decode {dtype}", eb)
            parts.append(f"decode ({FK.LAST_DECODE['route']}, {FK.LAST_DECODE['splits']} splits) "
                         f"max abs {err:.3e}, row relative {rel:.3e}")
            say(f"head dim {D} ({name}: Hq {Hq}, Hkv {Hkv}) {dtype}: " + "; ".join(parts))
            del q, k, v, got, want

    records = []
    for name, Hq, Hkv, D, dtype in HEAD_DIM_TIMED:
        dtype = getattr(torch, dtype)
        S, eb = PREFILL[1], torch.tensor([], dtype=dtype).element_size()
        q, k, v = qkv(1, Hq, Hkv, S, S, D, dtype)
        if eb == 4:
            b_ms, b_by, _, flops = f32_attention_bounds(1, Hq, Hkv, S, D)
            lib_fn = lambda: sdpa_math(torch, q, k, v)  # noqa: E731
        else:
            b_ms, b_by, flops = attention_bound(1, Hq, Hkv, S, S, D, True, 2)
            lib_fn = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True,  # noqa: E731
                                                            enable_gqa=True)
        reset_counts()
        out = flash_attention(q, k, v, causal=True)
        torch.cuda.synchronize()
        launches = dict(FK.LAUNCHES)
        tile = FK.LAST_LAUNCH["flash_attention_fwd"][:2]
        if launches["flash_attention_fwd"] != 1:
            raise AssertionError(f"{name} D {D}: launches {launches}")
        err, rel = check_flash(torch, out, attention_ref(q, k, v, True), f"{name} B 1 x {S}", eb)
        del out
        route = FK.fwd_route(dtype, D, *tile)
        if eb == 2 and route != "wgmma":
            raise AssertionError(f"{name} D {D} bf16 at {tile} ran {route}, not the wgmma kernel")
        plain = cuda_ms(torch, lambda: attention_ref(q, k, v, True), warmup=1, reps=5)
        call = lambda: FK.flash_attention_fwd(q, k, v, *tile, True)  # noqa: E731
        ms, lib = cuda_ms(torch, call), cuda_ms(torch, lib_fn)
        turns = interleaved_ms(torch, {"kernel": call, "library": lib_fn}, FLASH_ROUNDS)
        label = "SDPA math (allow_tf32=False)" if eb == 4 else "SDPA"
        say(f"time head dim {D} ({name}: Hq {Hq}, Hkv {Hkv}) {dtype} causal B 1 x {S} through "
            f"flash_attention at (bq, bk) {tile} ({route}): launches {launches}; max abs error "
            f"{err!r}, row relative {rel!r}; {ms:.4f} ms ({b_ms / ms * 100:.1f}% of the {b_ms:.4f} "
            f"ms bound, {b_by}); in turns ({FLASH_ROUNDS} rounds) {turns['kernel']:.4f} against "
            f"{label} {turns['library']:.4f} ms ({turns['kernel'] / turns['library']:.4f}x); plain "
            f"{plain:.4f} ms; library {lib:.4f} ms; {card_line()}")
        records.append({"name": f"flash_attention_fwd[{'fp32' if eb == 4 else 'bf16'},D={D},"
                                f"bq={tile[0]},bk={tile[1]}]", "fwd_route": route,
                        "launches": launches["flash_attention_fwd"], "max_abs_err": err, "ms": ms,
                        "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
                        "in_turns_ms": turns["kernel"], "library_in_turns_ms": turns["library"],
                        "source": FLASH_SOURCE, "replaces": FLASH_REPLACES["fwd"]})
        del q, k, v
        torch.cuda.empty_cache()
    return records


def run_small_decode(torch, q, k, v) -> list:
    """F3. The decode at a single user's batch (the first sequences of the
    decode_32k cache) through ``flash_attention``: too few (b, KV head)
    units to fill the card, so the cache is split and a second kernel
    combines the partials.  Both kernels against their plain versions,
    timed beside their bounds and SDPA."""
    import torch.nn.functional as F

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (
        attention_ref,
        combine_partials_ref,
        decode_partials_ref,
        row_rel_err,
    )

    B, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    b_ms, b_by, _ = attention_bound(B, Hq, Hkv, 1, Skv, D, False, 2)
    reset_counts()
    out = flash_attention(q, k, v)
    torch.cuda.synchronize()
    launches, decode = dict(FK.LAUNCHES), dict(FK.LAST_DECODE)
    splits = decode["splits"]
    if launches != {"flash_attention_fwd": 0, "flash_decode": 1, "flash_decode_combine": 1} or \
            decode["route"] != "tma_mma" or splits <= 1:
        raise AssertionError(f"decode B {B}: launches {launches}, {decode}")
    want32 = attention_ref(q.float(), k.float(), v.float(), False)
    want = want32.to(torch.bfloat16)
    err, rel = check_flash(torch, out, want, f"flash_attention decode B {B}", 2)
    say(f"decode B {B} x {Skv}: flash_attention ran {decode['route']} in {splits} splits and the "
        f"combine; launches {launches}; max abs error {err!r} ({FLASH_TOL[2]}), row relative "
        f"error {rel!r} (bound {FLASH_ROW_REL[2]}); against the fp32 plain version row relative "
        f"{row_rel_err(out, want32)!r} (its own bf16 rounding {row_rel_err(want, want32)!r})")
    del out, want, want32
    # the combine kernel alone, on the plain version's partials of these splits
    part = decode_partials_ref(q, k, v, splits)
    c_err = check_close(torch, FK.decode_combine(part), combine_partials_ref(part), "decode_combine",
                        **FLASH_TOL[2])
    c_bytes = part.numel() * 4 + B * Hq * D * 2
    c_bound = c_bytes / HBM_BYTES_PER_S * 1e3
    c_ms = cuda_ms(torch, lambda: FK.decode_combine(part))
    c_queued = interleaved_ms(torch, {"combine": lambda: FK.decode_combine(part)}, 5,
                              QUEUED_CALLS)["combine"]
    c_plain = cuda_ms(torch, lambda: combine_partials_ref(part), warmup=1, reps=5)
    say(f"decode_combine of {splits} splits ({tuple(part.shape)} fp32 partials): max abs error "
        f"{c_err!r} against combine_partials_ref; {c_ms:.4f} ms (queued {c_queued:.4f} ms), byte "
        f"bound {c_bound:.4f} ms, plain {c_plain:.4f} ms")
    plain = cuda_ms(torch, lambda: attention_ref(q, k, v, False), warmup=1, reps=3)
    sdpa = lambda: F.scaled_dot_product_attention(q, k, v, enable_gqa=True)
    lib = cuda_ms(torch, sdpa)
    dec = lambda: flash_attention(q, k, v)
    ms = cuda_ms(torch, dec)
    turns = interleaved_ms(torch, {"flash_decode": dec, "sdpa": sdpa}, FLASH_ROUNDS)
    queued = interleaved_ms(torch, {"flash_decode": dec, "sdpa": sdpa}, 10, QUEUED_CALLS)
    say(f"time flash_decode bf16 B {B} ({splits} splits, the combine included): {ms:.4f} ms "
        f"({b_ms / ms * 100:.1f}% of the {b_ms:.4f} ms bound, "
        f"{k.numel() * 4 / (ms * 1e-3) / 1e9:.0f} GB/s); plain {plain:.4f} ms; library "
        f"F.scaled_dot_product_attention(enable_gqa) {lib:.4f} ms; in turns ({FLASH_ROUNDS} "
        f"rounds) {turns['flash_decode']:.4f} against SDPA {turns['sdpa']:.4f} ms "
        f"({turns['flash_decode'] / turns['sdpa']:.4f}x); queued ({QUEUED_CALLS} calls back to "
        f"back, in turns, 10 rounds) {queued['flash_decode']:.4f} against SDPA "
        f"{queued['sdpa']:.4f} ms ({b_ms / queued['flash_decode'] * 100:.1f}% of bound); "
        f"{card_line()}")
    common = {"source": FLASH_SOURCE, "replaces": FLASH_REPLACES["decode"]}
    return [{"name": f"flash_decode[B={B}]", "decode_route": decode["route"], "splits": splits,
             "launches": launches["flash_decode"], "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by, "library_ms": lib,
             "in_turns_ms": turns["flash_decode"], "library_in_turns_ms": turns["sdpa"],
             "queued_ms": queued["flash_decode"], "library_queued_ms": queued["sdpa"], **common},
            {"name": "flash_decode_combine", "splits": splits,
             "launches": launches["flash_decode_combine"], "max_abs_err": c_err, "ms": c_ms,
             "plain_ms": c_plain, "bound_ms": c_bound, "bound_by": "bytes", "library_ms": None,
             "queued_ms": c_queued, **common}]


def run_core_decode(torch, q, k, v) -> list:
    """F4. The CUDA-core decode route through ``flash_attention`` at a single
    user's batch of the decode_32k cache: in fp32 (the sequences in fp32)
    and in bf16 at head dim 32 (their first 32 dims).  Too few units fill
    the card, so each splits the cache as ``decode_splits`` says and the
    combine kernel merges the partials in the output's dtype.  Held to the
    plain version, timed beside the bound, the plain version and SDPA (in
    fp32 the math backend, the only one that takes fp32 with
    ``enable_gqa``)."""
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref, row_rel_err

    B, Hq, _, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    chosen = FK.decode_splits(B, Hkv, FK.decode_chunks("cuda_cores", Hq // Hkv), Skv, sms)
    records = []
    for label, qc, kc, vc in (("fp32", q.float(), k.float(), v.float()),
                              ("bf16,D=32", *(t[..., :32].contiguous() for t in (q, k, v)))):
        eb, d = qc.element_size(), qc.shape[-1]
        reset_counts()
        out = flash_attention(qc, kc, vc)
        torch.cuda.synchronize()
        launches, decode = dict(FK.LAUNCHES), dict(FK.LAST_DECODE)
        if launches != {"flash_attention_fwd": 0, "flash_decode": 1, "flash_decode_combine": 1} \
                or decode != {"route": "cuda_cores", "splits": chosen} or chosen < 2:
            raise AssertionError(f"decode {label} B {B}: launches {launches}, {decode}, "
                                 f"decode_splits {chosen}")
        want = attention_ref(qc, kc, vc, False)
        err, rel = check_flash(torch, out, want, f"flash_attention decode {label} B {B}", eb)
        rel32 = row_rel_err(out, attention_ref(qc.float(), kc.float(), vc.float(), False))
        del out, want
        flops = 4.0 * d * B * Hq * Skv  # Q K^T and P V on the CUDA cores, f32 FFMAs
        n_bytes = (2 * B * Hq * d + 2 * B * Hkv * Skv * d) * eb
        t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[4] * 1e3
        b_ms, b_by = (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
        plain = cuda_ms(torch, lambda: attention_ref(qc, kc, vc, False), warmup=1, reps=3)
        call = lambda: flash_attention(qc, kc, vc)
        if eb == 4:
            sdpa_fp32(torch, qc, kc, vc, False, f"decode fp32 B {B}")

            def sdpa():
                with sdpa_kernel([SDPBackend.MATH]):
                    return F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True)
        else:
            sdpa = lambda: F.scaled_dot_product_attention(qc, kc, vc, enable_gqa=True)
        ms, lib = cuda_ms(torch, call), cuda_ms(torch, sdpa)
        turns = interleaved_ms(torch, {"flash_decode": call, "sdpa": sdpa}, FLASH_ROUNDS)
        queued = interleaved_ms(torch, {"flash_decode": call, "sdpa": sdpa}, 10, QUEUED_CALLS)
        say(f"decode {label} B {B} x {Skv} (cuda_cores): flash_attention ran {chosen} splits "
            f"(decode_splits on {sms} SMs) and the combine; launches {launches}; max abs error "
            f"{err!r} ({FLASH_TOL[eb]}), row relative error {rel!r} (bound {FLASH_ROW_REL[eb]}; "
            f"against the fp32 plain version {rel32!r}); {ms:.4f} ms ({b_ms / ms * 100:.1f}% of "
            f"the {b_ms:.4f} ms bound, {b_by}; {kc.numel() * 2 * eb / (ms * 1e-3) / 1e9:.0f} "
            f"GB/s); plain {plain:.4f} ms (median of 3); library "
            f"F.scaled_dot_product_attention{' (math)' if eb == 4 else ''} {lib:.4f} ms; in turns "
            f"({FLASH_ROUNDS} rounds) {turns['flash_decode']:.4f} against {turns['sdpa']:.4f} ms "
            f"({turns['flash_decode'] / turns['sdpa']:.4f}x); queued ({QUEUED_CALLS} calls back "
            f"to back, 10 rounds) {queued['flash_decode']:.4f} against {queued['sdpa']:.4f} ms "
            f"({b_ms / queued['flash_decode'] * 100:.1f}% of bound); {card_line()}")
        records.append({"name": f"flash_decode[{label},B={B}]", "decode_route": "cuda_cores",
                        "splits": chosen, "launches": launches["flash_decode"],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": b_ms,
                        "bound_by": b_by, "library_ms": lib, "in_turns_ms": turns["flash_decode"],
                        "library_in_turns_ms": turns["sdpa"], "queued_ms": queued["flash_decode"],
                        "library_queued_ms": queued["sdpa"], "source": FLASH_SOURCE,
                        "replaces": FLASH_REPLACES["decode"]})
        del qc, kc, vc
    return records


def run_layer(args, torch, dev) -> None:
    """``attention_apply`` at granite-3-2b's full width with the port's
    weights: the flash branch (one ``flash_attention_fwd`` launch) against
    the chunked branch."""
    from repro_torch.configs.granite3_2b import CONFIG
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.layers.attention import attention_apply, attention_init

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    H, KV, D = CONFIG.n_heads, CONFIG.n_kv, CONFIG.resolved_head_dim
    params = attention_init(CONFIG.d_model, H, KV, D, CONFIG.qkv_bias, torch.bfloat16,
                            generator=gen, device=dev)
    x = torch.randn((*PREFILL, CONFIG.d_model), device=dev, generator=gen, dtype=torch.bfloat16)
    kw = dict(n_heads=H, n_kv=KV, head_dim=D, rope_theta=CONFIG.rope_theta)
    reset_counts()
    out, cache = attention_apply(params, x, use_pallas=True, **kw)
    torch.cuda.synchronize()
    launches = dict(FK.LAUNCHES)
    if launches != {"flash_attention_fwd": 1, "flash_decode": 0, "flash_decode_combine": 0} \
            or cache is not None:
        raise AssertionError(f"attention_apply(use_pallas=True) launches {launches}: the flash "
                             "branch must run flash_attention_fwd exactly once")
    bq, bk, _ = FK.LAST_LAUNCH["flash_attention_fwd"]
    route = FK.fwd_route(torch.bfloat16, D, bq, bk)
    want, _ = attention_apply(params, x, use_pallas=False, **kw)
    err, rel = check_flash(torch, out, want, "attention_apply flash vs chunked", 2)
    del out, want
    flash_ms = cuda_ms(torch, lambda: attention_apply(params, x, use_pallas=True, **kw),
                       warmup=1, reps=5)
    chunked_ms = cuda_ms(torch, lambda: attention_apply(params, x, use_pallas=False, **kw),
                         warmup=1, reps=5)
    say(f"layer: attention_apply(x {tuple(x.shape)} bf16, granite-3-2b weights from "
        f"attention_init, use_pallas=True): launches {launches} at (bq, bk) {(bq, bk)} "
        f"({route}); max abs error against "
        f"use_pallas=False {err!r} ({FLASH_TOL[2]}), row relative error {rel!r} (bound "
        f"{FLASH_ROW_REL[2]}); call {flash_ms:.4f} ms with the flash "
        f"kernel, {chunked_ms:.4f} ms chunked (median of 5)")


def run_attention(args, torch, dev) -> list:
    """The attention path at granite-3-2b's full width: the layer's GEMMs,
    prefill and decode attention, and the attention layer itself."""
    kernels = run_matmuls(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_matmul_fp32(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_flash(args, torch, dev)
    torch.cuda.empty_cache()
    run_layer(args, torch, dev)
    return kernels


# the TPU side of the generators ("tpu P1"): each paper-loop generator's
# Pallas space ranked on the TPU v5e at the smoke's own domains, and the TPU
# winner's config run by the port's entry point on the card
TPU_P1 = (("stencil", 8), ("lbm", 8), ("jacobi", 8), ("jacobi", 4), ("transpose", 4))


def tpu_p1_stencil(torch, dev, gen, cfg: dict, eb: int) -> dict:
    """The stencil's TPU winner ``cfg`` through ``star_stencil`` on the card,
    then timed on the pre-padded input beside the H100-ranked launch and,
    for a new record, ``F.conv3d``."""
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import best_config
    from repro_torch.kernels.stencil3d25.ops import star_stencil, zmarch_tile
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

    dtype = torch.float64 if eb == 8 else torch.float32
    src = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen).to(dtype)
    w = star_weights(R, dtype, dev)
    padded = pad_input(src, R)
    want = star_stencil_ref(padded, w, R)
    reset_counts()
    out = star_stencil(src, w, r=R, config=cfg)
    torch.cuda.synchronize()
    launches = dict(K.LAUNCHES)
    err = check(torch, out, want, eb, f"tpu P1 star_stencil({cfg}) fp{eb * 8}")
    del out, want
    h100 = best_config(R, DOMAIN, eb, H100).launch
    if cfg["variant"] == "replane":
        kernel, launch = "star_pointwise", h100
        run = lambda: K.star_pointwise(padded, w, R, launch)  # noqa: E731
        name, what = "star_pointwise", f"block {launch.block} folding {launch.folding}"
    else:
        tile = zmarch_tile(cfg, R, DOMAIN, eb)
        kernel, route = "star_zmarch", K.LAST_ZMARCH["route"]
        run = lambda: K.star_zmarch(padded, w, R, *tile)  # noqa: E731
        name = (f"star_zmarch[ring,{route}]" if cfg["variant"] == "ring"
                else f"star_zmarch[ytile_ring,ty={cfg['ty']},{route}]")
        what = f"tile {tile[0]}x{tile[1]}, route {route}"
    x5, conv_w = padded.view(1, 1, *padded.shape), star_conv_weight(torch, w, R)
    return dict(
        name=name, kernel=kernel, launches=launches, err=err, what=what, ms=cuda_ms(torch, run),
        h100_ms=cuda_ms(torch, lambda: K.star_pointwise(padded, w, R, h100)), h100=h100,
        bound=bound(padded, R), source=SOURCE, replaces=REPLACES[cfg["variant"]],
        plain=lambda: star_stencil_ref(padded, w, R), library=lambda: F.conv3d(x5, conv_w))


def tpu_p1_lbm(torch, dev, gen, cfg: dict, eb: int) -> dict:
    """The LBM's TPU winner ``cfg`` through ``lbm_step`` on the card, on
    independent random PDFs, then timed like the stencil's."""
    from repro_torch.core.machines import H100
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.lbm_d3q15.generator import best_config
    from repro_torch.kernels.lbm_d3q15.ops import lbm_step
    from repro_torch.kernels.lbm_d3q15.ref import lbm_step_ref, pad_inputs

    dtype = torch.float64 if eb == 8 else torch.float32
    phase = torch.sigmoid(torch.randn(LBM_DOMAIN, dtype=torch.float64, device=dev,
                                      generator=gen)).to(dtype)
    pdf = torch.rand((15, *LBM_DOMAIN), dtype=torch.float64, device=dev,
                     generator=gen).to(dtype)
    pdf_p, phase_p = pad_inputs(pdf, phase)
    want, want_phase = lbm_step_ref(pdf_p, phase_p)
    reset_counts()
    out, out_phase = lbm_step(pdf, phase, config=cfg)
    torch.cuda.synchronize()
    launches = dict(LK.LAUNCHES)
    err = max(check(torch, out, want, eb, f"tpu P1 lbm_step({cfg}) fp{eb * 8} PDFs"),
              check(torch, out_phase, want_phase, eb, f"tpu P1 lbm_step({cfg}) fp{eb * 8} phase"))
    del out, out_phase, want, want_phase, pdf, phase
    h100 = best_config(LBM_DOMAIN, eb, H100).launch
    if cfg["variant"] == "replane":
        kernel, name, launch = "lbm_pointwise", "lbm_pointwise", h100
        run = lambda: LK.lbm_pointwise(pdf_p, phase_p, launch)  # noqa: E731
        what = f"block {launch.block} folding {launch.folding}"
    else:
        tile = LK.ytile_tile(cfg["ty"], eb)
        kernel, name = "lbm_ytile", f"lbm_ytile[ty={cfg['ty']}]"
        run = lambda: LK.lbm_ytile(pdf_p, phase_p, *tile)  # noqa: E731
        what = ytile_line(LK, LK.LAST_YTILE, eb)
    return dict(
        name=name, kernel=kernel, launches=launches, err=err, what=what, ms=cuda_ms(torch, run),
        h100_ms=cuda_ms(torch, lambda: LK.lbm_pointwise(pdf_p, phase_p, h100)), h100=h100,
        bound=lbm_bound(pdf_p, phase_p), source=LBM_SOURCE, replaces=LBM_REPLACES[cfg["variant"]],
        plain=lambda: lbm_step_ref(pdf_p, phase_p), library=None)


def tpu_p1_jacobi(torch, dev, gen, cfg: dict, eb: int) -> dict:
    """The Jacobi sweep's TPU winner ``cfg`` through ``jacobi_step`` on the
    card, then timed like the stencil's, beside ``F.conv2d``."""
    import torch.nn.functional as F

    from repro_torch.core.machines import H100
    from repro_torch.kernels.jacobi2d import kernel as JK
    from repro_torch.kernels.jacobi2d.generator import best_config
    from repro_torch.kernels.jacobi2d.ops import jacobi_step
    from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref, pad_input

    dtype = torch.float64 if eb == 8 else torch.float32
    src = torch.randn(JACOBI_DOMAIN, dtype=torch.float64, device=dev, generator=gen).to(dtype)
    padded = pad_input(src)
    want = jacobi_padded_ref(padded, JACOBI_WEIGHTS)
    reset_counts()
    out = jacobi_step(src, JACOBI_WEIGHTS, cfg)
    torch.cuda.synchronize()
    launches = dict(JK.LAUNCHES)
    err = check(torch, out, want, eb, f"tpu P1 jacobi_step({cfg}) fp{eb * 8}")
    del out, want
    h100 = best_config(JACOBI_DOMAIN, eb, H100).launch
    prefix = "" if eb == 8 else "fp32,"
    if cfg["variant"] == "rowstream":
        kernel, launch = "jacobi_pointwise", h100
        name = "jacobi_pointwise" if eb == 8 else "jacobi_pointwise[fp32]"
        run = lambda: JK.jacobi_pointwise(padded, launch, JACOBI_WEIGHTS)  # noqa: E731
        what = f"block {launch.block} folding {launch.folding}"
    else:
        tile = JK.ytile_tile(cfg["ty"], eb)
        kernel, name = "jacobi_ytile", f"jacobi_ytile[{prefix}ty={cfg['ty']}]"
        run = lambda: JK.jacobi_ytile(padded, *tile, JACOBI_WEIGHTS)  # noqa: E731
        what = jacobi_ring_line(JK.LAST_YTILE)
    x4 = padded.view(1, 1, *padded.shape)
    weight = jacobi_conv_weight(torch, dtype, dev)
    return dict(
        name=name, kernel=kernel, launches=launches, err=err, what=what, ms=cuda_ms(torch, run),
        h100_ms=cuda_ms(torch, lambda: JK.jacobi_pointwise(padded, h100, JACOBI_WEIGHTS)),
        h100=h100, bound=jacobi_bound(padded), source=JACOBI_SOURCE,
        replaces=JACOBI_REPLACES[cfg["variant"]],
        plain=lambda: jacobi_padded_ref(padded, JACOBI_WEIGHTS),
        library=lambda: F.conv2d(x4, weight))


def tpu_p1_transpose(torch, dev, gen, cfg: dict, eb: int) -> dict:
    """The transpose's TPU winner ``cfg`` through ``transpose`` on the card,
    held bit for bit, then timed beside the H100-ranked launch; the plain
    version, ``x.mT.contiguous()``, is also the library call."""
    from repro_torch.core.machines import H100
    from repro_torch.kernels.transpose_pad import kernel as TK
    from repro_torch.kernels.transpose_pad.generator import best_config
    from repro_torch.kernels.transpose_pad.ops import transpose
    from repro_torch.kernels.transpose_pad.ref import transpose_ref

    dtype = torch.float64 if eb == 8 else torch.float32
    x = torch.randn(TRANSPOSE_SHAPE, dtype=torch.float64, device=dev, generator=gen).to(dtype)
    reset_counts()
    out = transpose(x, cfg)
    torch.cuda.synchronize()
    launches = dict(TK.LAUNCHES)
    err = check_exact(torch, out, transpose_ref(x), f"tpu P1 transpose({cfg}) fp{eb * 8}")
    del out
    h100 = best_config(TRANSPOSE_SHAPE, eb, H100).launch
    bm, bn = cfg["bm"], cfg["bn"]
    prefix = "" if eb == 4 else "fp64,"
    return dict(
        name=f"transpose_tiled[{prefix}{bm}x{bn}]", kernel="transpose_tiled",
        launches=launches, err=err, what=f"tile {bm}x{bn}",
        ms=cuda_ms(torch, lambda: TK.transpose_tiled(x, bm, bn)),
        h100_ms=cuda_ms(torch, lambda: TK.transpose_pointwise(x, h100)), h100=h100,
        bound=(2 * x.numel() * eb / HBM_BYTES_PER_S * 1e3, "bytes"), source=TRANSPOSE_SOURCE,
        replaces=TRANSPOSE_REPLACES, plain=lambda: transpose_ref(x),
        library=lambda: transpose_ref(x))


def run_tpu(args, torch, dev, kernels: list) -> list:
    """The "tpu P1" phase: each paper-loop generator's TPU space ranked with
    ``tpu_rank_configs`` on the TPU v5e at the smoke's domains (host
    seconds, candidates ranked and skipped, the winner's predicted time and
    limiter), the winner's config run by the port's entry point on the card
    and held to its plain version, its kernel timed on the pre-padded input
    beside its bound and the H100-ranked launch.  A refused config fails
    the phase.  The launches go onto the record of the kernel and config
    the path phases ran (``tpu_launches``, ``tpu_ms``); a winner no path
    runs gets a record of its own, measured here.  Returns the new records."""
    from repro_torch.core.machines import TPU_V5E
    from repro_torch.kernels.jacobi2d import generator as jacobi_gen
    from repro_torch.kernels.lbm_d3q15 import generator as lbm_gen
    from repro_torch.kernels.stencil3d25 import generator as stencil_gen
    from repro_torch.kernels.transpose_pad import generator as transpose_gen

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    paths = {
        "stencil": (stencil_gen, (R, DOMAIN), tpu_p1_stencil, f"r={R} {DOMAIN}"),
        "lbm": (lbm_gen, (LBM_DOMAIN,), tpu_p1_lbm, f"{LBM_DOMAIN}"),
        "jacobi": (jacobi_gen, (JACOBI_DOMAIN,), tpu_p1_jacobi, f"{JACOBI_DOMAIN}"),
        "transpose": (transpose_gen, (TRANSPOSE_SHAPE,), tpu_p1_transpose, f"{TRANSPOSE_SHAPE}"),
    }
    records = []
    for path, eb in TPU_P1:
        module, shape, drive, where = paths[path]
        t0 = time.perf_counter()
        ranked = module.tpu_rank_configs(*shape, TPU_V5E, eb)
        t_rank = time.perf_counter() - t0
        n_cands = len(list(module.tpu_candidate_specs(*shape, eb)))
        if not ranked:
            raise AssertionError(f"tpu P1 {path}: no TPU candidate of {n_cands} fits")
        top = ranked[0]
        cfg, est = top.config, top.estimate
        say(f"tpu P1 {path} {where} fp{eb * 8}: tpu_rank_configs on {TPU_V5E.name} in "
            f"{t_rank:.4f} s, {len(ranked)} ranked, {n_cands - len(ranked)} skipped (VMEM); "
            f"winner {cfg} predicted {est.total_time * 1e3:.4f} ms on the TPU v5e "
            f"({est.limiter}-limited)")
        torch.cuda.synchronize()
        run = drive(torch, dev, gen, cfg, eb)
        count = run["launches"].get(run["kernel"], 0)
        if count < 1:
            raise AssertionError(f"tpu P1 {path}: the entry point at {cfg} launched no "
                                 f"{run['kernel']}: {run['launches']}")
        b_ms, b_by = run["bound"]
        say(f"tpu P1 {path} fp{eb * 8}: the entry point at {cfg} launched {run['kernel']} "
            f"{count}x ({run['what']}); max abs error {run['err']!r} (tolerance "
            f"{'bit-exact' if path == 'transpose' else TOL[eb]}); {run['kernel']} "
            f"{run['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), {b_ms / run['ms'] * 100:.1f}% "
            f"of bound; the H100-ranked launch ({run['h100'].block}/{run['h100'].folding}) "
            f"{run['h100_ms']:.4f} ms, {run['ms'] / run['h100_ms']:.4f}x it; {card_line()}")
        tpu = {"tpu_launches": count, "tpu_ms": run["ms"], "tpu_config": cfg,
               "tpu_predicted_ms": est.total_time * 1e3, "tpu_h100_ms": run["h100_ms"]}
        rec = next((k for k in kernels + records if k["name"] == run["name"]), None)
        if rec is None:
            plain = cuda_ms(torch, run["plain"], warmup=1, reps=5)
            lib = run["library"] and cuda_ms(torch, run["library"], warmup=1, reps=5)
            rec = {"name": run["name"], "config": cfg, "source": run["source"],
                   "replaces": run["replaces"], "launches": count, "max_abs_err": run["err"],
                   "ms": run["ms"], "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib}
            records.append(rec)
            say(f"tpu P1 {path} fp{eb * 8}: new record {run['name']}: plain {plain:.4f} ms, "
                "library " + ("none" if lib is None else f"{lib:.4f} ms") + " (medians of 5)")
        rec.update(tpu)
        del run
        torch.cuda.empty_cache()
    t_phase = time.perf_counter() - t_phase
    say(f"tpu P1: {len(TPU_P1)} rankings and runs in {t_phase:.1f} s")
    return records


# the layers phase: norms, MLPs, the KV cache, MoE and the SSM blocks at
# the full width of the repo's configs (bf16, random weights from --seed)
LAYER_ROW_REL = 2e-2     # a bf16 module against its fp32 evaluation on the card: a bf16
                         # rounding adds at most 2^-9 relative error, no module here rounds
                         # more than five times in a chain (5 x 2^-9 = 9.8e-3); twice that
LAYER_DECODE = 16                        # decode steps after a cache's prefill
WHISPER_TOKENS = (8, 1500)               # (B, S): whisper-base's 1500 audio frames
MOE_TOKENS = (1, 4096)                   # (B, S) through one mixtral-8x7b MoE layer
MOE_DROP_FACTORS = (1.25, 1.0)           # capacity factors of the drop check: the default,
                                         # and the mean load, where some expert always drops
SSM_TOKENS = 4096                        # S of the chunked SSM calls, B 1
SSM_CHECK_TOKENS = 128                   # S of the chunked-against-recurrence check, fp32
SSM_CHECK_SCALE = 0.3                    # the input's scale there, as tests/test_ssm_numerics.py
SSM_RECURRENCE_TOL = {"mamba2": 3e-4, "rwkv6": 2e-4, "rwkv6_channel_mix": 2e-4}


def int8_row_rel_bound(head_dim: int) -> float:
    """The row relative error bound of attention through the int8 KV cache:
    the bf16 flash bound plus, for K and V each, the worst relative RMS of
    rounding to a per-(token, head) scale.  The rounding error is uniform in
    ±scale/2 with scale = max|x| / 127, an RMS of scale / sqrt(12), and a
    row's max is at most sqrt(D) times its RMS."""
    return FLASH_ROW_REL[2] + 2 * math.sqrt(head_dim) / (127 * math.sqrt(12))



def check_rows(torch, got, want, what: str, row_rel: float) -> tuple:
    """(max abs error, max row relative error) of ``got`` against ``want``;
    raises when the shapes differ, a value is not finite, or a row's
    relative L2 error exceeds ``row_rel``."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    if got.shape != want.shape:
        raise AssertionError(f"{what}: got {tuple(got.shape)}, want {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite output")
    err = float((got.float() - want.float()).abs().max())
    rel = row_rel_err(got, want)
    if rel > row_rel:
        raise AssertionError(f"{what}: row relative error {rel!r} exceeds {row_rel}")
    return err, rel


def gemm_flops(tokens: int, *shapes) -> float:
    """Operations of multiplying ``tokens`` rows by weights of each (K, N)."""
    return sum(2.0 * tokens * k * n for k, n in shapes)


def tensor_bytes(*trees) -> int:
    """Bytes of every tensor in ``trees`` (tensors, dicts of them, tuples)."""
    n = 0
    for t in trees:
        if isinstance(t, dict):
            n += tensor_bytes(*t.values())
        elif isinstance(t, (tuple, list)):
            n += tensor_bytes(*t)
        elif t is not None:
            n += t.numel() * t.element_size()
    return n


def fp32(params: dict) -> dict:
    """A copy of a nest of dicts of tensors in fp32."""
    return {k: fp32(v) if isinstance(v, dict) else v.float() for k, v in params.items()}


def run_layers_mlp(args, torch, dev) -> None:
    """L1: granite-3-2b's rmsnorm then SwiGLU at B 4 x 4096, whisper-base's
    layernorm then GELU MLP at B 8 x 1500, each held to an fp32 evaluation
    of the same functions on the card within LAYER_ROW_REL, and timed."""
    from repro_torch.configs import get_config
    from repro_torch.layers import mlp, norms

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for arch, (B, S) in (("granite-3-2b", PREFILL), ("whisper-base", WHISPER_TOKENS)):
        cfg = get_config(arch)
        E, Fd = cfg.d_model, cfg.d_ff
        norm = getattr(norms, cfg.norm)
        ffn = {"swiglu": mlp.swiglu, "gelu": mlp.gelu_mlp}[cfg.mlp]
        ffn_init = {"swiglu": mlp.swiglu_init, "gelu": mlp.gelu_mlp_init}[cfg.mlp]
        # a unit scale and a zero bias would not show whether the parameters count
        norm_p = {k: v + 0.1 * torch.randn(v.shape, generator=gen, device=dev)
                  for k, v in getattr(norms, f"{cfg.norm}_init")(E, device=dev).items()}
        ffn_p = ffn_init(E, Fd, torch.bfloat16, generator=gen, device=dev)
        if cfg.mlp == "gelu":
            ffn_p = {k: v + 0.02 if k.startswith("b") else v for k, v in ffn_p.items()}
        x = torch.randn((B, S, E), generator=gen, device=dev, dtype=torch.bfloat16)
        h = norm(norm_p, x)
        out = ffn(ffn_p, h)
        h32 = norm(norm_p, x.float())
        want = ffn(fp32(ffn_p), h32)
        n_err, n_rel = check_rows(torch, h, h32, f"{arch} {cfg.norm}", LAYER_ROW_REL)
        f_err, f_rel = check_rows(torch, out, want, f"{arch} {cfg.mlp}", LAYER_ROW_REL)
        del h32, want
        norm_ms = cuda_ms(torch, lambda: norm(norm_p, x))
        ffn_ms = cuda_ms(torch, lambda: ffn(ffn_p, h))
        n_in = 2 if cfg.mlp == "swiglu" else 1
        norm_bound, norm_by = bf16_bound(0.0, tensor_bytes(x, h, norm_p))
        ffn_bound, ffn_by = bf16_bound(gemm_flops(B * S, *[(E, Fd)] * n_in, (Fd, E)),
                                       tensor_bytes(h, out, ffn_p))
        say(f"layers L1 {arch}: x {(B, S, E)} bf16; {cfg.norm} {norm_ms:.4f} ms (bound "
            f"{norm_bound:.4f} ms, {norm_by}), against fp32 max abs error {n_err!r}, row "
            f"relative error {n_rel!r}; {ffn.__name__} d_ff {Fd} {ffn_ms:.4f} ms (bound "
            f"{ffn_bound:.4f} ms, {ffn_by}: {ffn_bound / ffn_ms:.1%}), against fp32 max abs error "
            f"{f_err!r}, row relative error {f_rel!r} (bound {LAYER_ROW_REL}); median of 20")
        del x, h, out, norm_p, ffn_p
        torch.cuda.empty_cache()


def decode_steps(torch, attention_apply, params, x, cache, start: int, kw: dict) -> tuple:
    """``LAYER_DECODE`` single-token steps through the cache from position
    ``start``: (their outputs (B, steps, E), each step's CUDA-event ms)."""
    B = x.shape[0]
    outs, events = [], []
    for i in range(LAYER_DECODE):
        pos = torch.full((B, 1), start + i, dtype=torch.int32, device=x.device)
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        o, cache = attention_apply(params, x[:, start + i:start + i + 1], positions=pos,
                                   cache=cache, **kw)
        ev[1].record()
        outs.append(o)
        events.append(ev)
    torch.cuda.synchronize()
    return torch.cat(outs, dim=1), [a.elapsed_time(b) for a, b in events]


def run_layers_cache(args, torch, dev) -> None:
    """L2: granite-3-2b's attention at B 4, a 4096-token prefill through
    ``attention_apply(cache=...)`` into a full cache of 4096 + 16 slots, then
    16 decode steps, bf16 and int8, held to ``attention_apply`` without a
    cache over all 4112 tokens; L3: mixtral-8x7b's sliding window at B 1, a
    ring cache of 4096 slots filled by the prefill, then 16 steps that wrap,
    held to windowed attention without a cache."""
    from repro_torch.configs import get_config
    from repro_torch.layers.attention import KVCache, attention_apply, attention_init

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for line, arch, B in (("L2", "granite-3-2b", PREFILL[0]), ("L3", "mixtral-8x7b", 1)):
        cfg = get_config(arch)
        H, KV, D, P = cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim, PREFILL[1]
        n = P + LAYER_DECODE
        window = cfg.swa_window or None
        capacity = window if window else n
        params = attention_init(cfg.d_model, H, KV, D, cfg.qkv_bias, torch.bfloat16,
                                generator=gen, device=dev)
        x = torch.randn((B, n, cfg.d_model), generator=gen, device=dev, dtype=torch.bfloat16)
        kw = dict(n_heads=H, n_kv=KV, head_dim=D, rope_theta=cfg.rope_theta, window=window)
        full, _ = attention_apply(params, x, **kw)
        for quantized in ((False, True) if line == "L2" else (False,)):
            cache = KVCache.init(B, KV, capacity, D, torch.bfloat16, quantized, device=dev)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            pre, cache = attention_apply(params, x[:, :P], cache=cache, **kw)
            ev[1].record()
            torch.cuda.synchronize()
            prefill_ms = ev[0].elapsed_time(ev[1])
            dec, step_ms = decode_steps(torch, attention_apply, params, x, cache, P, kw)
            kept = torch.arange(n - capacity, n, device=dev, dtype=torch.int32)
            if (int(cache.cursor.min()) != n or int(cache.cursor.max()) != n
                    or not torch.equal(cache.positions.sort(dim=1).values,
                                       kept.expand(B, capacity))):
                raise AssertionError(f"{arch} cache: cursor {cache.cursor.tolist()}, positions "
                                     f"not the last {capacity} tokens")
            what = f"{arch} {'int8' if quantized else 'bf16'} cache"
            if quantized:
                row_rel = int8_row_rel_bound(D)
                bound = f"row bound {row_rel:.4g}"
                p_err, p_rel = check_rows(torch, pre, full[:, :P], f"{what} prefill", row_rel)
                d_err, d_rel = check_rows(torch, dec, full[:, P:], f"{what} decode", row_rel)
            else:
                bound = f"atol {FLASH_TOL[2]['atol']}, row bound {FLASH_ROW_REL[2]}"
                p_err, p_rel = check_flash(torch, pre, full[:, :P], f"{what} prefill", 2)
                d_err, d_rel = check_flash(torch, dec, full[:, P:], f"{what} decode", 2)
            step_bound, step_by = bf16_bound(gemm_flops(
                B, (cfg.d_model, (H + 2 * KV) * D), (H * D, cfg.d_model)),
                tensor_bytes(params, tuple(cache)))
            say(f"layers {line} {arch}: {H}/{KV} heads, D {D}, B {B}, window {window}, "
                f"{'ring' if window else 'full'} cache of {capacity} slots "
                f"({'int8 with per-(token, head) scales' if quantized else 'bf16'}): prefill of "
                f"{P} tokens {prefill_ms:.3f} ms, max abs error {p_err!r}, row relative error "
                f"{p_rel!r}; {LAYER_DECODE} decode steps median {statistics.median(step_ms):.4f} "
                f"ms (min {min(step_ms):.4f}, max {max(step_ms):.4f}; bound {step_bound:.4f} ms, "
                f"{step_by}), max abs error {d_err!r}, row relative error {d_rel!r}, against "
                f"attention_apply without a cache over {n} tokens ({bound})")
            del cache, pre, dec
        del params, x, full
        torch.cuda.empty_cache()


def moe_oracle(torch, F, p, x, exp_idx, weights) -> torch.Tensor:
    """sum over k of weights[t, k] * SwiGLU_{exp_idx[t, k]}(x_t) in fp32, one
    expert at a time over the tokens that chose it.  x: (n, E)."""
    out = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for e in range(p["router"].shape[1]):
        w = (weights * (exp_idx == e)).sum(dim=-1)
        rows = (exp_idx == e).any(dim=-1).nonzero()[:, 0]
        xe = x[rows].float()
        o = (F.silu(xe @ p["w_gate"][e].float()) * (xe @ p["w_up"][e].float())) \
            @ p["w_down"][e].float()
        out.index_add_(0, rows, w[rows, None] * o)
    return out


def run_layers_moe(args, torch, dev) -> None:
    """L4: one mixtral-8x7b MoE layer (8 experts, d_ff 14336) at B 1 x 4096:
    top-1 at capacity factor 8 against the dense argmax-expert oracle; then
    the default top-2 at capacity factors 1.25 and 1.0 against the oracle of
    the kept pairs (each dropped (token, k) pair adding nothing), timed at
    1.25."""
    import torch.nn.functional as F

    from repro_torch.configs import get_config
    from repro_torch.layers.moe import moe_apply, moe_init, moe_route

    cfg = get_config("mixtral-8x7b")
    E, Fd, X = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    p = moe_init(E, Fd, X, torch.bfloat16, generator=gen, device=dev)
    x = torch.randn((*MOE_TOKENS, E), generator=gen, device=dev, dtype=torch.bfloat16)
    n = MOE_TOKENS[0] * MOE_TOKENS[1]
    xt = x.reshape(n, E)
    best = (xt.float() @ p["router"]).argmax(dim=-1)
    r1 = moe_route(p, x, top_k=1, capacity_factor=8.0)
    if not bool(r1.keep.all()) or not torch.equal(r1.exp_idx.reshape(n), best):
        raise AssertionError("moe top-1 at capacity factor 8: routing is not every token's "
                             "argmax expert, all kept")
    out1 = moe_apply(p, x, top_k=1, capacity_factor=8.0)
    want = moe_oracle(torch, F, p, xt, best[:, None], torch.ones((n, 1), device=dev))
    err1, rel1 = check_rows(torch, out1.reshape(n, E), want, "moe top-1 vs dense oracle",
                            LAYER_ROW_REL)
    del out1, want
    lines, capacity = [], {}
    for factor in MOE_DROP_FACTORS:
        r = moe_route(p, x, top_k=cfg.top_k, capacity_factor=factor)
        capacity[factor] = r.capacity
        out = moe_apply(p, x, top_k=cfg.top_k, capacity_factor=factor).reshape(n, E)
        keep = r.keep.reshape(r.groups, cfg.top_k, -1).transpose(1, 2).reshape(n, cfg.top_k)
        exp_idx, gates = r.exp_idx.reshape(n, cfg.top_k), r.gates.reshape(n, cfg.top_k)
        dropped = int((~keep).sum())
        kept_w = gates * keep
        err, rel = check_rows(torch, out, moe_oracle(torch, F, p, xt, exp_idx, kept_w),
                              f"moe top-{cfg.top_k} capacity factor {factor} vs kept pairs",
                              LAYER_ROW_REL)
        none_kept = ~keep.any(dim=-1)
        if bool(out[none_kept].any()):
            raise AssertionError(f"moe capacity factor {factor}: a token with every pair "
                                 "dropped has a nonzero output")
        part = (~keep).any(dim=-1) & keep.any(dim=-1)
        seen = "no dropped pair"
        if dropped:
            from repro_torch.kernels.flash_attention.ref import row_rel_err

            with_drops = moe_oracle(torch, F, p, xt[part], exp_idx[part], gates[part])
            missed = row_rel_err(out[part], with_drops)
            if missed <= LAYER_ROW_REL:
                raise AssertionError(f"moe capacity factor {factor}: the row bound cannot tell "
                                     f"a dropped pair (row relative error {missed!r})")
            seen = (f"rows with a dropped pair read {missed!r} against the oracle that keeps "
                    f"them (the bound rejects that)")
        elif factor == min(MOE_DROP_FACTORS):
            raise AssertionError(f"moe capacity factor {factor}: no pair dropped, so the check "
                                 "that dropped pairs add nothing saw none")
        lines.append(f"capacity factor {factor} (capacity {r.capacity} slots an expert): "
                     f"{dropped} of {n * cfg.top_k} (token, k) pairs dropped, "
                     f"{int(none_kept.sum())} tokens with none kept and zero out; against "
                     f"the oracle of the kept pairs max abs error {err!r}, row relative error "
                     f"{rel!r}; {seen}")
        del out, r
    C = capacity[MOE_DROP_FACTORS[0]]
    ms = cuda_ms(torch, lambda: moe_apply(p, x, top_k=cfg.top_k,
                                          capacity_factor=MOE_DROP_FACTORS[0]))
    bound, by = bf16_bound(gemm_flops(X * C, (E, Fd), (E, Fd), (Fd, E)), tensor_bytes(p, x, x))
    say(f"layers L4 mixtral-8x7b MoE: d_model {E}, d_ff {Fd}, {X} experts (weights "
        f"{tensor_bytes(p) / 1e9:.2f} GB bf16), x {tuple(x.shape)}; top-1 at capacity factor 8 "
        f"against the dense argmax-expert oracle (fp32): max abs error {err1!r}, row relative "
        f"error {rel1!r} (bound {LAYER_ROW_REL}); top-{cfg.top_k}: " + "; ".join(lines)
        + f"; moe_apply at capacity factor {MOE_DROP_FACTORS[0]} {ms:.4f} ms (bound {bound:.4f} "
        f"ms over the {X} x {C} expert slots, {by}: {bound / ms:.1%}), median of 20")
    del p, x
    torch.cuda.empty_cache()


def mamba2_scan_flops(B, S, H, P, N, L) -> float:
    """The products of Mamba2's chunked scan: C·B^T, the intra-chunk mix,
    the state's read and its update."""
    return -(-S // L) * (2.0 * B * L * L * N + 2.0 * B * H * L * L * P + 4.0 * B * H * L * P * N)


def rwkv6_scan_flops(B, S, H, K, L) -> float:
    """The products of RWKV6's chunked scan: scores, the intra-chunk mix,
    the state's read and its update."""
    return -(-S // L) * (4.0 * B * H * L * L * K + 4.0 * B * H * L * K * K)


def run_layers_ssm(args, torch, dev) -> None:
    """L5: zamba2-2.7b's Mamba2 and rwkv6-1.6b's time mix and channel mix,
    bf16, B 1: the chunked call at S 4096, timed; the chunked form against
    the exact per-token recurrence at S 128 in fp32 (outputs and final
    state, the reference's tests/test_ssm_numerics.py tolerances); one
    decode step from the S 4096 call's state, timed."""
    from repro_torch.configs import get_config
    from repro_torch.layers import shapes
    from repro_torch.layers.ssm import (
        mamba2_apply,
        mamba2_init,
        rwkv6_apply,
        rwkv6_channel_mix,
        rwkv6_channel_mix_init,
        rwkv6_init,
    )

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    zamba, rwkv = get_config("zamba2-2.7b"), get_config("rwkv6-1.6b")
    md = shapes.mamba2_dims(zamba.d_model, zamba.ssm_state, zamba.ssm_head_dim)
    rd = shapes.rwkv6_dims(rwkv.d_model, rwkv.ssm_head_dim)
    mk = dict(d_state=zamba.ssm_state, head_dim=zamba.ssm_head_dim)
    blocks = (
        ("mamba2", zamba, mamba2_init(zamba.d_model, zamba.ssm_state, zamba.ssm_head_dim,
                                      dtype=torch.bfloat16, generator=gen, device=dev),
         lambda p, x, s: mamba2_apply(p, x, s, **mk),
         lambda S: (gemm_flops(S, (zamba.d_model, md["d_in_proj"]), (md["d_inner"], zamba.d_model)),
                    mamba2_scan_flops(1, S, md["n_heads"], md["head_dim"], md["d_state"],
                                      md["chunk"]))),
        ("rwkv6", rwkv, rwkv6_init(rwkv.d_model, rwkv.ssm_head_dim, dtype=torch.bfloat16,
                                   generator=gen, device=dev),
         lambda p, x, s: rwkv6_apply(p, x, s, head_dim=rwkv.ssm_head_dim),
         lambda S: (gemm_flops(S, *[(rwkv.d_model, rwkv.d_model)] * 5, (rwkv.d_model, 64),
                               (64, rwkv.d_model)),
                    rwkv6_scan_flops(1, S, rd["n_heads"], rd["head_dim"], rd["chunk"]))),
        ("rwkv6_channel_mix", rwkv, rwkv6_channel_mix_init(rwkv.d_model, rwkv.d_ff,
                                                           torch.bfloat16, generator=gen,
                                                           device=dev),
         rwkv6_channel_mix,
         lambda S: (gemm_flops(S, (rwkv.d_model, rwkv.d_ff), (rwkv.d_ff, rwkv.d_model),
                               (rwkv.d_model, rwkv.d_model)), 0.0)),
    )
    for name, cfg, p, apply, flops in blocks:
        E = cfg.d_model
        x = torch.randn((1, SSM_TOKENS, E), generator=gen, device=dev, dtype=torch.bfloat16)
        y, state = apply(p, x, None)
        if y.shape != x.shape or y.dtype != x.dtype or not bool(torch.isfinite(y).all()):
            raise AssertionError(f"{name}: chunked output {tuple(y.shape)} {y.dtype}, or not finite")
        chunked_ms = cuda_ms(torch, lambda: apply(p, x, None))
        gemm, scan = flops(SSM_TOKENS)
        bound, by = bf16_bound(gemm, tensor_bytes(p, x, y), scan)
        x1 = torch.randn((1, 1, E), generator=gen, device=dev, dtype=torch.bfloat16)
        step_ms = cuda_ms(torch, lambda: apply(p, x1, state))
        # the recurrence's own products are a few per state element: not counted
        step_bound, step_by = bf16_bound(flops(1)[0], tensor_bytes(p, x1, state))

        # the chunked form against the exact recurrence, fp32, as the reference's test
        p32 = fp32(p)
        xs = torch.randn((1, SSM_CHECK_TOKENS, E), generator=gen, device=dev) * SSM_CHECK_SCALE
        y_chunk, st_chunk = apply(p32, xs, None)
        st = (xs.new_zeros(1, E) if name == "rwkv6_channel_mix"
              else type(st_chunk)(*(torch.zeros_like(t) for t in st_chunk)))
        outs = []
        for t in range(SSM_CHECK_TOKENS):
            yt, st = apply(p32, xs[:, t:t + 1], st)
            outs.append(yt)
        y_seq = torch.cat(outs, dim=1)
        tol = SSM_RECURRENCE_TOL[name]
        final = (("token shift", st_chunk, st) if name == "rwkv6_channel_mix" else
                 ("state", st_chunk[0], st[0]))
        errs = {}
        for what, got, want in (("output", y_chunk, y_seq), final):
            errs[what] = float((got - want).abs().max())
            if not torch.allclose(got, want, rtol=tol, atol=tol):
                raise AssertionError(f"{name}: chunked {what} against the recurrence, max abs "
                                     f"error {errs[what]!r} exceeds rtol = atol = {tol}")
        say(f"layers L5 {name} ({cfg.name}, d_model {E}"
            + (f", d_state {cfg.ssm_state}, head_dim {cfg.ssm_head_dim}" if name == "mamba2" else
               f", d_ff {cfg.d_ff}" if name == "rwkv6_channel_mix" else
               f", head_dim {cfg.ssm_head_dim}")
            + f", bf16, B 1): chunked at S {SSM_TOKENS} {chunked_ms:.4f} ms (bound {bound:.4f} "
            f"ms, {by}: {bound / chunked_ms:.1%}); one decode step {step_ms:.4f} ms (bound "
            f"{step_bound:.4f} ms, {step_by}); chunked against the per-token recurrence at S "
            f"{SSM_CHECK_TOKENS} in fp32: output max abs error {errs['output']!r}, final "
            f"{final[0]} {errs[final[0]]!r} (rtol = atol = {tol}); median of 20")
        del x, y, state, p32, xs, y_chunk, st_chunk, st, outs, y_seq
        torch.cuda.empty_cache()


def run_layers(args, torch, dev) -> None:
    """The layers phase: L1 norms and MLPs, L2 the KV cache, L3 the ring
    cache, L4 MoE, L5 the SSM blocks, each at the full width of a config of
    the repo.  Their products are torch's einsums, as the reference leaves
    them to XLA: the phase launches none of the port's kernels, and checks
    that it did not."""
    reset_counts()
    for run in (run_layers_mlp, run_layers_cache, run_layers_moe, run_layers_ssm):
        run(args, torch, dev)
        torch.cuda.empty_cache()
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"the layers phase launched the port's kernels {launched}")
    say("layers: L1-L5 launched none of the port's kernels (their products are torch.einsum)")


# the lm phase: whole models of the repo's configs served through the port's
# LM stack (models.lm, train.step, launch.serve), bf16, random weights from
# --seed.  The stack runs eager torch ops and torch.einsum, as the reference
# leaves them to XLA: it launches none of the port's kernels.
LM_ARCH = "granite-3-2b"                 # M1 and M2: the repo's config, whole
LM_BATCH, LM_REQUESTS = 4, 8             # two waves of four
LM_PROMPT, LM_GEN = 512, 64              # tokens of a prompt, tokens generated a request
LM_M3_STEPS, LM_M3_BATCH = 8, 2         # decode steps and batch of each other block pattern
# (arch, layers kept, 0 for all) of M3: mixtral-8x7b is cut to 2 of its 32
# layers (about 94 GB whole in bf16)
LM_M3 = (("rwkv6-1.6b", 0), ("zamba2-2.7b", 0), ("whisper-base", 0), ("mixtral-8x7b", 2))
# M1's bf16 logits against forward without caches: the decode step's GEMMs (4
# rows) and the teacher-forced forward's (2300) sum in other orders, so their
# bf16 roundings part here and there and the parting grows through 40 layers:
# 2.03e-2 at most over M1's 504 decode rows (an H100 80GB HBM3 at 700 W).  A step at its
# position + 1 read 0.29 and one without the prefill's last cache slot 0.052
# there; the bound sits between, and each run checks both wrong steps against it
LM_ROW_REL = 3.5e-2
# the bf16 model against its fp32 evaluation: each of 40 layers rounds its
# output at least five times to bf16 (2^-9 each), the fp32 one never: in
# quadrature sqrt(5 x 40) x 2^-9 = 2.8e-2, and twice that
LM_FP32_ROW_REL = 2 * math.sqrt(5 * 40) * 2.0 ** -9
# M3's fp32 check: the two sides sum in other orders (the chunked scans against
# the per-token recurrences, GEMMs of 2 rows against 1040), each part near
# 1e-6 of its row, and the depth grows it: zamba2-2.7b's 54 Mamba2 layers read
# 7.6e-4, the other three 8.6e-7-6.7e-5 (an H100 80GB HBM3 at 700 W); in bf16 the same
# parting reads 1e-3-0.31, so bf16 is timed and fp32 held.  A decode step at
# its position + 1 reads 0.29 in M1
LM_M3_ROW_REL = 5e-3
LM_INT8_TOL = dict(atol=0.15, rtol=0.05)  # tests/test_optimizations.py:50-52
# leaves that scale or shift elementwise (no GEMM) in the operation count
LM_ELEMENTWISE = {"mu", "bonus_u", "conv_w", "scale", "bias", "A_log", "dt_bias", "norm_scale",
                  "decay_base", "bq", "bk", "bv", "b_up", "b_down"}


def named_leaves(tree, prefix=()):
    """(path, tensor) of every tensor in a nest of dicts."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def token_weights(cfg, tree) -> float:
    """Weights one token multiplies in ``tree``'s GEMMs: every matrix leaf,
    a MoE expert's at top_k / n_experts."""
    n = 0.0
    for path, t in named_leaves(tree):
        if path[-1] not in LM_ELEMENTWISE:
            expert = "moe" in path and path[-1] != "router"
            n += t.numel() * (cfg.top_k / cfg.n_experts if expert else 1.0)
    return n


def lm_work(cfg, params, B: int, S: int, pos: int, cache_entry_bytes: int) -> tuple:
    """(prefill operations of B prompts of S tokens, operations and bytes
    of a decode step at position ``pos``).  Operations: 2 a weight a token
    multiplies (a MoE expert's at top_k / n_experts; the lm_head for the
    prefill's last token only; whisper's encoder over its frames and its
    cross-attention K and V, which a decode step recomputes), plus
    attention's 4·H·D a (query, key) pair it must see (causal: S(S+1)/2 a
    head, within the window).  Bytes: every weight a decode step reads (all
    but the embedding table, of which it gathers B rows; of a MoE layer's
    experts the min(n_experts, B·top_k) it can reach), each KV entry it sees
    once (``cache_entry_bytes`` a token and KV head, K and V), each SSM
    state read and written once, whisper's encoder output once a layer."""
    H, D, E = cfg.n_heads, cfg.resolved_head_dim, cfg.d_model
    win = cfg.swa_window or 1 << 62
    dec = token_weights(cfg, params["layers"])
    n_attn = cfg.n_layers if cfg.block_pattern == "attn" else 0
    if cfg.block_pattern == "mamba_hybrid":
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        dec += n_attn * token_weights(cfg, params["shared_attn"])
    N = cfg.frontend_tokens if cfg.enc_layers else 0
    enc_ops = cross_kv = 0.0
    if cfg.enc_layers:
        cross = params["cross_layers"]["attn"]
        dec += cross["wq"].numel() + cross["wo"].numel()
        cross_kv = 2.0 * B * N * (cross["wk"].numel() + cross["wv"].numel())
        enc_ops = (2.0 * B * N * token_weights(cfg, params["enc_layers"])
                   + 4.0 * B * H * D * N * N * cfg.enc_layers
                   + 2.0 * B * N * params["frontend_proj"].numel())
    head = params["lm_head"].numel()
    pairs = sum(min(i + 1, win) for i in range(S))
    prefill = (2.0 * B * S * dec + 2.0 * B * head + 4.0 * B * H * D * pairs * n_attn
               + enc_ops + cross_kv + 4.0 * B * H * D * S * N * (cfg.n_layers if N else 0))
    seen = min(pos + 1, win)
    step_ops = (2.0 * B * (dec + head) + 4.0 * B * H * D * seen * n_attn + cross_kv
                + 4.0 * B * H * D * N * (cfg.n_layers if N else 0))
    step_bytes = 0
    for path, t in named_leaves(params):
        if path[0] == "enc_layers" or path == ("frontend_proj",):
            continue
        share = 1.0
        if path[0] == "embed":
            share = B / t.shape[0]
        elif "moe" in path and path[-1] != "router":
            share = min(cfg.n_experts, B * cfg.top_k) / cfg.n_experts
        step_bytes += t.numel() * t.element_size() * share
    step_bytes += n_attn * B * cfg.n_kv * seen * cache_entry_bytes
    if cfg.block_pattern == "rwkv":
        K = cfg.ssm_head_dim
        step_bytes += 2 * cfg.n_layers * B * (E // K) * K * K * 4
    elif cfg.block_pattern == "mamba_hybrid":
        step_bytes += 2 * cfg.n_layers * B * 2 * E * cfg.ssm_state * 4
    if N:
        step_bytes += cfg.n_layers * B * N * E * 2
    return prefill, step_ops, step_bytes


def lm_rows(torch, got, want, what: str, bound: float) -> float:
    """Largest row relative L2 error of logits ``got`` against ``want``;
    raises when the shapes differ, a value is not finite, or it exceeds
    ``bound``."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    if got.shape != want.shape:
        raise AssertionError(f"{what}: got {tuple(got.shape)}, want {tuple(want.shape)}")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: non-finite logits")
    rel = row_rel_err(got, want)
    if rel > bound:
        raise AssertionError(f"{what}: row relative error {rel!r} exceeds {bound}")
    return rel


def lm_rejects(torch, wrong, want, what: str, bound: float) -> float:
    """Raise unless ``bound`` rejects ``wrong``, logits of a decode step
    made wrong on purpose; its row relative error."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err

    rel = row_rel_err(wrong, want)
    if not rel > bound:
        raise AssertionError(f"{what}: the row bound {bound} passes it (row relative error "
                             f"{rel!r})")
    return rel


def clone_kv(caches: dict) -> dict:
    return {k: type(c)(*(None if t is None else t.clone() for t in c)) for k, c in caches.items()}


def run_lm_granite(args, torch, dev) -> float:
    """M1: granite-3-2b whole through ``launch.serve``'s loop, its prefill
    and decode logits held to ``forward`` without caches (teacher-forced
    over the prompt and the generated tokens), the bf16 prefill to an fp32
    evaluation of the same weights, and two wrong decode steps (a position
    off by one; the prefill's last cache slot missing) rejected by the same
    bound.  M2: the same model over an int8 cache, fed M1's tokens, held
    to M1's logits at the reference's int8 bounds.  Returns M1's median
    decode-step ms."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import row_rel_err
    from repro_torch.launch.serve import serve
    from repro_torch.models.lm import forward, init_params
    from repro_torch.train.step import make_decode_step, make_prefill_step

    cfg = get_config(LM_ARCH)
    B, S, G = LM_BATCH, LM_PROMPT, LM_GEN
    cap = S + G + 8
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    t0 = time.perf_counter()
    params = init_params(cfg, generator=gen, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for _, t in named_leaves(params))
    lines = []
    res = serve(cfg, params, batch=B, requests=LM_REQUESTS, prompt_len=S, gen_len=G,
                generator=gen, device=dev, keep_logits=True, log=lines.append)
    for line in lines:
        say(f"lm M1 {line}")
    if sorted(res.outputs) != list(range(LM_REQUESTS)) or any(
            len(v) != G for v in res.outputs.values()):
        raise AssertionError("lm M1: not every request was answered once with "
                             f"{G} tokens: {sorted(res.outputs)}")
    pre_rel, dec_rel = [], []
    with torch.inference_mode():
        for w in res.waves:
            alone, _, _ = forward(cfg, params, w.prompts, last_only=True)
            pre_rel.append(lm_rows(torch, w.prefill_logits, alone[:, 0],
                                   "lm M1 prefill against forward without caches", LM_ROW_REL))
            fed = torch.cat([w.prompts, w.tokens[:, :-1].long()], dim=1)
            tf = forward(cfg, params, fed)[0][:, S - 1:]
            steps = torch.stack(w.decode_logits, dim=1)
            dec_rel.append(max(lm_rows(torch, steps[:, i], tf[:, i + 1],
                                       f"lm M1 decode step {i} against the teacher-forced "
                                       "forward", LM_ROW_REL) for i in range(G - 1)))
            if w is res.waves[0]:
                first = tf[:, 1].clone()
            del tf, steps, alone
        # two wrong steps on wave 0's prefill, and the honest one
        w = res.waves[0]
        prefill, decode = make_prefill_step(cfg, cap), make_decode_step(cfg)
        _, caches, _ = prefill(params, w.prompts)
        tok, at = w.tokens[:, :1], torch.full((B, 1), S, dtype=torch.int32, device=dev)
        off, _ = decode(params, tok, clone_kv(caches), at + 1)
        off_rel = lm_rejects(torch, off, first, "lm M1 a decode step at its position + 1",
                             LM_ROW_REL)
        missing = clone_kv(caches)
        missing["kv"].positions[:, :, S - 1] = -1
        miss, _ = decode(params, tok, missing, at)
        miss_rel = lm_rejects(torch, miss, first, "lm M1 a decode step without the prefill's "
                              "last cache slot", LM_ROW_REL)
        ok, _ = decode(params, tok, caches, at)
        ok_rel = lm_rows(torch, ok, first, "lm M1 the same decode step", LM_ROW_REL)
        del caches, missing, off, miss, ok
        # the bf16 model against an fp32 evaluation of the same weights
        cfg32 = dataclasses.replace(cfg, param_dtype="float32")
        params32 = fp32(params)
        want32, _, _ = forward(cfg32, params32, w.prompts, last_only=True)
        del params32
        torch.cuda.empty_cache()
        fp32_rel = lm_rows(torch, w.prefill_logits, want32[:, 0],
                           "lm M1 bf16 prefill against its fp32 evaluation", LM_FP32_ROW_REL)
        del want32

    prefill_ops, step_ops, step_bytes = lm_work(cfg, params, B, S, S + G // 2,
                                                2 * 2 * cfg.resolved_head_dim)
    pre_bound, pre_by = bf16_bound(prefill_ops, 0.0)
    dec_bound, dec_by = bf16_bound(step_ops, step_bytes)
    dec_ms = [s * 1e3 for s in res.decode_s]
    med = statistics.median(dec_ms)
    weights = tensor_bytes(params)
    say(f"lm M1 {LM_ARCH} whole: {cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads}/"
        f"{cfg.n_kv} heads, d_ff {cfg.d_ff}, padded vocab {cfg.padded_vocab}, "
        f"{n_params / 1e9:.4f} B parameters ({weights / 1e9:.3f} GB bf16, drawn in "
        f"{init_s:.2f} s); launch.serve B {B}, {LM_REQUESTS} requests in {len(res.waves)} "
        f"waves, prompt {S}, {G} tokens generated, bf16 caches of {cap} slots: prefill "
        + ", ".join(f"{s * 1e3:.2f}" for s in res.prefill_s)
        + f" ms a wave (bound {pre_bound:.3f} ms, {pre_by}: {prefill_ops / 1e12:.2f} TFLOP at "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s); decode step median {med:.3f} ms over "
        f"{len(dec_ms)} steps (min {min(dec_ms):.3f}, max {max(dec_ms):.3f}; bound "
        f"{dec_bound:.4f} ms, {dec_by}: {step_bytes / 1e9:.3f} GB at position {S + G // 2}), "
        f"{LM_REQUESTS * G / res.total_s:.1f} tokens/s over the loop's {res.total_s:.2f} s, "
        f"{B / med * 1e3:.1f} tokens/s in decode (bound {B / dec_bound * 1e3:.0f})")
    say(f"lm M1 checks: prefill's last logits against forward without caches, row relative "
        f"error {max(pre_rel)!r}; each wave's {G - 1} decode steps against the teacher-forced "
        f"forward over its {S} + {G - 1} tokens {max(dec_rel)!r} (bound {LM_ROW_REL}); the "
        f"bf16 prefill against its fp32 evaluation {fp32_rel!r} (bound {LM_FP32_ROW_REL}); "
        f"wave 0's first decode step again {ok_rel!r}, at its position + 1 {off_rel!r} and "
        f"without the prefill's last cache slot {miss_rel!r}: both rejected")

    # M2: the int8 cache, fed M1's wave-0 tokens
    cfg8 = dataclasses.replace(cfg, kv_int8=True)
    prefill8, decode8 = make_prefill_step(cfg8, cap), make_decode_step(cfg8)
    w = res.waves[0]
    errs, rels, times = [], [], []
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg, caches, _ = prefill8(params, w.prompts)
        torch.cuda.synchronize()
        pre8 = (time.perf_counter() - t0) * 1e3
        if caches["kv"].k.dtype != torch.int8:
            raise AssertionError(f"lm M2: the cache holds {caches['kv'].k.dtype}, not int8")
        pairs = [(lg, w.prefill_logits)]
        for i in range(G - 1):
            at = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
            t0 = time.perf_counter()
            lg, caches = decode8(params, w.tokens[:, i:i + 1], caches, at)
            torch.cuda.synchronize()
            times.append((time.perf_counter() - t0) * 1e3)
            pairs.append((lg, w.decode_logits[i]))
        for got, want in pairs:
            errs.append(check_close(torch, got, want, "lm M2 int8 cache against bf16",
                                    **LM_INT8_TOL))
            rels.append(row_rel_err(got, want))
        del caches
    _, step8_ops, step8_bytes = lm_work(cfg, params, B, S, S + G // 2,
                                        2 * (cfg.resolved_head_dim + 4))
    dec8_bound, dec8_by = bf16_bound(step8_ops, step8_bytes)
    med8 = statistics.median(times)
    say(f"lm M2 {LM_ARCH} whole, int8 KV cache (per-(token, head) scales) fed wave 0's tokens: "
        f"prefill {pre8:.2f} ms, decode step median {med8:.3f} ms over {len(times)} (min "
        f"{min(times):.3f}, max {max(times):.3f}; bound {dec8_bound:.4f} ms, {dec8_by}), "
        f"{med8 / med:.3f}x M1's; logits against M1's bf16-cache logits max abs error "
        f"{max(errs)!r} (atol {LM_INT8_TOL['atol']}, rtol {LM_INT8_TOL['rtol']}, "
        f"tests/test_optimizations.py:50-52), row relative error {max(rels)!r}")
    del params, res
    torch.cuda.empty_cache()
    return med


def run_lm_others(args, torch, dev) -> None:
    """M3: each other block pattern at full width (``LM_M3``), bf16 as
    configured: a prefill of ``LM_PROMPT`` tokens at B 2 and
    ``LM_M3_STEPS`` greedy decode steps through ``train.step``, timed.
    Then the check, in fp32 (the same weights cast, fp32 caches): the
    prefill and decode steps fed the bf16 run's tokens, each step's logits
    held to the teacher-forced ``forward`` without caches within
    ``LM_M3_ROW_REL``.  The MoE runs both sides without drops (a capacity
    of every token: the default drops pairs a call, and the two sides'
    calls hold different tokens) and with its routing held equal."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.kernels.flash_attention.ref import row_rel_err
    from repro_torch.launch.serve import request_prompt
    from repro_torch.layers.moe import moe_route
    from repro_torch.models import lm
    from repro_torch.train.step import make_decode_step, make_prefill_step

    S, steps, B = LM_PROMPT, LM_M3_STEPS, LM_M3_BATCH
    real_moe = lm.moe_apply
    for arch, keep in LM_M3:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=keep) if keep else full
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = lm.init_params(cfg, generator=gen, device=dev)
        prompts = torch.stack([request_prompt(cfg, r, S) for r in range(B)]).to(dev)
        frontend = (torch.randn((B, cfg.frontend_tokens, cfg.frontend_dim), generator=gen,
                                device=dev) if cfg.frontend else None)
        prefill, decode = make_prefill_step(cfg, S + steps + 8), make_decode_step(cfg)
        dropped = []

        def counted(p, x, **kw):
            dropped.append(int((~moe_route(p, x, top_k=kw["top_k"]).keep).sum()))
            return real_moe(p, x, **kw)

        lm.moe_apply = counted
        try:
            with torch.inference_mode():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                lg, caches, enc = prefill(params, prompts, frontend)
                tok = lg.argmax(-1)[:, None].to(torch.int32)
                torch.cuda.synchronize()
                pre_ms = (time.perf_counter() - t0) * 1e3
                got, toks, times = [lg], [tok], []
                for i in range(steps):
                    at = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
                    t0 = time.perf_counter()
                    lg, caches = decode(params, tok, caches, at, enc)
                    tok = lg.argmax(-1)[:, None].to(torch.int32)
                    torch.cuda.synchronize()
                    times.append((time.perf_counter() - t0) * 1e3)
                    got.append(lg)
                    toks.append(tok)
                got = torch.stack(got, dim=1)
                if not bool(torch.isfinite(got).all()):
                    raise AssertionError(f"lm M3 {arch}: non-finite logits")
                fed = torch.cat([prompts, torch.cat(toks[:-1], dim=1).long()], dim=1)
                served_drops = list(dropped)
                bf16_rel = row_rel_err(got, lm.forward(cfg, params, fed,
                                                       frontend_embeds=frontend)[0][:, S - 1:])
        finally:
            lm.moe_apply = real_moe
        del caches, enc
        rel, routed = lm_check_fp32(torch, dev, cfg, params, prompts, frontend, toks)
        entry = 2 * 2 * cfg.resolved_head_dim
        prefill_ops, step_ops, step_bytes = lm_work(cfg, params, B, S, S + steps // 2, entry)
        pre_bound, pre_by = bf16_bound(prefill_ops, 0.0)
        dec_bound, dec_by = bf16_bound(step_ops, step_bytes)
        weights = tensor_bytes(params)
        cut = ""
        if keep:
            whole = weights + tensor_bytes(params["layers"]) / keep * (full.n_layers - keep)
            cut = (f", cut to {keep} of its {full.n_layers} layers ({whole / 1e9:.1f} GB whole "
                   "in bf16; one card holds 80)")
        med = statistics.median(times)
        say(f"lm M3 {arch}{cut}: {cfg.block_pattern}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {weights / 1e9:.3f} GB bf16"
            + (f", window {cfg.swa_window}" if cfg.swa_window else "")
            + (f", encoder {cfg.enc_layers} layers over {cfg.frontend_tokens} random frames"
               if cfg.enc_layers else "")
            + f"; B {B}, prefill of {S} tokens {pre_ms:.2f} ms (bound {pre_bound:.3f} ms, "
            f"{pre_by}), {steps} decode steps median {med:.3f} ms (min {min(times):.3f}, max "
            f"{max(times):.3f}; bound {dec_bound:.4f} ms, {dec_by})"
            + (f"; MoE pairs dropped a call {served_drops} (capacity factor 1.25)"
               if cfg.n_experts else "")
            + f"; in fp32, the prefill's and each step's logits against the teacher-forced "
            f"forward over {S} + {steps} tokens, row relative error {rel!r} (bound "
            f"{LM_M3_ROW_REL}){routed}; bf16 against its own teacher-forced forward {bf16_rel!r} "
            "(not held: bf16 roundings grown through the depth"
            + (", and pairs dropped apart" if cfg.n_experts else "") + ")")
        del params, got
        torch.cuda.empty_cache()


def lm_check_fp32(torch, dev, cfg, params, prompts, frontend, toks) -> tuple:
    """M3's check: ``params`` cast to fp32 over fp32 caches, a prefill and
    a decode step for each of ``toks`` but the last, each step's logits
    against the teacher-forced ``forward`` without caches; the MoE without
    drops on both sides and its routing held equal.  (row relative error,
    a note on the routing)."""
    import dataclasses

    from repro_torch.layers.moe import moe_route
    from repro_torch.models import lm
    from repro_torch.train.step import make_decode_step

    B, S = prompts.shape
    steps = len(toks) - 1
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = fp32(params)
    routes = []
    real_moe = lm.moe_apply

    def dropless(p, x, **kw):
        # a capacity of every token of the call: no pair drops
        factor = cfg.n_experts / kw["top_k"]
        r = moe_route(p, x, top_k=kw["top_k"], capacity_factor=factor)
        routes.append((r.exp_idx.reshape(x.shape[0], x.shape[1], -1).sort(-1).values,
                       int((~r.keep).sum())))
        return real_moe(p, x, capacity_factor=factor, **kw)

    lm.moe_apply = dropless
    try:
        with torch.inference_mode():
            caches = lm.init_caches(cfg32, B, S + steps + 8, torch.float32, device=dev)
            lg, caches, enc = lm.forward(cfg32, p32, prompts, caches=caches,
                                         frontend_embeds=frontend, last_only=True)
            got = [lg[:, -1]]
            decode = make_decode_step(cfg32)
            for i in range(steps):
                at = torch.full((B, 1), S + i, dtype=torch.int32, device=dev)
                lg, caches = decode(p32, toks[i], caches, at, enc)
                got.append(lg)
            served = len(routes)
            fed = torch.cat([prompts, torch.cat(toks[:-1], dim=1).long()], dim=1)
            tf = lm.forward(cfg32, p32, fed, frontend_embeds=frontend)[0][:, S - 1:]
    finally:
        lm.moe_apply = real_moe
    routed = ""
    if cfg.n_experts:
        L = cfg.n_layers
        pre, dec, want = routes[:L], routes[L:served], routes[served:]
        other = [int((pre[layer][0] != want[layer][0][:, :S]).any(-1).sum())
                 + sum(int((dec[i * L + layer][0][:, 0] != want[layer][0][:, S + i])
                           .any(-1).sum()) for i in range(steps)) for layer in range(L)]
        drops = sum(d for _, d in routes)
        if any(other) or drops:
            raise AssertionError(f"lm M3 {cfg.name} fp32: tokens routed otherwise than the "
                                 f"teacher-forced forward by layer {other}, {drops} pairs dropped")
        routed = (f"; the {L} MoE layers route every token as the teacher-forced forward "
                  "does, no pair dropped (capacity n_experts / top_k)")
    rel = lm_rows(torch, torch.stack(got, dim=1), tf, f"lm M3 {cfg.name} fp32 against the "
                  "teacher-forced forward", LM_M3_ROW_REL)
    del p32, caches, tf
    return rel, routed


def run_lm(args, torch, dev) -> float:
    """The lm phase: M1 granite-3-2b whole through ``launch.serve``, M2 its
    int8 cache, M3 the other block patterns.  Like the layers it runs, it
    launches none of the port's kernels, and checks that it did not.
    Returns M1's median decode-step ms."""
    reset_counts()
    m1_ms = run_lm_granite(args, torch, dev)
    run_lm_others(args, torch, dev)
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"the lm phase launched the port's kernels {launched}")
    say("lm: M1-M3 launched none of the port's kernels (eager torch ops and torch.einsum)")
    return m1_ms


# the train phase: the training half of the LM stack (data, the train step,
# AdamW, checkpoints, the fault hooks) through launch.train.train, bf16,
# random weights from --seed.  Like the lm phase it runs eager torch ops and
# torch.einsum, and launches none of the port's kernels.
TRAIN_ARCH = "granite-3-2b"              # T1 and T3: the repo's config
TRAIN_BATCH, TRAIN_SEQ = 8, 512          # T1's global batch and sequence: 4096 tokens a step
TRAIN_MICRO = 2                          # T1's microbatches (and T3's)
TRAIN_STEPS = 6                          # T1's steps, the first one untimed
TRAIN_OPT = dict(lr=1e-3, warmup_steps=20)  # launch.train's schedule
TRAIN_BYTES_A_PARAM = 2 * 2 + 4 + 4 * 4  # AdamW: bf16 param read and written, the fp32
#                                          gradient sum read, m and v read and written
TRAIN_CKPT_LAYERS, TRAIN_CKPT_BATCH = 2, 4  # T3: granite-3-2b cut to 2 layers, B 4 x 512
TRAIN_T4_BATCH = 2                       # T4: B 2 x TRAIN_SEQ, two train steps each
# bounds of the bf16 step against its fp32 evaluation on the card (same
# weights upcast, same batch).  An H100 80GB HBM3 at 700 W read: the loss
# 1.4e-5 (granite) to 1.7e-3 (rwkv6-1.6b, 24 recurrent layers), the gradient
# norm 2.4e-6 to 6.1e-3, each granite gradient leaf's rows 5.2e-2 at most;
# labels shifted by one position read 1.75 there.  The bounds sit about
# twice above the honest readings and an order below the wrong one
TRAIN_LOSS_REL = 1e-2                    # T1 and T4: the loss
TRAIN_GNORM_REL = 5e-2                   # T1 and T4 (but zamba2, below): the gradient norm
TRAIN_GRAD_ROW_REL = 0.1                 # T1: each gradient leaf's rows (relative L2)
TRAIN_MICRO_REL = 5e-3                   # T1: the loss in two microbatches against one
TRAIN_ADAMW_REL = 1e-5                   # T2: the moments, card against CPU
# (arch, layers kept (0 for all), the gradient norm's bound) of T4:
# mixtral-8x7b is cut to 2 of its 32 layers (6.2 GB of bf16 weights and 25
# GB of moments at 2).  zamba2-2.7b's gradients explode backward through
# its 54 Mamba2 layers at init (fp32 norm 3364 against granite's 5.8),
# and bf16's roundings grow with them: the card read its bf16 norm 0.712x
# the fp32 one.  At 6 Mamba2 layers a group and width 128 the port's fp32
# gradients equal the reference's and its bf16 norm stays within 0.5 of
# fp32 (tests/test_torch_train_step_ssm_enc.py).  Its norm is held within 0.5
TRAIN_T4 = (("rwkv6-1.6b", 0, TRAIN_GNORM_REL), ("zamba2-2.7b", 0, 0.5),
            ("whisper-base", 0, TRAIN_GNORM_REL), ("mixtral-8x7b", 2, TRAIN_GNORM_REL))


def train_work(cfg, params, tokens: int, seq: int) -> tuple:
    """(the step's GEMM operations, the optimiser's bytes) for ``tokens``
    tokens in sequences of ``seq``.  Operations: 2 a weight a token
    multiplies (``token_weights``: every matrix but the embedding table,
    whose rows are gathered; the shared attention block once a turn;
    whisper's encoder, its frontend projection and the cross-attention's K
    and V over the frames instead), plus attention's 4·H·D a (query, key)
    pair (causal: seq(seq+1)/2 a sequence and head, within the window; the
    encoder's frames all pairs; the cross-attention's tokens by frames), all
    four times: the forward, its recompute under remat, and the backward's
    two products.  Bytes: ``TRAIN_BYTES_A_PARAM`` a parameter."""
    seqs = tokens // seq
    dec = token_weights(cfg, params["layers"]) + params["lm_head"].numel()
    groups = cfg.n_layers // cfg.hybrid_attn_every if cfg.block_pattern == "mamba_hybrid" else 0
    if groups:
        dec += groups * token_weights(cfg, params["shared_attn"])
    n_attn = {"attn": cfg.n_layers, "rwkv": 0, "mamba_hybrid": groups}[cfg.block_pattern]
    win = cfg.swa_window or 1 << 62
    pairs = seqs * sum(min(i + 1, win) for i in range(seq)) * n_attn
    frame_ops = 0.0
    if cfg.enc_layers:
        N = cfg.frontend_tokens
        cross = params["cross_layers"]["attn"]
        dec += cross["wq"].numel() + cross["wo"].numel()
        frames = (token_weights(cfg, params["enc_layers"]) + params["frontend_proj"].numel()
                  + cross["wk"].numel() + cross["wv"].numel())
        frame_ops = 2.0 * seqs * N * frames
        pairs += seqs * (N * N * cfg.enc_layers + seq * N * cfg.n_layers)
    attn = 4.0 * cfg.n_heads * cfg.resolved_head_dim * pairs
    n_params = sum(t.numel() for _, t in named_leaves(params))
    return 4 * (2.0 * tokens * dec + frame_ops + attn), TRAIN_BYTES_A_PARAM * n_params


def to_device(torch, batch: dict, dev) -> dict:
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def grad_norm(torch, grads) -> float:
    from repro_torch.tree import leaves

    return float(torch.sqrt(sum(g.float().square().sum() for g in leaves(grads))))


def worst_rows(torch, grads, want) -> tuple:
    """(the largest row relative L2 error of any leaf of ``grads`` against
    ``want``, its leaf's path)."""
    from repro_torch.kernels.flash_attention.ref import row_rel_err
    from repro_torch.tree import flatten_with_path, leaves, path_str

    return max((row_rel_err(g.reshape(-1, g.shape[-1]), w.reshape(-1, w.shape[-1])),
                path_str(p)) for (p, g), w in zip(flatten_with_path(grads), leaves(want),
                                                  strict=True))


def rel_close(got: float, want: float, bound: float, what: str) -> float:
    """|got - want| / |want|; raises when it exceeds ``bound`` or ``got`` is
    not finite."""
    rel = abs(got - want) / abs(want)
    if not (math.isfinite(got) and rel <= bound):
        raise AssertionError(f"{what}: {got!r} against {want!r}, relative error {rel!r} "
                             f"exceeds {bound}")
    return rel


def run_train_granite(args, torch, dev) -> tuple:
    """T1: granite-3-2b whole, bf16, through ``launch.train.train``: global
    batch ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in ``TRAIN_MICRO`` microbatches,
    remat on, ``TRAIN_STEPS`` steps, no checkpoint.  Before the optimiser
    state exists, the first batch's loss and gradients (two microbatches,
    as the step takes them) against an fp32 evaluation of the same weights
    on the card, labels shifted by one position rejected by the same
    gradient bound, and the loss in one microbatch against two.  Returns
    the trained parameters for T2 and the median step ms."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import train
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.step import loss_and_grads

    cfg = get_config(TRAIN_ARCH)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    n_params = sum(t.numel() for _, t in named_leaves(params))
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batch = to_device(torch, batch_for_step(dc, 0), dev)

    # the checks, before the optimiser state exists
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    loss, grads = loss_and_grads(cfg, params, batch, TRAIN_MICRO)
    torch.cuda.synchronize()
    grads_s = time.perf_counter() - t0
    loss, gnorm = float(loss), grad_norm(torch, grads)
    loss1 = float(loss_and_grads(cfg, params, batch, 1)[0])
    micro_rel = rel_close(loss, loss1, TRAIN_MICRO_REL, "train T1 the loss in "
                          f"{TRAIN_MICRO} microbatches against one")
    cfg32 = dataclasses.replace(cfg, param_dtype="float32")
    p32 = fp32(params)
    t0 = time.perf_counter()
    loss32, g32 = loss_and_grads(cfg32, p32, batch, TRAIN_MICRO)
    torch.cuda.synchronize()
    grads32_s = time.perf_counter() - t0
    del p32
    loss32, gnorm32 = float(loss32), grad_norm(torch, g32)
    loss_rel = rel_close(loss, loss32, TRAIN_LOSS_REL, "train T1 bf16 loss against fp32")
    gnorm_rel = rel_close(gnorm, gnorm32, TRAIN_GNORM_REL,
                          "train T1 bf16 gradient norm against fp32")
    rows, at = worst_rows(torch, grads, g32)
    if not rows <= TRAIN_GRAD_ROW_REL:
        raise AssertionError(f"train T1 bf16 gradients against fp32: {at}'s rows read "
                             f"{rows!r}, beyond {TRAIN_GRAD_ROW_REL}")
    del grads
    shifted = dict(batch, labels=torch.roll(batch["labels"], 1, dims=1))
    wrong, wrong_at = worst_rows(torch, loss_and_grads(cfg, params, shifted, TRAIN_MICRO)[1],
                                 g32)
    if not wrong > TRAIN_GRAD_ROW_REL:
        raise AssertionError(f"train T1: labels shifted by one position pass the gradient "
                             f"bound {TRAIN_GRAD_ROW_REL} ({wrong_at}'s rows read {wrong!r})")
    del g32, shifted
    checks_peak = torch.cuda.max_memory_allocated(dev)
    torch.cuda.empty_cache()

    # the run
    opt_cfg = OptConfig(total_steps=TRAIN_STEPS, **TRAIN_OPT)
    opt = init_opt_state(opt_cfg, params)
    torch.cuda.reset_peak_memory_stats(dev)
    lines = []
    res = train(cfg, params, opt, opt_cfg=opt_cfg, data=dc, steps=TRAIN_STEPS,
                microbatches=TRAIN_MICRO, log=lines.append)
    peak = torch.cuda.max_memory_allocated(dev)
    for line in lines:
        say(f"train T1 {line}")
    if len(res.losses) != TRAIN_STEPS or not all(map(math.isfinite, res.losses)):
        raise AssertionError(f"train T1: the losses of {TRAIN_STEPS} steps: {res.losses}")
    step_loss_rel = rel_close(res.losses[0], loss32, TRAIN_LOSS_REL,
                              "train T1 the first step's loss against fp32")
    step_gnorm_rel = rel_close(res.grad_norms[0], gnorm32, TRAIN_GNORM_REL,
                               "train T1 the first step's gradient norm against fp32")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    ops, opt_bytes = train_work(cfg, params, tokens, TRAIN_SEQ)
    ops_ms = ops / PEAK_BF16_FLOPS * 1e3
    opt_ms = opt_bytes / HBM_BYTES_PER_S * 1e3
    ms = [s * 1e3 for s in res.step_s[1:]]
    med = statistics.median(ms)
    moments = tensor_bytes(res.opt.m, res.opt.v)
    say(f"train T1 {TRAIN_ARCH} whole: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{n_params / 1e9:.4f} B parameters ({tensor_bytes(params) / 1e9:.3f} GB bf16, m and v "
        f"{moments / 1e9:.3f} GB fp32), remat {cfg.remat}; launch.train.train, global batch "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches, {TRAIN_STEPS} steps: step "
        f"median {med:.2f} ms over steps 1-{TRAIN_STEPS - 1} (min {min(ms):.2f}, max "
        f"{max(ms):.2f}; the first {res.step_s[0] * 1e3:.2f}), {tokens / med * 1e3:.0f} "
        f"tokens/s; bound {ops_ms + opt_ms:.2f} ms = {ops / 1e12:.2f} TFLOP at "
        f"{PEAK_BF16_FLOPS / 1e12:.0f} TFLOP/s ({ops_ms:.2f} ms) + the optimiser's "
        f"{opt_bytes / 1e9:.2f} GB at {HBM_BYTES_PER_S / 1e12:.2f} TB/s ({opt_ms:.2f} ms), "
        f"{(ops_ms + opt_ms) / med * 100:.1f} % of it; peak memory {peak / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated over the run; the checks before it "
        f"{checks_peak / 2**30:.3f} GiB); losses "
        + ", ".join(f"{x:.4f}" for x in res.losses))
    say(f"train T1 checks on batch 0: bf16 loss {loss!r} against fp32 {loss32!r}, relative "
        f"{loss_rel!r} (bound {TRAIN_LOSS_REL}); gradient norm {gnorm!r} against {gnorm32!r}, "
        f"{gnorm_rel!r} (bound {TRAIN_GNORM_REL}); the gradients' worst rows {rows!r} ({at}; "
        f"bound {TRAIN_GRAD_ROW_REL}); labels shifted by one position {wrong!r} ({wrong_at}): "
        f"rejected; one microbatch against {TRAIN_MICRO} {micro_rel!r} (bound "
        f"{TRAIN_MICRO_REL}); the first step's loss {step_loss_rel!r} and gradient norm "
        f"{step_gnorm_rel!r} from fp32; loss and gradients in {grads_s * 1e3:.1f} ms bf16, "
        f"{grads32_s * 1e3:.1f} ms fp32")
    del res, opt
    return params, med, peak


def run_train_adamw(args, torch, dev, params: dict) -> None:
    """T2: ``apply_updates`` on four of granite-3-2b's leaves at full width
    (the lm_head, one layer's ``w_up`` and ``wq``, the stacked ``ln1``
    scales) with random fp32 gradients and moments at step 5, once on the
    card and once on the CPU, with and without ``compress_grads``: the
    moments within ``TRAIN_ADAMW_REL`` of the largest value of their leaf,
    the error feedback within two ulps of g + e, the bf16 parameters
    within one bf16 step, the gradient norm within 1e-6."""
    from repro_torch.optim.adamw import OptConfig, OptState, apply_updates
    from repro_torch.tree import leaves

    picked = {"lm_head": params["lm_head"], "w_up": params["layers"]["mlp"]["w_up"][0],
              "wq": params["layers"]["attn"]["wq"][0],
              "ln1": params["layers"]["ln1"]["scale"]}
    gen = torch.Generator(device=dev).manual_seed(args.seed + 2)

    def draw(scale):
        return {k: torch.randn(v.shape, generator=gen, device=dev) * scale
                for k, v in picked.items()}

    n = sum(v.numel() for v in picked.values())
    for compress in (False, True):
        cfg = OptConfig(total_steps=20, compress_grads=compress, **TRAIN_OPT)
        grads = draw(1e-2)
        m = draw(1e-3)
        v = {k: (1e-3 + x.abs()).square() for k, x in draw(1e-3).items()}
        err = draw(1e-4) if compress else None

        def state(device):
            copy = lambda tree: None if tree is None else {  # noqa: E731
                k: x.to(device, copy=True) for k, x in tree.items()}
            return (copy(picked), OptState(torch.tensor(5, dtype=torch.int32, device=device),
                                           copy(m), copy(v), copy(err)), copy(grads))

        gp, gs, gg = state(dev)
        cp, cs, cg = state("cpu")
        gp, gs, ginfo = apply_updates(cfg, gs, gp, gg)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cp, cs, cinfo = apply_updates(cfg, cs, cp, cg)
        cpu_s = time.perf_counter() - t0
        gn_rel = rel_close(float(ginfo["grad_norm"]), float(cinfo["grad_norm"]), 1e-6,
                           "train T2 the gradient norm, card against CPU")
        flips = 0
        for (k, a), b in zip(gp.items(), cp.values()):
            a, b = a.float().cpu(), b.float()
            d = (a - b).abs()
            # one bf16 step of the larger result, plus 8 fp32 ulps of the old
            # value: where an update cancels most of a parameter, the two
            # sides' fp32 results part by ulps of the operands, not the result
            allowed = torch.maximum(a.abs(), b.abs()) * 2.0 ** -7 + (
                picked[k].float().cpu().abs() * 2.0 ** -20)
            if not bool((d <= allowed).all()):
                i = int((d - allowed).argmax())
                raise AssertionError(f"train T2 {k}: a bf16 parameter {float(a.flatten()[i])!r} "
                                     f"against {float(b.flatten()[i])!r} on the CPU, beyond one "
                                     "bf16 step")
            flips += int((d > 0).sum())
        worst = 0.0
        for tree_g, tree_c in ((gs.m, cs.m), (gs.v, cs.v)):
            for a, b in zip(leaves(tree_g), leaves(tree_c)):
                e = float((a.cpu() - b).abs().max()) / float(b.abs().max())
                worst = max(worst, e)
        if not worst <= TRAIN_ADAMW_REL:
            raise AssertionError(f"train T2: the moments part by {worst!r} of their leaves' "
                                 f"largest, beyond {TRAIN_ADAMW_REL}")
        err_ulps = 0.0
        if compress:
            for k in picked:
                top = float((grads[k] + err[k]).abs().max())
                ulp = top * 2.0 ** -23
                e = float((gs.error[k].cpu() - cs.error[k]).abs().max()) / ulp
                err_ulps = max(err_ulps, e)
            if not err_ulps <= 2.0:
                raise AssertionError(f"train T2: the error feedback parts by {err_ulps!r} ulps")

        def card():
            p, s, g = state(dev)
            return lambda: apply_updates(cfg, s, p, g)

        ms = cuda_ms(torch, card(), warmup=1, reps=5)
        moved = n * (2 * 2 + 4 + 4 * 4 + (8 if compress else 0))
        bound = moved / HBM_BYTES_PER_S * 1e3
        say(f"train T2 apply_updates on {len(picked)} of {TRAIN_ARCH}'s leaves "
            f"({n / 1e6:.1f} M parameters, bf16), compress_grads {compress}: card {ms:.3f} ms "
            f"(bound {bound:.4f} ms, bytes: {moved / 1e9:.3f} GB), CPU {cpu_s * 1e3:.1f} ms; "
            f"card against CPU: gradient norm {gn_rel!r}, moments {worst!r} of their leaves' "
            f"largest (bound {TRAIN_ADAMW_REL}), {flips} of {n} bf16 parameters one step apart"
            + (f", error feedback within {err_ulps:.2f} ulps of g + e" if compress else ""))
        del gp, gs, gg, cp, cs, cg


def run_train_resume(args, torch, dev) -> None:
    """T3: granite-3-2b cut to ``TRAIN_CKPT_LAYERS`` layers at full width, B
    ``TRAIN_CKPT_BATCH`` x ``TRAIN_SEQ`` in two microbatches, under
    ``torch.use_deterministic_algorithms(True)``: 4 steps straight against
    2 steps (their async save at step 2), a fresh ``train`` that restores
    it and takes 2 more; the parameters and the optimiser state equal bit
    for bit.  Then the final state saved blocking and async and restored,
    timed, in a temporary directory removed afterwards."""
    import dataclasses
    import os
    import shutil
    import tempfile

    from repro_torch.checkpoint.ckpt import restore, save
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.train import train
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.tree import leaves

    full = get_config(TRAIN_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_CKPT_LAYERS)
    opt_cfg = OptConfig(total_steps=4, **TRAIN_OPT)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_CKPT_BATCH)

    def fresh():
        p = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                        device=dev)
        return p, init_opt_state(opt_cfg, p)

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    was = torch.are_deterministic_algorithms_enabled()
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"  # deterministic cuBLAS needs a fixed one
    lines = []
    try:
        torch.use_deterministic_algorithms(True)
        kw = dict(opt_cfg=opt_cfg, data=dc, microbatches=TRAIN_MICRO, log=lines.append)
        straight = train(cfg, *fresh(), steps=4, **kw)
        first = train(cfg, *fresh(), steps=2, ckpt_dir=tmp, ckpt_every=2, **kw)
        del first
        resumed = train(cfg, *fresh(), steps=4, ckpt_dir=tmp, ckpt_every=2, **kw)
        if resumed.start != 2:
            raise AssertionError(f"train T3: resumed from step {resumed.start}, not 2")
        a = leaves({"params": straight.params, "opt": straight.opt})
        b = leaves({"params": resumed.params, "opt": resumed.opt})
        unequal = sum(not torch.equal(x, y) for x, y in zip(a, b, strict=True))
        if unequal:
            raise AssertionError(f"train T3: {unequal} of {len(a)} leaves differ between 4 steps "
                                 "straight and 2 + a resume of 2")
        losses = (straight.losses, resumed.losses)
        del straight, a, b
        state = {"params": resumed.params, "opt": resumed.opt}
        for name in os.listdir(tmp):
            shutil.rmtree(os.path.join(tmp, name))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save(tmp, 100, state)
        block_s = time.perf_counter() - t0
        d = os.path.join(tmp, "step_000100")
        on_disk = sum(os.path.getsize(os.path.join(d, f)) for f in os.listdir(d))
        shutil.rmtree(d)
        t0 = time.perf_counter()
        writer = save(tmp, 101, state, blocking=False)
        returned_s = time.perf_counter() - t0
        writer.join()
        async_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got, step = restore(tmp, state)
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != 101 or not all(torch.equal(x, y) for x, y in
                                  zip(leaves(got), leaves(state), strict=True)):
            raise AssertionError("train T3: the restored state is not the saved one")
        del got, state, resumed
    finally:
        torch.use_deterministic_algorithms(was)
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = env
        shutil.rmtree(tmp, ignore_errors=True)
    for line in lines:
        say(f"train T3 {line}")
    say(f"train T3 {TRAIN_ARCH} cut to {cfg.n_layers} of its {full.n_layers} layers at full "
        f"width, B {TRAIN_CKPT_BATCH} x {TRAIN_SEQ}, deterministic algorithms: 4 steps straight "
        f"and 2 + an async save + a resume of 2 equal bit for bit in every leaf of the "
        f"parameters and the optimiser state (losses {losses[0]} and the resumed "
        f"{losses[1]}); the final state {on_disk / 1e9:.3f} GB on disk: saved blocking in "
        f"{block_s:.2f} s, async {returned_s:.2f} s to return (the copy to the host) and "
        f"{async_s:.2f} s to its commit, restored in {restore_s:.2f} s")


def run_train_others(args, torch, dev) -> None:
    """T4: each other block pattern (``TRAIN_T4``), bf16, B ``TRAIN_T4_BATCH``
    x ``TRAIN_SEQ``, two train steps on one batch, each timed, and their
    peak memory; the first step's loss and gradient norm against an fp32
    evaluation of the same weights and batch, made first.  The MoE runs
    dropless on both sides (a capacity of every token of the call)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.step import loss_and_grads, make_train_step

    real_moe = lm.moe_apply

    def dropless(p, x, **kw):
        return real_moe(p, x, capacity_factor=cfg.n_experts / kw["top_k"], **kw)

    for arch, keep, gnorm_bound in TRAIN_T4:
        full = get_config(arch)
        cfg = dataclasses.replace(full, n_layers=keep) if keep else full
        params = lm.init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                                device=dev)
        dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_T4_BATCH,
                        frontend_tokens=cfg.frontend_tokens if cfg.frontend else 0,
                        frontend_dim=cfg.frontend_dim if cfg.frontend else 0)
        batch = to_device(torch, batch_for_step(dc, 0), dev)
        if cfg.n_experts:
            lm.moe_apply = dropless
        try:
            p32 = fp32(params)
            loss32, g32 = loss_and_grads(dataclasses.replace(cfg, param_dtype="float32"), p32,
                                         batch)
            loss32, gnorm32 = float(loss32), grad_norm(torch, g32)
            del p32, g32
            torch.cuda.empty_cache()
            opt_cfg = OptConfig(total_steps=2, **TRAIN_OPT)
            opt = init_opt_state(opt_cfg, params)
            step = make_train_step(cfg, opt_cfg)
            torch.cuda.reset_peak_memory_stats(dev)
            ms = []
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                params, opt, metrics = step(params, opt, batch)
                got = float(metrics["loss"]), float(metrics["grad_norm"])
                ms.append((time.perf_counter() - t0) * 1e3)
                if len(ms) == 1:
                    loss, gnorm = got
            peak = torch.cuda.max_memory_allocated(dev)
        finally:
            lm.moe_apply = real_moe
        loss_rel = rel_close(loss, loss32, TRAIN_LOSS_REL, f"train T4 {arch} loss against fp32")
        gnorm_rel = rel_close(gnorm, gnorm32, gnorm_bound,
                              f"train T4 {arch} gradient norm against fp32")
        tokens = TRAIN_T4_BATCH * TRAIN_SEQ
        ops, opt_bytes = train_work(cfg, params, tokens, TRAIN_SEQ)
        bound = ops / PEAK_BF16_FLOPS * 1e3 + opt_bytes / HBM_BYTES_PER_S * 1e3
        weights = tensor_bytes(params)
        cut = ""
        if keep:
            whole = weights + tensor_bytes(params["layers"]) / keep * (full.n_layers - keep)
            cut = f", cut to {keep} of its {full.n_layers} layers ({whole / 1e9:.1f} GB whole)"
        say(f"train T4 {arch}{cut}: {cfg.block_pattern}, {cfg.n_layers} layers, "
            f"{weights / 1e9:.3f} GB bf16"
            + (f", encoder {cfg.enc_layers} layers over {cfg.frontend_tokens} random frames"
               if cfg.enc_layers else "")
            + (", MoE dropless" if cfg.n_experts else "")
            + f"; B {TRAIN_T4_BATCH} x {TRAIN_SEQ}, a train step {ms[1]:.2f} ms (the first "
            f"{ms[0]:.2f}, cold; bound {bound:.3f} ms, {bound / ms[1] * 100:.1f} % of it), peak "
            f"memory {peak / 2**30:.3f} GiB; the first step's loss {loss!r} against fp32 "
            f"{loss32!r} ({loss_rel!r}, bound "
            f"{TRAIN_LOSS_REL}), gradient norm {gnorm!r} against {gnorm32!r} ({gnorm_rel!r}, "
            f"bound {gnorm_bound})")
        del params, opt, metrics, batch
        torch.cuda.empty_cache()


def run_train(args, torch, dev) -> tuple:
    """The train phase: T1 granite-3-2b whole through ``launch.train``, T2
    AdamW card against CPU, T3 checkpoint and resume bit for bit, T4 the
    other block patterns.  Like the lm phase, it launches none of the
    port's kernels, and checks that it did not.  Returns T1's median step
    ms and its run's peak bytes."""
    reset_counts()
    t0 = time.perf_counter()
    params, t1_ms, t1_peak = run_train_granite(args, torch, dev)
    run_train_adamw(args, torch, dev, params)
    del params
    torch.cuda.empty_cache()
    run_train_resume(args, torch, dev)
    torch.cuda.empty_cache()
    run_train_others(args, torch, dev)
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"the train phase launched the port's kernels {launched}")
    say(f"train: T1-T4 in {time.perf_counter() - t0:.1f} s, launching none of the port's "
        "kernels (eager torch ops and torch.einsum)")
    return t1_ms, t1_peak


# the shard phase: train.sharding's specs applied as DTensor placements on a
# DeviceMesh, on the one card there is: a one-rank group and a (1, 1) mesh.
# The placements shard nothing at one device, but every op of the step runs
# through DTensor's dispatch, every constrain through redistribute, and the
# optimiser through the placed path.  Bands:
# the placed step's loss, gradient norm and each gradient leaf's rows, and the
# first trained step's loss and gradient norm, against the plain step's on the
# same weights and batch: one card computes the same sums in the same order
# (the label logit's one-hot product has one nonzero term a row, so it is the
# gathered logit exactly); every reading so far was 0.0 (PERF.md, PR 36), and
# the bound leaves room for the last bit of an fp32 reduction alone
SHARD_REL = 1e-6
SHARD_GRAD_ROW_REL = 1e-6
# peak memory over T1's run: it read 40.404 GiB against T1's 40.404 twice
# and 40.407 once (PERF.md, PR 36); the margin allows the allocator's
# rounding of DTensor's extra views and copies, 80 times the largest excess
SHARD_PEAK_MARGIN = 2 ** 28
SHARD_STEPS = 2


def run_shard(args, torch, dev, t1_ms: float, t1_peak: int) -> None:
    """S1: a one-rank process group (``nccl`` on the card, ``gloo`` on the
    CPU; a ``FileStore`` in a temporary directory) and a (1, 1)
    ``DeviceMesh`` ('data', 'model'); granite-3-2b whole, bf16, from
    ``--seed``; the plain ``loss_and_grads`` on T1's first batch, then the
    weights and the batch placed by ``make_param_shardings`` and
    ``make_batch_shardings`` and the same ``loss_and_grads`` through
    DTensor: its loss and gradient norm (``SHARD_REL``) and each gradient
    leaf's rows (``SHARD_GRAD_ROW_REL``) against the plain ones.  Then
    ``SHARD_STEPS`` train steps through ``launch.train.train`` at
    ``TRAIN_BATCH`` x ``TRAIN_SEQ`` in ``TRAIN_MICRO`` microbatches, each
    batch placed on the mesh (the first no longer cold: the placed
    gradients filled DTensor's caches).  The steps' ms beside T1's median,
    the first step's loss and gradient norm against the plain step's
    (``SHARD_REL``), the peak memory of the steps against T1's plus
    ``SHARD_PEAK_MARGIN``, the phase's seconds.  The group is destroyed and
    the activation axes unset; nothing is caught."""
    import tempfile

    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.launch.train import train
    from repro_torch.models.lm import init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train import sharding
    from repro_torch.train.step import loss_and_grads
    from repro_torch.tree import leaves

    reset_counts()
    t0 = time.perf_counter()
    cfg = get_config(TRAIN_ARCH)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    params = init_params(cfg, generator=torch.Generator(device=dev).manual_seed(args.seed),
                         device=dev)
    batch = to_device(torch, batch_for_step(dc, 0), dev)
    loss, grads = loss_and_grads(cfg, params, batch, TRAIN_MICRO)
    loss, gnorm = float(loss), grad_norm(torch, grads)

    backend = "nccl" if dev.type == "cuda" else "gloo"
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(str(Path(tmp) / "store"), 1)
        dist.init_process_group(backend, store=store, rank=0, world_size=1,
                                device_id=dev if dev.type == "cuda" else None)
        try:
            mesh = init_device_mesh(dev.type, (1, 1), mesh_dim_names=("data", "model"))
            sharding.set_activation_axes(mesh)
            params = sharding.place(params, sharding.make_param_shardings(params, mesh), mesh)
            batch = sharding.place(batch, sharding.make_batch_shardings(batch, mesh), mesh)
            p_loss, p_grads = loss_and_grads(cfg, params, batch, TRAIN_MICRO)
            p_grads = sharding.gather(p_grads)
            p_loss, p_gnorm = float(p_loss), grad_norm(torch, p_grads)
            rows, at = worst_rows(torch, p_grads, grads)
            del p_grads, grads, batch
            torch.cuda.empty_cache()
            opt_cfg = OptConfig(total_steps=TRAIN_STEPS, **TRAIN_OPT)
            opt = init_opt_state(opt_cfg, params)
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            lines = []
            res = train(cfg, params, opt, opt_cfg=opt_cfg, data=dc, steps=SHARD_STEPS,
                        microbatches=TRAIN_MICRO, log=lines.append)
            torch.cuda.synchronize(dev)
            peak = torch.cuda.max_memory_allocated(dev)
            placed = all(sharding.is_dtensor(x) for x in leaves(res.params) + leaves(res.opt.m))
        finally:
            sharding.set_activation_axes(None)
            dist.destroy_process_group()
    for line in lines:
        say(f"shard S1 {line}")
    if not placed:
        raise AssertionError("shard S1: the trained parameters or moments are not DTensors")
    p_loss_rel = rel_close(p_loss, loss, SHARD_REL,
                           "shard S1 the placed loss_and_grads' loss against the plain one's")
    p_gnorm_rel = rel_close(p_gnorm, gnorm, SHARD_REL, "shard S1 the placed loss_and_grads' "
                            "gradient norm against the plain one's")
    if not rows <= SHARD_GRAD_ROW_REL:
        raise AssertionError(f"shard S1 the placed gradients against the plain ones: {at}'s "
                             f"rows read {rows!r}, beyond {SHARD_GRAD_ROW_REL}")
    loss_rel = rel_close(res.losses[0], loss, SHARD_REL,
                         "shard S1 the first step's loss against the plain step's")
    gnorm_rel = rel_close(res.grad_norms[0], gnorm, SHARD_REL,
                          "shard S1 the first step's gradient norm against the plain step's")
    if peak > t1_peak + SHARD_PEAK_MARGIN:
        raise AssertionError(f"shard S1: peak memory {peak / 2**30:.3f} GiB exceeds T1's "
                             f"{t1_peak / 2**30:.3f} GiB plus {SHARD_PEAK_MARGIN / 2**30:.1f}")
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"the shard phase launched the port's kernels {launched}")
    ms = [x * 1e3 for x in res.step_s]
    first = res.losses[0]
    del res, opt, params
    torch.cuda.empty_cache()
    say(f"shard S1 {TRAIN_ARCH} whole, bf16, on a (1, 1) DeviceMesh ('data', 'model') of a "
        f"one-rank {backend} group, {SHARD_STEPS} train steps through launch.train.train at "
        f"{TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} microbatches through DTensor: steps "
        + ", ".join(f"{x:.2f}" for x in ms) + f" ms (T1's plain median {t1_ms:.2f} ms); "
        f"the placed loss_and_grads' loss relative {p_loss_rel!r}, gradient norm "
        f"{p_gnorm_rel!r} (bound {SHARD_REL}), the gradients' worst rows {rows!r} ({at}; "
        f"bound {SHARD_GRAD_ROW_REL}); the first step's loss {first!r} against the plain "
        f"step's {loss!r}, relative {loss_rel!r}, gradient norm relative {gnorm_rel!r} (bound "
        f"{SHARD_REL}); peak memory {peak / 2**30:.3f} GiB (T1's {t1_peak / 2**30:.3f} GiB, "
        f"margin {SHARD_PEAK_MARGIN / 2**30:.2f}); phase {time.perf_counter() - t0:.1f} s, "
        "launching none of the port's kernels")


# the dryrun phase: the model-level dry run (core.cost.count_cost,
# launch.calibrate, launch.dryrun) at granite-3-2b's full width, bf16, held
# against the card.  Its counts run on meta stand-ins (nothing allocated), and
# the same counter runs one real step on the card.  Bands, from the CPU tests
# (tests/test_torch_dryrun.py) and a meta count of T1's step here:
DRY_ARCH = "granite-3-2b"
# the train step's raw product FLOPs over the calibrated ones: the raw step
# runs the head's forward once and torch's non-reentrant checkpoint stops a
# block's recompute after its last saved tensor (the SwiGLU's down product is
# not recomputed), where calibrate counts 4 passes of everything; the reduced
# attention archs with remat read 0.933-0.979, T1's step on meta 0.926
DRY_TRAIN_RAW_BAND = (0.90, 1.00)
# the prefill and decode steps' raw FLOPs against the calibrated ones: the
# reduced attention archs read equal (1.0000), granite's decode on meta too
DRY_STEP_REL = 1e-2
# calibrate's product FLOPs against train_work's, once the half of each
# attention square that the causal mask discards (chunked_attention computes
# it) is added to train_work's: equal but for the order of the sums
DRY_WORK_REL = 1e-9
# the predicted peak (the meta count's argument + temp bytes) over the card's
# torch.cuda.max_memory_allocated over one uncounted step: the caching
# allocator rounds each block up to 512 bytes, and an op's internal scratch
# (cuBLAS workspaces, a reduction's temporaries) is allocated where the
# counter sees no storage, so the card reads above the count
DRY_PEAK_BAND = (0.85, 1.05)


# D4: the dry run on the reference's production meshes (DeviceMeshes over a
# fake group, rank 0's program counted on meta shards).  The train cell is
# T1's sequence at a batch the (2, 16, 16) mesh's 32 data ranks divide (one
# row a rank, one microbatch): T1's own batch of 8 leaves DTensor planning
# strided redistributions for minutes (torch 2.13 on a CPU), train_4k's 8
# microbatches take 150 s.
DRY_MESH_DECODE = "decode_32k"
DRY_MESH_TRAIN_BATCH = 32
# the train cell's raw product FLOPs over the calibrated ones on the mesh:
# beside the one-device causes (DRY_TRAIN_RAW_BAND), DTensor picks the
# backward's products' strategies apart from the forward's that calibrate's
# 4 x forward counts; read 1.1666 on torch 2.13 (a CPU)
DRY_MESH_TRAIN_RAW_BAND = (0.90, 1.25)


def dry_machine(torch):
    """The card's data-sheet peaks as a ``core.machines.TPUMachine``
    record for ``report_from_values``: bf16 at ``PEAK_BF16_FLOPS``, fp32
    at the CUDA cores' ``PEAK_FLOPS[4]``, HBM at ``HBM_BYTES_PER_S``, and
    no NVLink term on one card (an infinite link rate: collectives cost
    nothing)."""
    from repro_torch.core.machines import TPUMachine

    return TPUMachine(name="H100 SXM data sheet", peak_flops_bf16=PEAK_BF16_FLOPS,
                      peak_flops_f32=PEAK_FLOPS[4], hbm_bw=HBM_BYTES_PER_S,
                      ici_bw_per_link=math.inf)


def card_bytes(torch, dev) -> int:
    return (torch.cuda.get_device_properties(dev).total_memory if dev.type == "cuda"
            else 80 * 10**9)


def dry_cells(torch, dev, arch: str) -> list:
    """D1: ``launch.dryrun.lower_cell`` with ``--local`` semantics for each
    valid cell of ``arch``, on meta; each timed and printed with its
    dominant term, bound and predicted peak against the card's memory.
    Returns the rows."""
    from repro_torch.configs import valid_cells
    from repro_torch.launch import dryrun

    rows = []
    for shape in valid_cells(dryrun.get_config(arch)):
        t0 = time.perf_counter()
        row = dryrun.lower_cell(arch, shape.name, False, local=True)
        secs = time.perf_counter() - t0
        if not (row["mesh"] == "1x1" and row["hlo_gflops"] > 0 and row["memory"]["peak_bytes"] > 0
                and all(math.isfinite(row[k]) for k in ("t_compute_s", "t_memory_s"))):
            raise AssertionError(f"dryrun D1 {arch}/{shape.name}: a row without counts: {row}")
        peak = row["memory"]["peak_bytes"]
        bound = max(row["t_compute_s"], row["t_memory_s"], row["t_collective_s"])
        say(f"dryrun D1 {arch}/{shape.name} (B {shape.global_batch} x {shape.seq_len}, "
            f"{row['mesh']}, kv_int8 {row['kv_int8']}): lower_cell on meta in {secs:.2f} s "
            f"({row['compile_s']:.2f} s the step's count); dominant {row['dominant']}, bound "
            f"{bound * 1e3:.3f} ms on TPU_V5E (compute {row['t_compute_s'] * 1e3:.3f}, memory "
            f"{row['t_memory_s'] * 1e3:.3f}); calibrated {row['hlo_gflops'] / 1e3:.3f} TFLOP, "
            f"raw {row['raw_cost_analysis']['flops'] / 1e12:.3f} TFLOP (products "
            f"{row['raw_cost_analysis']['dot_flops'] / 1e12:.3f}), model "
            f"{row['model_flops'] / 1e12:.3f}; analytic bytes "
            f"{row['analytic_bytes']['total'] / 1e9:.3f} GB, unfused "
            f"{row['raw_cost_analysis']['hbm_bytes'] / 1e9:.3f} GB; peak {peak / 1e9:.3f} GB "
            f"against the card's {card_bytes(torch, dev) / 1e9:.3f} GB "
            f"({'fits' if peak <= card_bytes(torch, dev) else 'does not fit'})")
        rows.append(row)
    return rows


def measured_peak(torch, dev, fn) -> tuple:
    """(``fn()``, the bytes allocated at its peak, what measured them): on
    the card ``torch.cuda.max_memory_allocated`` after a reset, uncounted;
    on the CPU the counter's own peak of the real run, less the arguments
    (``fn`` takes none: its caller adds them)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        out = fn()
        torch.cuda.synchronize(dev)
        return out, torch.cuda.max_memory_allocated(dev), "torch.cuda.max_memory_allocated"
    from repro_torch.core.cost import count_cost

    out, cost = count_cost(fn)
    return out, cost.peak_bytes, "count_cost of the run on the CPU"


def masked_ops(cfg, tokens: int, seq: int) -> float:
    """The operations of the (query, key) pairs a causal, windowed mask
    discards, over every attention layer of a train step (four passes):
    ``chunked_attention`` computes each whole square, ``train_work`` counts
    the pairs it keeps."""
    n_attn = {"attn": cfg.n_layers, "rwkv": 0,
              "mamba_hybrid": cfg.n_layers // cfg.hybrid_attn_every}[cfg.block_pattern]
    win = cfg.swa_window or 1 << 62
    kept = sum(min(i + 1, win) for i in range(seq))
    return 4 * 4.0 * cfg.n_heads * cfg.resolved_head_dim * n_attn * (tokens // seq) * (
        seq * seq - kept)


def dry_step(torch, dev, cfg, params, shape, step, args, microbatches: int = 1) -> dict:
    """D2 / D3 for one step: ``calibrated_cost`` and the raw count on meta
    (``launch.dryrun.step_cost``), ``model_flops``, the same counter over
    ``step(*args)`` on ``dev`` (the card), and one uncounted run for the
    peak.  Holds the meta and card products equal and the predicted peak
    within ``DRY_PEAK_BAND`` of the measured one; returns the numbers."""
    from repro_torch.core.cost import count_cost
    from repro_torch.launch import dryrun
    from repro_torch.launch.calibrate import analytic_bytes, calibrated_cost
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.tree import leaves

    mesh = make_local_mesh("meta")
    p_meta = dryrun.params_struct(cfg)
    n_params = sum(t.numel() for t in leaves(p_meta))
    t0 = time.perf_counter()
    cal = calibrated_cost(cfg, shape, mesh, microbatches=microbatches, n_params=n_params)
    cal_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meta = dryrun.step_cost(cfg, shape, p_meta, microbatches)
    meta_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, card = count_cost(step, *args)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    card_s = time.perf_counter() - t0
    if card.dot_flops != meta.dot_flops:
        raise AssertionError(f"dryrun {shape.name}: the card's step counts {card.dot_flops!r} "
                             f"product FLOPs, meta {meta.dot_flops!r}")
    _, peak, peak_by = measured_peak(torch, dev, lambda: step(*args))
    if dev.type != "cuda":
        peak += card.argument_bytes
    ratio = meta.peak_bytes / peak
    if not DRY_PEAK_BAND[0] <= ratio <= DRY_PEAK_BAND[1]:
        raise AssertionError(f"dryrun {shape.name}: predicted peak {meta.peak_bytes} bytes, "
                             f"{peak_by} {peak}: {ratio!r} outside {DRY_PEAK_BAND}")
    return {"cal": cal, "meta": meta, "card": card, "peak": peak, "peak_by": peak_by,
            "ratio": ratio, "n_params": n_params, "secs": (cal_s, meta_s, card_s),
            "model_flops": dryrun.model_flops(cfg, shape, p_meta),
            "analytic": analytic_bytes(cfg, shape, mesh, microbatches, n_params)}


def dry_place(torch, name: str, d: dict, measured_ms: float, what: str) -> str:
    """The step placed with ``report_from_values`` on the card's data-sheet
    peaks (``dry_machine``): the calibrated FLOPs and the analytic bytes;
    the line printed beside the measured median."""
    from repro_torch.core.roofline import report_from_values

    rep = report_from_values(name, flops=d["cal"].flops, hbm_bytes=d["analytic"]["total"],
                             coll_wire_bytes=0.0, n_chips=1, machine=dry_machine(torch),
                             model_flops_total=d["model_flops"],
                             peak_bytes_per_device=d["meta"].peak_bytes)
    unfused = d["meta"].bytes / HBM_BYTES_PER_S * 1e3
    return (f"bound {rep.t_bound * 1e3:.3f} ms ({rep.dominant}: compute "
            f"{rep.t_compute * 1e3:.3f}, memory {rep.t_memory * 1e3:.3f} for "
            f"{d['analytic']['total'] / 1e9:.3f} GB analytic; the unfused raw bytes "
            f"{d['meta'].bytes / 1e9:.3f} GB would take {unfused:.3f}) on the H100's "
            f"data-sheet peaks, beside the {what} median {measured_ms:.3f} ms measured in this "
            f"run ({rep.t_bound * 1e3 / measured_ms * 100:.1f} % of it); useful FLOPs "
            f"{rep.useful_flops_ratio:.3f} of the calibrated")


def run_dryrun(args, torch, dev, t1_ms: float, m1_ms: float) -> None:
    """The dryrun phase: D1 every valid cell of granite-3-2b through
    ``launch.dryrun.lower_cell`` on meta; D2 T1's train step (``TRAIN_BATCH``
    x ``TRAIN_SEQ``, ``TRAIN_MICRO`` microbatches, remat), counted on meta
    and on the card, its calibrated products held to ``train_work``'s; D3
    M1's decode step (B ``LM_BATCH``, the lm phase's cache length) the same
    way; each placed on the card's data-sheet peaks beside the step's
    median from the train and lm phases.  It launches none of the port's
    kernels, and checks that it did not."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.data.pipeline import DataConfig, batch_for_step
    from repro_torch.models.lm import init_caches, init_params
    from repro_torch.optim.adamw import OptConfig, init_opt_state
    from repro_torch.train.step import make_decode_step, make_train_step

    reset_counts()
    t0 = time.perf_counter()
    dry_cells(torch, dev, DRY_ARCH)

    # D2: T1's step
    cfg = get_config(DRY_ARCH)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(cfg, generator=gen, device=dev)
    dc = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ, global_batch=TRAIN_BATCH)
    batch = to_device(torch, batch_for_step(dc, 0), dev)
    opt = init_opt_state(OptConfig(), params)
    shape = ShapeSpec("T1", TRAIN_SEQ, TRAIN_BATCH, "train")
    step = make_train_step(cfg, OptConfig(), microbatches=TRAIN_MICRO)
    d = dry_step(torch, dev, cfg, params, shape, step, (params, opt, batch), TRAIN_MICRO)
    del opt, batch
    cal_dot = d["cal"].detail["dot_flops"]
    raw_ratio = d["meta"].dot_flops / cal_dot
    if not DRY_TRAIN_RAW_BAND[0] <= raw_ratio <= DRY_TRAIN_RAW_BAND[1]:
        raise AssertionError(f"dryrun D2: raw over calibrated product FLOPs {raw_ratio!r} "
                             f"outside {DRY_TRAIN_RAW_BAND}")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    work, _ = train_work(cfg, params, tokens, TRAIN_SEQ)
    masked = masked_ops(cfg, tokens, TRAIN_SEQ)
    work_rel = rel_close(cal_dot, work + masked, DRY_WORK_REL,
                         "dryrun D2 calibrated product FLOPs against train_work's + the masked "
                         "halves")
    meta, card = d["meta"], d["card"]
    say(f"dryrun D2 {DRY_ARCH} T1's step ({TRAIN_BATCH} x {TRAIN_SEQ} in {TRAIN_MICRO} "
        f"microbatches, remat {cfg.remat}): calibrated {d['cal'].flops / 1e12:.4f} TFLOP "
        f"(products {cal_dot / 1e12:.4f}; train_work's {work / 1e12:.4f} + the causal masks' "
        f"discarded halves {masked / 1e12:.4f}: {work_rel!r} apart, bound {DRY_WORK_REL}; "
        f"{cal_dot / work:.4f}x train_work) in {d['secs'][0]:.2f} s; raw on meta "
        f"{meta.flops / 1e12:.4f} TFLOP (products {meta.dot_flops / 1e12:.4f}, "
        f"{raw_ratio:.4f}x the calibrated, band {DRY_TRAIN_RAW_BAND}; {meta.ops} ops) in "
        f"{d['secs'][1]:.2f} s; on the card {card.dot_flops / 1e12:.4f} TFLOP of products, "
        f"equal, {card.ops} ops counted in {d['secs'][2]:.2f} s; model_flops "
        f"{d['model_flops'] / 1e12:.4f} TFLOP")
    say(f"dryrun D2 memory: predicted peak {meta.peak_bytes / 2**30:.3f} GiB (arguments "
        f"{meta.argument_bytes / 2**30:.3f}, temp {meta.temp_bytes / 2**30:.3f}); "
        f"{d['peak_by']} over one uncounted step {d['peak'] / 2**30:.3f} GiB: predicted/"
        f"measured {d['ratio']:.4f} (band {DRY_PEAK_BAND}); the counter on the card "
        f"{card.peak_bytes / 2**30:.3f} GiB")
    say(f"dryrun D2 placed: {dry_place(torch, 'T1', d, t1_ms, 'train phase T1 step')}")
    del d, step

    # D3: M1's decode step
    B, cap = LM_BATCH, LM_PROMPT + LM_GEN + 8
    shape = ShapeSpec("M1", cap, B, "decode")
    caches = init_caches(cfg, B, cap, device=dev)
    token = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=dev, dtype=torch.int32)
    at = torch.full((B, 1), LM_PROMPT, dtype=torch.int32, device=dev)
    decode = make_decode_step(cfg)

    def step(*a):
        with torch.no_grad():
            return decode(*a)

    d = dry_step(torch, dev, cfg, params, shape, step, (params, token, caches, at))
    meta = d["meta"]
    step_rel = rel_close(meta.flops, d["cal"].flops, DRY_STEP_REL,
                         "dryrun D3 raw FLOPs against the calibrated")
    say(f"dryrun D3 {DRY_ARCH} M1's decode step (B {B}, a cache of {cap}): calibrated "
        f"{d['cal'].flops / 1e9:.4f} GFLOP in {d['secs'][0]:.2f} s; raw on meta "
        f"{meta.flops / 1e9:.4f} GFLOP ({step_rel!r} apart, bound {DRY_STEP_REL}; products "
        f"{meta.dot_flops / 1e9:.4f}, {meta.ops} ops) in {d['secs'][1]:.2f} s; on the card "
        f"{d['card'].dot_flops / 1e9:.4f} GFLOP of products, equal, in {d['secs'][2]:.2f} s; "
        f"model_flops {d['model_flops'] / 1e9:.4f} GFLOP; bytes unfused "
        f"{meta.bytes / 1e9:.3f} GB, analytic {d['analytic']['total'] / 1e9:.3f} GB")
    say(f"dryrun D3 memory: predicted peak {meta.peak_bytes / 2**30:.3f} GiB (arguments "
        f"{meta.argument_bytes / 2**30:.3f}, temp {meta.temp_bytes / 2**30:.3f}); "
        f"{d['peak_by']} {d['peak'] / 2**30:.3f} GiB: {d['ratio']:.4f} (band {DRY_PEAK_BAND})")
    say(f"dryrun D3 placed: {dry_place(torch, 'M1', d, m1_ms, 'lm phase M1 decode-step')}")
    del d, params, caches
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"the dryrun phase launched the port's kernels {launched}")
    say(f"dryrun: D1-D3 in {time.perf_counter() - t0:.1f} s, launching none of the port's "
        "kernels")


def run_dryrun_meshes(args, torch, dev) -> None:
    """The dryrun phase's D4: ``launch.dryrun.lower_cell`` of granite-3-2b's
    ``DRY_MESH_DECODE`` on (16, 16), its products times 256 held equal to
    one device's count (every product divides) and its raw FLOPs to the
    calibrated ones; then a train cell (``DRY_MESH_TRAIN_BATCH`` x
    ``TRAIN_SEQ``) on (2, 16, 16), its raw products held to the calibrated
    ones (``DRY_MESH_TRAIN_RAW_BAND``).  Each mesh is a ``DeviceMesh`` on
    the CPU over a ``fake`` group that ``launch.dryrun.counting_mesh``
    opens and closes, so none may be open before or after; counted on meta
    shards, nothing is allocated.  It launches none of the port's kernels,
    and checks that it did not."""
    import torch.distributed as dist

    from repro_torch.configs import SHAPES
    from repro_torch.configs.base import ShapeSpec
    from repro_torch.launch import calibrate, dryrun
    from repro_torch.tree import leaves

    if dist.is_initialized():
        raise AssertionError("dryrun D4: a process group is open before the phase")
    reset_counts()
    t0 = time.perf_counter()
    cfg = dryrun.get_config(DRY_ARCH)
    p = dryrun.params_struct(cfg)
    n_params = sum(t.numel() for t in leaves(p))

    shape = SHAPES[DRY_MESH_DECODE]
    one = dryrun.step_cost(cfg, shape, p)
    t = time.perf_counter()
    row = dryrun.lower_cell(DRY_ARCH, DRY_MESH_DECODE, multi_pod=False)
    secs = time.perf_counter() - t
    raw = row["raw_cost_analysis"]
    n_chips = 256
    if raw["dot_flops"] * n_chips != one.dot_flops:
        raise AssertionError(f"dryrun D4 {DRY_MESH_DECODE}: products {raw['dot_flops']!r} a "
                             f"device x {n_chips} are not one device's {one.dot_flops!r}")
    step_rel = rel_close(raw["flops"], row["hlo_gflops"] * 1e9, DRY_STEP_REL,
                         f"dryrun D4 {DRY_MESH_DECODE} raw FLOPs against the calibrated")
    coll = row["collectives"]
    if not coll or raw["coll_wire_bytes"] <= 0:
        raise AssertionError(f"dryrun D4 {DRY_MESH_DECODE}: no collective counted on the mesh")
    say(f"dryrun D4 {DRY_ARCH}/{DRY_MESH_DECODE} on {row['mesh']} ({n_chips} ranks, "
        f"a fake group): lower_cell in {secs:.2f} s ({row['compile_s']:.2f} s the step's "
        f"count); a device {row['hlo_gflops'] / 1e3:.6f} TFLOP calibrated, raw "
        f"{raw['flops'] / 1e12:.6f} ({step_rel!r} apart, bound {DRY_STEP_REL}); products "
        f"x {n_chips} = one device's {one.dot_flops / 1e12:.4f} TFLOP exactly; "
        f"collectives {sum(v['count'] for v in coll.values()):.0f}, wire "
        f"{row['coll_wire_GB']:.4f} GB (raw {raw['coll_wire_bytes'] / 1e9:.4f}: " + ", ".join(
            f"{k} {v['count']:.0f} for {v['wire_bytes'] / 1e9:.4f} GB"
            for k, v in sorted(coll.items()))
        + f"); predicted peak {row['memory']['peak_bytes'] / 2**30:.3f} GiB; dominant "
        f"{row['dominant']}")

    shape = ShapeSpec("D4", TRAIN_SEQ, DRY_MESH_TRAIN_BATCH, "train")
    t = time.perf_counter()
    with dryrun.counting_mesh(True) as mesh:
        mb = dryrun.train_microbatches(cfg, shape, mesh)
        cost = dryrun.step_cost(cfg, shape, p, mb, mesh)
        count_s = time.perf_counter() - t
        cal = calibrate.calibrated_cost(cfg, shape, mesh, microbatches=mb, n_params=n_params)
        name = dryrun.mesh_name(mesh)
    secs = time.perf_counter() - t
    if dist.is_initialized():
        raise AssertionError("dryrun D4: the fake group outlived counting_mesh")
    ratio = cost.dot_flops / cal.detail["dot_flops"]
    if not DRY_MESH_TRAIN_RAW_BAND[0] <= ratio <= DRY_MESH_TRAIN_RAW_BAND[1]:
        raise AssertionError(f"dryrun D4 train: raw over calibrated product FLOPs {ratio!r} "
                             f"outside {DRY_MESH_TRAIN_RAW_BAND}")
    wire = cost.collectives["total"]["wire_bytes"]
    if wire <= 0:
        raise AssertionError("dryrun D4 train: no collective counted on the mesh")
    say(f"dryrun D4 {DRY_ARCH} train {DRY_MESH_TRAIN_BATCH} x {TRAIN_SEQ} on {name} (512 "
        f"ranks, {mb} microbatch(es), remat {cfg.remat}): counted in {count_s:.2f} s, "
        f"calibrated after, {secs:.2f} s in all; a device {cal.flops / 1e12:.4f} TFLOP "
        f"calibrated, raw {cost.flops / 1e12:.4f} (products {ratio:.4f}x the calibrated, band "
        f"{DRY_MESH_TRAIN_RAW_BAND}; {cost.ops} ops); collectives "
        f"{cost.collectives['total']['count']:.0f}, wire {wire / 1e9:.4f} GB raw, "
        f"{cal.coll_wire / 1e9:.4f} GB calibrated; predicted peak "
        f"{cost.peak_bytes / 2**30:.3f} GiB (arguments {cost.argument_bytes / 2**30:.3f})")
    launched = {k: n for module in kernel_modules() for k, n in module.LAUNCHES.items() if n}
    if launched:
        raise AssertionError(f"dryrun D4 launched the port's kernels {launched}")
    say(f"dryrun: D4 in {time.perf_counter() - t0:.1f} s, launching none of the port's kernels")


STREAM_L2_BYTES = 8 * 2**20             # a read footprint the 50 MB L2 holds
STREAM_L2_PASSES = 64                    # passes over it in one reduction
RANK_TOP_K = 10                          # the pruned ranking's k


def stream_read(torch, dev, n_bytes: int, passes: int = 1) -> tuple:
    """A streaming read of ``n_bytes`` (fp64) on the card: ``torch.sum``
    over a stride-0 view that reads the footprint ``passes`` times in one
    kernel (the L2-resident case), queued 10 calls back to back in turns.
    Returns (bytes read a call, ms a call, GB/s)."""
    x = torch.rand(n_bytes // 8, dtype=torch.float64, device=dev)
    view = x.expand(passes, x.numel()) if passes > 1 else x
    ms = interleaved_ms(torch, {"read": lambda: view.sum()}, rounds=5,
                        calls=QUEUED_CALLS)["read"]
    read = n_bytes * passes
    return read, ms, read / (ms * 1e-3) / 1e9


def run_api(args, torch, dev) -> tuple:
    """The estimator's front door on the card: the paper-loop example
    (``examples/torch_stencil_codegen.main``) at the paper's domains, its
    rankings against the generators', one ranking of each path's 168
    launches four ways (serial; the pooled engine, started after CUDA;
    pooled with a top-k; the same engine warm), and streaming reads at an
    L2-resident footprint and at the two paths' DRAM footprints beside the
    H100 model's rates.  Returns the main path's launch counts, the
    streaming reads (label -> footprint, ms, GB/s) and, for the serve phase,
    the example's in-process ``PriceResult`` and the rankings' host times."""
    import os

    from repro_torch import obs
    from repro_torch.api import gpu_request, price
    from repro_torch.core import gridwalk, perfmodel
    from repro_torch.core.engine import Explorer, pool
    from repro_torch.core.machines import H100
    from repro_torch.core.specs import lbm_d3q15, star_stencil_3d
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.lbm_d3q15.generator import rank_configs as lbm_rank
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import rank_configs as star_rank

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_stencil_codegen as example

    card = card_line()
    cores = len(os.sched_getaffinity(0))
    say(f"api: card {card}; host {cores} cores available ({os.cpu_count()} on the host); "
        f"torch.cuda.is_initialized() {torch.cuda.is_initialized()}")
    if (example.R, example.STENCIL_DOMAIN, example.LBM_DOMAIN) != (R, DOMAIN, LBM_DOMAIN) \
            or example.TOL != TOL[8]:
        raise AssertionError("the example's domains or tolerance are not the smoke's")

    # A1. the example: one price() sweep of both launch spaces, then the winners
    reset_counts()
    t0 = time.perf_counter()
    out = example.main(device=dev, stencil_domain=DOMAIN, lbm_domain=LBM_DOMAIN)
    torch.cuda.synchronize()
    t_example = time.perf_counter() - t0
    launches = {"star_pointwise": K.LAUNCHES["star_pointwise"],
                "lbm_pointwise": LK.LAUNCHES["lbm_pointwise"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"the example launched {launches}")
    result = out["result"]
    for name, ranked in (("stencil3d25", star_rank(R, DOMAIN, 8, H100)),
                         ("lbm_d3q15", lbm_rank(LBM_DOMAIN, 8, H100))):
        mine = result.ranking(name)
        if len(mine) != 168 or [(e.config, e.perf, e.limiter, e.estimate.limiter_rates)
                                for e in mine] != [
                (rc.launch, rc.perf, rc.estimate.limiter, rc.estimate.limiter_rates)
                for rc in ranked]:
            raise AssertionError(f"the API's {name} ranking is not rank_configs'")
    if out["lbm"]["launch"] != LK.LAST_LAUNCH["lbm_pointwise"] \
            or out["stencil"]["launch"] != result.best("stencil3d25").config:
        raise AssertionError("the example's kernels did not run at the API's winners")
    say(f"api example: price() ranked 168 + 168 launches in {result.wall_time_s:.3f} s "
        f"(serial), then ran star_pointwise at {out['stencil']['launch'].block}/"
        f"{out['stencil']['launch'].folding} (max abs error {out['stencil']['max_abs_err']!r}) "
        f"and lbm_pointwise at {out['lbm']['launch'].block}/{out['lbm']['launch'].folding} "
        f"(max abs error {out['lbm']['max_abs_err']!r}), tolerance {TOL[8]}; launches "
        f"{launches}; the rankings equal rank_configs' bitwise; whole example "
        f"{t_example:.2f} s")

    # A2. one ranking of each path's 168 launches, four ways (host time)
    def cold():
        perfmodel._WAVE_BOX_MEMO.clear()
        gridwalk._STREAM_MEMO.clear()

    def key(entries):
        return [(e.config, e.perf, e.limiter) for e in entries]

    ctx = pool._context()
    if ctx is None or ctx.get_start_method() == "fork":
        raise AssertionError(f"the pool after CUDA would start with {ctx and ctx.get_start_method()}")
    times = {}
    for name, spec in (("stencil", star_stencil_3d(R, DOMAIN, 8)),
                       ("lbm", lbm_d3q15(LBM_DOMAIN, 8))):
        cold()
        t0 = time.perf_counter()
        serial = price(gpu_request(spec, H100))
        t_serial = time.perf_counter() - t0
        cold()
        obs.reset()
        obs.enable()
        t0 = time.perf_counter()
        pooled = price(gpu_request(spec, H100), engine=Explorer(parallel=True))
        t_pooled = time.perf_counter() - t0
        obs.disable()
        spans = obs.spans()
        chunks = [r for r in spans if r.name == "pool.chunk"]
        workers = {r.pid for r in chunks}
        obs.reset()
        if not chunks or os.getpid() in workers:
            raise AssertionError(f"the pooled {name} ranking ran no pool worker")
        # where the pooled sweep's time goes, from its spans (host clock, µs)
        run = next(r for r in spans if r.name == "pool.run")
        sweep = next(r for r in spans if r.name == "engine.sweep")
        first = min(c.t0_us for c in chunks) - run.t0_us
        last = max(c.t0_us + c.dur_us for c in chunks) - run.t0_us
        chunk_s = sum(c.dur_us for c in chunks) / 1e6
        task_s = sum(r.dur_us for r in spans if r.cat == "task") / 1e6
        split = {"sweep_s": sweep.dur_us / 1e6, "pool_run_s": run.dur_us / 1e6,
                 "first_chunk_s": first / 1e6, "last_chunk_end_s": last / 1e6,
                 "chunks": len(chunks), "chunk_s": chunk_s, "task_s": task_s,
                 "busy_share": chunk_s / (len(workers) * run.dur_us / 1e6)}
        engine = Explorer(parallel=True)
        t0 = time.perf_counter()
        pruned = price(gpu_request(spec, H100, top_k=RANK_TOP_K), engine=engine)
        t_pruned = time.perf_counter() - t0
        t0 = time.perf_counter()
        warm = price(gpu_request(spec, H100, top_k=RANK_TOP_K), engine=engine)
        t_warm = time.perf_counter() - t0
        if key(pooled.entries) != key(serial.entries) or len(serial.entries) != 168 \
                or key(pruned.entries) != key(serial.entries)[:RANK_TOP_K] \
                or key(warm.entries) != key(pruned.entries):
            raise AssertionError(f"the {name} rankings disagree between the four ways")
        if warm.cache_stats["misses"] or warm.cache_stats["pool_tasks"]:
            raise AssertionError(f"the warm {name} ranking did structural work: "
                                 f"{warm.cache_stats}")
        times[name] = {"serial_s": t_serial, "pooled_s": t_pooled, "pruned_s": t_pruned,
                       "warm_s": t_warm, "workers": len(workers),
                       "start_method": ctx.get_start_method(), "pooled_split": split,
                       "pruned": pruned.cache_stats["pruned"],
                       "pool_tasks": {"serial": serial.cache_stats["pool_tasks"],
                                      "pruned": pruned.cache_stats["pool_tasks"]}}
        say(f"api ranking {name} (168 launches on {H100.name}, fp64), {card}, {cores} cores: "
            f"serial {t_serial:.3f} s; pooled ({ctx.get_start_method()}, {len(workers)} "
            f"worker processes, started after CUDA) {t_pooled:.3f} s; pooled top-{RANK_TOP_K} "
            f"{t_pruned:.3f} s ({pruned.cache_stats['pruned']} launches pruned, "
            f"{pruned.cache_stats['pool_tasks']} of {serial.cache_stats['pool_tasks']} "
            f"structural tasks); the same engine warm {t_warm:.4f} s (0 tasks); all four "
            f"agree bitwise")
        say(f"  pooled {name} sweep's spans: sweep {split['sweep_s']:.3f} s, pool.run "
            f"{split['pool_run_s']:.3f} s; first chunk starts at {split['first_chunk_s']:.3f} s, "
            f"the last ends at {split['last_chunk_end_s']:.3f} s; {len(chunks)} chunks, "
            f"{split['chunk_s']:.3f} s of chunks ({split['task_s']:.3f} s in tasks) on "
            f"{len(workers)} workers, busy share {split['busy_share']:.3f}; serial sweep "
            f"{t_serial:.3f} s")

    # what a pool worker pays before its first task: a fresh interpreter,
    # then the imports that unpickling a task brings in
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    starts = {}
    for what, code in (("interpreter", "pass"), ("numpy", "import numpy"),
                       ("engine", "import repro_torch.core.engine")):
        t0 = time.perf_counter()
        subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
        starts[what] = time.perf_counter() - t0
    times["process_start_s"] = starts
    say(f"api: a fresh process on this host takes {starts['interpreter']:.3f} s, "
        f"{starts['numpy']:.3f} s with numpy imported, {starts['engine']:.3f} s with "
        f"repro_torch.core.engine imported (one at a time, while the card is idle)")

    # A3. streaming reads beside the model's L2 and DRAM rates
    reads = {}
    padded = tuple(d + 2 * R for d in DOMAIN)
    star_bytes = 8 * (padded[0] * padded[1] * padded[2] + DOMAIN[0] * DOMAIN[1] * DOMAIN[2])
    lbm_pad = tuple(d + 2 for d in LBM_DOMAIN)
    lbm_bytes = 8 * (16 * lbm_pad[0] * lbm_pad[1] * lbm_pad[2]
                     + 15 * LBM_DOMAIN[0] * LBM_DOMAIN[1] * LBM_DOMAIN[2])
    for label, n_bytes, passes, model in (
            ("L2-resident", STREAM_L2_BYTES, STREAM_L2_PASSES, H100.l2_bw),
            ("stencil footprint", star_bytes, 1, H100.dram_bw),
            ("LBM footprint", lbm_bytes, 1, H100.dram_bw)):
        read, ms, gbs = stream_read(torch, dev, n_bytes, passes)
        torch.cuda.empty_cache()
        reads[label] = {"footprint_bytes": n_bytes, "bytes": read, "ms": ms, "GB_s": gbs,
                        "model_GB_s": model / 1e9}
        say(f"api stream read {label}: {n_bytes / 2**20:.1f} MiB footprint x {passes} "
            f"pass(es), {ms:.4f} ms a call (10 queued calls, median of 5 rounds) = "
            f"{gbs:.1f} GB/s beside the model's {model / 1e9:.0f} GB/s "
            f"({'H100.l2_bw' if passes > 1 else 'H100.dram_bw'}); {card}")
    say("api: " + json.dumps({"card": card, "cores": cores, "example_s": t_example,
                              "rank": times, "stream_read": reads}))

    # the forkserver the pooled sweeps started outlives them: stop it
    pool.stop_helpers()
    left = live_children()
    if left:
        raise AssertionError(f"processes the smoke started are still there: {left}")
    say("api: the pool's forkserver stopped and reaped; no child process left")
    return launches, reads, {"result": result, "rank": times}


QUICK_DOMAIN = (192, 192, 256)           # (Z, Y, X), examples/quickstart.py's
QUICK_DIVIDED_DOMAIN = (256, 192, 256)   # Z a multiple of the quickstart winner's z extent
# the simulator's and the estimator's (load, store) B/LUP of the quickstart's
# winner there, held against the reference's by tests/test_torch_cachesim.py
# (the simulation takes a minute of the chip machine's host)
QUICK_DIVIDED_SIM, QUICK_DIVIDED_EST = (6.82, 8.00), (9.07, 8.00)
FIELDS_APART_BYTES = 1 << 40             # the gap between fields in the simulator's check
# the paper's volume check (§5.8) on the full H100 model, fp64: (name, kernel,
# domain, ranked launch (block, folding), simulator's and estimator's (load,
# store) B/LUP to two decimals); tests/test_torch_cachesim.py holds them
# exactly against the reference's simulator and estimator on the CPU
SIM_CHECKS = (
    ("stencil", "star_pointwise", DOMAIN, ((16, 2, 32), (1, 1, 1)), (9.29, 8.00),
     (10.50, 8.00)),
    ("lbm", "lbm_pointwise", LBM_DOMAIN, ((256, 4, 1), (1, 2, 1)), (130.04, 120.00),
     (129.48, 120.00)),
    ("quickstart", "star_pointwise", QUICK_DOMAIN, ((16, 1, 64), (1, 1, 2)), (13.63, 16.00),
     (9.57, 8.00)),
)


def fields_apart(spec):
    """``spec`` with its k-th field's base moved k * ``FIELDS_APART_BYTES`` up (a
    multiple of the line, so each field's alignment modulo a line stays):
    the simulator gives every field addresses from 0, so fields share line
    ids; apart, they do not."""
    import dataclasses

    bases = {}
    for a in spec.accesses:
        bases.setdefault(a.field.name, len(bases) * FIELDS_APART_BYTES // a.field.elem_bytes)
    return dataclasses.replace(spec, accesses=tuple(
        dataclasses.replace(a, field=dataclasses.replace(
            a.field, alignment=a.field.alignment + bases[a.field.name]))
        for a in spec.accesses))


def entry_key(e) -> tuple:
    """One ranked entry, every number of it, for bitwise comparison."""
    est = e.estimate
    return (e.config.block, e.config.folding, e.perf, e.limiter,
            tuple(sorted(est.limiter_rates.items())), est.l1_cycles_per_lup,
            est.l2_l1_load_per_lup, est.l2_l1_store_per_lup, est.dram_load_per_lup,
            est.dram_store_per_lup)


def run_sim(args, torch, dev, kernels: list, reads: dict) -> dict:
    """The cache simulator and the design-space sweep on the card's host: S1
    the quickstart example (``examples/torch_quickstart.main``) on the card,
    its H100 winner run by ``star_pointwise`` and timed; S2 the paper's
    volume check, the LRU simulator's DRAM volume (``core.cachesim``) beside
    the estimator's for the ranked winners of both paths and the
    quickstart's, and the DRAM rates these imply at the kernels' measured
    times; S3 the design-space example (``examples/torch_design_space.main``)
    on the pooled engine started after CUDA, held to a serial sweep and to
    ``price`` on its A100 anchor.  Returns the quickstart's launch counts."""
    import os

    from repro_torch import obs
    from repro_torch.api import gpu_request, price
    from repro_torch.core import designspace
    from repro_torch.core.cachesim import simulate_l2_waves
    from repro_torch.core.engine import Explorer, pool
    from repro_torch.core.machines import A100, H100
    from repro_torch.core.perfmodel import estimate_gpu
    from repro_torch.core.specs import lbm_d3q15, star_stencil_3d
    from repro_torch.kernels.lbm_d3q15.generator import best_config as lbm_best
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import best_config as star_best
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_weights

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_design_space as design
    import torch_quickstart as quick

    card = card_line()
    cores = len(os.sched_getaffinity(0))
    say(f"sim: card {card}; host {cores} cores available ({os.cpu_count()} on the host)")
    if (quick.R, quick.DOMAIN, quick.ELEM_BYTES, quick.TOL) != (R, QUICK_DOMAIN, 8, TOL[8]):
        raise AssertionError("the quickstart's range, domain, dtype or tolerance are not "
                             "the smoke's")

    # S1. the quickstart on the card: rank on the H100, cross-check on the
    # H100/8 against the simulator, run the winner through star_stencil
    reset_counts()
    t0 = time.perf_counter()
    q = quick.main(device=dev)
    torch.cuda.synchronize()
    t_quick = time.perf_counter() - t0
    launches = {"star_pointwise": K.LAUNCHES["star_pointwise"]}
    if launches["star_pointwise"] < 1:
        raise AssertionError(f"the quickstart launched {launches}")
    launch = q["launch"]
    if launch != q["ranked"][0].launch or len(q["ranked"]) != 168:
        raise AssertionError(f"the quickstart ran {launch}, not its ranking's first")
    if not q["max_abs_err"] <= TOL[8]["atol"]:
        raise AssertionError(f"the quickstart's stencil is off by {q['max_abs_err']!r}")
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    padded = pad_input(torch.randn(QUICK_DOMAIN, dtype=torch.float64, device=dev,
                                   generator=gen), R)
    w = star_weights(R, torch.float64, dev)
    quick_ms = cuda_ms(torch, lambda: K.star_pointwise(padded, w, R, launch))
    # the same launch where no block overhangs the domain in z
    divided = pad_input(torch.randn(QUICK_DIVIDED_DOMAIN, dtype=torch.float64, device=dev,
                                    generator=gen), R)
    divided_ms = cuda_ms(torch, lambda: K.star_pointwise(divided, w, R, launch))
    divided_bound = bound(divided, R)[0]
    del divided
    q_bound, q_by = bound(padded, R)
    n_quick = QUICK_DOMAIN[0] * QUICK_DOMAIN[1] * QUICK_DOMAIN[2]
    q_pred = n_quick / q["winner"].perf * 1e3
    small = q["small"]
    say(f"sim S1 quickstart: ranked 168 launches of r={R} at {QUICK_DOMAIN} fp64 on "
        f"{H100.name}, ran star_pointwise at the first, {launch.block}/{launch.folding} "
        f"(launches {launches}, max abs error {q['max_abs_err']!r}, tolerance {TOL[8]}); "
        f"{small['machine'].name} cross-check at {small['spec'].domain}, "
        f"{small['winner'].launch.block}/{small['winner'].launch.folding}: predicted "
        f"{small['winner'].estimate.dram_load_per_lup:.2f} B/LUP, simulated "
        f"{small['sim']['dram_load_bytes_per_lup']:.2f} ({small['sim_s']:.3f} s host); "
        f"whole example {t_quick:.2f} s")
    say(f"time star_pointwise fp64 at the quickstart's winner {launch.block}/"
        f"{launch.folding}, {QUICK_DOMAIN}: {quick_ms:.4f} ms (3 warm-ups, median of 20), "
        f"bound {q_bound:.4f} ms ({q_by}), {q_bound / quick_ms * 100:.1f}% of bound; "
        f"predicted {q_pred:.4f} ms ({q['winner'].estimate.limiter}-limited); {card}")
    ext = launch.block_extent()
    n_divided = QUICK_DIVIDED_DOMAIN[0] * QUICK_DIVIDED_DOMAIN[1] * QUICK_DIVIDED_DOMAIN[2]
    say(f"time star_pointwise fp64 at the same launch, {QUICK_DIVIDED_DOMAIN} (Z a multiple "
        f"of its z extent {ext[2]}; at {QUICK_DOMAIN} the last z-layer of blocks overhangs Z "
        f"by {-QUICK_DOMAIN[0] % ext[2]} planes): {divided_ms:.4f} ms, bound "
        f"{divided_bound:.4f} ms, {divided_bound / divided_ms * 100:.1f}% of bound; "
        f"{n_divided / divided_ms / 1e6:.2f} GLUP/s against {n_quick / quick_ms / 1e6:.2f} "
        f"at {QUICK_DOMAIN}")
    for k in kernels:
        if k["name"] == "star_pointwise" and k.get("config", "") is None:
            k["sim_ms"] = quick_ms

    # S2. the paper's volume check: estimator against the LRU simulator on
    # the full H100 model, and the rates they imply at the measured times
    record = {k["name"]: k for k in kernels if k.get("config", "") is None}
    times = {"stencil": (record["star_pointwise"]["ms"], "the stencil phase's time of "
                         "star_pointwise fp64 at its ranked launch"),
             "lbm": (record["lbm_pointwise"]["ms"], "the LBM phase's time of "
                     "lbm_pointwise fp64 at its ranked launch"),
             "quickstart": (quick_ms, "S1's time")}
    quick_bytes = 8 * (padded.numel() + n_quick)
    del padded
    q_read = stream_read(torch, dev, quick_bytes)
    torch.cuda.empty_cache()
    rates = {"stencil": (reads["stencil footprint"]["GB_s"], reads["stencil footprint"]),
             "lbm": (reads["LBM footprint"]["GB_s"], reads["LBM footprint"]),
             "quickstart": (q_read[2], {"footprint_bytes": quick_bytes, "ms": q_read[1]})}
    winners = {"stencil": star_best(R, DOMAIN, 8, H100).launch,
               "lbm": lbm_best(LBM_DOMAIN, 8, H100).launch, "quickstart": launch}
    checks = {}
    for name, kernel, domain, (block, fold), sim_want, est_want in SIM_CHECKS:
        spec = (lbm_d3q15(domain, 8) if name == "lbm" else star_stencil_3d(R, domain, 8))
        lc = winners[name]
        if (lc.block, lc.folding) != (block, fold):
            raise AssertionError(f"sim {name}: the ranked winner is {lc}, not the check's "
                                 f"{block}/{fold}")
        est = estimate_gpu(spec, lc, H100)
        t0 = time.perf_counter()
        sim = simulate_l2_waves(spec, lc, H100)
        sim_s = time.perf_counter() - t0
        got = (round(sim["dram_load_bytes_per_lup"], 2), round(sim["dram_store_bytes_per_lup"], 2))
        got_est = (round(est.dram_load_per_lup, 2), round(est.dram_store_per_lup, 2))
        if got != sim_want or got_est != est_want:
            raise AssertionError(f"sim {name}: simulator {got} B/LUP, estimator {got_est}; "
                                 f"the reference gives {sim_want} and {est_want}")
        n = domain[0] * domain[1] * domain[2]
        ms, ms_from = times[name]
        bpl = {"sim": sim["dram_load_bytes_per_lup"] + sim["dram_store_bytes_per_lup"],
               "est": est.dram_load_per_lup + est.dram_store_per_lup}
        line = ""
        if name == "stencil":  # where the fields' shared line ids move the volume
            t0 = time.perf_counter()
            apart = simulate_l2_waves(fields_apart(spec), lc, H100)
            apart_s = time.perf_counter() - t0
            bpl["apart"] = apart["dram_load_bytes_per_lup"] + apart["dram_store_bytes_per_lup"]
            line = (f"; fields apart {apart['dram_load_bytes_per_lup']:.2f} + "
                    f"{apart['dram_store_bytes_per_lup']:.2f} ({apart_s:.2f} s)")
        rate = {what: b * n / (ms * 1e-3) / 1e9 for what, b in bpl.items()}
        read_gbs, read = rates[name]
        checks[name] = {
            "launch": [list(block), list(fold)], "lups": n,
            "est_B_per_lup": [est.dram_load_per_lup, est.dram_store_per_lup],
            "sim_B_per_lup": [sim["dram_load_bytes_per_lup"], sim["dram_store_bytes_per_lup"]],
            "sim_s": sim_s, "sim_measured_lups": sim["lups"], "wave_blocks": sim["wave_blocks"],
            "B_per_lup": bpl, "kernel_ms": ms, "kernel_ms_from": ms_from,
            "implied_GB_s": rate, "stream_read_GB_s": read_gbs,
            "stream_read_footprint_bytes": read["footprint_bytes"],
            "model_dram_GB_s": H100.dram_bw / 1e9}
        say(f"sim S2 {name} {kernel} {block}/{fold} at {domain} fp64 on {H100.name}: "
            f"estimator {est.dram_load_per_lup:.2f} + {est.dram_store_per_lup:.2f} B/LUP, "
            f"simulator {sim['dram_load_bytes_per_lup']:.2f} + "
            f"{sim['dram_store_bytes_per_lup']:.2f} B/LUP ({sim_s:.2f} s host, "
            f"{sim['lups']} LUPs measured in a wave of {sim['wave_blocks']} blocks), equal to "
            f"the reference's{line}")
        say(f"  {name}: kernel {ms:.4f} ms ({ms_from}) -> "
            + ", ".join(f"{what} bytes at {r:.1f} GB/s" for what, r in rate.items())
            + f"; H100.dram_bw {H100.dram_bw / 1e9:.0f} GB/s; a torch.sum stream read of the "
            f"{read['footprint_bytes'] / 2**20:.1f} MiB footprint {read_gbs:.1f} GB/s; {card}, "
            f"{cores} cores")
    # the quickstart's winner where no block overhangs the domain in z: the
    # estimator live, the simulator's volume as the CPU tests pin it
    est = estimate_gpu(star_stencil_3d(R, QUICK_DIVIDED_DOMAIN, 8), launch, H100)
    got_est = (round(est.dram_load_per_lup, 2), round(est.dram_store_per_lup, 2))
    if got_est != QUICK_DIVIDED_EST:
        raise AssertionError(f"sim quickstart at {QUICK_DIVIDED_DOMAIN}: estimator {got_est}, "
                             f"the reference gives {QUICK_DIVIDED_EST}")
    rate = {what: sum(b) * n_divided / (divided_ms * 1e-3) / 1e9
            for what, b in (("sim", QUICK_DIVIDED_SIM), ("est", got_est))}
    checks["quickstart_divided"] = {
        "domain": list(QUICK_DIVIDED_DOMAIN), "lups": n_divided, "kernel_ms": divided_ms,
        "est_B_per_lup": [est.dram_load_per_lup, est.dram_store_per_lup],
        "sim_B_per_lup": list(QUICK_DIVIDED_SIM), "implied_GB_s": rate}
    say(f"sim S2 quickstart's winner at {QUICK_DIVIDED_DOMAIN}: estimator {got_est[0]:.2f} + "
        f"{got_est[1]:.2f} B/LUP, simulator {QUICK_DIVIDED_SIM[0]:.2f} + "
        f"{QUICK_DIVIDED_SIM[1]:.2f} (tests/test_torch_cachesim.py); kernel "
        f"{divided_ms:.4f} ms -> simulated bytes at {rate['sim']:.1f} GB/s, estimated at "
        f"{rate['est']:.1f} GB/s; {card}")

    # S3. the design-space sweep on the pooled engine, started after CUDA
    ctx = pool._context()
    if ctx is None or ctx.get_start_method() == "fork":
        raise AssertionError(f"the pool after CUDA would start with "
                             f"{ctx and ctx.get_start_method()}")
    obs.reset()
    obs.enable()
    d = design.main(device=dev)
    obs.disable()
    workers = {r.pid for r in obs.spans() if r.name == "pool.chunk"}
    obs.reset()
    if not workers or os.getpid() in workers:
        raise AssertionError("the pooled design-space sweep ran no pool worker")
    machines, report = d["machines"], d["report"]
    t0 = time.perf_counter()
    serial = designspace.design_space_sweep([design.workload()], machines,
                                            configs=d["configs"], top_k=design.TOP_K,
                                            explorer=Explorer())
    t_serial = time.perf_counter() - t0
    if [(e.workload, e.machine, e.index) + entry_key(e) for e in report.entries] != \
            [(e.workload, e.machine, e.index) + entry_key(e) for e in serial.entries] \
            or len(report.entries) != len(machines) * design.TOP_K:
        raise AssertionError("the pooled design-space sweep is not the serial one")
    anchor = price(gpu_request(design.workload().gpu_spec, A100, d["configs"],
                               top_k=design.TOP_K))
    if [entry_key(e) for e in anchor.entries] != \
            [entry_key(e) for e in report.ranking(machine=A100.name)]:
        raise AssertionError("the sweep's A100 cell is not price()'s")
    stats = report.cache_stats
    checks["design_space"] = {
        "machines": len(machines), "configs": len(d["configs"]), "pooled_s": d["seconds"],
        "serial_s": t_serial, "machines_per_s": len(machines) / d["seconds"],
        "serial_machines_per_s": len(machines) / t_serial, "workers": len(workers),
        "start_method": ctx.get_start_method(), "geometry_groups": stats["geometry_groups"],
        "pool_tasks": stats["pool_tasks"], "geometry_share": stats["geometry_share"]}
    say(f"sim S3 design space: {len(machines)} machines x {len(d['configs'])} launches, top "
        f"{design.TOP_K}: pooled ({ctx.get_start_method()}, {len(workers)} worker processes, "
        f"started after CUDA) {d['seconds']:.3f} s, {len(machines) / d['seconds']:.1f} "
        f"machines/s; serial {t_serial:.3f} s, {len(machines) / t_serial:.1f} machines/s; "
        f"{stats['geometry_groups']} geometry groups, {stats['pool_tasks']} structural "
        f"tasks; entries equal the serial sweep's bitwise, the A100 cell equals price()'s; "
        f"{card}, {cores} cores")
    say("sim: " + json.dumps({"card": card, "cores": cores, "quickstart_s": t_quick,
                              "quickstart_ms": quick_ms, "quickstart_bound_ms": q_bound,
                              "quickstart_predicted_ms": q_pred,
                              "quickstart_divided_ms": divided_ms, "checks": checks}))

    pool.stop_helpers()
    left = live_children()
    if left:
        raise AssertionError(f"processes the smoke started are still there: {left}")
    say("sim: the pool's forkserver stopped and reaped; no child process left")
    return launches


# examples/torch_model_pricing.py's rows (mixtral-8x7b at train_4k): machine
# -> (time a pass s, flops, HBM bytes, dominant, workload rows), and the
# suite's H100 price of granite-3-2b at train_4k: (time a pass s, flops,
# HBM bytes, dominant) and its time a role; tests/test_torch_suite.py holds
# them exactly against the reference's suite on the CPU (the chip machine
# has no jax), and the card's host holds its own within SUITE_RTOL
MODEL_PRICING_ROWS = {
    "V100-PCIe-32GB": (96.16262544695653, 113232517791744.0, 29598447903612.53, "memory", 225),
    "A100-SXM4-40G": (69.71600899227738, 113232517791744.0, 29476617934614.87, "memory", 225),
    "TPUv5e": (0.5850649735220053, 108834471280640.0, 239211642880.0, "compute", 193),
}
GRANITE_H100 = (10.18967922583209, 26255135080448.0, 6924370839428.047, "memory")
GRANITE_H100_ROLES = {
    "attn.qkv": 0.8001056810730257,
    "attn.core[qk]": 1.066807574764033,
    "attn.core[av]": 1.066807574764033,
    "attn.out": 0.5334037873820165,
    "mlp.in": 4.267230299056132,
    "mlp.out": 2.133615149528066,
    "head.lm": 0.32170915926477894,
}
SUITE_RTOL = 1e-9                        # another host's numpy may sum in another order
SUITE_PASSES = 5                         # timed runs of the whole pass, back to back


def same_numbers(got, want) -> bool:
    """Whether two tuples agree, floats within SUITE_RTOL, the rest exactly."""
    return len(got) == len(want) and all(
        abs(g - w) <= SUITE_RTOL * abs(w) if isinstance(w, float) else g == w
        for g, w in zip(got, want))


def run_suite(args, torch, dev, kernels: list) -> dict:
    """The model suite on the card's host and its plan on the card: U1 the
    model-pricing example (``examples/torch_model_pricing.main``), its rows
    held to the reference's; U2 a ``plan_request`` for granite-3-2b's
    ``train_4k`` plan on ``H100`` through the wire codec and ``price``; U3
    one forward pass of that plan at full width, each distinct GEMM class
    through ``tuned_matmul`` (bf16) and the attention core through
    ``flash_attention``, held against their plain versions and timed beside
    the suite's H100 price of each and their bf16 bound.  Returns U3's
    launch counts."""
    import os

    from repro_torch.api import PlanRef, plan_request, price
    from repro_torch.configs import get_config
    from repro_torch.core.engine import pool
    from repro_torch.kernels.flash_attention import kernel as FK
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.matmul import kernel as MK
    from repro_torch.kernels.matmul.ops import tuned_matmul
    from repro_torch.kernels.matmul.ref import matmul_ref
    from repro_torch.serve import schema
    from repro_torch.suite import lower_model

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_model_pricing as pricing

    card = card_line()
    cores = len(os.sched_getaffinity(0))
    say(f"suite: card {card}; host {cores} cores available ({os.cpu_count()} on the host)")

    # U1. the example: one price() sweep of mixtral-8x7b's plan on three machines
    t0 = time.perf_counter()
    out = pricing.main()
    t_example = time.perf_counter() - t0
    got = out["suite"]
    rows = {machine: (r.time_s, r.flops, r.hbm_bytes, r.roofline.dominant, len(r.rows))
            for (_, machine), r in got.reports.items()}
    if set(rows) != set(MODEL_PRICING_ROWS) or not all(
            same_numbers(rows[m], want) for m, want in MODEL_PRICING_ROWS.items()):
        raise AssertionError(f"the example's rows {rows} are not the reference's "
                             f"{MODEL_PRICING_ROWS}")
    exact = rows == MODEL_PRICING_ROWS
    say(f"suite U1 model pricing: {pricing.ARCH} at {pricing.SHAPE}, {len(out['plan'].workloads)} "
        f"workloads, {len(out['plan'].distinct())} structural classes, priced on "
        f"{len(rows)} machines in {got.wall_time_s:.4f} s (sweep), the example {t_example:.4f} s; "
        f"invariant cache {got.cache_stats['hits']} hits / {got.cache_stats['misses']} misses; "
        f"rows equal the reference's {'exactly' if exact else f'within {SUITE_RTOL}'}; {card}")
    say("suite U1 table:\n" + got.table())

    # U2. a PlanRef request through the wire codec, priced on the H100
    request = plan_request({"granite-3-2b": PlanRef("granite-3-2b", "train_4k")}, ["H100"])
    text = schema.dumps(request)
    back = schema.loads(text)
    if back != request:
        raise AssertionError("the plan request does not round-trip through the codec")
    t0 = time.perf_counter()
    result = price(back)
    t_price = time.perf_counter() - t0
    report = result.suite.get("granite-3-2b", "H100-SXM5-80G")
    priced = (report.time_s, report.flops, report.hbm_bytes, report.roofline.dominant)
    roles = report.by_role()
    if not report.complete or not same_numbers(priced, GRANITE_H100) or set(roles) != set(
            GRANITE_H100_ROLES) or not all(same_numbers((roles[k],), (v,))
                                           for k, v in GRANITE_H100_ROLES.items()):
        raise AssertionError(f"the H100 price of granite-3-2b {priced}, {roles} is not the "
                             f"reference's {GRANITE_H100}, {GRANITE_H100_ROLES}")
    say(f"suite U2 plan request: {len(text)} bytes on the wire, decoded equal; price() on "
        f"H100 in {t_price:.4f} s ({result.suite.wall_time_s:.4f} s the sweep): "
        f"{report.time_s * 1e3:.2f} ms a pass, {report.flops / 1e12:.2f} TFLOP, "
        f"{report.hbm_bytes / 1e9:.2f} GB, {report.roofline.dominant}-dominant, "
        f"{len(report.rows)} rows (the reference's numbers); by role (ms): "
        + ", ".join(f"{k} {v * 1e3:.2f}" for k, v in roles.items()))

    # the pools the sweeps may have started outlive them: stop them
    pool.stop_helpers()
    left = live_children()
    if left:
        raise AssertionError(f"processes the smoke started are still there: {left}")
    say("suite: no pool helper and no child process left after the sweeps")

    # U3. one forward pass of the plan on the card: the GEMM classes through
    # tuned_matmul, the attention core through flash_attention in place of
    # the GPU half's per-head core[qk] / core[av] GEMM classes
    cfg = get_config("granite-3-2b")
    plan = lower_model(cfg, "train_4k")
    Hq, Hkv, D = cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim
    S = plan.shape.seq_len
    # the GPU half's GEMM classes by (M, K, N): their roles, count a pass and
    # the suite's H100 price of them all; the attention core's per-head
    # classes priced together, one flash call a layer on the card
    priced_rows = {r.name: r for r in report.rows}
    classes, n_attn, attn_price = {}, 0, 0.0
    for w in plan.workloads:
        if "gpu" not in w.backends:
            continue
        row = priced_rows[w.name]
        if w.role in ("attn.core[qk]", "attn.core[av]"):
            n_attn += w.role == "attn.core[qk]"
            attn_price += row.total_time_s
            continue
        c = classes.setdefault((w.params["M"], w.params["K"], w.params["N"]),
                               {"roles": [], "count": 0, "price_s": 0.0})
        c["roles"] += [] if w.role in c["roles"] else [w.role]
        c["count"] += w.count
        c["price_s"] += row.total_time_s
    gemms = [("+".join(c["roles"]), shape, c["count"]) for shape, c in classes.items()]
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    operands = {}
    for role, (M, K, N), _ in gemms:
        a = torch.randn((M, K), device=dev, generator=gen).bfloat16()
        b = (torch.randn((K, N), device=dev, generator=gen) * K ** -0.5).bfloat16()
        operands[role] = (a, b)
    q = torch.randn((plan.batch, Hq, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    k = torch.randn((plan.batch, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)
    v = torch.randn((plan.batch, Hkv, S, D), device=dev, generator=gen, dtype=torch.bfloat16)

    # the main path: each class once through its entry point, every launch counted
    reset_counts()
    outs = {role: tuned_matmul(a, b) for role, (a, b) in operands.items()}
    attn = flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    launches = {"matmul_tiled": MK.LAUNCHES["matmul_tiled"],
                "flash_attention_fwd": FK.LAUNCHES["flash_attention_fwd"]}
    mm_tile = MK.LAST_LAUNCH["matmul_tiled"]
    fa_tile = FK.LAST_LAUNCH["flash_attention_fwd"]
    if launches != {"matmul_tiled": len(gemms), "flash_attention_fwd": 1} or \
            mm_tile[0] != "wgmma" or FK.fwd_route(torch.bfloat16, D, *fa_tile[:2]) != "wgmma":
        raise AssertionError(f"suite pass: launches {launches} (want {len(gemms)} GEMMs and 1 "
                             f"flash forward), last GEMM {mm_tile}, last flash {fa_tile}")
    errs = {role: check_close(torch, outs[role], matmul_ref(a, b), f"suite {role} bf16",
                              **GEMM_TOL[2]) for role, (a, b) in operands.items()}
    del outs
    want = attention_ref(q.float(), k.float(), v.float(), True).to(torch.bfloat16)
    err_attn, rel_attn = check_flash(torch, attn, want, "suite attention core", 2)
    del attn, want
    say(f"suite U3 main path: {len(gemms)} GEMM classes through tuned_matmul at "
        f"{mm_tile}, the attention core through flash_attention at {fa_tile}; launches "
        f"{launches}; max abs error {errs} (rtol/atol {GEMM_TOL[2]}); attention "
        f"{err_attn!r} ({FLASH_TOL[2]}), row relative {rel_attn!r} (bound {FLASH_ROW_REL[2]})")

    # times: each class alone, beside the suite's H100 price of it and its bound
    lines, total, bound_total, flops_total = [], 0.0, 0.0, 0.0
    for role, (M, K, N), count in gemms:
        a, b = operands[role]
        ms = cuda_ms(torch, lambda: tuned_matmul(a, b))
        b_ms, b_by = bf16_bound(2.0 * M * K * N, (M * K + K * N + M * N) * 2)
        price_ms = classes[(M, K, N)]["price_s"] * 1e3
        total += count * ms
        bound_total += count * b_ms
        flops_total += count * 2.0 * M * K * N
        lines.append({"class": role, "shape": [M, K, N], "count": count, "ms": ms,
                      "total_ms": count * ms, "suite_h100_ms": price_ms,
                      "bound_ms": b_ms, "bound_by": b_by})
        say(f"suite U3 {role} {M}x{K}x{N} x{count}: {ms:.4f} ms, x{count} = "
            f"{count * ms:.4f} ms ({2.0 * M * K * N / ms / 1e9:.1f} TFLOP/s); the suite's H100 "
            f"price of the class {price_ms:.4f} ms ({price_ms / (count * ms):.1f}x); bound "
            f"{count * b_ms:.4f} ms ({b_by})")
    ms = cuda_ms(torch, lambda: flash_attention(q, k, v, causal=True))
    b_ms, b_by, flops = attention_bound(plan.batch, Hq, Hkv, S, S, D, True, 2)
    price_ms = attn_price * 1e3
    total += n_attn * ms
    bound_total += n_attn * b_ms
    flops_total += n_attn * flops
    lines.append({"class": "attn.core", "shape": [plan.batch, Hq, Hkv, S, D], "count": n_attn,
                  "ms": ms, "total_ms": n_attn * ms, "suite_h100_ms": price_ms,
                  "bound_ms": b_ms, "bound_by": b_by})
    say(f"suite U3 attn.core B {plan.batch} x {Hq}/{Hkv} heads x {S}, D {D}, causal x{n_attn}: "
        f"{ms:.4f} ms, x{n_attn} = {n_attn * ms:.4f} ms; the suite's H100 price of its "
        f"core[qk] + core[av] classes ({2 * plan.batch * Hq} per-head GEMMs a layer) "
        f"{price_ms:.4f} ms ({price_ms / (n_attn * ms):.1f}x); bound {n_attn * b_ms:.4f} ms "
        f"({b_by})")

    # the whole pass back to back, every class its count of times, as a
    # forward pass queues them: the card's time without idle gaps between calls
    def one_pass():
        for role, _, count in gemms:
            a, b = operands[role]
            for _ in range(count):
                tuned_matmul(a, b)
        for _ in range(n_attn):
            flash_attention(q, k, v, causal=True)

    pass_ms = cuda_ms(torch, one_pass, warmup=1, reps=SUITE_PASSES)
    suite_ms = report.time_s * 1e3
    say(f"suite U3 pass: sum of count x ms {total:.4f} ms; the pass back to back {pass_ms:.4f} ms "
        f"(median of {SUITE_PASSES}); the suite's H100 price {suite_ms:.2f} ms, "
        f"{suite_ms / pass_ms:.1f}x the pass on the card; the plan's bf16 bound "
        f"{bound_total:.4f} ms ({flops_total / 1e12:.3f} TFLOP, the pass at "
        f"{bound_total / pass_ms * 100:.1f} % of it); {card}")
    say("suite: " + json.dumps({"card": card, "cores": cores, "example_s": t_example,
                                "example_sweep_s": got.wall_time_s, "price_s": t_price,
                                "classes": lines, "sum_ms": total, "pass_ms": pass_ms,
                                "suite_h100_ms": suite_ms, "ratio": suite_ms / pass_ms,
                                "bound_ms": bound_total, "launches": launches}))
    del operands, q, k, v
    names = {"matmul_tiled": f"matmul_tiled[{'x'.join(map(str, mm_tile[1]))}]",
             "flash_attention_fwd": f"flash_attention_fwd[bq={fa_tile[0]},bk={fa_tile[1]}]"}
    if not all(any(kr["name"] == name for kr in kernels) for name in names.values()):
        raise AssertionError(f"no kernels record named {names}")
    return {names[key]: n for key, n in launches.items()}


SERVE_BIND_S = 120                       # seconds a daemon may take to answer its first ping
SERVE_CALL_S = 600                       # a client's socket timeout
SERVE_HITS = 200                         # memo hits timed of each request
SERVE_TOP_K = 5                          # the pruned request's k
SERVE_RETRIES = 12                       # the restart client's retries (backoff 0.2 s, doubling to 5)


def answer_wire(schema, result) -> str:
    """The wire text of a result's answer (entries, skips, prunes, suite and
    flags), with the sweep's own measurements (wall time, cache counters,
    metrics) left out: those differ between any two sweeps."""
    import dataclasses

    report = dataclasses.replace(result.report, cache_stats={}, wall_time_s=0.0, metrics={})
    return schema.dumps(dataclasses.replace(result, report=report))


def boot_daemon(cmd: list, env: dict, sock: str, log) -> tuple:
    """Start ``python -m repro_torch.serve`` and wait until it answers a
    ping; returns the process and the seconds that took."""
    import os

    from repro_torch.serve import PriceClient

    t0 = time.perf_counter()
    proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
    while True:
        if proc.poll() is not None:
            raise AssertionError(f"the daemon exited {proc.returncode} before it answered")
        if time.perf_counter() - t0 > SERVE_BIND_S:
            proc.kill()
            proc.wait(timeout=60)
            raise AssertionError(f"the daemon did not answer within {SERVE_BIND_S} s")
        if os.path.exists(sock):
            try:
                with PriceClient(sock, timeout=10) as c:
                    if c.ping():
                        return proc, time.perf_counter() - t0
            except OSError:  # bound, not yet listening
                pass
        time.sleep(0.01)


def first_pool_split(trace: dict) -> dict:
    """Where a daemon's first pooled sweep went, from its Chrome trace (host
    clock, s): the sweep, its first ``pool.run``, when that run's first
    chunk started and its last ended (from the run's start), its chunks and
    their worker processes."""
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    sweep = min((e for e in xs if e["name"] == "engine.sweep"), key=lambda e: e["ts"])
    run = min((e for e in xs if e["name"] == "pool.run"), key=lambda e: e["ts"])
    chunks = [e for e in xs if e["name"] == "pool.chunk"
              and run["ts"] <= e["ts"] <= run["ts"] + run["dur"]]
    return {"sweep_s": sweep["dur"] / 1e6, "pool_run_s": run["dur"] / 1e6,
            "first_chunk_s": (min(e["ts"] for e in chunks) - run["ts"]) / 1e6,
            "last_chunk_end_s": (max(e["ts"] + e["dur"] for e in chunks) - run["ts"]) / 1e6,
            "chunks": len(chunks), "workers": len({e["pid"] for e in chunks})}


def percentiles(ts: list) -> tuple:
    """p50 and p99 of ``ts`` in ms."""
    cuts = statistics.quantiles(ts, n=100, method="inclusive")
    return statistics.median(ts) * 1e3, cuts[98] * 1e3


def host_ms(fn, reps: int = 20) -> float:
    """Median host time of ``fn`` in ms, over ``reps`` runs."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    return statistics.median(times) * 1e3


def run_serve(args, torch, dev, kernels: list, priced: dict) -> dict:
    """The pricing daemon on the card's host, its winners on the card: V1
    ``python -m repro_torch.serve`` started as a process (pooled, with a
    cache path, ``--resume``, a pid file and telemetry on, as the api
    phase's pooled rankings have it); V2 the api phase's request
    through its socket, its answer held to the api phase's in-process
    ``price`` on the wire (``answer_wire``), with the stencil's and the
    LBM's own requests sent while it prices, which coalesce into one sweep
    whose split reports must equal their solo rankings, then the same two
    spaces in fp32 on the warm daemon; V3 memo hits of the full report and of a top-k request;
    V4 ``star_pointwise`` and ``lbm_pointwise`` at the served winners,
    which must be the generators', against ``ref.py`` and timed; V5 a
    SIGTERM drain, a ``--resume`` restart answering warm with the same
    bytes to a client built while the daemon was down, then ``shutdown``;
    and a ``PricingDaemon`` in this process on a pooled engine, whose pool
    must not fork after CUDA.  Returns V4's launch counts."""
    import dataclasses
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from repro_torch import obs
    from repro_torch.api import PriceRequest, gpu_request, price
    from repro_torch.core import gridwalk, perfmodel
    from repro_torch.core.engine import Explorer, Workload, pool
    from repro_torch.core.machines import H100
    from repro_torch.core.selector import enumerate_gpu_configs
    from repro_torch.core.specs import lbm_d3q15, star_stencil_3d
    from repro_torch.kernels.lbm_d3q15 import kernel as LK
    from repro_torch.kernels.lbm_d3q15.generator import rank_configs as lbm_rank
    from repro_torch.kernels.lbm_d3q15.ops import lbm_step
    from repro_torch.kernels.lbm_d3q15.ref import WEIGHTS, lbm_step_ref, pad_inputs
    from repro_torch.kernels.stencil3d25 import kernel as K
    from repro_torch.kernels.stencil3d25.generator import rank_configs as star_rank
    from repro_torch.kernels.stencil3d25.ops import star_stencil
    from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights
    from repro_torch.serve import PriceClient, PricingDaemon, schema

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_stencil_codegen as example

    card = card_line()
    cores = len(os.sched_getaffinity(0))
    say(f"serve: card {card}; host {cores} cores available ({os.cpu_count()} on the host)")
    STENCIL, LBM = example.STENCIL, example.LBM
    tmp = Path(tempfile.mkdtemp(prefix="serve-"))
    sock, pid = str(tmp / "s.sock"), tmp / "pid"
    cmd = [sys.executable, "-m", "repro_torch.serve", "--socket", sock,
           "--cache-path", str(tmp / "inv"), "--parallel", "--resume", "--pid-file", str(pid),
           "--trace-out", str(tmp / "trace.json")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(tmp / "daemon.log", "w")
    procs, out = [], {"card": card, "cores": cores}
    try:
        # V1. the daemon process
        proc, out["bind_s"] = boot_daemon(cmd, env, sock, log)
        procs.append(proc)
        if int(pid.read_text()) != proc.pid:
            raise AssertionError("the pid file does not name the daemon")
        # what a fresh daemon pays before it binds: the interpreter and its imports
        starts = {}
        for what, code in (("torch", "import torch"),
                           ("daemon", "import sys, repro_torch.serve.daemon; "
                                      "sys.exit('torch' in sys.modules)")):
            t0 = time.perf_counter()
            subprocess.run([sys.executable, "-c", code], env=env, check=True, timeout=120)
            starts[what] = time.perf_counter() - t0
        out["import_s"] = starts
        say(f"serve V1: python -m repro_torch.serve --parallel --resume answered its first ping "
            f"{out['bind_s']:.3f} s after it was started (pid {proc.pid}); a fresh process "
            f"importing torch takes {starts['torch']:.3f} s, importing repro_torch.serve.daemon "
            f"{starts['daemon']:.3f} s, loading no torch (one at a time, the daemon idle)")

        # V2. the api phase's request cold; the two paths' own requests sent
        # once the worker has taken it, so they queue behind it and coalesce;
        # then both spaces in fp32 on the warm daemon
        pooled = {name: priced["rank"][name]["pooled_s"] for name in ("stencil", "lbm")}
        first = {name: priced["rank"][name]["pooled_split"]["first_chunk_s"]
                 for name in ("stencil", "lbm")}
        full = example.request(DOMAIN, LBM_DOMAIN)
        solo = {STENCIL: gpu_request(star_stencil_3d(R, DOMAIN, 8), "H100"),
                LBM: gpu_request(lbm_d3q15(LBM_DOMAIN, 8), "H100")}
        cold = {}

        def price_cold():
            with PriceClient(sock, timeout=SERVE_CALL_S) as c:
                t0 = time.perf_counter()
                cold["result"] = c.price(full)
                cold["s"] = time.perf_counter() - t0

        worker = threading.Thread(target=price_cold)
        worker.start()
        with PriceClient(sock, timeout=SERVE_CALL_S) as c:
            t_wait = time.perf_counter()
            while True:   # taken off the queue (1 in flight, none queued), not answered
                stats = c.stats()
                if stats["requests"] == 1 and stats["inflight"] == stats["pending"] == 1:
                    break
                if stats["requests"] > 1 or time.perf_counter() - t_wait > SERVE_BIND_S:
                    raise AssertionError(f"the cold request was not seen in flight: {stats}")
                time.sleep(0.001)
            t0 = time.perf_counter()
            split = c.price_many(list(solo.values()))
            pair_s = time.perf_counter() - t0
            worker.join(SERVE_CALL_S)
            stats = c.stats()
            split_s = first_pool_split(c.trace())
        served = cold["result"]
        want = answer_wire(schema, priced["result"])
        if answer_wire(schema, served) != want:
            raise AssertionError("the served answer is not the api phase's in-process price()")
        if stats["coalesced_sweeps"] != 1 or stats["coalesced_requests"] != 2:
            raise AssertionError(f"the two paths' requests did not coalesce: {stats}")
        for (name, request), got in zip(solo.items(), split):
            local = price(request)
            if schema.dumps(got.entries) != schema.dumps(local.entries) or \
                    len(got.entries) != 168 or got.cache_stats.get("coalesced") is not True:
                raise AssertionError(f"the coalesced {name} report is not its solo ranking")
        out.update(cold_s=cold["s"], served_sweep_s=served.wall_time_s, pair_s=pair_s,
                   pair_sweep_s=split[0].wall_time_s, cold_split=split_s)
        say(f"serve V2: the api phase's request (168 + 168 launches on {H100.name}, fp64) cold "
            f"through the socket in {cold['s']:.3f} s ({served.wall_time_s:.3f} s the daemon's "
            f"sweep, {served.cache_stats['pool_tasks']} structural tasks); its answer equals the "
            f"api phase's in-process price() byte for byte ({len(want)} bytes on the wire, the "
            f"sweep's own timings and counters set aside); the stencil's and the LBM's own "
            f"requests, sent while it priced, coalesced into one sweep of 2 requests "
            f"({split[0].wall_time_s:.3f} s, answered {pair_s:.3f} s after they were sent), each "
            f"split report equal to its solo ranking")
        say(f"  the cold sweep's spans in the daemon: sweep {split_s['sweep_s']:.3f} s, first "
            f"pool.run {split_s['pool_run_s']:.3f} s; its first chunk starts at "
            f"{split_s['first_chunk_s']:.3f} s, the last ends at {split_s['last_chunk_end_s']:.3f} "
            f"s; {split_s['chunks']} chunks on {split_s['workers']} workers (the api phase's "
            f"pooled rankings: first chunk at {first['stencil']:.3f} and {first['lbm']:.3f} s)")

        configs = tuple(enumerate_gpu_configs())
        fp32 = PriceRequest(workloads=[
            Workload(STENCIL, gpu_spec=star_stencil_3d(R, DOMAIN, 4), gpu_configs=configs),
            Workload(LBM, gpu_spec=lbm_d3q15(LBM_DOMAIN, 4), gpu_configs=configs)],
            machines=[H100])
        with PriceClient(sock, timeout=SERVE_CALL_S) as c:
            t0 = time.perf_counter()
            served32 = c.price(fp32)
            out["fp32_s"] = time.perf_counter() - t0
        if answer_wire(schema, served32) != answer_wire(schema, price(fp32)):
            raise AssertionError("the served fp32 answer is not the in-process price()")
        say(f"serve V2 fp32: both spaces in fp32 on the warm daemon in {out['fp32_s']:.3f} s "
            f"({served32.wall_time_s:.3f} s its sweep, {served32.cache_stats['pool_tasks']} "
            f"structural tasks, invariant cache {served32.cache_stats['hits']} hits / "
            f"{served32.cache_stats['misses']} misses); the api phase's in-process pooled "
            f"rankings (forkserver after CUDA) took {pooled['stencil']:.3f} + {pooled['lbm']:.3f} "
            f"s for the two fp64 spaces, of which {first['stencil']:.3f} + {first['lbm']:.3f} s "
            f"before the first chunk; equal to in-process price() byte for byte")

        # V3. memo hits: the full report and a top-k request, one client
        topk = dataclasses.replace(full, top_k=SERVE_TOP_K)
        hits = {}
        with PriceClient(sock, timeout=SERVE_CALL_S) as c:
            t0 = time.perf_counter()
            pruned = c.price(topk)
            out["topk_cold_s"] = time.perf_counter() - t0
            for name in (STENCIL, LBM):
                if schema.dumps(pruned.ranking(name)) != \
                        schema.dumps(served.ranking(name)[:SERVE_TOP_K]):
                    raise AssertionError(f"the top-{SERVE_TOP_K} {name} ranking is not the "
                                         "full ranking's head")
            for label, request, first_answer in (("full", full, served),
                                                 (f"top{SERVE_TOP_K}", topk, pruned)):
                ts = []
                for _ in range(SERVE_HITS):
                    t0 = time.perf_counter()
                    got = c.price(request)
                    ts.append(time.perf_counter() - t0)
                if schema.dumps(got) != schema.dumps(first_answer):
                    raise AssertionError(f"a memo hit of the {label} request changed its bytes")
                hits[label] = ts
            trace = c.trace()
            stats = c.stats()
        if stats["requests"] != stats["memo_hits"] + stats["dedupe_joins"] + \
                stats["keys_priced"] + stats["cancelled"] or stats["pending"] != 0 or \
                stats["memo_hits"] < 2 * SERVE_HITS:
            raise AssertionError(f"the daemon's counters do not add up: {stats}")
        # where a full report's hit goes: the daemon decodes its memoized
        # wire and encodes the body again, the client decodes it
        wire = schema.dumps(served)
        body = json.loads(wire)["body"]
        codec = {"json_loads_ms": host_ms(lambda: json.loads(wire)),
                 "json_dumps_ms": host_ms(lambda: json.dumps(body, separators=(",", ":"))),
                 "decode_ms": host_ms(lambda: schema.decode(body))}
        sizes = {"full": len(wire), f"top{SERVE_TOP_K}": len(schema.dumps(pruned))}
        for label, ts in hits.items():
            p50, p99 = percentiles(ts)
            out[f"hit_{label}_ms"] = {"p50": p50, "p99": p99, "min": min(ts) * 1e3}
            say(f"serve V3 memo hits, {label} ({SERVE_HITS} through one client, "
                f"{sizes[label]} bytes): p50 {p50:.3f} ms, p99 {p99:.3f} ms, min "
                f"{min(ts) * 1e3:.3f} ms; {card}")
        out.update(codec_ms=codec, wire_bytes=sizes, trace_events=len(trace["traceEvents"]))
        say(f"serve V3: the full report's wire ({len(wire)} bytes) in this process: json.loads "
            f"{codec['json_loads_ms']:.3f} ms, json.dumps of its body {codec['json_dumps_ms']:.3f} "
            f"ms, schema.decode {codec['decode_ms']:.3f} ms (median of 20); the top-"
            f"{SERVE_TOP_K} request cold {out['topk_cold_s']:.3f} s; counters {stats['requests']} "
            f"requests = {stats['memo_hits']} memo hits + {stats['dedupe_joins']} joins + "
            f"{stats['keys_priced']} priced + {stats['cancelled']} cancelled; the trace op "
            f"shipped {len(trace['traceEvents'])} events")

        # V4. the served winners on the card, held to ref.py and timed
        star_win, lbm_win = served.best(STENCIL).config, served.best(LBM).config
        want_star = star_rank(R, DOMAIN, 8, H100)[0].launch
        want_lbm = lbm_rank(LBM_DOMAIN, 8, H100)[0].launch
        if (star_win, lbm_win) != (want_star, want_lbm):
            raise AssertionError(f"the served winners {star_win}, {lbm_win} are not the "
                                 f"generators' {want_star}, {want_lbm}")
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        src = torch.randn(DOMAIN, dtype=torch.float64, device=dev, generator=gen)
        w = star_weights(R, torch.float64, dev)
        phase = torch.sigmoid(torch.randn(LBM_DOMAIN, dtype=torch.float64, device=dev,
                                          generator=gen))
        pdf = torch.stack([wq * phase for wq in WEIGHTS])
        reset_counts()
        st = star_stencil(src, w, r=R, config={"block": star_win.block,
                                               "folding": star_win.folding})
        new_pdf, new_phase = lbm_step(pdf, phase, config={"block": lbm_win.block,
                                                          "folding": lbm_win.folding})
        torch.cuda.synchronize()
        launches = {"star_pointwise": K.LAUNCHES["star_pointwise"],
                    "lbm_pointwise": LK.LAUNCHES["lbm_pointwise"]}
        if launches != {"star_pointwise": 1, "lbm_pointwise": 1} or \
                LK.LAST_LAUNCH["lbm_pointwise"] != lbm_win:
            raise AssertionError(f"the served winners ran as {launches}, "
                                 f"{LK.LAST_LAUNCH['lbm_pointwise']}")
        padded = pad_input(src, R)
        err_star = check(torch, st, star_stencil_ref(padded, w, R), 8, "served star_stencil")
        del st, src
        pdf_p, phase_p = pad_inputs(pdf, phase)
        ref_pdf, ref_phase = lbm_step_ref(pdf_p, phase_p)
        err_lbm = max(check(torch, new_pdf, ref_pdf, 8, "served lbm_step"),
                      check(torch, new_phase, ref_phase, 8, "served lbm_step phase"))
        del new_pdf, new_phase, ref_pdf, ref_phase, pdf, phase
        ms = {"star_pointwise": cuda_ms(torch, lambda: K.star_pointwise(padded, w, R, star_win)),
              "lbm_pointwise": cuda_ms(torch, lambda: LK.lbm_pointwise(pdf_p, phase_p, lbm_win))}
        del padded, pdf_p, phase_p
        record = {k["name"]: k for k in kernels if k.get("config", "") is None}
        for name, t in ms.items():
            record[name]["serve_ms"] = t
        out.update(launches=launches, serve_ms=ms, max_abs_err={"star_pointwise": err_star,
                                                                "lbm_pointwise": err_lbm})
        say(f"serve V4 main path: star_pointwise at the served {star_win.block}/"
            f"{star_win.folding} and lbm_pointwise at {lbm_win.block}/{lbm_win.folding}, the "
            f"generators' winners, through star_stencil and lbm_step at {DOMAIN} and "
            f"{LBM_DOMAIN} fp64; launches {launches}; max abs error {err_star!r}, {err_lbm!r} "
            f"(tolerance {TOL[8]}); {ms['star_pointwise']:.4f} ms and {ms['lbm_pointwise']:.4f} "
            f"ms (3 warm-ups, median of 20) against the kernels phases' "
            f"{record['star_pointwise']['ms']:.4f} and {record['lbm_pointwise']['ms']:.4f}; {card}")

        # V5. a SIGTERM drain, a --resume restart ridden by a client built
        # while the daemon is down, then the shutdown op
        os.kill(proc.pid, signal.SIGTERM)
        rc = proc.wait(timeout=SERVE_BIND_S)
        if rc != 0 or pid.exists() or os.path.exists(sock):
            raise AssertionError(f"the SIGTERM drain exited {rc}, pid file left "
                                 f"{pid.exists()}, socket left {os.path.exists(sock)}")
        client = PriceClient(sock, retries=SERVE_RETRIES, backoff_s=0.2, timeout=SERVE_CALL_S)
        t0 = time.perf_counter()
        proc = subprocess.Popen(cmd, env=env, stdout=log, stderr=subprocess.STDOUT)
        procs.append(proc)
        again = client.price(full)
        out["restart_answer_s"] = time.perf_counter() - t0
        stats = client.stats()
        client.shutdown_server()
        client.close()
        rc = proc.wait(timeout=SERVE_BIND_S)
        if schema.dumps(again) != schema.dumps(served):
            raise AssertionError("the restarted daemon's answer is not the first one's bytes")
        if stats["memo_restored"] < 1 or stats["keys_priced"] != 0 or stats["memo_hits"] < 1:
            raise AssertionError(f"the restarted daemon did not answer warm: {stats}")
        if rc != 0 or pid.exists():
            raise AssertionError(f"the shutdown op exited {rc}, pid file left {pid.exists()}")
        out.update(memo_restored=stats["memo_restored"])
        say(f"serve V5: SIGTERM drained with exit 0, pid file removed; restarted with --resume, "
            f"a client built while it was down ({SERVE_RETRIES} retries) got the request's "
            f"answer {out['restart_answer_s']:.3f} s after the start, a memo hit "
            f"({stats['memo_restored']} memo entries restored, {stats['keys_priced']} keys "
            f"priced) with the first answer's bytes; the shutdown op exited 0")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait(timeout=60)
        log.close()
        daemon_log = (tmp / "daemon.log").read_text()
        shutil.rmtree(tmp)
    say("serve daemon log: " + " | ".join(daemon_log.splitlines()))

    # the daemon in this process, on a pooled engine started after CUDA
    ctx = pool._context()
    method = ctx and ctx.get_start_method()
    if method in (None, "fork"):
        raise AssertionError(f"a pool in this process would start with {method}")
    perfmodel._WAVE_BOX_MEMO.clear()
    gridwalk._STREAM_MEMO.clear()
    obs.reset()
    obs.enable()
    in_sock = tempfile.mkdtemp(prefix="serve-")
    try:
        with PricingDaemon(os.path.join(in_sock, "s.sock"), engine=Explorer(parallel=True)):
            with PriceClient(os.path.join(in_sock, "s.sock"), timeout=SERVE_CALL_S) as c:
                t0 = time.perf_counter()
                got = c.price(solo[STENCIL])
                out["in_process_s"] = time.perf_counter() - t0
    finally:
        obs.disable()
        shutil.rmtree(in_sock)
    workers = {r.pid for r in obs.spans() if r.name == "pool.chunk"}
    obs.reset()
    if not workers or os.getpid() in workers or got.cache_stats["pool_tasks"] < 1:
        raise AssertionError(f"the in-process daemon's sweep ran no pool worker: {workers}")
    if schema.dumps(got.entries) != schema.dumps(split[0].entries):
        raise AssertionError("the in-process daemon's stencil ranking is not the served one")
    pool.stop_helpers()
    left = live_children()
    if left:
        raise AssertionError(f"processes the smoke started are still there: {left}")
    out["in_process_start_method"] = method
    say(f"serve in process: PricingDaemon on Explorer(parallel=True), pool started by {method} "
        f"({len(workers)} workers) after CUDA, ranked the stencil's 168 launches cold in "
        f"{out['in_process_s']:.3f} s through its socket (the api phase's pooled ranking "
        f"{pooled['stencil']:.3f} s); the forkserver stopped, no child process left")
    say("serve: " + json.dumps(out))
    return launches


FRONTEND_SOURCE = "src/repro_torch/frontend/triton_kernels.py"
# the tracer's Triton fixtures at real sizes: (kind, shape, dtype, the
# traced kernel of the reference each is the counterpart of).  They replace
# no TPU kernel (the CUDA kernels do), so their records' "replaces" is null
# and "counterpart_of" names that kernel.
FRONTEND_FIXTURES = (
    ("jacobi5", (4096, 4096), "float64", "src/repro/kernels/jacobi2d/kernel.py:49"),
    ("star", (4, (256, 256, 256)), "float64", "src/repro/kernels/stencil3d25/kernel.py:69"),
    ("gemm", (4096, 4096, 4096), "bfloat16", "src/repro/kernels/matmul/kernel.py:42"),
    ("transpose", (8192, 4096), "float32", "src/repro/kernels/transpose_pad/kernel.py:29"),
)
FRONTEND_SCALE_SHIFT_COUNTERPART = "examples/price_my_kernel.py:24"
FRONTEND_ROUNDS = 10                     # rounds of a Triton kernel and its library call in turns
H100_NAME = "H100-SXM5-80G"              # core.machines.H100's name in a ranking


def frontend_fixture(torch, F, kind: str, shape, dtype, inputs: list) -> tuple:
    """``(plain version, library call, (bound ms, bound by))`` of a fixture
    on ``inputs``."""
    from repro_torch.frontend import triton_kernels as T

    eb = dtype.itemsize
    if kind == "jacobi5":
        w = jacobi_conv_weight(torch, dtype, inputs[0].device)
        return (lambda: T.jacobi5_ref(*inputs),
                lambda: F.conv2d(inputs[0][None, None], w)[0, 0], jacobi_bound(inputs[0]))
    if kind == "star":
        r = shape[0]
        full = [T.STAR_WEIGHTS[0]] + [T.STAR_WEIGHTS[o] for _axis in range(3)
                                      for o in range(1, r + 1) for _sign in (0, 1)]
        w = star_conv_weight(torch, torch.tensor(full, dtype=dtype, device=inputs[0].device), r)
        return (lambda: T.star_ref(inputs[0], r),
                lambda: F.conv3d(inputs[0][None, None], w)[0, 0], bound(inputs[0], r))
    if kind == "transpose":
        return (lambda: T.transpose_ref(*inputs), lambda: inputs[0].t().contiguous(),
                (2 * inputs[0].numel() * eb / HBM_BYTES_PER_S * 1e3, "bytes"))
    M, K, N = shape
    return (lambda: T.gemm_ref(*inputs), lambda: torch.matmul(*inputs),
            bf16_bound(2.0 * M * N * K, (M * K + K * N + M * N) * eb))


def run_frontend(args, torch, dev) -> list:
    """The spec frontend on the card: F1 ``examples/torch_price_my_kernel.py``
    (the ``@triton.jit`` scale_shift at 4096 x 4096 fp32 traced, priced on
    four machines, launched and held to x * 2 + 1 within one ulp), then
    timed beside the estimator's H100 time for its top launch, its bound and
    ``x * 2.0 + 1.0`` in eager PyTorch; F2 each tracer fixture traced from
    its real ``@triton.jit`` kernel, its GPU spec's wire equal to the
    ``core.specs`` spec the CPU tests pin, launched at a real size and held
    to its plain version, timed beside its H100 prediction, its bound and a
    library call; F3 F1's request through ``python -m repro_torch.serve``,
    its answer equal on the wire to in-process ``price()``.  Triton missing,
    a fixture that does not build or launch, or a spec that differs, fails
    the run.  Returns the Triton kernels' records."""
    import os
    import shutil
    import tempfile

    import torch.nn.functional as F

    try:
        import triton
    except ImportError as e:
        raise AssertionError("frontend: the triton package is missing on this machine") from e
    from repro_torch import api
    from repro_torch.frontend import arg
    from repro_torch.frontend import triton_kernels as T
    from repro_torch.serve import PriceClient, schema

    sys.path.insert(0, str(ROOT / "examples"))
    import torch_price_my_kernel as example

    card = card_line()
    say(f"frontend: triton {triton.__version__}, torch {torch.__version__}; card {card}")
    records = []

    # F1. the example on the card
    T.reset_launch_counts()
    t0 = time.perf_counter()
    f1 = example.main(device=dev, seed=args.seed)
    f1_s = time.perf_counter() - t0
    launches = T.LAUNCHES["scale_shift"]
    if launches != 1:
        raise AssertionError(f"frontend F1: the example launched {launches} Triton kernels, not 1")
    x, launcher = f1["x"], f1["launcher"]
    best = f1["result"].best("scale_shift", H100_NAME)
    predicted = best.estimate.lups / best.perf * 1e3
    bound_ms = 2 * x.numel() * x.element_size() / HBM_BYTES_PER_S * 1e3
    ms = cuda_ms(torch, lambda: launcher(x))
    # the plain version is x * 2.0 + 1.0 in eager PyTorch, the library call too
    eager_ms = cuda_ms(torch, lambda: T.scale_shift_ref(x, 2.0, 1.0))
    queued = interleaved_ms(torch, {"kernel": lambda: launcher(x), "eager": lambda: x * 2.0 + 1.0},
                            FRONTEND_ROUNDS, calls=QUEUED_CALLS)
    say(f"frontend F1: examples/torch_price_my_kernel.py on {dev}: the @triton.jit "
        f"scale_shift_kernel at {tuple(x.shape)} fp32, tiles {T.SCALE_SHIFT_BLOCK} (BY, BX), "
        f"4 warps, traced (grid {f1['traced'].grid}), priced on {', '.join(example.MACHINES)} "
        f"and run in {f1_s:.2f} s (Triton's compile included); launches {launches}; "
        f"{f1['ulps']} ulp (max abs error {f1['max_abs_err']!r}) from x * 2 + 1")
    say(f"frontend F1 times: cuda_ms {ms:.4f} single call, {queued['kernel']:.4f} queued "
        f"({QUEUED_CALLS} back to back); the estimator's H100 time for its top launch "
        f"{best.config.block}x{best.config.folding} {predicted:.4f} ms ({best.limiter}); bound "
        f"2 x {x.numel() * x.element_size() / 2**20:.0f} MiB at 3.35 TB/s {bound_ms:.4f} ms; eager x * 2.0 + 1.0 {eager_ms:.4f} single, "
        f"{queued['eager']:.4f} queued; ratios kernel/predicted {ms / predicted:.3f} "
        f"({queued['kernel'] / predicted:.3f} queued), kernel/bound {ms / bound_ms:.3f} "
        f"({queued['kernel'] / bound_ms:.3f}), kernel/eager {ms / eager_ms:.3f} "
        f"({queued['kernel'] / queued['eager']:.3f}); {card}")
    records.append({"name": "scale_shift_kernel", "route": "triton", "source": FRONTEND_SOURCE,
                    "replaces": None, "counterpart_of": FRONTEND_SCALE_SHIFT_COUNTERPART,
                    "launches": launches, "max_abs_err": f1["max_abs_err"], "ms": ms,
                    "plain_ms": eager_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes", "library_ms": eager_ms,
                    "queued_ms": queued["kernel"], "library_queued_ms": queued["eager"],
                    "predicted_ms": predicted})

    # F2. each fixture, traced from its @triton.jit kernel and run
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    for kind, shape, dtype_name, counterpart in FRONTEND_FIXTURES:
        dtype = getattr(torch, dtype_name)
        t0 = time.perf_counter()
        spec = T.traced_gpu_spec(kind, shape, dtype)
        trace_s = time.perf_counter() - t0
        if schema.encode(spec) != schema.encode(T.hand_spec(kind, shape, dtype.itemsize)):
            raise AssertionError(f"frontend F2 {kind}: the traced GPU spec is not core.specs' "
                                 f"{spec.name}: {spec}")
        call, placeholders, _kw, _costs, _rename = T.traced(kind, shape, dtype)
        scale = shape[1] ** -0.25 if kind == "gemm" else 1.0
        inputs = [torch.randn(a.shape, dtype=dtype, device=dev, generator=gen) * scale
                  for a in placeholders]
        plain, library, (b_ms, b_by) = frontend_fixture(torch, F, kind, shape, dtype, inputs)
        T.reset_launch_counts()
        t0 = time.perf_counter()
        out = call(*inputs)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        launches = T.LAUNCHES[kind]
        if launches != 1:
            raise AssertionError(f"frontend F2 {kind}: {launches} launches, not 1")
        want = plain()
        what = f"frontend F2 {kind}"
        if kind == "transpose":
            err = check_exact(torch, out, want, what)
        elif kind == "gemm":
            err = check_close(torch, out, want, what, **GEMM_TOL[2])
        else:
            err = check(torch, out, want, dtype.itemsize, what)
        k_ms = cuda_ms(torch, lambda: call(*inputs))
        p_ms = cuda_ms(torch, plain)
        # fp64 conv3d takes ~190 ms a call: timed alone, and not in turns
        slow = kind == "star"
        lib_ms = cuda_ms(torch, library, warmup=1, reps=3) if slow else cuda_ms(torch, library)
        fns = {"kernel": lambda: call(*inputs)}
        if not slow:
            fns["library"] = library
        turns = interleaved_ms(torch, fns, FRONTEND_ROUNDS)
        t0 = time.perf_counter()
        top = api.price(api.gpu_request(spec, "H100", top_k=1)).entries[0]
        rank_s = time.perf_counter() - t0
        predicted = top.estimate.lups / top.perf * 1e3
        say(f"frontend F2 {kind}: {spec.name} traced from the @triton.jit kernel in "
            f"{trace_s:.2f} s, its GPU spec's wire equal to core.specs'; {tuple(out.shape)} "
            f"{dtype_name} launched ({launches}, first call {first_s:.2f} s with Triton's "
            f"compile), max abs error {err!r}; {k_ms:.4f} ms (in turns {turns['kernel']:.4f}) "
            f"against the estimator's H100 top launch {top.config.block}x{top.config.folding} "
            f"{predicted:.4f} ms ({top.limiter}; ranked in {rank_s:.2f} s), kernel/predicted "
            f"{k_ms / predicted:.3f}; bound {b_ms:.4f} ms ({b_by}), kernel/bound "
            f"{k_ms / b_ms:.3f}; plain {p_ms:.4f} ms; library {lib_ms:.4f} ms ("
            + (f"in turns {turns['library']:.4f}" if not slow else "3 calls, not in turns")
            + f"); {card}")
        records.append({"name": f"{kind}_kernel", "route": "triton", "source": FRONTEND_SOURCE,
                        "replaces": None, "counterpart_of": counterpart,
                        "launches": launches, "max_abs_err": err,
                        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
                        "library_ms": lib_ms, "in_turns_ms": turns["kernel"],
                        "library_in_turns_ms": turns.get("library"), "predicted_ms": predicted})
        del inputs, out, want
        torch.cuda.empty_cache()

    # F3. F1's request through the daemon
    request = api.kernel_request(launcher, [arg("x", tuple(x.shape), torch.float32)],
                                 list(example.MACHINES), name="scale_shift")
    local = api.price(request)
    tmp = Path(tempfile.mkdtemp(prefix="frontend-"))
    sock = str(tmp / "s.sock")
    cmd = [sys.executable, "-m", "repro_torch.serve", "--socket", sock]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    log = open(tmp / "daemon.log", "w")
    proc = None
    try:
        proc, bind_s = boot_daemon(cmd, env, sock, log)
        with PriceClient(sock, timeout=SERVE_CALL_S) as c:
            t0 = time.perf_counter()
            served = c.price(request)
            served_s = time.perf_counter() - t0
            c.shutdown_server()
        rc = proc.wait(timeout=SERVE_BIND_S)
        if rc != 0:
            raise AssertionError(f"frontend F3: the daemon's shutdown exited {rc}")
        if answer_wire(schema, served) != answer_wire(schema, local):
            raise AssertionError("frontend F3: the served traced request is not in-process "
                                 "price()'s answer on the wire")
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait(timeout=60)
        log.close()
        shutil.rmtree(tmp)
    say(f"frontend F3: the traced scale_shift request (a TracedSpecPayload on the wire) through "
        f"python -m repro_torch.serve (first ping {bind_s:.3f} s after its start) answered in "
        f"{served_s:.3f} s, equal on the wire to in-process price() "
        f"({len(local.entries)} entries on {len(request.machines)} machines); the shutdown op "
        f"exited 0")
    left = live_children()
    if left:
        raise AssertionError(f"processes the smoke started are still there: {left}")
    return records


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: no repro_torch package under {ROOT / 'src'}; "
              "run it from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.reset_peak_memory_stats(dev)

    # 1. the card
    card = card_line()
    say(f"card: {card}")
    say(f"torch device: {torch.cuda.get_device_name(0)}, count "
        f"{torch.cuda.device_count()}, torch {torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build every kernel source, one nvcc each, in parallel
    t0 = time.perf_counter()
    libs = _build.build()
    say(f"build: {sorted(libs)} in {time.perf_counter() - t0:.2f} s; each source's nvcc, "
        f"all started together: "
        + ", ".join(f"{n} {s:.2f} s" for n, s in sorted(_build.BUILD_SECONDS.items())))
    for name, lib in libs.items():
        log = lib.with_name(lib.name + ".log")
        kernel = ""
        for line in log.read_text().splitlines() if log.is_file() else ():
            if "Compiling entry function" in line:
                kernel = ptxas_kernel_name(line)
            elif "registers" in line or "spill" in line:
                REGISTERS[kernel] = (REGISTERS.get(kernel, "") + " " + line.strip()).strip()
                # the stencil's instantiations for other ranges are not on any path
                if name != "stencil3d25" or re.match(r"star_\w+<\w+, 4\b", kernel):
                    say(f"  ptxas[{name}] {kernel}: {line.strip()}")

    kernels = run_stencil(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_lbm(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_jacobi(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_transpose(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_attention(args, torch, dev)
    torch.cuda.empty_cache()
    kernels += run_tpu(args, torch, dev, kernels)
    torch.cuda.empty_cache()
    run_layers(args, torch, dev)
    torch.cuda.empty_cache()
    m1_ms = run_lm(args, torch, dev)
    torch.cuda.empty_cache()
    t1_ms, t1_peak = run_train(args, torch, dev)
    torch.cuda.empty_cache()
    run_shard(args, torch, dev, t1_ms, t1_peak)
    torch.cuda.empty_cache()
    run_dryrun(args, torch, dev, t1_ms, m1_ms)
    run_dryrun_meshes(args, torch, dev)
    torch.cuda.empty_cache()
    api_launches, reads, priced = run_api(args, torch, dev)
    for k in kernels:
        if k["name"] in api_launches and k.get("config", "") is None:
            k["api_launches"] = api_launches[k["name"]]
    torch.cuda.empty_cache()
    sim_launches = run_sim(args, torch, dev, kernels, reads)
    for k in kernels:
        if k["name"] in sim_launches and k.get("config", "") is None:
            k["sim_launches"] = sim_launches[k["name"]]
    torch.cuda.empty_cache()
    suite_launches = run_suite(args, torch, dev, kernels)
    for k in kernels:
        if k["name"] in suite_launches:
            k["suite_launches"] = suite_launches[k["name"]]
    torch.cuda.empty_cache()
    serve_launches = run_serve(args, torch, dev, kernels, priced)
    for k in kernels:
        if k["name"] in serve_launches and k.get("config", "") is None:
            k["serve_launches"] = serve_launches[k["name"]]
    torch.cuda.empty_cache()
    kernels += run_frontend(args, torch, dev)

    # peak memory
    say(f"peak memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.3f} GiB "
        f"(torch.cuda.max_memory_allocated)")

    say(f"smoke: every phase in {time.perf_counter() - t_start:.1f} s")
    # the kernels record
    say(f"card: {card}")
    say(json.dumps({"kernels": [
        {"name": k["name"], "route": k.get("route", "cuda"), "source": k["source"],
         "replaces": k["replaces"],
         "launches": k["launches"], "max_abs_err": k["max_abs_err"], "ms": k["ms"],
         "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"], "bound_by": k["bound_by"],
         "library_ms": k["library_ms"], "pass": True,
         **{key: k[key] for key in ("fwd_route", "decode_route", "splits", "in_turns_ms",
                                    "library_in_turns_ms", "queued_ms", "library_queued_ms",
                                    "offset_bits", "weights", "zmarch_route", "stages",
                                    "threads", "segments", "fp64_in_turns_ms",
                                    "fp64_library_in_turns_ms", "fp32_ms", "fp32_bound_ms",
                                    "fp32_plain_ms", "copy_queued_ms", "fp32_in_turns_ms",
                                    "fp32_queued_ms", "fp32_library_ms",
                                    "fp32_library_in_turns_ms", "fp32_library_queued_ms",
                                    "fp32_copy_queued_ms", "ytile_fp64", "ytile_fp32",
                                    "api_launches", "sim_launches", "sim_ms",
                                    "suite_launches", "serve_launches", "serve_ms",
                                    "predicted_ms", "counterpart_of", "tpu_launches",
                                    "tpu_ms", "tpu_config", "tpu_predicted_ms", "tpu_h100_ms")
            if key in k}}
        for k in kernels]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
