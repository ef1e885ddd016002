"""Matmul decisions on the H100: the CUDA GEMM's tiles, the TPU's skipped
block sizes, and the suite's CUDA-core price.

The reference ranks (bm, bk, bn) VMEM blocks for the TPU with its Pallas
model.  The GPU model has no tensor-core term: the suite prices a model's
GEMMs with ``core.specs.matmul_naive``, a per-point CUDA-core kernel, at
the eight ``SUITE_GPU_BLOCKS`` (DESIGN §8), and it cannot rank the tiles of
a tensor-core kernel.  So nothing is ranked here: ``tpu_space`` is the
TPU's space, which ``repro_torch.kernels.tpu_skipped`` lists as skipped
with that reason, and the CUDA GEMM runs at a pinned default tile per dtype
(``DEFAULT``), one of the tiles it instantiates (``TILES``).  A config of
the TPU's space runs at ``DEFAULT`` too (``kernel_tile``): a VMEM block
decides nothing on the card.
``suite_price`` gives the copied estimator's price of ``matmul_naive`` at
the suite's blocks, which is a CUDA-core model's price, not a prediction of
the tiled kernel.

``tpu_candidate_specs`` gives the suite's TPU half the reference's
``(config, PallasKernelSpec)`` candidates over ``tpu_space``.  The
reference traces them from its Pallas kernel; the port's kernel is
hand-written CUDA, which its spec frontend (``repro_torch.frontend``,
Triton kernels only) cannot trace, so it keeps declaring them in the form
the reference's tracer derives (pinned by the reference's
``test_matmul_traced_matches_handwritten`` and, under a test-only shim, against the
reference's traced specs in ``tests/test_torch_suite.py``);
``tpu_rank_configs`` ranks them on a ``TPUMachine`` as the reference's
``rank_configs`` does.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.core.access import LaunchConfig
from repro_torch.core.machines import H100, TPU_V5E, GPUMachine, TPUMachine
from repro_torch.core.selector import RankingResult, rank_gpu_configs
from repro_torch.core.specs import matmul_naive
from repro_torch.core.tpu_adapt import (
    MatmulShape,
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    pow2_tiles,
    select_pallas_config,
)
from repro_torch.kernels.matmul.tiles import TILES as _KERNEL_TILES
from repro_torch.kernels.matmul.tiles import vector_width

# GPU launch configurations the suite prices per matmul workload: a small
# representative set of (x=n, y=m, z=k) thread-block shapes (1024-thread
# tiles of the paper's eq.-6 grid plus two small blocks for skinny GEMMs);
# a copy of ``repro.suite.lowering.SUITE_GPU_BLOCKS``
SUITE_GPU_BLOCKS = [
    (32, 8, 4), (16, 16, 4), (64, 16, 1), (128, 8, 1), (32, 32, 1),
    (16, 8, 8), (32, 4, 1), (16, 8, 2),
]

# the CUDA GEMM's tiles per element size, and the pinned default (the
# first).  bf16: 128x256x64 was picked by timing the granite-3-2b layer's
# five GEMMs at 16384 tokens on an H100 at 700 W (chip_smoke.py's
# run_matmuls prints them): 2.81 ms against 3.09 ms at 128x128x64, whose
# narrower wgmma reads A from shared memory twice as often per flop.  fp32:
# 128x128x32, the split-TF32 kernel's tile whose registers hold a second
# accumulator for the slab sums
TILES = {eb: tuple({"bm": bm, "bn": bn, "bk": bk} for bm, bn, bk in tiles)
         for eb, tiles in _KERNEL_TILES.items()}
DEFAULT = {eb: tiles[0] for eb, tiles in TILES.items()}


def suite_gpu_configs() -> list[LaunchConfig]:
    return [LaunchConfig(block=b) for b in SUITE_GPU_BLOCKS]


def tpu_space(M: int, K: int, N: int):
    """The reference's (bm, bk, bn) decisions: powers of two from 128 that
    divide the dims, bm and bn up to 1024, bk up to 2048 (a copy of
    ``repro.kernels.matmul.generator._space``)."""
    for bm in pow2_tiles(128, min(M, 1024)):
        if M % bm:
            continue
        for bn in pow2_tiles(128, min(N, 1024)):
            if N % bn:
                continue
            for bk in pow2_tiles(128, min(K, 2048)):
                if K % bk:
                    continue
                yield {"bm": bm, "bk": bk, "bn": bn}


@lru_cache(maxsize=None)
def _tpu_candidates(M: int, K: int, N: int, elem_bytes: int) -> tuple:
    out = []
    for cfg in tpu_space(M, K, N):
        bm, bk, bn = cfg["bm"], cfg["bk"], cfg["bn"]
        out.append((cfg, PallasKernelSpec(
            name=f"mm_{bm}x{bk}x{bn}", grid=(M // bm, N // bn, K // bk),
            operands=(
                OperandSpec("a", (bm, bk), elem_bytes, grid_deps=(0, 2)),
                OperandSpec("b", (bk, bn), elem_bytes, grid_deps=(1, 2)),
                OperandSpec("o", (bm, bn), elem_bytes, grid_deps=(0, 1), is_output=True),
            ),
            # one MXU matmul a grid step, accumulated in an fp32 scratch block
            matmuls_per_step=(MatmulShape(bm, bk, bn),),
            scratch_bytes=bm * bn * 4,
            work_per_step=2.0 * bm * bk * bn, elem_bytes=elem_bytes)))
    return tuple(out)


def tpu_candidate_specs(M: int, K: int, N: int, elem_bytes: int = 2):
    """``(config, PallasKernelSpec)`` of the reference's Pallas matmul at
    every config of ``tpu_space(M, K, N)``, in its order: grid (M/bm, N/bn,
    K/bk), A revisited per (i, k), B per (j, k), an fp32 accumulator.
    Declared, since the port cannot trace a Pallas kernel; memoised per
    shape, so repeated layers share the candidate objects."""
    yield from _tpu_candidates(M, K, N, elem_bytes)


def tpu_rank_configs(M: int, K: int, N: int, machine: TPUMachine = TPU_V5E,
                     elem_bytes: int = 2) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``)."""
    return select_pallas_config(tpu_candidate_specs(M, K, N, elem_bytes), machine)


def default_config(M: int, K: int, N: int, elem_bytes: int = 2) -> dict | None:
    """The pinned tile for this dtype, or None when no tile fits the shape
    (a dtype without a kernel, or K or N not a multiple of the kernel's
    16-byte loads); ``ops.tuned_matmul`` then runs the plain version."""
    if elem_bytes not in DEFAULT or min(M, K, N) < 1:
        return None
    vec = vector_width(elem_bytes)
    if K % vec or N % vec:
        return None
    return dict(DEFAULT[elem_bytes])


def kernel_tile(config: dict, M: int, K: int, N: int, elem_bytes: int) -> dict:
    """The tile the CUDA GEMM runs for ``config``: one of ``TILES`` for the
    element size as it is, one of the reference's space at (M, K, N)
    (``tpu_space``) at ``DEFAULT``; ValueError for any other."""
    asked = {"bm": int(config["bm"]), "bk": int(config["bk"]), "bn": int(config["bn"])}
    if asked in TILES.get(elem_bytes, ()):
        return asked
    if elem_bytes in DEFAULT and asked in tpu_space(M, K, N):
        return dict(DEFAULT[elem_bytes])
    raise ValueError(f"config {asked} is not instantiated: neither one of the kernel's tiles "
                     f"{TILES.get(elem_bytes, ())} nor in the reference's space at "
                     f"(M, K, N) = {(M, K, N)}")


def suite_price(M: int, K: int, N: int, elem_bytes: int = 2,
                machine: GPUMachine = H100) -> RankingResult:
    """The suite's GPU price of the (M, K, N) GEMM: ``matmul_naive`` priced
    by the copied estimator at every ``SUITE_GPU_BLOCKS`` launch, best
    first (``perf`` in MAC/s)."""
    return rank_gpu_configs(matmul_naive(M, K, N, elem_bytes), machine,
                            configs=suite_gpu_configs())
