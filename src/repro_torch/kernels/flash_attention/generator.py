"""Flash-attention decisions on the H100: the CUDA kernels' tiles and the
TPU's skipped block sizes.

The reference ranks (bq, bk) VMEM blocks for the TPU with its Pallas
model.  The GPU model has no tensor-core term and prices per-point kernels
only (DESIGN §8/§9): the suite lowers attention to per-head GEMMs for GPU
machines, and nothing in it can rank the tiles of a flash kernel.  So
nothing is ranked here: ``tpu_space`` is the TPU's space, which
``repro_torch.kernels.tpu_skipped`` lists as skipped with that reason, and
the forward kernel runs at ``DEFAULT = {"bq": 128, "bk": 128}`` unless a
config pins one of ``TILES``.  A config of the TPU's space runs the kernel
at ``DEFAULT`` too (a VMEM block decides nothing on the card), and only
the rows that see no key follow its blocks (``kernel_tile``).

(128, 128) is the reference's own fallback
(``repro/kernels/flash_attention/ops.py:29``) and the faster tile on the
H100: at granite-3-2b's causal prefill (B 4 × 4096, D 64), where
``chip_smoke.py`` times both tiles in turns, the (64, 64) wgmma kernel
is the slower one (``PERF.md`` §6 row 10 gives both times, with the card
and its power limit).

``tpu_candidate_specs`` gives the suite's TPU half the reference's
``(config, PallasKernelSpec)`` candidates over ``tpu_space``.  The
reference traces them from its Pallas kernel; the port's kernel is
hand-written CUDA, which its spec frontend (``repro_torch.frontend``,
Triton kernels only) cannot trace, so it keeps declaring them in the form
the reference's tracer derives (pinned by the reference's
``test_flash_traced_matches_handwritten`` and, under a test-only shim, against the
reference's traced specs in ``tests/test_torch_suite.py``);
``tpu_rank_configs`` ranks them on a ``TPUMachine`` as the reference's
``rank_configs`` does.
"""
from __future__ import annotations

from functools import lru_cache

from repro_torch.core.machines import TPU_V5E, TPUMachine
from repro_torch.core.tpu_adapt import (
    MatmulShape,
    OperandSpec,
    PallasKernelSpec,
    RankedPallasConfig,
    pow2_tiles,
    select_pallas_config,
)
from repro_torch.kernels.flash_attention.kernel import FWD_TILES

TILES = tuple({"bq": bq, "bk": bk} for bq, bk in FWD_TILES)
DEFAULT = {"bq": 128, "bk": 128}  # the wgmma kernel's tile for bf16, every head dim


def tpu_space(Sq: int, Skv: int):
    """The reference's (bq, bk) decisions: powers of two from 128 that divide
    Sq (up to 1024) and Skv (up to 2048) (a copy of
    ``repro.kernels.flash_attention.generator._space``)."""
    for bq in pow2_tiles(128, min(Sq, 1024)):
        if Sq % bq:
            continue
        for bk in pow2_tiles(128, min(Skv, 2048)):
            if Skv % bk:
                continue
            yield {"bq": bq, "bk": bk}


@lru_cache(maxsize=None)
def _tpu_candidates(B, Hq, Hkv, Sq, Skv, D, causal, elem_bytes) -> tuple:
    # the triangular causal work factor is a hand-pinned cost annotation in
    # the reference too: a property of the masked values, not of addresses
    tri = 0.5 if causal and Sq == Skv else 1.0
    out = []
    for cfg in tpu_space(Sq, Skv):
        bq, bk = cfg["bq"], cfg["bk"]
        out.append((cfg, PallasKernelSpec(
            name=f"fa_{bq}x{bk}", grid=(B * Hq, Sq // bq, Skv // bk),
            operands=(
                OperandSpec("q", (1, 1, bq, D), elem_bytes, grid_deps=(0, 1)),
                OperandSpec("k", (1, 1, bk, D), elem_bytes, grid_deps=(0, 2)),
                OperandSpec("v", (1, 1, bk, D), elem_bytes, grid_deps=(0, 2)),
                OperandSpec("o", (1, 1, bq, D), elem_bytes, grid_deps=(0, 1), is_output=True),
            ),
            matmuls_per_step=(MatmulShape(bq, D, bk), MatmulShape(bq, bk, D)),
            vpu_elems_per_step=6.0 * bq * bk * tri,  # exp, mask, rescale
            vpu_shape=(bq, bk),
            # the fp32 accumulator and the two (bq, 128) running-stat blocks
            scratch_bytes=(bq * D + 2 * bq * 128) * 4,
            work_per_step=float(bq * bk) * tri, elem_bytes=elem_bytes)))
    return tuple(out)


def tpu_candidate_specs(B, Hq, Hkv, Sq, Skv, D, causal=True, elem_bytes=2):
    """``(config, PallasKernelSpec)`` of the reference's Pallas flash
    forward at every config of ``tpu_space(Sq, Skv)``, in its order: grid
    (B·Hq, Sq/bq, Skv/bk), K and V revisited per (head, kv block), the
    causal triangle's factor 0.5 when Sq == Skv.  Declared, since the port
    cannot trace a Pallas kernel; memoised per shape, so repeated layers
    share the candidate objects."""
    yield from _tpu_candidates(B, Hq, Hkv, Sq, Skv, D, bool(causal), elem_bytes)


def tpu_rank_configs(B, Hq, Hkv, Sq, Skv, D, causal=True, machine: TPUMachine = TPU_V5E,
                     elem_bytes=2) -> list[RankedPallasConfig]:
    """The TPU candidates ranked on ``machine``, best first, as the
    reference's ``rank_configs`` ranks them (``select_pallas_config``)."""
    return select_pallas_config(
        tpu_candidate_specs(B, Hq, Hkv, Sq, Skv, D, causal, elem_bytes), machine)


def decode_bk(Skv: int) -> int:
    """The decode kernel's KV block, as the reference's entry point picks it."""
    return 512 if Skv % 512 == 0 else 128


def kernel_tile(config: dict, Sq: int, Skv: int) -> tuple:
    """((bq, bk) the forward kernel runs, (bq, bk) of the blocks the rows
    that see no key follow) for ``config``: one of ``TILES`` runs as it is;
    one of the reference's space at (Sq, Skv) (``tpu_space``) runs at
    ``DEFAULT``, its rows that see no key averaging its own blocks, as the
    reference's kernel at that config does.  ValueError for any other."""
    asked = {"bq": int(config["bq"]), "bk": int(config["bk"])}
    tile = (asked["bq"], asked["bk"])
    if asked in TILES:
        return tile, tile
    if asked in tpu_space(Sq, Skv):
        return (DEFAULT["bq"], DEFAULT["bk"]), tile
    raise ValueError(f"config {asked} is not instantiated: neither one of the kernel's tiles "
                     f"{TILES} nor in the reference's space at Sq={Sq}, Skv={Skv}")
