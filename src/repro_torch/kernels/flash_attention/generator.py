"""Flash-attention decisions on the H100: the CUDA kernels' tiles and the
TPU's skipped block sizes.

The reference ranks (bq, bk) VMEM blocks for the TPU with its Pallas
model.  The GPU model has no tensor-core term and prices per-point kernels
only (DESIGN §8/§9): the suite lowers attention to per-head GEMMs for GPU
machines, and nothing in it can rank the tiles of a flash kernel.  So
nothing is ranked here: ``tpu_space`` is the TPU's space, which
``repro_torch.kernels.tpu_skipped`` lists as skipped with that reason, and
the forward kernel runs at the reference's own fallback,
``DEFAULT = {"bq": 128, "bk": 128}``
(``repro/kernels/flash_attention/ops.py:29``), unless a config pins one of
``TILES``.
"""
from __future__ import annotations

from repro_torch.kernels import pow2_tiles
from repro_torch.kernels.flash_attention.kernel import FWD_TILES

TILES = tuple({"bq": bq, "bk": bk} for bq, bk in FWD_TILES)
# the reference's fallback; (64, 64) ran faster at the model's prefill on
# the H100 (PERF.md §6 row 10), a redesign question (ROADMAP.md queue 2)
DEFAULT = {"bq": 128, "bk": 128}


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


def decode_bk(Skv: int) -> int:
    """The decode kernel's KV block, as the reference's entry point picks it."""
    return 512 if Skv % 512 == 0 else 128
