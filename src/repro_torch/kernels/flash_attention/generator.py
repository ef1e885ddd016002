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
"""
from __future__ import annotations

from repro_torch.kernels import pow2_tiles
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
