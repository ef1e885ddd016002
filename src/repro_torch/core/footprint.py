"""Unique memory footprints of thread groups via implicit sets (paper §4.3/4.4).

The footprint of a group of threads is the union over all accesses of the
image of the group's domain-point set under the access's line-granular address
expressions.  Addresses live in the multi-dimensional address space of
§4.4.1: tuples keyed by field, floor-div by line size only in the innermost
dim.  Counting is exact (isets.count_union) and independent of thread count.

A copy of ``repro.core.footprint``.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Sequence

from .access import Access, KernelSpec
from .isets import Box, count_intersection_of_unions, count_union


def footprint_boxes(
    accesses: Sequence[Access], domain_boxes: Sequence[Box], line_bytes: int
) -> dict:
    """field name -> list of line-granular address boxes."""
    per_field: dict = defaultdict(list)
    for acc in accesses:
        per_field[acc.field.name].extend(acc.line_boxes(domain_boxes, line_bytes))
    return dict(per_field)


def union_bytes_by_field(per_field_boxes: dict, line_bytes: int) -> int:
    """Exact union volume (bytes) of a ``footprint_boxes`` result.

    Shared by the wave model's front/overlap split and the single-access
    volume floors: addresses of different fields never alias, so the total
    is the per-field union count summed (all integer math)."""
    return sum(count_union(b) for b in per_field_boxes.values()) * line_bytes


def footprint_lines(
    accesses: Sequence[Access], domain_boxes: Sequence[Box], line_bytes: int
) -> int:
    """Number of unique cache lines referenced by the group."""
    total = 0
    for boxes in footprint_boxes(accesses, domain_boxes, line_bytes).values():
        total += count_union(boxes)
    return total


def footprint_bytes(
    accesses: Sequence[Access], domain_boxes: Sequence[Box], line_bytes: int
) -> int:
    return footprint_lines(accesses, domain_boxes, line_bytes) * line_bytes


def overlap_bytes(
    accesses: Sequence[Access],
    boxes_a: Sequence[Box],
    boxes_b: Sequence[Box],
    line_bytes: int,
) -> int:
    """|footprint(A) ∩ footprint(B)| in bytes (warm-cache reuse, §4.4.2)."""
    fa = footprint_boxes(accesses, boxes_a, line_bytes)
    fb = footprint_boxes(accesses, boxes_b, line_bytes)
    total = 0
    for name, ba in fa.items():
        if name in fb:
            total += count_intersection_of_unions(ba, fb[name])
    return total * line_bytes


def kernel_block_volumes(
    spec: KernelSpec, domain_boxes: Sequence[Box], sector_bytes=32, line_bytes=128
) -> dict:
    """Per-group volumes used by the L1/L2 models.

    Returns dict with:
      load_sectors  — unique 32B sectors of all loads (compulsory L2->L1 loads)
      store_sectors — unique 32B sectors of stores (write-through volume)
      alloc_lines   — unique 128B lines of all accesses (L1 allocation volume)
    all in bytes.
    """
    return {
        "load_sectors": footprint_bytes(spec.loads, domain_boxes, sector_bytes),
        "store_sectors": footprint_bytes(spec.stores, domain_boxes, sector_bytes),
        "alloc_lines": footprint_bytes(spec.accesses, domain_boxes, line_bytes),
    }
