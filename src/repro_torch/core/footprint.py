"""Unique memory footprints of thread groups via implicit sets (paper §4.3/4.4).

The footprint of a group of threads is the union over all accesses of the
image of the group's domain-point set under the access's line-granular address
expressions.  Addresses live in the multi-dimensional address space of
§4.4.1: tuples keyed by field, floor-div by line size only in the innermost
dim.  Counting is exact (isets.count_union) and independent of thread count.

A copy of ``repro.core.footprint`` trimmed to what ``estimate_gpu`` reaches.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Sequence

from .access import Access, KernelSpec
from .isets import Box, count_union


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
