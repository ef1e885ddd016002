"""Wave model and layer-condition thread sets (paper §4.4, figs. 9/10).

Thread blocks are scheduled in X-Y-Z order; only a wave of
``SMs x blocks_per_SM`` blocks is resident at once.  Inside a wave all blocks
run simultaneously with no assumed order; everything before the wave happened
strictly earlier (the paper's simplification of GPU "blurred sequentiality").

Layer-condition thread sets: for each dimension we build the set of threads
one reuse distance in the past — the preceding full row of blocks (y) and the
preceding full plane of blocks (z).  The intersection of their footprints with
the wave's footprint is the potential warm-cache reuse in that dimension; the
set's allocation volume vs. cache capacity decides (via the fitted hit-rate
function) how much of the potential is realized.

A copy of ``repro.core.wave``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

from .access import KernelSpec, LaunchConfig, domain_zyx
from .isets import APRange, Box


def occupancy_blocks_per_sm(
    launch: LaunchConfig,
    max_threads_per_sm: int = 2048,
    max_blocks_per_sm: int = 32,
    regs_blocks_cap: int | None = None,
) -> int:
    cap = min(max_threads_per_sm // launch.threads, max_blocks_per_sm)
    if regs_blocks_cap is not None:
        cap = min(cap, regs_blocks_cap)
    return max(cap, 1)


def linear_block_range_boxes(grid: tuple, start: int, count: int) -> list[Box]:
    """Decompose linear block-index range [start, start+count) of an
    x-fastest (gx, gy, gz) grid into (z, y, x) block-index boxes."""
    gx, gy, gz = grid
    total = gx * gy * gz
    start = max(0, min(start, total))
    end = max(start, min(start + count, total))
    if start == end:
        return []
    boxes: list[Box] = []

    def rc(i):  # linear -> (z, y, x)
        return (i // (gx * gy), (i // gx) % gy, i % gx)

    z0, y0, x0 = rc(start)
    z1, y1, x1 = rc(end - 1)
    if (z0, y0) == (z1, y1):
        return [(APRange.point(z0), APRange.point(y0), APRange.interval(x0, x1))]
    # head partial row
    if x0 != 0:
        boxes.append((APRange.point(z0), APRange.point(y0), APRange.interval(x0, gx - 1)))
        y0 += 1
        if y0 == gy:
            y0, z0 = 0, z0 + 1
    # tail partial row
    tail = None
    if x1 != gx - 1:
        tail = (APRange.point(z1), APRange.point(y1), APRange.interval(0, x1))
        y1 -= 1
        if y1 < 0:
            y1, z1 = gy - 1, z1 - 1
    # now rows [ (z0,y0) .. (z1,y1) ] inclusive are full rows
    if (z1, y1) >= (z0, y0):
        if z0 == z1:
            boxes.append(
                (APRange.point(z0), APRange.interval(y0, y1), APRange.interval(0, gx - 1))
            )
        else:
            if y0 != 0:
                boxes.append(
                    (APRange.point(z0), APRange.interval(y0, gy - 1), APRange.interval(0, gx - 1))
                )
                z0 += 1
            if y1 != gy - 1:
                boxes.append(
                    (APRange.point(z1), APRange.interval(0, y1), APRange.interval(0, gx - 1))
                )
                z1 -= 1
            if z1 >= z0:
                boxes.append(
                    (
                        APRange.interval(z0, z1),
                        APRange.interval(0, gy - 1),
                        APRange.interval(0, gx - 1),
                    )
                )
    if tail is not None:
        boxes.append(tail)
    return boxes


def block_boxes_to_domain_boxes(
    block_boxes: list[Box], launch: LaunchConfig, domain: tuple
) -> list[Box]:
    """Map contiguous block-index boxes to clipped domain-point (z,y,x) boxes."""
    ex, ey, ez = launch.block_extent()
    dz, dy, dx = domain_zyx(domain)
    out = []
    for bz, by, bx in block_boxes:
        # block boxes from linear ranges are contiguous (step 1)
        z0, z1 = bz.start * ez, min((bz.last + 1) * ez, dz) - 1
        y0, y1 = by.start * ey, min((by.last + 1) * ey, dy) - 1
        x0, x1 = bx.start * ex, min((bx.last + 1) * ex, dx) - 1
        if z0 > z1 or y0 > y1 or x0 > x1:
            continue
        b3 = (APRange.interval(z0, z1), APRange.interval(y0, y1), APRange.interval(x0, x1))
        if len(domain) == 3:
            out.append(b3)
        elif len(domain) == 2:
            out.append(b3[1:])
        else:
            out.append(b3[2:])
    return out


@dataclass
class WaveSets:
    """Representative wave + per-dimension layer-condition sets (domain boxes)."""

    wave: list
    y_layer: list
    z_layer: list
    n_blocks: int
    grid: tuple
    start: int


def build_wave_sets(
    spec: KernelSpec,
    launch: LaunchConfig,
    n_sms: int,
    blocks_per_sm: int | None = None,
    max_threads_per_sm: int = 2048,
) -> WaveSets:
    """Construct the representative wave in the middle of the call grid and
    the y/z layer-condition sets (preceding row / preceding plane of blocks)."""
    grid = launch.grid_for(spec.domain)
    gx, gy, gz = grid
    total = gx * gy * gz
    bps = blocks_per_sm or occupancy_blocks_per_sm(launch, max_threads_per_sm)
    wave_blocks = min(n_sms * bps, total)
    # representative start: a row boundary in the middle of the grid
    mid_layer = gz // 2
    start = gx * gy * mid_layer + gx * (gy // 3)
    start = min(start, max(total - wave_blocks, 0))
    start -= start % gx  # align to row start
    wave_bb = linear_block_range_boxes(grid, start, wave_blocks)
    # y layer: the gx blocks immediately preceding the wave (previous row)
    y_bb = linear_block_range_boxes(grid, start - gx, gx) if start >= gx else []
    # z layer: the gx*gy blocks of the preceding plane
    z_bb = (
        linear_block_range_boxes(grid, start - gx * gy, gx * gy)
        if start >= gx * gy
        else []
    )
    dom = spec.domain
    return WaveSets(
        wave=block_boxes_to_domain_boxes(wave_bb, launch, dom),
        y_layer=block_boxes_to_domain_boxes(y_bb, launch, dom),
        z_layer=block_boxes_to_domain_boxes(z_bb, launch, dom),
        n_blocks=wave_blocks,
        grid=grid,
        start=start,
    )
