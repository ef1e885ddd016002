"""LRU sector-cache simulator — the measurement stand-in (DESIGN §2.1, §10).

The paper validates its estimates against hardware performance counters
(lts__t_sectors_srcunit_tex_op_read etc.).  Without hardware we validate
against an explicit cache simulation: an LRU cache with 128B line allocation
and 32B sector transfer granularity (Volta/Ampere semantics, paper §4.3/4.4),
driven by the block-scheduling order of the launch configuration.

Two simulators:
  * ``simulate_l1_block``   — per-thread-block L1 (write-through, sectors),
    produces the "measured" L2->L1 volume for one block.
  * ``simulate_l2_waves``   — chip-wide L2 across consecutive waves with
    round-robin interleaving of warp instructions inside a wave (the paper's
    "no order inside a wave"), produces "measured" DRAM load/store volumes
    per lattice update, including warm-cache reuse and capacity misses.

Both run on an array-native core by default (DESIGN §10): warp streams come
from the shared stream table (one base block, integer translation per
block — "folded" waves), and the LRU itself is replayed offline via exact
stack distances instead of an OrderedDict walk.  The original OrderedDict
simulator is retained as the reference oracle — ``oracle=True`` or
``REPRO_CACHESIM_ORACLE=1`` selects it — and the two are pinned
byte-for-byte equal by tests/test_torch_cachesim.py.

A copy of ``repro.core.cachesim``, numpy-only as the reference is: the
simulator runs on the host, not on the card.  Sector ids and every index
array stay int64 (the paper's LBM field spans about 4.2 GB of addresses).
"""
from __future__ import annotations

import os
from collections import OrderedDict

import numpy as np

from repro_torch import obs

from .access import KernelSpec, LaunchConfig
from .gridwalk import (
    CORE_STATS,
    InstrTable,
    batched_instr_events,
    block_points,
    block_points_count,
    stream_table,
)
from .machines import GPUMachine
from .wave import occupancy_blocks_per_sm

_LINE_BYTES = 128
_SECTOR_BYTES = 32
_SPL = _LINE_BYTES // _SECTOR_BYTES


def _oracle_default() -> bool:
    return os.environ.get("REPRO_CACHESIM_ORACLE", "") not in ("", "0")


class SectorCache:
    """LRU, 128B line allocation, 32B sector fills, write-back stores with
    read-to-complete for partially written sectors on eviction.

    ``measuring`` gates the volume counters; dirty sectors written while
    measuring are tagged so their eventual write-back is attributed to the
    measured wave even if evicted later (or at flush).  Dirty sectors whose
    stores all happened while *not* measuring are never attributed to the
    measured volume, no matter when they are evicted (pinned by a
    regression test before the vectorized core inherited the rule).
    """

    def __init__(self, capacity_bytes: int, line_bytes: int = 128, sector_bytes: int = 32):
        self.lines = OrderedDict()  # id -> [present, written, read, measured]
        self.max_lines = max(1, capacity_bytes // line_bytes)
        self.sector_bytes = sector_bytes
        self.spl = line_bytes // sector_bytes
        self.measuring = False
        self.load_bytes = 0            # DRAM->L2 fills while measuring
        self.store_bytes = 0           # L2->DRAM write-backs of measured sectors
        self.completion_read_bytes = 0 # partial-sector completion reads (measured)

    def _evict_one(self):
        _, (present, written, read, measured) = self.lines.popitem(last=False)
        for s in range(self.spl):
            bit = 1 << s
            if written & bit and measured & bit:
                self.store_bytes += self.sector_bytes
                # partially written sector never completed by a read: DRAM
                # must supply the missing bytes (paper §4.4)
                if not (present & bit):
                    self.completion_read_bytes += self.sector_bytes

    def access(self, line_id: int, sector_bit: int, fully_written: bool, is_store: bool):
        entry = self.lines.get(line_id)
        if entry is None:
            if len(self.lines) >= self.max_lines:
                self._evict_one()
            entry = [0, 0, 0, 0]
            self.lines[line_id] = entry
        else:
            self.lines.move_to_end(line_id)
        if is_store:
            entry[1] |= sector_bit
            if self.measuring:
                entry[3] |= sector_bit
            if fully_written:
                entry[0] |= sector_bit
        else:
            if not (entry[0] & sector_bit):
                if self.measuring:
                    self.load_bytes += self.sector_bytes
                entry[0] |= sector_bit
            entry[2] |= sector_bit

    def flush(self):
        while self.lines:
            self._evict_one()


# --------------------------------------------------------------------------
# Warp streams (served from the shared stream table)
# --------------------------------------------------------------------------
def _block_event_arrays(table, block_idx):
    """(sec, full, instr, instr_off, is_store, acc_id) event arrays of one
    block: the base block's instruction table translated by the block's
    byte delta — a pure integer shift of every sorted-unique sector list
    when the delta is sector-aligned, a vectorized rebuild from translated
    byte addresses otherwise (identical by construction either way)."""
    it = table.sector_instr_table(_SECTOR_BYTES)
    delta = table.block_delta_bytes(block_idx)
    if (delta % _SECTOR_BYTES == 0).all():
        sec = it.sec + (delta // _SECTOR_BYTES)[it.acc_id]
        return sec, it.full, it.instr, it.instr_off, it.ev_is_store, it
    bt = InstrTable(table, _SECTOR_BYTES, delta_bytes=delta)
    return bt.sec, bt.full, bt.instr, bt.instr_off, bt.ev_is_store, bt


def _block_warp_streams(spec: KernelSpec, launch: LaunchConfig, domain, block_idx):
    """Per-warp-instruction sector references of one block.

    Returns a list over (access x warp x fold_iter) of tuples
    (line_ids, sector_bits, fully_written flags, is_store), read from the
    shared stream table (one address generation per (spec, launch), every
    block a translation)."""
    table = stream_table(spec, launch, tuple(domain))
    sec, full, _instr, off, is_store, _ = _block_event_arrays(table, block_idx)
    out = []
    for i in range(len(off) - 1):
        lo, hi = off[i], off[i + 1]
        s = sec[lo:hi]
        out.append((s // _SPL, s % _SPL, full[lo:hi], bool(is_store[lo])))
    return out


def _block_warp_streams_ref(spec: KernelSpec, launch: LaunchConfig, domain,
                            block_idx):
    """Reference per-warp stream builder (the pre-stream-table meshgrid
    walk) — kept as the generation oracle the table-served streams are
    pinned against in tests/test_torch_cachesim.py."""
    from .gridwalk import _clipped_thread_major, access_addresses

    pts_tm = _clipped_thread_major(launch, domain)  # (threads, fold, 3)
    ex, ey, ez = launch.block_extent()
    off = np.array(
        [block_idx[2] * ez, block_idx[1] * ey, block_idx[0] * ex], dtype=np.int64
    )
    fold = pts_tm.shape[1]
    out = []
    for acc in spec.accesses:
        eb = acc.field.elem_bytes
        epc = max(1, 32 // eb)  # elements per sector
        for w0 in range(0, launch.threads, 32):
            hw = pts_tm[w0 : w0 + 32]
            for j in range(fold):
                sl = hw[:, j, :]
                mask = sl[:, 0] >= 0
                if not mask.any():
                    continue
                p = sl[mask] + off
                addr = access_addresses(acc, p, len(domain))
                sec = np.unique(addr // 32)
                if acc.is_store:
                    elems = np.unique(addr // eb)
                    sec_of_elem = elems * eb // 32
                    uniq, counts = np.unique(sec_of_elem, return_counts=True)
                    fullmap = dict(zip(uniq.tolist(), (counts >= epc).tolist()))
                    full = [bool(fullmap.get(int(s), False)) for s in sec]
                else:
                    full = [False] * len(sec)
                out.append((sec // 4, sec % 4, full, acc.is_store))
    return out


# --------------------------------------------------------------------------
# Exact offline LRU replay (stack distances + generation accounting)
# --------------------------------------------------------------------------
def _rank_before(vals: np.ndarray) -> np.ndarray:
    """For each position i: #{j < i : vals[j] <= vals[i]} (vals distinct).

    Bottom-up mergesort with counting: runs are contiguous original-index
    ranges, so when two sorted runs merge, each right-run element's count
    of left-run elements before it in the merged order is exactly its
    number of earlier-and-<= partners in that merge; summing over levels
    counts every pair once.  All levels are vectorized row-sorts."""
    n = len(vals)
    if n <= 1:
        return np.zeros(n, dtype=np.int64)
    npad = 1 << (n - 1).bit_length()
    # vals are previous-occurrence indices (< n < 2^31): int32 sorts faster
    big = np.iinfo(np.int32).max
    cur = np.full(npad, big, dtype=np.int32)
    cur[:n] = vals
    idx = np.arange(npad)
    acc = np.zeros(npad, dtype=np.int64)
    width = 1
    while width < npad:
        rows = npad // (2 * width)
        a = np.argsort(cur.reshape(rows, 2 * width), axis=1, kind="stable")
        a_flat = a.ravel()
        flat = a_flat + np.repeat(np.arange(rows) * (2 * width), 2 * width)
        from_right = a_flat >= width
        pos = np.tile(np.arange(2 * width), rows)
        left_before = (pos - (a_flat - width))[from_right]
        cur = cur[flat]
        idx = idx[flat]
        acc[idx[from_right]] += left_before
        width *= 2
    return acc[:n]


def _lru_volumes(line, bit, full, is_store, measuring, capacity_lines, flush):
    """Replay ``SectorCache`` over an event trace without walking it.

    Exact counterpart of the OrderedDict loop (pinned byte-for-byte by the
    property tests), in four offline steps:

    1. line hits/misses from LRU stack distances — event i of line L hits
       iff L was accessed before (at p(i)) and fewer than C distinct other
       lines appear in (p(i), i).  The distinct count is
       ``#{j < i : p(j) <= p(i)} - (p(i) + 1)`` (every window gets exactly
       one first-occurrence event and every j <= p(i) trivially qualifies),
       a rank count handled by ``_rank_before``.
    2. misses partition each line's events into *generations* (insertion to
       eviction).  Eviction accounting is time-independent: the counters
       ``SectorCache._evict_one`` emits depend only on which sectors were
       written/measured/completed during the generation, never on when the
       eviction happens — so generations aggregate, no replay order needed.
    3. without a flush, a line's last generation only counts if the trace
       evicts it: true iff >= C distinct other lines appear after the
       line's final access.
    4. per (generation, sector): a load is counted iff it is the sector's
       first load of the generation, happens while measuring, and no
       fully-written store precedes it; a write-back is counted iff any
       store hit the sector while measuring; a completion read additionally
       requires that nothing set the present bit (no load, no full store).
    """
    n = len(line)
    if n == 0:
        return 0, 0, 0
    cap = capacity_lines
    # consecutive same-line events collapse into *runs* for the line-level
    # replay: tail events of a run are guaranteed hits that leave the LRU
    # order unchanged (the line is already most-recent), so misses,
    # generations, and eviction structure live at run granularity
    run_head = np.empty(n, dtype=bool)
    run_head[0] = True
    run_head[1:] = line[1:] != line[:-1]
    rid = np.cumsum(run_head) - 1          # run id per event
    rline = line[run_head]                 # line per run
    r = len(rline)
    order = np.argsort(rline, kind="stable")
    l_s = rline[order]
    new_line = np.empty(r, dtype=bool)
    new_line[0] = True
    new_line[1:] = l_s[1:] != l_s[:-1]
    prev = np.full(r, -1, dtype=np.int64)
    prev[order[1:]] = np.where(new_line[1:], -1, order[:-1])
    cold = prev < 0
    miss = cold.copy()
    warm = np.flatnonzero(~cold)
    if len(warm):
        cold_before = np.cumsum(cold) - cold
        p = prev[warm]
        a_rank = cold_before[warm] + _rank_before(p)
        dist = a_rank - (p + 1)
        miss[warm] = dist >= cap

    # generations: per line, cumulative misses (sorted-by-line space)
    miss_s = miss[order].astype(np.int64)
    cs = np.cumsum(miss_s)
    line_start = np.flatnonzero(new_line)
    grp = np.cumsum(new_line) - 1
    gen_s = cs - (cs[line_start] - miss_s[line_start])[grp]
    new_seg = new_line.copy()
    new_seg[1:] |= gen_s[1:] != gen_s[:-1]
    seg_s = np.cumsum(new_seg) - 1
    n_seg = int(seg_s[-1]) + 1

    # which segments get evicted (and therefore write back): every segment
    # followed by another of the same line; the line's final segment only
    # under flush, or when enough distinct lines follow its last access
    line_end = np.concatenate([line_start[1:] - 1, [r - 1]])
    last_seg_of_line = seg_s[line_end]
    seg_evicted = np.ones(n_seg, dtype=bool)
    if not flush:
        is_last_occ = np.zeros(r, dtype=bool)
        is_last_occ[order[line_end]] = True
        # distinct lines strictly after run t = last occurrences after t
        after = np.concatenate([
            np.cumsum(is_last_occ[::-1])[::-1][1:], [0]])
        seg_evicted[last_seg_of_line] = after[order[line_end]] >= cap

    # per (segment, sector) aggregation at event granularity
    seg_of_run = np.empty(r, dtype=np.int64)
    seg_of_run[order] = seg_s
    seg_ev = seg_of_run[rid]               # segment per event
    sec_key = seg_ev * np.int64(_SPL) + bit
    ord2 = np.argsort(sec_key, kind="stable")
    key2 = sec_key[ord2]
    starts = np.empty(len(key2), dtype=bool)
    starts[0] = True
    starts[1:] = key2[1:] != key2[:-1]
    starts = np.flatnonzero(starts)
    t2 = ord2                              # trace time per grouped event
    st2 = is_store[ord2]
    fu2 = full[ord2]
    me2 = measuring[ord2]
    big = np.iinfo(np.int64).max
    # first load, encoded as 2t + (not measuring) so the min carries both
    enc_load = np.where(~st2, t2 * 2 + (~me2), big)
    first_load = np.minimum.reduceat(enc_load, starts)
    enc_fs = np.where(st2 & fu2, t2, big)
    first_full_store = np.minimum.reduceat(enc_fs, starts)
    any_measured_store = np.maximum.reduceat(
        (st2 & me2).astype(np.int8), starts) > 0
    any_present = np.maximum.reduceat(
        (~st2 | fu2).astype(np.int8), starts) > 0
    seg_of_group = key2[starts] // _SPL
    grp_evicted = seg_evicted[seg_of_group]

    counted_load = (first_load < big) & (first_load % 2 == 0) & \
        (first_load // 2 < first_full_store)
    load_bytes = int(counted_load.sum()) * _SECTOR_BYTES
    wb = any_measured_store & grp_evicted
    store_bytes = int(wb.sum()) * _SECTOR_BYTES
    completion = int((wb & ~any_present).sum()) * _SECTOR_BYTES
    return load_bytes, store_bytes, completion


# --------------------------------------------------------------------------
# Wave traces (folded by translation symmetry)
# --------------------------------------------------------------------------
def _decode_blocks(lin_ids: np.ndarray, grid):
    gx, gy, _ = grid
    return np.stack(
        [lin_ids % gx, (lin_ids // gx) % gy, lin_ids // (gx * gy)], axis=1)

def _wave_events(table, it, lin_ids, grid, dsec):
    """Event arrays of one wave, round-robin interleaved across blocks
    (instruction-major, block order inside an instruction, ascending
    sectors inside a block's instruction — the oracle's exact order)."""
    blocks = _decode_blocks(np.asarray(lin_ids, dtype=np.int64), grid)
    B = len(blocks)
    E = len(it.sec)
    if E == 0 or B == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(0, bool), np.zeros(0, bool)
    if dsec is not None:
        CORE_STATS["waves_folded"] += 1
        dsec_b = blocks @ dsec.T  # (B, n_acc) sector deltas
        lens = it.instr_len[it.instr]
        b_off = np.zeros(it.n_instr + 1, dtype=np.int64)
        np.cumsum(it.instr_len * B, out=b_off[1:])
        base_pos = b_off[it.instr] + it.rank
        pos = base_pos[None, :] + np.arange(B)[:, None] * lens[None, :]
        sec = np.empty(B * E, dtype=np.int64)
        sec[pos] = it.sec[None, :] + dsec_b[:, it.acc_id]
        fullv = np.empty(B * E, dtype=bool)
        fullv[pos] = np.broadcast_to(it.full, (B, E))
        storev = np.empty(B * E, dtype=bool)
        storev[pos] = np.broadcast_to(it.ev_is_store, (B, E))
        return sec, fullv, storev
    # fallback: rebuild every block's stream from translated byte addresses
    # in one batched pass — blocks become extra warp rows, and a single
    # lexsort produces the interleaved (instruction, block, sector) order
    CORE_STATS["wave_fallbacks"] += 1
    spec, launch = table.spec, table.launch
    n_warps = -(-launch.threads // 32)
    deltas = blocks @ table.step_bytes.T  # (B, n_acc) byte deltas
    sec, full, acc_id, rows, foldi = batched_instr_events(
        table, deltas, _SECTOR_BYTES)
    if not len(sec):
        return sec, np.zeros(0, bool), np.zeros(0, bool)
    bid, warp = rows // n_warps, rows % n_warps
    is_store = np.array([a.is_store for a in spec.accesses], dtype=bool)
    order = np.lexsort((sec, bid, foldi, warp, acc_id))
    return sec[order], full[order], is_store[acc_id][order]


# --------------------------------------------------------------------------
# Simulators (vectorized default, OrderedDict oracle behind a flag)
# --------------------------------------------------------------------------
def simulate_l1_block(
    spec: KernelSpec,
    launch: LaunchConfig,
    machine: GPUMachine,
    domain=None,
    block_idx=(0, 0, 0),
    oracle: bool | None = None,
) -> dict:
    """Measured L2<->L1 volumes for one thread block (write-through L1).

    L1 capacity is shared by the blocks resident on the SM: capacity is
    scaled by 1/blocks_per_sm (inter-block sharing considered unlikely,
    paper §4.3).
    """
    with obs.span("cachesim.replay", "cachesim", level="l1"):
        return _simulate_l1_block(spec, launch, machine, domain, block_idx,
                                  oracle)


def _simulate_l1_block(spec, launch, machine, domain, block_idx, oracle):
    domain = domain or spec.domain
    bps = occupancy_blocks_per_sm(launch, machine.max_threads_per_sm)
    if oracle if oracle is not None else _oracle_default():
        return _simulate_l1_block_oracle(spec, launch, machine, domain,
                                         block_idx, bps)
    table = stream_table(spec, launch, tuple(domain))
    sec, full, _instr, _off, is_store, _ = _block_event_arrays(table, block_idx)
    loads = ~is_store
    sec_l = sec[loads]
    cap = max(1, (machine.l1_bytes // bps) // _LINE_BYTES)
    load_bytes, _, _ = _lru_volumes(
        sec_l // _SPL, sec_l % _SPL, full[loads], np.zeros(len(sec_l), bool),
        np.ones(len(sec_l), bool), cap, flush=False)
    store_bytes = int(is_store.sum()) * _SECTOR_BYTES
    n_pts = block_points_count(launch, domain, block_idx)
    return {
        "l2_to_l1_load_bytes": load_bytes,
        "l1_to_l2_store_bytes": store_bytes,
        "lups": n_pts,
        "l2_to_l1_load_bytes_per_lup": load_bytes / max(n_pts, 1),
    }


def _simulate_l1_block_oracle(spec, launch, machine, domain, block_idx, bps):
    cache = SectorCache(machine.l1_bytes // bps)
    cache.measuring = True
    store_bytes = 0
    for line_ids, sec_in_line, full, is_store in _block_warp_streams(
        spec, launch, domain, block_idx
    ):
        if is_store:
            # write-through: every store op transfers its sectors to L2
            store_bytes += len(line_ids) * 32
            continue
        for li, s in zip(line_ids, sec_in_line):
            cache.access(int(li), 1 << int(s), False, False)
    n_pts = len(block_points(launch, domain, block_idx))
    return {
        "l2_to_l1_load_bytes": cache.load_bytes,
        "l1_to_l2_store_bytes": store_bytes,
        "lups": n_pts,
        "l2_to_l1_load_bytes_per_lup": cache.load_bytes / max(n_pts, 1),
    }


def _l2_schedule(launch, machine, domain, warm_waves, measure_waves,
                 max_warm_blocks):
    """Shared wave schedule of the L2 simulation (oracle and vectorized)."""
    grid = launch.grid_for(domain)
    gx, gy, gz = grid
    total_blocks = gx * gy * gz
    bps = occupancy_blocks_per_sm(launch, machine.max_threads_per_sm)
    wave_blocks = min(machine.n_sms * bps, total_blocks)

    mid_layer = gz // 2
    start = gx * gy * mid_layer + gx * (gy // 3)
    start = min(start, max(total_blocks - wave_blocks * measure_waves, 0))
    start -= start % gx

    warm_blocks = min(max(warm_waves * wave_blocks, gx * gy), max_warm_blocks,
                      start)
    first = start - warm_blocks

    waves = []  # (range, phase) with phase in {"warm", "measured", "cool"}
    lin = first
    while lin < start:
        n = min(wave_blocks, start - lin)
        waves.append((range(lin, lin + n), "warm"))
        lin += n
    for _ in range(measure_waves):
        n = min(wave_blocks, total_blocks - lin)
        if n <= 0:
            break
        waves.append((range(lin, lin + n), "measured"))
        lin += n
    n = min(wave_blocks, total_blocks - lin)
    if n > 0:
        waves.append((range(lin, lin + n), "cool"))
    return grid, wave_blocks, waves


def simulate_l2_waves(
    spec: KernelSpec,
    launch: LaunchConfig,
    machine: GPUMachine,
    domain=None,
    warm_waves: int = 2,
    measure_waves: int = 1,
    max_warm_blocks: int = 4096,
    oracle: bool | None = None,
) -> dict:
    """Measured DRAM<->L2 volumes per LUP around a representative wave.

    Warm-up blocks (up to a full z-plane of history, capped) populate the
    cache; counters run only while the measured wave executes.  Warp
    instructions of a wave's blocks are interleaved round-robin.
    """
    with obs.span("cachesim.replay", "cachesim", level="l2"):
        return _simulate_l2_waves(spec, launch, machine, domain, warm_waves,
                                  measure_waves, max_warm_blocks, oracle)


def _simulate_l2_waves(spec, launch, machine, domain, warm_waves,
                       measure_waves, max_warm_blocks, oracle):
    domain = domain or spec.domain
    grid, wave_blocks, waves = _l2_schedule(
        launch, machine, domain, warm_waves, measure_waves, max_warm_blocks)
    if oracle if oracle is not None else _oracle_default():
        return _simulate_l2_waves_oracle(spec, launch, machine, domain, grid,
                                         wave_blocks, waves)
    table = stream_table(spec, launch, tuple(domain))
    it = table.sector_instr_table(_SECTOR_BYTES)
    dsec = it.sector_deltas(grid)
    secs, fulls, stores, meas = [], [], [], []
    measured_pts = 0
    gx, gy, _ = grid
    for ids, phase in waves:
        s, f, st = _wave_events(table, it, ids, grid, dsec)
        secs.append(s)
        fulls.append(f)
        stores.append(st)
        meas.append(np.full(len(s), phase == "measured", dtype=bool))
        if phase == "measured":
            for lin in ids:
                measured_pts += block_points_count(
                    launch, domain,
                    (lin % gx, (lin // gx) % gy, lin // (gx * gy)))
    sec = np.concatenate(secs) if secs else np.zeros(0, dtype=np.int64)
    full = np.concatenate(fulls) if fulls else np.zeros(0, dtype=bool)
    store = np.concatenate(stores) if stores else np.zeros(0, dtype=bool)
    measuring = np.concatenate(meas) if meas else np.zeros(0, dtype=bool)
    cap = max(1, machine.l2_bytes // _LINE_BYTES)
    load_bytes, store_bytes, completion = _lru_volumes(
        sec // _SPL, sec % _SPL, full, store, measuring, cap, flush=True)
    load_total = load_bytes + completion
    return {
        "dram_load_bytes": load_total,
        "dram_store_bytes": store_bytes,
        "lups": measured_pts,
        "dram_load_bytes_per_lup": load_total / max(measured_pts, 1),
        "dram_store_bytes_per_lup": store_bytes / max(measured_pts, 1),
        "wave_blocks": wave_blocks,
    }


def _simulate_l2_waves_oracle(spec, launch, machine, domain, grid,
                              wave_blocks, waves):
    gx, gy, _ = grid
    cache = SectorCache(machine.l2_bytes)

    def run_wave(block_lin_ids):
        streams = [
            _block_warp_streams(
                spec, launch, domain, (lin % gx, (lin // gx) % gy, lin // (gx * gy))
            )
            for lin in block_lin_ids
        ]
        maxlen = max((len(s) for s in streams), default=0)
        for i in range(maxlen):
            for s in streams:
                if i < len(s):
                    line_ids, sec_in_line, full, is_store = s[i]
                    for li, sec, f in zip(line_ids, sec_in_line, full):
                        cache.access(int(li), 1 << int(sec), bool(f), is_store)

    measured_pts = 0
    for ids, phase in waves:
        cache.measuring = phase == "measured"
        run_wave(ids)
        if phase == "measured":
            for l in ids:
                bidx = (l % gx, (l // gx) % gy, l // (gx * gy))
                measured_pts += len(block_points(launch, domain, bidx))
    # flush to write back remaining measured sectors (the cool-down wave ran
    # unmeasured so measured lines saw realistic eviction pressure first)
    cache.measuring = True
    cache.flush()
    load_total = cache.load_bytes + cache.completion_read_bytes
    return {
        "dram_load_bytes": load_total,
        "dram_store_bytes": cache.store_bytes,
        "lups": measured_pts,
        "dram_load_bytes_per_lup": load_total / max(measured_pts, 1),
        "dram_store_bytes_per_lup": cache.store_bytes / max(measured_pts, 1),
        "wave_blocks": wave_blocks,
    }
