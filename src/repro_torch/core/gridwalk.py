"""Explicit grid iteration + visitors (paper listing 5, figs. 4/5/8).

This is the enumeration path: it walks every thread of a thread group, puts
the thread coordinates into all address expressions, and hands the resulting
address sets to visitors.  It is exact and serves as the oracle against which
the implicit-set estimator (isets/footprint) is property-tested, and as the
primary path for L1-level metrics where groups are small (warps/blocks).

Vectorized with numpy meshgrid as in the paper (§4.2).

The stream table (DESIGN §10) is the shared address backbone of the
cache-metric core: each access's byte-address stream is generated **once
per (spec, launch, domain)** for the base thread block, and every consumer
— the vectorized L1 walks, per-warp sector requests, block footprints, and
the cache simulator's per-block warp streams (``core.cachesim``) — reads
it, translating to other blocks by the affine per-axis byte deltas instead
of re-meshgridding.  ``CORE_STATS`` counts streams built vs shared and (for
the simulator) waves served by pure translation vs rebuilt.

A copy of ``repro.core.gridwalk``.  The port's per-point CUDA kernels
(``repro_torch/csrc``) map threads to points exactly as ``block_points``
documents, so the priced launch is the executed one.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch import obs
from repro_torch.obs.metrics import CounterGroup

from .access import Access, KernelSpec, LaunchConfig, domain_zyx

# ---------------------------------------------------------------------------
# Core instrumentation (process-local; the Explorer reports per-sweep deltas).
# A registry-backed counter group (repro_torch.obs.metrics): every counter
# is named and documented as ``core.<field>`` in the process-wide metrics
# registry; the two wave counters count the cache simulator's waves.
# ---------------------------------------------------------------------------
CORE_STATS = CounterGroup("core", {
    "streams_built": "stream-table entries constructed",
    "streams_shared": "stream-table memo hits (a consumer reused a table)",
    "waves_folded": "simulator waves generated by pure translation",
    "wave_fallbacks": "simulator waves rebuilt per block (no sector fold)",
})


def core_stats_snapshot() -> dict:
    return dict(CORE_STATS)


def reset_core_stats() -> None:
    for k in CORE_STATS:
        CORE_STATS[k] = 0


def block_points(launch: LaunchConfig, domain: tuple, block_idx=(0, 0, 0)):
    """(N,3) int array of (z,y,x) domain points of one thread block, ordered
    by (warp-major) thread id, folding unrolled innermost.

    Thread t = (tx,ty,tz) with folding (fx,fy,fz) computes points
    (bz*ez + tz*fz + jz, by*ey + ty*fy + jy, bx*ex + tx*fx + jx).
    Points outside the domain are dropped (guard clause intersection).
    """
    bx, by, bz = launch.block
    fx, fy, fz = launch.folding
    ex, ey, ez = launch.block_extent()
    ox, oy, oz = block_idx[0] * ex, block_idx[1] * ey, block_idx[2] * ez
    tz, ty, tx = np.meshgrid(
        np.arange(bz), np.arange(by), np.arange(bx), indexing="ij"
    )
    # thread linear id: x fastest (CUDA convention)
    tid = (tz * by + ty) * bx + tx
    order = np.argsort(tid.ravel(), kind="stable")
    tx, ty, tz = tx.ravel()[order], ty.ravel()[order], tz.ravel()[order]
    pts = []
    for jz in range(fz):
        for jy in range(fy):
            for jx in range(fx):
                px = ox + tx * fx + jx
                py = oy + ty * fy + jy
                pz = oz + tz * fz + jz
                pts.append(np.stack([pz, py, px], axis=1))
    # interleave folding iterations per thread: thread-major ordering
    arr = np.stack(pts, axis=1).reshape(-1, 3)  # (threads*fold, 3) thread-major
    dz, dy, dx = domain_zyx(domain)
    m = (arr[:, 0] < dz) & (arr[:, 1] < dy) & (arr[:, 2] < dx)
    return arr[m]


def block_points_count(launch: LaunchConfig, domain, block_idx=(0, 0, 0)) -> int:
    """len(block_points(...)) in closed form: a block covers the contiguous
    extent [o, o+e) per axis exactly once, so clipping is a per-axis min."""
    dzyx = domain_zyx(domain)
    ext = launch.block_extent()  # (x, y, z)
    n = 1
    for d in range(3):
        o = block_idx[2 - d] * ext[2 - d]
        n *= max(0, min(o + ext[2 - d], dzyx[d]) - o)
    return n


def access_addresses(acc: Access, pts: np.ndarray, domain_ndim: int = 3) -> np.ndarray:
    """Linear *byte* addresses (incl. alignment) for domain points (N,3).

    Points are always (z,y,x) columns; ``dim_map`` indexes the kernel's domain
    dims (slowest..fastest), i.e. column ``3 - domain_ndim + d``.
    """
    nd = acc.field.ndim
    coords = []
    for j in range(nd):
        d = acc.dim_map[j]
        col = 3 - domain_ndim + d
        coords.append(acc.coeffs[j] * pts[:, col] + acc.offsets[j])
    addr = np.zeros(len(pts), dtype=np.int64)
    for dim, c in enumerate(coords):
        addr = addr * acc.field.shape[dim] + c
    return (addr + acc.field.alignment) * acc.field.elem_bytes


# --------------------------------------------------------------------------
# Visitors (paper figs. 5 and 8)
# --------------------------------------------------------------------------
class CLVisitor:
    """Counts unique cache lines of a given granularity (fig. 8)."""

    def __init__(self, line_bytes: int):
        self.line_bytes = line_bytes
        self.lines: set = set()

    def count(self, field_name: str, byte_addresses: np.ndarray):
        self.lines.update(
            (field_name, int(l)) for l in np.unique(byte_addresses // self.line_bytes)
        )

    @property
    def n_lines(self) -> int:
        return len(self.lines)

    def volume(self) -> int:
        return self.n_lines * self.line_bytes


class BankConflictVisitor:
    """L1 wavefront/cycle model (paper §4.2, figs. 4/5).

    128B lines over 16 banks x 8B.  A half warp (16 threads) issues one
    load; cycles = max addresses per bank among *unique* 8B words, with the
    additional rule that addresses farther than ``window`` (1024B) apart
    cannot share a wavefront.
    """

    N_BANKS = 16
    BANK_BYTES = 8
    WINDOW = 1024

    def __init__(self):
        self.cycles = 0

    def count(self, field_name: str, byte_addresses: np.ndarray):
        words = np.unique(byte_addresses // self.BANK_BYTES)
        if len(words) == 0:
            return
        windows = np.unique(words * self.BANK_BYTES // self.WINDOW)
        banks = words % self.N_BANKS
        _, bank_counts = np.unique(banks, return_counts=True)
        self.cycles += max(int(bank_counts.max()), len(windows))


def walk_block_l1(
    spec: KernelSpec, launch: LaunchConfig, domain=None, half_warp: int = 16
):
    """Average L1 cycles per work unit for one thread block (paper §4.2).

    Iterates all half warps of a representative block; for each access, one
    load instruction per folding iteration.
    """
    domain = domain or spec.domain
    pts_tm = _thread_major_points(launch, domain)
    fold = pts_tm.shape[1]
    n_threads = launch.threads
    vis = BankConflictVisitor()
    for acc in spec.accesses:
        for w0 in range(0, n_threads, half_warp):
            hw = pts_tm[w0 : w0 + half_warp]  # (<=16, fold, 3)
            for j in range(fold):
                sl = hw[:, j, :]
                sl = sl[sl[:, 0] >= 0]
                if len(sl) == 0:
                    continue
                vis.count(acc.field.name, access_addresses(acc, sl, len(domain)))
    lups = int((pts_tm[:, :, 0] >= 0).sum())
    return vis.cycles / max(lups, 1)


def _clipped_thread_major(launch: LaunchConfig, domain):
    bx, by, bz = launch.block
    fx, fy, fz = launch.folding
    tz, ty, tx = np.meshgrid(np.arange(bz), np.arange(by), np.arange(bx), indexing="ij")
    tid = (tz * by + ty) * bx + tx
    order = np.argsort(tid.ravel(), kind="stable")
    tx, ty, tz = tx.ravel()[order], ty.ravel()[order], tz.ravel()[order]
    dz, dy, dx = domain_zyx(domain)
    out = np.full((launch.threads, fx * fy * fz, 3), -1, dtype=np.int64)
    j = 0
    for jz in range(fz):
        for jy in range(fy):
            for jx in range(fx):
                px, py, pz = tx * fx + jx, ty * fy + jy, tz * fz + jz
                ok = (px < dx) & (py < dy) & (pz < dz)
                col = np.stack([pz, py, px], axis=1)
                col[~ok] = -1
                out[:, j, :] = col
                j += 1
    return out


# --------------------------------------------------------------------------
# Stream table: memoized base-block address streams + translation deltas
# --------------------------------------------------------------------------
# Pads invalid threads in the row-wise sorts below.  Large positive so padded
# entries sort *after* every real key (a valid entry never has a padded
# predecessor, keeping the first-occurrence masks exact); real keys are
# bounded by field sizes and can never reach it.
_SENTINEL = np.int64(1) << 62


def _thread_major_points(launch: LaunchConfig, domain) -> np.ndarray:
    """(threads, fold, 3) thread-major points with -1-marked invalid rows."""
    pts = block_points(launch, domain)
    fold = int(np.prod(launch.folding))
    if len(pts) == launch.threads * fold:
        return pts.reshape(-1, fold, 3)
    return _clipped_thread_major(launch, domain)


class StreamTable:
    """Base-block address streams of one (spec, launch, domain) triple.

    All thread blocks of a launch compute pure translations of the base
    block's points (the guard-clause clip is evaluated against the base
    block, matching the per-warp stream oracle), so each access's byte
    addresses are generated once here and translated everywhere else:
    ``addr(block b) = addr(base) + bx*dx + by*dy + bz*dz`` with the per-axis
    byte deltas below (exact — the address expressions are affine).
    """

    def __init__(self, spec: KernelSpec, launch: LaunchConfig, domain: tuple):
        self.spec = spec
        self.launch = launch
        self.domain = domain
        self.pts_tm = _thread_major_points(launch, domain)  # (threads, fold, 3)
        self.valid = self.pts_tm[:, :, 0] >= 0
        self.lups = int(self.valid.sum())
        nd = len(domain)
        flat = self.pts_tm.reshape(-1, 3)
        vmask = self.valid.reshape(-1)
        self.addrs = []  # per access: (threads, fold) int64, _SENTINEL invalid
        for acc in spec.accesses:
            a = np.full(len(flat), _SENTINEL, dtype=np.int64)
            if vmask.any():
                a[vmask] = access_addresses(acc, flat[vmask], nd)
            self.addrs.append(a.reshape(self.pts_tm.shape[:2]))
        # per-access byte delta of one block step along grid x/y/z (affine in
        # the block offset, so evaluated at any reference point)
        ex, ey, ez = launch.block_extent()
        ref = np.zeros((1, 3), dtype=np.int64)
        steps = np.array([[0, 0, ex], [0, ey, 0], [ez, 0, 0]], dtype=np.int64)
        self.step_bytes = np.empty((len(spec.accesses), 3), dtype=np.int64)
        for i, acc in enumerate(spec.accesses):
            base = access_addresses(acc, ref, nd)[0]
            for k in range(3):
                self.step_bytes[i, k] = (
                    access_addresses(acc, ref + steps[k : k + 1], nd)[0] - base
                )
        self._instr_table = None

    def block_delta_bytes(self, block_idx) -> np.ndarray:
        """Per-access byte translation of block ``(bx, by, bz)``."""
        off = np.asarray(block_idx, dtype=np.int64)
        return self.step_bytes @ off

    def sector_instr_table(self, sector_bytes: int = 32):
        """Per-warp-instruction sector stream of the base block (lazy)."""
        if self._instr_table is None or self._instr_table.sector_bytes != sector_bytes:
            self._instr_table = InstrTable(self, sector_bytes)
        return self._instr_table


class InstrTable:
    """Sorted-unique sector events per (access, warp, folding) instruction.

    Mirrors the per-warp stream oracle exactly: one instruction per
    (access, warp, fold iteration) with at least one valid thread, events =
    that warp's unique sectors in ascending order, stores carrying the
    fully-written flag of each sector.  Arrays are flat over events with an
    instruction index, so a whole wave's interleaved trace is index
    arithmetic away (see cachesim).
    """

    def __init__(self, table: StreamTable, sector_bytes: int,
                 delta_bytes=None):
        self.sector_bytes = sector_bytes
        self.table = table
        spec, launch = table.spec, table.launch
        n_warps = -(-launch.threads // 32)
        deltas = (np.zeros((1, len(spec.accesses)), dtype=np.int64)
                  if delta_bytes is None
                  else np.asarray(delta_bytes, dtype=np.int64)[None, :])
        sec, full, acc_id, warp, foldi = batched_instr_events(
            table, deltas, sector_bytes)
        # oracle instruction order: access -> warp -> fold iteration; events
        # ascend by sector inside an instruction (np.unique order)
        order = np.lexsort((sec, foldi, warp, acc_id))
        self.sec = sec[order]
        self.full = full[order]
        self.acc_id = acc_id[order]
        key = (acc_id[order] * np.int64(n_warps) + warp[order]) * np.int64(
            max(int(foldi.max()) + 1, 1) if len(foldi) else 1) + foldi[order]
        # dense instruction ids in stream order (empty instructions dropped,
        # exactly like the oracle's ``continue``)
        new_instr = np.empty(len(key), dtype=bool)
        if len(key):
            new_instr[0] = True
            new_instr[1:] = key[1:] != key[:-1]
        self.instr = np.cumsum(new_instr) - 1 if len(key) else key
        self.n_instr = int(self.instr[-1]) + 1 if len(key) else 0
        self.instr_len = np.bincount(self.instr, minlength=self.n_instr) \
            if len(key) else np.zeros(0, dtype=np.int64)
        is_store = np.array([a.is_store for a in spec.accesses], dtype=bool)
        self.ev_is_store = is_store[self.acc_id] if len(key) else \
            np.zeros(0, dtype=bool)
        self.n_store_events = int(self.ev_is_store.sum())
        # per-event rank within its instruction
        off = np.zeros(self.n_instr + 1, dtype=np.int64)
        np.cumsum(self.instr_len, out=off[1:])
        self.instr_off = off
        self.rank = np.arange(len(key)) - off[self.instr] if len(key) else key

    def sector_deltas(self, grid: tuple):
        """Per-access per-axis *sector* deltas, or None when any in-use axis
        step is not sector-aligned (translation cannot fold unique-sector
        streams; callers rebuild per block from byte addresses instead)."""
        sb = self.sector_bytes
        steps = self.table.step_bytes
        for k, g in enumerate(grid):
            if g > 1 and (steps[:, k] % sb != 0).any():
                return None
        return steps // sb


def batched_instr_events(table: StreamTable, deltas: np.ndarray,
                         sector_bytes: int):
    """Sector events of ``len(deltas)`` translated copies of the base block.

    ``deltas`` is (B, n_accesses) byte translations.  Returns flat
    (sec, full, acc_id, row, fold) arrays with ``row = block * n_warps +
    warp`` and no ordering imposed (callers lexsort into their instruction
    order).  This is the single event builder behind the base instruction
    table (B=1, zero delta), the per-block rebuild, and the wave-level
    fallback — one implementation, three translations."""
    spec, launch = table.spec, table.launch
    n_warps = -(-launch.threads // 32)
    padded = n_warps * 32
    deltas = np.asarray(deltas, dtype=np.int64)
    n_blocks = len(deltas)
    ev_sec, ev_full, ev_acc, ev_row, ev_fold = [], [], [], [], []
    for ai, acc in enumerate(spec.accesses):
        addr = table.addrs[ai]  # (threads, fold)
        fold = addr.shape[1]
        for j in range(fold):
            col = addr[:, j]
            flat = np.full((n_blocks, padded), _SENTINEL, dtype=np.int64)
            flat[:, : len(col)] = np.where(
                col[None, :] != _SENTINEL,
                col[None, :] + deltas[:, ai : ai + 1], _SENTINEL)
            flat = flat.reshape(-1)
            secs, rows = _warp_unique(flat, n_blocks * n_warps, sector_bytes)
            if not len(secs):
                continue
            ev_sec.append(secs)
            ev_row.append(rows)
            ev_acc.append(np.full(len(secs), ai, dtype=np.int64))
            ev_fold.append(np.full(len(secs), j, dtype=np.int64))
            if acc.is_store:
                ev_full.append(_full_sector_flags(
                    flat, n_blocks * n_warps, secs, rows,
                    acc.field.elem_bytes, sector_bytes))
            else:
                ev_full.append(np.zeros(len(secs), dtype=bool))
    if not ev_sec:
        z = np.zeros(0, dtype=np.int64)
        return z, np.zeros(0, dtype=bool), z.copy(), z.copy(), z.copy()
    return (np.concatenate(ev_sec), np.concatenate(ev_full),
            np.concatenate(ev_acc), np.concatenate(ev_row),
            np.concatenate(ev_fold))


def _warp_unique(addr_col: np.ndarray, n_warps: int, gran: int):
    """Per-warp sorted unique ``addr // gran`` values of one instruction.

    Returns (values, warp_ids) flattened in (warp, ascending value) order —
    identical to per-warp ``np.unique`` calls of the stream oracle."""
    keys = np.where(addr_col != _SENTINEL, addr_col // gran, _SENTINEL)
    s, uniq, row_idx = _rowwise_group_stats(keys, 32, n_warps)
    return s[uniq], row_idx[uniq]


def _full_sector_flags(addr_col: np.ndarray, n_warps: int, secs: np.ndarray,
                       warps: np.ndarray, elem_bytes: int, sector_bytes: int):
    """Fully-written flags per (warp, sector) event, mirroring the oracle:
    a sector is full when the warp writes >= sector_bytes/elem_bytes unique
    elements mapping into it (elements-per-sector counted at element
    granularity, sector of an element = elem * eb // sector_bytes)."""
    epc = max(1, sector_bytes // elem_bytes)
    ekeys = np.where(addr_col != _SENTINEL, addr_col // elem_bytes, _SENTINEL)
    es, euniq, erow = _rowwise_group_stats(ekeys, 32, n_warps)
    elems, ewarps = es[euniq], erow[euniq]
    soe = elems * elem_bytes // sector_bytes
    if not len(elems):
        return np.zeros(len(secs), dtype=bool)
    # run-length count per (warp, sector-of-element); both arrays ascend
    # within a warp, so groups are contiguous
    scale = np.int64(max(int(soe.max()), int(secs.max()) if len(secs) else 0) + 1)
    ekey = ewarps * scale + soe
    boundary = np.empty(len(ekey), dtype=bool)
    boundary[0] = True
    boundary[1:] = ekey[1:] != ekey[:-1]
    group = np.cumsum(boundary) - 1
    counts = np.bincount(group)
    gkeys = ekey[boundary]
    # look up each event's (warp, sector) among the element groups
    skey = warps * scale + secs
    pos = np.searchsorted(gkeys, skey)
    pos_c = np.minimum(pos, len(gkeys) - 1)
    found = gkeys[pos_c] == skey
    return found & (counts[pos_c] >= epc)


_STREAM_MEMO: OrderedDict = OrderedDict()
_STREAM_MEMO_CAP = 32


def stream_table(spec: KernelSpec, launch: LaunchConfig,
                 domain=None) -> StreamTable:
    """Memoized shared stream table (the ``streams built/shared`` counters
    feed the engine's cache_stats)."""
    domain = tuple(domain or spec.domain)
    key = (spec, launch, domain)
    tab = _STREAM_MEMO.get(key)
    if tab is not None:
        _STREAM_MEMO.move_to_end(key)
        CORE_STATS["streams_shared"] += 1
        return tab
    with obs.span("gridwalk.stream_table", "cachesim"):
        tab = StreamTable(spec, launch, domain)
    CORE_STATS["streams_built"] += 1
    _STREAM_MEMO[key] = tab
    while len(_STREAM_MEMO) > _STREAM_MEMO_CAP:
        _STREAM_MEMO.popitem(last=False)
    return tab


# --------------------------------------------------------------------------
# Vectorized walks (exact replicas of the per-warp loops above)
# --------------------------------------------------------------------------
def _rowwise_group_stats(keys: np.ndarray, group: int, n_rows: int):
    """Shared core of the vectorized walks: sort ``keys`` (padded with
    _SENTINEL for invalid threads) within rows of ``group`` threads and
    return (sorted_keys, unique-mask, row_index) for counting row-unique
    values exactly as per-warp ``np.unique`` calls do."""
    pad = n_rows * group - len(keys)
    if pad:
        keys = np.concatenate([keys, np.full(pad, _SENTINEL, dtype=np.int64)])
    rows = keys.reshape(n_rows, group)
    s = np.sort(rows, axis=1)
    uniq = np.ones_like(s, dtype=bool)
    uniq[:, 1:] = s[:, 1:] != s[:, :-1]
    uniq &= s != _SENTINEL
    row_idx = np.broadcast_to(np.arange(n_rows)[:, None], s.shape)
    return s, uniq, row_idx


def walk_block_l1_fast(
    spec: KernelSpec, launch: LaunchConfig, domain=None, half_warp: int = 16
):
    """Vectorized ``walk_block_l1``: one numpy pass per (access, folding
    iteration) over the shared stream table instead of one per half warp.
    Bitwise-identical cycle counts (pinned by tests/test_torch_cachesim.py
    against the loop oracle)."""
    domain = tuple(domain or spec.domain)
    table = stream_table(spec, launch, domain)
    fold = table.pts_tm.shape[1]
    n_rows = -(-launch.threads // half_warp)
    cycles = 0
    vis = BankConflictVisitor
    for ai in range(len(spec.accesses)):
        addr = table.addrs[ai]
        for j in range(fold):
            col = addr[:, j]
            words = np.where(col != _SENTINEL, col // vis.BANK_BYTES, _SENTINEL)
            s, uniq, row_idx = _rowwise_group_stats(words, half_warp, n_rows)
            # per-row max addresses per bank among unique words
            counts = np.zeros((n_rows, vis.N_BANKS), dtype=np.int64)
            np.add.at(counts, (row_idx[uniq], (s % vis.N_BANKS)[uniq]), 1)
            bank_max = counts.max(axis=1)
            # per-row unique 1024B windows (monotone transform of sorted words)
            win = s * vis.BANK_BYTES // vis.WINDOW
            wfirst = np.ones_like(win, dtype=bool)
            wfirst[:, 1:] = win[:, 1:] != win[:, :-1]
            wfirst &= uniq
            n_win = wfirst.sum(axis=1)
            cycles += int(np.maximum(bank_max, n_win).sum())
    return cycles / max(table.lups, 1)


def warp_sector_requests_fast(
    spec: KernelSpec, launch: LaunchConfig, sector_bytes: int = 32, domain=None
) -> int:
    """Vectorized ``warp_sector_requests`` over the shared stream table."""
    domain = tuple(domain or spec.domain)
    table = stream_table(spec, launch, domain)
    fold = table.pts_tm.shape[1]
    n_rows = -(-launch.threads // 32)
    total = 0
    for ai, acc in enumerate(spec.accesses):
        if acc.is_store:
            continue
        addr = table.addrs[ai]
        for j in range(fold):
            col = addr[:, j]
            sect = np.where(col != _SENTINEL, col // sector_bytes, _SENTINEL)
            _, uniq, _ = _rowwise_group_stats(sect, 32, n_rows)
            total += int(uniq.sum())
    return total * sector_bytes


def access_line_tuples(acc: Access, pts: np.ndarray, domain_ndim: int,
                       line_bytes: int) -> set:
    """Multi-dimensional line tuples (paper §4.4.1): floor-div by the line
    size only in the innermost dim — the address space the implicit-set
    estimator counts in (exact up to row wrap-around, which the paper shows
    is negligible; the linear-address cache simulator covers that side)."""
    arr = _access_line_rows(acc, pts, domain_ndim, line_bytes)
    return {(acc.field.name,) + tuple(int(v) for v in row) for row in arr}


def _access_line_rows(acc: Access, pts: np.ndarray, domain_ndim: int,
                      line_bytes: int) -> np.ndarray:
    """(N, field_ndim) int64 line-tuple rows (vectorized tuple math)."""
    nd = acc.field.ndim
    coords = []
    for j in range(nd):
        d = acc.dim_map[j]
        col = 3 - domain_ndim + d
        coords.append(acc.coeffs[j] * pts[:, col] + acc.offsets[j])
    eb = acc.field.elem_bytes
    x_line = (eb * (coords[-1] + acc.field.alignment)) // line_bytes
    cols = coords[:-1] + [x_line]
    return np.stack(cols, axis=1)


def block_footprint_bytes(
    spec: KernelSpec,
    launch: LaunchConfig,
    line_bytes: int = 32,
    which: str = "loads",
    domain=None,
    block_idx=(0, 0, 0),
) -> int:
    """Unique footprint (bytes, line-granular) of one thread block (oracle).

    Counting is vectorized: per field, line-tuple rows of all its accesses
    are stacked and counted with ``np.unique`` — the same distinct tuples
    the set-based ``access_line_tuples`` oracle produces."""
    domain = domain or spec.domain
    pts = block_points(launch, domain, block_idx)
    accs = spec.loads if which == "loads" else spec.stores if which == "stores" else spec.accesses
    per_field: dict = {}
    for acc in accs:
        rows = _access_line_rows(acc, pts, len(domain), line_bytes)
        per_field.setdefault(acc.field.name, []).append(rows)
    n_lines = 0
    for rows_list in per_field.values():
        stacked = rows_list[0] if len(rows_list) == 1 else np.concatenate(rows_list)
        if len(stacked):
            n_lines += len(np.unique(stacked, axis=0))
    return n_lines * line_bytes


def warp_sector_requests(
    spec: KernelSpec, launch: LaunchConfig, sector_bytes: int = 32, domain=None
) -> int:
    """Total 32B-sector requests issued by a block: per-warp unique sectors,
    summed over warps and load instructions — the no-inter-warp-reuse upper
    bound on the L2->L1 volume (paper fig. 15's outlined bar)."""
    domain = domain or spec.domain
    fold = int(np.prod(launch.folding))
    pts_tm = _clipped_thread_major(launch, domain)
    total = 0
    for acc in spec.loads:
        for w0 in range(0, launch.threads, 32):
            hw = pts_tm[w0 : w0 + 32]
            for j in range(fold):
                sl = hw[:, j, :]
                sl = sl[sl[:, 0] >= 0]
                if len(sl) == 0:
                    continue
                a = access_addresses(acc, sl, len(domain))
                total += len(np.unique(a // sector_bytes))
    return total * sector_bytes
