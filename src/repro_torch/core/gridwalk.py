"""Explicit grid iteration (paper listing 5, figs. 4/5).

This is the enumeration path: it walks every thread of a thread group and
puts the thread coordinates into all address expressions.  It is exact, and
it is the path for L1-level metrics where groups are small (warps/blocks).

Vectorized with numpy meshgrid as in the paper (§4.2).

A copy of ``repro.core.gridwalk`` trimmed to what ``estimate_gpu`` reaches:
the memoized base-block address streams (stream table) behind the vectorized
L1 walks and block footprints.  The port's per-point CUDA kernel
(``repro_torch/csrc/stencil3d25.cu``) maps threads to points exactly as
``block_points`` documents, so the priced launch is the executed one.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np

from repro_torch import obs
from repro_torch.obs.metrics import CounterGroup

from .access import Access, KernelSpec, LaunchConfig, domain_zyx

# ---------------------------------------------------------------------------
# Core instrumentation (process-local; the Explorer reports per-sweep deltas),
# a registry-backed counter group: every counter is named and documented as
# ``core.<field>``.  The two wave counters belong to the cache simulator,
# which is not ported yet; they stay 0 and keep the reference's key set.
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
# L1 bank model (paper figs. 4/5)
# --------------------------------------------------------------------------
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
# Stream table: memoized base-block address streams
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

    Each access's byte addresses of the base block are generated once here
    and read by every vectorized walk of the same (spec, launch, domain).
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


_STREAM_MEMO: OrderedDict = OrderedDict()
_STREAM_MEMO_CAP = 32


def stream_table(spec: KernelSpec, launch: LaunchConfig,
                 domain=None) -> StreamTable:
    """Memoized shared stream table (bounded LRU; the ``streams
    built/shared`` counters feed the engine's cache_stats)."""
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
# Vectorized walks (exact replicas of the reference's per-warp loops)
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
    """Average L1 cycles per work unit for one thread block (paper §4.2):
    one numpy pass per (access, folding iteration) over the shared stream
    table, one load instruction per half warp and folding iteration."""
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
    """Total 32B-sector requests issued by a block: per-warp unique sectors,
    summed over warps and load instructions — the no-inter-warp-reuse upper
    bound on the L2->L1 volume (paper fig. 15's outlined bar)."""
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
