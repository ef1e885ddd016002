"""Wrappers of the hand-written CUDA Jacobi kernels
(``repro_torch/csrc/jacobi2d.cu``).

* ``jacobi_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding) on the domain (1, Y, X).
  Replaces the TPU's ``make_rowstream``.  The priced folds run compile-time
  instantiations (``pointwise_fold_rows``), with 64-bit element offsets;
  ``LAST_POINTWISE`` records the fold of the last launch.
* ``jacobi_ytile`` — a persistent y-march: CTAs take contiguous ranges of
  the (strip of tx columns, tile of ty rows) steps (``ytile_ranges``), and a
  producer warp streams each strip's padded rows into a ring of shared-memory
  slots (``ytile_plan``) by bulk copies of the TMA unit or by ``cp.async``
  (``ytile_route``), from which one consumer thread a column marches down y.
  Replaces ``make_ytile(ty)`` (``ytile_tile`` picks tx).  ``LAST_YTILE``
  records the route, tile, ring and CTAs of the last launch.

Both take the halo-1 padded (Y+2, X+2) source and the weights (wc, wn) and
return (Y, X).  On a CPU tensor they compute the plain version
(``ref.jacobi_padded_ref``); on a CUDA tensor they launch the kernel on the
current stream or raise.  ``LAUNCHES`` counts kernel launches per wrapper,
and ``LAST_LAUNCH`` holds the launch (``LaunchConfig``, or the (ty, tx)
tile) each wrapper last ran on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import SMEM_PER_BLOCK, _build, raw_stream
from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref

LAUNCHES = {"jacobi_pointwise": 0, "jacobi_ytile": 0}
LAST_LAUNCH = {"jacobi_pointwise": None, "jacobi_ytile": None}
# {"fold_rows"} of the last jacobi_pointwise launch
LAST_POINTWISE: dict = {}
# {"route", "tile", "strip", "columns", "rows", "stages", "ring_bytes", "threads", "ctas"}
# of the last jacobi_ytile launch
LAST_YTILE: dict = {}

YTILE_TX = (256, 128, 64, 32, 16, 8, 4, 2, 1)  # tx choices of jacobi_ytile, widest first
YTILE_ROUTES = ("tma", "cp_async")
YTILE_STAGES = 4           # ring slots of jacobi_ytile where they fit YTILE_CTAS_PER_SM CTAs an SM
YTILE_MIN_STAGES = 2       # an output row's centre slot and the slot of its down row
YTILE_MAX_STAGES = 8       # kMaxStages
YTILE_CTAS_PER_SM = 2      # persistent CTAs an SM, where the occupancy query allows
SMEM_PER_SM = 233_472      # shared memory of one Hopper SM (228 KB) ...
SMEM_RESERVED = 1_024      # ... less this much for each resident CTA
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "jacobi_pointwise_launch": [_I, _P, _P, _D, _D] + [_I] * 8 + [_P],
    "jacobi_ytile_launch": [_I, _P, _P, _D, _D] + [_I] * 10 + [_P],
    "jacobi_ytile_blocks_per_sm": [_I, _I, _I, _I],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None
    LAST_POINTWISE.clear()
    LAST_YTILE.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("jacobi2d")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.jacobi_error_string.argtypes = [ctypes.c_int]
    lib.jacobi_error_string.restype = ctypes.c_char_p
    return lib


def _check(src_padded: torch.Tensor, weights) -> tuple:
    """Validate the operands; return the output domain (Y, X) and the
    weights (wc, wn) as Python floats."""
    if not isinstance(src_padded, torch.Tensor):
        raise TypeError("src_padded must be a torch tensor")
    if src_padded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src_padded.device}")
    if src_padded.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {src_padded.dtype}")
    if src_padded.dim() != 2:
        raise ValueError(f"expected a (Y+2, X+2) field, got {tuple(src_padded.shape)}")
    if not src_padded.is_contiguous():
        raise ValueError("src_padded must be contiguous")
    if len(weights) != 2:
        raise ValueError(f"expected the weights (wc, wn), got {weights!r}")
    domain = tuple(n - 2 for n in src_padded.shape)
    if min(domain) < 1:
        raise ValueError(f"padded shape {tuple(src_padded.shape)} is smaller than its halo of 1")
    return domain, tuple(float(w) for w in weights)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().jacobi_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def pointwise_fold_rows(launch: LaunchConfig) -> int:
    """The rows of the compile-time fold ``jacobi_pointwise`` runs at
    ``launch``: 1 or 2 for the priced folds (fx = 1, fy = 1 or 2, any fz),
    0 for the generic kernel, whose folds are read at run time."""
    fx, fy, _fz = launch.folding
    return fy if fx == 1 and fy in (1, 2) else 0


def jacobi_pointwise(src_padded: torch.Tensor, launch: LaunchConfig,
                     weights=(0.5, 0.125)) -> torch.Tensor:
    """One Jacobi sweep, one thread per (point x fold iteration) at ``launch``
    (the mapping of ``core.gridwalk.block_points`` on (1, Y, X))."""
    (Y, X), (wc, wn) = _check(src_padded, weights)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((Y, X))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if src_padded.device.type == "cpu":
        return jacobi_padded_ref(src_padded, (wc, wn))
    out = torch.empty((Y, X), dtype=src_padded.dtype, device=src_padded.device)
    index = src_padded.get_device()
    with torch.cuda.device(index):
        rc = _lib().jacobi_pointwise_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(), wc, wn,
            Y, X, bx, by, bz, fx, fy, fz, raw_stream(index))
    _raise_on(rc, "jacobi_pointwise")
    LAUNCHES["jacobi_pointwise"] += 1
    LAST_LAUNCH["jacobi_pointwise"] = launch
    LAST_POINTWISE.clear()
    LAST_POINTWISE.update(fold_rows=pointwise_fold_rows(launch))
    return out


def ytile_smem_bytes(ty: int, tx: int, elem_bytes: int) -> int:
    """Shared memory of a staged (ty+2) x (tx+2) input tile: what decides
    the tile (``ytile_tile``), as VMEM decides it on the TPU."""
    return (ty + 2) * (tx + 2) * elem_bytes


def ytile_tile(ty: int, elem_bytes: int) -> tuple:
    """(TY, TX) of ``jacobi_ytile(ty)``: the widest TX whose staged tile fits
    in one block's shared memory (capacity takes the place of the TPU's
    VMEM limit); ValueError when none does."""
    for tx in YTILE_TX:
        if ytile_smem_bytes(ty, tx, elem_bytes) <= SMEM_PER_BLOCK:
            return ty, tx
    raise ValueError(
        f"no y-tile of {ty} rows fits its staged inputs in "
        f"{SMEM_PER_BLOCK} B of shared memory")


def ytile_row_bytes(tx: int, elem_bytes: int, xp: int) -> int:
    """Bytes from one ring-slot row of ``jacobi_ytile`` to the next for a
    strip of tx columns of a padded field with rows of ``xp`` elements: the
    strip's tx + 2 padded columns and 16 bytes more, rounded up to 16 bytes,
    then offset by the field's row bytes modulo 16.  So each slot row keeps
    its field row's alignment modulo 16, whole 16-byte pieces of the field
    land as whole 16-byte pieces of the slot, and a row's surplus bytes fall
    into the gap before the next."""
    return -(-((tx + 2) * elem_bytes + 16) // 16) * 16 + (xp * elem_bytes) % 16


def ytile_ring_bytes(rows: int, tx: int, elem_bytes: int, stages: int, xp: int) -> int:
    """Shared memory of ``jacobi_ytile``: ``stages`` slots of ``rows`` slot
    rows (rounded up to 16 bytes) and 32 bytes for the first row's head piece
    and the last row's tail, and a full and an empty mbarrier (8 bytes each)
    a slot."""
    slot = -(-rows * ytile_row_bytes(tx, elem_bytes, xp) // 16) * 16 + 32
    return stages * (slot + 16)


def ytile_plan(ty: int, tx: int, elem_bytes: int, xp: int) -> tuple:
    """(rows, stages) of ``jacobi_ytile``'s ring for a ty x tx tile of a
    field with padded rows of ``xp`` elements: slots of ty padded rows (at
    least the 2 a slot needs), as many as fit YTILE_CTAS_PER_SM CTAs an SM up
    to YTILE_STAGES, at least YTILE_MIN_STAGES; failing that, YTILE_STAGES
    slots of as many rows as fit (the generic ring, for tiles too tall for
    that)."""
    budget = SMEM_PER_SM // YTILE_CTAS_PER_SM - SMEM_RESERVED
    rows = max(2, ty)
    for stages in range(YTILE_STAGES, YTILE_MIN_STAGES - 1, -1):
        if ytile_ring_bytes(rows, tx, elem_bytes, stages, xp) <= budget:
            return rows, stages
    row = ytile_row_bytes(tx, elem_bytes, xp)
    return max(2, (budget // YTILE_STAGES - 16 - 32 - 15) // row), YTILE_STAGES


def ytile_route(tx: int, xp: int, elem_bytes: int, data_ptr: int = 0) -> str:
    """How ``jacobi_ytile``'s producer fills its ring: ``"tma"`` (one bulk
    copy of the TMA unit a padded row) where rows, strip starts (tx columns
    apart) and the field's address are 16-byte aligned, as a bulk copy
    needs; ``"cp_async"`` (16-byte copies by the producer warp's lanes)
    everywhere else.  At X = 4096 the fp32 rows are 16,392 bytes
    (``"cp_async"``) and the fp64 rows 32,784 (``"tma"``)."""
    if (xp * elem_bytes) % 16 == 0 and (tx * elem_bytes) % 16 == 0 and data_ptr % 16 == 0:
        return "tma"
    return "cp_async"


def ytile_strip(tx: int) -> int:
    """Output columns of ``jacobi_ytile``'s strips for a tile tx wide: tx,
    or, for a tile wider than the YTILE_TX[0] = 256 columns a CTA's
    consumers cover, the tile cut into equal strips no wider than that."""
    return -(-tx // -(-tx // YTILE_TX[0]))


def ytile_columns(tx: int, X: int, elem_bytes: int, data_ptr: int = 0) -> int:
    """Output columns each consumer thread of ``jacobi_ytile`` owns for
    strips tx wide of a (Y, X) output whose padded field is at address
    ``data_ptr``: 2, loaded from shared memory and stored in pairs of 8
    (fp32) or 16 (fp64) bytes, where the strips, X and the address leave
    every pair so aligned; else 1."""
    if tx % 2 == 0 and X % 2 == 0 and data_ptr % (2 * elem_bytes) == 0:
        return 2
    return 1


def ytile_threads(tx: int, columns: int = 1) -> int:
    """Threads of a ``jacobi_ytile`` CTA: the producer warp, then one
    consumer for each ``columns`` strip columns, in whole warps."""
    consumers = -(-tx // columns)
    return 32 + -(-consumers // 32) * 32


def ytile_steps(domain: tuple, ty: int, tx: int) -> int:
    """(strip, y-tile) steps of ``jacobi_ytile`` on ``domain``."""
    Y, X = domain
    return -(-Y // ty) * -(-X // tx)


def ytile_ctas(steps: int, slots: int, strips: int) -> int:
    """CTAs of ``jacobi_ytile``'s persistent grid on a card that holds
    ``slots`` of them at once: one a slot, no more than the steps, and a
    multiple of the ``strips`` where there are no more strips than that, so
    that the CTAs of a y-range march its strips side by side, in step, and
    read whole padded rows together."""
    ctas = max(1, min(slots, steps))
    return ctas - ctas % strips if strips <= ctas else ctas


def ytile_ranges(steps: int, ctas: int) -> list:
    """The (begin, end) steps of each of ``ctas`` CTAs: equal contiguous
    ranges, as the kernel cuts them (``begin = b * steps // ctas``)."""
    return [(b * steps // ctas, (b + 1) * steps // ctas) for b in range(ctas)]


def ytile_segments(domain: tuple, ty: int, tx: int, begin: int, end: int) -> list:
    """The segments a CTA marches for its steps ``begin`` .. ``end``, as the
    kernel walks them: (x0, y0, n) for outputs y0 .. y0+n-1 of the strip at
    column x0, strip-major."""
    Y, X = domain
    tiles_y = -(-Y // ty)
    out, s = [], begin
    while s < end:
        strip, t = divmod(s, tiles_y)
        cnt = min(tiles_y - t, end - s)
        out.append((strip * tx, t * ty, min(Y, (t + cnt) * ty) - t * ty))
        s += cnt
    return out


@functools.cache
def _ytile_plan(ty: int, tx: int, elem_bytes: int, xp: int) -> tuple:
    """``ytile_plan``, once per tile and row length: the wrapper's host time
    before a launch is time an idle card waits."""
    return ytile_plan(ty, tx, elem_bytes, xp)


@functools.cache
def _ytile_slots(device_index: int, elem_bytes: int, columns: int, threads: int,
                 smem: int) -> int:
    """y-tile CTAs the card holds at once with ``threads`` threads and
    ``smem`` bytes of shared memory: blocks per SM (the occupancy query, at
    most YTILE_CTAS_PER_SM) times SMs."""
    n = _lib().jacobi_ytile_blocks_per_sm(elem_bytes, columns, threads, smem)
    if n < 1:
        raise RuntimeError(f"jacobi_ytile fits no SM at {threads} threads and {smem} B of "
                           f"shared memory (occupancy query returned {n})")
    sms = torch.cuda.get_device_properties(device_index).multi_processor_count
    return min(n, YTILE_CTAS_PER_SM) * sms


def jacobi_ytile(src_padded: torch.Tensor, ty: int, tx: int,
                 weights=(0.5, 0.125)) -> torch.Tensor:
    """One Jacobi sweep over ty x tx tiles, marched down y by persistent
    CTAs through a ring of padded rows in shared memory."""
    return _ytile(src_padded, ty, tx, weights)


def _ytile(src_padded: torch.Tensor, ty: int, tx: int, weights=(0.5, 0.125), *,
           route: str | None = None, stages: int | None = None, columns: int | None = None,
           ctas: int | None = None) -> torch.Tensor:
    """``jacobi_ytile`` with the kernel's choices pinned, for the tests:
    ``route`` (``ytile_route`` by default), ``stages`` (``ytile_plan``'s by
    default), ``columns`` a consumer (``ytile_columns`` by default) and
    ``ctas`` (one a resident slot by default)."""
    (Y, X), (wc, wn) = _check(src_padded, weights)
    eb = src_padded.element_size()
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    if ytile_smem_bytes(ty, tx, eb) > SMEM_PER_BLOCK:
        raise ValueError(
            f"tile {ty}x{tx} needs {ytile_smem_bytes(ty, tx, eb)} B of shared memory, more "
            f"than the {SMEM_PER_BLOCK} B a block can use")
    sx = ytile_strip(tx)
    rule = ytile_route(sx, X + 2, eb, src_padded.data_ptr())
    if route not in (None, *YTILE_ROUTES) or (route == "tma" and rule != "tma"):
        raise ValueError(f"route {route!r} does not take this field (ytile_route says {rule!r})")
    route = route or rule
    rows, fit = _ytile_plan(ty, sx, eb, X + 2)
    stages = fit if stages is None else stages
    ring = ytile_ring_bytes(rows, sx, eb, stages, X + 2)
    if not YTILE_MIN_STAGES <= stages <= YTILE_MAX_STAGES or ring > SMEM_PER_BLOCK:
        raise ValueError(f"{stages} ring slots of {rows} rows for tile {ty}x{tx}: "
                         f"{YTILE_MIN_STAGES} to {YTILE_MAX_STAGES}, in {SMEM_PER_BLOCK} B of "
                         f"shared memory")
    rule_columns = ytile_columns(sx, X, eb, src_padded.data_ptr())
    if columns not in (None, 1, 2) or (columns == 2 and rule_columns != 2):
        raise ValueError(f"{columns} columns a consumer do not take this field "
                         f"(ytile_columns says {rule_columns})")
    columns = columns or rule_columns
    steps = ytile_steps((Y, X), ty, sx)
    if steps >= 2**31 or Y + 2 >= 2**31:
        raise ValueError(f"{steps} (strip, y-tile) steps exceed the kernel's 32-bit count")
    if ctas is not None and not 1 <= ctas <= steps:
        raise ValueError(f"{ctas} CTAs for {steps} (strip, y-tile) steps")
    if src_padded.device.type == "cpu":
        return jacobi_padded_ref(src_padded, (wc, wn))
    index = src_padded.get_device()
    threads = ytile_threads(sx, columns)
    if ctas is None:
        ctas = ytile_ctas(steps, _ytile_slots(index, eb, columns, threads, ring), -(-X // sx))
    out = torch.empty((Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(index):
        rc = _lib().jacobi_ytile_launch(
            eb, src_padded.data_ptr(), out.data_ptr(), wc, wn, Y, X, ty, sx, rows,
            ytile_row_bytes(sx, eb, X + 2), stages, YTILE_ROUTES.index(route), columns, ctas,
            raw_stream(index))
    _raise_on(rc, "jacobi_ytile")
    LAUNCHES["jacobi_ytile"] += 1
    LAST_LAUNCH["jacobi_ytile"] = (ty, tx)
    LAST_YTILE.clear()
    LAST_YTILE.update(route=route, tile=(ty, tx), strip=sx, columns=columns, rows=rows,
                      stages=stages, ring_bytes=ring, threads=threads, ctas=ctas)
    return out
