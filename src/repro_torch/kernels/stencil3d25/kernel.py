"""Wrappers of the hand-written CUDA star-stencil kernels
(``repro_torch/csrc/stencil3d25.cu``).

* ``star_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding).  Replaces the TPU's
  ``make_replane``.  ``pointwise_offset_bits`` picks its offset width from
  the field's size; ``LAST_POINTWISE`` records it and where the weights
  came from for the last launch.
* ``star_zmarch`` — the z-marching kernel per TY x TX tile: a producer warp
  keeps an S-stage ring of halo planes in flight (``zmarch_route``: TMA,
  or ``cp.async`` for rows that are not 16-byte multiples), and the
  consumer threads keep the z taps in registers.  Replaces ``make_ring``
  (``ring_tile``) and ``make_ytile_ring(ty)`` (``ytile_tile``).
  ``LAST_ZMARCH`` records the route, tile, stages, threads, z segments and
  weights of the last launch.

Both take the halo-padded (Z+2r, Y+2r, X+2r) source and return (Z, Y, X),
for any r.  On a CPU tensor they compute the plain version
(``ref.star_stencil_ref``); on a CUDA tensor they launch the kernel on the
current stream or raise.  For r <= ``UNROLLED_R`` the kernels are unrolled
and read their weights from the library's constant bank
(``weights_in_bank``), filled on the launch stream before each launch; any
other r runs the generic kernels, which read the weights tensor.  The bank
is one per device and dtype and is guarded: a launch on another stream than
the bank's last one makes its stream wait for that launch's event first,
so stencils with different weights may run on several streams at once
(``bank_counts`` counts the fills and those waits).  ``LAUNCHES`` counts
kernel launches on the card per wrapper, as the ``obs`` counter group
``kernels.stencil3d25.launches``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import SMEM_PER_BLOCK, _build
from repro_torch.kernels.stencil3d25.ref import star_stencil_ref
from repro_torch.obs import metrics

LAUNCHES = metrics.CounterGroup("kernels.stencil3d25.launches", {
    "star_pointwise": "star_pointwise kernels launched on the card",
    "star_zmarch": "star_zmarch kernels launched on the card",
})
LAST_POINTWISE: dict = {}          # {"offset_bits", "weights"} of the last star_pointwise launch
LAST_ZMARCH: dict = {}             # {"route", "tile", "stages", "threads", "segments", "weights"}

UNROLLED_R = 4                     # r = 1..UNROLLED_R: unrolled kernels, weights in the bank (kBankRange)
WIDE_AT = 2**31                    # padded elements from which offsets are 64-bit
RING_TILE = (16, 32)               # (TY, TX) of the ring variant
YTILE_TX = (128, 64, 32, 16, 8, 4, 2, 1)  # TX choices of ytile_ring, largest first
ZMARCH_ROUTES = ("tma", "cp_async")
ZMARCH_STAGES = 4                  # ring slots of the z-march at r <= UNROLLED_R (2 or 3 in the ablation)
ZMARCH_CONSUMERS = 256             # consumer threads of a z-march block at most
ZMARCH_MAX_SEGMENTS = 8            # z segments per tile at most (zmarch_segments)
_TMA_BOX_MAX = 256                 # elements on each side of a TMA box
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "star_pointwise_launch": [_I, _P, _P, _P] + [_I] * 11 + [_P],
    "star_zmarch_launch": [_I, _P, _P, _P] + [_I] * 14 + [_P],
    "star_zmarch_blocks_per_sm": [_I] * 5,
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("stencil3d25")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.star_error_string.argtypes = [ctypes.c_int]
    lib.star_error_string.restype = ctypes.c_char_p
    for fn in (lib.star_bank_fills, lib.star_bank_waits):
        fn.argtypes = []
        fn.restype = ctypes.c_longlong
    return lib


def _check(src_padded: torch.Tensor, weights: torch.Tensor, r: int) -> tuple:
    """Validate the operands; return the output domain (Z, Y, X)."""
    if not isinstance(src_padded, torch.Tensor) or not isinstance(weights, torch.Tensor):
        raise TypeError("src_padded and weights must be torch tensors")
    if src_padded.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src_padded.device}")
    if src_padded.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {src_padded.dtype}")
    if weights.dtype != src_padded.dtype or weights.device != src_padded.device:
        raise ValueError("weights must have the dtype and device of the source")
    if r < 1:
        raise ValueError(f"stencil range r must be >= 1, got {r}")
    if src_padded.dim() != 3:
        raise ValueError(f"expected a (Z+2r, Y+2r, X+2r) field, got {tuple(src_padded.shape)}")
    if weights.shape != (6 * r + 1,):
        raise ValueError(f"expected {6 * r + 1} weights for r={r}, got {tuple(weights.shape)}")
    if not (src_padded.is_contiguous() and weights.is_contiguous()):
        raise ValueError("src_padded and weights must be contiguous")
    domain = tuple(n - 2 * r for n in src_padded.shape)
    if min(domain) < 1:
        raise ValueError(f"padded shape {tuple(src_padded.shape)} is smaller than its 2r={2 * r} halo")
    return domain


def weights_in_bank(r: int) -> bool:
    """Whether the card's kernels at range ``r`` read their weights from the
    constant bank (the unrolled instantiations, r <= UNROLLED_R) rather
    than from the weights tensor (the generic ones, any other r)."""
    return r <= UNROLLED_R


def bank_counts() -> dict:
    """{"fills", "waits"}: the constant-bank fills of this process's
    stencil launches on the card, and of them those that first waited for
    the bank's last launch on another stream."""
    lib = _lib()
    return {"fills": lib.star_bank_fills(), "waits": lib.star_bank_waits()}


def zmarch_stages(r: int) -> int:
    """The z-march's default ring slots: ZMARCH_STAGES where the z taps stay
    in registers (r <= UNROLLED_R), else the 2r+1 planes of an output and
    one more, from which the generic kernel reads every tap."""
    return ZMARCH_STAGES if r <= UNROLLED_R else 2 * r + 2


def _min_stages(r: int) -> int:
    return 2 if r <= UNROLLED_R else 2 * r + 2


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().star_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def pointwise_offset_bits(numel: int, wide_at: int = WIDE_AT) -> int:
    """Width of star_pointwise's element offsets for a padded field of
    ``numel`` elements: 32 bits below ``wide_at`` (2**31: every offset then
    fits a signed int), 64 from there on."""
    return 32 if numel < wide_at else 64


def star_pointwise(src_padded: torch.Tensor, weights: torch.Tensor, r: int,
                   launch: LaunchConfig, *, wide_at: int = WIDE_AT) -> torch.Tensor:
    """Range-r star stencil, one thread per (point x fold iteration) at
    ``launch`` (the mapping of ``core.gridwalk.block_points``).  ``wide_at``
    moves the 64-bit offsets' threshold (tests reach that path on a small
    field with it).  On the card, for r <= UNROLLED_R, the weights go to
    the constant bank on the current stream, ordered after the bank's last
    launch on any stream."""
    Z, Y, X = _check(src_padded, weights, r)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((Z, Y, X))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if src_padded.device.type == "cpu":
        return star_stencil_ref(src_padded, weights, r)
    bits = pointwise_offset_bits(src_padded.numel(), wide_at)
    out = torch.empty((Z, Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(src_padded.device):
        rc = _lib().star_pointwise_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(),
            weights.data_ptr(), r, Z, Y, X, bx, by, bz, fx, fy, fz, int(bits == 64),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "star_pointwise")
    LAUNCHES["star_pointwise"] += 1
    LAST_POINTWISE.clear()
    LAST_POINTWISE.update(offset_bits=bits,
                          weights="constant bank" if weights_in_bank(r) else "tensor")
    return out


def layer_ring_bytes(r: int, ty: int, tx: int, elem_bytes: int) -> int:
    """Bytes of the TPU kernels' ring, 2r+1 halo planes of (ty+2r) x (tx+2r)
    elements: its fit in one block's shared memory is the layer condition
    that picks the tiles (``ring_tile``, ``ytile_tile``)."""
    return (2 * r + 1) * (ty + 2 * r) * (tx + 2 * r) * elem_bytes


def zmarch_rows(ty: int, tx: int) -> int:
    """Output rows of one column a z-march consumer thread owns: the least
    of 2, 4 and 8 that needs at most ZMARCH_CONSUMERS threads for the tile
    (with the producer warp a block of at most 9 warps, which leaves 168
    registers a thread for the 2r+1 partial sums of each row); ValueError
    where 8 would need more."""
    for cy in (2, 4, 8):
        if -(-ty // cy) * tx <= ZMARCH_CONSUMERS:
            return cy
    raise ValueError(f"a {ty}x{tx} tile needs more than {ZMARCH_CONSUMERS} z-march "
                     f"consumer threads at 8 rows a thread")


def zmarch_layout(r: int, ty: int, tx: int, elem_bytes: int) -> dict:
    """The z-march kernel's geometry for a ty x tx tile: rows a consumer
    thread owns (``cy``), a ring slot of ``rows`` x ``bw`` elements (ty
    rounded up to cy, plus the 2r halo rows; tx + 2r columns rounded up to
    16 bytes, as a TMA box needs, and 16 bytes more where tiles start off
    16-byte boundaries, since a slot's rows start at the boundary below),
    ``slot_elems`` from slot to slot (a 128-byte multiple), and
    ``threads``: one a column of cy rows, in whole warps, and the producer
    warp."""
    cy = zmarch_rows(ty, tx)
    groups = -(-ty // cy)
    per16 = 16 // elem_bytes
    skew = per16 - 1 if (tx * elem_bytes) % 16 else 0
    bw = -(-(tx + 2 * r + skew) // per16) * per16
    rows = groups * cy + 2 * r
    per128 = 128 // elem_bytes
    return {"cy": cy, "rows": rows, "bw": bw,
            "slot_elems": -(-rows * bw // per128) * per128,
            "threads": -(-groups * tx // 32) * 32 + 32}


def zmarch_smem_bytes(r: int, ty: int, tx: int, elem_bytes: int,
                      stages: int | None = None) -> int:
    """Shared memory of the z-march kernel: ``stages`` ring slots
    (``zmarch_stages`` by default), a full and an empty mbarrier (8 bytes
    each) per slot, and 128 bytes of room to align the ring as TMA needs."""
    stages = zmarch_stages(r) if stages is None else stages
    return stages * (zmarch_layout(r, ty, tx, elem_bytes)["slot_elems"] * elem_bytes + 16) + 128


def zmarch_threads(r: int, ty: int, tx: int) -> int:
    """Threads of a z-march block (``zmarch_layout``'s; r does not change
    them)."""
    return zmarch_layout(r, ty, tx, 8)["threads"]


def zmarch_route(r: int, ty: int, tx: int, xp: int, elem_bytes: int, data_ptr: int = 0) -> str:
    """How the z-march's producer fills its ring for a ty x tx tile of a
    padded field with rows of ``xp`` elements at address ``data_ptr``:
    ``"tma"`` (one 3D box load a plane) where TMA takes the field, i.e. its
    rows (xp · elem_bytes) and address are 16-byte multiples and the box
    is at most 256 elements on each side; ``"cp_async"`` (element copies
    by the producer warp, any row stride) everywhere else."""
    lay = zmarch_layout(r, ty, tx, elem_bytes)
    if ((xp * elem_bytes) % 16 == 0 and data_ptr % 16 == 0
            and max(lay["bw"], lay["rows"]) <= _TMA_BOX_MAX):
        return "tma"
    return "cp_async"


def zmarch_segments(tiles: int, Z: int, r: int, slots: int) -> int:
    """Segments of Z each tile is split into, for ``tiles`` tiles on a card
    that holds ``slots`` z-march CTAs at once: the count of at most
    ZMARCH_MAX_SEGMENTS whose waves of CTAs times planes a CTA marches
    (ceil(Z/n) + 2r, the 2r halo planes read again per segment) is least,
    the fewest among equals."""
    best, best_cost = 1, None
    for n in range(1, min(ZMARCH_MAX_SEGMENTS, Z) + 1):
        zlen = -(-Z // n)
        ctas = tiles * -(-Z // zlen)
        cost = -(-ctas // slots) * (zlen + 2 * r)
        if best_cost is None or cost < best_cost:
            best, best_cost = -(-Z // zlen), cost
    return best


@functools.cache
def _zmarch_slots(device_index: int, elem_bytes: int, r: int, cy: int, threads: int,
                  smem: int) -> int:
    """z-march CTAs the card holds at once: blocks per SM (the occupancy
    query) times SMs."""
    n = _lib().star_zmarch_blocks_per_sm(elem_bytes, r, cy, threads, smem)
    if n < 1:
        raise RuntimeError(f"star_zmarch fits no SM at {threads} threads and {smem} B "
                           f"of shared memory (occupancy query returned {n})")
    return n * torch.cuda.get_device_properties(device_index).multi_processor_count


def _kernel_fits(r: int, ty: int, tx: int, elem_bytes: int, stages: int | None = None) -> bool:
    """Whether the z-march kernel takes a ty x tx tile with ``stages`` slots
    (``zmarch_stages`` by default)."""
    try:
        zmarch_rows(ty, tx)
    except ValueError:
        return False
    stages = zmarch_stages(r) if stages is None else stages
    return (stages >= _min_stages(r)
            and zmarch_smem_bytes(r, ty, tx, elem_bytes, stages) <= SMEM_PER_BLOCK)


def _zmarch_fits(r: int, ty: int, tx: int, elem_bytes: int) -> bool:
    return (layer_ring_bytes(r, ty, tx, elem_bytes) <= SMEM_PER_BLOCK
            and _kernel_fits(r, ty, tx, elem_bytes))


def ring_tile(r: int, elem_bytes: int) -> tuple:
    """(TY, TX) of the ring variant; ValueError when its ring does not fit."""
    ty, tx = RING_TILE
    if not _zmarch_fits(r, ty, tx, elem_bytes):
        raise ValueError(
            f"ring tile {ty}x{tx} at r={r} needs a ring of "
            f"{layer_ring_bytes(r, ty, tx, elem_bytes)} B of shared memory, "
            f"more than the {SMEM_PER_BLOCK} B a block can use")
    return ty, tx


def ytile_tile(r: int, ty: int, elem_bytes: int) -> tuple:
    """(TY, TX) of ``ytile_ring(ty)``: the widest TX whose (2r+1)-plane
    ring fits in one block's shared memory (``layer_ring_bytes``: capacity
    takes the place of the TPU's VMEM layer condition) and whose z-march
    block fits; ValueError when none does."""
    for tx in YTILE_TX:
        if _zmarch_fits(r, ty, tx, elem_bytes):
            return ty, tx
    raise ValueError(
        f"no y-tile of {ty} rows fits a (2r+1)-plane ring at r={r} in "
        f"{SMEM_PER_BLOCK} B of shared memory")


def star_zmarch(src_padded: torch.Tensor, weights: torch.Tensor, r: int, ty: int, tx: int, *,
                route: str | None = None, stages: int | None = None,
                segments: int | None = None) -> torch.Tensor:
    """Range-r star stencil marching over z per ty x tx output tile.
    ``route`` (``zmarch_route`` by default), ``stages`` (``zmarch_stages``
    by default) and ``segments`` (``zmarch_segments`` by default) pin the
    kernel's choices, for tests and the ablation.  On the card the weights
    reach the kernel as for ``star_pointwise``."""
    Z, Y, X = _check(src_padded, weights, r)
    eb = src_padded.element_size()
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    stages = zmarch_stages(r) if stages is None else stages
    if not _kernel_fits(r, ty, tx, eb, stages):
        raise ValueError(
            f"a {ty}x{tx} tile at r={r} with {stages} stages needs at most "
            f"{ZMARCH_CONSUMERS} consumer threads and {SMEM_PER_BLOCK} B of shared memory")
    lay = zmarch_layout(r, ty, tx, eb)
    if -(-Y // ty) > _GRID_YZ_MAX:
        raise ValueError(f"{-(-Y // ty)} y-tiles exceed CUDA's y grid limit")
    rule = zmarch_route(r, ty, tx, X + 2 * r, eb, src_padded.data_ptr())
    if route not in (None, *ZMARCH_ROUTES) or (route == "tma" and rule != "tma"):
        raise ValueError(f"route {route!r} does not take this field (zmarch_route says {rule!r})")
    if segments is not None and not 1 <= segments <= min(Z, _GRID_YZ_MAX):
        raise ValueError(f"{segments} z segments for Z={Z}")
    if src_padded.device.type == "cpu":
        return star_stencil_ref(src_padded, weights, r)
    route = route or rule
    smem = zmarch_smem_bytes(r, ty, tx, eb, stages)
    tiles = -(-X // tx) * -(-Y // ty)
    if segments is None:
        slots = _zmarch_slots(src_padded.device.index or 0, eb, r, lay["cy"], lay["threads"], smem)
        segments = zmarch_segments(tiles, Z, r, slots)
    segments = -(-Z // -(-Z // segments))  # the count ceil(Z/n)-plane segments really make
    out = torch.empty((Z, Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(src_padded.device):
        rc = _lib().star_zmarch_launch(
            eb, src_padded.data_ptr(), out.data_ptr(), weights.data_ptr(), r, Z, Y, X, ty, tx,
            lay["cy"], lay["rows"], lay["bw"], lay["slot_elems"], stages, segments,
            ZMARCH_ROUTES.index(route), lay["threads"], torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "star_zmarch")
    LAUNCHES["star_zmarch"] += 1
    LAST_ZMARCH.clear()
    LAST_ZMARCH.update(route=route, tile=(ty, tx), stages=stages, threads=lay["threads"],
                       segments=segments,
                       weights="constant bank" if weights_in_bank(r) else "tensor")
    return out
