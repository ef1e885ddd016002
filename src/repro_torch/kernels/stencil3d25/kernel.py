"""Wrappers of the hand-written CUDA star-stencil kernels
(``repro_torch/csrc/stencil3d25.cu``).

* ``star_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding).  Replaces the TPU's
  ``make_replane``.
* ``star_zmarch`` — z-marching kernel with a (2r+1)-plane shared-memory ring
  per TY x TX tile.  Replaces ``make_ring`` (``ring_tile``) and
  ``make_ytile_ring(ty)`` (``ytile_tile``).

Both take the halo-padded (Z+2r, Y+2r, X+2r) source and return (Z, Y, X).
On a CPU tensor they compute the plain version (``ref.star_stencil_ref``);
on a CUDA tensor they launch the kernel on the current stream or raise.
``LAUNCHES`` counts kernel launches per wrapper.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import SMEM_PER_BLOCK, _build
from repro_torch.kernels.stencil3d25.ref import star_stencil_ref

LAUNCHES = {"star_pointwise": 0, "star_zmarch": 0}

RING_TILE = (16, 32)               # (TY, TX) of the ring variant
YTILE_TX = (128, 64, 32, 16, 8, 4, 2, 1)  # TX choices of ytile_ring, largest first
ZMARCH_PREFETCH = 8                # halo elements a thread stages per plane (kPrefetch)
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "star_pointwise_launch": [_I, _P, _P, _P] + [_I] * 10 + [_P],
    "star_zmarch_launch": [_I, _P, _P, _P] + [_I] * 7 + [_P],
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
    if src_padded.numel() >= 2**31:
        raise ValueError("fields of 2**31 elements or more are not supported")
    return domain


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().star_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def star_pointwise(src_padded: torch.Tensor, weights: torch.Tensor, r: int,
                   launch: LaunchConfig) -> torch.Tensor:
    """Range-r star stencil, one thread per (point x fold iteration) at
    ``launch`` (the mapping of ``core.gridwalk.block_points``)."""
    Z, Y, X = _check(src_padded, weights, r)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((Z, Y, X))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if src_padded.device.type == "cpu":
        return star_stencil_ref(src_padded, weights, r)
    out = torch.empty((Z, Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(src_padded.device):
        rc = _lib().star_pointwise_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(),
            weights.data_ptr(), r, Z, Y, X, bx, by, bz, fx, fy, fz,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "star_pointwise")
    LAUNCHES["star_pointwise"] += 1
    return out


def zmarch_smem_bytes(r: int, ty: int, tx: int, elem_bytes: int) -> int:
    """Shared memory of the (2r+1)-plane ring of (ty+2r) x (tx+2r) elements
    plus the 6r+1 staged weights."""
    return ((2 * r + 1) * (ty + 2 * r) * (tx + 2 * r) + 6 * r + 1) * elem_bytes


def zmarch_threads(r: int, ty: int, tx: int) -> int:
    """Threads of a z-march block: one for every two outputs of the tile,
    more when the halo plane needs them (each thread stages
    ZMARCH_PREFETCH elements of it), in whole warps."""
    plane = (ty + 2 * r) * (tx + 2 * r)
    want = max(-(-ty * tx // 2), -(-plane // ZMARCH_PREFETCH))
    return -(-want // 32) * 32


def _zmarch_fits(r: int, ty: int, tx: int, elem_bytes: int) -> bool:
    return (zmarch_smem_bytes(r, ty, tx, elem_bytes) <= SMEM_PER_BLOCK
            and zmarch_threads(r, ty, tx) <= 1024)


def ring_tile(r: int, elem_bytes: int) -> tuple:
    """(TY, TX) of the ring variant; ValueError when its ring does not fit."""
    ty, tx = RING_TILE
    if not _zmarch_fits(r, ty, tx, elem_bytes):
        raise ValueError(
            f"ring tile {ty}x{tx} at r={r} needs "
            f"{zmarch_smem_bytes(r, ty, tx, elem_bytes)} B of shared memory, "
            f"more than the {SMEM_PER_BLOCK} B a block can use")
    return ty, tx


def ytile_tile(r: int, ty: int, elem_bytes: int) -> tuple:
    """(TY, TX) of ``ytile_ring(ty)``: the widest TX whose ring fits in one
    block's shared memory (capacity takes the place of the TPU's VMEM
    layer condition); ValueError when none does."""
    for tx in YTILE_TX:
        if _zmarch_fits(r, ty, tx, elem_bytes):
            return ty, tx
    raise ValueError(
        f"no y-tile of {ty} rows fits a (2r+1)-plane ring at r={r} in "
        f"{SMEM_PER_BLOCK} B of shared memory")


def star_zmarch(src_padded: torch.Tensor, weights: torch.Tensor, r: int,
                ty: int, tx: int) -> torch.Tensor:
    """Range-r star stencil marching over z with a shared-memory ring of
    2r+1 planes per ty x tx output tile."""
    Z, Y, X = _check(src_padded, weights, r)
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    if not _zmarch_fits(r, ty, tx, src_padded.element_size()):
        raise ValueError(
            f"tile {ty}x{tx} at r={r} needs "
            f"{zmarch_smem_bytes(r, ty, tx, src_padded.element_size())} B of shared "
            f"memory and {zmarch_threads(r, ty, tx)} threads")
    if -(-Y // ty) > _GRID_YZ_MAX:
        raise ValueError(f"{-(-Y // ty)} y-tiles exceed CUDA's y grid limit")
    if src_padded.device.type == "cpu":
        return star_stencil_ref(src_padded, weights, r)
    threads = zmarch_threads(r, ty, tx)
    out = torch.empty((Z, Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(src_padded.device):
        rc = _lib().star_zmarch_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(),
            weights.data_ptr(), r, Z, Y, X, ty, tx, threads,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "star_zmarch")
    LAUNCHES["star_zmarch"] += 1
    return out
