"""Wrappers of the hand-written CUDA Jacobi kernels
(``repro_torch/csrc/jacobi2d.cu``).

* ``jacobi_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding) on the domain (1, Y, X).
  Replaces the TPU's ``make_rowstream``.
* ``jacobi_ytile`` — one CTA per ty x tx output tile, its (ty+2) x (tx+2)
  inputs staged in shared memory.  Replaces ``make_ytile(ty)``
  (``ytile_tile`` picks tx).

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
from repro_torch.kernels import SMEM_PER_BLOCK, _build
from repro_torch.kernels.jacobi2d.ref import jacobi_padded_ref

LAUNCHES = {"jacobi_pointwise": 0, "jacobi_ytile": 0}
LAST_LAUNCH = {"jacobi_pointwise": None, "jacobi_ytile": None}

YTILE_TX = (256, 128, 64, 32, 16, 8, 4, 2, 1)  # tx choices of jacobi_ytile, widest first
YTILE_THREADS = 256
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "jacobi_pointwise_launch": [_I, _P, _P, _D, _D] + [_I] * 8 + [_P],
    "jacobi_ytile_launch": [_I, _P, _P, _D, _D] + [_I] * 5 + [_P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None


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


def jacobi_pointwise(src_padded: torch.Tensor, launch: LaunchConfig,
                     weights=(0.5, 0.125)) -> torch.Tensor:
    """One Jacobi sweep, one thread per (point x fold iteration) at
    ``launch`` (the mapping of ``core.gridwalk.block_points`` on (1, Y, X))."""
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
    with torch.cuda.device(src_padded.device):
        rc = _lib().jacobi_pointwise_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(), wc, wn,
            Y, X, bx, by, bz, fx, fy, fz, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "jacobi_pointwise")
    LAUNCHES["jacobi_pointwise"] += 1
    LAST_LAUNCH["jacobi_pointwise"] = launch
    return out


def ytile_smem_bytes(ty: int, tx: int, elem_bytes: int) -> int:
    """Shared memory of the staged (ty+2) x (tx+2) input tile."""
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


def jacobi_ytile(src_padded: torch.Tensor, ty: int, tx: int,
                 weights=(0.5, 0.125)) -> torch.Tensor:
    """One Jacobi sweep, one CTA per ty x tx output tile staged through
    shared memory."""
    (Y, X), (wc, wn) = _check(src_padded, weights)
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    if ytile_smem_bytes(ty, tx, src_padded.element_size()) > SMEM_PER_BLOCK:
        raise ValueError(
            f"tile {ty}x{tx} needs {ytile_smem_bytes(ty, tx, src_padded.element_size())} B "
            f"of shared memory, more than the {SMEM_PER_BLOCK} B a block can use")
    if -(-Y // ty) > _GRID_YZ_MAX:
        raise ValueError(f"{-(-Y // ty)} y-tiles exceed CUDA's y grid limit")
    if src_padded.device.type == "cpu":
        return jacobi_padded_ref(src_padded, (wc, wn))
    out = torch.empty((Y, X), dtype=src_padded.dtype, device=src_padded.device)
    with torch.cuda.device(src_padded.device):
        rc = _lib().jacobi_ytile_launch(
            src_padded.element_size(), src_padded.data_ptr(), out.data_ptr(), wc, wn,
            Y, X, ty, tx, YTILE_THREADS, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "jacobi_ytile")
    LAUNCHES["jacobi_ytile"] += 1
    LAST_LAUNCH["jacobi_ytile"] = (ty, tx)
    return out
