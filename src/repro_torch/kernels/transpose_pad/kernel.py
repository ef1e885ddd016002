"""Wrappers of the hand-written CUDA transpose kernels
(``repro_torch/csrc/transpose_pad.cu``).

* ``transpose_pointwise`` — the per-point kernel the GPU estimator prices,
  at a ``LaunchConfig`` (thread block x thread folding) on the output
  domain (1, N, M).
* ``transpose_tiled`` — one CTA per (bm, bn) block, moved through shared
  memory in 32 x 33 sub-tiles.  Replaces the TPU's
  ``make_transpose(M, N, bm, bn)``; it masks the edges, so the operand
  needs no padding to tile multiples.

Both take a contiguous (M, N) tensor of any dtype of 1, 2, 4 or 8 bytes and
return its (N, M) transpose.  On a CPU tensor they compute the plain
version (``ref.transpose_ref``); on a CUDA tensor they launch the kernel on
the current stream or raise.  ``LAUNCHES`` counts kernel launches per
wrapper, and ``LAST_LAUNCH`` holds the launch (``LaunchConfig``, or the
(bm, bn) tile) each wrapper last ran on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import _build
from repro_torch.kernels.transpose_pad.ref import transpose_ref

LAUNCHES = {"transpose_pointwise": 0, "transpose_tiled": 0}
LAST_LAUNCH = {"transpose_pointwise": None, "transpose_tiled": None}

_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIGNATURES = {
    "transpose_pointwise_launch": [_I, _P, _P] + [_I] * 8 + [_P],
    "transpose_tiled_launch": [_I, _P, _P] + [_I] * 4 + [_P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("transpose_pad")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.transpose_error_string.argtypes = [ctypes.c_int]
    lib.transpose_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor) -> tuple:
    """Validate the operand; return its shape (M, N)."""
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch tensor")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.element_size() not in (1, 2, 4, 8):
        raise TypeError(f"elements of 1, 2, 4 or 8 bytes only, got {x.dtype}")
    if x.dim() != 2 or min(x.shape) < 1:
        raise ValueError(f"expected a non-empty (M, N) tensor, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    return tuple(x.shape)


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().transpose_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def transpose_pointwise(x: torch.Tensor, launch: LaunchConfig) -> torch.Tensor:
    """The transpose, one thread per (output point x fold iteration) at
    ``launch`` (the mapping of ``core.gridwalk.block_points`` on (1, N, M))."""
    M, N = _check(x)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((N, M))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if x.device.type == "cpu":
        return transpose_ref(x)
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().transpose_pointwise_launch(
            x.element_size(), x.data_ptr(), out.data_ptr(), M, N, bx, by, bz, fx, fy, fz,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "transpose_pointwise")
    LAUNCHES["transpose_pointwise"] += 1
    LAST_LAUNCH["transpose_pointwise"] = launch
    return out


def transpose_tiled(x: torch.Tensor, bm: int, bn: int) -> torch.Tensor:
    """The transpose, one CTA per (bm, bn) block of ``x``, through shared
    memory in 32 x 33 sub-tiles."""
    M, N = _check(x)
    if bm < 1 or bn < 1:
        raise ValueError(f"tile {bm}x{bn} is empty")
    if -(-M // bm) > _GRID_YZ_MAX:
        raise ValueError(f"{-(-M // bm)} row blocks exceed CUDA's y grid limit")
    if x.device.type == "cpu":
        return transpose_ref(x)
    out = torch.empty((N, M), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        rc = _lib().transpose_tiled_launch(
            x.element_size(), x.data_ptr(), out.data_ptr(), M, N, bm, bn,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "transpose_tiled")
    LAUNCHES["transpose_tiled"] += 1
    LAST_LAUNCH["transpose_tiled"] = (bm, bn)
    return out
