"""Wrapper of the hand-written CUDA GEMM (``repro_torch/csrc/matmul.cu``).

``matmul_tiled(a, b, bm, bn, bk)`` computes ``a @ b`` with one CTA per
(bm, bn) output tile walking K in bk slabs through shared memory, an fp32
accumulator in registers and the result cast to the inputs' dtype: bf16 on
the tensor cores (``mma.sync``), fp32 on the CUDA cores.  Replaces the TPU's
``make_matmul(M, K, N, bm, bk, bn)``; the tiles are the kernel's own
(``TILES``), and the edges are masked, so no dimension needs to be a tile
multiple.  The 16-byte loads need K and N to be multiples of 16 bytes' worth
of elements and 16-byte aligned operands.

On CPU tensors it computes the plain version (``ref.matmul_ref``); on CUDA
tensors it launches the kernel on the current stream or raises.
``LAUNCHES`` counts kernel launches, and ``LAST_LAUNCH`` holds the
(bm, bn, bk) tile it last ran on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref

LAUNCHES = {"matmul_tiled": 0}
LAST_LAUNCH = {"matmul_tiled": None}

# the instantiated CTA tiles (bm, bn, bk) per element size: bf16 on the
# tensor cores, fp32 on the CUDA cores
TILES = {
    2: ((128, 128, 32), (128, 256, 32)),
    4: ((128, 128, 16),),
}
KERNEL_DTYPES = (torch.bfloat16, torch.float32)
_GRID_Y_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("matmul")
    lib.matmul_tiled_launch.argtypes = [_I, _P, _P, _P] + [_I] * 6 + [_P]
    lib.matmul_tiled_launch.restype = ctypes.c_int
    lib.matmul_error_string.argtypes = [ctypes.c_int]
    lib.matmul_error_string.restype = ctypes.c_char_p
    return lib


def vector_width(elem_bytes: int) -> int:
    """Elements of one 16-byte load: K and N must be multiples of it."""
    return 16 // elem_bytes


def _check(a: torch.Tensor, b: torch.Tensor, tile: tuple) -> tuple:
    """Validate the operands and the tile; return (M, K, N)."""
    if not isinstance(a, torch.Tensor) or not isinstance(b, torch.Tensor):
        raise TypeError("a and b must be torch tensors")
    if a.dtype != b.dtype or a.dtype not in KERNEL_DTYPES:
        raise TypeError(f"a and b must both be bfloat16 or float32, got {a.dtype}, {b.dtype}")
    if a.device != b.device or a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"a and b must lie on one CPU or CUDA device, got {a.device}, {b.device}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0] or min(*a.shape, b.shape[1]) < 1:
        raise ValueError(f"expected non-empty (M, K) and (K, N), got {tuple(a.shape)}, "
                         f"{tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    eb = a.element_size()
    if tile not in TILES[eb]:
        raise ValueError(f"tile {tile} is not instantiated for {a.dtype}; choose from {TILES[eb]}")
    (M, K), N = a.shape, b.shape[1]
    vec = vector_width(eb)
    if K % vec or N % vec:
        raise ValueError(f"K={K} and N={N} must be multiples of {vec} for {a.dtype}")
    if -(-M // tile[0]) > _GRID_Y_MAX:
        raise ValueError(f"{-(-M // tile[0])} row tiles exceed CUDA's y grid limit")
    return M, K, N


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int) -> torch.Tensor:
    """``a @ b`` (fp32 accumulation, cast to the inputs' dtype), one CTA per
    (bm, bn) tile of the output."""
    tile = (int(bm), int(bn), int(bk))
    M, K, N = _check(a, b, tile)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().matmul_tiled_launch(
            a.element_size(), a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, *tile,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        msg = _lib().matmul_error_string(rc).decode()
        raise RuntimeError(f"matmul_tiled launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["matmul_tiled"] += 1
    LAST_LAUNCH["matmul_tiled"] = tile
    return out
