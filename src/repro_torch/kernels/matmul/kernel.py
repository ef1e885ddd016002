"""Wrapper of the hand-written CUDA GEMM (``repro_torch/csrc/matmul.cu``).

``matmul_tiled(a, b, bm, bn, bk)`` computes ``a @ b`` with an fp32
accumulator in registers and the result cast to the inputs' dtype, on
Hopper's tensor cores through wgmma: persistent CTAs, one per SM, walk the
(bm, bn) output tiles; in each, a producer warp keeps TMA copies of
bk-deep slabs in flight through a ring in shared memory and two consumer
warpgroups multiply them.  bf16 takes one pass (route ``"wgmma"``).  fp32
takes three TF32 passes (route ``"split_tf32"``): ``split_b`` writes B^T as
its TF32 hi and lo parts, and ``split_tf32_gemm`` sums a_lo b_hi + a_hi b_lo
+ a_hi b_hi, splitting A in registers, which keeps fp32's accuracy.  The
fp32 CUDA-core kernel it replaced stays in the library, reached only by
the ablation through ``matmul_tiled_launch``.  Replaces the TPU's
``make_matmul(M, K, N, bm, bk, bn)``; the tiles are the kernel's own
(``TILES``), and the edges are masked (TMA zero-fills the loads and clips
the stores), so no dimension needs to be a tile multiple.  The 16-byte
global strides of TMA need K and N to be multiples of 16 bytes' worth of
elements and 16-byte aligned operands.

On CPU tensors each wrapper computes its plain version (``ref.matmul_ref``
for ``matmul_tiled``); on CUDA tensors it launches its kernel on the
current stream or raises.  ``LAUNCHES`` counts kernel launches, and
``LAST_LAUNCH`` holds the (route, (bm, bn, bk)) that ``matmul_tiled`` last
ran on the card and the (K, N) that ``split_b`` last split.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.matmul.ref import matmul_ref, matmul_split_parts_ref, split_tf32

LAUNCHES = {"matmul_tiled": 0, "matmul_split_b": 0}
LAST_LAUNCH = {"matmul_tiled": None, "matmul_split_b": None}

# the instantiated CTA tiles (bm, bn, bk) of the tensor-core routes per
# element size: bf16 one wgmma pass, fp32 three TF32 passes (split_tf32),
# whose slab sums need a second accumulator: no room for a 256-wide tile
TILES = {
    2: ((128, 256, 64), (128, 128, 64)),
    4: ((128, 128, 32),),
}
ROUTE = {2: "wgmma", 4: "split_tf32"}  # element size -> the kernel matmul_tiled runs
KERNEL_DTYPES = (torch.bfloat16, torch.float32)

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
    lib.matmul_split_b_launch.argtypes = [_P, _P, _P, _I, _I, _P]
    lib.matmul_split_b_launch.restype = ctypes.c_int
    lib.matmul_split_tf32_launch.argtypes = [_P] * 4 + [_I] * 6 + [_P]
    lib.matmul_split_tf32_launch.restype = ctypes.c_int
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
    return M, K, N


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().matmul_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _f32_matrix(x, name: str) -> None:
    if not isinstance(x, torch.Tensor) or x.dtype != torch.float32 or x.dim() != 2 \
            or not x.is_contiguous() or x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} must be a contiguous 2-D float32 tensor on the CPU or a CUDA "
                         f"device")
    if x.device.type == "cuda" and x.data_ptr() % 16:
        raise ValueError(f"{name} must be 16-byte aligned")


def split_b(b: torch.Tensor) -> tuple:
    """B (K, N) fp32 -> (hi, lo), each (N, K): B^T split into its TF32 parts,
    hi = tf32(b) and lo = tf32(b - hi), rounded to nearest, ties away from
    zero (``ref.split_tf32``)."""
    _f32_matrix(b, "b")
    K, N = b.shape
    if b.device.type == "cpu":
        return split_tf32(b.mT)
    hi = torch.empty((N, K), dtype=b.dtype, device=b.device)
    lo = torch.empty_like(hi)
    with torch.cuda.device(b.device):
        rc = _lib().matmul_split_b_launch(b.data_ptr(), hi.data_ptr(), lo.data_ptr(), K, N,
                                          torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "matmul_split_b")
    LAUNCHES["matmul_split_b"] += 1
    LAST_LAUNCH["matmul_split_b"] = (K, N)
    return hi, lo


def split_tf32_gemm(a: torch.Tensor, b_hi: torch.Tensor, b_lo: torch.Tensor,
                    tile: tuple) -> torch.Tensor:
    """``a @ b`` in fp32 from ``split_b(b)``'s parts, in three TF32 passes
    at ``tile`` (one of ``TILES[4]``); the plain version on the CPU is
    ``ref.matmul_split_parts_ref``."""
    for x, name in ((a, "a"), (b_hi, "b_hi"), (b_lo, "b_lo")):
        _f32_matrix(x, name)
    tile = tuple(int(t) for t in tile)
    if tile not in TILES[4]:
        raise ValueError(f"tile {tile} is not instantiated for torch.float32; choose from "
                         f"{TILES[4]}")
    (M, K), N = a.shape, b_hi.shape[0]
    if b_hi.shape != (N, K) or b_lo.shape != (N, K) or not (a.device == b_hi.device == b_lo.device):
        raise ValueError(f"expected a (M, K) and b_hi, b_lo (N, K) on one device, got "
                         f"{tuple(a.shape)}, {tuple(b_hi.shape)}, {tuple(b_lo.shape)}")
    if K % 4 or N % 4:
        raise ValueError(f"K={K} and N={N} must be multiples of 4 for torch.float32")
    if a.device.type == "cpu":
        return matmul_split_parts_ref(a, b_hi, b_lo)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().matmul_split_tf32_launch(
            a.data_ptr(), b_hi.data_ptr(), b_lo.data_ptr(), out.data_ptr(), M, N, K, *tile,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "matmul_split_tf32")
    LAUNCHES["matmul_tiled"] += 1
    LAST_LAUNCH["matmul_tiled"] = (ROUTE[4], tile)
    return out


def matmul_tiled(a: torch.Tensor, b: torch.Tensor, bm: int, bn: int, bk: int) -> torch.Tensor:
    """``a @ b`` (fp32 accumulation, cast to the inputs' dtype) in (bm, bn)
    tiles of the output: bf16 in one wgmma pass, fp32 as ``split_b`` and
    ``split_tf32_gemm``."""
    tile = (int(bm), int(bn), int(bk))
    M, K, N = _check(a, b, tile)
    if a.device.type == "cpu":
        return matmul_ref(a, b)
    if a.data_ptr() % 16 or b.data_ptr() % 16:
        raise ValueError("a and b must be 16-byte aligned")
    if a.dtype == torch.float32:
        return split_tf32_gemm(a, *split_b(b), tile)
    out = torch.empty((M, N), dtype=a.dtype, device=a.device)
    with torch.cuda.device(a.device):
        rc = _lib().matmul_tiled_launch(
            a.element_size(), a.data_ptr(), b.data_ptr(), out.data_ptr(), M, N, K, *tile,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "matmul_tiled")
    LAUNCHES["matmul_tiled"] += 1
    LAST_LAUNCH["matmul_tiled"] = (ROUTE[2], tile)
    return out
