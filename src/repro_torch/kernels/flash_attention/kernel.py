"""Wrappers of the hand-written CUDA attention kernels
(``repro_torch/csrc/flash_attention.cu``).

* ``flash_attention_fwd(q, k, v, bq, bk, causal)`` — the causal GQA
  forward with online softmax, one CTA per (b·Hq + h, q block of bq rows)
  streaming KV blocks of bk rows.  Replaces the TPU's
  ``make_flash_attention(B, Hq, Hkv, Sq, Skv, D, bq, bk, causal)``; bq | Sq
  and bk | Skv, as there.  bf16 runs on the tensor cores (``mma.sync``), fp32
  on the CUDA cores.
* ``flash_decode(q, k, v, bk)`` — one query token against the KV cache,
  one CTA per (b, KV head) and up to 8 of its query heads, over blocks of
  bk keys.  Replaces ``make_flash_decode(B, Hq, Hkv, Skv, D, bk)``.

q is (B, Hq, Sq, D) (Sq = 1 for decode), k and v (B, Hkv, Skv, D), all
contiguous and of one dtype; Hkv divides Hq.  On CPU tensors both compute
the plain version (``ref.attention_ref``); on CUDA tensors they launch the
kernel on the current stream or raise.  ``LAUNCHES`` counts kernel
launches per wrapper, and ``LAST_LAUNCH`` holds what each last ran on the
card: ``(bq, bk, causal)`` and ``bk``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import attention_ref

LAUNCHES = {"flash_attention_fwd": 0, "flash_decode": 0}
LAST_LAUNCH = {"flash_attention_fwd": None, "flash_decode": None}

# the instantiated forward kernels: (bq, bk) tiles, and head dims per dtype
FWD_TILES = ((128, 128), (64, 64))
FWD_HEAD_DIMS = {torch.bfloat16: (32, 64, 128), torch.float32: (32, 64)}
DECODE_HEAD_DIMS = (32, 64, 128)
DECODE_BK_MAX = 2048          # keys of a block's scores in shared memory
_GRID_Y_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("flash_attention")
    lib.flash_fwd_launch.argtypes = [_I, _P, _P, _P, _P] + [_I] * 8 + [_F, _I, _P]
    lib.flash_decode_launch.argtypes = [_I, _P, _P, _P, _P] + [_I] * 6 + [_F, _P]
    for fn in (lib.flash_fwd_launch, lib.flash_decode_launch):
        fn.restype = ctypes.c_int
    lib.flash_error_string.argtypes = [ctypes.c_int]
    lib.flash_error_string.restype = ctypes.c_char_p
    return lib


def _check(q, k, v) -> tuple:
    """Validate the operands; return (B, Hq, Hkv, Sq, Skv, D)."""
    if not all(isinstance(t, torch.Tensor) for t in (q, k, v)):
        raise TypeError("q, k and v must be torch tensors")
    if q.dtype not in FWD_HEAD_DIMS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must all be bfloat16 or float32, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if len({q.device, k.device, v.device}) != 1 or q.device.type not in ("cpu", "cuda"):
        raise ValueError("q, k and v must lie on one CPU or CUDA device")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"expected q (B, Hq, Sq, D) and k, v (B, Hkv, Skv, D), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    if k.shape[0] != B or k.shape[3] != D or min(B, Hq, Sq, D, Hkv, Skv) < 1 or Hq % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k, v {tuple(k.shape)} do not match "
                         "(same B and D, Hkv dividing Hq)")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("q, k and v must be contiguous")
    return B, Hq, Hkv, Sq, Skv, D


def _aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("q, k and v must be 16-byte aligned")


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().flash_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def flash_attention_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bq: int = 128,
                        bk: int = 128, causal: bool = True) -> torch.Tensor:
    """Causal (or full) GQA attention, (B, Hq, Sq, D), in q's dtype."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    bq, bk, causal = int(bq), int(bk), bool(causal)
    if Sq % bq or Skv % bk:
        raise ValueError(f"bq={bq} must divide Sq={Sq} and bk={bk} Skv={Skv}")
    if (bq, bk) not in FWD_TILES:
        raise ValueError(f"(bq, bk) = {(bq, bk)} is not instantiated; choose from {FWD_TILES}")
    if D not in FWD_HEAD_DIMS[q.dtype]:
        raise ValueError(f"head dim {D} is not instantiated for {q.dtype}; "
                         f"choose from {FWD_HEAD_DIMS[q.dtype]}")
    if Sq // bq > _GRID_Y_MAX:
        raise ValueError(f"{Sq // bq} q blocks exceed CUDA's y grid limit")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal)
    _aligned(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().flash_fwd_launch(
            q.element_size(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Sq, Skv, D, bq, bk, D ** -0.5, int(causal),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_attention_fwd")
    LAUNCHES["flash_attention_fwd"] += 1
    LAST_LAUNCH["flash_attention_fwd"] = (bq, bk, causal)
    return out


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bk: int = 128) -> torch.Tensor:
    """One query token (B, Hq, 1, D) against the whole cache (no mask)."""
    B, Hq, Hkv, Sq, Skv, D = _check(q, k, v)
    bk = int(bk)
    if Sq != 1:
        raise ValueError(f"flash_decode takes one query token, got Sq={Sq}")
    if bk < 64 or bk % 64 or bk > DECODE_BK_MAX or Skv % bk:
        raise ValueError(f"bk={bk} must be a multiple of 64 up to {DECODE_BK_MAX} "
                         f"that divides Skv={Skv}")
    if D not in DECODE_HEAD_DIMS:
        raise ValueError(f"head dim {D} is not instantiated; choose from {DECODE_HEAD_DIMS}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=False)
    _aligned(q, k, v)
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = _lib().flash_decode_launch(
            q.element_size(), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, Hq, Hkv, Skv, D, bk, D ** -0.5, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "flash_decode")
    LAUNCHES["flash_decode"] += 1
    LAST_LAUNCH["flash_decode"] = bk
    return out
