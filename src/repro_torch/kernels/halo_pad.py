"""Wrapper of the hand-written CUDA zero-halo kernel
(``repro_torch/csrc/halo_pad.cu``).

``halo_pad(src, h)`` returns ``src`` with a zero halo of width ``h`` on each
side of its last three dims, any leading dims kept as they are: what
``torch.nn.functional.pad(src, (h,) * 6)`` returns.  It is the pad of the
entry points ``stencil3d25.ops.star_stencil`` and ``lbm_d3q15.ops.lbm_step``,
and replaces no TPU kernel: the JAX package pads with ``jnp.pad``.

On a CPU tensor it returns ``F.pad``'s result; on a CUDA tensor it launches
the kernel on the current stream, into an output from ``torch.empty``, or
raises.  ``src`` must be a contiguous float32 or float64 tensor of at least
three dims, none empty; anything else is refused on either device.  The
kernel writes each padded element once (``F.pad`` fills the whole output
with zeros, then copies the interior): one warp a padded row, loaded an
element at a time and stored in vectors of ``pad_vector`` elements.

``LAUNCHES`` counts launches on the card, as the ``obs`` counter group
``kernels.halo_pad.launches``; ``LAST_PAD`` records ``h``, the fields (the
product of the leading dims) and the vector of the last launch.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, raw_stream
from repro_torch.obs import metrics

LAUNCHES = metrics.CounterGroup("kernels.halo_pad.launches", {
    "halo_pad": "halo_pad kernels launched on the card",
})
LAST_PAD: dict = {}        # {"h", "fields", "vector"} of the last launch

_P = ctypes.c_void_p
_I = ctypes.c_int


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    LAST_PAD.clear()


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared."""
    lib = _build.load("halo_pad")
    lib.halo_pad_launch.argtypes = [_I, _P, _P] + [_I] * 6 + [_P]
    lib.halo_pad_launch.restype = ctypes.c_int
    lib.halo_pad_error_string.argtypes = [ctypes.c_int]
    lib.halo_pad_error_string.restype = ctypes.c_char_p
    return lib


def _check(src: torch.Tensor, h: int) -> tuple:
    """Validate the operand; return (fields, Z, Y, X)."""
    if not isinstance(src, torch.Tensor):
        raise TypeError("src must be a torch tensor")
    if src.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {src.device}")
    if src.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {src.dtype}")
    if src.dim() < 3 or min(src.shape) < 1:
        raise ValueError(f"expected a non-empty (..., Z, Y, X) field, got {tuple(src.shape)}")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if not isinstance(h, int) or h < 0:
        raise ValueError(f"halo width h must be an int >= 0, got {h!r}")
    Z, Y, X = src.shape[-3:]
    return math.prod(src.shape[:-3]), Z, Y, X


def pad_vector(X: int, h: int, elem_bytes: int, dst_ptr: int = 0) -> int:
    """Elements a store of a field with rows of ``X`` elements padded by
    ``h``: the widest store of 16, 8 or 4 bytes, and at least one element,
    that every padded row of X + 2h elements and the output's address take."""
    xp = X + 2 * h
    return next(v for v in (16 // elem_bytes, 8 // elem_bytes, 4 // elem_bytes)
                if v >= 1 and xp % v == 0 and dst_ptr % (v * elem_bytes) == 0)


def halo_pad(src: torch.Tensor, h: int) -> torch.Tensor:
    """``src`` (..., Z, Y, X) with a zero halo of width ``h`` around its last
    three dims: (..., Z+2h, Y+2h, X+2h), equal to ``F.pad(src, (h,) * 6)``."""
    fields, Z, Y, X = _check(src, h)
    if src.device.type == "cpu":
        return torch.nn.functional.pad(src, (h,) * 6)
    eb = src.element_size()
    out = torch.empty((*src.shape[:-3], Z + 2 * h, Y + 2 * h, X + 2 * h), dtype=src.dtype,
                      device=src.device)
    vec = pad_vector(X, h, eb, out.data_ptr())
    index = src.get_device()
    with torch.cuda.device(index):
        rc = _lib().halo_pad_launch(eb, src.data_ptr(), out.data_ptr(), fields, Z, Y, X, h, vec,
                                    raw_stream(index))
    if rc != 0:
        msg = _lib().halo_pad_error_string(rc).decode()
        raise RuntimeError(f"halo_pad launch failed: CUDA error {rc} ({msg})")
    LAUNCHES["halo_pad"] += 1
    LAST_PAD.clear()
    LAST_PAD.update(h=h, fields=fields, vector=vec)
    return out
