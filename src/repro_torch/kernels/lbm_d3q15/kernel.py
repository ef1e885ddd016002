"""Wrappers of the hand-written CUDA D3Q15 LBM kernels
(``repro_torch/csrc/lbm_d3q15.cu``).

* ``lbm_pointwise`` — the per-point kernel the GPU estimator prices, at a
  ``LaunchConfig`` (thread block x thread folding).  Replaces the TPU's
  ``make_replane``.
* ``lbm_ytile`` — z-marching kernel over ty x tx output tiles with a
  3-plane shared-memory ring of the phase field.  Replaces
  ``make_ytile(ty)`` (``ytile_tile`` picks tx).

Both take the halo-1 padded PDFs (15, Z+2, Y+2, X+2) and phase field
(Z+2, Y+2, X+2) and return the new PDFs (15, Z, Y, X).  On a CPU tensor they
compute the plain version (``ref.lbm_step_ref``); on a CUDA tensor they
launch the kernel on the current stream or raise.  ``LAUNCHES`` counts
kernel launches per wrapper, and ``LAST_LAUNCH`` holds the launch
(``LaunchConfig``, or the (ty, tx) tile) each wrapper last ran on the card.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.access import LaunchConfig
from repro_torch.kernels import SMEM_PER_BLOCK, _build
from repro_torch.kernels.lbm_d3q15.ref import lbm_step_ref

LAUNCHES = {"lbm_pointwise": 0, "lbm_ytile": 0}
LAST_LAUNCH = {"lbm_pointwise": None, "lbm_ytile": None}

YTILE_TX = (256, 128, 64, 32, 16, 8, 4, 2, 1)  # tx choices of lbm_ytile, widest first
# the z range of lbm_ytile is cut into slabs until the grid has at least this
# many CTAs for each SM of the card it launches on
YTILE_CTAS_PER_SM = 4
_GRID_YZ_MAX = 65_535

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIGNATURES = {
    "lbm_pointwise_launch": [_I, _P, _P, _P] + [_I] * 9 + [_D, _D, _P],
    "lbm_ytile_launch": [_I, _P, _P, _P] + [_I] * 6 + [_D, _D, _P],
}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
        LAST_LAUNCH[k] = None


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library with every entry point's C signature declared."""
    lib = _build.load("lbm_d3q15")
    for fn, argtypes in _SIGNATURES.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    lib.lbm_error_string.argtypes = [ctypes.c_int]
    lib.lbm_error_string.restype = ctypes.c_char_p
    return lib


def _check(pdf_p: torch.Tensor, phase_p: torch.Tensor) -> tuple:
    """Validate the operands; return the output domain (Z, Y, X)."""
    if not isinstance(pdf_p, torch.Tensor) or not isinstance(phase_p, torch.Tensor):
        raise TypeError("pdf_p and phase_p must be torch tensors")
    if pdf_p.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {pdf_p.device}")
    if pdf_p.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {pdf_p.dtype}")
    if phase_p.dtype != pdf_p.dtype or phase_p.device != pdf_p.device:
        raise ValueError("phase_p must have the dtype and device of pdf_p")
    if pdf_p.dim() != 4 or pdf_p.shape[0] != 15 or tuple(pdf_p.shape[1:]) != tuple(phase_p.shape):
        raise ValueError(
            f"expected PDFs (15, Z+2, Y+2, X+2) and a phase field (Z+2, Y+2, X+2), "
            f"got {tuple(pdf_p.shape)} and {tuple(phase_p.shape)}")
    if not (pdf_p.is_contiguous() and phase_p.is_contiguous()):
        raise ValueError("pdf_p and phase_p must be contiguous")
    domain = tuple(n - 2 for n in phase_p.shape)
    if min(domain) < 1:
        raise ValueError(f"padded shape {tuple(phase_p.shape)} is smaller than its halo of 1")
    if pdf_p.numel() >= 2**31:
        raise ValueError("fields of 2**31 elements or more are not supported")
    return domain


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().lbm_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def lbm_pointwise(pdf_p: torch.Tensor, phase_p: torch.Tensor, launch: LaunchConfig,
                  tau: float = 0.8, kappa: float = 0.15) -> torch.Tensor:
    """One LBM step, one thread per (point x fold iteration) at ``launch``
    (the mapping of ``core.gridwalk.block_points``)."""
    Z, Y, X = _check(pdf_p, phase_p)
    (bx, by, bz), (fx, fy, fz) = launch.block, launch.folding
    if min(bx, by, bz, fx, fy, fz) < 1 or launch.threads > 1024 or bz > 64:
        raise ValueError(f"launch {launch} is not a valid CUDA block")
    gx, gy, gz = launch.grid_for((Z, Y, X))
    if gy > _GRID_YZ_MAX or gz > _GRID_YZ_MAX:
        raise ValueError(f"grid {(gx, gy, gz)} exceeds CUDA's y/z grid limit")
    if pdf_p.device.type == "cpu":
        return lbm_step_ref(pdf_p, phase_p, tau, kappa)[0]
    out = torch.empty((15, Z, Y, X), dtype=pdf_p.dtype, device=pdf_p.device)
    with torch.cuda.device(pdf_p.device):
        rc = _lib().lbm_pointwise_launch(
            pdf_p.element_size(), pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(),
            Z, Y, X, bx, by, bz, fx, fy, fz, tau, kappa,
            torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lbm_pointwise")
    LAUNCHES["lbm_pointwise"] += 1
    LAST_LAUNCH["lbm_pointwise"] = launch
    return out


def ytile_smem_bytes(ty: int, tx: int, elem_bytes: int) -> int:
    """Shared memory of the 3-plane phase ring of (ty+2) x (tx+2) elements."""
    return 3 * (ty + 2) * (tx + 2) * elem_bytes


def ytile_tile(ty: int, elem_bytes: int) -> tuple:
    """(TY, TX) of ``lbm_ytile(ty)``: the widest TX whose phase ring fits in
    one block's shared memory (capacity takes the place of the TPU's VMEM
    layer condition); ValueError when none does."""
    for tx in YTILE_TX:
        if ytile_smem_bytes(ty, tx, elem_bytes) <= SMEM_PER_BLOCK:
            return ty, tx
    raise ValueError(
        f"no y-tile of {ty} rows fits a 3-plane phase ring in "
        f"{SMEM_PER_BLOCK} B of shared memory")


def ytile_slab(domain: tuple, ty: int, tx: int, sms: int) -> int:
    """Planes of the z slab each ``lbm_ytile`` CTA marches over: the deepest
    slab that still gives at least ``YTILE_CTAS_PER_SM`` CTAs for each of the
    card's ``sms`` SMs (or one plane)."""
    Z, Y, X = domain
    tiles = (-(-Y // ty)) * (-(-X // tx))
    return max(1, Z // -(-(YTILE_CTAS_PER_SM * sms) // tiles))


def lbm_ytile(pdf_p: torch.Tensor, phase_p: torch.Tensor, ty: int, tx: int,
              tau: float = 0.8, kappa: float = 0.15) -> torch.Tensor:
    """One LBM step marching over z with a 3-plane shared-memory ring of the
    phase field per ty x tx output tile."""
    Z, Y, X = _check(pdf_p, phase_p)
    if ty < 1 or tx < 1:
        raise ValueError(f"tile {ty}x{tx} is empty")
    if ytile_smem_bytes(ty, tx, pdf_p.element_size()) > SMEM_PER_BLOCK:
        raise ValueError(
            f"tile {ty}x{tx} needs {ytile_smem_bytes(ty, tx, pdf_p.element_size())} B "
            f"of shared memory, more than the {SMEM_PER_BLOCK} B a block can use")
    if -(-Y // ty) > _GRID_YZ_MAX:
        raise ValueError(f"{-(-Y // ty)} y-tiles exceed CUDA's y grid limit")
    if pdf_p.device.type == "cpu":
        return lbm_step_ref(pdf_p, phase_p, tau, kappa)[0]
    sms = torch.cuda.get_device_properties(pdf_p.device).multi_processor_count
    zs = ytile_slab((Z, Y, X), ty, tx, sms)
    out = torch.empty((15, Z, Y, X), dtype=pdf_p.dtype, device=pdf_p.device)
    with torch.cuda.device(pdf_p.device):
        rc = _lib().lbm_ytile_launch(
            pdf_p.element_size(), pdf_p.data_ptr(), phase_p.data_ptr(), out.data_ptr(),
            Z, Y, X, ty, tx, zs, tau, kappa, torch.cuda.current_stream().cuda_stream)
    _raise_on(rc, "lbm_ytile")
    LAUNCHES["lbm_ytile"] += 1
    LAST_LAUNCH["lbm_ytile"] = (ty, tx)
    return out
