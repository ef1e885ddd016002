"""Kernel packages of the port + the generator entry-point registry.

Mirrors ``repro.kernels``: every kernel package couples a code generator to
the estimator through ``<package>.generator``; ``get_generator`` resolves it
lazily by name.
"""
from __future__ import annotations

import importlib

import torch

# name -> generator module; extend when porting a kernel package
GENERATOR_MODULES = {
    "stencil3d25": "repro_torch.kernels.stencil3d25.generator",
    "lbm_d3q15": "repro_torch.kernels.lbm_d3q15.generator",
    "jacobi2d": "repro_torch.kernels.jacobi2d.generator",
    "transpose_pad": "repro_torch.kernels.transpose_pad.generator",
    "matmul": "repro_torch.kernels.matmul.generator",
    "flash_attention": "repro_torch.kernels.flash_attention.generator",
}

# why a generator's shared-memory variants (z-march rings, y-tiles, tiles)
# sit in a ranking's ``.skipped``
SCRATCH_REASON = (
    "scratch-staged kernel: it stages planes or tiles through shared memory, "
    "and the GPU model prices per-point kernels only (DESIGN §9 rejects "
    "scratch-staged kernels for the GPU target); runnable through a pinned "
    "config")

# why the matmul and flash-attention generators list the TPU's decisions
# in ``.skipped`` (``tpu_skipped``) and rank nothing
TPU_REASON = (
    "VMEM block size of the TPU's Pallas kernel: the GPU model has no "
    "tensor-core term and prices per-point kernels only (DESIGN §8/§9), so "
    "it ranks neither these nor the CUDA kernel's tiles; the CUDA kernel "
    "runs at its pinned default tile")

# dynamic shared memory one block may opt into on Hopper (227 KB)
SMEM_PER_BLOCK = 232_448

_DTYPES = {1: torch.int8, 2: torch.bfloat16, 4: torch.float32, 8: torch.float64}


def pow2_tiles(lo: int, hi: int) -> list[int]:
    """Powers of two from ``lo`` up to ``hi`` (the TPU generators' block
    sizes; a copy of ``repro.core.tpu_adapt.pow2_tiles``)."""
    out = []
    t = lo
    while t <= hi:
        out.append(t)
        t *= 2
    return out


def tpu_skipped(space) -> list:
    """The TPU's block decisions ``space`` (a generator's ``tpu_space``) as
    ``SkippedConfig`` entries with ``TPU_REASON``."""
    from repro_torch.core.selector import SkippedConfig

    return [SkippedConfig(cfg, TPU_REASON) for cfg in space]


def available_generators() -> list[str]:
    return sorted(GENERATOR_MODULES)


def get_generator(name: str):
    """Import the named kernel package's generator module."""
    if name not in GENERATOR_MODULES:
        raise KeyError(
            f"unknown kernel generator {name!r}; "
            f"choose from {available_generators()}"
        )
    return importlib.import_module(GENERATOR_MODULES[name])


def dtype_for(elem_bytes: int) -> torch.dtype:
    """The torch dtype a generator's ``elem_bytes`` parameter denotes (the
    same byte table as ``repro.kernels.dtype_for``)."""
    if elem_bytes not in _DTYPES:
        raise ValueError(
            f"unsupported elem_bytes {elem_bytes}; "
            f"choose from {sorted(_DTYPES)}")
    return _DTYPES[elem_bytes]


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  A CUDA device without a card raises; nothing falls back."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions")
    return dev
