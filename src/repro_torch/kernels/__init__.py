"""Kernel packages of the port + the generator entry-point registry.

Mirrors ``repro.kernels``: every kernel package couples a code generator to
the estimator through ``<package>.generator``; ``get_generator`` resolves it
lazily by name.
"""
from __future__ import annotations

import importlib

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

# why the 2D generators (jacobi2d, transpose_pad) list the launches deeper
# than their domain in ``.skipped`` (``flat_launches``)
DEPTH_REASON = (
    "launch deeper than the domain: a 2D domain reads as (1, Y, X), so of a "
    "launch whose z extent bz·fz exceeds 1 only the z = 0 threads and fold "
    "steps get a point, while the GPU model prices the whole block as busy "
    "(core.gridwalk.block_points); runnable through a pinned config")

# why the matmul and flash-attention generators list the TPU's decisions
# in ``.skipped`` (``tpu_skipped``) and rank nothing
TPU_REASON = (
    "VMEM block size of the TPU's Pallas kernel: the GPU model has no "
    "tensor-core term and prices per-point kernels only (DESIGN §8/§9), so "
    "it ranks neither these nor the CUDA kernel's tiles; the CUDA kernel "
    "runs at its pinned default tile")

# dynamic shared memory one block may opt into on Hopper (227 KB)
SMEM_PER_BLOCK = 232_448

# elem_bytes -> torch dtype name; ``dtype_for`` maps it when called, so
# importing this package (the pricing daemon does) loads no torch
_DTYPES = {1: "int8", 2: "bfloat16", 4: "float32", 8: "float64"}


def tpu_skipped(space) -> list:
    """The TPU's block decisions ``space`` (a generator's ``tpu_space``) as
    ``SkippedConfig`` entries with ``TPU_REASON``; they belong to no GPU
    workload or machine, so both names are empty."""
    from repro_torch.core.selector import SkippedConfig

    return [SkippedConfig("", "", cfg, TPU_REASON) for cfg in space]


def fills_depth(launch) -> bool:
    """Whether every thread and fold step of ``launch`` has a point of a 2D
    domain (1, Y, X): its z extent bz·fz is 1."""
    return launch.block[2] * launch.folding[2] == 1


def flat_launches(ranked):
    """The launches of a 2D ranking that fill the domain's depth, in their
    ranked order; the others go to ``.skipped`` with ``DEPTH_REASON``, after
    what was skipped already, as pinned configs ``{"block", "folding"}``."""
    from repro_torch.core.selector import RankingResult, SkippedConfig

    deep = [SkippedConfig(rc.estimate.kernel, rc.estimate.machine,
                          {"block": rc.launch.block, "folding": rc.launch.folding},
                          DEPTH_REASON)
            for rc in ranked if not fills_depth(rc.launch)]
    return RankingResult([rc for rc in ranked if fills_depth(rc.launch)],
                         ranked.report, ranked.skipped + deep)


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
    import torch

    return getattr(torch, _DTYPES[elem_bytes])


def raw_stream(index: int) -> int:
    """The handle of CUDA device ``index``'s current stream: what
    ``torch.cuda.current_stream(index).cuda_stream`` gives, without building
    a ``Stream`` object on every launch (host time that a single call on an
    idle card waits out before its kernel starts)."""
    import torch

    return torch._C._cuda_getCurrentRawStream(index)


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks for
    the CPU.  A CUDA device without a card raises; nothing falls back."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the plain versions")
    return dev
