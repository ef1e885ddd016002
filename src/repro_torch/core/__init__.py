"""The GPU estimator path of ``repro.core``, copied for the port.

numpy-only, like the original; the port imports nothing of ``repro``.
"""
from .access import Access, Field, KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .machines import A100, A100_80G, H100, V100, GPUMachine
from .perfmodel import GPUEstimate, estimate_gpu
from .selector import (
    RankedConfig,
    RankingResult,
    SkippedConfig,
    enumerate_gpu_configs,
    rank_gpu_configs,
    ranking_quality,
)
from .specs import star_stencil_3d

__all__ = [
    "Access", "Field", "KernelSpec", "LaunchConfig", "CapacityModel",
    "A100", "A100_80G", "H100", "V100", "GPUMachine",
    "GPUEstimate", "estimate_gpu",
    "RankedConfig", "RankingResult", "SkippedConfig",
    "enumerate_gpu_configs", "rank_gpu_configs", "ranking_quality",
    "star_stencil_3d",
]
