"""The estimator of ``repro.core``, copied for the port: the GPU path, the
TPU adaptation that prices hand-built Pallas specs, and the exploration
engine that ranks configuration spaces through both.

numpy-only, like the original; the port imports nothing of ``repro``.
"""
from .access import Access, Field, KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .engine import Explorer, SkippedConfig, Workload
from .machines import A100, A100_80G, H100, V100, GPUMachine
from .perfmodel import GPUEstimate, estimate_gpu
from .selector import (
    RankedConfig,
    RankingResult,
    enumerate_gpu_configs,
    rank_gpu_configs,
    ranking_quality,
    select_gpu_config,
)
from .specs import star_stencil_3d

__all__ = [
    "Access", "Field", "KernelSpec", "LaunchConfig", "CapacityModel",
    "Explorer", "SkippedConfig", "Workload",
    "A100", "A100_80G", "H100", "V100", "GPUMachine",
    "GPUEstimate", "estimate_gpu",
    "RankedConfig", "RankingResult", "enumerate_gpu_configs",
    "rank_gpu_configs", "ranking_quality", "select_gpu_config",
    "star_stencil_3d",
]
