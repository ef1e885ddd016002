"""The estimator of ``repro.core``, copied for the port: the GPU path, the
TPU adaptation that prices hand-built Pallas specs, the exploration
engine that ranks configuration spaces through both, the design-space
sweeps over its machine axis, and the LRU sector-cache simulator
(``cachesim``) that the estimator's volumes are checked against.

numpy-only, like the original; the port imports nothing of ``repro``.
"""
from .access import Access, Field, KernelSpec, LaunchConfig
from .capacity import CapacityModel
from .designspace import (
    ParetoPoint,
    design_space_sweep,
    gpu_rate_grid,
    h100_class_grid,
    paper_design_grid,
    pareto_frontier,
    pareto_table,
    tpu_rate_grid,
)
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
    "ParetoPoint", "design_space_sweep", "gpu_rate_grid", "h100_class_grid",
    "paper_design_grid", "pareto_frontier", "pareto_table", "tpu_rate_grid",
    "A100", "A100_80G", "H100", "V100", "GPUMachine",
    "GPUEstimate", "estimate_gpu",
    "RankedConfig", "RankingResult", "enumerate_gpu_configs",
    "rank_gpu_configs", "ranking_quality", "select_gpu_config",
    "star_stencil_3d",
]
