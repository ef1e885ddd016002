"""The estimator of ``repro.core``, copied for the port: the GPU path, the
TPU adaptation that prices Pallas specs and ranks a generator's TPU
candidates (``select_pallas_config``), the exploration engine that ranks
configuration spaces through both, the design-space sweeps over its
machine axis, the mesh-level roofline of a counted step, and the LRU
sector-cache simulator (``cachesim``) that the estimator's volumes are
checked against.

numpy-only, like the original; the port imports nothing of ``repro``.  It
exports every name of ``repro.core`` but the jax-only
``analyze_compiled``, whose place ``analyze_cost`` takes.
"""
from .access import Access, Field, KernelSpec, LaunchConfig
from .capacity import CapacityModel, HitRateFit, gompertz
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
from .engine import (
    Explorer,
    ExplorationReport,
    EvalResult,
    SkippedConfig,
    Workload,
)
from .machines import (
    A100,
    A100_80G,
    H100,
    TPU_V5E,
    V100,
    GPUGeometry,
    GPUMachine,
    TPUGeometry,
    TPUMachine,
)
from .perfmodel import GPUEstimate, estimate_gpu
from .roofline import RooflineReport, analyze_cost, format_roofline_table
from .selector import (
    RankedConfig,
    RankingResult,
    enumerate_gpu_configs,
    rank_gpu_configs,
    ranking_quality,
    select_gpu_config,
)
from .specs import star_stencil_3d
from .tpu_adapt import (
    MatmulShape,
    OperandSpec,
    PallasEstimate,
    PallasKernelSpec,
    RankedPallasConfig,
    estimate_pallas,
    fetch_count,
    select_pallas_config,
)

__all__ = [
    "Access", "Field", "KernelSpec", "LaunchConfig",
    "CapacityModel", "HitRateFit", "gompertz",
    "Explorer", "ExplorationReport", "EvalResult", "SkippedConfig", "Workload",
    "A100", "A100_80G", "H100", "V100", "TPU_V5E",
    "GPUGeometry", "GPUMachine", "TPUGeometry", "TPUMachine",
    "ParetoPoint", "design_space_sweep", "gpu_rate_grid", "h100_class_grid",
    "paper_design_grid", "pareto_frontier", "pareto_table", "tpu_rate_grid",
    "GPUEstimate", "estimate_gpu",
    "RankedConfig", "RankingResult", "enumerate_gpu_configs",
    "rank_gpu_configs", "ranking_quality", "select_gpu_config",
    "MatmulShape", "OperandSpec", "PallasEstimate", "PallasKernelSpec",
    "RankedPallasConfig", "estimate_pallas", "fetch_count", "select_pallas_config",
    "RooflineReport", "analyze_cost", "format_roofline_table",
    "star_stencil_3d",
]
