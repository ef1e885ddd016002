"""Workload suite: model configs lowered into estimator-priced kernel plans.

A copy of ``repro.suite``.  The paper's closing claim — the estimator
integrates with *any* code generator that can produce address expressions —
applied to the model-config zoo: ``lower_model`` decomposes a
``repro_torch.configs`` architecture into a ``ModelPlan`` of kernel
workloads (attention cores, projection/MoE/SSM GEMMs), and whole batches of
plans are priced across GPU and TPU machines in one exploration-engine
sweep through ``repro_torch.api``.  See DESIGN.md §8 for the lowering
contract.

    from repro_torch.api import PlanRef, plan_request, price

    suite = price(plan_request({"mixtral-8x7b": PlanRef("mixtral-8x7b")},
                               ["V100", "A100", "TPUv5e"])).suite
    print(suite.table())
"""
from .lowering import (
    SUITE_GPU_BLOCKS,
    KernelWorkload,
    ModelPlan,
    lower_all,
    lower_model,
    pad_tile,
    suite_gpu_configs,
)
from .report import (
    ModelReport,
    SuiteReport,
    WorkloadPricing,
    machine_kind,
    suite_from_report,
)

__all__ = [
    "KernelWorkload", "ModelPlan", "lower_model", "lower_all",
    "pad_tile", "suite_gpu_configs", "SUITE_GPU_BLOCKS",
    "ModelReport", "SuiteReport", "WorkloadPricing",
    "machine_kind", "suite_from_report",
]
