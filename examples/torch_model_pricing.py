"""Model pricing through the port: from an architecture config to a machine
recommendation.

The port of ``examples/model_pricing.py``.  The paper's workflow (fig. 1)
prices one kernel configuration space; this example prices a whole *model*:
the mixtral-8x7b config is lowered into a per-layer kernel plan (attention
cores -> flash-attention candidates, MoE expert FFNs -> matmul candidates
weighted by the top-2 routing fan-out), and the plan is priced on V100,
A100, and TPU-v5e in one exploration-engine sweep through
``repro_torch.api.price(plan_request(...))``.  No code is generated and
nothing runs on a device — it is the paper's analytical estimator,
integrated with the model zoo as its code generator.

It prices only and touches no tensor, so unlike the port's other examples
it takes no device: it runs the same on a host with a card and without one.

Run:  PYTHONPATH=src python examples/torch_model_pricing.py
"""
from __future__ import annotations

import sys

from repro_torch.api import plan_request, price
from repro_torch.configs import get_config
from repro_torch.core.machines import A100, TPU_V5E, V100
from repro_torch.suite import lower_model

ARCH = "mixtral-8x7b"
SHAPE = "train_4k"
MACHINES = (V100, A100, TPU_V5E)


def main() -> dict:
    """Lower ``ARCH`` at ``SHAPE``, price the plan on ``MACHINES`` in one
    ``price`` sweep (its default engine, serial), and print the reference
    example's lines.  Returns ``{"plan": ModelPlan, "result": PriceResult,
    "suite": SuiteReport, "winner": (machine name, seconds a pass)}``."""
    cfg = get_config(ARCH)
    plan = lower_model(cfg, SHAPE)
    print(f"{cfg.name} ({cfg.n_layers} layers, {cfg.n_experts} experts "
          f"top-{cfg.top_k}) at shape {plan.shape.name}:")
    print(f"  {len(plan.workloads)} kernel workloads, "
          f"{len(plan.distinct())} distinct structural classes, "
          f"{plan.total_flops()/1e12:.1f} TFLOP useful work per pass")

    result = price(plan_request({ARCH: plan}, list(MACHINES)))
    suite = result.suite
    print(f"\npriced in {suite.wall_time_s:.1f}s "
          f"(invariant cache: {suite.cache_stats['hits']} hits / "
          f"{suite.cache_stats['misses']} misses)\n")
    print(suite.table())

    best_machine, best_t = suite.machine_ranking(ARCH)[0]
    report = suite.get(ARCH, best_machine)
    print(f"\nfastest machine: {best_machine} ({best_t*1e3:.1f} ms/pass, "
          f"{report.roofline.dominant}-dominant, "
          f"{100*report.roofline_fraction:.0f}% of its roofline)")

    print("\nper-role cost breakdown on the winner:")
    for role, t in sorted(report.by_role().items(), key=lambda kv: -kv[1]):
        print(f"  {role:18s} {t*1e3:8.2f} ms")

    print("\nper-layer best configs (layer 0 shown; later layers share "
          "structure and reuse its tasks):")
    for row in report.rows[:6]:
        print(f"  {row.name:22s} {str(row.config):28s} "
              f"count={row.count:3d}  {row.time_s*1e6:8.1f} us  {row.limiter}")
    return {"plan": plan, "result": result, "suite": suite,
            "winner": (best_machine, best_t)}


if __name__ == "__main__":
    main()
    sys.exit(0)
