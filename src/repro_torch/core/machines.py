"""GPU machine models (paper Table 1, plus H100 and A100-80G).

A copy of the GPU half of ``repro.core.machines`` with unchanged
parameters; the TPU model and the geometry/rate-key factoring of the
exploration engine are not needed by the serial ``estimate_gpu`` path.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUMachine:
    name: str
    n_sms: int
    clock_hz: float
    l1_bytes: int
    l2_bytes: int          # effective (A100: one 20MB section, paper §3)
    dram_bw: float         # B/s
    l2_bw: float           # B/s
    peak_flops_dp: float
    max_threads_per_sm: int = 2048
    sector_bytes: int = 32
    line_bytes: int = 128


A100 = GPUMachine(
    name="A100-SXM4-40G",
    n_sms=108,
    clock_hz=1.41e9,
    l1_bytes=192 * 1024,
    l2_bytes=20 * 1024 * 1024,  # split L2: effective capacity halved (paper §3)
    dram_bw=1400e9,
    l2_bw=5000e9,
    peak_flops_dp=9.7e12,
)

V100 = GPUMachine(
    name="V100-PCIe-32GB",
    n_sms=80,
    clock_hz=1.38e9,
    l1_bytes=128 * 1024,
    l2_bytes=6 * 1024 * 1024,
    dram_bw=800e9,
    l2_bw=2500e9,
    peak_flops_dp=7.0e12,
)

# A100 80GB SXM: same GA100 silicon/geometry as the 40GB part, but HBM2e at
# 2039 GB/s (NVIDIA A100 datasheet) and modeled with the *full* 40MB L2 —
# the unpartitioned design-exploration variant (contrast the paper's §3
# halved-L2 treatment of the 40GB card above).  Shares every structural
# entry with A100 (identical geometry): only hit-rates and limiters differ.
A100_80G = GPUMachine(
    name="A100-SXM4-80G",
    n_sms=108,
    clock_hz=1.41e9,
    l1_bytes=192 * 1024,
    l2_bytes=40 * 1024 * 1024,
    dram_bw=2039e9,
    l2_bw=5000e9,
    peak_flops_dp=9.7e12,
)

# H100 SXM5 80GB — the natural post-A100 step for design exploration.
# Parameter sources:
#   * NVIDIA Hopper architecture whitepaper: 132 SMs, 1.83 GHz boost,
#     256 KB combined L1/shared per SM, 50 MB L2, HBM3 3.35 TB/s,
#     33.5 TFLOP/s FP64 (vector, non-tensor).
#   * l2_bytes models the effective capacity of one 25 MB L2 partition —
#     Hopper keeps Ampere's two-section L2 with a partitioned crossbar, so
#     we apply the same §3 halving used for A100 above.
#   * l2_bw is a model estimate (no public figure): A100's measured 5 TB/s
#     scaled by the SM-count x clock ratio, ~8 TB/s.  Revisit against
#     microbenchmarks when available.
#   * max_threads_per_sm stays 2048; sector/line granularity unchanged.
H100 = GPUMachine(
    name="H100-SXM5-80G",
    n_sms=132,
    clock_hz=1.83e9,
    l1_bytes=256 * 1024,
    l2_bytes=25 * 1024 * 1024,
    dram_bw=3350e9,
    l2_bw=8000e9,
    peak_flops_dp=33.5e12,
)
