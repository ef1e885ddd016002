"""Machine models (paper Table 1, plus H100 and A100-80G, and the TPU v5e).

A copy of ``repro.core.machines`` with unchanged parameters.  GPU models
carry the paper's measured parameters; the TPU model carries the hardware
constants of the reference's production target, and prices the hand-built
Pallas specs the exploration engine's TPU backend takes.

Every machine factors into a **geometry** — the fields structural pricing
reads (grid walks, footprint unions, wave counting depend on SM count,
occupancy limit, and sector/line granularity; VMEM padding depends on
lane/sublane/MXU tiling) — and a **rate key** — the fields only the cheap
rate/limiter stage reads (clocks, bandwidths, FLOP peaks, and cache
*capacities*, which enter solely through Gompertz hit-rates).  Machines
sharing a geometry share every structural computation (DESIGN.md §11).
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class GPUGeometry:
    """The machine fields GPU structural pricing reads — nothing else.

    Cache capacities are deliberately *not* here: in this model L1/L2 sizes
    enter only through capacity hit-rates (the rate stage), so machines
    differing only in cache size share all structural work.
    """

    n_sms: int
    max_threads_per_sm: int = 2048
    sector_bytes: int = 32
    line_bytes: int = 128


@dataclass(frozen=True)
class TPUGeometry:
    """The machine fields Pallas structural pricing reads (tile paddings)."""

    vpu_lanes: int = 128
    vpu_sublanes: int = 8
    mxu_dim: int = 128

    def sublane_elems(self, elem_bytes: int) -> int:
        """Second-to-last-dim tile granularity: 8 for 4B, 16 for 2B, 32 for 1B."""
        return self.vpu_sublanes * max(1, 4 // elem_bytes)


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

    @property
    def l1_total(self) -> int:
        return self.l1_bytes * self.n_sms

    @property
    def geometry(self) -> GPUGeometry:
        """Structural key: machines with equal geometry share every grid
        walk, footprint box, and wave count (DESIGN.md §11)."""
        return GPUGeometry(self.n_sms, self.max_threads_per_sm,
                           self.sector_bytes, self.line_bytes)

    @property
    def rate_key(self) -> tuple:
        """The complementary rate-stage fields (hit-rates + limiters)."""
        return (self.clock_hz, self.l1_bytes, self.l2_bytes, self.dram_bw,
                self.l2_bw, self.peak_flops_dp)


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


@dataclass(frozen=True)
class TPUMachine:
    """Single-chip TPU model + ICI mesh parameters (v5e-class)."""

    name: str = "TPUv5e"
    peak_flops_bf16: float = 197e12
    peak_flops_f32: float = 197e12 / 4
    hbm_bw: float = 819e9              # B/s per chip
    hbm_bytes: int = 16 * 1024**3
    vmem_bytes: int = 128 * 1024 * 1024  # model constant (per-core VMEM budget)
    vmem_bw: float = 4.0e12            # B/s VMEM<->VREG model constant
    ici_bw_per_link: float = 50e9      # B/s per link per direction
    ici_links: int = 4                 # 2D torus: 4 links/chip (2 axes x 2 dirs)
    mxu_dim: int = 128                 # systolic array edge
    vpu_lanes: int = 128
    vpu_sublanes: int = 8
    vpu_flops: float = 197e12 / 16     # vector (non-MXU) throughput model
    grid_step_overhead_s: float = 1e-7 # per-grid-step pipeline bubble model

    def sublane_elems(self, elem_bytes: int) -> int:
        """Second-to-last-dim tile granularity: 8 for 4B, 16 for 2B, 32 for 1B."""
        return self.vpu_sublanes * max(1, 4 // elem_bytes)

    def peak_flops(self, elem_bytes: int) -> float:
        return self.peak_flops_bf16 if elem_bytes <= 2 else self.peak_flops_f32

    @property
    def geometry(self) -> TPUGeometry:
        """Structural key: tile paddings and fetch counts depend only on
        these fields (VMEM *capacity* is a rate-side feasibility budget)."""
        return TPUGeometry(self.vpu_lanes, self.vpu_sublanes, self.mxu_dim)

    @property
    def rate_key(self) -> tuple:
        return (self.peak_flops_bf16, self.peak_flops_f32, self.hbm_bw,
                self.vmem_bytes, self.vmem_bw, self.vpu_flops,
                self.grid_step_overhead_s)


TPU_V5E = TPUMachine()


# --------------------------------------------------------------------------
# machine registry: PriceRequests reference machines by name; hypothetical
# variants travel as full parameter sets.
# --------------------------------------------------------------------------
MACHINES: dict = {m.name: m for m in (V100, A100, A100_80G, H100, TPU_V5E)}
# short aliases for the common cards
MACHINES.update({
    "V100": V100,
    "A100": A100,
    "A100-80G": A100_80G,
    "H100": H100,
    "TPUv5e": TPU_V5E,
})


def get_machine(name: str):
    """Resolve a machine by registry name or alias (KeyError with the
    known names when unknown)."""
    try:
        return MACHINES[name]
    except KeyError:
        raise KeyError(
            f"unknown machine {name!r}; known: {sorted(MACHINES)}"
        ) from None
