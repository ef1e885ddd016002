"""Roofline placement of priced work (a copy of ``repro.core.roofline``).

    compute term    = FLOPs / peak_FLOP/s              (per chip)
    memory term     = bytes / HBM_bw                   (per chip)
    collective term = collective wire bytes / ICI bw   (per chip)

The mesh-level instantiation of the paper's multi-limiter model: the
dominant term is the bottleneck the perf loop iterates on.  The suite
(``repro_torch.suite``) places every priced model plan with
``report_from_values`` (TPU machines) or a ``RooflineReport`` built from a
GPU machine's measured peaks.

The reference's ``analyze_compiled`` reads these values from a compiled
JAX object (``compiled.cost_analysis()`` and the optimized HLO text through
``core.hlo``); it waits for the port's own cost source, with ``launch``
(``ROADMAP.md`` queue 1, item 9), and so does ``core.hlo``.
"""
from __future__ import annotations

from dataclasses import dataclass, field as dc_field

from .machines import TPUMachine, TPU_V5E


@dataclass
class RooflineReport:
    name: str
    flops: float
    hbm_bytes: float
    coll_payload_bytes: float
    coll_wire_bytes: float
    t_compute: float
    t_memory: float
    t_collective: float
    dominant: str
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    bytes_per_device: float = 0.0   # peak memory from memory_analysis
    detail: dict = dc_field(default_factory=dict)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the bound time spent on useful model FLOPs."""
        if self.t_bound <= 0:
            return 0.0
        return self.t_model_compute / self.t_bound

    @property
    def t_model_compute(self) -> float:
        return self.detail.get("t_model_compute", 0.0)

    def row(self) -> dict:
        return {
            "name": self.name,
            "t_compute_s": self.t_compute,
            "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "dominant": self.dominant,
            "hlo_gflops": self.flops / 1e9,
            "hbm_GB": self.hbm_bytes / 1e9,
            "coll_wire_GB": self.coll_wire_bytes / 1e9,
            "useful_flops_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
            "mem_GB_per_device": self.bytes_per_device / 1e9,
        }


def report_from_values(
    name: str,
    flops: float,
    hbm_bytes: float,
    coll_wire_bytes: float,
    n_chips: int,
    machine: TPUMachine = TPU_V5E,
    model_flops_total: float = 0.0,
    elem_bytes: int = 2,
    ici_links_used: int = 2,
    peak_bytes_per_device: float = 0.0,
    detail: dict | None = None,
) -> RooflineReport:
    """Roofline report from externally calibrated per-device values."""
    peak = machine.peak_flops(elem_bytes)
    t_compute = flops / peak
    t_memory = hbm_bytes / machine.hbm_bw
    t_coll = coll_wire_bytes / (machine.ici_bw_per_link * ici_links_used)
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    model_per_chip = model_flops_total / max(n_chips, 1)
    d = dict(detail or {})
    d["t_model_compute"] = model_per_chip / peak
    return RooflineReport(
        name=name,
        flops=flops,
        hbm_bytes=hbm_bytes,
        coll_payload_bytes=coll_wire_bytes,
        coll_wire_bytes=coll_wire_bytes,
        t_compute=t_compute,
        t_memory=t_memory,
        t_collective=t_coll,
        dominant=max(terms, key=terms.get),
        model_flops=model_flops_total,
        useful_flops_ratio=(model_per_chip / flops) if flops else 0.0,
        bytes_per_device=peak_bytes_per_device,
        detail=d,
    )


def format_roofline_table(reports) -> str:
    hdr = (
        f"{'cell':44s} {'t_comp(ms)':>10s} {'t_mem(ms)':>10s} {'t_coll(ms)':>10s} "
        f"{'dom':>10s} {'useful':>7s} {'roofl%':>7s} {'GB/dev':>7s}"
    )
    lines = [hdr, "-" * len(hdr)]
    for r in reports:
        lines.append(
            f"{r.name:44s} {r.t_compute*1e3:10.2f} {r.t_memory*1e3:10.2f} "
            f"{r.t_collective*1e3:10.2f} {r.dominant:>10s} "
            f"{r.useful_flops_ratio:7.3f} {100*r.roofline_fraction:6.1f}% "
            f"{r.bytes_per_device/1e9:7.2f}"
        )
    return "\n".join(lines)
