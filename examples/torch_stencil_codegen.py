"""Code generation + analytical selection on the H100, the pystencils
integration (§1.2), through the port's pricing API.

The port of ``examples/stencil_codegen.py``.  It builds the paper's two
applications — the range-4 3D25pt star stencil and the D3Q15 Allen-Cahn LBM
interface-tracking kernel — from their specs, prices both generators'
per-point launch spaces (the paper's 168 launches each) on the H100 in one
``repro_torch.api.price()`` sweep, prints the rankings and the variants the
GPU model does not price (the stencil's z-march rings, the LBM's y-tiles)
with their reasons, then runs ``star_stencil`` and ``lbm_step`` at the
winning launches and holds them against the plain versions in ``ref.py``.
Beside it, as the reference does, it prices both generators' TPU spaces
(the stencil's Pallas variants and the LBM's first five) on the TPU v5e in
one more ``price()`` sweep and prints that ranking, the candidates whose
VMEM working set does not fit skipped with their reason.

Run:  PYTHONPATH=src python examples/torch_stencil_codegen.py [--device cpu]

The kernels run on the card; the CPU runs the plain versions only when
asked with ``--device cpu`` (``main(device="cpu")``).  Without a card and
without it, the script fails.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.api import PriceRequest, price
from repro_torch.core.engine import Workload
from repro_torch.core.machines import H100, TPU_V5E
from repro_torch.core.selector import enumerate_gpu_configs
from repro_torch.core.specs import lbm_d3q15, star_stencil_3d
from repro_torch.kernels import SCRATCH_REASON, dtype_for, resolve_device
from repro_torch.kernels.lbm_d3q15.generator import tpu_candidate_specs as lbm_candidates
from repro_torch.kernels.lbm_d3q15.generator import ytile_space
from repro_torch.kernels.lbm_d3q15.ops import lbm_step
from repro_torch.kernels.lbm_d3q15.ref import WEIGHTS, lbm_step_ref, pad_inputs
from repro_torch.kernels.stencil3d25.generator import tpu_candidate_specs as st_candidates
from repro_torch.kernels.stencil3d25.generator import zmarch_space
from repro_torch.kernels.stencil3d25.ops import star_stencil
from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

R = 4
STENCIL_DOMAIN = (512, 512, 640)   # (Z, Y, X), paper §5.2
LBM_DOMAIN = (256, 256, 256)       # (Z, Y, X), paper §5.3
ELEM_BYTES = 8                     # fp64, as the paper runs both
TOL = dict(rtol=1e-12, atol=1e-12)  # the kernels against ref.py, in fp64
STENCIL, LBM = "stencil3d25", "lbm_d3q15"


def request(stencil_domain=STENCIL_DOMAIN, lbm_domain=LBM_DOMAIN,
            machine=H100) -> PriceRequest:
    """Both generators' per-point launch spaces on ``machine``, one request."""
    configs = tuple(enumerate_gpu_configs())
    return PriceRequest(
        workloads=[
            Workload(STENCIL, gpu_spec=star_stencil_3d(R, tuple(stencil_domain), ELEM_BYTES),
                     gpu_configs=configs),
            Workload(LBM, gpu_spec=lbm_d3q15(tuple(lbm_domain), ELEM_BYTES),
                     gpu_configs=configs),
        ],
        machines=[machine],
    )


def tpu_request(stencil_domain=STENCIL_DOMAIN, lbm_domain=LBM_DOMAIN,
                machine=TPU_V5E) -> PriceRequest:
    """The reference's TPU sweep: the stencil's Pallas space and the LBM's
    first five candidates on ``machine``, one request."""
    return PriceRequest(
        workloads=[
            Workload(STENCIL, tpu_candidates=list(
                st_candidates(R, tuple(stencil_domain), elem_bytes=ELEM_BYTES))),
            Workload(LBM, tpu_candidates=list(
                lbm_candidates(tuple(lbm_domain), elem_bytes=ELEM_BYTES))[:5]),
        ],
        machines=[machine],
    )


def _print_tpu_ranking(report, name: str, title: str, unit: str) -> None:
    print(f"{title} — ranked candidates:")
    for e in report.ranking(name):
        print(f"  {str(e.config):38s} {e.estimate.bytes_per_work:6.1f} {unit} "
              f"t={e.estimate.total_time * 1e3:7.2f} ms  {e.limiter}")
    for s in report.skipped_for(name):
        print(f"  {str(s.config):38s} skipped: {s.reason}")


def _print_ranking(result, name: str, title: str, unpriced, show: int) -> None:
    ranking = result.ranking(name)
    print(f"{title} — {len(ranking)} launches ranked, best first:")
    for e in ranking[:show]:
        est = e.estimate
        dram = est.dram_load_per_lup + est.dram_store_per_lup
        print(f"  block {str(e.config.block):15s} folding {str(e.config.folding):10s} "
              f"{dram:6.1f} B/LUP  t={est.lups / e.perf * 1e3:8.3f} ms  {e.limiter}")
    if len(ranking) > show:
        print(f"  ... {len(ranking) - show} more")
    for s in result.report.skipped_for(name):
        print(f"  {str(s.config):38s} skipped: {s.reason}")
    for cfg in unpriced:
        print(f"  {str(cfg):38s} skipped: {SCRATCH_REASON}")


def _max_err(got: torch.Tensor, want: torch.Tensor, what: str) -> float:
    if got.shape != want.shape or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{what}: got {tuple(got.shape)}, want {tuple(want.shape)}, "
                             "or a value that is not finite")
    err = float((got - want).abs().max())
    if not torch.allclose(got, want, **TOL):
        raise AssertionError(f"{what}: max abs error {err!r} exceeds {TOL}")
    return err


def main(device="cuda", stencil_domain=STENCIL_DOMAIN, lbm_domain=LBM_DOMAIN, *,
         engine=None, seed: int = 0, show: int = 10) -> dict:
    """Price both launch spaces in one sweep, print them, run the winners.

    ``engine`` (an ``Explorer``) sets the sweeps' pool and cache.  Returns
    ``{"result": PriceResult, "tpu": PriceResult, "stencil": {...}, "lbm":
    {...}}``: the H100 sweep, the TPU sweep, and each kernel with its
    winning ``launch`` and ``max_abs_err`` against ``ref.py``."""
    dev = resolve_device(device)
    stencil_domain, lbm_domain = tuple(stencil_domain), tuple(lbm_domain)
    result = price(request(stencil_domain, lbm_domain), engine=engine)

    _print_ranking(result, STENCIL, f"stencil 3D25pt, domain {stencil_domain}, f64",
                   zmarch_space(R, stencil_domain), show)
    print()
    _print_ranking(result, LBM, f"LBM D3Q15, domain {lbm_domain}, f64",
                   ytile_space(lbm_domain), show)
    print(f"\nengine: {result.report.summary()}")

    # ---- the TPU spaces, as the reference prices them --------------------
    tpu = price(tpu_request(stencil_domain, lbm_domain), engine=engine)
    print()
    _print_tpu_ranking(tpu.report, STENCIL,
                       f"TPU v5e: stencil 3D25pt, domain {stencil_domain}, f64", "B/pt ")
    print()
    _print_tpu_ranking(tpu.report, LBM, f"TPU v5e: LBM D3Q15, domain {lbm_domain}, f64", "B/LUP")
    print(f"\nengine: {tpu.report.summary()}")

    # ---- run the selected kernels and validate -------------------------
    dtype = dtype_for(ELEM_BYTES)
    gen = torch.Generator(device=dev).manual_seed(seed)
    print(f"\nrunning the selected kernels on {dev} against ref.py:")
    best = result.best(STENCIL).config
    src = torch.randn(stencil_domain, dtype=dtype, device=dev, generator=gen)
    w = star_weights(R, dtype, dev)
    out = star_stencil(src, w, r=R, config={"block": best.block, "folding": best.folding})
    err_st = _max_err(out, star_stencil_ref(pad_input(src, R), w, R), "star_stencil")
    print(f"  stencil at block {best.block} folding {best.folding}: "
          f"max abs error {err_st!r} (tolerance {TOL})")
    del src, out

    best_lbm = result.best(LBM).config
    phase = torch.sigmoid(torch.randn(lbm_domain, dtype=dtype, device=dev, generator=gen))
    pdf = torch.stack([wq * phase for wq in WEIGHTS])
    new_pdf, new_phase = lbm_step(pdf, phase, config={"block": best_lbm.block,
                                                      "folding": best_lbm.folding})
    ref_pdf, ref_phase = lbm_step_ref(*pad_inputs(pdf, phase))
    err_lbm = _max_err(new_pdf, ref_pdf, "lbm_step")
    err_phase = _max_err(new_phase, ref_phase, "lbm_step phase")
    print(f"  lbm at block {best_lbm.block} folding {best_lbm.folding}: max abs error "
          f"{err_lbm!r}, phase {err_phase!r}; phase sum {float(new_phase.sum()):.4f} "
          f"(ref {float(ref_phase.sum()):.4f})")
    return {"result": result, "tpu": tpu,
            "stencil": {"launch": best, "max_abs_err": err_st},
            "lbm": {"launch": best_lbm, "max_abs_err": max(err_lbm, err_phase)}}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs the plain versions")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(device=args.device, seed=args.seed)
    sys.exit(0)
