"""Quickstart through the port: the paper's workflow end to end on the H100.

The port of ``examples/quickstart.py``.

1. Describe a kernel by its *address expressions* (what a code generator has
   before emitting code).
2. Ask the analytical estimator to price every launch configuration — no
   compilation, no benchmarking — on the H100 model.
3. Inspect the predicted volumes and limiters; cross-check the winner on a
   1/8-scaled H100 against the exact LRU cache simulator
   (``repro_torch.core.cachesim``).
4. Do the same on the TPU side: rank the stencil's Pallas configurations
   at the paper's domain on TPU-v5e (``api.price(pallas_request(...))`` over
   the generator's ``tpu_candidate_specs``, the form the reference's tracer
   derives from its Pallas builders); then run the H100-ranked winner on the
   card: ``star_stencil`` at that launch (the per-point CUDA kernel
   ``star_pointwise``), held against the plain version ``star_stencil_ref``.

Run:  PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

The kernel runs on the card; the CPU runs the plain version only when asked
with ``--device cpu`` (``main(device="cpu")``).  Without a card and without
it, the script fails.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.api import pallas_request, price
from repro_torch.core.cachesim import simulate_l2_waves
from repro_torch.core.machines import H100, GPUMachine
from repro_torch.core.selector import rank_gpu_configs
from repro_torch.core.specs import star_stencil_3d
from repro_torch.kernels import resolve_device
from repro_torch.kernels.stencil3d25.generator import tpu_candidate_specs
from repro_torch.kernels.stencil3d25.ops import star_stencil
from repro_torch.kernels.stencil3d25.ref import pad_input, star_stencil_ref, star_weights

R = 4
DOMAIN = (192, 192, 256)         # (Z, Y, X) of steps 1-3 and 4, as the reference's
SMALL_DOMAIN = (48, 96, 128)     # the simulator's cross-check, as the reference's
TPU_DOMAIN = (512, 512, 640)     # step 4's Pallas ranking, as the reference's (paper §5.2)
TOTAL_THREADS = 1024
ELEM_BYTES = 8                   # fp64: the spec's default and the kernel's dtype
TOL = dict(rtol=1e-12, atol=1e-12)


def scaled(machine: GPUMachine, factor: int = 8) -> GPUMachine:
    """``machine`` cut to 1/``factor`` (the reference's A100/8 pattern): SMs,
    L2 and the rates divided, the SM's own sizes and limits kept."""
    return dataclasses.replace(
        machine, name=f"{machine.name.split('-')[0]}/{factor}",
        n_sms=machine.n_sms // factor, l2_bytes=machine.l2_bytes // factor,
        dram_bw=machine.dram_bw / factor, l2_bw=machine.l2_bw / factor,
        peak_flops_dp=machine.peak_flops_dp / factor)


def main(device="cuda", machine: GPUMachine = H100, domain=DOMAIN,
         small_domain=SMALL_DOMAIN, small_machine: GPUMachine | None = None, *,
         seed: int = 0, show: int = 5, tpu_domain=TPU_DOMAIN) -> dict:
    """Steps 1-4.  Returns what it printed, as data: ``{"spec", "ranked"
    (the RankingResult on ``machine``), "winner", "worst", "small": {"spec",
    "machine", "winner", "sim", "sim_s"}, "tpu" (the TPU-v5e ranking's top
    3 EvalResults), "launch", "max_abs_err"}``."""
    dev = resolve_device(device)
    domain, small_domain = tuple(domain), tuple(small_domain)
    small_machine = small_machine or scaled(machine)

    # ---------------------------------------------------------- steps 1-2
    spec = star_stencil_3d(r=R, domain=domain, elem_bytes=ELEM_BYTES)
    print(f"kernel: {spec.name}, domain {spec.domain}, "
          f"{len(spec.accesses)} address expressions")
    t0 = time.perf_counter()
    ranked = rank_gpu_configs(spec, machine, total_threads=TOTAL_THREADS)
    t_rank = time.perf_counter() - t0
    print(f"\ntop-{show} predicted configurations on {machine.name} (of "
          f"{len(ranked)} candidates, {t_rank:.2f} s to price them all):")
    for rc in ranked[:show]:
        e = rc.estimate
        print(f"  block={rc.launch.block} fold={rc.launch.folding}: "
              f"{e.perf_lups/1e9:6.1f} GLup/s  DRAM={e.dram_load_per_lup:5.1f}B/LUP "
              f"limiter={e.limiter}")
    worst = ranked[-1]
    print(f"  ... worst: block={worst.launch.block} "
          f"{worst.estimate.perf_lups/1e9:6.1f} GLup/s")

    # ---------------------------------------------------------- step 3
    spec_s = star_stencil_3d(r=R, domain=small_domain, elem_bytes=ELEM_BYTES)
    best_s = rank_gpu_configs(spec_s, small_machine)[0]
    t0 = time.perf_counter()
    sim = simulate_l2_waves(spec_s, best_s.launch, small_machine)
    sim_s = time.perf_counter() - t0
    print(f"\nvalidation vs LRU simulator on {small_machine.name} at {small_domain} "
          f"({best_s.launch.block}): predicted {best_s.estimate.dram_load_per_lup:.1f} "
          f"B/LUP, simulated {sim['dram_load_bytes_per_lup']:.1f} B/LUP ({sim_s:.2f} s)")

    # ---------------------------------------------------------- step 4
    print("\nTPU (Pallas) config selection for the same stencil:")
    tpu = price(pallas_request(tpu_candidate_specs(R, tuple(tpu_domain), ELEM_BYTES),
                               "TPUv5e")).ranking()[:3]
    for e in tpu:
        est = e.estimate
        print(f"  {e.config}: {est.bytes_per_work:5.1f} B/pt, limiter={est.limiter}, "
              f"VMEM={est.vmem_alloc_bytes/2**20:.0f} MiB")
    best = ranked[0].launch
    dtype = torch.float64 if ELEM_BYTES == 8 else torch.float32
    gen = torch.Generator(device=dev).manual_seed(seed)
    src = torch.randn(domain, dtype=dtype, device=dev, generator=gen)
    w = star_weights(R, dtype, dev)
    out = star_stencil(src, w, r=R, config={"block": best.block, "folding": best.folding})
    want = star_stencil_ref(pad_input(src, R), w, R)
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"star_stencil: got {tuple(out.shape)}, want "
                             f"{tuple(want.shape)}, or a value that is not finite")
    err = float((out - want).abs().max())
    if not torch.allclose(out, want, **TOL):
        raise AssertionError(f"star_stencil: max abs error {err!r} exceeds {TOL}")
    print(f"star_stencil on {dev} at the {machine.name} winner block={best.block} "
          f"fold={best.folding}, fp{ELEM_BYTES * 8}: max abs error {err!r} against "
          f"star_stencil_ref (tolerance {TOL})")
    return {"spec": spec, "ranked": ranked, "winner": ranked[0], "worst": worst,
            "small": {"spec": spec_s, "machine": small_machine, "winner": best_s,
                      "sim": sim, "sim_s": sim_s},
            "tpu": tpu, "launch": best, "max_abs_err": err}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs the plain version")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(device=args.device, seed=args.seed)
    sys.exit(0)
