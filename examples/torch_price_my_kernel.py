"""Price a user's Triton kernel with zero hand-written specs, then run it.

The port of ``examples/price_my_kernel.py``.  The paper's integration
claim: the estimator plugs into any code generator that can produce the
address expressions.  The spec frontend (``repro_torch.frontend``, DESIGN
§9) produces them *from the kernel itself* — write a Triton kernel, hand
the frontend its launcher and shapes, get a cross-machine ranking:

1. ``kernel_request`` traces the ``@triton.jit`` kernel ``scale_shift``
   (``out = x * 2 + 1`` over (16, 256) tiles of a 4096 x 4096 fp32 field,
   ``repro_torch.frontend.triton_kernels``) and ``price`` ranks it on the
   V100, A100, H100 and TPU-v5e models;
2. the traced address expressions are printed: each operand's block, its
   block index over the grid symbols, and the body's windows;
3. the kernel runs, held to its plain version within one fp32 ulp (the
   kernel may fuse the multiply-add).

Run:  PYTHONPATH=src python examples/torch_price_my_kernel.py [--device cpu]

The kernel runs on the card (Triton compiles it at its first launch); with
``--device cpu`` (``main(device="cpu")``) the script prices and runs the
plain version.  Without a card and without it, the script fails.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.api import kernel_request, price
from repro_torch.frontend import arg, lower_gpu, lower_tpu, trace_kernel
from repro_torch.frontend.triton_kernels import (
    SCALE_SHIFT_BLOCK,
    scale_shift,
    scale_shift_ref,
)
from repro_torch.kernels import resolve_device

SHAPE = (4096, 4096)                   # (Y, X), as the reference's example
MACHINES = ("V100", "A100", "H100", "TPUv5e")


def ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest difference of ``got`` from ``want`` in units of the last
    place of ``want`` (fp32)."""
    mag = want.abs()
    ulp = torch.nextafter(mag, torch.full_like(mag, float("inf"))) - mag
    return float(((got - want).abs() / ulp).max())


def main(device="cuda", shape=SHAPE, block=SCALE_SHIFT_BLOCK, *,
         seed: int = 0) -> dict:
    """Steps 1-3.  Returns ``{"result" (the PriceResult), "traced",
    "tpu_spec", "gpu_spec", "launcher", "x", "out", "max_abs_err", "ulps"}``."""
    dev = resolve_device(device)
    shape = tuple(shape)
    launcher = scale_shift(2.0, 1.0, block=block)
    args = [arg("x", shape, torch.float32)]

    # ---- the whole integration: one request ------------------------------
    result = price(kernel_request(launcher, args, list(MACHINES),
                                  name="scale_shift"))
    print(result.report.comparison_table())
    print(f"\nengine: {result.report.summary()}")

    # ---- the traced artifact, address expressions included ----------------
    traced = trace_kernel(launcher, args, name="scale_shift", trace_body=True)
    print(f"\ntraced address expressions (grid {traced.grid}, tiles {tuple(block)}):")
    for op in traced.operands:
        print(f"  {op.name}: block={op.block_shape} index={op.index_exprs} "
              f"deps={op.grid_deps} out={op.is_output}")
    for a in traced.body.accesses:
        kind = "store" if a.is_store else "load"
        print(f"  body {kind} {traced.operands[a.ref_index].name}: "
              f"offsets={a.offsets} extents={a.extents}")
    tpu = lower_tpu(traced)
    print(f"traced TPU spec: grid={tpu.grid} work/step={tpu.work_per_step} "
          f"vpu/step={tpu.vpu_elems_per_step}")
    gpu = lower_gpu(traced)
    print(f"traced GPU spec: domain={gpu.domain} flops/point={gpu.flops_per_point} "
          + ", ".join(f"{'store' if a.is_store else 'load'} {a.field.name}"
                      f"{a.offsets} dim_map={a.dim_map}" for a in gpu.accesses))

    # ---- run it -------------------------------------------------------------
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(shape, dtype=torch.float32, device=dev, generator=gen)
    out = launcher(x)
    want = scale_shift_ref(x, 2.0, 1.0)
    if out.shape != want.shape or not bool(torch.isfinite(out).all()):
        raise AssertionError(f"scale_shift: got {tuple(out.shape)}, want "
                             f"{tuple(want.shape)}, or a value that is not finite")
    err, n_ulps = float((out - want).abs().max()), ulps(out, want)
    if n_ulps > 1.0:
        raise AssertionError(f"scale_shift: {n_ulps} ulps from x * 2 + 1 (at most 1)")
    kernel = "the Triton kernel" if dev.type == "cuda" else "the plain version"
    print(f"\nscale_shift on {dev} ({kernel}): max abs error {err!r}, "
          f"{n_ulps} ulp, against x * 2 + 1")
    return {"result": result, "traced": traced, "tpu_spec": tpu, "gpu_spec": gpu,
            "launcher": launcher, "x": x, "out": out, "max_abs_err": err,
            "ulps": n_ulps}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu, which runs the plain version")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    main(device=args.device, seed=args.seed)
    sys.exit(0)
