"""Spec-extraction frontend: trace Triton kernels into address expressions.

The estimator "can be integrated into any code generator that can generate
the required address expressions" (paper §6).  This package removes the
hand-written step: give it a Triton kernel's launcher and shape
placeholders, and it derives the address-expression artifact mechanically —

    from repro_torch.api import kernel_request, price
    from repro_torch.frontend import arg

    result = price(kernel_request(my_launcher,
                                  [arg("x", (8192, 8192), torch.float32)],
                                  machines=["H100", "TPUv5e"], name="my_kernel"))
    print(result.report.comparison_table())

Layers (DESIGN.md §9): ``affine`` (symbolic quasi-affine IR), ``trace``
(the capture of one Triton launch and its body over symbolic program ids,
lanes and pointers), ``lower`` (PallasKernelSpec / GPU KernelSpec
emission), ``candidates`` (decision-space sweeps for kernel generators),
``tl`` (a stand-in for ``triton.language`` where Triton is not installed)
and ``triton_kernels`` (the tracer's Triton fixtures).  Importing this
package imports neither torch nor triton; tracing does.

``trace_payload`` is the serializable boundary: it runs the tracing work
(trace + lower) once and returns a pure-value ``TracedSpecPayload`` that
travels through ``repro_torch.api.PriceRequest`` — in-process or over the
``repro_torch.serve`` wire — with tracer rejections carried as
``RejectedSpec`` so the engine records the diagnostic itself.

A port of ``repro.frontend``, whose tracer captures ``pl.pallas_call``:
the same IR, lowerings, payload and wire tag, with a Triton capture in
place of the Pallas one.  The port's hand-written CUDA kernels cannot be
traced; their generators keep declaring their specs.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass

from .affine import AffineExpr, NonAffineError, Sym, affine
from .candidates import KernelBuild, candidates, grid_space
from .lower import CostModel, derive_costs, lower_gpu, lower_tpu
from .trace import Placeholder, TraceError, TracedKernel, arg, trace_kernel


@dataclass(frozen=True)
class TracedSpecPayload:
    """Pure-value result of tracing one kernel: everything the engine needs
    to price it, nothing that needs torch or triton.  ``gpu_spec`` is a
    ``KernelSpec``, a ``RejectedSpec`` (tracer diagnostic preserved), or
    None when GPU lowering was not attempted."""

    name: str
    tpu_spec: object
    gpu_spec: object | None = None


def trace_payload(call_fn, args, *, name: str = "kernel",
                  costs: CostModel | None = None,
                  rename: dict | None = None) -> TracedSpecPayload:
    """Trace ``call_fn`` once and lower to both backends.

    A GPU lowering rejected by the tracer becomes a ``RejectedSpec`` inside
    the payload: the engine turns it into a per-GPU-machine skip with the
    tracer's actual diagnostic as the reason.
    """
    from repro_torch import obs
    from repro_torch.core.engine import RejectedSpec

    with obs.span("frontend.trace", "frontend", kernel=name):
        traced = trace_kernel(call_fn, args, name=name, trace_body=True)
    with obs.span("frontend.lower", "frontend", kernel=name):
        tpu_spec = lower_tpu(traced, costs, name=name)
        try:
            gpu_spec = lower_gpu(traced, costs, name=name, rename=rename)
        except TraceError as e:
            gpu_spec = RejectedSpec(name, str(e))
    return TracedSpecPayload(name=name, tpu_spec=tpu_spec, gpu_spec=gpu_spec)


def price_kernel(call_fn, args, machines, *, name: str = "kernel",
                 costs: CostModel | None = None, engine=None,
                 rename: dict | None = None, top_k: int | None = None):
    """Deprecated: use ``repro_torch.api.price(kernel_request(...))``.

    Traces one kernel and prices it on a mix of GPU/TPU machines, returning
    the ``ExplorationReport`` (tracer rejections land in ``report.skipped``
    with the tracer's diagnostic as the reason).
    """
    warnings.warn(
        "price_kernel() is deprecated; use repro_torch.api.price("
        "repro_torch.api.kernel_request(...)) instead",
        DeprecationWarning, stacklevel=2,
    )
    from repro_torch.api import kernel_request, price

    request = kernel_request(call_fn, args, machines, name=name, costs=costs,
                             rename=rename, top_k=top_k)
    return price(request, engine=engine).report


__all__ = [
    "AffineExpr", "NonAffineError", "Sym", "affine",
    "KernelBuild", "candidates", "grid_space",
    "CostModel", "derive_costs", "lower_gpu", "lower_tpu",
    "Placeholder", "TraceError", "TracedKernel", "arg", "trace_kernel",
    "TracedSpecPayload", "trace_payload", "price_kernel",
]
