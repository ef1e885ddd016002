"""Public entry point for the D3Q15 LBM: the paper's fig.-1 loop on §5.3.

``lbm_step`` pads the fields, asks the generator for the best launch
(ranked analytically on the H100, memoized) and runs the per-point CUDA
kernel there, unless ``config`` pins the decision.

With ``obs`` on, a call records ``lbm.step`` (``variant`` in its args)
around ``lbm.pad`` (``pad_inputs``), ``lbm.launch`` (the kernel wrapper)
and ``lbm.phase_sum`` (``new_pdf.sum(0)``); the memo lookup stays in the
step's own time.
"""
from __future__ import annotations

import torch

from repro_torch import obs
from repro_torch.core.access import LaunchConfig
from repro_torch.kernels.lbm_d3q15.generator import best_config
from repro_torch.kernels.lbm_d3q15.kernel import lbm_pointwise, lbm_ytile, ytile_tile
from repro_torch.kernels.lbm_d3q15.ref import pad_inputs


def lbm_step(pdf: torch.Tensor, phase: torch.Tensor, tau: float = 0.8,
             kappa: float = 0.15, config: dict | None = None) -> tuple:
    """One pull-scheme interface-tracking step on ``pdf``'s device; returns
    ``(new_pdf, new_pdf.sum(0))``.

    ``pdf`` is (15, Z, Y, X), ``phase`` (Z, Y, X).  ``config=None`` (or
    ``{"variant": "replane"}``) ranks every launch of the per-point kernel
    on the H100 and runs it at the best one.  A pinned config is
    ``{"block": (bx, by, bz), "folding": (fx, fy, fz)}`` for the per-point
    kernel, or ``{"variant": "ytile", "ty": ty}`` (ty divides Y, ty >= 2;
    8 by default) for the shared-memory z-march kernel.  The TPU's ``ytile``
    needs its input padded in y up to (Y/ty + 1)·ty rows; the CUDA kernel
    masks its own tile edge, so here every variant takes the same halo-1
    padding.  The phase sum is a plain ``torch.sum``, as the JAX package
    computes it outside any kernel.
    """
    config = config or {"variant": "replane"}
    variant = config.get("variant", "replane")
    with obs.span("lbm.step", variant=variant):
        if pdf.dim() != 4 or pdf.shape[0] != 15 or tuple(pdf.shape[1:]) != tuple(phase.shape):
            raise ValueError(f"expected pdf (15, Z, Y, X) and phase (Z, Y, X), got "
                             f"{tuple(pdf.shape)} and {tuple(phase.shape)}")
        domain = tuple(phase.shape)
        if variant == "replane":
            if "block" in config:
                launch = LaunchConfig(block=tuple(config["block"]),
                                      folding=tuple(config.get("folding", (1, 1, 1))))
            else:
                launch = best_config(domain, pdf.element_size()).launch
        elif variant == "ytile":
            ty = config.get("ty") or 8
            if domain[1] % ty or ty < 2:
                raise ValueError("ty must divide Y and be >= 2")
            tile = ytile_tile(ty, pdf.element_size())
        else:
            raise ValueError(f"unknown variant {variant!r}")
        with obs.span("lbm.pad"):
            pdf_p, phase_p = pad_inputs(pdf.contiguous(), phase.contiguous())
        with obs.span("lbm.launch"):
            if variant == "replane":
                new_pdf = lbm_pointwise(pdf_p, phase_p, launch, tau, kappa)
            else:
                new_pdf = lbm_ytile(pdf_p, phase_p, *tile, tau, kappa)
        with obs.span("lbm.phase_sum"):
            return new_pdf, new_pdf.sum(0)
