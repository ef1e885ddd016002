"""The D3Q15 interface-tracking step through ``repro_torch``'s ``lbm_step``.

The phase field is uniform noise in [0, 1) drawn on the device from the
seed, and the PDFs start at rest for it (w_q·φ).  Each step feeds the next
the program's own PDFs and phase sum.
"""
from __future__ import annotations

import torch

from portbench import bounds
from portbench.reference import lbm as ref

OUTPUTS = ("pdf", "phase")


def _dtype(config):
    return getattr(torch, config["dtype"])


def init(config, seed: int, device) -> tuple:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    phase = torch.rand(tuple(config["domain"]), generator=gen, dtype=_dtype(config),
                       device=device)
    from repro_torch.kernels.lbm_d3q15 import ops

    return (ref.equilibrium(phase), phase), {"entry": ops.lbm_step}


def program_step(fields, operands, config, entry):
    pdf, phase = fields
    return operands["entry"](pdf, phase, tau=config["tau"], kappa=config["kappa"],
                             config=entry)


def reference_step(fields, operands, config, dtype=None):
    pdf, phase = fields
    return ref.step(pdf, phase, config["tau"], config["kappa"], dtype)


def points(config) -> int:
    Z, Y, X = config["domain"]
    return Z * Y * X


def bound_ms(config) -> float:
    return bounds.lbm_bound(tuple(config["domain"]), _dtype(config).itemsize)[0]
