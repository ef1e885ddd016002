"""The range-r star stencil through ``repro_torch``'s ``star_stencil``.

The field is uniform noise in [0, 1) drawn on the device from the seed;
the weights are the star's uniform average of its 6r+1 points, made here
and handed to the program and the reference alike.  With a zero halo a
step only smooths, so the loop stays in [0, 1].
"""
from __future__ import annotations

import torch

from portbench import bounds
from portbench.reference import star as ref

OUTPUTS = ("u",)


def _dtype(config):
    return getattr(torch, config["dtype"])


def init(config, seed: int, device) -> tuple:
    dtype = _dtype(config)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    u = torch.rand(tuple(config["domain"]), generator=gen, dtype=dtype, device=device)
    from repro_torch.kernels.stencil3d25 import ops

    weights = ref.uniform_weights(config["r"], dtype, device)
    return (u,), {"weights": weights, "entry": ops.star_stencil}


def program_step(fields, operands, config, entry):
    (u,) = fields
    return (operands["entry"](u, operands["weights"], r=config["r"], config=entry),)


def reference_step(fields, operands, config, dtype=None):
    (u,) = fields
    return (ref.step(u, operands["weights"], config["r"], dtype),)


def points(config) -> int:
    Z, Y, X = config["domain"]
    return Z * Y * X


def bound_ms(config) -> float:
    return bounds.star_bound(tuple(config["domain"]), config["r"],
                             _dtype(config).itemsize)[0]
