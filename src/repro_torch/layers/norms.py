"""Normalisation layers (a port of ``repro.layers.norms``).

Both compute in fp32 and cast back to the input's dtype, as the reference
does.  ``layernorm`` takes the population variance (``correction=0``), which
is ``jnp.var``'s; ``torch.var``'s default would divide by n - 1.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_device


def rmsnorm_init(dim: int, dtype=torch.float32, *, device="cuda") -> dict:
    """A unit scale, on the card unless the caller asks for the CPU."""
    return {"scale": torch.ones((dim,), dtype=dtype, device=resolve_device(device))}


def rmsnorm(params, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    y = xf * (var + eps) ** -0.5
    return (y * params["scale"].float()).to(x.dtype)


def layernorm_init(dim: int, dtype=torch.float32, *, device="cuda") -> dict:
    """A unit scale and a zero bias, on the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    return {"scale": torch.ones((dim,), dtype=dtype, device=device),
            "bias": torch.zeros((dim,), dtype=dtype, device=device)}


def layernorm(params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * (var + eps) ** -0.5
    return (y * params["scale"].float() + params["bias"].float()).to(x.dtype)
