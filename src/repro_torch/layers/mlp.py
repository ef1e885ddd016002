"""Feed-forward blocks (a port of ``repro.layers.mlp``): SwiGLU
(LLaMA-style) and GELU (whisper-style).

The projections stay ``torch.einsum``, as the reference leaves them to XLA
outside any kernel.  SiLU and GELU run in fp32 and are cast back to the
input's dtype before the next product, as in the reference.  ``jax.nn.gelu``
defaults to the tanh approximation, so ``gelu_mlp`` passes
``approximate="tanh"``; PyTorch's default, the exact GELU, would differ.
"""
from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device

from . import _draw


def swiglu_init(d_model: int, d_ff: int, dtype=torch.bfloat16, *,
                generator: torch.Generator, device="cuda") -> dict:
    """w_gate and w_up normal times d_model^-1/2, w_down times d_ff^-1/2,
    drawn in fp32 from ``generator`` (on ``device``) and cast to ``dtype``;
    on the card unless the caller asks for the CPU."""
    normal = functools.partial(_draw.normal, dtype=dtype, generator=generator,
                               device=resolve_device(device))
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "w_gate": normal((d_model, d_ff), s_in),
        "w_up": normal((d_model, d_ff), s_in),
        "w_down": normal((d_ff, d_model), s_ff),
    }


def swiglu(params, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("...e,ef->...f", x, params["w_gate"])
    u = torch.einsum("...e,ef->...f", x, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return torch.einsum("...f,fe->...e", h, params["w_down"])


def gelu_mlp_init(d_model: int, d_ff: int, dtype=torch.bfloat16, *,
                  generator: torch.Generator, device="cuda") -> dict:
    """w_up normal times d_model^-1/2, w_down times d_ff^-1/2 (fp32 draws
    cast to ``dtype``), zero biases; on the card unless the caller asks for
    the CPU."""
    device = resolve_device(device)
    normal = functools.partial(_draw.normal, dtype=dtype, generator=generator, device=device)
    return {
        "w_up": normal((d_model, d_ff), d_model ** -0.5),
        "b_up": torch.zeros((d_ff,), dtype=dtype, device=device),
        "w_down": normal((d_ff, d_model), d_ff ** -0.5),
        "b_down": torch.zeros((d_model,), dtype=dtype, device=device),
    }


def gelu_mlp(params, x: torch.Tensor) -> torch.Tensor:
    h = torch.einsum("...e,ef->...f", x, params["w_up"]) + params["b_up"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return torch.einsum("...f,fe->...e", h, params["w_down"]) + params["b_down"]
