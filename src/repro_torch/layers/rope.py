"""Rotary position embeddings (a port of ``repro.layers.rope``).

The angles and the rotation are computed in fp32 and the result is cast
back to x's dtype, as the reference's promotion of bf16 x against fp32
cos/sin does.
"""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """x: (..., S, D) with D even; positions: (..., S) int, broadcastable."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                 # (D/2,)
    ang = positions[..., None].to(torch.float32) * freqs   # (..., S, D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    out = torch.stack([y1, y2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)
