"""The weight draws of the layers' ``*_init`` functions."""
from __future__ import annotations

import torch


def normal(shape, scale, dtype, *, generator: torch.Generator, device) -> torch.Tensor:
    """Standard normal draws times ``scale``, made in fp32 from ``generator``
    on ``device`` and cast to ``dtype``, as the reference draws in fp32 and
    casts its weights."""
    w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
    return (w * scale).to(dtype)
