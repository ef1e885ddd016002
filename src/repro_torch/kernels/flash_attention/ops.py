"""Public flash-attention entry point with the reference's dispatch.

``flash_attention`` sends one query token to the decode kernel when the
cache length is a multiple of 128, shapes the blocked kernel cannot tile
(Sq or Skv not 128-divisible) to the plain version, and everything else to
the forward kernel at the pinned default tile (shape-keyed cache), unless
``config`` pins the tile.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.generator import DEFAULT, decode_bk
from repro_torch.kernels.flash_attention.kernel import flash_attention_fwd, flash_decode
from repro_torch.kernels.flash_attention.ref import attention_ref

_CONFIG_CACHE: dict = {}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                    config: dict | None = None) -> torch.Tensor:
    """q (B, Hq, Sq, D), k/v (B, Hkv, Skv, D) -> (B, Hq, Sq, D) on q's
    device.  ``config`` is ``{"bq": bq, "bk": bk}``, one of
    ``generator.TILES``."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected (B, H, S, D) tensors, got {tuple(q.shape)}, {tuple(k.shape)}")
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if Sq == 1:
        if Skv % 128 == 0:
            return flash_decode(q, k, v, decode_bk(Skv))
        return attention_ref(q, k, v, causal)
    if Sq % 128 or Skv % 128:
        return attention_ref(q, k, v, causal)
    if config is None:
        key = (B, Hq, Hkv, Sq, Skv, D, causal, q.element_size())
        config = _CONFIG_CACHE.setdefault(key, dict(DEFAULT))
    return flash_attention_fwd(q, k, v, config["bq"], config["bk"], causal)
