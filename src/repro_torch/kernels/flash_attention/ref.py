"""Plain PyTorch version of causal GQA attention (prefill and decode).

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``:
K and V repeated over each query head's group, scores and softmax in fp32,
and the decode-convention causal mask (query i attends keys
[0, Skv - Sq + i]).  The CPU tests run it, the CUDA kernels are held
against it on the card, and ``ops.flash_attention`` sends the shapes the
kernels cannot tile to it, as the reference does.
"""
from __future__ import annotations

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
                  scale: float | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Skv, D); GQA via head repetition."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = scale if scale is not None else D ** -0.5
    kr = k.repeat_interleave(group, dim=1)
    vr = v.repeat_interleave(group, dim=1)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr.float()) * scale
    if causal:
        qi = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
        ki = torch.arange(Skv, device=q.device)[None, :]
        s = s.masked_fill(ki > qi, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)
    return torch.einsum("bhqk,bhkd->bhqd", p, vr.float()).to(q.dtype)


def row_rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest relative L2 error over the rows (the last axis) of ``got``
    against ``want``, in fp32.  An attention output is a softmax average,
    about sqrt(e / Skv) in size far from the first keys, so an absolute
    bound passes a kernel that skips a block of keys; this one does not."""
    g, w = got.float(), want.float()
    return float(((g - w).norm(dim=-1) / w.norm(dim=-1).clamp_min(1e-30)).max())
