"""Plain PyTorch version of causal GQA attention (prefill and decode).

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``:
K and V repeated over each query head's group, scores and softmax in fp32,
and the decode-convention causal mask (query i attends keys
[0, Skv - Sq + i]).  The CPU tests run it, the CUDA kernels are held
against it on the card, and ``ops.flash_attention`` sends the shapes the
kernels cannot tile to it, as the reference does.

Split-KV decode, plainly: ``decode_split_bounds`` is the partition of the
cache the tensor-core decode kernel uses, ``decode_partials_ref`` the
partial (O, m, l) of each split in the kernel's workspace layout,
``combine_partials_ref`` the combine kernel's plain version, and
``decode_combine_ref`` the two together.
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


DECODE_BLOCK = 128  # keys of the tensor-core decode kernel's block: the split granularity


def decode_split_bounds(Skv: int, splits: int) -> list:
    """The key ranges [k0, k1) of the ``splits`` parts of a cache of Skv
    keys: split s holds the 128-key blocks [s·nb // splits, (s+1)·nb //
    splits) of its nb = ceil(Skv / 128) blocks (the last block may be cut
    by Skv), so every key lies in exactly one split; 1 <= splits <= nb."""
    nb = -(-Skv // DECODE_BLOCK)
    if not 1 <= splits <= nb:
        raise ValueError(f"splits={splits} must lie in [1, {nb}] for Skv={Skv}")
    return [(min(Skv, s * nb // splits * DECODE_BLOCK), min(Skv, (s + 1) * nb // splits * DECODE_BLOCK))
            for s in range(splits)]


def decode_partials_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int) -> torch.Tensor:
    """(B, Hq, splits, D + 2) fp32: for each split of the cache, the
    unnormalised ``sum_j e^(s_j - m) v_j`` (D values), the split's max m of
    the scaled scores s_j and its sum l = ``sum_j e^(s_j - m)``, in fp32
    from one query token q (B, Hq, 1, D)."""
    B, Hq, _, D = q.shape
    group, scale = Hq // k.shape[1], D ** -0.5
    kr = k.repeat_interleave(group, dim=1).float()
    vr = v.repeat_interleave(group, dim=1).float()
    parts = []
    for k0, k1 in decode_split_bounds(k.shape[2], splits):
        s = torch.einsum("bhqd,bhkd->bhqk", q.float(), kr[:, :, k0:k1]) * scale  # (B, Hq, 1, n)
        m = s.amax(dim=-1, keepdim=True)
        e = torch.exp(s - m)
        o = torch.einsum("bhqk,bhkd->bhqd", e, vr[:, :, k0:k1])
        parts.append(torch.cat([o, m, e.sum(dim=-1, keepdim=True)], dim=-1))
    return torch.cat(parts, dim=2)


def combine_partials_ref(part: torch.Tensor, dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """(B, Hq, 1, D) in ``dtype`` from the partials (B, Hq, splits, D + 2):
    m = max_s m_s, o = sum_s e^(m_s - m) O_s / max(sum_s e^(m_s - m) l_s,
    1e-30), the reference's final division."""
    D = part.shape[-1] - 2
    o, m, l = part[..., :D].float(), part[..., D].float(), part[..., D + 1].float()
    w = torch.exp(m - m.amax(dim=-1, keepdim=True))                      # (B, Hq, splits)
    acc = torch.einsum("bhs,bhsd->bhd", w, o)
    return (acc / (w * l).sum(dim=-1, keepdim=True).clamp_min(1e-30)).unsqueeze(2).to(dtype)


def decode_combine_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, splits: int) -> torch.Tensor:
    """Decode of one token (B, Hq, 1, D) with the cache split as the
    tensor-core kernel splits it: each split's partials, then combined."""
    return combine_partials_ref(decode_partials_ref(q, k, v, splits), q.dtype)
