"""Plain PyTorch version of causal GQA attention (prefill and decode).

The counterpart of ``repro.kernels.flash_attention.ref.attention_ref``:
K and V repeated over each query head's group, scores and softmax in fp32,
and the decode-convention causal mask (query i attends keys
[0, Skv - Sq + i]).  The CPU tests run it, the CUDA kernels are held
against it on the card, and ``ops.flash_attention`` sends the shapes the
kernels cannot tile to it, as the reference does.  A causal row that sees
no key (Sq > Skv) gets NaN from its -inf mask; ``attention_blocks_ref``
gives it the reference kernel's value at a tile (bq, bk) instead, as the
forward kernels do.

``attention_split_tf32_ref`` emulates the fp32 forward kernel's three TF32
passes in its order (blocks of 64 keys, the online softmax, p split into
TF32 hi and lo, ``split_tf32_mma``), so the tests can show what the passes
keep of fp32's accuracy; no main path uses it.  ``attention_fp64_ref`` is
the exact answer an fp32 output's error is measured against.

Split-KV decode, plainly: ``decode_split_bounds`` is the partition of the
cache both decode kernels use, ``decode_partials_ref`` the
partial (O, m, l) of each split in the kernel's workspace layout,
``combine_partials_ref`` the combine kernel's plain version, and
``decode_combine_ref`` the two together.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.matmul.ref import tf32_round

NEG_INF = -1e30  # the reference's finite mask value
SPLIT_BLOCK = 64  # keys of the fp32 forward kernel's ring stage
_TF32_MASK = -(1 << 13)  # clears the 13 mantissa bits TF32 drops


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


def no_key_keys(Sq: int, Skv: int, bq: int, bk: int) -> torch.Tensor:
    """(Sq,) int64: for each causal query row that sees no key (i + Skv -
    Sq < 0), the number of keys the reference's kernel averages at the tile
    (bq, bk): its KV blocks kb of the row's q block qb = i // bq are those
    with kb·bk <= qb·bq + bq - 1 + (Skv - Sq) (the rest skipped), each key
    masked to the finite NEG_INF, so p = 1 for each; 0 where it computes
    none.  -1 for a row that sees a key."""
    off = Skv - Sq
    rows = torch.arange(Sq)
    lim = rows // bq * bq + bq - 1 + off
    keys = torch.where(lim < 0, 0, torch.clamp((lim // bk + 1) * bk, max=Skv))
    return torch.where(rows + off < 0, keys, -1)


def attention_blocks_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                         bq: int, bk: int) -> torch.Tensor:
    """The reference kernel's attention at the tile (bq, bk): ``attention_ref``
    for every row that sees a key, and for a causal row that sees none (Sq >
    Skv) the mean of V over the keys ``no_key_keys`` gives, or 0 where there
    are none (the kernel's o = acc / max(l, 1e-30) of empty sums), where
    ``attention_ref``'s -inf mask gives NaN."""
    out = attention_ref(q, k, v, causal)
    Sq, Skv = q.shape[2], k.shape[2]
    if not causal or Sq <= Skv:
        return out
    keys = no_key_keys(Sq, Skv, bq, bk)
    group = q.shape[1] // k.shape[1]
    vr = v.repeat_interleave(group, dim=1).float()
    ones = torch.ones((1, bk), dtype=torch.float32, device=q.device)
    for n in keys[keys >= 0].unique().tolist():
        rows = (keys == n).nonzero().flatten().to(q.device)
        # as the kernel sums them: each KV block's P V (p = 1), then / l
        acc = torch.zeros_like(vr[:, :, :1])
        for k0 in range(0, n, bk):
            acc = acc + ones @ vr[:, :, k0:k0 + bk]
        out[:, :, rows] = (acc / max(n, 1)).expand(-1, -1, rows.numel(), -1).to(out.dtype)
    return out


def split_tf32_mma(x: torch.Tensor) -> tuple:
    """(hi, lo) of fp32 ``x`` as the fp32 forward kernel hands it to the
    tensor cores: hi = tf32(x) (``tf32_round``: nearest, ties away from
    zero, as ``cvt.rna.tf32.f32``) and lo = x - hi (exact in fp32) as the
    MMA reads it, its low 13 mantissa bits dropped (towards zero)."""
    x = x.float().contiguous()
    hi = tf32_round(x)
    lo = ((x - hi).view(torch.int32) & _TF32_MASK).view(torch.float32)
    return hi, lo


def attention_split_tf32_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool = True) -> torch.Tensor:
    """Attention in fp32 as ``flash_fwd_tf32_kernel`` sums it: q, k, v
    split into TF32 hi and lo (``split_tf32_mma``), and
    for each block of 64 keys S = q_hi k_hi + (q_lo k_hi + q_hi k_lo), the
    online softmax in the exp2 domain (x = S·scale·log2 e, masked keys the
    reference's finite NEG_INF), p split likewise and O = O·corr + (p_hi
    v_hi + (p_lo v_hi + p_hi v_lo)); o = O / max(l, 1e-30), in q's dtype.
    Each product is an fp32 matmul here, so only the split and the order
    are emulated, not the tensor cores' own rounding.  Rows that see no key
    (Sq > Skv) are out of its scope."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    c = torch.tensor(D ** -0.5, dtype=torch.float32) * torch.tensor(math.log2(math.e),
                                                                    dtype=torch.float32)
    qh, ql = split_tf32_mma(q)
    kh, kl = split_tf32_mma(k.repeat_interleave(group, dim=1))
    vh, vl = split_tf32_mma(v.repeat_interleave(group, dim=1))
    m = torch.full((B, Hq, Sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((B, Hq, Sq, 1), device=q.device)
    o = torch.zeros((B, Hq, Sq, D), device=q.device)
    rows = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    for k0 in range(0, Skv, SPLIT_BLOCK):
        blk = slice(k0, min(Skv, k0 + SPLIT_BLOCK))
        s = qh @ kh[:, :, blk].mT + (ql @ kh[:, :, blk].mT + qh @ kl[:, :, blk].mT)
        x = s * c
        if causal:
            keys = torch.arange(blk.start, blk.stop, device=q.device)[None, :]
            x = x.masked_fill(keys > rows, NEG_INF)
        m_new = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        corr, p = torch.exp2(m - m_new), torch.exp2(x - m_new)
        l = l * corr + p.sum(dim=-1, keepdim=True)
        ph, pl = split_tf32_mma(p)
        o = o * corr + (ph @ vh[:, :, blk] + (pl @ vh[:, :, blk] + ph @ vl[:, :, blk]))
        m = m_new
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def attention_fp64_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       causal: bool = True) -> torch.Tensor:
    """``attention_ref``'s function computed in fp64 and returned in fp64,
    one (b, query head) at a time so the scores stay small: the exact
    answer an fp32 output's error is measured against."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    out = torch.empty((B, Hq, Sq, D), dtype=torch.float64, device=q.device)
    keys = torch.arange(Skv, device=q.device)[None, :]
    masked = keys > torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)
    for b in range(B):
        for h in range(Hq):
            s = q[b, h].double() @ k[b, h // group].double().mT * D ** -0.5
            if causal:
                s = s.masked_fill(masked, float("-inf"))
            out[b, h] = torch.softmax(s, dim=-1) @ v[b, h // group].double()
    return out


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
    """Decode of one token (B, Hq, 1, D) with the cache split as the decode
    kernels split it: each split's partials, then combined."""
    return combine_partials_ref(decode_partials_ref(q, k, v, splits), q.dtype)
