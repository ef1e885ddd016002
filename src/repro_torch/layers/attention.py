"""GQA attention: the chunked online-softmax path and the flash-kernel path
(a port of ``repro.layers.attention`` without its KV cache).

``chunked_attention`` is the model-level default, in PyTorch: a loop over
KV chunks with fp32 running statistics (and a one-pass form for decode
shapes).  ``attention_apply(use_pallas=True)`` reaches the port's flash
kernel (``repro_torch.kernels.flash_attention``) where the reference
reaches its Pallas kernel.  The projections stay ``torch.einsum``, as the
reference leaves them to XLA outside any kernel.  The sharding hooks of the
reference (``gather_weight``, ``constrain``) have nothing to do on one
card and are left out; ``KVCache`` and the cache branch come with the LM
stack.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import resolve_device

from .rope import apply_rope

NEG_INF = -1e30


def attention_init(d_model: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool = False,
                   dtype=torch.bfloat16, *, generator: torch.Generator, device="cuda") -> dict:
    """Projection weights with the reference's scales: wq/wk/wv normal
    times d_model^-1/2, wo times (n_heads·head_dim)^-1/2, zero biases;
    drawn in fp32 from ``generator`` (on ``device``) and cast to ``dtype``.
    They lie on the card unless the caller asks for the CPU."""
    device = resolve_device(device)

    def normal(shape, scale):
        w = torch.randn(shape, generator=generator, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    s = d_model ** -0.5
    p = {
        "wq": normal((d_model, n_heads * head_dim), s),
        "wk": normal((d_model, n_kv * head_dim), s),
        "wv": normal((d_model, n_kv * head_dim), s),
        "wo": normal((n_heads * head_dim, d_model), (n_heads * head_dim) ** -0.5),
    }
    if qkv_bias:
        p["bq"] = torch.zeros((n_heads * head_dim,), dtype=dtype, device=device)
        p["bk"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
        p["bv"] = torch.zeros((n_kv * head_dim,), dtype=dtype, device=device)
    return p


def _positions(pos, n: int, B: int) -> torch.Tensor:
    return pos.expand(B, n) if pos.dim() == 1 else pos


def chunked_attention(q, k, v, *, causal=True, window=None, q_positions=None,
                      k_positions=None, chunk=1024):
    """Online-softmax attention over KV chunks.

    q: (B, Hq, Sq, D);  k/v: (B, Hkv, Skv, D).
    positions: absolute positions (B, S) or (S,); invalid cache slots carry
    position -1 and are masked out.
    """
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    scale = D ** -0.5
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(Sq, device=dev) + (Skv - Sq)
    if k_positions is None:
        k_positions = torch.arange(Skv, device=dev)
    q_positions = _positions(q_positions, Sq, B)
    k_positions = _positions(k_positions, Skv, B)
    qpos = q_positions[:, None, None, :, None]

    def valid_of(kpos):
        kpos = kpos[:, None, None, None, :]
        valid = kpos >= 0
        if causal:
            valid = valid & (kpos <= qpos)
        if window is not None:
            valid = valid & ((qpos - kpos) < window)
        return valid

    qf = q.float().reshape(B, Hkv, group, Sq, D)
    if Sq <= 4:
        # decode: the (B, H, Sq, Skv) scores are small enough for one pass
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float()) * scale
        s = torch.where(valid_of(k_positions), s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
        return out.reshape(B, Hq, Sq, D).to(q.dtype)

    chunk = min(chunk, Skv)
    nchunks = -(-Skv // chunk)
    pad = nchunks * chunk - Skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        k_positions = torch.nn.functional.pad(k_positions, (0, pad), value=-1)

    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Hkv, group, Sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, Hkv, group, Sq, D), dtype=torch.float32, device=dev)
    for c in range(nchunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        kb, vb = k[:, :, sl].float(), v[:, :, sl].float()
        s = torch.einsum("bhgqd,bhkd->bhgqk", qf, kb) * scale
        s = torch.where(valid_of(k_positions[:, sl]), s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhgqk,bhkd->bhgqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.reshape(B, Hq, Sq, D).to(q.dtype)


def attention_apply(params, x, *, n_heads, n_kv, head_dim, causal=True, window=None,
                    rope_theta=10000.0, positions=None, context=None, use_pallas=False,
                    chunk=1024):
    """Full attention block: projections (+bias), RoPE, attention, output
    projection; returns ``(out, None)`` as the reference does without a
    cache.

    ``context`` switches to cross-attention (K/V from context, no RoPE on it,
    no causal mask).  ``use_pallas`` runs the port's flash kernel when there
    is no context and S is a multiple of 128, as the reference runs its
    Pallas kernel; otherwise ``chunked_attention``.
    """
    B, S, E = x.shape
    q = torch.einsum("bse,ehd->bshd", x, params["wq"].reshape(E, n_heads, head_dim))
    if "bq" in params:
        q = q + params["bq"].reshape(n_heads, head_dim)
    kv_src = context if context is not None else x
    k = torch.einsum("bse,ehd->bshd", kv_src, params["wk"].reshape(E, n_kv, head_dim))
    v = torch.einsum("bse,ehd->bshd", kv_src, params["wv"].reshape(E, n_kv, head_dim))
    if "bk" in params:
        k = k + params["bk"].reshape(n_kv, head_dim)
        v = v + params["bv"].reshape(n_kv, head_dim)

    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=x.device)[None, :].expand(B, S)

    if context is None and rope_theta:
        q = apply_rope(q.transpose(1, 2), positions[:, None, :], rope_theta)
        k = apply_rope(k.transpose(1, 2), positions[:, None, :], rope_theta)
    else:
        q = q.transpose(1, 2)
        k = k.transpose(1, 2)
    v = v.transpose(1, 2)

    if use_pallas and S % 128 == 0 and context is None:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        o = flash_attention(q, k, v, causal=causal)
    else:
        o = chunked_attention(q, k, v, causal=causal and context is None, window=window,
                              q_positions=positions, chunk=chunk)

    o = o.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    out = torch.einsum("bsh,he->bse", o, params["wo"])
    return out, None
