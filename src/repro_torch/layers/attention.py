"""GQA attention: the chunked online-softmax path, the flash-kernel path and
the KV cache (full or sliding-window ring, bf16 or int8) for serving (a port
of ``repro.layers.attention``).

``chunked_attention`` is the model-level default, in PyTorch: a loop over
KV chunks with fp32 running statistics (and a one-pass form for decode
shapes).  ``attention_apply(use_pallas=True)`` reaches the port's flash
kernel (``repro_torch.kernels.flash_attention``) where the reference
reaches its Pallas kernel.  The projections stay ``torch.einsum``, as the
reference leaves them to XLA outside any kernel.  The sharding hooks of the
reference (``gather_weight``, ``constrain``) have nothing to do on one
card and are left out.

``KVCache.append`` differs from the reference in one way: it writes into
the cache's storage in place and returns a ``KVCache`` over the same
tensors, where the reference returns a functional copy; a copy of the
whole cache for every decoded token would double its memory and write all
of it once a token.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from repro_torch.kernels import resolve_device

from . import _draw
from .rope import apply_rope

NEG_INF = -1e30


def attention_init(d_model: int, n_heads: int, n_kv: int, head_dim: int, qkv_bias: bool = False,
                   dtype=torch.bfloat16, *, generator: torch.Generator, device="cuda") -> dict:
    """Projection weights with the reference's scales: wq/wk/wv normal
    times d_model^-1/2, wo times (n_heads·head_dim)^-1/2, zero biases;
    drawn in fp32 from ``generator`` (on ``device``) and cast to ``dtype``.
    They lie on the card unless the caller asks for the CPU."""
    device = resolve_device(device)
    normal = functools.partial(_draw.normal, dtype=dtype, generator=generator, device=device)
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


class KVCache(NamedTuple):
    k: torch.Tensor           # (B, Hkv, C, D): bf16 (or the model's dtype), or int8
    v: torch.Tensor
    positions: torch.Tensor   # (B, C) int32 absolute positions, -1 = empty
    cursor: torch.Tensor      # (B,) int32 next write slot (ring) / length (full)
    k_scale: torch.Tensor | None = None  # (B, Hkv, C) fp32 per-(token, head) scales
    v_scale: torch.Tensor | None = None

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None

    @staticmethod
    def init(batch, n_kv, capacity, head_dim, dtype=torch.bfloat16, quantized: bool = False,
             *, device="cuda") -> "KVCache":
        """An empty cache of ``capacity`` slots, on the card unless the
        caller asks for the CPU.  ``quantized=True``: int8 storage with
        per-(token, head) symmetric scales, half the bytes of bf16."""
        dev = resolve_device(device)
        store = torch.int8 if quantized else dtype
        shape = (batch, n_kv, capacity, head_dim)

        def scales():
            return torch.zeros(shape[:3], dtype=torch.float32, device=dev) if quantized else None

        return KVCache(
            k=torch.zeros(shape, dtype=store, device=dev),
            v=torch.zeros(shape, dtype=store, device=dev),
            positions=torch.full((batch, capacity), -1, dtype=torch.int32, device=dev),
            cursor=torch.zeros((batch,), dtype=torch.int32, device=dev),
            k_scale=scales(), v_scale=scales(),
        )

    def dequant(self):
        """The (k, v) the attention reads: the storage itself, or the int8
        codes times their scales as bf16, as the reference gives them."""
        if not self.quantized:
            return self.k, self.v
        k = self.k.float() * self.k_scale[..., None]
        v = self.v.float() * self.v_scale[..., None]
        return k.to(torch.bfloat16), v.to(torch.bfloat16)

    def append(self, k_new, v_new, pos_new) -> "KVCache":
        """Write Sq new entries at the (ring) cursor: slots
        (cursor + arange(Sq)) % C.  k_new: (B, Hkv, Sq, D), pos_new: (B, Sq).
        int8 codes are round(x / max(scale, 1e-8)) with scale = max|x| / 127
        for each (token, head).

        The write is in place: this cache is consumed, and the returned
        ``KVCache`` holds the same tensors (the cursor advanced by Sq).  With
        Sq > C one call writes some slots twice, in no specified order (the
        reference's scatter leaves it unspecified too)."""
        B, Hkv, Sq, D = k_new.shape
        C = self.k.shape[2]
        dev = self.k.device
        idx = (self.cursor.long()[:, None] + torch.arange(Sq, device=dev)[None, :]) % C
        bidx = torch.arange(B, device=dev)[:, None]
        if self.quantized:
            for store, scale, new in ((self.k, self.k_scale, k_new),
                                      (self.v, self.v_scale, v_new)):
                nf = new.float()
                s = nf.abs().amax(dim=-1) / 127.0                       # (B, Hkv, Sq)
                q = torch.round(nf / torch.clamp(s, min=1e-8)[..., None])
                store[bidx, :, idx] = q.transpose(1, 2).to(torch.int8)
                scale[bidx, :, idx] = s.transpose(1, 2)
        else:
            self.k[bidx, :, idx] = k_new.transpose(1, 2).to(self.k.dtype)
            self.v[bidx, :, idx] = v_new.transpose(1, 2).to(self.v.dtype)
        self.positions[bidx, idx] = pos_new.to(self.positions.dtype)
        self.cursor.add_(Sq)
        return self


def attention_apply(params, x, *, n_heads, n_kv, head_dim, causal=True, window=None,
                    rope_theta=10000.0, positions=None, cache: KVCache | None = None,
                    context=None, use_pallas=False, chunk=1024):
    """Full attention block: projections (+bias), RoPE, attention, output
    projection; returns ``(out, new_cache)``, ``new_cache`` None without a
    cache.

    ``context`` switches to cross-attention (K/V from context, no RoPE on it,
    no causal mask).  With ``cache`` set, x is the new-token slice: its K/V
    are appended to the cache (in place: the cache passed in is consumed)
    and ``chunked_attention`` reads the whole cache, as the reference's
    serving path does, whatever ``use_pallas`` says.  Otherwise
    ``use_pallas`` runs the port's flash kernel when there is no context and
    S is a multiple of 128, as the reference runs its Pallas kernel; else
    ``chunked_attention``.
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

    new_cache = None
    if cache is not None:
        new_cache = cache.append(k, v, positions)
        k, v = new_cache.dequant()
        o = chunked_attention(q, k, v, causal=causal, window=window, q_positions=positions,
                              k_positions=new_cache.positions, chunk=chunk)
    elif use_pallas and S % 128 == 0 and context is None:
        from repro_torch.kernels.flash_attention.ops import flash_attention

        o = flash_attention(q, k, v, causal=causal)
    else:
        o = chunked_attention(q, k, v, causal=causal and context is None, window=window,
                              q_positions=positions, chunk=chunk)

    o = o.transpose(1, 2).reshape(B, S, n_heads * head_dim)
    out = torch.einsum("bsh,he->bse", o, params["wo"])
    return out, new_cache
