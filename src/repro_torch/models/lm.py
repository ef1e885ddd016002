"""Unified LM covering all ten architectures (a port of ``repro.models.lm``).

One parameterised decoder (plus an optional encoder) built from the port's
layer library.  The parameter and cache trees keep the reference's stacked
layout: every per-layer leaf has a leading ``n_layers`` (or ``enc_layers``,
or shared-block) axis, so they match the JAX trees leaf for leaf.  The
reference's ``lax.scan`` over layers becomes a Python loop over the views
of each stacked parameter, taken by one ``unbind`` (so its gradient is
stacked once, as the scan's transpose gives it), and its ``jax.checkpoint`` (``cfg.remat``) becomes
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)`` around a
block while autograd is on and no cache is passed (recomputing a block
would append to its cache twice); under ``torch.inference_mode()``, as
serving runs, it does nothing.

Block patterns:
  * ``attn``         — [dense|moe] transformer blocks (qwen/phi3/granite/
                       internvl2/mixtral/arctic/whisper-decoder)
  * ``rwkv``         — RWKV6 time mix + channel mix (attention-free)
  * ``mamba_hybrid`` — Mamba2 blocks with a weight-shared attention + MLP
                       block after every ``hybrid_attn_every`` of them (zamba2)

What ``forward`` does to the caches it is given (the reference's are
functional; copying every layer's whole cache per decoded token would
double its memory and write all of it each step):

  * KV caches (``"kv"``, ``"shared_kv"``) are written in place through the
    per-layer views (``KVCache.append``): the caches passed in are consumed,
    and the returned tree holds the very same tensors.
  * SSM states (``"mamba"``, ``"rwkv"``) are left as they were passed: each
    layer's new state is a new tensor, and the returned tree stacks them
    (``torch.stack``), their dtype the block's output's, as the reference's
    scan returns them.  They are small (a few MB a layer).

The whisper decoder recomputes its cross-attention K and V from
``encoder_out`` at every step: the reference keeps no cross cache.

Parameters, tokens and caches placed across devices (DTensors on a
``DeviceMesh``, ``train.sharding.place``) run the same code: the
reference's ``constrain`` sites (the embedded tokens, the residual stream
between blocks, the logits over the vocab) redistribute them to the
activation axes that ``train.sharding.set_activation_axes`` set.  The
embedding's rows come from the table placed (tp, fsdp), gathered whole
(``_embed``), and each stacked leaf's one ``unbind`` splits its lead dim,
which no spec shards.  Plain tensors run as they did.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels import resolve_device
from repro_torch.layers import _draw
from repro_torch.layers.attention import KVCache, attention_apply, attention_init
from repro_torch.layers.mlp import gelu_mlp, gelu_mlp_init, swiglu, swiglu_init
from repro_torch.layers.moe import moe_apply, moe_init
from repro_torch.layers.norms import layernorm, layernorm_init, rmsnorm, rmsnorm_init
from repro_torch.layers.ssm import (
    Mamba2State,
    RWKV6State,
    mamba2_apply,
    mamba2_init,
    rwkv6_apply,
    rwkv6_channel_mix,
    rwkv6_channel_mix_init,
    rwkv6_init,
)
from repro_torch.train import sharding
from repro_torch.train.sharding import constrain

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _norm_init(cfg: ArchConfig, dim=None, *, device):
    dim = dim or cfg.d_model
    init = rmsnorm_init if cfg.norm == "rmsnorm" else layernorm_init
    return init(dim, device=device)


def _norm(cfg: ArchConfig, p, x):
    return rmsnorm(p, x) if cfg.norm == "rmsnorm" else layernorm(p, x)


def _gathered(cfg: ArchConfig, x):
    """A normed residual stream before the products that read it: under
    Megatron-style sequence parallelism (``cfg.seq_parallel``, the residual's
    sequence over 'model' between blocks) its sequence is gathered here, as
    Megatron-SP all-gathers before a column-parallel product; DTensor (torch
    2.11) refuses to flatten (B, S) for a product with S sharded.  The
    identity otherwise, and on a plain tensor."""
    return constrain(x, ("dp", None, None)) if cfg.seq_parallel else x


def _scattered(cfg: ArchConfig, x):
    """A sublayer's output before it joins the residual stream: under
    sequence parallelism its sequence goes back over 'model' (Megatron-SP's
    reduce-scatter after a row-parallel product), so that the gradient
    comes back through this redistribute with the sequence whole, as the
    sublayer's reshapes need it (torch 2.11).  Otherwise the row-parallel
    product's partial sum is reduced (Megatron's all-reduce), the batch
    keeping the data axes where they divide it: left to itself DTensor
    reduce-scatters it onto the sequence, which the next products flatten
    into a strided shard (refused by torch 2.11, and minutes to plan on a
    3-D mesh in torch 2.13).  The identity on a plain tensor."""
    if cfg.seq_parallel:
        return constrain(x, ("dp", "tp", None))
    return sharding.redistribute(x, ("dp", None, None))


# ===========================================================================
# Trees: nests of dicts and (named) tuples of tensors, None leaves kept
# ===========================================================================
def _map(fn, tree, *rest):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, tuple):
        vals = [_map(fn, v, *(r[j] for r in rest)) for j, v in enumerate(tree)]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return fn(tree, *rest)


def _index(tree, i: int):
    """Layer ``i``'s views of a stacked tree."""
    return _map(lambda t: t[i], tree)


def _unstack(tree, n: int) -> list:
    """Layer ``i``'s views of a stacked tree for every ``i``, by one
    ``unbind`` a leaf.  Its backward stacks the layers' gradients once,
    where ``n`` selects (``_index``) would each give a zero-filled gradient
    of the whole stacked leaf to be added up: ``n`` passes over the stack
    (``python -m repro_torch.train.ablate`` times both)."""
    if tree is None:
        return [None] * n
    if isinstance(tree, dict):
        per = {k: _unstack(v, n) for k, v in tree.items()}
        return [{k: per[k][i] for k in tree} for i in range(n)]
    if isinstance(tree, tuple):
        per = [_unstack(v, n) for v in tree]
        if hasattr(tree, "_fields"):
            return [type(tree)(*(p[i] for p in per)) for i in range(n)]
        return [tuple(p[i] for p in per) for i in range(n)]
    return list(tree.unbind(0))


def _stack(trees: list):
    """Per-layer trees stacked along a new leading axis."""
    return _map(lambda *ts: torch.stack(ts), *trees)


def _repeat(tree, n: int):
    """``n`` copies of ``tree`` stacked: each leaf's values (zeros, -1
    positions) repeated along a new leading axis."""
    return _map(lambda t: t.expand(n, *t.shape).clone(), tree)


def _stacked(make, n: int):
    """``make()`` drawn ``n`` times into one stacked tree.  The stack is
    allocated once and each layer's draw is copied in and freed, so the
    peak is the stack plus one layer (a draw is fp32 before its cast)."""
    layer = make()
    out = _map(lambda t: t.new_empty((n, *t.shape)), layer)
    for i in range(n):
        if i:
            layer = make()
        _map(lambda dst, src: dst[i].copy_(src), out, layer)
        del layer
    return out


# ===========================================================================
# Parameter init
# ===========================================================================
def _attn_block_init(cfg: ArchConfig, dtype, *, generator, device) -> dict:
    draw = dict(generator=generator, device=device)
    p = {
        "ln1": _norm_init(cfg, device=device),
        "attn": attention_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
                               cfg.qkv_bias, dtype, **draw),
        "ln2": _norm_init(cfg, device=device),
    }
    if cfg.n_experts:
        p["moe"] = moe_init(cfg.d_model, cfg.d_ff, cfg.n_experts, dtype, **draw)
        if cfg.dense_residual:
            p["mlp"] = swiglu_init(cfg.d_model, cfg.d_ff, dtype, **draw)
    elif cfg.mlp == "swiglu":
        p["mlp"] = swiglu_init(cfg.d_model, cfg.d_ff, dtype, **draw)
    else:
        p["mlp"] = gelu_mlp_init(cfg.d_model, cfg.d_ff, dtype, **draw)
    return p


def _rwkv_block_init(cfg: ArchConfig, dtype, *, generator, device) -> dict:
    draw = dict(generator=generator, device=device)
    return {
        "ln1": _norm_init(cfg, device=device),
        "time": rwkv6_init(cfg.d_model, cfg.ssm_head_dim, dtype=dtype, **draw),
        "ln2": _norm_init(cfg, device=device),
        "chan": rwkv6_channel_mix_init(cfg.d_model, cfg.d_ff, dtype, **draw),
    }


def _mamba_block_init(cfg: ArchConfig, dtype, *, generator, device) -> dict:
    return {
        "ln": _norm_init(cfg, device=device),
        "mamba": mamba2_init(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim, dtype=dtype,
                             generator=generator, device=device),
    }


def _cross_init(cfg: ArchConfig, dtype, *, generator, device) -> dict:
    return {
        "ln": _norm_init(cfg, device=device),
        "attn": attention_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
                               False, dtype, generator=generator, device=device),
    }


_BLOCK_INITS = {"attn": _attn_block_init, "rwkv": _rwkv_block_init,
                "mamba_hybrid": _mamba_block_init}


def init_params(cfg: ArchConfig, *, generator: torch.Generator, device="cuda") -> dict:
    """The reference's parameter tree and scales, drawn from ``generator``
    (on ``device``) in fp32 and cast to ``cfg.param_dtype``; on the card
    unless the caller asks for the CPU."""
    device = resolve_device(device)
    dtype = DTYPES[cfg.param_dtype]
    kw = dict(generator=generator, device=device)
    p: dict = {
        "embed": _draw.normal((cfg.padded_vocab, cfg.d_model), 0.02, dtype, **kw),
        "final_norm": _norm_init(cfg, device=device),
        "lm_head": _draw.normal((cfg.d_model, cfg.padded_vocab), cfg.d_model ** -0.5, dtype,
                                **kw),
    }
    if cfg.block_pattern not in _BLOCK_INITS:
        raise ValueError(cfg.block_pattern)
    block = _BLOCK_INITS[cfg.block_pattern]
    p["layers"] = _stacked(lambda: block(cfg, dtype, **kw), cfg.n_layers)
    if cfg.block_pattern == "mamba_hybrid":
        p["shared_attn"] = _attn_block_init(cfg, dtype, **kw)
    if cfg.enc_layers:
        p["enc_layers"] = _stacked(lambda: _attn_block_init(cfg, dtype, **kw), cfg.enc_layers)
        p["enc_norm"] = _norm_init(cfg, device=device)
        p["cross_layers"] = _stacked(lambda: _cross_init(cfg, dtype, **kw), cfg.n_layers)
    if cfg.frontend:
        p["frontend_proj"] = _draw.normal((cfg.frontend_dim, cfg.d_model),
                                          cfg.frontend_dim ** -0.5, dtype, **kw)
    return p


# ===========================================================================
# Blocks (apply)
# ===========================================================================
def _attn_block(cfg: ArchConfig, p, h, positions, cache, context=None):
    a, new_cache = attention_apply(
        p["attn"], _gathered(cfg, _norm(cfg, p["ln1"], h)),
        n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
        causal=context is None, window=cfg.swa_window or None,
        rope_theta=cfg.rope_theta if context is None else 0.0,
        positions=positions, cache=cache, context=context,
    )
    h = h + _scattered(cfg, a)
    hn = _gathered(cfg, _norm(cfg, p["ln2"], h))
    if cfg.n_experts:
        f = moe_apply(p["moe"], hn, top_k=cfg.top_k)
        if cfg.dense_residual:
            f = f + swiglu(p["mlp"], hn)
    elif cfg.mlp == "swiglu":
        f = swiglu(p["mlp"], hn)
    else:
        f = gelu_mlp(p["mlp"], hn)
    return h + _scattered(cfg, f), new_cache


def _rwkv_block(cfg: ArchConfig, p, h, state):
    tstate = state[0] if state is not None else None
    cprev = state[1] if state is not None else None
    t_out, new_t = rwkv6_apply(p["time"], _norm(cfg, p["ln1"], h), tstate, cfg.ssm_head_dim)
    h = h + t_out
    c_out, new_prev = rwkv6_channel_mix(p["chan"], _norm(cfg, p["ln2"], h), cprev)
    return h + c_out, (new_t, new_prev)


def _mamba_block(cfg: ArchConfig, p, h, state):
    out, new_state = mamba2_apply(p["mamba"], _norm(cfg, p["ln"], h), state,
                                  cfg.ssm_state, cfg.ssm_head_dim)
    return h + out, new_state


# ===========================================================================
# Cache containers
# ===========================================================================
def init_caches(cfg: ArchConfig, batch: int, capacity: int, dtype=torch.bfloat16, *,
                device="cuda") -> dict:
    """Stacked per-layer serving caches, on the card unless the caller asks
    for the CPU.  ``capacity`` = max KV length (the sliding window caps it
    for SWA archs — the long_500k enabler); ``cfg.kv_int8`` stores K and V
    as int8 with per-(token, head) scales."""
    device = resolve_device(device)
    cap = min(capacity, cfg.swa_window) if cfg.swa_window else capacity
    hd = cfg.resolved_head_dim

    def kv(n):
        return _repeat(KVCache.init(batch, cfg.n_kv, cap, hd, dtype, quantized=cfg.kv_int8,
                                    device=device), n)

    def zeros(shape, dt):
        return torch.zeros(shape, dtype=dt, device=device)

    if cfg.block_pattern == "attn":
        return {"kv": kv(cfg.n_layers)}
    if cfg.block_pattern == "rwkv":
        H = cfg.d_model // cfg.ssm_head_dim
        K = V = cfg.ssm_head_dim
        return {"rwkv": _repeat((RWKV6State(zeros((batch, H, K, V), torch.float32),
                                            zeros((batch, cfg.d_model), dtype)),
                                 zeros((batch, cfg.d_model), dtype)), cfg.n_layers)}
    if cfg.block_pattern == "mamba_hybrid":
        d_inner = 2 * cfg.d_model
        H = d_inner // cfg.ssm_head_dim
        return {
            "mamba": _repeat(Mamba2State(
                zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                zeros((batch, 3, d_inner), dtype)), cfg.n_layers),
            "shared_kv": kv(cfg.n_layers // cfg.hybrid_attn_every),
        }
    raise ValueError(cfg.block_pattern)


# ===========================================================================
# Forward
# ===========================================================================
def _remat(cfg: ArchConfig, caches) -> bool:
    return cfg.remat and caches is None and torch.is_grad_enabled()


def _scan_blocks(cfg: ArchConfig, fn, h, stacked, caches, n: int):
    """The reference's layer scan as a loop: ``fn(h, layer_params, cache) ->
    (h, new_cache)`` over the leading axis of ``stacked`` (and of ``caches``,
    None for none); returns (h, the per-layer new caches)."""
    res_tags = ("dp", "tp", None) if cfg.seq_parallel else ("dp", None, None)

    def body(carry, lp, lc):
        # the reference's optional Megatron-SP residual stream tags
        carry = constrain(carry, res_tags)
        out, new_c = fn(carry, lp, lc)
        return constrain(out, res_tags), new_c

    remat = _remat(cfg, caches)
    layers = _unstack(stacked, n)
    new = []
    for i in range(n):
        lc = None if caches is None else _index(caches, i)
        args = (h, layers[i], lc)
        h, c = checkpoint(body, *args, use_reentrant=False) if remat else body(*args)
        new.append(c)
    return h, new


def _embed(table, tokens):
    """The table's rows of ``tokens`` (B, S).  A placed table is gathered
    whole and each rank looks up its batch shard's rows
    (``train.sharding.shard_local``): DTensor's index and embedding
    strategies fail on a table sharded on both dims (the index's backward,
    an accumulating ``index_put``, in torch 2.11; the embedding's masked
    partial sum in 2.13)."""
    return sharding.shard_local(lambda t, ids: t[ids.long()],
                                [(table, (None, None)), (tokens, ("dp", None))],
                                ("dp", None, None), (*tokens.shape, table.shape[1]))


def forward(cfg: ArchConfig, params, tokens, *, positions=None, caches=None,
            frontend_embeds=None, encoder_out=None, last_only: bool = False):
    """Returns (logits, new_caches, encoder_out).

    Training/prefill: caches=None or empty caches.  Decode: tokens (B, 1)
    with caches + positions.  ``frontend_embeds``: (B, N, frontend_dim) for
    vlm/audio archs.  ``encoder_out`` short-circuits the encoder for decode.
    KV caches are written in place and SSM states come back new (the
    module's docstring); logits are fp32.
    """
    dtype = DTYPES[cfg.param_dtype]
    B, S = tokens.shape
    dev = tokens.device
    h = constrain(_embed(params["embed"], tokens), ("dp", None, None))

    if cfg.frontend == "vision" and frontend_embeds is not None:
        patches = torch.einsum("bnf,fe->bne", frontend_embeds.to(dtype), params["frontend_proj"])
        h = torch.cat([patches, h], dim=1)
        S = h.shape[1]

    if positions is None:
        positions = torch.arange(S, dtype=torch.int32, device=dev)[None].expand(B, S)

    # --- encoder (whisper) ------------------------------------------------
    if cfg.enc_layers and encoder_out is None:
        if frontend_embeds is None:
            raise ValueError("encoder-decoder arch needs frontend embeddings")
        e = torch.einsum("bnf,fe->bne", frontend_embeds.to(dtype), params["frontend_proj"])
        e_pos = torch.arange(e.shape[1], dtype=torch.int32, device=dev)[None].expand(B, -1)

        def enc_fn(hh, lp, lc):
            out, _ = attention_apply(
                lp["attn"], _norm(cfg, lp["ln1"], hh),
                n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
                causal=False, rope_theta=cfg.rope_theta, positions=e_pos,
            )
            hh = hh + out
            hn = _norm(cfg, lp["ln2"], hh)
            f = gelu_mlp(lp["mlp"], hn) if cfg.mlp == "gelu" else swiglu(lp["mlp"], hn)
            return hh + f, lc

        e, _ = _scan_blocks(cfg, enc_fn, e, params["enc_layers"], None, cfg.enc_layers)
        encoder_out = _norm(cfg, params["enc_norm"], e)

    # --- decoder stack ----------------------------------------------------
    if cfg.block_pattern == "attn":
        kv = caches["kv"] if caches else None

        def fn(hh, lps, lc):
            lp, cp = lps if cfg.enc_layers else (lps, None)
            hh, new_c = _attn_block(cfg, lp, hh, positions, lc)
            if cp is not None:
                # cross-attention after each self-attention block
                x_out, _ = attention_apply(
                    cp["attn"], _norm(cfg, cp["ln"], hh),
                    n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
                    causal=False, rope_theta=0.0, positions=positions, context=encoder_out,
                )
                hh = hh + x_out
            return hh, new_c

        stacked = ((params["layers"], params["cross_layers"]) if cfg.enc_layers
                   else params["layers"])
        h, _ = _scan_blocks(cfg, fn, h, stacked, kv, cfg.n_layers)
        new_caches = None if kv is None else {"kv": kv}

    elif cfg.block_pattern == "rwkv":
        st = caches["rwkv"] if caches else None
        h, new_st = _scan_blocks(cfg, lambda hh, lp, lc: _rwkv_block(cfg, lp, hh, lc), h,
                                 params["layers"], st, cfg.n_layers)
        new_caches = None if st is None else {"rwkv": _stack(new_st)}

    elif cfg.block_pattern == "mamba_hybrid":
        k = cfg.hybrid_attn_every
        if cfg.n_layers % k:
            raise ValueError(f"n_layers {cfg.n_layers} is not a multiple of "
                             f"hybrid_attn_every {k}")
        mst = caches["mamba"] if caches else None
        skv = caches["shared_kv"] if caches else None
        layers = _unstack(params["layers"], cfg.n_layers)

        def group(carry, g):
            # k Mamba2 blocks, then the weight-shared attention block with
            # this group's own KV cache
            hh = constrain(carry, ("dp", None, None))
            new_m = []
            for i in range(g * k, (g + 1) * k):
                hh, s = _mamba_block(cfg, layers[i], hh,
                                     None if mst is None else _index(mst, i))
                new_m.append(s)
            hh, _ = _attn_block(cfg, params["shared_attn"], hh, positions,
                                None if skv is None else _index(skv, g))
            return constrain(hh, ("dp", None, None)), new_m

        remat = _remat(cfg, mst)
        new_mst = []
        for g in range(cfg.n_layers // k):
            h, m = checkpoint(group, h, g, use_reentrant=False) if remat else group(h, g)
            new_mst += m
        new_caches = None if mst is None else {"mamba": _stack(new_mst), "shared_kv": skv}
    else:
        raise ValueError(cfg.block_pattern)

    h = _gathered(cfg, _norm(cfg, params["final_norm"], h))
    if last_only:
        h = h[:, -1:]  # avoid materializing (B, S, V) logits in prefill
    logits = torch.einsum("bse,ev->bsv", h, params["lm_head"]).float()
    logits = constrain(logits, ("dp", None, "tp"))
    return logits, new_caches, encoder_out
