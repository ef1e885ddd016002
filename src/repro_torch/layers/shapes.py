"""GEMM shapes of the layer library, without running it.

A copy of ``repro.layers.shapes``: every helper mirrors the parameter
shapes of the corresponding ``*_init`` of the reference's layer library
(``attention_init``, the MLP, ``moe_init``, ``mamba2_init``,
``rwkv6_init``, ``rwkv6_channel_mix_init``), so the workload suite
(``repro_torch.suite``) can decompose a model config into matmul shapes.
The chunk sizes of the chunked-parallel scan forms live here, as in the
reference, where its ``layers.ssm`` takes them from.

All shapes are (in_features, out_features) of the underlying matmul, i.e.
the weight shape the token matrix is multiplied against.
"""
from __future__ import annotations

# chunk sizes of the chunked-parallel scan forms (the reference's
# ``layers.ssm`` imports these, so its numerics and the lowering agree)
RWKV_CHUNK = 32
MAMBA_CHUNK = 64


def attention_proj_shapes(d_model: int, n_heads: int, n_kv: int,
                          head_dim: int) -> dict:
    """Projection matmuls of ``attention_init`` (wq/wk/wv fused as qkv)."""
    return {
        "qkv": (d_model, (n_heads + 2 * n_kv) * head_dim),
        "q": (d_model, n_heads * head_dim),
        "kv": (d_model, 2 * n_kv * head_dim),
        "out": (n_heads * head_dim, d_model),
    }


def mlp_shapes(d_model: int, d_ff: int, kind: str = "swiglu") -> dict:
    """``{role: (weight shape, multiplicity)}`` of the MLP block."""
    n_in = 2 if kind == "swiglu" else 1  # gate+up vs single up
    return {
        "in": ((d_model, d_ff), n_in),
        "out": ((d_ff, d_model), 1),
    }


def moe_shapes(d_model: int, d_ff: int, n_experts: int,
               kind: str = "swiglu") -> dict:
    """Router + per-expert FFN matmuls of ``moe_init``."""
    n_in = 2 if kind == "swiglu" else 1
    return {
        "router": ((d_model, n_experts), 1),
        "expert_in": ((d_model, d_ff), n_in),      # per expert
        "expert_out": ((d_ff, d_model), 1),        # per expert
    }


def mamba2_dims(d_model: int, d_state: int = 64, head_dim: int = 64,
                expand: int = 2) -> dict:
    """Derived dimensions of ``mamba2_init`` (w_in/w_out + SSD scan)."""
    d_inner = expand * d_model
    n_heads = d_inner // head_dim
    return {
        "d_inner": d_inner,
        "n_heads": n_heads,
        "d_in_proj": 2 * d_inner + 2 * d_state + n_heads,
        "head_dim": head_dim,
        "d_state": d_state,
        "chunk": MAMBA_CHUNK,
    }


def rwkv6_dims(d_model: int, head_dim: int = 64) -> dict:
    """Derived dimensions of ``rwkv6_init`` (r/k/v/g/o are all ExE)."""
    return {
        "n_heads": d_model // head_dim,
        "head_dim": head_dim,
        "n_proj": 4,        # r, k, v, g (decay lora is rank-64, negligible)
        "chunk": RWKV_CHUNK,
    }


def rwkv6_channel_mix_shapes(d_model: int, d_ff: int) -> dict:
    """``rwkv6_channel_mix_init``: key/value FFN + receptance gate."""
    return {
        "key": ((d_model, d_ff), 1),
        "value": ((d_ff, d_model), 1),
        "receptance": ((d_model, d_model), 1),
    }
