"""GEMM shapes of the layer library, without running it.

Copies of ``repro.layers.shapes.attention_proj_shapes`` and ``mlp_shapes``:
they mirror the parameter shapes of ``attention.attention_init`` and of the
MLP block.  All shapes are (in_features, out_features) of the underlying
matmul, i.e. the weight shape the token matrix is multiplied against.
"""
from __future__ import annotations


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
