"""Carry the JAX package's arrays, given as numpy, into port tensors.

Both packages then compute on the same data: a test makes its inputs with
numpy, hands them to ``repro`` as they are and to ``repro_torch`` through
``from_numpy``.  bf16 arrays (numpy dtype ``ml_dtypes.bfloat16``, what JAX
hands over for its bf16 parameters) are carried bit for bit, without
importing ``ml_dtypes``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.layers.attention import KVCache
from repro_torch.layers.ssm import Mamba2State, RWKV6State


def from_numpy(tree, device="cuda"):
    """Map every numpy array (or numpy scalar) in a nest of dicts, lists and
    tuples to a tensor on ``device``, keeping dtype and shape; other leaves
    pass through unchanged."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        if isinstance(x, (np.ndarray, np.generic)):
            arr = np.array(x, order="C")  # a writable copy
            if arr.dtype.name == "bfloat16":  # torch has no numpy bfloat16: go by the bits
                return torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16).to(dev)
            return torch.from_numpy(arr).to(dev)
        return x

    return conv(tree)


ATTENTION_PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _checked(what: str, np_params: dict, required, optional=()) -> dict:
    unknown = set(np_params) - set(required) - set(optional)
    missing = set(required) - set(np_params)
    if unknown or missing:
        raise KeyError(f"{what} parameters: unknown {sorted(unknown)}, "
                       f"missing {sorted(missing)}")
    return dict(np_params)


def attention_params_from_numpy(np_params: dict, device="cuda") -> dict:
    """``repro.layers.attention.attention_init``'s parameters, as numpy
    arrays (bf16 included), as port tensors on ``device`` for
    ``repro_torch.layers.attention.attention_apply``."""
    return from_numpy(_checked("attention", np_params, ATTENTION_PARAMS[:4],
                               ATTENTION_PARAMS[4:]), device)


# the keys of each ``*_init`` of ``repro.layers`` that the port's layers take
LAYER_PARAMS = {
    "rmsnorm": ("scale",),
    "layernorm": ("scale", "bias"),
    "swiglu": ("w_gate", "w_up", "w_down"),
    "gelu_mlp": ("w_up", "b_up", "w_down", "b_down"),
    "moe": ("router", "w_gate", "w_up", "w_down"),
    "mamba2": ("w_in", "w_out", "A_log", "dt_bias", "conv_w", "norm_scale"),
    "rwkv6": ("w_r", "w_k", "w_v", "w_g", "w_o", "w_decay_a", "w_decay_b", "decay_base",
              "bonus_u", "mu"),
    "rwkv6_channel_mix": ("w_k", "w_v", "w_r", "mu"),
}


def layer_params_from_numpy(kind: str, np_params: dict, device="cuda") -> dict:
    """The parameters of ``repro.layers``' ``<kind>_init`` (a key of
    ``LAYER_PARAMS``), as numpy arrays (bf16 included), as port tensors on
    ``device`` for the port's ``<kind>`` apply function.  Unknown or
    missing keys raise."""
    if kind not in LAYER_PARAMS:
        raise KeyError(f"unknown layer {kind!r}; choose from {sorted(LAYER_PARAMS)}")
    return from_numpy(_checked(kind, np_params, LAYER_PARAMS[kind]), device)


def kv_cache_from_numpy(np_cache: dict, device="cuda") -> KVCache:
    """The fields of a ``repro.layers.attention.KVCache`` as numpy arrays, by
    name (bf16 and int8 included; ``k_scale`` and ``v_scale`` None or absent
    for a cache that is not quantized), as the port's ``KVCache`` on
    ``device``."""
    f = _checked("KVCache", np_cache, ("k", "v", "positions", "cursor"), ("k_scale", "v_scale"))
    return KVCache(**from_numpy(f, device))


def mamba2_state_from_numpy(np_state: dict, device="cuda") -> Mamba2State:
    """The fields of a ``repro.layers.ssm.Mamba2State`` (``ssm``, ``conv``)
    as numpy arrays, as the port's ``Mamba2State`` on ``device``."""
    return Mamba2State(**from_numpy(_checked("Mamba2State", np_state, ("ssm", "conv")), device))


def rwkv6_state_from_numpy(np_state: dict, device="cuda") -> RWKV6State:
    """The fields of a ``repro.layers.ssm.RWKV6State`` (``wkv``, ``prev``) as
    numpy arrays, as the port's ``RWKV6State`` on ``device``."""
    return RWKV6State(**from_numpy(_checked("RWKV6State", np_state, ("wkv", "prev")), device))
