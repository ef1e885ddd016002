"""Carry the JAX package's arrays, given as numpy, into port tensors, and
the port's trees back out as numpy.

Both packages then compute on the same data: a test makes its inputs with
numpy, hands them to ``repro`` as they are and to ``repro_torch`` through
``from_numpy``.  bf16 arrays (numpy dtype ``ml_dtypes.bfloat16``, what JAX
hands over for its bf16 parameters) are carried bit for bit, without
importing ``ml_dtypes``; ``to_numpy`` hands bf16 back as its ``uint16``
bits.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import resolve_device
from repro_torch.layers.attention import KVCache
from repro_torch.layers.ssm import Mamba2State, RWKV6State
from repro_torch.optim.adamw import OptState
from repro_torch.tree import map_with_path


def from_numpy(tree, device="cuda"):
    """Map every numpy array (or numpy scalar) in a nest of dicts, lists and
    (named) tuples to a tensor on ``device``, keeping dtype and shape; other leaves
    pass through unchanged."""
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return type(x)(*(conv(v) for v in x))
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


def _norm_kind(cfg) -> str:
    return "rmsnorm" if cfg.norm == "rmsnorm" else "layernorm"


def _block_layers(cfg, block: str) -> dict:
    """Each sub-tree of one block of ``repro.models.lm`` -> its layer kind
    (a key of ``LAYER_PARAMS``, or "attention")."""
    norm = _norm_kind(cfg)
    if block == "attn":
        keys = {"ln1": norm, "attn": "attention", "ln2": norm}
        if cfg.n_experts:
            keys["moe"] = "moe"
            if cfg.dense_residual:
                keys["mlp"] = "swiglu"
        else:
            keys["mlp"] = "swiglu" if cfg.mlp == "swiglu" else "gelu_mlp"
        return keys
    if block == "rwkv":
        return {"ln1": norm, "time": "rwkv6", "ln2": norm, "chan": "rwkv6_channel_mix"}
    if block == "mamba_hybrid":
        return {"ln": norm, "mamba": "mamba2"}
    if block == "cross":
        return {"ln": norm, "attn": "attention"}
    raise ValueError(block)


def _block_from_numpy(cfg, what: str, block: str, np_block: dict, device) -> dict:
    keys = _block_layers(cfg, block)
    _checked(what, np_block, tuple(keys))
    out = {}
    for name, kind in keys.items():
        try:
            out[name] = (attention_params_from_numpy(np_block[name], device) if kind == "attention"
                         else layer_params_from_numpy(kind, np_block[name], device))
        except KeyError as e:
            raise KeyError(f"{what}.{name}: {e.args[0]}") from None
    return out


def lm_params_from_numpy(cfg, np_params: dict, device="cuda") -> dict:
    """The tree of ``repro.models.lm.init_params(cfg, ...)``, as numpy arrays
    (bf16 included, carried bit for bit), as the port's tree for
    ``repro_torch.models.lm.forward`` on ``device``.  Every block's keys are
    checked (``_checked``, ``LAYER_PARAMS``): unknown or missing keys
    raise ``KeyError``."""
    top = ["embed", "final_norm", "lm_head", "layers"]
    if cfg.block_pattern == "mamba_hybrid":
        top.append("shared_attn")
    if cfg.enc_layers:
        top += ["enc_layers", "enc_norm", "cross_layers"]
    if cfg.frontend:
        top.append("frontend_proj")
    p = _checked("LM", np_params, top)
    norm = _norm_kind(cfg)
    out = {"embed": from_numpy(p["embed"], device), "lm_head": from_numpy(p["lm_head"], device),
           "final_norm": layer_params_from_numpy(norm, p["final_norm"], device),
           "layers": _block_from_numpy(cfg, "layers", cfg.block_pattern, p["layers"], device)}
    if "shared_attn" in p:
        out["shared_attn"] = _block_from_numpy(cfg, "shared_attn", "attn", p["shared_attn"],
                                               device)
    if cfg.enc_layers:
        out["enc_layers"] = _block_from_numpy(cfg, "enc_layers", "attn", p["enc_layers"], device)
        out["enc_norm"] = layer_params_from_numpy(norm, p["enc_norm"], device)
        out["cross_layers"] = _block_from_numpy(cfg, "cross_layers", "cross", p["cross_layers"],
                                                device)
    if cfg.frontend:
        out["frontend_proj"] = from_numpy(p["frontend_proj"], device)
    return out


def opt_state_from_numpy(cfg, np_state, device="cuda") -> OptState:
    """A ``repro.optim.adamw.OptState`` (a NamedTuple, or a mapping of its
    fields ``step``, ``m``, ``v``, ``error``) as numpy leaves, as the port's
    ``OptState`` on ``device``: ``step`` a 0-d int32, each moment tree
    checked as ``lm_params_from_numpy`` checks the parameters', ``error``
    None where the reference's is."""
    f = _checked("OptState", _fields(np_state), ("step", "m", "v", "error"))
    step = from_numpy(np.asarray(f["step"], dtype=np.int32), device)
    err = None if f["error"] is None else lm_params_from_numpy(cfg, f["error"], device)
    return OptState(step, lm_params_from_numpy(cfg, f["m"], device),
                    lm_params_from_numpy(cfg, f["v"], device), err)


def numpy_copy(t: torch.Tensor) -> np.ndarray:
    """A numpy copy of ``t`` on the host; bf16 as its ``uint16`` bits (numpy
    has no bfloat16 without ``ml_dtypes``)."""
    t = t.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def to_numpy(tree):
    """A port tree (parameters, an ``OptState``, caches) with every tensor
    as its ``numpy_copy``, keeping the tree's dicts and (named) tuples."""
    return map_with_path(lambda _, t: numpy_copy(t), tree)


def _fields(x) -> dict:
    """A cache's fields by name: a NamedTuple's, or a mapping's."""
    return x._asdict() if hasattr(x, "_asdict") else dict(x)


def lm_caches_from_numpy(cfg, np_caches: dict, device="cuda") -> dict:
    """The stacked caches of ``repro.models.lm.init_caches`` or of a
    prefill (``{"kv"}``, ``{"rwkv"}`` or ``{"mamba", "shared_kv"}``; each
    cache a NamedTuple or a mapping of its fields, as numpy arrays; the
    RWKV entry a pair of the time mix's state and the channel mix's last
    input), as the port's on ``device``.  Unknown or missing keys raise."""
    if cfg.block_pattern == "attn":
        c = _checked("LM caches", np_caches, ("kv",))
        return {"kv": kv_cache_from_numpy(_fields(c["kv"]), device)}
    if cfg.block_pattern == "rwkv":
        c = _checked("LM caches", np_caches, ("rwkv",))
        state, prev = c["rwkv"]
        return {"rwkv": (rwkv6_state_from_numpy(_fields(state), device),
                         from_numpy(np.asarray(prev), device))}
    if cfg.block_pattern == "mamba_hybrid":
        c = _checked("LM caches", np_caches, ("mamba", "shared_kv"))
        return {"mamba": mamba2_state_from_numpy(_fields(c["mamba"]), device),
                "shared_kv": kv_cache_from_numpy(_fields(c["shared_kv"]), device)}
    raise ValueError(cfg.block_pattern)
