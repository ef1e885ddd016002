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


def attention_params_from_numpy(np_params: dict, device="cuda") -> dict:
    """``repro.layers.attention.attention_init``'s parameters, as numpy
    arrays (bf16 included), as port tensors on ``device`` for
    ``repro_torch.layers.attention.attention_apply``."""
    unknown = set(np_params) - set(ATTENTION_PARAMS)
    missing = {"wq", "wk", "wv", "wo"} - set(np_params)
    if unknown or missing:
        raise KeyError(f"attention parameters: unknown {sorted(unknown)}, "
                       f"missing {sorted(missing)}")
    return from_numpy(dict(np_params), device)
