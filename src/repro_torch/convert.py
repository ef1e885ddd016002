"""Carry the JAX package's arrays, given as numpy, into port tensors.

Both packages then compute on the same data: a test makes its inputs with
numpy, hands them to ``repro`` as they are and to ``repro_torch`` through
``from_numpy``.
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
            return torch.from_numpy(np.array(x, order="C")).to(dev)  # a writable copy
        return x

    return conv(tree)
