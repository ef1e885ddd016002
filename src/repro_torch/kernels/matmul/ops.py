"""Public entry point for the matmul, with the shape-keyed config cache.

``tuned_matmul`` keeps the reference's dispatch: a shape no tile fits goes
to the plain version (the reference's ``jnp.dot``), every other shape
launches the CUDA GEMM at the pinned default tile of its dtype, unless
``config`` pins the tile.  ``config`` takes the kernel's tiles and the
reference's space; a config of the latter runs at the default tile
(``generator.kernel_tile``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.matmul.generator import default_config, kernel_tile
from repro_torch.kernels.matmul.kernel import KERNEL_DTYPES, matmul_tiled
from repro_torch.kernels.matmul.ref import matmul_ref

_CONFIG_CACHE: dict = {}


def tuned_matmul(a: torch.Tensor, b: torch.Tensor, config: dict | None = None) -> torch.Tensor:
    """``a @ b`` for a (M, K) and b (K, N) on their device, accumulated in
    fp32 and cast to their dtype.  ``config`` is ``{"bm", "bn", "bk"}``, one
    of ``generator.TILES`` for the dtype or of the reference's space
    (``generator.tpu_space(M, K, N)``)."""
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"expected (M, K) and (K, N), got {tuple(a.shape)}, {tuple(b.shape)}")
    (M, K), N = a.shape, b.shape[1]
    if config is None and a.dtype not in KERNEL_DTYPES:
        return matmul_ref(a, b)  # no kernel for this dtype: the plain version
    if config is None:
        key = (M, K, N, a.element_size())
        config = _CONFIG_CACHE.get(key)
        if config is None:
            config = default_config(M, K, N, a.element_size())
            if config is None:
                # no tile fits: the plain version, as the reference's jnp.dot
                return matmul_ref(a, b)
            _CONFIG_CACHE[key] = config
    elif a.dtype in KERNEL_DTYPES:
        config = kernel_tile(config, M, K, N, a.element_size())
    return matmul_tiled(a.contiguous(), b.contiguous(), config["bm"], config["bn"], config["bk"])
