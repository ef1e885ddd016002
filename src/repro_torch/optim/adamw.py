"""AdamW with global-norm clipping, a warmup-cosine schedule and optional
int8 gradient compression with error feedback (a port of
``repro.optim.adamw``).

The arithmetic is the reference's, in fp32: the moments ``m`` and ``v`` and
the compression's error feedback are fp32, each update is computed in fp32
and cast back to its parameter's dtype (round to nearest even, as
``astype``), and ``compress_int8`` rounds half to even (``torch.round``, as
``jnp.round``).

``apply_updates`` writes the parameters, the moments and the error
feedback in place, under ``torch.no_grad()``, where the reference's
launcher donates them to its jitted step (``donate_argnums=(0, 1)``): it
returns the very tensors it was given, as ``models.lm.forward`` does with
KV caches.  It works leaf by leaf, so no fp32 copy of the whole gradient
tree sits beside the moments (granite-3-2b's stacked ``w_up`` alone is
2.7 GB in fp32).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.train import sharding
from repro_torch.tree import leaves, map_with_path


@dataclass(frozen=True)
class OptConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    compress_grads: bool = False  # int8 + error feedback


class OptState(NamedTuple):
    step: torch.Tensor  # 0-d int32
    m: dict
    v: dict
    error: dict | None  # compression error feedback


def lr_at(cfg: OptConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or a 0-d integer tensor), a 0-d
    fp32 tensor on the step's device: linear warmup, then a cosine from
    ``lr`` down to a tenth of it at ``total_steps``."""
    s = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(s / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((s - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1),
                       0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (0.1 + 0.9 * cos)


def init_opt_state(cfg: OptConfig, params) -> OptState:
    """Zero fp32 moments (and error feedback with ``compress_grads``) shaped
    as ``params``, on each parameter's device; ``step`` a 0-d int32 on the
    first parameter's."""

    def zero(x):
        if sharding.is_dtensor(x):  # on the parameter's placements
            return torch.zeros_like(x, dtype=torch.float32)
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)

    def zeros(tree):
        return map_with_path(lambda _, x: zero(x), tree)

    dev = leaves(params)[0].device
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        m=zeros(params),
        v=zeros(params),
        error=zeros(params) if cfg.compress_grads else None,
    )


def compress_int8(g, error):
    """Simulated int8 compression with error feedback: quantize ``g + error``
    to 255 levels a tensor and carry the residual.  (dequantized, new
    error), both fp32."""
    deq, _, _, err = _compress(g, error)
    return deq, err


def _compress(g, error):
    """(dequantized, int8 levels, scale, new error) of ``g + error``."""
    gc = g + error
    scale = torch.clamp(sharding.full(gc.abs().max()), min=1e-12) / 127.0
    q = torch.round(gc / scale).to(torch.int8)
    deq = q.to(torch.float32) * scale
    return deq, q, scale, gc - deq


@torch.no_grad()
def apply_updates(cfg: OptConfig, state: OptState, params, grads):
    """One AdamW step: returns (params, new OptState, {"grad_norm", "lr"}).

    ``params``, ``state.m``, ``state.v`` and ``state.error`` are written in
    place and returned (the new state holds a new ``step``); ``grads`` (any
    float dtype, in ``params``' structure) are read, not written.  With
    ``compress_grads`` every gradient is first replaced by its int8
    compression with error feedback, and the norm and update read those.

    Placed parameters (DTensors, ``train.sharding.place``) take the same
    code under ``sharding.spmd``, their moments and error feedback on their
    placements (``init_opt_state``): each gradient is first redistributed
    to its parameter's placements (``sharding.like``: a reduce-scatter of
    a partial sum), and the global norm and each leaf's compression scale
    are full tensors, the one-device values."""
    with sharding.spmd(params):
        return _apply_updates(cfg, state, params, grads)


def _apply_updates(cfg: OptConfig, state: OptState, params, grads):
    p_l = leaves(params)
    g_l = [sharding.like(g, p) for g, p in zip(leaves(grads), p_l)]
    m_l, v_l = leaves(state.m), leaves(state.v)
    if not len(p_l) == len(g_l) == len(m_l) == len(v_l):
        raise ValueError("params, grads and the moments must have the same leaves")
    if cfg.compress_grads:
        # the levels (int8) and scales are kept; the fp32 gradient is
        # rebuilt from them leaf by leaf below, bit for bit
        packed = []
        for g, e in zip(g_l, leaves(state.error)):
            _, q, scale, err = _compress(g.float(), e)
            e.copy_(err)
            packed.append((q, scale))
            del err

        def grad(i):
            q, scale = packed[i]
            return q.to(torch.float32) * scale
    else:
        def grad(i):
            return g_l[i].float()

    sq = [sharding.full(grad(i).square().sum()) for i in range(len(p_l))]
    gnorm = torch.sqrt(torch.stack(sq).sum())
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12), max=1.0)
    step = state.step + 1
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)

    for i, (p, m, v) in enumerate(zip(p_l, m_l, v_l)):
        g = grad(i) * clip
        m.mul_(cfg.b1).add_(g, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).add_(g.square_(), alpha=1 - cfg.b2)
        del g
        denom = (v / b2c).sqrt_().add_(cfg.eps)
        delta = (m / b1c).div_(denom)
        del denom
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay)
        p.copy_(p32.sub_(delta.mul_(lr)))
        del delta, p32
    return params, OptState(step, state.m, state.v, state.error), {"grad_norm": gnorm, "lr": lr}
