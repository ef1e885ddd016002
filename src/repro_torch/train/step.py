"""The prefill and decode steps (a port of the serving half of
``repro.train.step``): plain functions that return closures, where the
reference's are the units it ``jax.jit``s.

The training half (``xent``, ``loss_fn``, ``make_train_step``) is not
ported yet (ROADMAP queue 1 item 7).
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import forward, init_caches


def make_prefill_step(cfg: ArchConfig, capacity: int):
    """prefill(params, tokens, frontend) -> (last_logits, caches, encoder_out).

    The caches are made fresh for each call on the tokens' device, in
    ``init_caches``' default bf16, whatever the parameters' dtype, as the
    reference's prefill makes them."""

    def prefill(params, tokens, frontend=None):
        B, S = tokens.shape
        caches = init_caches(cfg, B, capacity, device=tokens.device)
        logits, new_caches, enc = forward(
            cfg, params, tokens, caches=caches, frontend_embeds=frontend, last_only=True,
        )
        return logits[:, -1], new_caches, enc

    return prefill


def make_decode_step(cfg: ArchConfig):
    """decode(params, token (B, 1), caches, positions (B, 1), encoder_out) ->
    (logits (B, V), new_caches).  The KV caches passed in are written in
    place and returned; SSM states come back as new tensors
    (``repro_torch.models.lm``)."""

    def decode(params, token, caches, positions, encoder_out=None):
        logits, new_caches, _ = forward(
            cfg, params, token, positions=positions, caches=caches, encoder_out=encoder_out,
        )
        return logits[:, -1], new_caches

    return decode
