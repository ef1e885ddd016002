"""The train, prefill and decode steps (a port of ``repro.train.step``):
plain functions that return closures, where the reference's are the units
it ``jax.jit``s.

The train step takes its gradients with ``torch.autograd.grad`` over the
parameter leaves and hands them to ``optim.adamw.apply_updates``, which
writes the parameters and the optimiser state in place and returns them.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models.lm import forward, init_caches
from repro_torch.optim.adamw import OptConfig, OptState, apply_updates
from repro_torch.train import sharding
from repro_torch.train.sharding import constrain
from repro_torch.tree import leaves, unflatten


def xent(logits, labels):
    """Mean cross entropy: logsumexp over every column of the fp32 logits
    (all ``padded_vocab`` of them, as the reference) minus the label's
    logit.  On placed (vocab-sharded) logits the label's logit is the
    reference's one-hot product, the one-hot constrained to ('dp', None,
    'tp') so that the vocab axis is not gathered: each rank sums its
    columns and one all-reduce adds them (one nonzero term a row, so the
    sum is exact).  Plain logits gather it."""
    lse = torch.logsumexp(logits, dim=-1)
    if sharding.is_dtensor(logits):
        cols = torch.arange(logits.shape[-1], device=logits.device)
        oh = constrain((labels.long()[..., None] == cols).to(logits.dtype), ("dp", None, "tp"))
        label_logit = (logits * oh).sum(-1)
    else:
        label_logit = logits.gather(-1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - label_logit)


def loss_fn(cfg: ArchConfig, params, batch):
    """The mean cross entropy of ``batch`` ({"tokens", "labels"[,
    "frontend"]}); a vision arch scores only the text positions."""
    logits, _, _ = forward(cfg, params, batch["tokens"], frontend_embeds=batch.get("frontend"))
    S = batch["tokens"].shape[1]
    logits = logits[:, -S:]  # vlm: score only the text positions
    return xent(logits, batch["labels"])


def loss_and_grads(cfg: ArchConfig, params, batch, microbatches: int = 1):
    """(loss, gradients in ``params``' structure) of ``batch``, by
    ``torch.autograd.grad`` over the parameter leaves.

    With one microbatch the gradients are in the parameters' dtype, as the
    reference's ``value_and_grad`` gives them.  ``microbatches > 1`` splits
    the batch into that many equal slices along its first axis, as the
    reference's ``lax.scan`` does: each slice's gradients are summed into
    fp32, and the sum and the summed loss are divided by ``microbatches``.

    Placed parameters and batch (DTensors, ``train.sharding.place``) run
    the same code under ``sharding.spmd``: each gradient comes back on its
    parameter's placements (a reduce-scatter over the FSDP dims,
    ``sharding.like``), a microbatch is the global batch's rows, as the
    reference's (``sharding.rows``, placed again as the batch was), and the
    loss is a full tensor.
    """

    def grads_of(mbatch):
        p_l = leaves(params)
        live = [t.detach().requires_grad_() for t in p_l]
        loss = loss_fn(cfg, unflatten(params, live), mbatch)
        grads = torch.autograd.grad(loss, live, allow_unused=True, materialize_grads=True)
        return sharding.full(loss.detach()), [sharding.like(g, p) for g, p in zip(grads, p_l)]

    with sharding.spmd(params):
        if microbatches == 1:
            loss, grads = grads_of(batch)
            return loss, unflatten(params, grads)
        b = batch["tokens"].shape[0]
        if b % microbatches:
            raise ValueError(f"batch {b} does not split into {microbatches} microbatches")
        loss, grads = 0.0, None
        for k in range(microbatches):
            l, g = grads_of({key: sharding.rows(x, k, microbatches) for key, x in batch.items()})
            loss = loss + l
            if grads is None:
                grads = [t.float() for t in g]
            else:
                for acc, t in zip(grads, g):
                    acc.add_(t)
            del g
        for acc in grads:
            acc.div_(microbatches)
        return loss / microbatches, unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt_cfg: OptConfig, microbatches: int = 1):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics {"loss", "grad_norm", "lr"}, 0-d tensors): ``loss_and_grads``,
    then ``apply_updates``, which writes the parameters and the optimiser
    state in place and returns them."""

    def train_step(params, opt_state: OptState, batch):
        loss, grads = loss_and_grads(cfg, params, batch, microbatches)
        params, opt_state, info = apply_updates(opt_cfg, opt_state, params, grads)
        return params, opt_state, {"loss": loss, **info}

    return train_step


def make_prefill_step(cfg: ArchConfig, capacity: int):
    """prefill(params, tokens, frontend) -> (last_logits, caches, encoder_out).

    The caches are made fresh for each call on the tokens' device, in
    ``init_caches``' default bf16, whatever the parameters' dtype, as the
    reference's prefill makes them.  Placed tokens (a DTensor) get caches
    placed on their mesh by ``make_cache_shardings``."""

    def prefill(params, tokens, frontend=None):
        B, S = tokens.shape
        caches = init_caches(cfg, B, capacity, device=tokens.device)
        if sharding.is_dtensor(tokens):
            mesh = tokens.device_mesh
            caches = sharding.place(caches, sharding.make_cache_shardings(caches, mesh), mesh)
        with sharding.spmd(params):
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
        with sharding.spmd(params):
            logits, new_caches, _ = forward(
                cfg, params, token, positions=positions, caches=caches,
                encoder_out=encoder_out,
            )
            return logits[:, -1], new_caches

    return decode
