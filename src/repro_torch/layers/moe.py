"""Top-k MoE with grouped, gather-based capacity dispatch (a port of
``repro.layers.moe``, GShard-style).

Tokens are processed in G groups: the fp32 router, its softmax and top-k,
the normalised gates, the k-major cumsum slotting and the dispatch and
combine gathers all stay group-local.  Each (token, k) pair takes the next
slot of its expert's queue in the k-major flat order; pairs past the
expert's capacity are dropped and add nothing.  Dispatch and combine are
gathers and scatters, not one-hot products.  The expert GEMMs stay
``torch.einsum``, as the reference leaves them to XLA.

``groups`` defaults to the data-parallel shard count (``dp_size`` of
``train.sharding.set_activation_axes``), as the reference's does, so that
at a mesh every group is shard-local: one on one device.  The reference's
``constrain`` sites (the grouped tokens over 'dp', the experts' inputs and
outputs over 'dp' and 'tp') act on placed (DTensor) inputs.  On those the
routing and dispatch, and the combine, run on each rank's groups, and the
experts' SwiGLU on its groups and experts (``train.sharding.shard_local``:
groups over 'dp', experts over 'tp' where they divide it, the router and
each expert's weights whole, their FSDP rows gathered): all of it is local
to a group, and DTensor has no sharding strategy for the slot's gather
from the cumsum nor an in-place ``index_put_`` onto a sharded dispatch
table, and its gathers by global group index fail on a group-sharded
tensor in torch 2.11.  Where the reference writes the
dispatch table with ``mode="drop"`` (the dropped pairs aim at row
``n_exp``, out of bounds), the port sends them to one spare entry past the
table and slices it off: nothing is written out of bounds.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import resolve_device
from repro_torch.train.sharding import constrain, dp_size, shard_local

from . import _draw


def moe_init(d_model: int, d_ff: int, n_experts: int, dtype=torch.bfloat16, *,
             generator: torch.Generator, device="cuda") -> dict:
    """The fp32 router and the experts' SwiGLU weights, with the reference's
    scales (d_model^-1/2 in, d_ff^-1/2 out), drawn in fp32 from
    ``generator`` (on ``device``) and cast to ``dtype``; on the card unless
    the caller asks for the CPU."""
    normal = functools.partial(_draw.normal, generator=generator,
                               device=resolve_device(device))
    s_in, s_ff = d_model ** -0.5, d_ff ** -0.5
    return {
        "router": normal((d_model, n_experts), s_in, torch.float32),
        "w_gate": normal((n_experts, d_model, d_ff), s_in, dtype),
        "w_up": normal((n_experts, d_model, d_ff), s_in, dtype),
        "w_down": normal((n_experts, d_ff, d_model), s_ff, dtype),
    }


def _pick_groups(n_tokens: int, groups: int | None) -> int:
    g = groups if groups is not None else max(1, dp_size())
    while g > 1 and n_tokens % g:
        g //= 2
    return g


def _capacity(ng: int, top_k: int, capacity_factor: float, n_exp: int) -> int:
    """Slots of each expert in a group of ``ng`` tokens."""
    return max(1, int(ng * top_k * capacity_factor / n_exp))


class Routing(NamedTuple):
    """Where each (token, k) pair of each group goes.  ``flat_exp``,
    ``slot`` and ``keep`` are in the k-major flat order (G, k·ng): entry
    j·ng + t is token t's j-th choice."""
    groups: int
    capacity: int
    gates: torch.Tensor     # (G, ng, k) fp32, normalised over k
    exp_idx: torch.Tensor   # (G, ng, k) int64, the top-k experts
    flat_exp: torch.Tensor  # (G, k·ng) int64
    slot: torch.Tensor      # (G, k·ng) int64, place in the expert's queue
    keep: torch.Tensor      # (G, k·ng) bool, slot < capacity


def moe_route(params, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
              groups: int | None = None) -> Routing:
    """The router's decisions for x (B, S, E): fp32 logits, softmax, top-k,
    gates normalised over k, and each pair's slot by a cumsum over the
    k-major flat order of its group."""
    B, S, E = x.shape
    n = B * S
    G = _pick_groups(n, groups)
    return _route(x.reshape(G, n // G, E), params["router"], top_k, capacity_factor)


def _route(xt, router, top_k: int, capacity_factor: float) -> Routing:
    """``moe_route`` of tokens already in their groups, xt (G, ng, E)."""
    G, ng, _ = xt.shape
    n_exp = router.shape[1]
    logits = torch.einsum("gne,ex->gnx", xt.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    gates, exp_idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    capacity = _capacity(ng, top_k, capacity_factor, n_exp)
    flat_exp = exp_idx.transpose(1, 2).reshape(G, top_k * ng)
    pos_in_exp = torch.cumsum(F.one_hot(flat_exp, n_exp), dim=1) - 1
    slot = torch.gather(pos_in_exp, 2, flat_exp[..., None])[..., 0]
    return Routing(G, capacity, gates, exp_idx, flat_exp, slot, slot < capacity)


def _dispatch(xt, router, *, top_k: int, capacity_factor: float) -> tuple:
    """Route the grouped tokens xt (G, ng, E) and gather each expert's
    slots: (the experts' inputs (G, X, C, E), a zero row where a slot is
    empty; each (token, k) pair's entry in the flat (X·C) slots, the spare
    entry X·C where it was dropped; the gates (G, ng, k))."""
    G, ng, E = xt.shape
    n_exp = router.shape[1]
    r = _route(xt, router, top_k, capacity_factor)
    C = r.capacity
    dev = xt.device
    gidx = torch.arange(G, device=dev)[:, None]
    # the token id of every (expert, slot), ng (a zero row) where empty;
    # dropped pairs write to the spare entry n_exp·C, sliced off after
    token_id = torch.arange(ng, device=dev).repeat(top_k)[None].expand(G, -1)
    dest = torch.where(r.keep, r.flat_exp * C + r.slot, n_exp * C)
    disp = torch.full((G, n_exp * C + 1), ng, dtype=torch.int64, device=dev)
    disp[gidx, dest] = token_id
    disp = disp[:, : n_exp * C].reshape(G, n_exp, C)
    xt_pad = torch.cat([xt, xt.new_zeros((G, 1, E))], dim=1)
    return xt_pad[gidx[..., None], disp], dest, r.gates


def _experts(exp_in, w_gate, w_up, w_down, *, dtype):
    """The experts' SwiGLU on their slots: exp_in (G, X, C, E) -> (G, X, C,
    E)."""
    g = torch.einsum("gxce,xef->gxcf", exp_in, w_gate)
    u = torch.einsum("gxce,xef->gxcf", exp_in, w_up)
    h = F.silu(g.float()).to(dtype) * u
    return torch.einsum("gxcf,xfe->gxce", h, w_down)


def moe_apply(params, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
              groups: int | None = None) -> torch.Tensor:
    """x: (B, S, E) -> (B, S, E); a deterministic capacity-dropping
    dispatch by ``moe_route``'s decisions."""
    B, S, E = x.shape
    n_exp = params["router"].shape[1]
    n = B * S
    G = _pick_groups(n, groups)
    ng = n // G
    C = _capacity(ng, top_k, capacity_factor, n_exp)
    by_group = ("dp", None, None)
    slots = ("dp", "tp", None, None)
    xt = constrain(x.reshape(G, ng, E), by_group)
    exp_in, dest, gates = shard_local(
        lambda *a: _dispatch(*a, top_k=top_k, capacity_factor=capacity_factor),
        [(xt, by_group), (params["router"], (None, None))],
        ((*by_group, None), ("dp", None), by_group),
        ((G, n_exp, C, E), (G, top_k * ng), (G, ng, top_k)))
    exp_in = constrain(exp_in, slots)
    exp_out = shard_local(lambda *a: _experts(*a, dtype=x.dtype), [
        (exp_in, slots), (params["w_gate"], ("tp", None, None)),
        (params["w_up"], ("tp", None, None)), (params["w_down"], ("tp", None, None))],
        slots, exp_in.shape)
    exp_out = constrain(exp_out, slots)
    out = shard_local(lambda *a: _combine(*a, top_k=top_k), [
        (exp_out, (*by_group, None)), (dest, ("dp", None)), (gates, by_group)],
        by_group, (G, ng, E))
    return out.reshape(B, S, E).to(x.dtype)


def _combine(exp_out, dest, gates, *, top_k: int):
    """Each (token, k) reads its slot back if kept, else a zero row (``dest``
    the spare entry X·C), weighted by its gate: (G, ng, E)."""
    G, X, C, E = exp_out.shape
    ng = gates.shape[1]
    gidx = torch.arange(G, device=exp_out.device)[:, None]
    flat_out = exp_out.reshape(G, X * C, E)
    flat_out_pad = torch.cat([flat_out, flat_out.new_zeros((G, 1, E))], dim=1)
    per_k = flat_out_pad[gidx, dest].reshape(G, top_k, ng, E)
    return torch.einsum("gkne,gnk->gne", per_k, gates.to(per_k.dtype))
