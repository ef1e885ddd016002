"""Top-k MoE with grouped, gather-based capacity dispatch (a port of
``repro.layers.moe``, GShard-style).

Tokens are processed in G groups: the fp32 router, its softmax and top-k,
the normalised gates, the k-major cumsum slotting and the dispatch and
combine gathers all stay group-local.  Each (token, k) pair takes the next
slot of its expert's queue in the k-major flat order; pairs past the
expert's capacity are dropped and add nothing.  Dispatch and combine are
gathers and scatters, not one-hot products.  The expert GEMMs stay
``torch.einsum``, as the reference leaves them to XLA.

The reference defaults ``groups`` to its data-parallel shard count, which is
1 on one card; so does the port.  Its ``constrain`` sharding hooks have
nothing to do on one card and are left out.  Where the reference writes the
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
    g = groups if groups is not None else 1
    while g > 1 and n_tokens % g:
        g //= 2
    return g


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
    n_exp = params["router"].shape[1]
    n = B * S
    G = _pick_groups(n, groups)
    ng = n // G
    xt = x.reshape(G, ng, E)
    logits = torch.einsum("gne,ex->gnx", xt.float(), params["router"].float())
    probs = torch.softmax(logits, dim=-1)
    gates, exp_idx = torch.topk(probs, top_k, dim=-1)
    gates = gates / gates.sum(dim=-1, keepdim=True)
    capacity = max(1, int(ng * top_k * capacity_factor / n_exp))
    flat_exp = exp_idx.transpose(1, 2).reshape(G, top_k * ng)
    pos_in_exp = torch.cumsum(F.one_hot(flat_exp, n_exp), dim=1) - 1
    slot = torch.gather(pos_in_exp, 2, flat_exp[..., None])[..., 0]
    return Routing(G, capacity, gates, exp_idx, flat_exp, slot, slot < capacity)


def moe_apply(params, x: torch.Tensor, *, top_k: int = 2, capacity_factor: float = 1.25,
              groups: int | None = None) -> torch.Tensor:
    """x: (B, S, E) -> (B, S, E); a deterministic capacity-dropping
    dispatch by ``moe_route``'s decisions."""
    B, S, E = x.shape
    n_exp = params["router"].shape[1]
    r = moe_route(params, x, top_k=top_k, capacity_factor=capacity_factor, groups=groups)
    G, C = r.groups, r.capacity
    ng = B * S // G
    dev = x.device
    xt = x.reshape(G, ng, E)
    gidx = torch.arange(G, device=dev)[:, None]

    # dispatch: token id of every (expert, slot), ng (a zero row) where empty;
    # dropped pairs write to the spare entry n_exp·C, sliced off after
    token_id = torch.arange(ng, device=dev).repeat(top_k)[None].expand(G, -1)
    dest = torch.where(r.keep, r.flat_exp * C + r.slot, n_exp * C)
    disp = torch.full((G, n_exp * C + 1), ng, dtype=torch.int64, device=dev)
    disp[gidx, dest] = token_id
    disp = disp[:, : n_exp * C].reshape(G, n_exp, C)

    xt_pad = torch.cat([xt, xt.new_zeros((G, 1, E))], dim=1)
    exp_in = xt_pad[gidx[..., None], disp]                           # (G, X, C, E)
    g = torch.einsum("gxce,xef->gxcf", exp_in, params["w_gate"])
    u = torch.einsum("gxce,xef->gxcf", exp_in, params["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    exp_out = torch.einsum("gxcf,xfe->gxce", h, params["w_down"])

    # combine: each (token, k) reads its slot back if kept, else a zero row
    flat_out = exp_out.reshape(G, n_exp * C, E)
    flat_out_pad = torch.cat([flat_out, flat_out.new_zeros((G, 1, E))], dim=1)
    per_k = flat_out_pad[gidx, dest].reshape(G, top_k, ng, E)
    out = torch.einsum("gkne,gnk->gne", per_k, r.gates.to(per_k.dtype))
    return out.reshape(B, S, E).to(x.dtype)
