"""Calibrated per-cell cost accounting for the roofline (a port of
``repro.launch.calibrate``).

The reference lowers ONE layer block (and the embed/head/loss) apart,
because XLA's CPU ``cost_analysis()`` counts a while-loop body once, and
then scales:

    train:   total = mb * (L * 4 * layer_fwd + 4 * head_fwd) + opt_pass
    prefill: total = L * layer_fwd + head_fwd
    decode:  total = L * layer_decode + head_fwd

The 4x train multiplier is the standard fwd + recompute (remat) + dx + dw
accounting; the optimizer pass adds an analytic 20 B/param f32 read-write
term.  Collectives scale the same way.

The port counts each block with ``core.cost.count_cost`` on ``meta``
stand-ins (nothing allocated), under the reference's chunk hints
(``layers.attention.CHUNK_OVERRIDE``, ``layers.ssm.CHUNK_OVERRIDE``), so a
block's chunked attention or scan does the work it does in the
reference's calibration.  The reference's ``SCAN_UNROLL`` has no
counterpart: eager PyTorch runs, and counts, every chunk.  A block's
numbers are ``BlockCost``s, whose first three fields are the reference's
``(flops, bytes, coll_wire)``.

On a ``DeviceMesh`` (``launch.mesh.make_production_mesh``, a ``fake``
group on the CPU) each block's arguments are placed by the reference's
specs (``train.sharding.place``, ``meta`` shards) under the mesh's
activation axes, and ``count_cost`` counts one rank's program: its local
products, bytes and memory, and the collectives DTensor issues for its
redistributions, as the reference's per-device ``cost_analysis()`` and
HLO collectives.  A one-device mesh record places nothing; a record of
more than one device cannot place, and raises ``ValueError``.
``analytic_bytes`` and its constants are the reference's, unchanged: they
read only a mesh's axis names and sizes (either kind of mesh), so they hold
for any mesh.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.core.cost import count_cost
from repro_torch.layers import attention as attn_mod
from repro_torch.layers import ssm as ssm_mod
from repro_torch.layers.attention import KVCache, attention_apply, attention_init
from repro_torch.layers.norms import rmsnorm
from repro_torch.layers.ssm import Mamba2State, RWKV6State
from repro_torch.models import lm as lm_mod
from repro_torch.train import sharding
from repro_torch.train.sharding import (
    axis_names,
    constrain,
    is_device_mesh,
    make_cache_shardings,
    make_param_shardings,
    mesh_shape,
    place,
    spec_at,
)
from repro_torch.train.step import xent
from repro_torch.tree import map_with_path

TRAIN_MULT = 4.0  # fwd + remat recompute + dx + dw
META = torch.device("meta")


@dataclass
class CellCost:
    flops: float
    bytes: float
    coll_wire: float
    detail: dict


class BlockCost(NamedTuple):
    """One block's count: the reference's ``(flops, bytes, coll_wire)``,
    then the products' share of the flops and the whole ``core.cost.Cost``."""
    flops: float
    bytes: float
    coll_wire: float
    dot_flops: float
    cost: object


def _mesh_devices(mesh) -> int:
    return math.prod(mesh_shape(mesh))


def _cost_of(fn, args, in_shardings, mesh, chunk_hint: int | None = None) -> BlockCost:
    """``count_cost`` of ``fn(*args)`` under the chunk hint.  On a
    ``DeviceMesh`` each argument is placed by its spec in ``in_shardings``
    (the reference's ``in_shardings``) and the activation axes are the
    mesh's while it runs, under ``train.sharding.spmd`` as the steps run:
    one rank's program is counted.  On a one-device
    record the arguments stay plain tensors."""
    placed = is_device_mesh(mesh)
    if not placed and _mesh_devices(mesh) != 1:
        raise ValueError(f"counting on a mesh of {_mesh_devices(mesh)} devices needs a "
                         "DeviceMesh (launch.mesh.make_production_mesh) to place the "
                         f"arguments on; got {type(mesh).__name__}")
    before = sharding.activation_mesh()
    attn_mod.CHUNK_OVERRIDE[0] = chunk_hint
    ssm_mod.CHUNK_OVERRIDE[0] = chunk_hint
    try:
        if placed:
            sharding.set_activation_axes(mesh)
            args = tuple(place(a, s, mesh) for a, s in zip(args, in_shardings, strict=True))
        with torch.no_grad(), sharding.spmd(args):
            _, cost = count_cost(fn, *args)
    finally:
        attn_mod.CHUNK_OVERRIDE[0] = None
        ssm_mod.CHUNK_OVERRIDE[0] = None
        if placed:
            sharding.set_activation_axes(before)
    return BlockCost(cost.flops, cost.bytes, float(cost.collectives["total"]["wire_bytes"]),
                     cost.dot_flops, cost)


def _h_sharding(mesh, B, S, seq_parallel=False) -> tuple:
    """Residual-stream spec used between blocks (matches models.lm
    _scan_blocks): batch over data; sequence over model iff seq_parallel."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh)) or None
    sizes = dict(zip(axis_names(mesh), mesh_shape(mesh)))
    if dp and B % math.prod(sizes[a] for a in dp) != 0:
        dp = None
    tp = None
    if seq_parallel and "model" in axis_names(mesh) and S % sizes.get("model", 1) == 0:
        tp = "model"
    return (dp, tp, None)


def _dp_sharding(mesh, ndim, dim0=None) -> tuple:
    """Batch-dim spec over the data axes; replicates when it doesn't divide
    (the batch-1 long-context cells)."""
    dp = tuple(a for a in ("pod", "data") if a in axis_names(mesh))
    if dp:
        sizes = dict(zip(axis_names(mesh), mesh_shape(mesh)))
        dsz = math.prod(sizes[a] for a in dp)
        if dim0 is not None and dim0 % dsz != 0:
            dp = ()
    return (dp if dp else None, *([None] * (ndim - 1)))


def _stand_in(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def _block_params(cfg: ArchConfig, pattern: str) -> dict:
    init = {"attn": lm_mod._attn_block_init, "rwkv": lm_mod._rwkv_block_init}.get(
        pattern, lm_mod._mamba_block_init)
    return init(cfg, torch.bfloat16, generator=None, device=META)


def _layer_fwd_cost(cfg: ArchConfig, mesh, B, S, decode_cache_len: int | None = None,
                    block: str | None = None) -> BlockCost:
    """Cost of one layer block forward (B, S).  decode_cache_len set -> the
    serving path with a KV/state cache of that length."""
    pattern = block or cfg.block_pattern
    E = cfg.d_model
    lp = _block_params(cfg, pattern)
    lp_shard = make_param_shardings(lp, mesh)
    h = _stand_in((B, S, E), torch.bfloat16)
    h_shard = _h_sharding(mesh, B, S, cfg.seq_parallel)
    pos = _stand_in((B, S), torch.int32)
    pos_shard = _dp_sharding(mesh, 2, B)

    hint = max(256, -(-S // 8))  # <=8 chunk-scan steps
    if decode_cache_len is None:
        if pattern == "attn":
            def f(lp, h, positions):
                return lm_mod._attn_block(cfg, lp, h, positions, None)[0]
            return _cost_of(f, (lp, h, pos), (lp_shard, h_shard, pos_shard), mesh, hint)
        if pattern == "rwkv":
            def f(lp, h):
                return lm_mod._rwkv_block(cfg, lp, h, None)[0]
            return _cost_of(f, (lp, h), (lp_shard, h_shard), mesh, hint)

        def f(lp, h):
            return lm_mod._mamba_block(cfg, lp, h, None)[0]
        return _cost_of(f, (lp, h), (lp_shard, h_shard), mesh, hint)

    # decode path with cache
    cap = min(decode_cache_len, cfg.swa_window) if cfg.swa_window else decode_cache_len
    if pattern == "attn":
        cache = KVCache.init(B, cfg.n_kv, cap, cfg.resolved_head_dim, device=META)
        stacked = make_cache_shardings(lm_mod._map(lambda x: x[None], cache), mesh)
        c_shard = map_with_path(lambda path, _: spec_at(stacked, path)[1:], cache)

        def f(lp, h, positions, cache):
            return lm_mod._attn_block(cfg, lp, h, positions, cache)[0]

        return _cost_of(f, (lp, h, pos, cache), (lp_shard, h_shard, pos_shard, c_shard), mesh,
                        max(2048, -(-cap // 8)))
    if pattern == "rwkv":
        H = cfg.d_model // cfg.ssm_head_dim
        K = cfg.ssm_head_dim
        st = (RWKV6State(_stand_in((B, H, K, K), torch.float32),
                         _stand_in((B, E), torch.bfloat16)),
              _stand_in((B, E), torch.bfloat16))
        st_shard = lm_mod._map(lambda x: _dp_sharding(mesh, x.dim(), x.shape[0]), st)

        def f(lp, h, st):
            return lm_mod._rwkv_block(cfg, lp, h, st)[0]

        return _cost_of(f, (lp, h, st), (lp_shard, h_shard, st_shard), mesh)
    d_inner = 2 * cfg.d_model
    H = d_inner // cfg.ssm_head_dim
    st = Mamba2State(_stand_in((B, H, cfg.ssm_head_dim, cfg.ssm_state), torch.float32),
                     _stand_in((B, 3, d_inner), torch.bfloat16))
    st_shard = lm_mod._map(lambda x: _dp_sharding(mesh, x.dim(), x.shape[0]), st)

    def f(lp, h, st):
        return lm_mod._mamba_block(cfg, lp, h, st)[0]

    return _cost_of(f, (lp, h, st), (lp_shard, h_shard, st_shard), mesh)


def _cross_fwd_cost(cfg: ArchConfig, mesh, B, S) -> BlockCost:
    """One decoder cross-attention block (enc-dec archs)."""
    cp = {
        "ln": lm_mod._norm_init(cfg, device=META),
        "attn": attention_init(cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.resolved_head_dim,
                               False, torch.bfloat16, generator=None, device=META),
    }
    cp_shard = make_param_shardings(cp, mesh)
    h = _stand_in((B, S, cfg.d_model), torch.bfloat16)
    ctx = _stand_in((B, cfg.frontend_tokens, cfg.d_model), torch.bfloat16)
    pos = _stand_in((B, S), torch.int32)
    h_sh = _h_sharding(mesh, B, S, cfg.seq_parallel)
    ctx_sh = _dp_sharding(mesh, 3, B)
    pos_sh = _dp_sharding(mesh, 2, B)

    def f(cp, h, positions, ctx):
        out, _ = attention_apply(
            cp["attn"], lm_mod._norm(cfg, cp["ln"], h),
            n_heads=cfg.n_heads, n_kv=cfg.n_kv, head_dim=cfg.resolved_head_dim,
            causal=False, rope_theta=0.0, positions=positions, context=ctx,
        )
        return h + out

    return _cost_of(f, (cp, h, pos, ctx), (cp_shard, h_sh, pos_sh, ctx_sh), mesh,
                    max(256, -(-cfg.frontend_tokens // 4)))


def _head_fwd_cost(cfg: ArchConfig, mesh, B, S, with_loss: bool) -> BlockCost:
    """embed + final norm + lm_head (+ xent loss)."""
    V, E = cfg.padded_vocab, cfg.d_model
    p = {
        "embed": _stand_in((V, E), torch.bfloat16),
        "lm_head": _stand_in((E, V), torch.bfloat16),
        "final_norm": {"scale": _stand_in((E,), torch.float32)},
    }
    p_shard = make_param_shardings(p, mesh)
    toks = _stand_in((B, S), torch.int32)
    t_shard = _dp_sharding(mesh, 2, B)

    def f(p, tokens):
        h = constrain(lm_mod._embed(p["embed"], tokens), ("dp", None, None))
        h = rmsnorm(p["final_norm"], h)
        if not with_loss:
            h = h[:, -1:]
        logits = torch.einsum("bse,ev->bsv", h, p["lm_head"]).float()
        logits = constrain(logits, ("dp", None, "tp"))
        if with_loss:
            return xent(logits, tokens)
        return logits[:, -1]

    return _cost_of(f, (p, toks), (p_shard, t_shard), mesh)


def _parts(cfg: ArchConfig, lf: BlockCost, layer) -> list:
    """(count, block) of the decoder stack: ``lf`` for every layer, and
    the hybrid's shared attention block once a group (``layer(block=
    "attn")`` counts it)."""
    parts = [(cfg.n_layers, lf)]
    if cfg.block_pattern == "mamba_hybrid":
        parts.append((cfg.n_layers // cfg.hybrid_attn_every, layer(block="attn")))
    return parts


def calibrated_cost(cfg: ArchConfig, shape: ShapeSpec, mesh, microbatches: int = 1,
                    n_params: float = 0.0) -> CellCost:
    n_chips = _mesh_devices(mesh)
    B = shape.global_batch
    detail = {}

    if shape.kind == "train":
        B_mb = max(1, B // microbatches)
        lf = _layer_fwd_cost(cfg, mesh, B_mb, shape.seq_len)
        hf = _head_fwd_cost(cfg, mesh, B_mb, shape.seq_len, with_loss=True)
        parts = _parts(cfg, lf, lambda block: _layer_fwd_cost(cfg, mesh, B_mb, shape.seq_len,
                                                              block=block))
        if cfg.enc_layers:
            ef = _layer_fwd_cost(cfg, mesh, B_mb, cfg.frontend_tokens, block="attn")
            parts.append((cfg.enc_layers, ef))
            parts.append((cfg.n_layers, _cross_fwd_cost(cfg, mesh, B_mb, shape.seq_len)))
        flops = sum(c * f[0] for c, f in parts)
        bts = sum(c * f[1] for c, f in parts)
        coll = sum(c * f[2] for c, f in parts)
        flops = microbatches * TRAIN_MULT * (flops + hf[0])
        bts = microbatches * TRAIN_MULT * (bts + hf[1])
        coll = microbatches * TRAIN_MULT * (coll + hf[2])
        # optimizer pass: read p,m,v + write p,m,v in f32 (per device)
        opt_bytes = 20.0 * (n_params / n_chips)
        bts += opt_bytes
        detail["opt_bytes"] = opt_bytes
        mult = microbatches * TRAIN_MULT
    elif shape.kind == "prefill":
        lf = _layer_fwd_cost(cfg, mesh, B, shape.seq_len)
        hf = _head_fwd_cost(cfg, mesh, B, shape.seq_len, with_loss=False)
        parts = _parts(cfg, lf, lambda block: _layer_fwd_cost(cfg, mesh, B, shape.seq_len,
                                                              block=block))
        if cfg.enc_layers:
            ef = _layer_fwd_cost(cfg, mesh, B, cfg.frontend_tokens, block="attn")
            parts.append((cfg.enc_layers, ef))
            parts.append((cfg.n_layers, _cross_fwd_cost(cfg, mesh, B, shape.seq_len)))
        flops = sum(c * f[0] for c, f in parts) + hf[0]
        bts = sum(c * f[1] for c, f in parts) + hf[1]
        coll = sum(c * f[2] for c, f in parts) + hf[2]
        mult = 1.0
    else:  # decode
        lf = _layer_fwd_cost(cfg, mesh, B, 1, decode_cache_len=shape.seq_len)
        hf = _head_fwd_cost(cfg, mesh, B, 1, with_loss=False)
        parts = _parts(cfg, lf, lambda block: _layer_fwd_cost(
            cfg, mesh, B, 1, decode_cache_len=shape.seq_len, block=block))
        flops = sum(c * f[0] for c, f in parts) + hf[0]
        bts = sum(c * f[1] for c, f in parts) + hf[1]
        coll = sum(c * f[2] for c, f in parts) + hf[2]
        mult = 1.0

    detail["layer_fwd"] = lf
    detail["head_fwd"] = hf
    # every block counted, with its count in the step: the products' sum
    detail["blocks"] = [(c, f) for c, f in parts] + [(1, hf)]
    detail["dot_flops"] = mult * sum(c * f.dot_flops for c, f in detail["blocks"])
    return CellCost(flops=flops, bytes=bts, coll_wire=coll, detail=detail)


# ===========================================================================
# Analytic HBM traffic model (the paper's methodology at model level)
# ===========================================================================
# The CPU backend's cost_analysis() reports *unfused* byte counts — every
# elementwise temporary hits "memory" — which a TPU's fusion would keep in
# VMEM/registers.  Exactly as the paper derives DRAM volumes analytically
# instead of trusting a naive per-op count, we model per-device HBM traffic
# from first principles; the unfused number is kept as an upper bound.
#
# Model constants (documented assumptions):
H_PASSES_TRAIN = 30.0   # h-sized HBM touches per layer per mb: fwd ~12 (reads
                        # + writes at fusion boundaries), remat recompute ~12,
                        # bwd dx/dw epilogues ~6
H_PASSES_FWD = 12.0
LOGIT_PASSES_TRAIN = 4.0  # write + read fwd, write + read bwd (f32)
LOGIT_PASSES_FWD = 2.0
PARAM_PASSES_TRAIN = 4.0  # fwd read, recompute read, dw pass read, grad write
OPT_BYTES_PER_PARAM = 20.0  # p(bf16 r/w) + m,v (f32 r/w)


def analytic_bytes(cfg: ArchConfig, shape: ShapeSpec, mesh, microbatches: int,
                   n_params: float) -> dict:
    """Per-device HBM bytes per step, first-principles (see constants above)."""
    sizes = dict(zip(axis_names(mesh), mesh_shape(mesh)))
    chips = math.prod(mesh_shape(mesh))
    tp = sizes.get("model", 1)
    dp = chips // tp
    B, S = shape.global_batch, shape.seq_len
    E, V = cfg.d_model, cfg.padded_vocab
    L = cfg.n_layers + (cfg.enc_layers or 0)
    h_bytes = lambda b, s: b * s * E * 2 / dp  # hidden slab per device

    out = {}
    if shape.kind == "train":
        mb = microbatches
        B_mb = max(1, B // mb)
        # FSDP: gathered layer params are read per pass, sharded 1/tp
        params_t = mb * PARAM_PASSES_TRAIN * n_params * 2 / tp
        act_t = mb * L * H_PASSES_TRAIN * h_bytes(B_mb, S)
        logit_t = mb * LOGIT_PASSES_TRAIN * B_mb * S * V * 4 / (dp * tp)
        opt_t = OPT_BYTES_PER_PARAM * n_params / chips
        out = {"params": params_t, "activations": act_t, "logits": logit_t,
               "optimizer": opt_t}
    elif shape.kind == "prefill":
        params_t = n_params * 2 / tp
        act_t = L * H_PASSES_FWD * h_bytes(B, S)
        logit_t = LOGIT_PASSES_FWD * B * 1 * V * 4 / (dp * tp)  # last_only
        cache_t = 0.0
        if cfg.block_pattern in ("attn", "mamba_hybrid"):
            n_attn = (cfg.n_layers if cfg.block_pattern == "attn"
                      else cfg.n_layers // cfg.hybrid_attn_every)
            cap = min(S, cfg.swa_window) if cfg.swa_window else S
            cache_t = n_attn * 2 * B * cfg.n_kv * cap * cfg.resolved_head_dim * 2 / dp
        out = {"params": params_t, "activations": act_t, "logits": logit_t,
               "kv_cache_write": cache_t}
    else:  # decode
        params_t = n_params * 2 / tp  # every param read once per token
        act_t = L * H_PASSES_FWD * h_bytes(B, 1)
        logit_t = LOGIT_PASSES_FWD * B * V * 4 / (dp * tp)
        cache_t = 0.0
        if cfg.block_pattern in ("attn", "mamba_hybrid"):
            n_attn = (cfg.n_layers if cfg.block_pattern == "attn"
                      else cfg.n_layers // cfg.hybrid_attn_every)
            cap = min(S, cfg.swa_window) if cfg.swa_window else S
            kv_heads_shard = max(1, min(tp, cfg.n_kv))
            cache_t = n_attn * 2 * B * cfg.n_kv * cap * cfg.resolved_head_dim * 2 / (
                dp * kv_heads_shard
            )
        if cfg.block_pattern == "rwkv":
            H = cfg.d_model // cfg.ssm_head_dim
            cache_t = cfg.n_layers * 2 * B * H * cfg.ssm_head_dim ** 2 * 4 / dp
        if cfg.block_pattern == "mamba_hybrid":
            Hm = 2 * cfg.d_model // cfg.ssm_head_dim
            cache_t += cfg.n_layers * 2 * B * Hm * cfg.ssm_head_dim * cfg.ssm_state * 4 / dp
        out = {"params": params_t, "activations": act_t, "logits": logit_t,
               "state_cache": cache_t}
    out["total"] = sum(out.values())
    return out
