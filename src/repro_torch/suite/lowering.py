"""Model-config -> kernel-plan lowering (DESIGN.md §8).

A copy of ``repro.suite.lowering``.  Walks the forward pass of any
``repro_torch.configs`` architecture — mirroring the layer stack the
reference's ``models.lm.forward`` executes — and decomposes it into a
``ModelPlan`` of per-layer kernel workloads the exploration engine can
price:

  * attention cores  -> ``kernels.flash_attention.generator.tpu_candidate_specs``
    (TPU) and per-head GEMM equivalents as address expressions (GPU);
  * every projection / MLP / MoE / LM-head matmul ->
    ``kernels.matmul.generator.tpu_candidate_specs`` (TPU) and
    ``core.specs.matmul_naive`` (GPU), with MoE expert FFNs weighted by the
    routing fan-out (``top_k``/``n_experts``);
  * SSM / RWKV mixers -> the GEMM equivalents of their chunked-parallel scan
    forms (chunk sizes from ``layers.shapes``).

The TPU candidates are the reference's Pallas specs in declared form (the
port cannot trace a Pallas kernel); ``tests/test_torch_suite.py`` holds
them, and every plan, equal to the reference's.

The plan is deliberately *per layer*: layers that share shapes produce
structurally identical workloads, and the engine's invariant cache collapses
them — re-pricing a 60-layer model costs a handful of distinct structural
tasks.

Deliberately not lowered (negligible or non-matmul work, see DESIGN.md §8):
embedding gathers, norms, RoPE, residual adds, RWKV's rank-64 decay lora,
Mamba's depthwise k=4 conv, and the stubbed audio/vision frontends (their
projection into ``d_model`` *is* lowered).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field as dc_field

from repro_torch import obs
from repro_torch.configs.base import SHAPES, ArchConfig, ShapeSpec
from repro_torch.kernels.matmul.generator import SUITE_GPU_BLOCKS, suite_gpu_configs
from repro_torch.layers import shapes as lshapes

TILE = 128  # MXU/lane tile: TPU block candidates need tile-divisible extents


class UnsupportedShape(ValueError):
    """The (arch, shape) cell is excluded by design (``valid_cells``), as
    opposed to a malformed config, which raises plain ``ValueError``."""


def pad_tile(x: int) -> int:
    """Round up to the 128 tile (minimum one tile) — what padding the
    compiler would apply to make the shape tileable."""
    return max(TILE, -(-int(x) // TILE) * TILE)


# interned generator outputs per shape class (see KernelWorkload); the suite
# prices thousands of per-layer workloads drawn from a few dozen shapes
_candidate_memo: dict = {}


@dataclass
class KernelWorkload:
    """One kernel invocation class inside a model's forward pass.

    ``kind`` selects the generator (``matmul`` | ``flash_attention``);
    ``backends`` says which machine types this workload is *for* (attention
    cores lower differently per backend, everything else is both);
    ``count`` is the multiplicity within its layer (expert fan-out, per-head
    GEMMs, scan chunks); ``params`` are the logical, unpadded shapes.
    """

    name: str                 # unique within the plan, e.g. "L03.attn.qkv"
    kind: str                 # "matmul" | "flash_attention"
    role: str                 # e.g. "attn.qkv", "moe.expert_in"
    params: dict
    count: int = 1
    backends: tuple = ("gpu", "tpu")

    # ---- generator coupling -------------------------------------------
    def tpu_candidates(self) -> list | None:
        """(config, PallasKernelSpec) candidates — shapes tile-padded (the
        generators' declared ``tpu_candidate_specs``).

        Interned per shape class: repeated layers (and repeated models)
        return the *same* candidate objects, so downstream consumers — the
        engine's cell-level dedupe, memoized spec hashes, cache probes —
        compare by identity instead of re-walking equal spec trees.
        """
        if "tpu" not in self.backends:
            return None
        key = (self.kind, tuple(sorted(self.params.items())))
        cands = _candidate_memo.get(key)
        if cands is not None:
            return cands
        from repro_torch.kernels.flash_attention.generator import (
            tpu_candidate_specs as flash_candidates,
        )
        from repro_torch.kernels.matmul.generator import (
            tpu_candidate_specs as matmul_candidates,
        )

        p = self.params
        if self.kind == "matmul":
            cands = list(matmul_candidates(pad_tile(p["M"]), pad_tile(p["K"]),
                                           pad_tile(p["N"]),
                                           elem_bytes=p["elem_bytes"]))
        elif self.kind == "flash_attention":
            cands = list(flash_candidates(p["B"], p["Hq"], p["Hkv"], p["Sq"],
                                          p["Skv"], p["D"], causal=p["causal"],
                                          elem_bytes=p["elem_bytes"]))
        else:
            raise ValueError(f"no TPU generator for kind {self.kind!r}")
        _candidate_memo[key] = cands
        return cands

    def gpu_spec(self):
        """Address-expression artifact for the GPU estimator (exact shapes —
        the GPU model does not require tile divisibility).  Interned like
        ``tpu_candidates``."""
        if "gpu" not in self.backends:
            return None
        if self.kind != "matmul":
            return None  # attention cores lower to GEMM workloads for GPU
        p = self.params
        key = ("gpu", self.kind, tuple(sorted(self.params.items())))
        spec = _candidate_memo.get(key)
        if spec is None:
            from repro_torch.core.specs import matmul_naive

            spec = matmul_naive(p["M"], p["K"], p["N"],
                                elem_bytes=p["elem_bytes"])
            _candidate_memo[key] = spec
        return spec

    # ---- accounting ----------------------------------------------------
    def flops(self) -> float:
        """Useful flops of ONE instance (multiply by ``count`` for the
        layer total)."""
        p = self.params
        if self.kind == "matmul":
            return 2.0 * p["M"] * p["K"] * p["N"]
        tri = 0.5 if p["causal"] and p["Sq"] == p["Skv"] else 1.0
        return 4.0 * p["B"] * p["Hq"] * p["Sq"] * p["Skv"] * p["D"] * tri

    def structural_key(self) -> tuple:
        """Workloads sharing this key share every structural task."""
        return (self.kind, self.backends,
                tuple(sorted(self.params.items())))


@dataclass
class ModelPlan:
    """The priceable decomposition of one (model config, input shape) cell."""

    config: ArchConfig
    shape: ShapeSpec
    batch: int
    workloads: list = dc_field(default_factory=list)

    # ---- structure -----------------------------------------------------
    def kind_counts(self) -> dict:
        out: dict = {}
        for w in self.workloads:
            out[w.kind] = out.get(w.kind, 0) + 1
        return out

    def role_counts(self) -> dict:
        """role -> (number of workload instances, sum of their counts)."""
        out: dict = {}
        for w in self.workloads:
            n, c = out.get(w.role, (0, 0))
            out[w.role] = (n + 1, c + w.count)
        return out

    def distinct(self) -> list:
        """(representative workload, total count) per structural class —
        the work the engine actually evaluates after memoization."""
        seen: dict = {}
        order = []
        for w in self.workloads:
            k = w.structural_key()
            if k in seen:
                rep, c = seen[k]
                seen[k] = (rep, c + w.count)
            else:
                seen[k] = (w, w.count)
                order.append(k)
        return [seen[k] for k in order]

    def total_flops(self, backend: str = "tpu") -> float:
        """Useful flops of one forward pass under one backend's lowering
        (attention cores lower differently per backend, so summing every
        workload would double-count them)."""
        return sum(w.flops() * w.count for w in self.workloads
                   if backend in w.backends)

    # ---- engine coupling ----------------------------------------------
    def engine_workloads(self, gpu_configs=None) -> list:
        """Lower to ``engine.Workload``s (one per kernel workload)."""
        from repro_torch.core.engine import Workload

        gpu_configs = gpu_configs or suite_gpu_configs()
        out = []
        # enumerate each structural class once: repeated layers share the
        # spec and candidate-list objects (the engine's cache dedupes
        # evaluation; this dedupes enumeration)
        by_class: dict = {}
        for w in self.workloads:
            k = w.structural_key()
            if k not in by_class:
                by_class[k] = (w.gpu_spec(), w.tpu_candidates())
            spec, cands = by_class[k]
            out.append(Workload(
                name=w.name,
                gpu_spec=spec,
                gpu_configs=gpu_configs if spec is not None else None,
                tpu_candidates=cands,
            ))
        return out


# ==========================================================================
# lowering
# ==========================================================================
def _mm(name, role, M, K, N, *, count=1, backends=("gpu", "tpu"),
        elem_bytes=2) -> KernelWorkload:
    return KernelWorkload(
        name=name, kind="matmul", role=role, count=count, backends=backends,
        params={"M": int(M), "K": int(K), "N": int(N),
                "elem_bytes": elem_bytes},
    )


def _attn_core(prefix, *, B, Hq, Hkv, Sq, Skv, D, causal, decode,
               elem_bytes=2) -> list:
    """Attention core: FA candidates on TPU, per-head GEMMs on GPU.

    Decode steps (Sq per sequence = 1) cannot tile a flash kernel's query
    axis, so both backends price the QK^T / AV GEMV-batch equivalents —
    M is the token batch, one GEMM class per query head.
    """
    if decode:
        return [
            _mm(f"{prefix}.core[qk]", "attn.core[qk]", B, D, Skv, count=Hq,
                elem_bytes=elem_bytes),
            _mm(f"{prefix}.core[av]", "attn.core[av]", B, Skv, D, count=Hq,
                elem_bytes=elem_bytes),
        ]
    fa = KernelWorkload(
        name=f"{prefix}.core[fa]", kind="flash_attention",
        role="attn.core[fa]", backends=("tpu",),
        params={"B": B, "Hq": Hq, "Hkv": Hkv, "Sq": Sq, "Skv": Skv, "D": D,
                "causal": causal, "elem_bytes": elem_bytes},
    )
    return [
        fa,
        _mm(f"{prefix}.core[qk]", "attn.core[qk]", Sq, D, Skv,
            count=B * Hq, backends=("gpu",), elem_bytes=elem_bytes),
        _mm(f"{prefix}.core[av]", "attn.core[av]", Sq, Skv, D,
            count=B * Hq, backends=("gpu",), elem_bytes=elem_bytes),
    ]


def _attn_block(prefix, cfg: ArchConfig, *, T, B, Sq, Skv, causal, decode,
                role_prefix="attn") -> list:
    """Self-attention sublayer: fused QKV projection, core, out projection."""
    hd = cfg.resolved_head_dim
    pr = lshapes.attention_proj_shapes(cfg.d_model, cfg.n_heads, cfg.n_kv, hd)
    wls = [_mm(f"{prefix}.{role_prefix}.qkv", f"{role_prefix}.qkv",
               T, *pr["qkv"])]
    core = _attn_core(f"{prefix}.{role_prefix}", B=B, Hq=cfg.n_heads,
                      Hkv=cfg.n_kv, Sq=Sq, Skv=Skv, D=hd, causal=causal,
                      decode=decode)
    for w in core:
        w.role = w.role.replace("attn.", f"{role_prefix}.", 1)
    wls += core
    wls.append(_mm(f"{prefix}.{role_prefix}.out", f"{role_prefix}.out",
                   T, *pr["out"]))
    return wls


def _mlp_block(prefix, cfg: ArchConfig, T, *, role_prefix="mlp") -> list:
    sh = lshapes.mlp_shapes(cfg.d_model, cfg.d_ff, cfg.mlp)
    (in_shape, n_in), (out_shape, _) = sh["in"], sh["out"]
    return [
        _mm(f"{prefix}.{role_prefix}.in", f"{role_prefix}.in",
            T, *in_shape, count=n_in),
        _mm(f"{prefix}.{role_prefix}.out", f"{role_prefix}.out",
            T, *out_shape),
    ]


def _moe_block(prefix, cfg: ArchConfig, T) -> list:
    """MoE sublayer with the routing fan-out made explicit: every token is
    dispatched to ``top_k`` experts, so each of the ``n_experts`` expert
    FFNs processes ``T * top_k / n_experts`` tokens (balanced routing, the
    capacity model's design point)."""
    sh = lshapes.moe_shapes(cfg.d_model, cfg.d_ff, cfg.n_experts, cfg.mlp)
    Te = max(1, math.ceil(T * cfg.top_k / cfg.n_experts))
    (r_shape, _) = sh["router"]
    (in_shape, n_in) = sh["expert_in"]
    (out_shape, _) = sh["expert_out"]
    wls = [
        _mm(f"{prefix}.moe.router", "moe.router", T, *r_shape),
        _mm(f"{prefix}.moe.expert_in", "moe.expert_in", Te, *in_shape,
            count=cfg.n_experts * n_in),
        _mm(f"{prefix}.moe.expert_out", "moe.expert_out", Te, *out_shape,
            count=cfg.n_experts),
    ]
    if cfg.dense_residual:  # arctic: dense MLP in parallel with the experts
        wls += _mlp_block(prefix, cfg, T)
    return wls


def _scan_equivalents(prefix, role_prefix, *, T, heads, head_dim, state,
                      chunk, decode) -> list:
    """GEMM equivalents of a chunked-parallel linear-attention/SSM scan.

    Per chunk and head (quadratic within the chunk, linear across chunks):
    ``intra``      (C x state x C)     intra-chunk interaction scores,
    ``intra_out``  (C x C x head_dim)  scores applied to values,
    ``state``      (state x C x head_dim) cross-chunk state update,
    ``state_out``  (C x state x head_dim) carried state applied to queries.
    Decode steps use the exact recurrence: a rank-1 state update plus a
    state readout per token per head.
    """
    if decode:
        return [
            _mm(f"{prefix}.{role_prefix}[state]", f"{role_prefix}[state]",
                state, 1, head_dim, count=heads * T),
            _mm(f"{prefix}.{role_prefix}[state_out]",
                f"{role_prefix}[state_out]",
                1, state, head_dim, count=heads * T),
        ]
    n = heads * max(1, math.ceil(T / chunk))
    C = chunk
    return [
        _mm(f"{prefix}.{role_prefix}[intra]", f"{role_prefix}[intra]",
            C, state, C, count=n),
        _mm(f"{prefix}.{role_prefix}[intra_out]", f"{role_prefix}[intra_out]",
            C, C, head_dim, count=n),
        _mm(f"{prefix}.{role_prefix}[state]", f"{role_prefix}[state]",
            state, C, head_dim, count=n),
        _mm(f"{prefix}.{role_prefix}[state_out]", f"{role_prefix}[state_out]",
            C, state, head_dim, count=n),
    ]


def _mamba_block(prefix, cfg: ArchConfig, T, decode) -> list:
    d = lshapes.mamba2_dims(cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim)
    return [
        _mm(f"{prefix}.ssm.in", "ssm.in", T, cfg.d_model, d["d_in_proj"]),
        *_scan_equivalents(prefix, "ssm.scan", T=T, heads=d["n_heads"],
                           head_dim=d["head_dim"], state=d["d_state"],
                           chunk=d["chunk"], decode=decode),
        _mm(f"{prefix}.ssm.out", "ssm.out", T, d["d_inner"], cfg.d_model),
    ]


def _rwkv_block(prefix, cfg: ArchConfig, T, decode) -> list:
    d = lshapes.rwkv6_dims(cfg.d_model, cfg.ssm_head_dim)
    ch = lshapes.rwkv6_channel_mix_shapes(cfg.d_model, cfg.d_ff)
    return [
        _mm(f"{prefix}.rwkv.proj", "rwkv.proj", T, cfg.d_model, cfg.d_model,
            count=d["n_proj"]),
        *_scan_equivalents(prefix, "rwkv.wkv", T=T, heads=d["n_heads"],
                           head_dim=d["head_dim"], state=d["head_dim"],
                           chunk=d["chunk"], decode=decode),
        _mm(f"{prefix}.rwkv.out", "rwkv.out", T, cfg.d_model, cfg.d_model),
        _mm(f"{prefix}.rwkv.chan[key]", "rwkv.chan[key]", T, *ch["key"][0]),
        _mm(f"{prefix}.rwkv.chan[value]", "rwkv.chan[value]",
            T, *ch["value"][0]),
        _mm(f"{prefix}.rwkv.chan[recept]", "rwkv.chan[recept]",
            T, *ch["receptance"][0]),
    ]


def lower_model(cfg: ArchConfig, shape: ShapeSpec | str = "train_4k",
                batch: int = 1) -> ModelPlan:
    """Decompose one forward pass of ``cfg`` at ``shape`` into a kernel plan.

    ``batch`` is the per-chip batch for train/prefill shapes (sequences);
    decode shapes take their token batch from ``shape.global_batch`` (one
    token per sequence per step).  Raises ``ValueError`` for the cells
    ``configs.base.valid_cells`` excludes (long-context on quadratic archs).
    """
    if isinstance(shape, str):
        shape = SHAPES[shape]
    if shape.kind == "long_decode" and not cfg.is_sub_quadratic:
        raise UnsupportedShape(
            f"{cfg.name} cannot lower {shape.name}: quadratic attention "
            "(see DESIGN.md §4)")

    decode = shape.kind in ("decode", "long_decode")
    S = pad_tile(shape.seq_len)             # padded sequence length
    hd = cfg.resolved_head_dim
    if decode:
        B = shape.global_batch              # tokens per decode step
        T = B
        Sq = 1
        ctx = shape.seq_len                 # KV-cache length
    else:
        B = batch
        T = B * S
        Sq = S
        ctx = S
    swa = cfg.swa_window
    Skv = min(ctx, swa) if swa > 0 else ctx
    Skv = pad_tile(Skv) if not decode else Skv

    wls: list = []

    # ---- frontend + encoder (whisper / internvl) -----------------------
    enc_T = 0
    if cfg.enc_layers and not decode:
        enc_T = B * pad_tile(cfg.frontend_tokens)
        wls.append(_mm("frontend.proj", "frontend.proj",
                       enc_T, cfg.frontend_dim, cfg.d_model))
        for i in range(cfg.enc_layers):
            p = f"E{i:02d}"
            wls += _attn_block(p, cfg, T=enc_T, B=B,
                               Sq=pad_tile(cfg.frontend_tokens),
                               Skv=pad_tile(cfg.frontend_tokens),
                               causal=False, decode=False)
            wls += _mlp_block(p, cfg, enc_T)
    elif cfg.frontend == "vision" and not decode:
        # VLM: patch embeddings are projected and prepended to the sequence
        vis_T = B * pad_tile(cfg.frontend_tokens)
        wls.append(_mm("frontend.proj", "frontend.proj",
                       vis_T, cfg.frontend_dim, cfg.d_model))
        T += vis_T
        Sq = Sq + pad_tile(cfg.frontend_tokens)
        Skv = pad_tile(min(Sq, swa)) if swa > 0 else Sq  # keep the SWA clamp

    # ---- decoder stack -------------------------------------------------
    cross_S = pad_tile(cfg.frontend_tokens) if cfg.enc_layers else 0
    pr = lshapes.attention_proj_shapes(cfg.d_model, cfg.n_heads, cfg.n_kv, hd)

    def cross_attn(prefix) -> list:
        # per-layer cross-attention: q from decoder tokens, kv recomputed
        # from the encoder output (mirrors models.lm: no cross-KV cache)
        out = [
            _mm(f"{prefix}.cross.q", "cross.q", T, *pr["q"]),
            _mm(f"{prefix}.cross.kv", "cross.kv", B * cross_S, *pr["kv"]),
        ]
        if decode:
            out += [
                _mm(f"{prefix}.cross.core[qk]", "cross.core[qk]",
                    B, hd, cross_S, count=cfg.n_heads),
                _mm(f"{prefix}.cross.core[av]", "cross.core[av]",
                    B, cross_S, hd, count=cfg.n_heads),
            ]
        else:
            core = _attn_core(f"{prefix}.cross", B=B, Hq=cfg.n_heads,
                              Hkv=cfg.n_kv, Sq=Sq, Skv=cross_S, D=hd,
                              causal=False, decode=False)
            for w in core:
                w.role = w.role.replace("attn.", "cross.", 1)
            out += core
        out.append(_mm(f"{prefix}.cross.out", "cross.out", T, *pr["out"]))
        return out

    if cfg.block_pattern == "attn":
        for i in range(cfg.n_layers):
            p = f"L{i:02d}"
            wls += _attn_block(p, cfg, T=T, B=B, Sq=Sq, Skv=Skv,
                               causal=True, decode=decode)
            if cfg.enc_layers:
                wls += cross_attn(p)
            if cfg.n_experts:
                wls += _moe_block(p, cfg, T)
            else:
                wls += _mlp_block(p, cfg, T)
    elif cfg.block_pattern == "rwkv":
        for i in range(cfg.n_layers):
            wls += _rwkv_block(f"L{i:02d}", cfg, T, decode)
    elif cfg.block_pattern == "mamba_hybrid":
        # k mamba layers per group, then ONE weight-shared attn+MLP block
        # (shared weights, but the compute runs once per group)
        k = cfg.hybrid_attn_every
        for i in range(cfg.n_layers):
            wls += _mamba_block(f"L{i:02d}", cfg, T, decode)
            if (i + 1) % k == 0:
                g = f"G{i // k:02d}"
                wls += _attn_block(g, cfg, T=T, B=B, Sq=Sq, Skv=Skv,
                                   causal=True, decode=decode)
                wls += _mlp_block(g, cfg, T)
    else:
        raise ValueError(cfg.block_pattern)

    # ---- LM head (prefill emits last-token logits only) ----------------
    head_T = B if shape.kind == "prefill" else T
    wls.append(_mm("head.lm", "head.lm",
                   head_T, cfg.d_model, cfg.padded_vocab))

    return ModelPlan(config=cfg, shape=shape, batch=batch, workloads=wls)


def lower_all(shape: ShapeSpec | str = "train_4k", batch: int = 1,
              archs=None) -> dict:
    """Lower every (known or given) arch that supports ``shape``;
    returns ``{arch_name: ModelPlan}`` in config-registry order."""
    from repro_torch.configs import ARCHS, get_config

    plans = {}
    for arch in (archs or ARCHS):
        cfg = get_config(arch)
        try:
            with obs.span("suite.lower", "suite", model=arch):
                plans[arch] = lower_model(cfg, shape, batch)
        except UnsupportedShape:
            continue  # excluded cell (long-context on a quadratic arch)
    return plans

