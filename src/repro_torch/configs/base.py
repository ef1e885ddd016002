"""Architecture config schema + assigned input-shape sets.

A copy of ``repro.configs.base`` (plain dataclasses, no jax): one
``ArchConfig`` instance per ported architecture lives in
``repro_torch.configs.<id>``; ``SHAPES`` defines the four assigned input
shapes.  ``reduced()`` derives the smoke-test config (same family, tiny
dims).
"""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                    # dense|moe|ssm|hybrid|encdec|vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    qkv_bias: bool = False
    swa_window: int = 0            # 0 -> full attention
    rope_theta: float = 10000.0
    norm: str = "rmsnorm"          # rmsnorm | layernorm
    mlp: str = "swiglu"            # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 2
    dense_residual: bool = False   # arctic: dense MLP in parallel with MoE
    # SSM / hybrid
    block_pattern: str = "attn"    # attn | rwkv | mamba_hybrid
    hybrid_attn_every: int = 6
    ssm_state: int = 64
    ssm_head_dim: int = 64
    # encoder-decoder / frontends
    enc_layers: int = 0            # >0 -> encoder-decoder (whisper)
    frontend: str = ""             # "" | audio | vision
    frontend_dim: int = 1024
    frontend_tokens: int = 1500    # frames (audio) / patches (vision)
    # numerics
    param_dtype: str = "bfloat16"
    remat: bool = True
    kv_int8: bool = False          # int8 KV cache (serving capacity knob)
    seq_parallel: bool = False     # Megatron-SP residual stream (per-arch)

    @property
    def padded_vocab(self) -> int:
        """Vocab rounded to 256 (Megatron-style) so the vocab axis shards
        cleanly on the 16-way model axis (granite/whisper have odd vocabs)."""
        return -(-self.vocab // 256) * 256

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def is_sub_quadratic(self) -> bool:
        """Can this arch lower long_500k? (SSM / hybrid / sliding-window)."""
        return self.block_pattern in ("rwkv", "mamba_hybrid") or self.swa_window > 0

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs decode (whisper via its decoder)

    def reduced(self) -> "ArchConfig":
        """Smoke-test config: same family/topology, tiny dims."""
        return replace(
            self,
            n_layers=min(self.n_layers, 2),
            d_model=128,
            n_heads=4,
            n_kv=max(1, min(self.n_kv, 2)) if self.n_kv < self.n_heads else 4,
            head_dim=32,
            d_ff=256,
            vocab=512,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            enc_layers=min(self.enc_layers, 2) if self.enc_layers else 0,
            frontend_dim=64 if self.frontend else self.frontend_dim,
            frontend_tokens=16 if self.frontend else self.frontend_tokens,
            hybrid_attn_every=2 if self.block_pattern == "mamba_hybrid" else self.hybrid_attn_every,
            ssm_state=16,
            ssm_head_dim=32,
            remat=False,
        )


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "long_decode"),
}


def valid_cells(cfg: ArchConfig):
    """The assigned (arch x shape) cells, honoring the long-context rule."""
    out = []
    for s in SHAPES.values():
        if s.kind == "long_decode" and not cfg.is_sub_quadratic:
            continue  # skip noted in DESIGN.md §4
        out.append(s)
    return out
