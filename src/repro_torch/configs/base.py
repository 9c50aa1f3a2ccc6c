"""Model / shape / run configuration schema shared by all architectures.

Every assigned architecture is expressed as a ``ModelConfig`` whose
``block_pattern`` describes the repeating unit of layers (scanned at
compile time, so a 95-layer model compiles as fast as a 5-layer one).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

# Block kinds appearing in patterns.
ATTN = "attn"          # global causal self-attention
LOCAL = "local"        # sliding-window causal self-attention
SSM = "ssm"            # Mamba-2 SSD block
RGLRU = "rglru"        # RecurrentGemma RG-LRU recurrent block
ENC_ATTN = "enc_attn"  # bidirectional self-attention (encoder)


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    #: capacity factor for the dropping dispatch (tokens per expert buffer).
    capacity_factor: float = 1.25
    #: llama4-style: sigmoid router + a parallel shared expert; olmoe-style:
    #: softmax router, no shared expert.
    router: str = "softmax"          # "softmax" | "sigmoid"
    shared_expert: bool = False
    #: if set, only layers with (index % interleave == interleave - 1) are
    #: MoE; the rest use the dense FFN (llama4 maverick: 2).
    interleave: int = 1


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def n_heads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    d_conv: int = 4
    #: width of the recurrent branch (RecurrentGemma: d_model rounded to 256).
    lru_width: Optional[int] = None
    block_width: int = 2560


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    #: repeating unit of block kinds; len must divide n_layers (a remainder
    #: tail is allowed and kept unscanned).
    block_pattern: Tuple[str, ...] = (ATTN,)
    head_dim: Optional[int] = None         # default d_model // n_heads
    # attention details
    window: int = 4096                     # LOCAL window size
    rope_theta: float = 500000.0
    attn_softcap: Optional[float] = None   # gemma2: 50.0
    final_softcap: Optional[float] = None  # gemma2: 30.0
    qk_norm: bool = False
    # ffn
    mlp: str = "swiglu"                    # swiglu | geglu | gelu
    moe: Optional[MoEConfig] = None
    # recurrent families
    ssm: Optional[SSMConfig] = None
    rglru: Optional[RGLRUConfig] = None
    # families
    family: str = "decoder"                # decoder | encdec | vlm | audio
    norm: str = "rmsnorm"                  # rmsnorm | layernorm
    tie_embeddings: bool = False
    scale_embed: bool = False              # gemma-style sqrt(d) embed scale
    # enc-dec (whisper)
    max_positions: int = 32768             # learned-pos table (whisper decoder)
    n_enc_layers: int = 0
    enc_positions: int = 1500              # audio frames after conv stub
    # vlm stub
    n_patches: int = 256                   # prepended patch embeddings
    # numerics / distribution
    param_dtype: str = "float32"
    moment_dtype: str = "float32"          # bf16 for >=60B models (fits HBM)
    activation_dtype: str = "bfloat16"
    #: run long_500k? only sub-quadratic decode paths (ssm / rglru+local)
    supports_long_context: bool = False

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def unit_count(self) -> int:
        return self.n_layers // len(self.block_pattern)

    def tail_pattern(self) -> Tuple[str, ...]:
        """Remainder layers not covered by whole pattern units."""
        rem = self.n_layers % len(self.block_pattern)
        return self.block_pattern[:rem]

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks), for rooflines."""
        d, ff, v = self.d_model, self.d_ff, self.vocab
        hd = self.resolved_head_dim
        attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
        dense_ffn = (3 if self.mlp in ("swiglu", "geglu") else 2) * d * ff
        total = 0
        pattern = list(self.block_pattern) * self.unit_count() + list(self.tail_pattern())
        for i, kind in enumerate(pattern):
            if kind in (ATTN, LOCAL, ENC_ATTN):
                total += attn
                if self.moe is not None and (i % self.moe.interleave == self.moe.interleave - 1):
                    total += 3 * d * self.moe.d_ff_expert * self.moe.n_experts
                    if self.moe.shared_expert:
                        total += dense_ffn
                else:
                    total += dense_ffn
            elif kind == SSM:
                cfg = self.ssm
                di = cfg.d_inner(d)
                nh = cfg.n_heads(d)
                total += d * (2 * di + 2 * cfg.d_state + nh)  # in_proj(z,x,B,C,dt)
                total += di * cfg.d_conv + di * d             # conv + out_proj
            elif kind == RGLRU:
                w = (self.rglru.lru_width or d)
                total += 2 * d * w + w * d                    # in (2 branches) + out
                total += w * self.rglru.d_conv + 2 * w * w + 2 * w  # conv + gates + lambda/D-ish
        total += v * d * (1 if self.tie_embeddings else 2)
        if self.family == "encdec":
            enc_block = attn + dense_ffn
            total += self.n_enc_layers * enc_block
            # decoder cross-attention
            total += self.n_layers * attn
        return total

    def n_active_params(self) -> int:
        """Active params per token (MoE counts top_k experts only)."""
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        full_expert = 3 * d * self.moe.d_ff_expert * self.moe.n_experts
        active_expert = 3 * d * self.moe.d_ff_expert * self.moe.top_k
        n_moe_layers = sum(
            1 for i in range(self.n_layers)
            if i % self.moe.interleave == self.moe.interleave - 1
        )
        return self.n_params() - n_moe_layers * (full_expert - active_expert)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One cell of the (arch x input-shape) grid."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def reduced_config(cfg: ModelConfig) -> ModelConfig:
    """Small same-family config for CPU smoke tests."""
    pattern_len = len(cfg.block_pattern)
    n_layers = pattern_len * 2 + (1 if cfg.tail_pattern() else 0) * len(cfg.tail_pattern())
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, n_experts=min(moe.n_experts, 8),
                                  d_ff_expert=min(moe.d_ff_expert, 128),
                                  top_k=min(moe.top_k, 2),
                                  # smoke tests check prefill/decode parity;
                                  # a generous capacity removes drop noise.
                                  capacity_factor=8.0)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, d_state=16, head_dim=16, chunk=32)
    rglru = cfg.rglru
    if rglru is not None:
        rglru = dataclasses.replace(rglru, lru_width=64)
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=max(pattern_len * 2, len(cfg.block_pattern)),
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=128,
        vocab=512,
        window=32,
        moe=moe,
        ssm=ssm,
        rglru=rglru,
        n_enc_layers=2 if cfg.n_enc_layers else 0,
        enc_positions=16,
        n_patches=8,
    )
