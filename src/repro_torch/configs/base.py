"""Model / run configuration schema for the assigned architectures.

A copy of ``repro/configs/base.py`` (which has no JAX in it): the port
imports nothing of the JAX package, so it keeps its own.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """Multi-head Latent Attention (DeepSeek-V2 / MiniCPM3 style)."""
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int = 64
    top_k: int = 6
    num_shared_experts: int = 2
    d_expert: int = 1408          # per-expert FFN hidden
    capacity_factor: float = 1.25
    # GShard-style grouped dispatch: positions/capacity computed within
    # each of `dispatch_groups` token groups (aligned to the data axis)
    # so the position prefix-sum never crosses shard boundaries.  1 =
    # single global group.
    dispatch_groups: int = 1
    # ALB-adaptive dispatch (DESIGN.md section 5): when the router's load
    # histogram exceeds the threshold, overflow tokens are re-dealt to
    # their next-best expert via the prefix-sum renumbering.
    adaptive: bool = True
    router_aux_weight: float = 1e-2


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    d_conv: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None            # default d_model // num_heads
    attention: str = "gqa"                    # gqa | mla | none
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    act: str = "silu"                         # silu (swiglu) | gelu
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    # hybrid (zamba2): every `attn_every` ssm blocks, apply the *shared*
    # attention block (single weight set, zamba2's key trick)
    attn_every: int = 0
    # modality frontend stub: prepended embedding prefix [B, prefix_len, D]
    prefix_len: int = 0
    num_codebooks: int = 1                    # musicgen: 4 EnCodec streams
    sub_quadratic: bool = False               # may run long_500k
    max_seq_len: int = 524_288

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // max(self.num_heads, 1)

    @property
    def padded_vocab(self) -> int:
        """Embedding/head tables are padded to a 128 multiple so the
        vocab dim shards evenly on any mesh axis (MaxText-style)."""
        return -(-self.vocab_size // 128) * 128

    def scaled(self, **kw) -> "ModelConfig":
        """Reduced copy for smoke tests."""
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Tuple[ShapeConfig, ...] = (
    ShapeConfig("train_4k", 4_096, 256, "train"),
    ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    ShapeConfig("decode_32k", 32_768, 128, "decode"),
    ShapeConfig("long_500k", 524_288, 1, "decode"),
)


def shape_by_name(name: str) -> ShapeConfig:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig):
    """long_500k only for sub-quadratic archs (assignment skip rule)."""
    out = []
    for s in SHAPES:
        if s.name == "long_500k" and not cfg.sub_quadratic:
            continue
        out.append(s)
    return out
