"""Config dataclasses: model architecture, input shapes, distribution.

Every assigned architecture file in this package instantiates ``ModelConfig``
with the exact public hyperparameters and registers itself.  Shapes are
global (pre-sharding); the sharding policy maps them onto the mesh.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field


@dataclass(frozen=True)
class AttnConfig:
    num_heads: int
    num_kv_heads: int
    head_dim: int
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    window: int | None = None          # sliding-window size (SWA layers)
    chunk: int | None = None           # llama4-style chunked-local attention
    global_every: int = 0              # every Nth layer is global (0 = per window/chunk only)
    global_layers: tuple[int, ...] = ()  # explicit global-attention layer ids


@dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    expert_ff: int
    shared_expert_ff: int = 0
    interleave_step: int = 1           # every Nth layer is MoE (1 = all)
    capacity_factor: float = 1.25
    parallelism: str = "ep"            # "ep" (experts over model) | "tp" (ffn over model)


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int = 16
    conv_width: int = 4
    expand: int = 2
    dt_rank: int = 0                   # 0 = ceil(d_model / 16)


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                        # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    d_ff: int
    vocab_size: int
    attn: AttnConfig | None = None
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # encoder-decoder extras
    enc_layers: int = 0
    enc_seq: int = 0                   # encoder (frontend) sequence length
    frontend: str | None = None        # "audio_stub" | "vision_stub"
    frontend_seq: int = 0              # patch/frame tokens prepended (vlm)
    # numerics / structure
    norm_eps: float = 1e-5
    act: str = "silu"
    tie_embeddings: bool = False
    dtype: str = "bfloat16"            # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "layer"               # "none" | "layer"
    # sharding policy: "tp" (replicated params) | "fsdp" (params over data too)
    sharding: str = "tp"

    def with_(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def layer_kind(self, i: int) -> dict:
        """Resolve per-layer structure: attention flavour + mlp flavour."""
        kind: dict = {"mixer": "attn", "mlp": "dense"}
        if self.family == "ssm":
            kind["mixer"] = "ssm"
        elif self.family == "hybrid":
            kind["mixer"] = "hybrid"
        if self.moe is not None:
            step = max(self.moe.interleave_step, 1)
            # hf llama4 convention: layers (step-1, 2*step-1, ...) are MoE when
            # interleaved; step == 1 -> every layer.
            if (i + 1) % step == 0:
                kind["mlp"] = "moe"
        if self.attn is not None:
            a = self.attn
            is_global = (i in a.global_layers or
                         (a.global_every and (i + 1) % a.global_every == 0) or
                         (a.window is None and a.chunk is None))
            kind["attn_global"] = bool(is_global)
        return kind


@dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str                          # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def sub_quadratic(cfg: ModelConfig) -> bool:
    """Can this arch run long_500k?  SSM state, SWA or chunked attention."""
    if cfg.family in ("ssm", "hybrid"):
        return True
    if cfg.attn is not None and (cfg.attn.window or cfg.attn.chunk):
        return True
    return False


def applicable_shapes(cfg: ModelConfig) -> list[str]:
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if sub_quadratic(cfg):
        out.append("long_500k")
    return out
