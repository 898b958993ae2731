"""Architecture registry: ``--arch <id>`` resolves here.

Each module defines ``CONFIG`` (exact public hyperparameters) and the
registry exposes ``get_config`` / ``reduced_config`` (smoke-scale same-family
variant) / ``list_archs``.

The port's own copy of ``repro.configs`` (plain data, no framework): the
two registries must stay field-for-field equal, which the port's tests check.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs import base
from repro_torch.configs.base import (SHAPES, AttnConfig, ModelConfig,
                                      MoEConfig, ShapeConfig, SSMConfig,
                                      applicable_shapes, sub_quadratic)

_ARCH_MODULES = [
    "llava_next_34b", "hymba_1p5b", "phi3_medium_14b", "minicpm_2b",
    "llama3p2_1b", "qwen2_7b", "llama4_maverick", "mixtral_8x7b",
    "whisper_base", "falcon_mamba_7b",
]


def _load() -> dict[str, ModelConfig]:
    import importlib

    out = {}
    for m in _ARCH_MODULES:
        mod = importlib.import_module(f"repro_torch.configs.{m}")
        out[mod.CONFIG.name] = mod.CONFIG
    return out


_REGISTRY: dict[str, ModelConfig] | None = None


def registry() -> dict[str, ModelConfig]:
    global _REGISTRY
    if _REGISTRY is None:
        _REGISTRY = _load()
    return _REGISTRY


def list_archs() -> list[str]:
    return sorted(registry().keys())


def get_config(name: str) -> ModelConfig:
    reg = registry()
    if name not in reg:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(reg)}")
    return reg[name]


def reduced_config(name: str) -> ModelConfig:
    """Smoke-scale config of the same family: tiny dims, same structure."""
    cfg = get_config(name)
    attn = cfg.attn
    if attn is not None:
        attn = dataclasses.replace(
            attn, num_heads=4, num_kv_heads=2, head_dim=16,
            window=None if attn.window is None else 32,
            chunk=None if attn.chunk is None else 32,
            global_layers=tuple(i for i in attn.global_layers if i < 2),
        )
    moe = cfg.moe
    if moe is not None:
        moe = dataclasses.replace(moe, num_experts=4,
                                  top_k=min(moe.top_k, 2), expert_ff=64,
                                  shared_expert_ff=64 if moe.shared_expert_ff else 0)
    ssm = cfg.ssm
    if ssm is not None:
        ssm = dataclasses.replace(ssm, state_dim=4, dt_rank=8)
    return cfg.with_(
        num_layers=2, d_model=64, d_ff=0 if cfg.d_ff == 0 else 128,
        vocab_size=512, attn=attn, moe=moe, ssm=ssm,
        enc_layers=2 if cfg.enc_layers else 0,
        enc_seq=16 if cfg.enc_seq else 0,
        frontend_seq=8 if cfg.frontend_seq else 0,
        dtype="float32", remat="none", sharding="tp",
    )


__all__ = ["AttnConfig", "ModelConfig", "MoEConfig", "SSMConfig",
           "ShapeConfig", "SHAPES", "applicable_shapes", "sub_quadratic",
           "get_config", "reduced_config", "list_archs", "registry", "base"]
