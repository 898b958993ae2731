"""Decoder-only transformer parameters (dense family).

Port of the init half of ``repro.models.transformer``: the same tree
(``embed``, ``blocks[i]`` with ``ln1``/``ln2``/``attn``/``mlp``,
``final_norm``, optional ``lm_head``).  MoE, SSM and hybrid stacks arrive
with their own slices of the port.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_init
from repro_torch.models.common import (dense_init, embed_init, glu_mlp_init,
                                       rmsnorm_init)


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.moe is not None or cfg.family in ("moe", "ssm", "hybrid"):
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.family!r} family is not ported yet (MoE "
            f"arrives with the expert-parallel slice, SSM and hybrid with "
            f"the remaining-families slice); the port covers dense stacks")


def block_init(generator, cfg: ModelConfig, i: int, dtype: torch.dtype,
               device=None) -> dict:
    _require_dense(cfg)
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
               "ln2": rmsnorm_init(cfg.d_model, dtype, device),
               "attn": attn_init(generator, cfg.attn, cfg.d_model,
                                 dtype=dtype, device=device)}
    if cfg.d_ff > 0:
        p["mlp"] = glu_mlp_init(generator, cfg.d_model, cfg.d_ff,
                                dtype=dtype, device=device)
    return p


def init_params(generator, cfg: ModelConfig, device=None) -> dict:
    _require_dense(cfg)
    dtype = getattr(torch, cfg.param_dtype)
    params = {
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                            dtype=dtype, device=device),
        "blocks": [block_init(generator, cfg, i, dtype, device)
                   for i in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size,
                                       dtype=dtype, device=device)
    return params
