"""Decoder-only transformer (dense family): parameters, forward and loss.

Port of ``repro.models.transformer`` for dense stacks: the same tree
(``embed``, ``blocks[i]`` with ``ln1``/``ln2``/``attn``/``mlp``,
``final_norm``, optional ``lm_head``) and the training forward.  Gradients
come from autograd; with ``remat="layer"`` each block is recomputed in the
backward pass (``torch.utils.checkpoint``), as the reference's
``jax.checkpoint``.  MoE, SSM and hybrid stacks arrive with their own
slices of the port.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import attn_apply, attn_init
from repro_torch.models.common import (dense, dense_init, embed, embed_init,
                                       glu_mlp, glu_mlp_init, rmsnorm,
                                       rmsnorm_init, softmax_xent, unembed)


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


def block_apply(p: dict, x: torch.Tensor, cfg: ModelConfig, i: int, *,
                positions: torch.Tensor, causal_skip: bool) -> torch.Tensor:
    cdt = getattr(torch, cfg.dtype)
    h = rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix = attn_apply(p["attn"], h, cfg.attn,
                     is_global=cfg.layer_kind(i).get("attn_global", True),
                     positions=positions, compute_dtype=cdt,
                     causal_skip=causal_skip)
    x = x + mix.to(x.dtype)
    if "mlp" not in p:
        return x
    h = rmsnorm(p["ln2"], x, cfg.norm_eps)
    y = glu_mlp(p["mlp"], h, cfg.act, cdt)
    return x + y.to(x.dtype)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            causal_skip: bool = False) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V) in the compute dtype."""
    _require_dense(cfg)
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens.long(), cdt)
    positions = torch.arange(x.shape[1], device=x.device)
    for i, bp in enumerate(params["blocks"]):
        if cfg.remat == "layer" and torch.is_grad_enabled():
            x = checkpoint(block_apply, bp, x, cfg, i, positions=positions,
                           causal_skip=causal_skip, use_reentrant=False)
        else:
            x = block_apply(bp, x, cfg, i, positions=positions,
                            causal_skip=causal_skip)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cdt)
    return dense(params["lm_head"], x, cdt)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            causal_skip: bool = False) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S), optional "mask"}."""
    logits = forward(params, batch["tokens"], cfg, causal_skip=causal_skip)
    return softmax_xent(logits, batch["labels"], batch.get("mask"))
