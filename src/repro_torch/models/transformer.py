"""Decoder-only transformer (dense family): parameters, forward, loss and
single-token decode.

Port of ``repro.models.transformer`` for dense stacks: the same tree
(``embed``, ``blocks[i]`` with ``ln1``/``ln2``/``attn``/``mlp``,
``final_norm``, optional ``lm_head``), the training / prefill forward and
the decode step against a per-layer KV cache.  Gradients come from
autograd; with ``remat="layer"`` each block is recomputed in the backward
pass (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
Under FSDP ``params["blocks"][i]`` is the block's list of flat weight
shards and ``block_resolver("blocks", i, shards)`` gathers it into the
block's tree inside the recomputed function, so that the backward pass
gathers again instead of keeping every gathered block alive.
MoE, SSM and hybrid stacks arrive with their own slices of the port.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (attn_apply, attn_decode,
                                          attn_init, init_cache)
from repro_torch.models.common import (dense, dense_init, embed, embed_init,
                                       glu_mlp, glu_mlp_init, rmsnorm,
                                       rmsnorm_init, softmax_xent, unembed)
from repro_torch.models.parallel import SINGLE, ParallelCtx


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
                positions: torch.Tensor, causal_skip: bool,
                attn_impl: str = "blockwise",
                ctx: ParallelCtx = SINGLE) -> torch.Tensor:
    cdt = getattr(torch, cfg.dtype)
    h = ctx.fan_out(rmsnorm(p["ln1"], x, cfg.norm_eps))
    mix = attn_apply(p["attn"], h, cfg.attn,
                     is_global=cfg.layer_kind(i).get("attn_global", True),
                     ctx=ctx, positions=positions, compute_dtype=cdt,
                     causal_skip=causal_skip, attn_impl=attn_impl)
    x = x + mix.to(x.dtype)
    if "mlp" not in p:
        return x
    h = ctx.fan_out(rmsnorm(p["ln2"], x, cfg.norm_eps))
    y = glu_mlp(p["mlp"], h, cfg.act, cdt, ctx, cfg.d_ff)
    return x + y.to(x.dtype)


def _resolved_block_apply(raw, x: torch.Tensor, cfg: ModelConfig, i: int, *,
                          block_resolver, **kw) -> torch.Tensor:
    bp = block_resolver("blocks", i, raw) if block_resolver else raw
    return block_apply(bp, x, cfg, i, **kw)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
            attn_impl: str = "blockwise",
            block_resolver=None) -> torch.Tensor:
    """tokens: (B, S) -> logits (B, S, V_local) in the compute dtype: the
    whole vocabulary on one rank, this rank's vocab shard under tensor
    parallelism (``ctx``, the parameters this rank's shards).
    ``attn_impl="kernel"`` runs every layer's attention through the
    ``flash_attn`` kernel (the serving prefill; no gradient).
    ``block_resolver`` (FSDP) turns a block's shard list into its tree, and
    is called inside the checkpointed function."""
    _require_dense(cfg)
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens.long(), cdt, ctx, cfg.vocab_size)
    positions = torch.arange(x.shape[1], device=x.device)
    kw = dict(positions=positions, causal_skip=causal_skip,
              attn_impl=attn_impl, block_resolver=block_resolver, ctx=ctx)
    for i, raw in enumerate(params["blocks"]):
        if cfg.remat == "layer" and torch.is_grad_enabled():
            x = checkpoint(_resolved_block_apply, raw, x, cfg, i, **kw,
                           use_reentrant=False)
        else:
            x = _resolved_block_apply(raw, x, cfg, i, **kw)
    return _logits(params, ctx.fan_out(
        rmsnorm(params["final_norm"], x, cfg.norm_eps)), cfg)


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The normed activations -> logits over the table's vocab rows."""
    cdt = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cdt)
    return dense(params["lm_head"], x, cdt)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
            block_resolver=None) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S), optional "mask"}; the
    cross entropy is vocab-parallel under tensor parallelism."""
    logits = forward(params, batch["tokens"], cfg, ctx=ctx,
                     causal_skip=causal_skip, block_resolver=block_resolver)
    return softmax_xent(logits, batch["labels"], batch.get("mask"), ctx,
                        cfg.vocab_size)


def _is_global(cfg: ModelConfig, i: int) -> bool:
    return cfg.layer_kind(i).get("attn_global", True)


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      device=None) -> list:
    """One ``{"kv": {"k", "v"}}`` per layer, zeros."""
    _require_dense(cfg)
    return [{"kv": init_cache(cfg.attn, batch, seq_len,
                              is_global=_is_global(cfg, i), dtype=cache_dtype,
                              device=device)}
            for i in range(cfg.num_layers)]


def cache_len(cfg: ModelConfig, i: int, seq_len: int) -> int:
    """Global KV-cache length of layer ``i`` (mirrors ``init_cache``)."""
    c = seq_len
    if not _is_global(cfg, i):
        if cfg.attn.window is not None:
            c = min(c, cfg.attn.window)
        elif cfg.attn.chunk is not None:
            c = min(c, cfg.attn.chunk)
    return c


def decode_step(params: dict, token: torch.Tensor, state: list, pos: int,
                cfg: ModelConfig, *, ctx: ParallelCtx = SINGLE,
                seq_len: int | None = None,
                block_resolver=None) -> tuple[torch.Tensor, list]:
    """token: (B,) ints at position ``pos``; returns (logits (B, V_local),
    state) with every layer's cache written in place (a sequence-sharded
    cache holds this rank's slots)."""
    _require_dense(cfg)
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], token.long()[:, None], cdt, ctx,
              cfg.vocab_size)
    for i, raw in enumerate(params["blocks"]):
        bp = block_resolver("blocks", i, raw) if block_resolver else raw
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        clen = cache_len(cfg, i, seq_len) if seq_len else None
        mix, state[i]["kv"] = attn_decode(
            bp["attn"], h, cfg.attn, state[i]["kv"],
            is_global=_is_global(cfg, i), pos=pos, ctx=ctx,
            compute_dtype=cdt, cache_len_global=clen)
        x = x + mix.to(x.dtype)
        if "mlp" in bp:
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            x = x + glu_mlp(bp["mlp"], h, cfg.act, cdt, ctx,
                            cfg.d_ff).to(x.dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], state
