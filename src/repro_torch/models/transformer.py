"""Decoder-only transformer (dense, MoE, SSM and hybrid families):
parameters, forward, loss and single-token decode.

Port of ``repro.models.transformer``: the same tree (``embed``,
``blocks[i]`` with ``ln1``/``ln2`` and, by the layer's kind, ``attn``,
``ssm`` (Mamba-1, :mod:`repro_torch.models.ssm`), both and ``beta`` on a
hybrid layer, ``mlp`` or ``moe``, ``final_norm``, optional ``lm_head``),
the training / prefill forward and the decode step against per-layer
state (a KV cache, an SSM state, or both).  A pure-SSM stack (``d_ff ==
0``) keeps ``ln2`` unused, as the reference does, so the leaves match its
one for one (the gradient of ``ln2`` is zero).  A hybrid layer runs
attention (windowed unless the layer is global) and the SSM heads on the
same input and mixes them as ``0.5 * (a * beta[0] + s * beta[1])``.
``extra_embeds`` (a modality stub's patch embeddings) are prepended to the
token embeddings, and the loss is taken over the text positions only.
:func:`forward` also returns the MoE layers' summed load-balancing loss and
their mean drop fraction; :func:`loss_fn` adds ``AUX_LOSS_WEIGHT`` times the
former and reports the latter through ``stats_out``.  Gradients come from
autograd; with ``remat="layer"`` each block is recomputed in the backward
pass (``torch.utils.checkpoint``), as the reference's ``jax.checkpoint``.
Under FSDP ``params["blocks"][i]`` is the block's list of flat weight
shards and ``block_resolver("blocks", i, shards)`` gathers it into the
block's tree inside the recomputed function, so that the backward pass
gathers again instead of keeping every gathered block alive.
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
from repro_torch.models.moe import moe_apply, moe_init
from repro_torch.models.parallel import SINGLE, ParallelCtx
from repro_torch.models.ssm import (init_ssm_state, ssm_apply, ssm_decode,
                                    ssm_init)

AUX_LOSS_WEIGHT = 0.01


def _is_moe(cfg: ModelConfig, i: int) -> bool:
    return cfg.layer_kind(i)["mlp"] == "moe"


def moe_layer_count(cfg: ModelConfig) -> int:
    """How many of the stack's layers are MoE (0 for a dense stack)."""
    return sum(1 for i in range(cfg.num_layers) if _is_moe(cfg, i))


def _mixer(cfg: ModelConfig, i: int) -> str:
    """``"attn"``, ``"ssm"`` or ``"hybrid"``: layer ``i``'s sequence mixer."""
    return cfg.layer_kind(i)["mixer"]


def block_init(generator, cfg: ModelConfig, i: int, dtype: torch.dtype,
               device=None) -> dict:
    mixer = _mixer(cfg, i)
    p: dict = {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
               "ln2": rmsnorm_init(cfg.d_model, dtype, device)}
    if mixer in ("attn", "hybrid"):
        p["attn"] = attn_init(generator, cfg.attn, cfg.d_model, dtype=dtype,
                              device=device)
    if mixer in ("ssm", "hybrid"):
        p["ssm"] = ssm_init(generator, cfg.ssm, cfg.d_model, dtype=dtype,
                            device=device)
    if mixer == "hybrid":
        p["beta"] = torch.ones((2,), dtype=dtype, device=device)
    if _is_moe(cfg, i):
        p["moe"] = moe_init(generator, cfg.moe, cfg.d_model, dtype=dtype,
                            device=device)
    elif cfg.d_ff > 0:
        p["mlp"] = glu_mlp_init(generator, cfg.d_model, cfg.d_ff,
                                dtype=dtype, device=device)
    return p


def layer_attn_impl(cfg: ModelConfig, i: int, attn_impl: str) -> str:
    """The attention route of layer ``i`` under ``attn_impl``, fixed by the
    layer's kind: the ``flash_attn`` kernel has no chunk mask, so a
    chunked-local layer (llama4's) runs the blockwise loop, the
    reference's own prefill attention, on every layer."""
    if attn_impl == "kernel" and not _is_global(cfg, i) \
            and cfg.attn.chunk is not None:
        return "blockwise"
    return attn_impl


def init_params(generator, cfg: ModelConfig, device=None) -> dict:
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
                ctx: ParallelCtx = SINGLE
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block: ``(x, aux, drop)``, the last two the MoE layer's
    load-balancing loss and drop fraction (zeros on a dense layer)."""
    cdt = getattr(torch, cfg.dtype)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)
    mixer = _mixer(cfg, i)
    h = ctx.fan_out(rmsnorm(p["ln1"], x, cfg.norm_eps))
    if mixer in ("attn", "hybrid"):
        a = attn_apply(p["attn"], h, cfg.attn, is_global=_is_global(cfg, i),
                       ctx=ctx, positions=positions, compute_dtype=cdt,
                       causal_skip=causal_skip,
                       attn_impl=layer_attn_impl(cfg, i, attn_impl))
    if mixer in ("ssm", "hybrid"):
        s = ssm_apply(p["ssm"], h, cfg.ssm, ctx=ctx, compute_dtype=cdt,
                      d_model=cfg.d_model)
    mix = a if mixer == "attn" else s if mixer == "ssm" else \
        _hybrid_mix(p["beta"], a, s, cdt)
    x = x + mix.to(x.dtype)
    if "moe" in p:        # moe places its own f-boundaries
        h = rmsnorm(p["ln2"], x, cfg.norm_eps)
        y, aux, drop = moe_apply(p["moe"], h, cfg.moe, cfg.act, ctx=ctx,
                                 compute_dtype=cdt)
        return x + y.to(x.dtype), aux, drop
    if "mlp" not in p:
        return x, zero, zero
    h = ctx.fan_out(rmsnorm(p["ln2"], x, cfg.norm_eps))
    y = glu_mlp(p["mlp"], h, cfg.act, cdt, ctx, cfg.d_ff)
    return x + y.to(x.dtype), zero, zero


def _hybrid_mix(beta: torch.Tensor, a: torch.Tensor, s: torch.Tensor,
                cdt: torch.dtype) -> torch.Tensor:
    """A hybrid layer's parallel attention and SSM heads, mixed in the
    compute dtype."""
    beta = beta.to(cdt)
    return 0.5 * (a * beta[0] + s * beta[1])


def _resolved_block_apply(raw, x: torch.Tensor, cfg: ModelConfig, i: int, *,
                          block_resolver, **kw):
    bp = block_resolver("blocks", i, raw) if block_resolver else raw
    return block_apply(bp, x, cfg, i, **kw)


def forward(params: dict, tokens: torch.Tensor, cfg: ModelConfig, *,
            ctx: ParallelCtx = SINGLE,
            extra_embeds: torch.Tensor | None = None,
            causal_skip: bool = False, attn_impl: str = "blockwise",
            block_resolver=None
            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """tokens: (B, S_text), ``extra_embeds`` (B, P, d) prepended (the
    modality stub) -> ``(logits, aux_loss, drop_fraction)``: the logits
    (B, P + S_text, V_local) in the compute dtype (the whole vocabulary on one rank,
    this rank's vocab shard under tensor parallelism: ``ctx``, the
    parameters this rank's shards), the MoE layers' summed load-balancing
    loss and their mean drop fraction (zeros for a dense stack).
    ``attn_impl="kernel"`` runs the attention through the ``flash_attn``
    kernel (the serving prefill; no gradient) on every layer but the
    chunked-local ones (:func:`layer_attn_impl`).  ``block_resolver``
    (FSDP) turns a block's shard list into its tree, and is called inside
    the checkpointed function."""
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], tokens.long(), cdt, ctx, cfg.vocab_size)
    if extra_embeds is not None:
        x = torch.cat([extra_embeds.to(cdt), x], dim=1)
    positions = torch.arange(x.shape[1], device=x.device)
    kw = dict(positions=positions, causal_skip=causal_skip,
              attn_impl=attn_impl, block_resolver=block_resolver, ctx=ctx)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    drop_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = moe_layer_count(cfg)
    for i, raw in enumerate(params["blocks"]):
        if cfg.remat == "layer" and torch.is_grad_enabled():
            x, aux, drop = checkpoint(_resolved_block_apply, raw, x, cfg, i,
                                      **kw, use_reentrant=False)
        else:
            x, aux, drop = _resolved_block_apply(raw, x, cfg, i, **kw)
        aux_total = aux_total + aux
        drop_total = drop_total + drop
    logits = _logits(params, ctx.fan_out(
        rmsnorm(params["final_norm"], x, cfg.norm_eps)), cfg)
    return logits, aux_total, drop_total / max(n_moe, 1)


def _logits(params: dict, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The normed activations -> logits over the table's vocab rows."""
    cdt = getattr(torch, cfg.dtype)
    if cfg.tie_embeddings:
        return unembed(params["embed"], x, cdt)
    return dense(params["lm_head"], x, cdt)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
            block_resolver=None,
            stats_out: list | None = None) -> torch.Tensor:
    """batch: {"tokens": (B,S), "labels": (B,S), optional "mask",
    optional "extra_embeds" (B,P,d)}; the cross entropy over the text
    positions (vocab-parallel under tensor parallelism) plus
    ``AUX_LOSS_WEIGHT`` times the MoE load-balancing loss.  ``stats_out``,
    when given, receives one ``{"moe_drop_fraction": scalar}`` per call
    (detached)."""
    extra = batch.get("extra_embeds")
    logits, aux, drop = forward(params, batch["tokens"], cfg, ctx=ctx,
                                extra_embeds=extra, causal_skip=causal_skip,
                                block_resolver=block_resolver)
    if extra is not None:
        logits = logits[:, extra.shape[1]:]
    loss = softmax_xent(logits, batch["labels"], batch.get("mask"), ctx,
                        cfg.vocab_size)
    if stats_out is not None:
        stats_out.append({"moe_drop_fraction": drop.detach()})
    return loss + AUX_LOSS_WEIGHT * aux


def _is_global(cfg: ModelConfig, i: int) -> bool:
    """Whether layer ``i``'s attention is global: an attention layer's is
    unless its kind says otherwise, a hybrid layer's only where it says so
    (hymba's windowed heads)."""
    kind = cfg.layer_kind(i)
    return kind.get("attn_global", kind["mixer"] == "attn")


def init_decode_state(cfg: ModelConfig, batch: int, seq_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      device=None) -> list:
    """Per layer, zeros: ``{"kv": {"k", "v"}}`` in ``cache_dtype`` where it
    attends, ``{"ssm": {"h", "conv"}}`` in fp32 where it scans."""
    state = []
    for i in range(cfg.num_layers):
        mixer, st = _mixer(cfg, i), {}
        if mixer in ("attn", "hybrid"):
            st["kv"] = init_cache(cfg.attn, batch, seq_len,
                                  is_global=_is_global(cfg, i),
                                  dtype=cache_dtype, device=device)
        if mixer in ("ssm", "hybrid"):
            st["ssm"] = init_ssm_state(cfg.ssm, cfg.d_model, batch,
                                       dtype=torch.float32, device=device)
        state.append(st)
    return state


def cache_len(cfg: ModelConfig, i: int, seq_len: int) -> int:
    """Global KV-cache length of layer ``i`` (mirrors ``init_cache``)."""
    c = seq_len
    if not _is_global(cfg, i) and cfg.attn is not None:
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
    cache holds this rank's slots) and every SSM state replaced."""
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], token.long()[:, None], cdt, ctx,
              cfg.vocab_size)
    for i, raw in enumerate(params["blocks"]):
        bp = block_resolver("blocks", i, raw) if block_resolver else raw
        mixer = _mixer(cfg, i)
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        if mixer in ("attn", "hybrid"):
            clen = cache_len(cfg, i, seq_len) if seq_len else None
            a, state[i]["kv"] = attn_decode(
                bp["attn"], h, cfg.attn, state[i]["kv"],
                is_global=_is_global(cfg, i), pos=pos, ctx=ctx,
                compute_dtype=cdt, cache_len_global=clen)
        if mixer in ("ssm", "hybrid"):
            s, state[i]["ssm"] = ssm_decode(bp["ssm"], h, cfg.ssm,
                                            state[i]["ssm"], ctx=ctx,
                                            compute_dtype=cdt,
                                            d_model=cfg.d_model)
        mix = a if mixer == "attn" else s if mixer == "ssm" else \
            _hybrid_mix(bp["beta"], a, s, cdt)
        x = x + mix.to(x.dtype)
        if "moe" in bp:
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            y, _, _ = moe_apply(bp["moe"], h, cfg.moe, cfg.act, ctx=ctx,
                                compute_dtype=cdt)
            x = x + y.to(x.dtype)
        elif "mlp" in bp:
            h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
            x = x + glu_mlp(bp["mlp"], h, cfg.act, cdt, ctx,
                            cfg.d_ff).to(x.dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return _logits(params, x, cfg)[:, 0], state
