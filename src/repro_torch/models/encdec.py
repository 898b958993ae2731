"""Whisper-style encoder-decoder; the audio front end is a stub (the
batch's ``frames`` (B, F, d) are precomputed mel-frame embeddings).

Port of ``repro.models.encdec``: the same tree (``enc_blocks``,
``enc_norm``, ``embed``, ``dec_blocks`` with ``self_attn``, ``ln_x`` and
``cross_attn``, ``final_norm``, ``lm_head``), the encoder, the decoder with
cross-attention over the encoder's output, the loss, and the decode step
against cached cross k/v (made once from the encoder's output by
:func:`init_decode_state`) and a self-attention KV cache.

Routes: training runs :func:`~repro_torch.models.attention.
blockwise_attention` everywhere, as the reference does.  With
``attn_impl="kernel"`` (serving, no gradient) the encoder's non-causal
self-attention and the decoder's causal self-attention run the
``flash_attn`` kernel; the cross-attention (queries over the text, keys
over the frames: Sq != Sk, which the kernel does not take) always runs the
blockwise loop, a route fixed by the call.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import (_gather_kv_for_local_q,
                                          _merge_heads, _needs_psum,
                                          _split_heads, attn_apply,
                                          attn_decode, attn_init,
                                          decode_attention, init_cache)
from repro_torch.models.common import (dense, dense_init, embed, embed_init,
                                       glu_mlp, glu_mlp_init, rmsnorm,
                                       rmsnorm_init, softmax_xent)
from repro_torch.models.parallel import SINGLE, ParallelCtx


def _enc_block_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "attn": attn_init(generator, cfg.attn, cfg.d_model, **kw),
            "ln2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": glu_mlp_init(generator, cfg.d_model, cfg.d_ff, **kw)}


def _dec_block_init(generator, cfg: ModelConfig, dtype, device) -> dict:
    kw = dict(dtype=dtype, device=device)
    return {"ln1": rmsnorm_init(cfg.d_model, dtype, device),
            "self_attn": attn_init(generator, cfg.attn, cfg.d_model, **kw),
            "ln_x": rmsnorm_init(cfg.d_model, dtype, device),
            "cross_attn": attn_init(generator, cfg.attn, cfg.d_model, **kw),
            "ln2": rmsnorm_init(cfg.d_model, dtype, device),
            "mlp": glu_mlp_init(generator, cfg.d_model, cfg.d_ff, **kw)}


def init_params(generator, cfg: ModelConfig, device=None) -> dict:
    dtype = getattr(torch, cfg.param_dtype)
    n_enc = cfg.enc_layers or cfg.num_layers
    return {
        "enc_blocks": [_enc_block_init(generator, cfg, dtype, device)
                       for _ in range(n_enc)],
        "enc_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "embed": embed_init(generator, cfg.vocab_size, cfg.d_model,
                            dtype=dtype, device=device),
        "dec_blocks": [_dec_block_init(generator, cfg, dtype, device)
                       for _ in range(cfg.num_layers)],
        "final_norm": rmsnorm_init(cfg.d_model, dtype, device),
        "lm_head": dense_init(generator, cfg.d_model, cfg.vocab_size,
                              dtype=dtype, device=device),
    }


def _layers(fn, blocks, x: torch.Tensor, **kw):
    """``x`` through ``fn(bp, x, **kw)`` for every block, each recomputed
    in the backward pass under ``remat="layer"`` (``kw["cfg"]``'s)."""
    for bp in blocks:
        if kw["cfg"].remat == "layer" and torch.is_grad_enabled():
            x = checkpoint(fn, bp, x, use_reentrant=False, **kw)
        else:
            x = fn(bp, x, **kw)
    return x


def _enc_block(bp: dict, x: torch.Tensor, *, cfg: ModelConfig,
               ctx: ParallelCtx, attn_impl: str) -> torch.Tensor:
    cdt = getattr(torch, cfg.dtype)
    h = ctx.fan_out(rmsnorm(bp["ln1"], x, cfg.norm_eps))
    x = x + attn_apply(bp["attn"], h, cfg.attn, is_global=True, ctx=ctx,
                       compute_dtype=cdt, causal=False,
                       attn_impl=attn_impl).to(x.dtype)
    h = ctx.fan_out(rmsnorm(bp["ln2"], x, cfg.norm_eps))
    return x + glu_mlp(bp["mlp"], h, cfg.act, cdt, ctx,
                       cfg.d_ff).to(x.dtype)


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig,
           ctx: ParallelCtx = SINGLE,
           attn_impl: str = "blockwise") -> torch.Tensor:
    """frames (B, F, d) -> the encoder's output (B, F, d) in the compute
    dtype."""
    x = frames.to(getattr(torch, cfg.dtype))
    x = _layers(_enc_block, params["enc_blocks"], x, cfg=cfg, ctx=ctx,
                attn_impl=attn_impl)
    return rmsnorm(params["enc_norm"], x, cfg.norm_eps)


def _dec_block(bp: dict, x: torch.Tensor, *, enc_out: torch.Tensor,
               cfg: ModelConfig, ctx: ParallelCtx, positions: torch.Tensor,
               causal_skip: bool, attn_impl: str) -> torch.Tensor:
    cdt = getattr(torch, cfg.dtype)
    h = ctx.fan_out(rmsnorm(bp["ln1"], x, cfg.norm_eps))
    x = x + attn_apply(bp["self_attn"], h, cfg.attn, is_global=True, ctx=ctx,
                       positions=positions, compute_dtype=cdt,
                       causal_skip=causal_skip,
                       attn_impl=attn_impl).to(x.dtype)
    h = ctx.fan_out(rmsnorm(bp["ln_x"], x, cfg.norm_eps))
    x = x + attn_apply(bp["cross_attn"], h, cfg.attn, is_global=True,
                       ctx=ctx, compute_dtype=cdt, causal=False,
                       cross_kv=ctx.fan_out(enc_out)).to(x.dtype)
    h = ctx.fan_out(rmsnorm(bp["ln2"], x, cfg.norm_eps))
    return x + glu_mlp(bp["mlp"], h, cfg.act, cdt, ctx,
                       cfg.d_ff).to(x.dtype)


def forward(params: dict, frames: torch.Tensor, tokens: torch.Tensor,
            cfg: ModelConfig, *, ctx: ParallelCtx = SINGLE,
            causal_skip: bool = False,
            attn_impl: str = "blockwise") -> torch.Tensor:
    """frames (B, F, d), tokens (B, S) -> logits (B, S, V_local) in the
    compute dtype."""
    cdt = getattr(torch, cfg.dtype)
    enc_out = encode(params, frames, cfg, ctx, attn_impl)
    x = embed(params["embed"], tokens.long(), cdt, ctx, cfg.vocab_size)
    positions = torch.arange(x.shape[1], device=x.device)
    x = _layers(_dec_block, params["dec_blocks"], x, enc_out=enc_out,
                cfg=cfg, ctx=ctx, positions=positions,
                causal_skip=causal_skip, attn_impl=attn_impl)
    x = ctx.fan_out(rmsnorm(params["final_norm"], x, cfg.norm_eps))
    return dense(params["lm_head"], x, cdt)


def loss_fn(params: dict, batch: dict, cfg: ModelConfig, *,
            ctx: ParallelCtx = SINGLE,
            causal_skip: bool = False) -> torch.Tensor:
    """batch: {"frames": (B,F,d), "tokens": (B,S), "labels": (B,S),
    optional "mask"}; the token-mean cross entropy."""
    logits = forward(params, batch["frames"], batch["tokens"], cfg, ctx=ctx,
                     causal_skip=causal_skip)
    return softmax_xent(logits, batch["labels"], batch.get("mask"), ctx,
                        cfg.vocab_size)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_decode_state(params: dict, frames: torch.Tensor, cfg: ModelConfig,
                      batch: int, seq_len: int,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      ctx: ParallelCtx = SINGLE,
                      attn_impl: str = "blockwise") -> list:
    """Runs the encoder once over ``frames`` and caches, per decoder layer,
    the cross k/v (B, Hkv, F, D) in ``cache_dtype`` beside an empty
    self-attention cache of ``seq_len`` slots, on the parameters'
    device."""
    cdt = getattr(torch, cfg.dtype)
    dev = frames.device
    with torch.no_grad():
        enc_out = encode(params, frames, cfg, ctx, attn_impl)
        state = []
        for bp in params["dec_blocks"]:
            cross = bp["cross_attn"]
            hkv = cross["wk"]["w"].shape[1] // cfg.attn.head_dim
            ck = _split_heads(dense(cross["wk"], enc_out, cdt), hkv)
            cv = _split_heads(dense(cross["wv"], enc_out, cdt), hkv)
            state.append({
                "kv": init_cache(cfg.attn, batch, seq_len, is_global=True,
                                 dtype=cache_dtype, device=dev),
                "cross_k": ck.to(cache_dtype).contiguous(),
                "cross_v": cv.to(cache_dtype).contiguous()})
    return state


def decode_step(params: dict, token: torch.Tensor, state: list, pos: int,
                cfg: ModelConfig, *, ctx: ParallelCtx = SINGLE
                ) -> tuple[torch.Tensor, list]:
    """token: (B,) ints at position ``pos``; returns (logits (B, V_local),
    state), the self-attention caches written in place and the cross k/v
    read as they are: every frame is valid (``decode_attention`` at the
    last frame's position, not rolling)."""
    cdt = getattr(torch, cfg.dtype)
    x = embed(params["embed"], token.long()[:, None], cdt, ctx,
              cfg.vocab_size)
    for bp, st in zip(params["dec_blocks"], state):
        h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
        mix, st["kv"] = attn_decode(bp["self_attn"], h, cfg.attn, st["kv"],
                                    is_global=True, pos=pos, ctx=ctx,
                                    compute_dtype=cdt)
        x = x + mix.to(x.dtype)
        h = rmsnorm(bp["ln_x"], x, cfg.norm_eps)
        cross = bp["cross_attn"]
        hq = cross["wq"]["w"].shape[1] // cfg.attn.head_dim
        q = _split_heads(dense(cross["wq"], h, cdt), hq)
        ck, cv = st["cross_k"], st["cross_v"]
        if hq != ck.shape[1]:
            ck, cv = _gather_kv_for_local_q(ck, cv, cfg.attn, hq, ctx)
        o = decode_attention(q, ck, cv, ck.shape[2] - 1, rolling=False)
        y = dense(cross["wo"], _merge_heads(o), cdt)
        if _needs_psum(cross, cfg.attn):
            y = ctx.psum(y)
        x = x + y.to(x.dtype)
        h = rmsnorm(bp["ln2"], x, cfg.norm_eps)
        x = x + glu_mlp(bp["mlp"], h, cfg.act, cdt, ctx, cfg.d_ff).to(x.dtype)
    x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
    return dense(params["lm_head"], x, cdt)[:, 0], state
