"""GQA attention: parameters, head layout, the blockwise training path,
the flash-kernel prefill and cached decode.

Port of ``repro.models.attention`` for dense decoders: query heads are
zero-padded up to a multiple of ``HEAD_PAD_TO`` (the padded rows of ``wo``
are zero, so padded heads never reach the output); q head ``h`` reads kv
head ``h // true_group``.  Training uses :func:`blockwise_attention`, the
reference's plain online-softmax loop over key blocks in fp32 (it trains
with that jnp function), written here in plain PyTorch.  The serving
prefill (``attn_impl="kernel"``) runs the ``flash_attn`` kernel on the real
query heads instead, where the reference's prefill runs the same
blockwise loop.  :func:`attn_decode` is the contiguous-cache decode of one
token; paged decode attention lives in :mod:`repro_torch.serve.engine`.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models.common import apply_rope, dense, dense_init

NEG_INF = -1e30
HEAD_PAD_TO = 16  # model-axis size the padded head count must tile


def padded_heads(n: int, pad_to: int = HEAD_PAD_TO) -> int:
    return int(math.ceil(n / pad_to) * pad_to)


def attn_init(generator, cfg: AttnConfig, d_model: int, *,
              dtype: torch.dtype = torch.float32, device=None,
              pad_to: int = HEAD_PAD_TO) -> dict:
    """Query heads padded to tile the model axis, padded ``wo`` rows zero;
    KV heads are never padded."""
    hq = padded_heads(cfg.num_heads, pad_to)
    hkv = cfg.num_kv_heads
    hd = cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(generator, d_model, hq * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(generator, d_model, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(generator, d_model, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(generator, hq * hd, d_model, **kw),
    }
    if hq > cfg.num_heads:
        p["wo"]["w"][cfg.num_heads * hd:] = 0.0
    return p


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


def _gather_kv_for_local_q(k: torch.Tensor, v: torch.Tensor,
                           cfg: AttnConfig, hq: int):
    """q head ``h`` reads kv head ``h // true_group`` (clipped for padded
    heads); returns kv per q head."""
    true_group = max(cfg.num_heads // cfg.num_kv_heads, 1)
    idx = torch.clamp(torch.arange(hq, device=k.device) // true_group, 0,
                      cfg.num_kv_heads - 1)
    return k.index_select(1, idx), v.index_select(1, idx)


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, *, causal: bool,
          window: int | None, chunk: int | None) -> torch.Tensor:
    m = torch.ones(torch.broadcast_shapes(q_pos.shape, k_pos.shape),
                   dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= k_pos <= q_pos
    if window is not None:
        m &= k_pos > q_pos - window
    if chunk is not None:
        m &= (k_pos // chunk) == (q_pos // chunk)
    return m


def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: int | None = None,
                        chunk: int | None = None, block_q: int = 2048,
                        block_k: int = 2048,
                        causal_skip: bool = False) -> torch.Tensor:
    """q: (B,Hq,S,D), k/v: (B,Hkv,S,D).  fp32 online softmax over key
    blocks, differentiable by autograd; the output is in q's dtype."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    scale = 1.0 / math.sqrt(d)
    bq = min(block_q, sq)
    bk = min(block_k, sk)
    nq = math.ceil(sq / bq)
    nk = math.ceil(sk / bk)
    dev = q.device

    outs = []
    for i in range(nq):
        q0, q1 = i * bq, min((i + 1) * bq, sq)
        qi = q[:, :, q0:q1].float() * scale
        m = torch.full((b, hq, q1 - q0, 1), NEG_INF, device=dev)
        l = torch.zeros((b, hq, q1 - q0, 1), device=dev)
        acc = torch.zeros((b, hq, q1 - q0, d), device=dev)
        for j in range(nk):
            k0, k1 = j * bk, min((j + 1) * bk, sk)
            if causal_skip and causal and k0 > q1 - 1:
                continue          # a block wholly in the future
            if causal_skip and window is not None and k1 - 1 <= q0 - window:
                continue          # a block wholly out of the window
            if (causal_skip and chunk is not None
                    and (k1 - 1) // chunk < q0 // chunk):
                continue          # a block before this q range's chunk
            kj = k[:, :, k0:k1].float()
            vj = v[:, :, k0:k1].float()
            if group > 1:
                kj = torch.repeat_interleave(kj, group, dim=1)
                vj = torch.repeat_interleave(vj, group, dim=1)
            s = qi @ kj.transpose(-1, -2)
            q_pos = torch.arange(q0, q1, device=dev)[:, None]
            k_pos = torch.arange(k0, k1, device=dev)[None, :]
            msk = _mask(q_pos, k_pos, causal=causal, window=window,
                        chunk=chunk)
            s = torch.where(msk, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(s - m_new)
            l = alpha * l + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + p @ vj
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-30))
    return torch.cat(outs, dim=2).to(q.dtype)


ATTN_IMPLS = ("blockwise", "kernel")


def attn_apply(p: dict, x: torch.Tensor, cfg: AttnConfig, *, is_global: bool,
               positions: torch.Tensor | None = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               causal: bool = True, causal_skip: bool = False,
               block_q: int = 2048, block_k: int = 2048,
               attn_impl: str = "blockwise") -> torch.Tensor:
    """Self-attention over a full sequence (train / prefill) on one rank;
    the tensor-parallel split arrives with its slice.

    ``attn_impl="kernel"`` (the prefill; no gradient) runs
    :func:`flash_attention` on the ``num_heads`` real query heads, which read
    kv head ``h // (num_heads / num_kv_heads)`` as the reference's
    ``_gather_kv_for_local_q`` maps them, and gives the padded heads zeros
    (their rows of ``wo`` are zero, so the output is the same).
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    b, s, _ = x.shape
    hq = p["wq"]["w"].shape[1] // cfg.head_dim
    hkv = p["wk"]["w"].shape[1] // cfg.head_dim
    q = _split_heads(dense(p["wq"], x, compute_dtype), hq)
    k = _split_heads(dense(p["wk"], x, compute_dtype), hkv)
    v = _split_heads(dense(p["wv"], x, compute_dtype), hkv)
    pos = (positions if positions is not None
           else torch.arange(s, device=x.device))
    q = apply_rope(q, pos, cfg.rope_theta)
    k = apply_rope(k, pos, cfg.rope_theta)
    window = None if is_global else cfg.window
    chunk = None if is_global else cfg.chunk
    if attn_impl == "kernel":
        o = flash_attention(q[:, :cfg.num_heads], k, v, causal=causal,
                            window=window, chunk=chunk)
        if hq > cfg.num_heads:
            o = torch.cat([o, o.new_zeros((b, hq - cfg.num_heads) +
                                          o.shape[2:])], dim=1)
    else:
        if hq != hkv:
            k, v = _gather_kv_for_local_q(k, v, cfg, hq)
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk, block_q=block_q, block_k=block_k,
                                causal_skip=causal_skip)
    return dense(p["wo"], _merge_heads(o), compute_dtype)


def decode_attention(q1: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: int, *,
                     window: int | None = None, chunk: int | None = None,
                     rolling: bool = False) -> torch.Tensor:
    """q1: (B,Hq,1,D); caches: (B,Hkv,C,D); ``pos``: the current position.

    With ``rolling`` the cache is a circular buffer of size C holding the
    last C positions; slot ``t`` holds absolute position
    ``pos - ((pos - t) mod C)``; masking handles validity.
    """
    hq, d = q1.shape[1], q1.shape[3]
    hkv, c = k_cache.shape[1], k_cache.shape[2]
    group = hq // hkv
    k = torch.repeat_interleave(k_cache, group, 1) if group > 1 else k_cache
    v = torch.repeat_interleave(v_cache, group, 1) if group > 1 else v_cache
    s = torch.einsum("bhqd,bhkd->bhqk", q1.float() / math.sqrt(d), k.float())
    slot = torch.arange(c, device=q1.device)
    k_pos = pos - torch.remainder(pos - slot, c) if rolling else slot
    valid = (k_pos <= pos) & (k_pos >= 0)       # >=0 excludes unwritten slots
    if window is not None:
        valid &= k_pos > pos - window
    if chunk is not None:
        valid &= (k_pos // chunk) == (pos // chunk)
    s = torch.where(valid, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q1.dtype)


def attn_decode(p: dict, x1: torch.Tensor, cfg: AttnConfig, cache: dict, *,
                is_global: bool, pos: int,
                compute_dtype: torch.dtype = torch.bfloat16,
                cache_len_global: int | None = None) -> tuple:
    """One-token decode against a contiguous rolling cache
    ``{"k", "v"}: (B,Hkv,C,D)``, written in place at slot ``pos mod C``
    (the reference donates the cache and returns the updated one; the port
    updates the same tensors and returns them).  A cache shorter than
    ``cache_len_global`` is sequence-sharded over the model axis, which is
    not ported."""
    hq = p["wq"]["w"].shape[1] // cfg.head_dim
    hkv = p["wk"]["w"].shape[1] // cfg.head_dim
    c_local = cache["k"].shape[2]
    if c_local < (cache_len_global or c_local):
        raise NotImplementedError(
            "sequence-sharded decode needs the model axis (the "
            "tensor-parallel slice)")
    q = _split_heads(dense(p["wq"], x1, compute_dtype), hq)       # (B,Hq,1,D)
    k1 = _split_heads(dense(p["wk"], x1, compute_dtype), hkv)
    v1 = _split_heads(dense(p["wv"], x1, compute_dtype), hkv)
    pos1 = torch.full((1,), pos, device=x1.device)
    q = apply_rope(q, pos1, cfg.rope_theta)
    k1 = apply_rope(k1, pos1, cfg.rope_theta)
    slot = pos % c_local
    cache["k"][:, :, slot] = k1[:, :, 0].to(cache["k"].dtype)
    cache["v"][:, :, slot] = v1[:, :, 0].to(cache["v"].dtype)
    kc, vc = cache["k"], cache["v"]
    if hq != hkv:
        kc, vc = _gather_kv_for_local_q(kc, vc, cfg, hq)
    window = None if is_global else cfg.window
    chunk = None if is_global else cfg.chunk
    o = decode_attention(q, kc, vc, pos, window=window, chunk=chunk,
                         rolling=True)
    return dense(p["wo"], _merge_heads(o), compute_dtype), cache


def init_cache(cfg: AttnConfig, batch: int, seq_len: int, *, is_global: bool,
               dtype: torch.dtype = torch.bfloat16, device=None) -> dict:
    """Cache length: the full sequence for global layers, the window or
    chunk for local ones."""
    c = seq_len
    if not is_global:
        if cfg.window is not None:
            c = min(c, cfg.window)
        elif cfg.chunk is not None:
            c = min(c, cfg.chunk)
    shape = (batch, cfg.num_kv_heads, c, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}
