"""GQA attention: parameters, head layout, the blockwise training path,
the flash-kernel prefill and cached decode.

Port of ``repro.models.attention`` (self-attention, and the
encoder-decoder's cross-attention over ``cross_kv``): query heads are
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
from repro_torch.fake import host_values
from repro_torch.kernels.flash_attn import flash_attention
from repro_torch.models.common import apply_rope, dense, dense_init
from repro_torch.models.parallel import (SINGLE, ParallelCtx,
                                         sum_grads_over_model)

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


def _kv_index(cfg: AttnConfig, first: int, n: int, device) -> torch.Tensor:
    """The kv head each of the q heads ``first .. first + n - 1`` (global)
    reads: ``h // true_group``, clipped for padded heads."""
    true_group = max(cfg.num_heads // cfg.num_kv_heads, 1)
    h = first + torch.arange(n, device=device)
    return torch.clamp(h // true_group, 0, cfg.num_kv_heads - 1)


def _gather_kv_for_local_q(k: torch.Tensor, v: torch.Tensor,
                           cfg: AttnConfig, hq_local: int,
                           ctx: ParallelCtx = SINGLE):
    """The tensor-parallel rank's GQA map: its local q head ``j`` is global
    head ``model_index * hq_local + j`` and reads that head's kv head;
    returns kv per local q head."""
    idx = _kv_index(cfg, ctx.model_index() * hq_local, hq_local, k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


def _needs_psum(p: dict, cfg: AttnConfig) -> bool:
    """Row-parallel ``wo``: a psum completes it when the merged-head
    dimension is a local shard."""
    return p["wo"]["w"].shape[0] < padded_heads(cfg.num_heads) * cfg.head_dim


def _kernel_heads(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  cfg: AttnConfig, ctx: ParallelCtx):
    """What this rank hands ``flash_attention``: its real query heads (the
    global heads below ``num_heads``, from ``model_index * hq_local`` on)
    and the kv heads they read.  Where their map is the kernel's uniform
    ``h // group`` over a run of kv heads, that run is sliced; otherwise kv
    are expanded to one head per query head.  ``None`` when the rank holds
    only padded heads."""
    hq = q.shape[1]
    first = ctx.model_index() * hq
    n_real = max(0, min(cfg.num_heads - first, hq))
    if n_real == 0:
        return None
    with host_values():              # the map's values, on the host
        idx = _kv_index(cfg, first, n_real, "cpu")
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        group = n_real // (hi - lo)
        uniform = group * (hi - lo) == n_real and torch.equal(
            idx, lo + torch.arange(n_real) // group)
    if uniform:
        return q[:, :n_real], k[:, lo:hi], v[:, lo:hi]
    idx = idx.to(k.device)
    return q[:, :n_real], k.index_select(1, idx), v.index_select(1, idx)


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
               ctx: ParallelCtx = SINGLE,
               positions: torch.Tensor | None = None,
               compute_dtype: torch.dtype = torch.bfloat16,
               causal: bool = True, causal_skip: bool = False,
               cross_kv: torch.Tensor | None = None,
               block_q: int = 2048, block_k: int = 2048,
               attn_impl: str = "blockwise") -> torch.Tensor:
    """Self (or cross) attention over a full sequence (train / prefill).
    With ``cross_kv`` (B, Sk, d) k and v are its projections, no RoPE is
    applied and the attention is non-causal (the encoder-decoder's
    cross-attention).  The weights
    may be this rank's tensor-parallel shards (``wq`` by heads, ``wo`` by
    rows, ``wk``/``wv`` replicated, their gradients summed over the model
    axis); ``ctx.psum`` completes the row-parallel output.

    ``attn_impl="kernel"`` (the prefill; no gradient) runs
    :func:`flash_attention` on this rank's real query heads and the kv
    heads they read (:func:`_kernel_heads`), and gives the padded heads
    zeros (their rows of ``wo`` are zero, so the output is the same); a
    rank that holds only padded heads launches nothing.  Cross-attention
    (Sq != Sk, which the kernel does not take) runs the blockwise loop
    under either ``attn_impl``: a route fixed by the call.
    """
    if attn_impl not in ATTN_IMPLS:
        raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got "
                         f"{attn_impl!r}")
    b, s, _ = x.shape
    hq = p["wq"]["w"].shape[1] // cfg.head_dim
    hkv = p["wk"]["w"].shape[1] // cfg.head_dim
    q = _split_heads(dense(p["wq"], x, compute_dtype), hq)
    wk, wv = p["wk"], p["wv"]
    if hq < padded_heads(cfg.num_heads):
        # TP-sharded q, replicated kv: each rank's use of them differs
        wk = sum_grads_over_model(wk, ctx)
        wv = sum_grads_over_model(wv, ctx)
    kv_src = cross_kv if cross_kv is not None else x
    k = _split_heads(dense(wk, kv_src, compute_dtype), hkv)
    v = _split_heads(dense(wv, kv_src, compute_dtype), hkv)
    if cross_kv is None:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device))
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    else:
        causal = False
    window = None if is_global else cfg.window
    chunk = None if is_global else cfg.chunk
    if attn_impl == "kernel" and cross_kv is None:
        heads = _kernel_heads(q, k, v, cfg, ctx)
        if heads is None:
            o = q.new_zeros(q.shape)
        else:
            o = flash_attention(*heads, causal=causal, window=window,
                                chunk=chunk)
            if o.shape[1] < hq:
                o = torch.cat([o, o.new_zeros((b, hq - o.shape[1]) +
                                              o.shape[2:])], dim=1)
    else:
        if hq != hkv:
            k, v = _gather_kv_for_local_q(k, v, cfg, hq, ctx)
        o = blockwise_attention(q, k, v, causal=causal, window=window,
                                chunk=chunk, block_q=block_q, block_k=block_k,
                                causal_skip=causal_skip)
    y = dense(p["wo"], _merge_heads(o), compute_dtype)
    return ctx.psum(y) if _needs_psum(p, cfg) else y


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
                is_global: bool, pos: int, ctx: ParallelCtx = SINGLE,
                compute_dtype: torch.dtype = torch.bfloat16,
                cache_len_global: int | None = None) -> tuple:
    """One-token decode against a contiguous rolling cache
    ``{"k", "v"}: (B,Hkv,C_local,D)``, written in place at slot ``pos mod
    C`` (the reference donates the cache and returns the updated one; the
    port updates the same tensors and returns them).

    When ``C_local < cache_len_global`` the cache is *sequence-sharded*
    over the model axis: rank ``r`` holds slots ``[r*C_local,
    (r+1)*C_local)``; only the owner of slot ``pos mod C`` writes it, each
    rank scores its slots, and the softmax combines with a ``pmax`` of the
    partial maxima and a ``psum`` each of the numerator and denominator.
    The partial statistics are taken for every query head: under
    tensor-parallel ``wq`` the ranks' heads are first gathered over the
    model axis, and each rank keeps its own heads of the combined output.
    (The reference combines the ranks' *local* heads index by index, which
    pairs global head ``j`` with head ``hq_local + j``; the two agree where
    every rank past the first holds only padded heads, whose ``wo`` rows
    are zero.)"""
    hq = p["wq"]["w"].shape[1] // cfg.head_dim
    hkv = p["wk"]["w"].shape[1] // cfg.head_dim
    q = _split_heads(dense(p["wq"], x1, compute_dtype), hq)       # (B,Hq,1,D)
    k1 = _split_heads(dense(p["wk"], x1, compute_dtype), hkv)
    v1 = _split_heads(dense(p["wv"], x1, compute_dtype), hkv)
    pos1 = torch.full((1,), pos, device=x1.device)
    q = apply_rope(q, pos1, cfg.rope_theta)
    k1 = apply_rope(k1, pos1, cfg.rope_theta)
    c_local = cache["k"].shape[2]
    c_total = cache_len_global or c_local
    window = None if is_global else cfg.window
    chunk = None if is_global else cfg.chunk
    if c_local == c_total:
        slot = pos % c_local
        cache["k"][:, :, slot] = k1[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, slot] = v1[:, :, 0].to(cache["v"].dtype)
        kc, vc = cache["k"], cache["v"]
        if hq != hkv:
            kc, vc = _gather_kv_for_local_q(kc, vc, cfg, hq, ctx)
        o = decode_attention(q, kc, vc, pos, window=window, chunk=chunk,
                             rolling=True)
    else:
        o = _seq_sharded_decode(q, k1, v1, cache, cfg, pos, c_total, ctx,
                                window=window, chunk=chunk)
    y = dense(p["wo"], _merge_heads(o), compute_dtype)
    return (ctx.psum(y) if _needs_psum(p, cfg) else y), cache


def _seq_sharded_decode(q, k1, v1, cache: dict, cfg: AttnConfig, pos: int,
                        c_total: int, ctx: ParallelCtx, *,
                        window: int | None, chunk: int | None):
    """The sequence-sharded branch of :func:`attn_decode`."""
    r, c_local = ctx.model_index(), cache["k"].shape[2]
    if c_local * ctx.model_size() != c_total:
        raise ValueError(f"a cache of {c_local} slots a rank over "
                         f"{ctx.model_size()} ranks is not one of "
                         f"{c_total}")
    ls = pos % c_total - r * c_local
    if 0 <= ls < c_local:                     # the owner writes the slot
        cache["k"][:, :, ls] = k1[:, :, 0].to(cache["k"].dtype)
        cache["v"][:, :, ls] = v1[:, :, 0].to(cache["v"].dtype)
    hq = q.shape[1]
    sharded_q = hq < padded_heads(cfg.num_heads)
    if sharded_q:                             # every rank scores all heads
        q = ctx.gather_replicated(q.transpose(0, 1)).transpose(0, 1)
    idx = _kv_index(cfg, 0, q.shape[1], q.device)
    kc = cache["k"].index_select(1, idx)
    vc = cache["v"].index_select(1, idx)
    dev = q.device
    slot_g = r * c_local + torch.arange(c_local, device=dev)
    k_pos = pos - torch.remainder(pos - slot_g, c_total)
    valid = (k_pos <= pos) & (k_pos >= 0)
    if window is not None:
        valid &= k_pos > pos - window
    if chunk is not None:
        valid &= (k_pos // chunk) == (pos // chunk)
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(cfg.head_dim),
                     kc.float())
    s = torch.where(valid, s, NEG_INF)
    m = ctx.pmax(s.amax(dim=-1, keepdim=True))
    e = torch.exp(s - m)
    num = ctx.psum(torch.einsum("bhqk,bhkd->bhqd", e, vc.float()))
    den = ctx.psum(e.sum(dim=-1, keepdim=True))
    o = (num / torch.clamp(den, min=1e-30)).to(q.dtype)
    if sharded_q:
        o = o[:, r * hq:(r + 1) * hq]
    return o


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
