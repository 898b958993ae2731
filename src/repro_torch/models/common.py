"""Shared building blocks: inits, norms, linears, RoPE, activations, loss.

Port of ``repro.models.common``.  Parameters are plain nested dicts of
tensors with the reference's keys, so a tree converted by
:mod:`repro_torch.bridge` runs here unchanged.  Inits draw from an explicit
``torch.Generator`` that lives on the device the tensors are made on; they
cannot replay ``jax.random``, so the tests start from bridged parameters.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_SQRT2 = math.sqrt(2.0)


def trunc_normal(generator: torch.Generator | None, shape, std: float,
                 dtype: torch.dtype = torch.float32,
                 device: str | torch.device | None = None) -> torch.Tensor:
    """A *standard* normal truncated to [-2, 2], cast, then scaled by
    ``std`` — the reference's order, so the bounds are ±2·std (not the
    absolute bounds of ``torch.nn.init.trunc_normal_``).  Sampled by
    inverting the normal CDF on a uniform draw."""
    hi = math.erf(2.0 / _SQRT2)
    u = torch.empty(shape, dtype=torch.float32, device=device)
    u.uniform_(-hi, hi, generator=generator)
    x = u.erfinv_().mul_(_SQRT2).clamp_(-2.0, 2.0)
    return x.to(dtype) * std


def dense_init(generator, d_in: int, d_out: int, *,
               dtype: torch.dtype = torch.float32, bias: bool = False,
               std: float | None = None, device=None) -> dict:
    std = std if std is not None else 1.0 / math.sqrt(d_in)
    p = {"w": trunc_normal(generator, (d_in, d_out), std, dtype, device)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def dense(p: dict, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w (+ b)`` in ``compute_dtype``; the cast is free when the
    weights already hold that type (see the engine's compute copy)."""
    y = x.to(compute_dtype) @ p["w"].to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def rmsnorm_init(d: int, dtype: torch.dtype = torch.float32,
                 device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    dt = x.dtype
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"].float()).to(dt)


def activation(name: str):
    # jax.nn.gelu defaults to the tanh approximation
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": F.relu}[name]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, H, S, D); positions: (B, S) or (S,)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)            # (D/2,)
    if positions.ndim == 1:
        positions = positions[None, :]
    ang = positions[:, None, :, None].float() * freqs       # (B,1,S,D/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    rx1 = x1 * cos - x2 * sin
    rx2 = x2 * cos + x1 * sin
    return torch.cat([rx1, rx2], dim=-1).to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def glu_mlp_init(generator, d: int, f: int, *,
                 dtype: torch.dtype = torch.float32, device=None) -> dict:
    return {"w_gate": dense_init(generator, d, f, dtype=dtype, device=device),
            "w_up": dense_init(generator, d, f, dtype=dtype, device=device),
            "w_down": dense_init(generator, f, d, dtype=dtype, device=device)}


def glu_mlp(p: dict, x: torch.Tensor, act: str,
            compute_dtype: torch.dtype, ctx=None,
            global_ff: int | None = None) -> torch.Tensor:
    """Column-parallel gate/up, row-parallel down: ``ctx.psum`` completes
    the output when the ff dimension of ``w_down`` is a local shard of
    ``global_ff``."""
    g = dense(p["w_gate"], x, compute_dtype)
    u = dense(p["w_up"], x, compute_dtype)
    y = dense(p["w_down"], activation(act)(g) * u, compute_dtype)
    if ctx is not None and global_ff is not None \
            and p["w_down"]["w"].shape[0] < global_ff:
        y = ctx.psum(y)
    return y


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_init(generator, vocab: int, d: int, *,
               dtype: torch.dtype = torch.float32, device=None) -> dict:
    # 0.02 (GPT-2/llama-style): keeps tied-unembedding logits O(1) at init
    return {"table": trunc_normal(generator, (vocab, d), 0.02, dtype, device)}


def embed(p: dict, tokens: torch.Tensor, compute_dtype: torch.dtype,
          ctx=None, global_vocab: int | None = None) -> torch.Tensor:
    """Row lookup.  A table that is this rank's vocab shard (fewer rows
    than ``global_vocab``) is vocab-parallel: the rows of other shards read
    zeros and ``ctx.psum`` adds the ranks' lookups."""
    table = p["table"].to(compute_dtype)
    v_local = table.shape[0]
    if global_vocab is None or v_local == global_vocab:
        return table[tokens]
    idx = tokens - ctx.model_index() * v_local
    valid = (idx >= 0) & (idx < v_local)
    out = table[idx.clamp(0, v_local - 1)]
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    return ctx.psum(out)


def unembed(p: dict, x: torch.Tensor,
            compute_dtype: torch.dtype) -> torch.Tensor:
    """Tied unembedding: logits over the table's rows (this rank's vocab
    shard under tensor parallelism)."""
    return x.to(compute_dtype) @ p["table"].to(compute_dtype).T


# ---------------------------------------------------------------------------
# loss
# ---------------------------------------------------------------------------


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None, ctx=None,
                 global_vocab: int | None = None) -> torch.Tensor:
    """Token-mean cross entropy in fp32.  ``logits`` may be this rank's
    vocab shard (B, S, V_local): with ``ctx`` and ``global_vocab`` the
    reduction is vocab-parallel (a shared max, detached as the reference's
    ``stop_gradient``, then a psum of the exp-sum and one of the gold
    logit)."""
    lf = logits.float()
    labels = labels.long()
    v_local = lf.shape[-1]
    if ctx is None or global_vocab is None or v_local == global_vocab:
        logz = torch.logsumexp(lf, dim=-1)
        gold = torch.take_along_dim(lf, labels[..., None], dim=-1)[..., 0]
    else:
        m = ctx.pmax(lf.detach().amax(dim=-1))
        se = ctx.psum(torch.exp(lf - m[..., None]).sum(dim=-1))
        logz = torch.log(se) + m
        idx = labels - ctx.model_index() * v_local
        valid = (idx >= 0) & (idx < v_local)
        g = torch.take_along_dim(lf, idx.clamp(0, v_local - 1)[..., None],
                                 dim=-1)[..., 0]
        gold = ctx.psum(torch.where(valid, g, torch.zeros((), device=g.device)))
    nll = logz - gold
    if mask is None:
        return nll.mean()
    m = mask.float()
    return (nll * m).sum() / torch.clamp(m.sum(), min=1.0)
