"""Mamba-1 selective SSM block (falcon-mamba's blocks, hymba's SSM heads).

Port of ``repro.models.ssm``: the same parameter tree (``in_proj_x``,
``in_proj_z``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj``, ``a_log``,
``d_skip``, ``out_proj``), the full-sequence selective scan and the
one-token decode against an O(1) state (``h`` (B, Din, N) and the conv's
last ``W - 1`` inputs (B, W-1, Din), both fp32).

The reference computes the scan over time with
``jax.lax.associative_scan``; :func:`selective_scan` is the same odd/even
recursion (adjacent pairs combined with stride-2 slices, the half-length
scan recursed on, the odd results combined with the even inputs), so it
forms the same products in the same order, and fp32 results agree with
the reference's within rounding.  A per-timestep loop would be another
function numerically, and S launches a layer on the card.  The scan stays
in plain PyTorch, as the reference's is plain ``jnp``.

Under tensor parallelism ``d_inner`` is split over the model axis
(``in_proj`` column-parallel, ``x_proj`` and ``out_proj`` row-parallel, the
conv and the scan elementwise in ``d_inner``); a block whose ``conv_w``
holds fewer than ``expand * d_model`` channels is such a shard, and the
context's collectives complete it.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import SSMConfig
from repro_torch.models.common import dense, dense_init, trunc_normal
from repro_torch.models.parallel import SINGLE, ParallelCtx


def ssm_dims(cfg: SSMConfig, d_model: int) -> tuple[int, int]:
    d_inner = cfg.expand * d_model
    dt_rank = cfg.dt_rank or int(math.ceil(d_model / 16))
    return d_inner, dt_rank


def ssm_init(generator, cfg: SSMConfig, d_model: int, *,
             dtype: torch.dtype = torch.float32, device=None) -> dict:
    """The reference's tree and initialisation (S4D-real ``A``)."""
    d_inner, dt_rank = ssm_dims(cfg, d_model)
    n = cfg.state_dim
    kw = dict(dtype=dtype, device=device)
    a = torch.arange(1, n + 1, dtype=torch.float32,
                     device=device)[None, :].repeat(d_inner, 1)
    return {
        "in_proj_x": dense_init(generator, d_model, d_inner, **kw),
        "in_proj_z": dense_init(generator, d_model, d_inner, **kw),
        "conv_w": trunc_normal(generator, (cfg.conv_width, d_inner),
                               1.0 / math.sqrt(cfg.conv_width), dtype, device),
        "conv_b": torch.zeros((d_inner,), **kw),
        "x_proj": dense_init(generator, d_inner, dt_rank + 2 * n, **kw),
        "dt_proj": dense_init(generator, dt_rank, d_inner, bias=True, **kw),
        "a_log": torch.log(a).to(dtype),
        "d_skip": torch.ones((d_inner,), **kw),
        "out_proj": dense_init(generator, d_inner, d_model, **kw),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 tail: torch.Tensor | None = None) -> torch.Tensor:
    """Depthwise causal conv over time, the taps summed in order ``t = 0 ..
    W-1``.  x: (B, S, D); w: (W, D); tail: (B, W-1, D), the inputs before
    ``x`` (zeros when None)."""
    width = w.shape[0]
    pad = tail if tail is not None else x.new_zeros(
        (x.shape[0], width - 1, x.shape[2]))
    xp = torch.cat([pad, x], dim=1)                       # (B, S+W-1, D)
    s = x.shape[1]
    out = torch.zeros_like(x)
    for t in range(width):
        out = out + xp[:, t:t + s] * w[t][None, None, :]
    return out + b[None, None, :]


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``, ``logaddexp(x, 0)`` (``F.softplus`` returns
    ``x`` itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _ssm_params(p: dict, xc: torch.Tensor, cfg: SSMConfig, dt_rank: int,
                compute_dtype: torch.dtype, ctx: ParallelCtx, sharded: bool):
    """Input-dependent ``(delta, A, B, C)`` from the conv'd activation
    (B, S, Din).  ``x_proj`` is row-parallel under tensor parallelism: a
    psum completes the contraction, and since its result feeds the
    rank-sharded scan the cotangent is summed again (``fan_out``)."""
    n = cfg.state_dim
    proj = dense(p["x_proj"], xc, compute_dtype)
    if sharded:
        proj = ctx.fan_out(ctx.psum(proj))
    dt_raw = proj[..., :dt_rank]
    b_ssm = proj[..., dt_rank:dt_rank + n]
    c_ssm = proj[..., dt_rank + n:]
    delta = _softplus(dense(p["dt_proj"], dt_raw, compute_dtype).float())
    a = -torch.exp(p["a_log"].float())                    # (Din, N)
    return delta, a, b_ssm.float(), c_ssm.float()


def selective_scan(abar: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """The states ``h_t = abar_t * h_{t-1} + bx_t`` (``h_{-1} = 0``) along
    dimension 1, by ``jax.lax.associative_scan``'s recursion over the
    combine ``(a1, b1), (a2, b2) -> (a1 * a2, a2 * b1 + b2)``.

    Only the ``b`` half of the scan is returned, and the ``a`` half of a
    level's results is never read by the ``b`` half of its parent (which
    reads the level's inputs' ``a``), so it is not formed: every ``b`` is
    the reference's product for product."""
    n = abar.shape[1]
    if n < 2:
        return bx
    a_even, a_odd = abar[:, 0:n - 1:2], abar[:, 1::2]
    b_even, b_odd = bx[:, 0:n - 1:2], bx[:, 1::2]
    # adjacent pairs combined, then the half-length scan
    odd = selective_scan(a_even * a_odd, a_odd * b_even + b_odd)
    # the odd results meet the even inputs from element 2 on (the last odd
    # result has no even input after it when n is even)
    odd_in = odd[:, :-1] if n % 2 == 0 else odd
    even = abar[:, 2::2] * odd_in + bx[:, 2::2]
    out = torch.empty_like(bx)
    out[:, 0] = bx[:, 0]
    out[:, 2::2] = even
    out[:, 1::2] = odd
    return out


def _is_sharded(p: dict, cfg: SSMConfig, d_model: int) -> bool:
    return p["conv_w"].shape[1] < cfg.expand * d_model


def ssm_apply(p: dict, x: torch.Tensor, cfg: SSMConfig, *,
              ctx: ParallelCtx = SINGLE,
              compute_dtype: torch.dtype = torch.bfloat16,
              d_model: int | None = None) -> torch.Tensor:
    """Full-sequence selective scan. x: (B, S, d_model).  The weights may
    be this rank's shards of ``d_inner``; the row-parallel output is then
    psum'd."""
    dt_rank = p["dt_proj"]["w"].shape[0]
    sharded = _is_sharded(p, cfg, d_model or x.shape[-1])
    xpart = dense(p["in_proj_x"], x, compute_dtype)        # (B, S, Din_local)
    z = dense(p["in_proj_z"], x, compute_dtype)
    xc = F.silu(_causal_conv(xpart, p["conv_w"].to(compute_dtype),
                             p["conv_b"].to(compute_dtype)))
    delta, a, b_ssm, c_ssm = _ssm_params(p, xc, cfg, dt_rank, compute_dtype,
                                         ctx, sharded)
    # discretise: abar = exp(delta * A), bbar * x = delta * B * x, each
    # (B, S, Din, N)
    xf = xc.float()
    abar = torch.exp(delta[..., None] * a[None, None])
    bx = (delta * xf)[..., None] * b_ssm[:, :, None, :]
    hs = selective_scan(abar, bx)
    del abar, bx
    y = torch.einsum("bsdn,bsn->bsd", hs, c_ssm)           # (B, S, Din)
    del hs
    y = y + xf * p["d_skip"].float()[None, None, :]
    y = y * F.silu(z.float())
    out = dense(p["out_proj"], y.to(compute_dtype), compute_dtype)
    return ctx.psum(out) if sharded else out


def ssm_decode(p: dict, x1: torch.Tensor, cfg: SSMConfig, state: dict, *,
               ctx: ParallelCtx = SINGLE,
               compute_dtype: torch.dtype = torch.bfloat16,
               d_model: int | None = None) -> tuple[torch.Tensor, dict]:
    """One-token step. x1: (B, 1, d_model); state: ``{"h": (B, Din, N),
    "conv": (B, W-1, Din)}``; returns the output and the new state."""
    dt_rank = p["dt_proj"]["w"].shape[0]
    sharded = _is_sharded(p, cfg, d_model or x1.shape[-1])
    xpart = dense(p["in_proj_x"], x1, compute_dtype)       # (B, 1, Din_local)
    z = dense(p["in_proj_z"], x1, compute_dtype)
    xc = F.silu(_causal_conv(xpart, p["conv_w"].to(compute_dtype),
                             p["conv_b"].to(compute_dtype),
                             tail=state["conv"].to(compute_dtype)))
    new_conv = torch.cat([state["conv"][:, 1:],
                          xpart.to(state["conv"].dtype)], dim=1)
    delta, a, b_ssm, c_ssm = _ssm_params(p, xc, cfg, dt_rank, compute_dtype,
                                         ctx, sharded)
    xf = xc.float()
    abar = torch.exp(delta[:, 0, :, None] * a[None])       # (B, Din, N)
    bx = (delta * xf)[:, 0, :, None] * b_ssm[:, 0, None, :]
    h = state["h"].float() * abar + bx
    y = torch.einsum("bdn,bn->bd", h, c_ssm[:, 0])[:, None, :]
    y = y + xf * p["d_skip"].float()[None, None, :]
    y = y * F.silu(z.float())
    out = dense(p["out_proj"], y.to(compute_dtype), compute_dtype)
    if sharded:
        out = ctx.psum(out)
    return out, {"h": h.to(state["h"].dtype), "conv": new_conv}


def init_ssm_state(cfg: SSMConfig, d_model: int, batch: int,
                   dtype: torch.dtype = torch.float32, device=None) -> dict:
    d_inner, _ = ssm_dims(cfg, d_model)
    return {"h": torch.zeros((batch, d_inner, cfg.state_dim), dtype=dtype,
                             device=device),
            "conv": torch.zeros((batch, cfg.conv_width - 1, d_inner),
                                dtype=dtype, device=device)}
