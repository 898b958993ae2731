"""Token-choice MoE with sort-based capacity dispatch.

Port of ``repro.models.moe``.  Per batch row: route the tokens to ``top_k``
experts, sort the (token, expert) pairs by expert (a stable
``torch.argsort``, group starts by ``torch.searchsorted``), scatter them
into an ``(E*C + 1, d)`` capacity buffer whose last row takes the pairs
past an expert's capacity, run every expert as one batched GLU
(``torch.bmm`` over the expert dimension), and gather back with the gate
weights.  Dropped pairs contribute nothing and are reported by
:func:`dropped_fraction`; a shared expert (llama4) adds a dense always-on
path.  The reference computes all of this in plain ``jnp``, outside any
Pallas kernel, so the port has no kernel here either.

Routes of :func:`moe_apply` (the weights' local shapes decide):

* **EP all-to-all** — the expert dimension is sharded over the model axis
  and the batch divides it: each rank builds the capacity buffer of its
  batch shard, ``ctx.all_to_all`` makes it expert-sharded (dispatch), the
  local experts compute, the inverse exchange brings the outputs home
  (combine) and ``ctx.gather_replicated`` replicates the result;
* **replicated-psum fallback** — EP weights, a batch the axis does not
  divide: the replicated buffer, this rank's experts sliced out, zero-padded
  back, combined and summed over the model axis;
* **TP in the expert** (``parallelism="tp"``) — every rank runs every
  expert on its ffn shard; ``ctx.psum`` after ``w_down``;
* **shared expert** — a GLU MLP on every token (column/row parallel under
  TP).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig
from repro_torch.models.common import (activation, dense_init, glu_mlp,
                                       glu_mlp_init, trunc_normal)


def moe_init(generator, cfg: MoEConfig, d_model: int, *,
             dtype: torch.dtype = torch.float32, device=None) -> dict:
    e, f = cfg.num_experts, cfg.expert_ff
    std = 1.0 / math.sqrt(d_model)
    p = {
        "router": dense_init(generator, d_model, e, dtype=dtype,
                             device=device),
        "w_gate": trunc_normal(generator, (e, d_model, f), std, dtype, device),
        "w_up": trunc_normal(generator, (e, d_model, f), std, dtype, device),
        "w_down": trunc_normal(generator, (e, f, d_model), 1.0 / math.sqrt(f),
                               dtype, device),
    }
    if cfg.shared_expert_ff:
        p["shared"] = glu_mlp_init(generator, d_model, cfg.shared_expert_ff,
                                   dtype=dtype, device=device)
    return p


def capacity(tokens_per_row: int, cfg: MoEConfig) -> int:
    """Slots per expert and batch row: ``ceil(S * k * cf / E)`` rounded up
    to a multiple of 8, at least 8 (the reference's sublane alignment)."""
    c = int(math.ceil(tokens_per_row * cfg.top_k * cfg.capacity_factor
                      / cfg.num_experts))
    return max(8, int(math.ceil(c / 8) * 8))


def load_balance_aux(gates_all: torch.Tensor, expert_ids: torch.Tensor,
                     num_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style load-balancing loss, normalised so that perfect balance
    is exactly 1.0 for every ``top_k``: ``me[e]`` is the mean router
    probability of expert ``e``, ``pe[e]`` the mean number of top-k slots
    it takes divided by ``top_k`` (so ``sum(pe) == 1`` for any k)."""
    e = num_experts
    me = torch.mean(gates_all, dim=(0, 1))                         # (E,)
    pe = torch.mean(F.one_hot(expert_ids, e).sum(dim=2).float(),
                    dim=(0, 1)) / top_k                            # (E,)
    return e * torch.sum(me * pe)


def dropped_fraction(expert_ids: torch.Tensor, num_experts: int,
                     cap: int) -> torch.Tensor:
    """Fraction of (token, expert) assignments past capacity, the pairs
    :func:`moe_apply` drops; from the routing decision alone, so it is the
    same on every rank."""
    b = expert_ids.shape[0]
    flat_ids = expert_ids.reshape(b, -1)                           # (B, S*k)
    t = flat_ids.shape[1]
    counts = F.one_hot(flat_ids, num_experts).float().sum(dim=1)   # (B, E)
    over = torch.clamp(counts - cap, min=0.0)
    return torch.sum(over) / (b * t)


def _dispatch(ids: torch.Tensor, x: torch.Tensor, e: int, cap: int, k: int
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The capacity buffers of a batch of rows: ``ids`` (b, T) expert ids,
    ``x`` (b, S, d) -> ``(buf (b, E, C, d), order (b, T), dest (b, T))``.
    Pair ``order[:, t]`` (token ``order // k``) lands in row ``dest`` of
    the flat ``(E*C + 1)``-row buffer; ``dest == E*C`` marks a drop."""
    b, t = ids.shape
    d = x.shape[-1]
    order = torch.argsort(ids, dim=1, stable=True)                 # (b, T)
    sorted_ids = torch.gather(ids, 1, order)
    arange_e = torch.arange(e, device=ids.device, dtype=ids.dtype)
    starts = torch.searchsorted(sorted_ids.contiguous(),
                                arange_e.expand(b, e).contiguous())
    pos = (torch.arange(t, device=ids.device)[None, :]
           - torch.gather(starts, 1, sorted_ids))
    dest = torch.where(pos < cap, sorted_ids * cap + pos,
                       torch.full_like(pos, e * cap))
    rows = torch.arange(b, device=ids.device)[:, None]
    vals = x[rows, order // k]                                     # (b, T, d)
    buf = x.new_zeros((b, e * cap + 1, d)).index_put((rows.expand(b, t),
                                                      dest), vals)
    return buf[:, :-1].reshape(b, e, cap, d), order, dest


def _combine(obuf: torch.Tensor, order: torch.Tensor, dest: torch.Tensor,
             gate: torch.Tensor, s: int, k: int) -> torch.Tensor:
    """The expert outputs ``obuf`` (b, E, C, d) gathered back to tokens,
    weighted by their gates (``gate`` (b, T), in pair order): (b, S, d).
    A token's row sums its ``top_k`` weighted outputs into zeros; with
    ``top_k <= 2`` that is ``0 + a + b``, whose rounding does not depend on
    the order of the adds (IEEE addition commutes and ``0 + a == a``), so
    the scatter's order, atomics included, cannot change a bit."""
    b, e, cap, d = obuf.shape
    t = order.shape[1]
    flat = obuf.reshape(b, e * cap, d)
    rows = torch.arange(b, device=obuf.device)[:, None]
    keep = (dest < e * cap)[..., None].to(obuf.dtype)
    vals = flat[rows, torch.clamp(dest, max=e * cap - 1)] * keep   # (b, T, d)
    g = torch.gather(gate, 1, order)[..., None].to(vals.dtype)
    y = vals.new_zeros((b, s, d))
    return y.index_put((rows.expand(b, t), order // k), vals * g,
                       accumulate=True)


def _glu(buf: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor,
         wd: torch.Tensor, act: str) -> torch.Tensor:
    """Every local expert's GLU on its slots: ``buf`` (B, E_l, C, d) ->
    (B, E_l, C, d), one ``bmm`` over the experts per projection (each
    expert one (B*C, d) GEMM, whatever the expert count)."""
    b, el, cap, d = buf.shape
    xe = buf.permute(1, 0, 2, 3).reshape(el, b * cap, d)
    h = activation(act)(torch.bmm(xe, wg)) * torch.bmm(xe, wu)
    out = torch.bmm(h, wd)                                   # (E_l, B*C, d)
    return out.reshape(el, b, cap, d).permute(1, 0, 2, 3)


def moe_apply(p: dict, x: torch.Tensor, cfg: MoEConfig, act: str, *, ctx,
              compute_dtype: torch.dtype = torch.bfloat16
              ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x: (B, S, d) -> (y, aux_loss, drop_fraction).

    The activations are replicated over the model axis, so the routing is
    the same on every model rank; the route follows the local shapes of
    the expert stacks (module docstring)."""
    b, s, d = x.shape
    e, k = cfg.num_experts, cfg.top_k
    cap = capacity(s, cfg)
    xf = x.to(compute_dtype)
    e_local = p["w_gate"].shape[0]
    f_local = p["w_gate"].shape[2]
    ep_sharded = e_local < e
    tp_sharded = f_local < cfg.expert_ff

    logits = (xf @ p["router"]["w"].to(compute_dtype)).float()     # (B,S,E)
    gates_all = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = torch.topk(logits, k, dim=-1)          # (B,S,k)
    if k == 1:
        # llama4-style sigmoid gate: the renormalised softmax of one logit
        # is a constant 1 and would starve the router of gradient
        gate_w = torch.sigmoid(gate_vals)
    else:
        gate_w = torch.softmax(gate_vals, dim=-1)                  # renorm
    aux = load_balance_aux(gates_all, expert_ids, e, k)
    drop_frac = dropped_fraction(expert_ids, e, cap)

    flat_ids = expert_ids.reshape(b, s * k)
    flat_gate = gate_w.reshape(b, s * k)
    if ep_sharded or tp_sharded:
        # the dispatch input and the gates feed rank-partial compute (local
        # experts / ffn shards): their cotangents sum over the model axis
        xd = ctx.fan_out(xf)
        flat_gate = ctx.fan_out(flat_gate)
    else:
        xd = xf
    wg = p["w_gate"].to(compute_dtype)
    wu = p["w_up"].to(compute_dtype)
    wd = p["w_down"].to(compute_dtype)

    r = ctx.model_size() if ep_sharded else 1
    if ep_sharded and r > 1 and b % r == 0:
        # expert parallel through the all-to-all
        bs = b // r
        rows = slice(ctx.model_index() * bs, (ctx.model_index() + 1) * bs)
        buf_s, order_s, dest_s = _dispatch(flat_ids[rows], xd[rows], e, cap,
                                           k)
        # dispatch: (bs, E, C, d) batch-sharded -> (B, E_l, C, d)
        recv = ctx.all_to_all(buf_s, split_axis=1, concat_axis=0)
        out = _glu(recv, wg, wu, wd, act)
        # combine: the inverse exchange brings the outputs home
        back = ctx.all_to_all(out, split_axis=0, concat_axis=1)
        y_s = _combine(back, order_s, dest_s, flat_gate[rows], s, k)
        y = ctx.gather_replicated(y_s)                             # (B,S,d)
    else:
        buf, order, dest = _dispatch(flat_ids, xd, e, cap, k)
        if ep_sharded:
            # replicated-psum fallback: this rank's experts, zero-padded
            e0 = ctx.model_index() * e_local
            out_l = _glu(buf[:, e0:e0 + e_local], wg, wu, wd, act)
            out_buf = out_l.new_zeros((b, e, cap, d))
            out_buf[:, e0:e0 + e_local] = out_l
        else:
            out_buf = _glu(buf, wg, wu, wd, act)
        y = _combine(out_buf, order, dest, flat_gate, s, k)
        if ep_sharded or tp_sharded:
            y = ctx.psum(y)

    if "shared" in p:
        sharded = p["shared"]["w_down"]["w"].shape[0] < cfg.shared_expert_ff
        xs = ctx.fan_out(xf) if sharded else xf
        y = y + glu_mlp(p["shared"], xs, act, compute_dtype, ctx,
                        cfg.shared_expert_ff)
    return y.to(x.dtype), aux, drop_frac
