"""AdamW over parameter trees and over flat bucket shards.

Port of ``repro.optim.adamw``:

* :func:`adamw_tree_update` — the replicated update over parameter trees;
* :func:`adamw_flat_update` — the ZeRO-1 update over the fp32 shards a
  reduce-scatter hands each rank; it returns the parameter *delta*
  (``-lr * adam``), which the caller all-gathers and applies with the
  decoupled weight decay on the full parameters.

Parameters may be of any float dtype; moments and the update are fp32.
Both updates allocate new tensors, like the reference's functional ones.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch import tree as tree_util


@dataclass(frozen=True)
class OptimConfig:
    base_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    schedule: str = "cosine"          # constant | linear | cosine | wsd
    warmup: int = 100
    total_steps: int = 1000


def init_opt_state(params) -> dict:
    zeros = lambda t: tree_util.tree_map(           # noqa: E731
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        t)
    return {"mu": zeros(params), "nu": zeros(params)}


def init_opt_state_flat(shards) -> dict:
    """Zero fp32 moments shaped like each flat shard."""
    return {"mu": [torch.zeros_like(s, dtype=torch.float32) for s in shards],
            "nu": [torch.zeros_like(s, dtype=torch.float32) for s in shards]}


def global_grad_norm(grads, specs=None, ctx=None) -> torch.Tensor:
    """Global L2 norm of a gradient tree (fp32) with model-axis-aware
    accounting: on a model axis above 1 (``ctx``), the sums of squares of
    leaves whose spec (``specs``, the congruent spec tree; see
    :mod:`repro_torch.sharding.rules`) splits over the model axis are
    summed over it (``ctx.psum``), replicated leaves are counted once.  On
    one model rank every leaf is summed in tree order (the same norm; the
    reference keeps the sharded and replicated sums apart there too, which
    moves the last bit)."""
    leaves = tree_util.leaves(grads)
    if specs is None or ctx is None or ctx.model_size() == 1:
        return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                              for g in leaves))
    from repro_torch.sharding.rules import is_model_sharded, spec_leaves

    flags = [is_model_sharded(s) for s in spec_leaves(specs)]
    if len(flags) != len(leaves):
        raise ValueError("gradients and specs differ in structure")
    zero = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
    sharded = sum((torch.sum(torch.square(g.float()))
                   for g, f in zip(leaves, flags) if f), zero)
    local = sum((torch.sum(torch.square(g.float()))
                 for g, f in zip(leaves, flags) if not f), zero)
    return torch.sqrt(ctx.psum(sharded) + local)


def clip_factor(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12), max=1.0)


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """IEEE fp32 square root.  The card's is correctly rounded; PyTorch's
    vectorised fp32 one on the CPU is not (up to 1 ulp off).  The CPU
    branch exists only so that the port is bitwise the reference on the
    CPU, where the tests hold it to it: CPU tensors take the root in
    float64 (one float64 copy of the tensor), whose rounding to fp32 is the
    correctly rounded result.  CUDA tensors take ``torch.sqrt`` as they
    are."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)


def _adamw_moments(g, mu, nu, step: int, cfg: OptimConfig):
    g = g.float()
    mu = cfg.b1 * mu + (1 - cfg.b1) * g
    nu = cfg.b2 * nu + (1 - cfg.b2) * g * g
    # the bias corrections in fp32, as the reference computes them
    t = torch.tensor(float(step) + 1.0, dtype=torch.float32)
    mu_hat = mu / (1 - cfg.b1 ** t)
    nu_hat = nu / (1 - cfg.b2 ** t)
    return mu_hat / (_sqrt(nu_hat) + cfg.eps), mu, nu


@torch.no_grad()
def adamw_tree_update(params, grads, opt_state: dict, step: int, lr: float,
                      cfg: OptimConfig):
    """``params' = (1 - lr*wd) * params - lr * adam(grads)``; returns
    ``(new_params, new_opt_state)``."""
    lp, treedef = tree_util.flatten(params)
    lg = tree_util.leaves(grads)
    lmu = tree_util.leaves(opt_state["mu"])
    lnu = tree_util.leaves(opt_state["nu"])
    if not len(lp) == len(lg) == len(lmu) == len(lnu):
        raise ValueError("params, grads and optimizer state differ in "
                         "structure")
    new_p, new_mu, new_nu = [], [], []
    for p, g, mu, nu in zip(lp, lg, lmu, lnu):
        upd, mu2, nu2 = _adamw_moments(g, mu, nu, step, cfg)
        p2 = p.float() * (1 - lr * cfg.weight_decay) - lr * upd
        new_p.append(p2.to(p.dtype))
        new_mu.append(mu2)
        new_nu.append(nu2)
    unf = treedef.unflatten
    return unf(new_p), {"mu": unf(new_mu), "nu": unf(new_nu)}


@torch.no_grad()
def adamw_flat_update(grad_shards, opt_state: dict, step: int, lr: float,
                      cfg: OptimConfig):
    """ZeRO update on flat shards; returns ``(deltas, new_opt_state)`` with
    ``delta = -lr * adam(grad)`` (weight decay is applied to the parameters
    outside)."""
    if not len(grad_shards) == len(opt_state["mu"]) == len(opt_state["nu"]):
        raise ValueError("gradient shards and optimizer state differ in "
                         "length")
    deltas, mus, nus = [], [], []
    for g, mu, nu in zip(grad_shards, opt_state["mu"], opt_state["nu"]):
        upd, mu2, nu2 = _adamw_moments(g, mu, nu, step, cfg)
        deltas.append(-lr * upd)
        mus.append(mu2)
        nus.append(nu2)
    return deltas, {"mu": mus, "nu": nus}
