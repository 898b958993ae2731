"""repro_torch's MoE layer against the JAX reference on one rank.

* ``moe_apply`` at fp32 compute from bridged parameters, on a top-2 case,
  a top-1 case with a shared expert (sigmoid gate), a case whose capacity
  factor of 0.1 drops most pairs and a wide top-2 case with 8 experts:
  ``y`` and the load-balancing loss within rtol 1e-5 / atol 1e-6 (matmul
  sums in another order), the drop fraction equal (a count of integers),
  and the gradients of ``sum(y * w) + aux`` with respect to the router,
  the expert stacks, the shared expert and ``x`` within rtol 1e-4 / atol
  1e-5.
* A stack with ``interleave_step`` 2 (MoE on every second layer, dense
  MLPs between): the tree's structure equal to the reference's, its loss
  and gradients within the tolerances of ``test_torch_train.py``, the
  drop fraction equal.
* ``capacity()`` equal to the reference's over a grid, and the
  load-balancing loss exactly 1 under uniform routing for every top_k.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MoEConfig as JaxMoEConfig
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import moe as jax_moe
from repro.models.parallel import SINGLE as JAX_SINGLE
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import reduced_config
from repro_torch.configs.base import MoEConfig
from repro_torch.models import build_model, moe
from repro_torch.models.parallel import SINGLE

CASES = {   # name: (MoEConfig kwargs, B, S, d)
    "top2": (dict(num_experts=4, top_k=2, expert_ff=32,
                  capacity_factor=1.25), 2, 16, 16),
    "top1_shared": (dict(num_experts=4, top_k=1, expert_ff=32,
                         shared_expert_ff=24, capacity_factor=1.25),
                    2, 16, 16),
    "drops": (dict(num_experts=4, top_k=2, expert_ff=32,
                   capacity_factor=0.1), 3, 64, 16),
    "top2_e8": (dict(num_experts=8, top_k=2, expert_ff=48,
                     capacity_factor=2.0), 2, 24, 32),
}


def _reference(kw, b, s, d, seed):
    cfg = JaxMoEConfig(**kw)
    p = jax_moe.moe_init(jax.random.key(seed), cfg, d)
    rs = np.random.RandomState(seed)
    x = rs.randn(b, s, d).astype(np.float32)
    w = rs.randn(b, s, d).astype(np.float32)

    def loss(pp, xx):
        y, aux, drop = jax_moe.moe_apply(pp, xx, cfg, "silu", ctx=JAX_SINGLE,
                                         compute_dtype=jnp.float32)
        return jnp.sum(y * w) + aux, (y, aux, drop)

    (_, (y, aux, drop)), (gp, gx) = jax.jit(jax.value_and_grad(
        loss, argnums=(0, 1), has_aux=True))(p, jnp.asarray(x))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    return to_np(p), x, w, np.asarray(y), float(aux), float(drop), \
        to_np(gp), np.asarray(gx)


@pytest.mark.parametrize("name", sorted(CASES))
def test_moe_apply_matches_reference(name):
    kw, b, s, d = CASES[name]
    p_np, x_np, w_np, y_ref, aux_ref, drop_ref, gp_ref, gx_ref = _reference(
        kw, b, s, d, seed=sorted(CASES).index(name))
    cfg = MoEConfig(**kw)
    leaves, treedef = tree_util.flatten(bridge.params_from_numpy(p_np, "cpu"))
    leaves = [t.requires_grad_(True) for t in leaves]
    x = torch.from_numpy(x_np).requires_grad_(True)
    y, aux, drop = moe.moe_apply(treedef.unflatten(leaves), x, cfg, "silu",
                                 ctx=SINGLE, compute_dtype=torch.float32)
    np.testing.assert_allclose(y.detach().numpy(), y_ref, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(aux.item(), aux_ref, rtol=1e-5, atol=1e-6)
    assert drop.item() == drop_ref
    if name == "drops":
        assert drop_ref > 0.5                 # most pairs are dropped
    loss = torch.sum(y * torch.from_numpy(w_np)) + aux
    grads = torch.autograd.grad(loss, leaves + [x])
    ref_leaves = tree_util.leaves(gp_ref)
    assert len(ref_leaves) == len(leaves)
    for g, gr in zip(grads, ref_leaves + [gx_ref]):
        np.testing.assert_allclose(g.numpy(), gr, rtol=1e-4, atol=1e-5)


def test_interleaved_stack_matches_reference():
    """MoE on layers 1 and 3 of four, dense MLPs on 0 and 2 (llama4's
    ``interleave_step`` 2 with its shared expert and top-1 gate)."""
    arch = "llama4-maverick-400b-a17b"
    jcfg = jax_reduced_config(arch).with_(num_layers=4)
    jmodel = jax_build_model(jcfg)
    jparams = jmodel.init(jax.random.PRNGKey(3))
    model = build_model(reduced_config(arch).with_(num_layers=4))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    kinds = [sorted(bp) for bp in params["blocks"]]
    assert kinds == [sorted(bp) for bp in jparams["blocks"]]
    assert ["moe" in k for k in kinds] == [False, True, False, True]
    rs = np.random.RandomState(7)
    batch = {"tokens": rs.randint(0, 512, (2, 32)).astype(np.int32),
             "labels": rs.randint(0, 512, (2, 32)).astype(np.int32)}

    def jloss_fn(p):
        stats: list = []
        loss = jmodel.loss_fn(p, batch, stats_out=stats)
        return loss, stats[0]["moe_drop_fraction"]

    (jloss, jdrop), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(jparams)
    leaves, treedef = tree_util.flatten(params)
    leaves = [t.requires_grad_(True) for t in leaves]
    stats: list = []
    loss = model.loss_fn(treedef.unflatten(leaves),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         stats_out=stats)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert stats[0]["moe_drop_fraction"].item() == float(jdrop)
    for g, jg in zip(grads, jax.tree.leaves(jgrads)):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_capacity_equals_reference_over_a_grid():
    for s, k, e, cf in itertools.product((1, 7, 16, 255, 256, 4096, 8192),
                                         (1, 2), (4, 8, 128),
                                         (0.1, 1.0, 1.25, 2.0)):
        kw = dict(num_experts=e, top_k=k, expert_ff=8, capacity_factor=cf)
        assert moe.capacity(s, MoEConfig(**kw)) == \
            jax_moe.capacity(s, JaxMoEConfig(**kw)), (s, k, e, cf)
    # mixtral-8x7b at the MoE cells' lengths
    mix = MoEConfig(num_experts=8, top_k=2, expert_ff=14336)
    assert moe.capacity(256, mix) == 80 and moe.capacity(8192, mix) == 2560


@pytest.mark.parametrize("k", [1, 2, 4])
def test_aux_loss_is_one_under_uniform_routing(k):
    e, b, s = 8, 2, 16
    gates = torch.full((b, s, e), 1.0 / e)
    # every expert takes the same number of slots
    ids = (torch.arange(s * k).reshape(s, k) % e).expand(b, s, k)
    aux = moe.load_balance_aux(gates, ids, e, k)
    assert aux.item() == pytest.approx(1.0, abs=1e-6)
    jaux = jax_moe.load_balance_aux(jnp.asarray(gates.numpy()),
                                    jnp.asarray(ids.numpy()), e, k)
    assert aux.item() == pytest.approx(float(jaux), abs=1e-7)
