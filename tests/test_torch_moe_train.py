"""MoE training in repro_torch against the JAX reference: the reduced
mixtral-8x7b and llama4-maverick-400b-a17b.

* One rank at fp32 compute from bridged parameters: the loss (cross
  entropy plus 0.01 times the load-balancing loss) within rtol 1e-5 and
  every gradient leaf within rtol / atol 1e-4, the method and bounds of
  ``test_torch_train.py``, and ``moe_drop_fraction`` equal (a count).
* Two gloo ranks on a (1, 2) ``("data", "model")`` mesh against the
  reference's 2-device ``build_train_step`` on the same mesh (one
  subprocess beside the ranks), from the reference's ``Model.init(key(7))``,
  the arch's EP settings (``moe_transport="a2a"``, ``moe_channels=2``),
  ``ring_hier`` over 2 channels, 2 steps: llama4 (``parallelism="ep"``, 1
  MoE layer of 2) and mixtral with its experts sharded (``ep`` through
  ``cfg.with_``), both ``fsdp``, and mixtral as published (TP in the
  expert) under ``zero1``.  Per-step losses within 5e-5 of the
  reference's, gradient norms within rtol 1e-4, the drop fractions equal,
  and the EP traffic the code's: 2 exchanges a MoE layer forward and 2
  backward (``remat`` is off at reduced size), each over 2 rails, so 8
  ``all_to_all_single`` calls a MoE layer a step; none under TP.
"""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest
import torch

import torch_moe_jobs as jobs
from conftest import SRC
from torch_dist_util import run_ranks
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import reduced_config
from repro_torch.models import build_model

ARCHS = ("mixtral-8x7b", "llama4-maverick-400b-a17b")
STEPS = 2
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "moe_transport": "a2a", "moe_channels": 2}
CASES = {"llama4_fsdp": dict(arch=ARCHS[1], mode="fsdp"),
         "mixtral_ep_fsdp": dict(arch=ARCHS[0], ep=True, mode="fsdp"),
         "mixtral_tp_zero1": dict(arch=ARCHS[0], mode="zero1")}
B, S = 4, 32

JAX_SCRIPT = r"""
import dataclasses
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.models import build_model
from repro.runtime.train_step import (TrainStepConfig, build_train_step,
                                      init_train_state)

kw, cases = {kw!r}, {cases!r}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
batch = dict(np.load({batch!r}))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}
for name, c in cases.items():
    cfg = reduced_config(c["arch"])
    if c.get("ep"):
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, parallelism="ep"))
    m = build_model(cfg)
    tcfg = TrainStepConfig(dp_mode=c["mode"], comm=CommConfig(**kw["comm"]),
                           moe_transport=kw["moe_transport"],
                           moe_channels=kw["moe_channels"])
    with mesh:
        state, _ = init_train_state(m, mesh, tcfg, key=jax.random.key(7))
        step = build_train_step(m, mesh, tcfg, bspecs)
        losses, norms, drops = [], [], []
        for s in range({steps}):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
            drops.append(float(met["moe_drop_fraction"]))
    out[f"{{name}}/loss"] = np.array(losses)
    out[f"{{name}}/gnorm"] = np.array(norms)
    out[f"{{name}}/drop"] = np.array(drops)
np.savez({path!r}, **out)
print("MOE_TRAIN_REF_OK")
"""


def _reference_leaves() -> dict:
    """Each case's ``Model.init(key(7))`` leaves (JAX order)."""
    import dataclasses

    out = {}
    for name, c in CASES.items():
        cfg = jax_reduced_config(c["arch"])
        if c.get("ep"):
            cfg = cfg.with_(moe=dataclasses.replace(cfg.moe,
                                                    parallelism="ep"))
        out[name] = [np.asarray(l) for l in jax.tree.leaves(
            jax_build_model(cfg).init(jax.random.key(7)))]
    return out


@pytest.fixture(scope="module")
def run():
    """The reference subprocess and the two port ranks, side by side."""
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 500, (B, S)).astype(np.int32),
             "labels": rng.randint(0, 500, (B, S)).astype(np.int32)}
    with tempfile.TemporaryDirectory() as tmp:
        bpath = os.path.join(tmp, "batch.npz")
        np.savez(bpath, **batch)
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                kw=STEP_KW, batch=bpath, cases=CASES, steps=STEPS,
                path=path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(jobs.moe_train_job, 2, _reference_leaves(),
                              batch, CASES, STEPS, STEP_KW)
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "MOE_TRAIN_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


@pytest.mark.parametrize("arch", ARCHS)
def test_one_rank_loss_and_grads_match_reference_at_fp32(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = build_model(reduced_config(arch))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    rs = np.random.RandomState(2)
    batch = {"tokens": rs.randint(0, 512, (2, 32)).astype(np.int32),
             "labels": rs.randint(0, 512, (2, 32)).astype(np.int32)}

    def jloss_fn(p):
        stats: list = []
        loss = jmodel.loss_fn(p, batch, stats_out=stats)
        return loss, stats[0]["moe_drop_fraction"]

    (jloss, jdrop), jgrads = jax.jit(jax.value_and_grad(
        jloss_fn, has_aux=True))(jparams)
    leaves, treedef = tree_util.flatten(params)
    leaves = [p.requires_grad_(True) for p in leaves]
    stats: list = []
    loss = model.loss_fn(treedef.unflatten(leaves),
                         {k: torch.from_numpy(v) for k, v in batch.items()},
                         stats_out=stats)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert stats[0]["moe_drop_fraction"].item() == float(jdrop)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_steps_follow_reference(run, case):
    ref = run["ref"]
    for out in run["ranks"]:
        got = out[case]
        np.testing.assert_allclose(got["loss"], ref[f"{case}/loss"], rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(got["grad_norm"], ref[f"{case}/gnorm"],
                                   rtol=1e-4)
        np.testing.assert_array_equal(got["drop"], ref[f"{case}/drop"])
    np.testing.assert_array_equal(run["ranks"][0][case]["loss"],
                                  run["ranks"][1][case]["loss"])


@pytest.mark.parametrize("case", list(CASES))
def test_ep_traffic_is_the_codes(run, case):
    cfg = jobs.moe_config(CASES[case])
    n_moe = sum(cfg.layer_kind(i)["mlp"] == "moe"
                for i in range(cfg.num_layers))
    routed = cfg.moe.parallelism == "ep"
    for out in run["ranks"]:
        rec = out[case]["moe_record"]
        assert rec["all_to_alls"] == (8 * n_moe * STEPS if routed else 0)
        assert rec["sends"] == rec["all_reduces"] == 0
