"""repro_torch tensor-parallel training against the JAX reference.

A (2, 2) ``("data", "model")`` mesh on 4 gloo ranks against the
reference's ``build_train_step`` on 4 host devices on the same mesh
(one subprocess, run beside the ranks), reduced llama3.2-1b, parameters
from the reference's ``Model.init(key(7))`` (its ``init_train_state``
makes the same ones), ``ring_hier`` at chunks 2 over 2 channels, 64 KiB
buckets and 8 KiB pages, microbatches 2, the reference's default
``OptimConfig``, 3 steps, in ``replicated``, ``zero1`` and ``zero1`` with
the arena:

* per-step loss within 5e-5 absolute, the reference's own bound for these
  modes (``tests/test_distributed.py::DPMODES_SCRIPT``), and the gradient
  norm within rtol 1e-4;
* the final parameters, gathered from the four ranks' blocks into the
  whole tree, within 5e-5 of the reference's (global arrays), and the
  blocks of a leaf replicated over the model axis equal on both model
  ranks;
* every leaf of the first step's reduced gradient (``replicated``,
  gathered likewise) within rtol/atol 1e-4 of the single-device gradient
  of the whole batch, ``jax.grad`` of the reference's loss, the tolerance
  of ``test_torch_train.py``'s fp32 gradient test.  A missing or doubled
  model-axis sum (the kv projections' ``sum_grads_over_model``, the
  norms' ``fan_out``, the tied table's two uses) is off by a factor of 2
  here;
* a config with 16 q / 4 kv heads in ``replicated``, so that model rank 1
  holds real heads (the reduced config pads 4 heads to 16, all on rank 0):
  losses, final parameters and first-step gradients likewise;
* the model ring issued the same all-reduces on every rank (one ``psum``
  an embedding, one a row-parallel output, two a cross entropy, their
  backward partners), and none went through the communicator.

And what ROADMAP Queue 1 #6b refused until it was ported builds on a
(1, 2) mesh: ``fsdp`` steps and a Trainer that checkpoints
(``test_torch_tp_fsdp.py`` and ``test_torch_tp_ckpt.py`` hold them to the
reference).
"""

import dataclasses
import os
import subprocess
import sys
import tempfile
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

from conftest import SRC
from torch_dist_util import run_ranks
import torch_tp_jobs as jobs
from repro_torch import bridge
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch.configs import reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.models import build_model
from repro_torch.sharding.rules import spec_leaves

STEPS = 3
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "microbatches": 2}
CASES = [("replicated", False), ("zero1", False), ("zero1", True)]
HEADS = {"num_heads": 16, "num_kv_heads": 4}
B, S = 8, 32


def _with_heads(cfg):
    return cfg.with_(attn=dataclasses.replace(cfg.attn, **HEADS))

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

kw = {kw!r}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
cfg = reduced_config("llama3.2-1b")
batch = dict(np.load({batch!r}))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}


def train(m, mode, arena, tag):
    tcfg = TrainStepConfig(dp_mode=mode, comm=CommConfig(**kw["comm"]),
                           microbatches=kw["microbatches"],
                           use_arena=arena)
    with mesh:
        state, _ = init_train_state(m, mesh, tcfg, key=jax.random.key(7))
        step = build_train_step(m, mesh, tcfg, bspecs)
        losses, norms = [], []
        for s in range({steps}):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    out[f"loss/{{tag}}"] = np.array(losses)
    out[f"gnorm/{{tag}}"] = np.array(norms)
    for i, l in enumerate(jax.tree.leaves(state["params"])):
        out[f"final/{{tag}}/{{i}}"] = np.asarray(l)


m = build_model(cfg)
for mode, arena in {cases!r}:
    train(m, mode, arena, f"{{mode}}{{int(arena)}}")
# real heads on model rank 1 (16 q / 4 kv heads: 8 and 2 a rank)
train(build_model(cfg.with_(attn=dataclasses.replace(
    cfg.attn, **{heads!r}))), "replicated", False, "heads")
np.savez({path!r}, **out)
print("TP_TRAIN_REF_OK")
"""


def _leaves(ref, prefix):
    n = len([k for k in ref if k.startswith(prefix)])
    return [ref[f"{prefix}{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def run():
    """The reference subprocess and the four port ranks, side by side (the
    subprocess starts first; the gradients here are taken meanwhile)."""
    rng = np.random.RandomState(0)
    batch = {"tokens": rng.randint(0, 500, (B, S)).astype(np.int32),
             "labels": rng.randint(0, 500, (B, S)).astype(np.int32)}
    with tempfile.TemporaryDirectory() as tmp:
        bpath = os.path.join(tmp, "batch.npz")
        np.savez(bpath, **batch)
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                kw=STEP_KW, batch=bpath, cases=CASES, steps=STEPS,
                heads=HEADS, path=path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            leaves, grads = {}, {}
            for name, cfg in (("base", jax_reduced_config("llama3.2-1b")),
                              ("heads", _with_heads(jax_reduced_config(
                                  "llama3.2-1b")))):
                jmodel = jax_build_model(cfg)
                params = jmodel.init(jax.random.key(7))
                leaves[name] = [np.asarray(l) for l in
                                jax.tree.leaves(params)]
                grads[name] = [np.asarray(g) for g in jax.tree.leaves(
                    jax.jit(jax.grad(jmodel.loss_fn))(params, batch))]
            ranks = run_ranks(jobs.tp_train_job, 4, leaves, batch, CASES,
                              STEPS, STEP_KW, HEADS)
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "TP_TRAIN_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref, "grads": grads}


@pytest.fixture(scope="module")
def specs():
    model = build_model(reduced_config("llama3.2-1b"))
    return model.param_specs(RankMesh(("data", "model"), (2, 2)))


MESH = RankMesh(("data", "model"), (2, 2))


def _global(trees, specs):
    from repro_torch import tree as tree_util

    return tree_util.leaves(bridge.global_params_to_numpy(trees, specs, MESH))


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[0]}{int(c[1])}")
def test_losses_norms_and_final_params_match_reference(run, specs, case):
    tag = f"{case[0]}{int(case[1])}"
    ref = run["ref"]
    outs = [r[case] for r in run["ranks"]]
    for o in outs:
        np.testing.assert_allclose(o["loss"], ref[f"loss/{tag}"], rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(o["grad_norm"], ref[f"gnorm/{tag}"],
                                   rtol=1e-4)
    final = _global([o["params"] for o in outs], specs)
    want = _leaves(ref, f"final/{tag}/")
    assert len(final) == len(want)
    for g, w in zip(final, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    # a leaf replicated over the model axis is the same on both model ranks
    from repro_torch import tree as tree_util

    for a, b in ((0, 1), (2, 3)):
        for x, y, sp in zip(tree_util.leaves(outs[a]["params"]),
                            tree_util.leaves(outs[b]["params"]),
                            spec_leaves(specs)):
            if "model" not in [e for e in sp if e is not None]:
                np.testing.assert_array_equal(x, y)


def test_first_step_gradients_match_reference(run, specs):
    outs = [r[("replicated", False)] for r in run["ranks"]]
    got = _global([o["grads"] for o in outs], specs)
    assert len(got) == len(run["grads"]["base"])
    for g, w in zip(got, run["grads"]["base"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_real_heads_on_model_rank_one_match_reference(run):
    """16 q / 4 kv heads, so that model rank 1 holds real heads (global q
    heads 8-15 reading kv heads 2-3) and every rank's ``wo`` rows carry
    weight: the kv gather's offset and the kernel's kv slice for rank 1
    are seen here, where the reduced config's padded heads hide them.
    ``replicated``: losses, final parameters and every first-step gradient
    leaf against the reference, at the tolerances above."""
    specs = build_model(_with_heads(reduced_config(
        "llama3.2-1b"))).param_specs(MESH)
    ref = run["ref"]
    outs = [r["heads"] for r in run["ranks"]]
    for o in outs:
        np.testing.assert_allclose(o["loss"], ref["loss/heads"], rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(o["grad_norm"], ref["gnorm/heads"],
                                   rtol=1e-4)
    final = _global([o["params"] for o in outs], specs)
    want = _leaves(ref, "final/heads/")
    assert len(final) == len(want)
    for g, w in zip(final, want):
        np.testing.assert_allclose(g, w, rtol=0, atol=5e-5)
    got = _global([o["grads"] for o in outs], specs)
    assert len(got) == len(run["grads"]["heads"])
    for g, w in zip(got, run["grads"]["heads"]):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4)


def test_model_axis_collectives_are_the_same_on_every_rank(run):
    for case in CASES:
        recs = [r[case]["model_record"] for r in run["ranks"]]
        assert all(rec == recs[0] for rec in recs)
        # forward: embed 1, per layer wo and w_down 2, the xent 2 (exp-sum
        # and gold) and its max 1; backward: per layer ln1, ln2 and the kv
        # projections' weights (fan_out / sum_grads), the final norm 1;
        # and a step's gradient norm 1 (the sharded leaves' sum of squares)
        layers, mb = 2, STEP_KW["microbatches"]
        per_mb = (1 + 2 * layers + 3) + (4 * layers + 1)
        assert recs[0]["all_reduces"] == STEPS * (mb * per_mb + 1)
        assert recs[0]["sends"] == 0 and recs[0]["all_gathers"] == 0


@pytest.mark.parametrize("arena", [False, True])
@pytest.mark.parametrize("index", [0, 1])
def test_zero1_norm_ranges_weigh_as_build_norm_weights(arena, index):
    """The zero1 norm's ranges and weights (the step's, read off the plan's
    runs) are :func:`build_norm_weights` (and the span weights) sliced like
    this rank's shard, on the (2, 2) mesh's local shapes: 1.0 on
    model-sharded fields, 0.5 on replicated ones, 0 on page padding."""
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.runtime.train_step import (_slice_like_shard,
                                                abstract_params,
                                                build_norm_weights,
                                                build_span_norm_weights,
                                                norm_ranges_from_runs,
                                                norm_weight_runs,
                                                span_norm_weight_runs)
    from repro_torch.sharding.rules import is_model_sharded, local_shard

    model = build_model(reduced_config("llama3.2-1b"))
    specs = model.param_specs(MESH)
    local = local_shard(abstract_params(model), specs, MESH, 0)
    comm = Communicator(MESH, CommConfig(**STEP_KW["comm"]), connect=False)
    plan = comm.bucketer.plan(local)
    weights = build_norm_weights(plan, spec_leaves(specs), 2)
    runs = norm_weight_runs(plan, spec_leaves(specs), 2)
    for f in plan.fields:
        want = 1.0 if is_model_sharded(spec_leaves(specs)[f.leaf]) else 0.5
        got = weights[f.bucket][f.offset:f.offset + f.size]
        assert torch.all(got == want)
    if arena:
        layout = comm.arena_layout(local)
        weights = build_span_norm_weights(layout, weights)
        runs = span_norm_weight_runs(layout, runs)
    rings = (SimpleNamespace(size=2, index=index),)
    ranges, ws = norm_ranges_from_runs(runs, rings)
    assert {w for r in ws for w in r} == {1.0, 0.5}
    for w, rs, rw in zip(weights, ranges, ws):
        want = _slice_like_shard(w, rings)
        got = torch.zeros_like(want)
        for (a, z), x in zip(rs, rw):
            got[a:z] = x
        assert torch.equal(got, want)


def test_what_stays_refused_on_a_model_axis(tmp_path):
    """Nothing of #6b stays refused: on a (1, 2) mesh of two gloo ranks an
    fsdp step trains (finite loss, equal on both ranks) and a Trainer with
    ``ckpt_dir`` writes its step directory, with the parameters laid out as
    model blocks and the rest replicated."""
    outs = run_ranks(jobs.model_axis_builds_job, 2, "train", str(tmp_path))
    assert np.isfinite(outs[0]["fsdp_loss"])
    assert outs[0]["fsdp_loss"] == outs[1]["fsdp_loss"]
    assert outs[0]["rules"] == ["Blocks", "replicated"]
    assert os.listdir(tmp_path) == ["step_00000001"]
