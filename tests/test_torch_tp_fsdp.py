"""repro_torch fsdp on a ``("data", "model")`` mesh against the JAX
reference.

A (2, 2) mesh on 4 gloo ranks against the reference's ``FsdpPlan`` and
``build_train_step`` on 4 host devices on the same mesh (one subprocess,
run beside the ranks), from the reference's ``Model.init(key(7))``,
``ring_hier`` at chunks 2 over 2 channels, 64 KiB buckets (fsdp's too:
several buckets a block), 8 KiB pages, microbatches 2, the reference's
default ``OptimConfig``, 3 steps.  Four cases cover the native and the ring
gather with the arena off and on, one each: the reduced llama3.2-1b over
the native gather without the arena and over the ring gather with it; a
16 q / 4 kv head config (model rank 1 holds real heads) over the native
gather with the arena; the reduced qwen2-7b (its arch's default mode, with
qkv biases) over the ring gather without it.

* the plan: the groups, each group's bucket sizes and arena segments, and
  the norm weights (1.0 on model-sharded fields, 1/2 on the fields the
  model axis replicates) equal to the reference's ``FsdpPlan`` field for
  field: the buckets hold the rank's model block;
* each rank's initial shards bitwise block ``d*2+m`` of the reference's
  global flat arrays (``P(('data', 'model'))``);
* per-step loss within 5e-5 absolute and gradient norm within rtol 1e-4,
  the bounds of ``test_torch_tp_train.py`` (a missing norm weight moves
  the norm by far more); both model ranks' losses equal;
* each rank's final shards within 5e-5 of block ``d*2+m`` of the
  reference's;
* the model axis's all-reduces the same on every rank and the count the
  code gives (below), none through the communicator.
"""

import os
import subprocess
import sys
import tempfile

import jax
import numpy as np
import pytest

from conftest import SRC
from torch_dist_util import run_ranks
import torch_tp_jobs as jobs

STEPS = 3
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "microbatches": 2, "fsdp_bucket_bytes": 64 * 1024}
CASES = {"native": dict(model="base", gather="native", arena=False),
         "ring_arena": dict(model="base", gather="ring", arena=True),
         "heads_native_arena": dict(model="heads", gather="native",
                                    arena=True),
         "qwen_ring": dict(model="qwen", gather="ring", arena=False)}
B, S = 8, 32

JAX_SCRIPT = r"""
import dataclasses
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.models import build_model
from repro.runtime.train_step import (FsdpPlan, TrainStepConfig,
                                      build_train_step, init_train_state)

kw, cases = {kw!r}, {cases!r}
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
batch = dict(np.load({batch!r}))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
base = reduced_config("llama3.2-1b")
cfgs = {{"base": base, "qwen": reduced_config("qwen2-7b"),
         "heads": base.with_(attn=dataclasses.replace(
             base.attn, num_heads=16, num_kv_heads=4))}}
out = {{}}


def save_groups(prefix, groups):
    for name, shards in groups.items():
        for i, s in enumerate(shards):
            out[f"{{prefix}}/{{name}}/{{i}}"] = np.asarray(s)


for name, c in cases.items():
    m = build_model(cfgs[c["model"]])
    tcfg = TrainStepConfig(dp_mode="fsdp", comm=CommConfig(**kw["comm"]),
                           microbatches=kw["microbatches"],
                           use_arena=c["arena"], fsdp_gather=c["gather"],
                           fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])
    with mesh:
        plan = FsdpPlan(m, mesh, tcfg)
        out[f"{{name}}/groups"] = np.array(sorted(plan.groups))
        for g in plan.groups:
            out[f"{{name}}/sizes/{{g}}"] = np.array(plan.plans[g].bucket_sizes)
            out[f"{{name}}/norm/{{g}}"] = np.concatenate(plan.norm_weights[g])
        if plan.arena_layout is not None:
            out[f"{{name}}/arena"] = np.array(
                [[s.offset, s.size, s.padded]
                 for s in plan.arena_layout.segments])
        state, _ = init_train_state(m, mesh, tcfg, key=jax.random.key(7))
        save_groups(f"{{name}}/init", state["groups"])
        step = build_train_step(m, mesh, tcfg, bspecs)
        losses, norms = [], []
        for s in range({steps}):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    out[f"{{name}}/loss"] = np.array(losses)
    out[f"{{name}}/gnorm"] = np.array(norms)
    save_groups(f"{{name}}/final", state["groups"])
np.savez({path!r}, **out)
print("TP_FSDP_REF_OK")
"""


def _reference_leaves() -> dict:
    """The reference's ``Model.init(key(7))`` leaves of each config."""
    import dataclasses

    from repro.configs import reduced_config
    from repro.models import build_model

    base = reduced_config("llama3.2-1b")
    cfgs = {"base": base, "qwen": reduced_config("qwen2-7b"),
            "heads": base.with_(attn=dataclasses.replace(
                base.attn, num_heads=16, num_kv_heads=4))}
    return {k: [np.asarray(l) for l in jax.tree.leaves(
        build_model(c).init(jax.random.key(7)))] for k, c in cfgs.items()}


@pytest.fixture(scope="module")
def run():
    """The reference subprocess and the four port ranks, side by side."""
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
                path=path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(jobs.tp_fsdp_job, 4, _reference_leaves(),
                              batch, CASES, STEPS, STEP_KW)
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "TP_FSDP_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


def _groups(ref, prefix) -> dict:
    """``{name: [global flat arrays]}`` saved under ``prefix``."""
    out: dict = {}
    for key in ref:
        if key.startswith(prefix + "/"):
            name, i = key[len(prefix) + 1:].rsplit("/", 1)
            out.setdefault(name, {})[int(i)] = ref[key]
    return {name: [d[i] for i in range(len(d))] for name, d in out.items()}


def _block(full, rank, world=4):
    """Block ``rank`` of a ``P(('data', 'model'))`` global array: the
    device at (d, m) holds block ``d * 2 + m``."""
    n = full.size // world
    return full[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_plan_and_norm_weights_equal_reference(run, case):
    ref = run["ref"]
    for out in run["ranks"]:
        plan = out[case]["plan"]
        assert plan["groups"] == list(ref[f"{case}/groups"])
        for name in plan["groups"]:
            assert plan["sizes"][name] == list(ref[f"{case}/sizes/{name}"])
            np.testing.assert_array_equal(plan["norm_weights"][name],
                                          ref[f"{case}/norm/{name}"])
        weights = np.concatenate(list(plan["norm_weights"].values()))
        assert set(np.unique(weights)) == {0.5, 1.0}
        if CASES[case]["arena"]:
            np.testing.assert_array_equal(plan["arena"],
                                          ref[f"{case}/arena"])
        else:
            assert "arena" not in plan


@pytest.mark.parametrize("case", list(CASES))
def test_initial_shards_are_the_reference_blocks(run, case):
    want = _groups(run["ref"], f"{case}/init")
    for r, out in enumerate(run["ranks"]):
        got = out[case]
        assert (got["data_index"], got["model_index"]) == divmod(r, 2)
        assert sorted(got["init"]) == sorted(want)
        for name in want:
            for a, b in zip(got["init"][name], want[name]):
                np.testing.assert_array_equal(a, _block(b, r),
                                              err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_on_a_model_axis_follows_reference(run, case):
    ref = run["ref"]
    final = _groups(ref, f"{case}/final")
    for r, out in enumerate(run["ranks"]):
        got = out[case]
        np.testing.assert_allclose(got["loss"], ref[f"{case}/loss"], rtol=0,
                                   atol=5e-5, err_msg=f"rank {r}")
        np.testing.assert_allclose(got["grad_norm"], ref[f"{case}/gnorm"],
                                   rtol=1e-4, err_msg=f"rank {r}")
        for name in final:
            for i, (p, full) in enumerate(zip(got["groups"][name],
                                              final[name])):
                np.testing.assert_allclose(p, _block(full, r), rtol=0,
                                           atol=5e-5,
                                           err_msg=f"rank {r} {name}/{i}")
    losses = [out[case]["loss"] for out in run["ranks"]]
    for other in losses[1:]:
        np.testing.assert_array_equal(other, losses[0])


@pytest.mark.parametrize("case", list(CASES))
def test_model_axis_collectives_are_the_same_on_every_rank(run, case):
    """The model ring issues, per microbatch, the forward's one embedding
    psum, two row-parallel psums a layer (``wo``, ``w_down``) and the cross
    entropy's three (max, exp-sum, gold), and the backward's two fan-outs
    a layer (``ln1``, ``ln2``), a sum a layer for each leaf of the kv
    projections (``w``, and under qkv biases ``b``: 2 or 4) and the final
    norm's one; and a step's gradient norm one: the count of
    ``test_torch_tp_train.py``, the gathers and their reduce-scatters all
    on the data axis."""
    recs = [out[case]["model_record"] for out in run["ranks"]]
    assert all(rec == recs[0] for rec in recs)
    layers, mb = 2, STEP_KW["microbatches"]
    kv = 4 if CASES[case]["model"] == "qwen" else 2
    per_mb = (1 + 2 * layers + 3) + ((2 + kv) * layers + 1)
    assert recs[0]["all_reduces"] == STEPS * (mb * per_mb + 1)
    assert recs[0]["sends"] == 0 and recs[0]["all_gathers"] == 0
    for out in run["ranks"]:
        rec = out[case]["record"]
        # the data axis: the loss's mean and the norm, 2 a step
        assert rec["all_reduces"] == 2 * STEPS
        if CASES[case]["gather"] == "ring":
            assert rec["sends"] > 0 and rec["all_gathers"] == 0
        else:
            assert rec["sends"] == 0 and rec["all_gathers"] > 0
