"""repro_torch ZeRO-1 (``dp_mode="zero1"``) against the JAX reference.

* ``adamw_flat_update`` and ``init_opt_state_flat`` on seeded shards:
  bitwise equal to the reference run under ``jit`` with
  ``--xla_disable_hlo_passes=fusion,algsimp`` (one subprocess; without the
  flags XLA divides by a reciprocal and contracts FMAs).  The port takes
  the bias corrections in fp32 and the square root correctly rounded, as
  the reference does.
* The norm weights (``build_norm_weights``, ``build_span_norm_weights``)
  of the reduced model's bucket plan and arena layout: equal to the
  reference's arrays exactly, each rank's slice of them is its
  reduce-scatter shard, and the ranges the step's norm sums over
  (``TrainStep.norm_ranges``) weigh each shard element as that slice does.
* The zero1 train loop on 2 gloo ranks against the reference's 2-device
  zero1 step (one subprocess), from the same initial parameters, with the
  arena off and on, ``microbatches=2`` and ``schedule="scheduled"``, for 3
  steps:

  - per-step loss within 5e-5 absolute (the reference's own zero1 bound,
    ``tests/test_distributed.py``) and rtol 1e-5 (the fp32 loss test's);
  - gradient norm within rtol 1e-4;
  - final parameters within atol 1e-4: AdamW divides each element's
    update by its own gradient scale, so where a gradient is near 0 the
    sum-order difference of autograd and XLA (the fp32 gradient test holds
    gradients to rtol/atol 1e-4) moves that element's update by a visible
    share of the learning rate (1e-2); 1e-4 is 1 % of one step;
  - each rank's ``mu`` shards, in the reference's layout (rank ``r``'s
    shard of a global flat leaf of ``p * n`` elements is ``[r*n,
    (r+1)*n)``), within rtol/atol 1e-4: ``mu`` is a weighted sum of the
    reduced gradients, with weights that sum to less than 1, so it carries
    the gradients' bound; ``nu`` within rtol 2e-4, since squaring doubles
    a relative error, and atol 1e-8, the square of the gradients' atol:
    where every gradient of an element lies within 1e-4 of 0, its ``nu``
    is below 1e-8 on both sides (the weights of ``nu`` sum to less than
    1);
  - both ranks' parameters bitwise equal after every step;
  - recorded sends and bytes equal to the plan (the reduce-scatter once per
    microbatch, the delta all-gather once; each half of the plan's
    all-reduce, see ``torch_zero1_jobs.zero1_prediction``), and 2
    all-reduces a step: the loss's mean and the norm's sum over data.
* The communicator: a reduce-scatter shard is this rank's slice of the sum,
  and ``reduce_scatter_tree`` + ``all_gather_buckets`` equals
  ``all_reduce_tree`` bitwise.
* Refusals: a transport without reduce-scatter (``psum``) raises
  ``ValueError``; so do the two refusals fsdp keeps, a wire codec with the
  ring gather and the ring gather over ``psum``.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_zero1_jobs as jobs
from repro_torch.comm import CommConfig, Communicator
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.optim import (OptimConfig, adamw_flat_update,
                               init_opt_state_flat)
from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                            abstract_params,
                                            build_norm_weights,
                                            build_span_norm_weights,
                                            data_mesh)

STEPS = 3
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=STEPS),
           "microbatches": 2, "schedule": "scheduled",
           "seq": 32, "batch": 4}

JAX_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_step import (TrainStepConfig, _local_shapes,
                                      build_comm, build_norm_weights,
                                      build_span_norm_weights,
                                      build_train_step, init_train_state)

kw = {kw!r}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
model = build_model(reduced_config("llama3.2-1b"))
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}
for arena in (0, 1):
    tcfg = TrainStepConfig(dp_mode="zero1", comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]),
                           use_arena=bool(arena),
                           microbatches=kw["microbatches"],
                           schedule=kw["schedule"])
    with mesh:
        comm = build_comm(mesh, tcfg)
        pspecs = model.param_specs(mesh)
        local = _local_shapes(model.abstract_params(), pspecs, mesh)
        specs_flat = jax.tree_util.tree_flatten(
            pspecs, is_leaf=lambda x: isinstance(x, P))[0]
        weights = build_norm_weights(comm.bucketer.plan(local), specs_flat,
                                     1)
        if arena:
            weights = build_span_norm_weights(comm.arena(local).layout,
                                              weights)
        for i, w in enumerate(weights):
            out[f"weights{{arena}}/{{i}}"] = np.asarray(w)
        state, _ = init_train_state(model, mesh, tcfg, key=jax.random.key(0))
        step = build_train_step(model, mesh, tcfg, bspecs)
        if not arena:
            for i, l in enumerate(jax.tree.leaves(state["params"])):
                out[f"init/{{i}}"] = np.asarray(l)
        losses, norms = [], []
        for s in range({steps}):
            state, m = step(state, data.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"loss/{{arena}}"] = np.array(losses)
    out[f"gnorm/{{arena}}"] = np.array(norms)
    for i, l in enumerate(jax.tree.leaves(state["params"])):
        out[f"final{{arena}}/{{i}}"] = np.asarray(l)
    for k in ("mu", "nu"):
        for i, l in enumerate(state["opt"][k]):
            out[f"{{k}}{{arena}}/{{i}}"] = np.asarray(l)
np.savez({path!r}, **out)
print("ZERO1_REF_OK")
"""

ADAMW_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
from repro.optim import OptimConfig
from repro.optim.adamw import adamw_flat_update, init_opt_state_flat

cases = np.load({inp!r})
out = {{}}
update = jax.jit(lambda g, o, s, lr: adamw_flat_update(g, o, s, lr,
                                                       OptimConfig()))
n = int(cases["n"])
g = [jnp.asarray(cases[f"g/{{i}}"]) for i in range(n)]
zero = init_opt_state_flat(g)
for i in range(n):
    out[f"zero_mu/{{i}}"] = np.asarray(zero["mu"][i])
    out[f"zero_nu/{{i}}"] = np.asarray(zero["nu"][i])
opt = {{"mu": [jnp.asarray(cases[f"mu/{{i}}"]) for i in range(n)],
        "nu": [jnp.asarray(cases[f"nu/{{i}}"]) for i in range(n)]}}
for c, (step, lr) in enumerate(zip(cases["steps"], cases["lrs"])):
    d, new = update(g, opt, jnp.asarray(step, jnp.int32),
                    jnp.asarray(lr, jnp.float32))
    for i in range(n):
        out[f"{{c}}/delta/{{i}}"] = np.asarray(d[i])
        out[f"{{c}}/mu/{{i}}"] = np.asarray(new["mu"][i])
        out[f"{{c}}/nu/{{i}}"] = np.asarray(new["nu"][i])
np.savez({path!r}, **out)
print("ADAMW_REF_OK")
"""


def _leaves(reference, prefix):
    n = len([k for k in reference if k.startswith(prefix)])
    return [reference[f"{prefix}{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "zero1.npz")
        assert "ZERO1_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


@pytest.fixture(scope="module")
def ranks(reference):
    leaves = _leaves(reference, "init/")
    return {arena: run_ranks(jobs.zero1_train_job, 2, leaves, STEPS,
                             bool(arena), STEP_KW)
            for arena in (0, 1)}


def _adamw_cases():
    """Seeded shards of many magnitudes, moments, and (step, lr) pairs."""
    rng = np.random.RandomState(5)
    sizes = (4096, 1000, 77)
    mags = [10.0 ** rng.uniform(-7, 1, n) for n in sizes]
    return {"n": len(sizes),
            "steps": np.array([0, 3, 17], np.int32),
            "lrs": np.array([1e-2, 3e-4, 2.5e-3], np.float32),
            **{f"g/{i}": (rng.randn(n) * m).astype(np.float32)
               for i, (n, m) in enumerate(zip(sizes, mags))},
            **{f"mu/{i}": (rng.randn(n) * 1e-3).astype(np.float32)
               for i, n in enumerate(sizes)},
            **{f"nu/{i}": (np.abs(rng.randn(n)) * 1e-5).astype(np.float32)
               for i, n in enumerate(sizes)}}


def test_flat_adamw_is_bitwise_the_reference():
    cases = _adamw_cases()
    n = cases["n"]
    with tempfile.TemporaryDirectory() as tmp:
        inp, path = os.path.join(tmp, "in.npz"), os.path.join(tmp, "out.npz")
        np.savez(inp, **cases)
        assert "ADAMW_REF_OK" in run_distributed(
            ADAMW_SCRIPT.format(inp=inp, path=path), n_devices=1,
            extra_flags="--xla_disable_hlo_passes=fusion,algsimp")
        with np.load(path) as f:
            want = dict(f)
    g = [torch.from_numpy(cases[f"g/{i}"]) for i in range(n)]
    zero = init_opt_state_flat(g)
    for i in range(n):
        for k in ("mu", "nu"):
            assert zero[k][i].dtype == torch.float32
            np.testing.assert_array_equal(zero[k][i].numpy(),
                                          want[f"zero_{k}/{i}"])
    opt = {k: [torch.from_numpy(cases[f"{k}/{i}"]) for i in range(n)]
           for k in ("mu", "nu")}
    for c, (step, lr) in enumerate(zip(cases["steps"], cases["lrs"])):
        deltas, new = adamw_flat_update(g, opt, int(step), float(lr),
                                        OptimConfig())
        for i in range(n):
            np.testing.assert_array_equal(deltas[i].numpy(),
                                          want[f"{c}/delta/{i}"])
            for k in ("mu", "nu"):
                np.testing.assert_array_equal(new[k][i].numpy(),
                                              want[f"{c}/{k}/{i}"])


@pytest.mark.parametrize("arena", [0, 1])
def test_norm_weights_equal_reference(reference, ranks, arena):
    model = build_model(reduced_config("llama3.2-1b"))
    local = abstract_params(model)
    comm = Communicator(data_mesh(2), TrainStepConfig(
        comm=CommConfig(**STEP_KW["comm"])).comm_config(("pod", "data")),
        connect=False)
    bplan = comm.bucketer.plan(local)
    weights = build_norm_weights(bplan)
    if arena:
        layout = comm.arena_layout(local)
        weights = build_span_norm_weights(layout, weights)
        # page padding weighs 0, every bucket element 1
        assert sum(int(w.sum()) for w in weights) == bplan.total_elems
        assert sum(w.numel() for w in weights) == sum(
            sp.size for sp in layout.spans)
    want = _leaves(reference, f"weights{arena}/")
    assert len(weights) == len(want)
    for w, x in zip(weights, want):
        assert w.dtype == torch.float32
        np.testing.assert_array_equal(w.numpy(), x)
    for r, out in enumerate(ranks[arena]):
        assert out["shard_sizes"] == [x.size // 2 for x in want]
        assert len(out["norm_weights"]) == len(out["norm_masks"]) == len(want)
        for w, m, x in zip(out["norm_weights"], out["norm_masks"], want):
            n = x.size // 2
            np.testing.assert_array_equal(w, x[r * n:(r + 1) * n])
            np.testing.assert_array_equal(m, x[r * n:(r + 1) * n])


@pytest.mark.parametrize("arena", [0, 1])
def test_two_rank_zero1_trajectory_follows_reference(reference, ranks,
                                                     arena):
    for r, out in enumerate(ranks[arena]):
        what = f"arena={arena} rank {r}"
        np.testing.assert_allclose(out["loss"], reference[f"loss/{arena}"],
                                   rtol=1e-5, atol=0, err_msg=what)
        assert np.all(np.abs(out["loss"] - reference[f"loss/{arena}"])
                      <= 5e-5), what
        np.testing.assert_allclose(out["grad_norm"],
                                   reference[f"gnorm/{arena}"], rtol=1e-4,
                                   err_msg=what)
        for i, p in enumerate(out["params"][-1]):
            np.testing.assert_allclose(p, reference[f"final{arena}/{i}"],
                                       atol=1e-4, err_msg=f"{what} leaf {i}")
        for k, tol in (("mu", dict(rtol=1e-4, atol=1e-4)),
                       ("nu", dict(rtol=2e-4, atol=1e-8))):
            want = _leaves(reference, f"{k}{arena}/")
            assert len(out[k]) == len(want), what
            for i, (got, full) in enumerate(zip(out[k], want)):
                n = got.size
                assert full.size == 2 * n, f"{what} {k} shard {i}"
                np.testing.assert_allclose(
                    got, full[r * n:(r + 1) * n], **tol,
                    err_msg=f"{what} {k} shard {i}")
        assert out["stable"], what
        rec, pred = out["record"], out["predicted"]
        assert rec["sends"] == pred["sends"], what
        assert rec["send_bytes"] == round(pred["send_bytes"]), what
        # per step: the loss metric's mean and the norm's sum over data
        assert rec["all_reduces"] == 2 * STEPS, what
        assert rec["all_reduce_bytes"] == 2 * 4 * STEPS, what
    a, b = ranks[arena]
    for k in range(STEPS):                      # replicas stay identical
        for x, y in zip(a["params"][k], b["params"][k]):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("arena", [0, 1])
def test_reduce_scatter_tree_and_all_gather_buckets(ranks, arena):
    for out in ranks[arena]:
        assert out["rs_shard_is_owned_slice"]
        assert out["rs_ag_equals_ar"]


def test_zero1_refuses_a_transport_without_reduce_scatter():
    model = build_model(reduced_config("llama3.2-1b"))
    cfg = TrainStepConfig(dp_mode="zero1", comm=CommConfig(
        transport="psum"))
    with pytest.raises(ValueError, match="supports_rs"):
        TrainStep(model, data_mesh(1), cfg, device=torch.device("cpu"))


def test_fsdp_still_refuses():
    """What fsdp refuses now that it is ported: a wire codec with the ring
    gather (its reduction is the gather's backward, which carries no
    codec), and the ring gather over a transport without reduce-scatter."""
    model = build_model(reduced_config("llama3.2-1b"))
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="fsdp_gather"):
        TrainStep(model, data_mesh(1), TrainStepConfig(
            dp_mode="fsdp", fsdp_gather="ring", wire_codec="int8"),
            device=cpu)
    with pytest.raises(ValueError, match="supports_rs"):
        TrainStep(model, data_mesh(1), TrainStepConfig(
            dp_mode="fsdp", fsdp_gather="ring",
            comm=CommConfig(transport="psum")), device=cpu)
    # the native gather over psum trains
    TrainStep(model, data_mesh(1), TrainStepConfig(
        dp_mode="fsdp", comm=CommConfig(transport="psum")), device=cpu)
