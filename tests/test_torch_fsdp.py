"""repro_torch FSDP (``dp_mode="fsdp"``, ZeRO-3) against the JAX reference.

One reference subprocess (2 host devices, a (2, 1) data x model mesh) and
one spawn of 2 gloo ranks (``torch_fsdp_jobs.fsdp_job``) hold the port's
fsdp against the reference's, on the reduced llama3.2-1b with fsdp buckets
of 64 KiB (several buckets a block), from the same parameters (the
reference's ``Model.init``, bridged):

* (a) the plan: the groups, each group's bucket sizes and, with the
  arena, its segments (one per group-bucket shard, in sorted group order),
  equal to the reference's ``FsdpPlan``;
* (b) each rank's initial shards (``FsdpPlan.shard_state`` of the bridged
  parameters) bitwise the reference's ``init_train_state`` groups, rank
  ``r`` holding ``[r*n, (r+1)*n)`` of a ``2n``-element global bucket;
* (c) 3 steps at ``microbatches=2``, ``schedule="scheduled"``, with the
  native and the ring gather, the arena off and on, and the ring gather
  under ``remat="layer"`` (every block gathered again in the backward
  pass).  The weights are gathered in bf16 on both sides, so the port's
  gradients are bf16 cotangents, summed over the ranks and cast to the
  fp32 shards, as the reference's.  Bounds:

  - loss: bitwise at steps 1 and 2, whose weights are bitwise the
    reference's (step 1's learning rate is 0 under ``warmup=1``).  Step 2
    takes the first update, and the shards then differ by up to ``lr``
    times the gradients' relative difference (see ``mu`` below: up to
    7.8e-5 = ``lr`` 2^-7 reached).  That flips the bf16 rounding of a few
    gathered weights by one bf16 ulp (23 of 156,032 in the native case),
    and those flips alone move step 3's loss by 4.2e-5: the port's loss
    at the reference's step-3 weights is 1 fp32 ulp (4.8e-7) from the
    reference's.  So step 3 is held to two bounds computed in the run: (i)
    the port's loss at the reference's weights (its last step taken
    again from them) within 1e-5 of the reference's, where both sides
    compute with the same bf16 weights and only the order of the fp32 sums
    differs; (ii) the port's own loss within (i)'s gap plus twice the
    first-order bound ``Σ |g_i| |bf16(w_i) - bf16(w'_i)|`` over the
    gathered weights, ``g`` the reference's step-3 gradient (from its
    moments, ``(mu_3 - b1 mu_2) / (1 - b1)``, unclipped) and ``w``, ``w'``
    the two sides' shards entering step 3 (the factor 2 covers the second
    order; 4.24e-5 reached against a first-order bound of 4.32e-5);
  - gradient norm: rtol 1e-4, as zero1's (7.6e-5 reached);
  - ``mu`` within rtol 2^-7 and atol 1e-4, ``nu`` within rtol 2^-6 and
    atol 1e-8 (zero1's atols).  A gradient element is a bf16 value on both
    sides: the sum of two bf16 cotangents, each rounded from an fp32 value
    that differs between the sides in its last bits, so where it does not
    cancel it lies within two bf16 ulps (2^-7 relative) of the
    reference's.  ``mu`` is a weighted sum of such gradients with weights
    summing below 1, and ``nu`` of their squares, which doubles the
    relative bound (1.3 % reached on ``nu``);
  - final shards: every element within 2 ``lr`` and all but 1e-3 of them
    within 1e-4 (zero1's bound for all; 18 of 78,016 elements beyond it
    reached, the largest 4.3e-3).  A gradient element here is the bf16 sum
    of two bf16 cotangents; where the two nearly cancel, the rounding of
    each (half a bf16 ulp of the cotangent, not of the sum) can move the
    sum by a large share of itself, or flip its sign, and AdamW's first
    update is ``lr`` times the sign: such an element may end up to ``2
    lr`` apart.  Elsewhere the zero1 argument holds (1e-4 is 1 % of a
    step);
  - both ranks' losses equal, the arena keeps its storage;

* (d) the three schedule policies give the same steps bitwise (the fsdp
  reduction is the gathers' backward; the policy only names when the
  reference would issue it, and fsdp always reports ``scheduled``), as
  ``tests/test_schedule.py`` holds the reference's to its bounds;
* (e) recorded sends and bytes (ring) or native gathers and
  reduce-scatters and their bytes (native) equal
  ``torch_fsdp_jobs.fsdp_prediction``, with the remat re-gathers, and 2
  fp32 all-reduces a step;
* (f) ``Communicator.gather_flat``'s gather is every rank's shard in rank
  order, and its gradient is this rank's slice of the sum of the ranks'
  cotangents, rounded once to the gather's dtype, bitwise, for both
  implementations at fp32 and bf16;
* (h) the gathered prefill and decode steps (``weight_mode="gathered"``)
  at 1 and 2 ranks against the reference's gathered steps: logits within
  the resident tests' 1e-4 (fp32 compute, fp32 caches; the gathered
  weights are bf16 on both sides), each rank holding its rows.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_fsdp_jobs as jobs
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs.base import ShapeConfig
from repro_torch.models.transformer import init_decode_state
from repro_torch.optim import OptimConfig
from repro_torch.runtime.serve_step import build_decode_step, build_prefill
from repro_torch.runtime.train_step import (FsdpPlan, TrainStep,
                                            TrainStepConfig, abstract_params,
                                            data_mesh)

STEPS = 3
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=STEPS),
           "microbatches": 2, "schedule": "scheduled",
           "fsdp_bucket_bytes": 64 * 1024, "seq": 32, "batch": 4}
CASES = {"native": dict(gather="native", arena=False, remat="none"),
         "native_arena": dict(gather="native", arena=True, remat="none"),
         "ring": dict(gather="ring", arena=False, remat="none"),
         "ring_arena": dict(gather="ring", arena=True, remat="none"),
         "ring_remat": dict(gather="ring", arena=False, remat="layer")}
POLICIES = ["accumulate_then_reduce", "stream"]
_rng = np.random.RandomState(9)
SERVE_KW = {"batch": 2, "seq": 16, "cache": 8,
            "tokens": _rng.randint(0, 500, (2, 16)).astype(np.int32),
            "decode_tokens": [_rng.randint(0, 500, (2,)).astype(np.int32)
                              for _ in range(3)]}

JAX_SCRIPT = r"""
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.configs.base import ShapeConfig
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.models.transformer import init_decode_state
from repro.optim import OptimConfig
from repro.runtime.serve_step import build_decode_step, build_prefill
from repro.runtime.train_step import (FsdpPlan, TrainStepConfig,
                                      build_train_step, init_train_state)

kw, cases, policies, serve = {kw!r}, {cases!r}, {policies!r}, {serve!r}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
cfg0 = reduced_config("llama3.2-1b")
data = SyntheticTokens(DataConfig(vocab_size=build_model(cfg0).cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}


def save_groups(prefix, groups):
    for name, shards in groups.items():
        for i, s in enumerate(shards):
            out[f"{{prefix}}/{{name}}/{{i}}"] = np.asarray(s)


params = build_model(cfg0).init(jax.random.key(0))
for i, l in enumerate(jax.tree.leaves(params)):
    out[f"params/{{i}}"] = np.asarray(l)
runs = [(name, c, c.get("schedule", kw["schedule"]), {steps})
        for name, c in cases.items()]
runs += [("policy_" + p, cases["native"], p, 2) for p in policies]
runs += [("policy_scheduled", cases["native"], kw["schedule"], 2)]
for name, c, policy, steps in runs:
    model = build_model(cfg0.with_(remat=c["remat"]))
    tcfg = TrainStepConfig(dp_mode="fsdp", comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]),
                           use_arena=c["arena"],
                           microbatches=kw["microbatches"], schedule=policy,
                           fsdp_gather=c["gather"],
                           fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])
    with mesh:
        plan = FsdpPlan(model, mesh, tcfg)
        out[f"{{name}}/groups"] = np.array(sorted(plan.groups))
        for g in plan.groups:
            out[f"{{name}}/sizes/{{g}}"] = np.array(plan.plans[g].bucket_sizes)
        if plan.arena_layout is not None:
            out[f"{{name}}/arena"] = np.array(
                [[s.offset, s.size, s.padded]
                 for s in plan.arena_layout.segments])
            out[f"{{name}}/arena_total"] = np.array(
                plan.arena_layout.total_elems)
        state, _ = init_train_state(model, mesh, tcfg, key=jax.random.key(0))
        save_groups(f"{{name}}/init", state["groups"])
        step = build_train_step(model, mesh, tcfg, bspecs)
        losses, norms = [], []
        for s in range(steps):
            if s == steps - 1 and name in cases:
                save_groups(f"{{name}}/pre_last", state["groups"])
                save_groups(f"{{name}}/mu_pre_last", state["opt"]["mu"])
            state, m = step(state, data.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    out[f"{{name}}/loss"] = np.array(losses)
    out[f"{{name}}/gnorm"] = np.array(norms)
    save_groups(f"{{name}}/final", state["groups"])
    save_groups(f"{{name}}/mu", state["opt"]["mu"])
    save_groups(f"{{name}}/nu", state["opt"]["nu"])

# gathered serving at 1 and 2 ranks, fp32 caches
model = build_model(cfg0)
b, s, c = serve["batch"], serve["seq"], serve["cache"]
for world in (1, 2):
    wmesh = Mesh(np.array(jax.devices()[:world]).reshape(world, 1),
                 ("data", "model"))
    with wmesh:
        state, _ = init_train_state(model, wmesh,
                                    TrainStepConfig(dp_mode="fsdp"),
                                    key=jax.random.key(0))
        wp = {{"groups": state["groups"]}}
        save_groups(f"serve{{world}}/groups", state["groups"])
        prefill, _ = build_prefill(model, wmesh,
                                   ShapeConfig("t", s, b, "prefill"),
                                   weight_mode="gathered")
        out[f"serve{{world}}/prefill"] = np.asarray(
            prefill(wp, {{"tokens": jnp.asarray(np.array(serve["tokens"],
                                                          np.int32))}}))
        decode, _, _ = build_decode_step(
            model, wmesh, ShapeConfig("t", c, b, "decode"),
            weight_mode="gathered", donate=False)
        st = init_decode_state(model.cfg, b, c, cache_dtype=jnp.float32)
        for pos, tok in enumerate(serve["decode_tokens"]):
            logits, st = decode(wp, jnp.asarray(np.array(tok, np.int32)),
                                st, jnp.asarray(pos))
            out[f"serve{{world}}/decode/{{pos}}"] = np.asarray(logits)
np.savez({path!r}, **out)
print("FSDP_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    serve = {k: (v.tolist() if isinstance(v, np.ndarray)
                 else [x.tolist() for x in v] if isinstance(v, list) else v)
             for k, v in SERVE_KW.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fsdp.npz")
        assert "FSDP_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, cases=CASES, policies=POLICIES,
                              serve=serve, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


def _params(reference):
    n = len([k for k in reference if k.startswith("params/")])
    return [reference[f"params/{i}"] for i in range(n)]


@pytest.fixture(scope="module")
def ranks(reference):
    at_weights = {case: _groups(reference, f"{case}/pre_last")
                  for case in CASES}
    return run_ranks(jobs.fsdp_job, 2, _params(reference), CASES, STEPS,
                     STEP_KW, POLICIES, SERVE_KW, at_weights)


def _groups(reference, prefix):
    """``{name: [global buckets]}`` saved under ``prefix``."""
    out: dict = {}
    for key in reference:
        if key.startswith(prefix + "/"):
            name, i = key[len(prefix) + 1:].rsplit("/", 1)
            out.setdefault(name, {})[int(i)] = reference[key]
    return {name: [d[i] for i in range(len(d))] for name, d in out.items()}


def _shard(full, rank, world=2):
    n = full.size // world
    return full[rank * n:(rank + 1) * n]


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_plan_equals_reference(reference, ranks, case):
    for out in ranks:
        plan = out["cases"][case]["plan"]
        assert plan["groups"] == list(reference[f"{case}/groups"])
        assert plan["groups"][:3] == ["blocks.0", "blocks.1", "root.embed"]
        for name in plan["groups"]:
            assert plan["sizes"][name] == list(
                reference[f"{case}/sizes/{name}"]), name
        assert sum(len(v) for v in plan["sizes"].values()) > len(
            plan["groups"])                    # several buckets a block
        if CASES[case]["arena"]:
            np.testing.assert_array_equal(plan["arena"],
                                          reference[f"{case}/arena"])
            assert plan["arena_total"] == int(reference[f"{case}/arena_total"])
        else:
            assert "arena" not in plan


def test_fsdp_plan_without_process_groups_matches_the_steps():
    """A plan built without process groups (``connect=False``) lays the
    groups out as the 2-rank steps do: shard sizes half the buckets."""
    model = jobs.fsdp_model()
    plan = FsdpPlan(model, data_mesh(2), jobs.fsdp_step_config(
        STEP_KW, CASES["native_arena"]), connect=False)
    assert plan.dp_world == 2
    for name, bplan in plan.plans.items():
        assert plan.shard_sizes[name] == [n // 2 for n in bplan.bucket_sizes]
    assert plan.arena_layout.n_segments == sum(
        len(v) for v in plan.shard_sizes.values())


@pytest.mark.parametrize("case", ["native", "ring_remat"])
def test_fsdp_initial_shards_bitwise_reference(reference, ranks, case):
    want = _groups(reference, f"{case}/init")
    for r, out in enumerate(ranks):
        got = out["cases"][case]["init"]
        assert sorted(got) == sorted(want)
        for name in want:
            for a, b in zip(got[name], want[name]):
                np.testing.assert_array_equal(a, _shard(b, r),
                                              err_msg=f"rank {r} {name}")


def _bf16(x: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        torch.bfloat16).double().numpy()


def _first_order_loss_gap(reference, ranks, case) -> float:
    """``Σ |g_i| |bf16(w_i) - bf16(w'_i)|`` over every gathered weight:
    ``g`` the reference's unclipped mean gradient of the last step, from
    its moments; ``w`` the port's and ``w'`` the reference's shards
    entering the last step."""
    cfg = OptimConfig(**STEP_KW["optim"])
    mu = _groups(reference, f"{case}/mu")
    mu0 = _groups(reference, f"{case}/mu_pre_last")
    want = _groups(reference, f"{case}/pre_last")
    total = 0.0
    for r, out in enumerate(ranks):
        got = out["cases"][case]["pre_last"]
        for name, fulls in want.items():
            for i, full in enumerate(fulls):
                g = (_shard(mu[name][i], r).astype(np.float64)
                     - cfg.b1 * _shard(mu0[name][i], r)) / (1 - cfg.b1)
                dw = _bf16(got[name][i]) - _bf16(_shard(full, r))
                total += float(np.sum(np.abs(g) * np.abs(dw)))
    gnorm = float(reference[f"{case}/gnorm"][-1])
    return total / min(1.0, cfg.clip_norm / gnorm)


@pytest.mark.parametrize("case", list(CASES))
def test_two_rank_fsdp_trajectory_follows_reference(reference, ranks, case):
    final = _groups(reference, f"{case}/final")
    mus, nus = _groups(reference, f"{case}/mu"), _groups(reference,
                                                         f"{case}/nu")
    first_order = _first_order_loss_gap(reference, ranks, case)
    for r, out in enumerate(ranks):
        got = out["cases"][case]
        what = f"{case} rank {r}"
        want = reference[f"{case}/loss"]
        np.testing.assert_array_equal(got["loss"][:-1], want[:-1],
                                      err_msg=what)
        at_gap = abs(got["loss_at"] - want[-1])
        assert at_gap <= 1e-5, (what, got["loss_at"], want[-1])
        bound = at_gap + 2 * first_order
        assert abs(got["loss"][-1] - want[-1]) <= bound, (
            what, got["loss"][-1], want[-1], at_gap, first_order)
        np.testing.assert_allclose(got["grad_norm"],
                                   reference[f"{case}/gnorm"], rtol=1e-4,
                                   err_msg=what)
        lr = STEP_KW["optim"]["base_lr"]
        beyond = total = 0
        for name in final:
            for i, (p, full) in enumerate(zip(got["groups"][name],
                                              final[name])):
                np.testing.assert_allclose(p, _shard(full, r), atol=2 * lr,
                                           err_msg=f"{what} {name}/{i}")
                beyond += int(np.sum(np.abs(p - _shard(full, r)) > 1e-4))
                total += p.size
            for k, want, tol in (("mu", mus, dict(rtol=2**-7, atol=1e-4)),
                                 ("nu", nus, dict(rtol=2**-6, atol=1e-8))):
                for i, (m, full) in enumerate(zip(got[k][name], want[name])):
                    np.testing.assert_allclose(
                        m, _shard(full, r), **tol,
                        err_msg=f"{what} {k} {name}/{i}")
        assert beyond <= 1e-3 * total, (what, beyond, total)
        assert got["stable"], what
    np.testing.assert_array_equal(ranks[0]["cases"][case]["loss"],
                                  ranks[1]["cases"][case]["loss"])


def test_fsdp_schedule_policies_are_equivalent(reference, ranks):
    for r, out in enumerate(ranks):
        base = out["policies"]["stream"]
        for policy in POLICIES:
            got = out["policies"][policy]
            np.testing.assert_array_equal(got["loss"], base["loss"])
            np.testing.assert_array_equal(got["grad_norm"],
                                          base["grad_norm"])
            for name in base["groups"]:
                for a, b in zip(got["groups"][name], base["groups"][name]):
                    np.testing.assert_array_equal(a, b)
        # and, as the reference's policies among themselves, to the
        # reference's scheduled run
        for policy in POLICIES + ["scheduled"]:
            assert np.all(np.abs(out["policies"]["stream"]["loss"]
                                 - reference[f"policy_{policy}/loss"])
                          <= 1e-5), (r, policy)


@pytest.mark.parametrize("case", list(CASES))
def test_fsdp_wire_equals_prediction(ranks, case):
    for r, out in enumerate(ranks):
        rec = out["cases"][case]["record"]
        pred = out["cases"][case]["predicted"]
        for key, want in pred.items():
            assert rec[key] == want, (case, r, key, rec[key], want)
        if CASES[case]["gather"] == "ring":
            assert rec["sends"] > 0 and rec["all_gathers"] == 0
        else:
            assert rec["sends"] == 0 and rec["reduce_scatters"] > 0


def test_fsdp_prediction_counts_the_remat_regathers(ranks):
    """Under ``remat="layer"`` every block bucket is gathered a second time
    in the backward pass: the sends exceed the no-remat run's by the
    blocks' gather hops exactly."""
    for out in ranks:
        plain = out["cases"]["ring"]["record"]
        remat = out["cases"]["ring_remat"]["record"]
        blocks = [n for name, sizes in out["cases"]["ring"]["plan"][
            "sizes"].items() if name.startswith("blocks.") for n in sizes]
        runs = STEP_KW["microbatches"] * STEPS
        assert remat["sends"] - plain["sends"] == 4 * len(blocks) * runs
        assert remat["send_bytes"] - plain["send_bytes"] == sum(
            n // 2 * 2 for n in blocks) * runs


@pytest.mark.parametrize("impl", ["native", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_flat_gradient_is_the_reduce_scatter_sum(ranks, impl, dtype):
    for r, out in enumerate(ranks):
        got = out["gather_flat"][f"{impl}/{dtype}"]
        assert got == {"gather": True, "gather_dtype": True, "grad": True,
                       "grad_dtype": True}, (r, got)


def test_gathered_prefill_and_decode_one_rank_match_reference(reference):
    model = jobs.fsdp_model()
    treedef = tree_util.flatten(abstract_params(model))[1]
    params = bridge.params_from_numpy(treedef.unflatten(_params(reference)),
                                      "cpu")
    groups = FsdpPlan(model, data_mesh(1), TrainStepConfig(
        dp_mode="fsdp")).shard_state(params)
    want = _groups(reference, "serve1/groups")
    for name in want:
        for a, b in zip(groups[name], want[name]):
            np.testing.assert_array_equal(a.numpy(), b)
    b, s, c = SERVE_KW["batch"], SERVE_KW["seq"], SERVE_KW["cache"]
    prefill = build_prefill(model, ShapeConfig("t", s, b, "prefill"),
                            weight_mode="gathered", device="cpu")
    got = prefill({"groups": groups},
                  {"tokens": torch.from_numpy(SERVE_KW["tokens"])})
    np.testing.assert_allclose(got.numpy(), reference["serve1/prefill"],
                               rtol=1e-4, atol=1e-4)
    decode = build_decode_step(model, ShapeConfig("t", c, b, "decode"),
                               weight_mode="gathered", device="cpu")
    state = init_decode_state(model.cfg, b, c, cache_dtype=torch.float32,
                              device="cpu")
    for pos, tok in enumerate(SERVE_KW["decode_tokens"]):
        got, state = decode({"groups": groups}, torch.from_numpy(tok), state,
                            pos)
        np.testing.assert_allclose(got.numpy(),
                                   reference[f"serve1/decode/{pos}"],
                                   rtol=1e-4, atol=1e-4, err_msg=str(pos))


def test_gathered_prefill_and_decode_two_ranks_match_reference(reference,
                                                                ranks):
    want = _groups(reference, "serve2/groups")
    for r, out in enumerate(ranks):
        got = out["serve"]
        for name in want:
            for a, b in zip(got["groups"][name], want[name]):
                np.testing.assert_array_equal(a, _shard(b, r))
        rows = slice(r, r + 1)                # batch 2 over 2 ranks
        np.testing.assert_allclose(got["prefill"],
                                   reference["serve2/prefill"][rows],
                                   rtol=1e-4, atol=1e-4, err_msg=str(r))
        for pos, logits in enumerate(got["decode"]):
            np.testing.assert_allclose(
                logits, reference[f"serve2/decode/{pos}"][rows], rtol=1e-4,
                atol=1e-4, err_msg=f"rank {r} position {pos}")


def test_fsdp_refuses_an_unknown_gather():
    """``fsdp_gather`` is ``"native"`` or ``"ring"`` (the refusals of a
    codec with the ring gather and of the ring gather over ``psum`` are
    ``test_torch_zero1.py::test_fsdp_still_refuses``'s)."""
    with pytest.raises(ValueError, match="fsdp_gather"):
        TrainStep(jobs.fsdp_model(), data_mesh(1), TrainStepConfig(
            dp_mode="fsdp", fsdp_gather="tree"), device=torch.device("cpu"))
