"""repro_torch ZeRO-1 over the int8 wire against the JAX reference.

Zero1 steps of the reduced llama3.2-1b on 2 gloo ranks with
``wire_codec="int8"``, with the arena (int8 payload, error feedback in the
``"ef"`` state tensor) and without it (int8 ring hops only), each taken by
the port from the reference's state before that step (its parameters, this
rank's moment shards in the reference's layout, rank ``r``'s shard of a
global flat leaf of ``p * n`` elements being ``[r*n, (r+1)*n)``, and this
rank's arena and ``"ef"``, handed over with ``bridge.state_from_numpy``),
against the reference's 2-device zero1 step (one subprocess), for 3 steps.
One microbatch; gradient clipping is off (``clip_norm`` 1e9) so that every
bound below is one of the codec and AdamW alone.

Why the port and the reference do not agree bitwise: the fp32 local
gradients differ in their last bits (autograd and XLA sum in other orders),
and the int8 codec turns such a difference into a different integer
wherever a value lies that close to a rounding boundary
(``test_torch_train_int8.py`` has the same premise).  Zero1 is lossy twice
on the wire: the reduce-scatter's hops carry int8 partial sums, and the
all-gather encodes each rank's parameter *delta* once at its source.

``s`` is the block scale of a rank's first encode of a gradient element
(its compensated local gradient with the arena, its raw local gradient
without), the port's, and ``S = max(s_rank0, s_rank1)``.  An encode moves
its output by at most twice its input's move (the value, and the scale
following its block's absmax) plus one quantum (a flipped rounding).  The
local gradients' own difference ``d`` enters each path at most 3 times;
one more ``S`` covers ``3 d`` up to ``S``.

* loss: rtol 1e-5, as in the fp32 test (same parameters, same batch);
* the reduced gradient shard: without the arena, the owner's raw local
  gradient plus the sender's hop encode of its own (``<= 2 d + S``), halved
  by the mean: ``S / 2`` and ``S``, **1.5 S**.  With it, each rank's pack
  encode (``<= 2 d + s``) and the hop's re-encode of the sender's decoded
  pack (``<= 2 (2 d + s) + s``), halved: ``2 S`` and ``S``, **3 S**.
  AdamW's moments follow: ``|d mu| <= (1 - b1) B`` and ``|d nu| <= (1 -
  b2) B (|g| + |g'|)``, plus two ulps;
* parameters: each side's new parameters are its old ones times ``1 - lr
  wd`` plus the decoded delta, which is within ``(0.5 + 127 * 2^-23)`` of
  the delta's block scale (rounding to the nearest integer, and the
  rounding of a quotient of at most 127) of AdamW of its own new moments,
  evaluated in float64 (to the update's fp32 rounding); the delta's scale
  is the port's (recorded at the all-gather) and, for the reference, that
  of its float64 delta, 1e-3 wider.  So every parameter difference is the
  moments' difference above;
* ``"ef"``: ``comp - q * scale`` moves by one quantum from a flip and by
  the compensated gradient's difference twice: ``1.3 s``; and ``"ef"`` is
  ``comp - decode(encode(comp))`` of the port's compensated local gradient
  bitwise;
* gradient norm: within the Euclidean norm of the per-element bound.

And: the arena and ``"ef"`` keep their storage; the recorded sends and
bytes equal the plan's compressed prediction (one reduce-scatter and one
delta all-gather a step: the plan's all-reduce); both ranks' new
parameters are bitwise equal.
"""

import os
import tempfile

import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_zero1_jobs as jobs
from repro_torch.comm import Communicator
from repro_torch.configs import reduced_config
from repro_torch.models import build_model
from repro_torch.runtime.train_step import abstract_params, data_mesh

STEPS = 3
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=STEPS,
                         clip_norm=1e9),
           "microbatches": 1, "schedule": "accumulate_then_reduce",
           "seq": 32, "batch": 4}
MODES = {"arena": True, "bucket": False}
QUANTA = {"arena": 3.0, "bucket": 1.5}   # the path bounds above, in S

JAX_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_step import (TrainStepConfig, build_train_step,
                                      init_train_state)

kw = {kw!r}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
model = build_model(reduced_config("llama3.2-1b"))
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}


def save(prefix, state):
    for i, l in enumerate(jax.tree.leaves(state["params"])):
        out[f"{{prefix}}/params/{{i}}"] = np.asarray(l)
    for k in ("mu", "nu"):
        for i, l in enumerate(state["opt"][k]):
            out[f"{{prefix}}/{{k}}/{{i}}"] = np.asarray(l)
    out[f"{{prefix}}/step"] = np.asarray(state["step"])
    for k in ("arena", "ef"):
        if k in state:
            out[f"{{prefix}}/{{k}}"] = np.asarray(state[k]).reshape(2, -1)


for mode, arena in (("arena", True), ("bucket", False)):
    tcfg = TrainStepConfig(dp_mode="zero1", comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]), use_arena=arena,
                           microbatches=kw["microbatches"],
                           schedule=kw["schedule"], wire_codec="int8")
    with mesh:
        state, _ = init_train_state(model, mesh, tcfg, key=jax.random.key(0))
        step = build_train_step(model, mesh, tcfg, bspecs)
        save(f"{{mode}}/0", state)
        losses, norms, lrs = [], [], []
        for s in range({steps}):
            state, m = step(state, data.batch_at(s))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
            lrs.append(float(m["lr"]))
            save(f"{{mode}}/{{s + 1}}", state)
    out[f"{{mode}}/loss"] = np.array(losses)
    out[f"{{mode}}/gnorm"] = np.array(norms)
    out[f"{{mode}}/lr"] = np.array(lrs)
np.savez({path!r}, **out)
print("ZERO1_INT8_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "zero1_int8.npz")
        assert "ZERO1_INT8_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


def _leaves(reference, prefix):
    n = len([k for k in reference if k.startswith(prefix)])
    return [reference[f"{prefix}{i}"] for i in range(n)]


def _shard(full, rank):
    n = full.size // 2
    return full[rank * n:(rank + 1) * n]


def _state(reference, mode, k, rank):
    """This rank's reference state after ``k`` steps, as numpy, with the
    moments cut to this rank's shards."""
    pre = f"{mode}/{k}"
    state = {"params": _leaves(reference, f"{pre}/params/"),
             "opt": {n: [_shard(x, rank)
                         for x in _leaves(reference, f"{pre}/{n}/")]
                     for n in ("mu", "nu")},
             "step": reference[f"{pre}/step"]}
    for n in ("arena", "ef"):
        if f"{pre}/{n}" in reference:
            state[n] = reference[f"{pre}/{n}"][rank]
    return state


@pytest.fixture(scope="module")
def ranks(reference):
    handover = [{mode: [_state(reference, mode, k, r) for k in range(STEPS)]
                 for mode in MODES} for r in range(2)]
    return run_ranks(jobs.zero1_int8_job, 2, handover, STEP_KW)


class Layout:
    """The reduced model's bucket plan and int8 arena layout on 2 ranks:
    maps the full vectors of the shards (per bucket, or per span) to the
    parameter leaves."""

    def __init__(self, use_arena: bool):
        cfg = jobs.zero1_step_config(STEP_KW, use_arena, "int8")
        local = abstract_params(build_model(reduced_config("llama3.2-1b")))
        comm = Communicator(data_mesh(2), cfg.comm_config(("pod", "data")),
                            connect=False)
        self.plan = comm.bucketer.plan(local)
        self.layout = comm.arena_layout(local) if use_arena else None
        self.block = comm.cfg.codec_block

    def leaves(self, vectors):
        if self.layout is not None:
            lay, spans = self.layout, vectors
            vectors = [None] * self.plan.n_buckets
            for sp, vec in zip(lay.spans, spans):
                for b in sp.buckets:
                    seg = lay.segment_of(b)
                    off = seg.offset - sp.offset
                    vectors[b] = vec[off:off + seg.size]
        return [vectors[f.bucket][f.offset:f.offset + f.size].reshape(f.shape)
                for f in sorted(self.plan.fields, key=lambda f: f.leaf)]

    def payload(self, span_vectors):
        """Span vectors placed at their payload offsets (the ``"ef"``
        layout)."""
        out = np.zeros(self.layout.payload_elems, np.float32)
        for sp, vec in zip(self.layout.spans, span_vectors):
            out[sp.offset:sp.offset + sp.size] = vec
        return out


def _upd64(mu, nu, t):
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / (1 - B1 ** t)) / (np.sqrt(nu / (1 - B2 ** t)) + EPS)


def _check_params(p_new, p_old, mu, nu, dscale, t, lr, what):
    """``p_new`` is ``p_old (1 - lr wd)`` plus the decoded delta of AdamW
    of ``(mu, nu)``."""
    upd = _upd64(mu, nu, t)
    want = np.asarray(p_old, np.float64) * (1 - lr * WD) - lr * upd
    tol = ((0.5 + 127 * 2.0**-23) * dscale
           + 4 * np.spacing(np.maximum(np.abs(p_old), np.abs(p_new)))
           + 1e-5 * lr * np.abs(upd))
    assert np.all(np.abs(p_new - want) <= tol), what


def _full(per_rank):
    """Full vectors from each rank's shard list."""
    return [np.concatenate(parts) for parts in zip(*per_rank)]


@pytest.mark.parametrize("mode", list(MODES))
def test_zero1_int8_handover_step_follows_reference(reference, ranks, mode):
    lay = Layout(MODES[mode])
    for k in range(STEPS):
        before = [_state(reference, mode, k, r) for r in range(2)]
        after = [_state(reference, mode, k + 1, r) for r in range(2)]
        recs = [out[mode]["handover"][k] for out in ranks]
        lr = float(reference[f"{mode}/lr"][k])
        big_s = [np.maximum(a, b) for a, b in zip(recs[0]["scales"],
                                                  recs[1]["scales"])]
        bound_full = [QUANTA[mode] * s for s in big_s]
        norm_bound = float(np.sqrt(sum(np.sum(b.astype(np.float64) ** 2)
                                       for b in bound_full)))
        for r, rec in enumerate(recs):
            what = f"{mode} step {k} rank {r}"
            np.testing.assert_allclose(rec["loss"],
                                       reference[f"{mode}/loss"][k],
                                       rtol=1e-5, err_msg=what)
            assert rec["lr"] == pytest.approx(lr, rel=1e-6)
            assert rec["step"] == int(after[r]["step"]) == k + 1
            assert abs(rec["grad_norm"] - reference[f"{mode}/gnorm"][k]) \
                <= norm_bound + 1e-5 * rec["grad_norm"], what
            shards = zip(rec["mu"], after[r]["opt"]["mu"], rec["nu"],
                         after[r]["opt"]["nu"], before[r]["opt"]["mu"],
                         bound_full)
            for i, (mu, mu_r, nu, nu_r, mu0, b) in enumerate(shards):
                b = _shard(b, r)
                ulp_mu = 2 * np.spacing(np.maximum(np.abs(mu), np.abs(mu_r)))
                assert np.all(np.abs(mu - mu_r) <= (1 - B1) * b + ulp_mu), \
                    f"{what} mu shard {i}"
                g = np.abs(mu - B1 * mu0) / (1 - B1)
                g_r = np.abs(mu_r - B1 * mu0) / (1 - B1)
                ulp_nu = 2 * np.spacing(np.maximum(nu, nu_r))
                assert np.all(np.abs(nu - nu_r)
                              <= (1 - B2) * b * (g + g_r) * 1.01 + ulp_nu), \
                    f"{what} nu shard {i}"
            if mode == "arena":
                assert rec["ef_identity"], what
                assert np.all(np.abs(rec["ef"] - after[r]["ef"])
                              <= 1.3 * lay.payload(rec["scales"])), \
                    f"{what} ef"
        # parameters: each side's from its own moments and decoded delta
        port_mu = lay.leaves(_full([rec["mu"] for rec in recs]))
        port_nu = lay.leaves(_full([rec["nu"] for rec in recs]))
        port_ds = lay.leaves(_full([rec["delta_scales"] for rec in recs]))
        ref_mu = lay.leaves(_leaves(reference, f"{mode}/{k + 1}/mu/"))
        ref_nu = lay.leaves(_leaves(reference, f"{mode}/{k + 1}/nu/"))
        for r, rec in enumerate(recs):
            for i, (p, p0, mu, nu, ds) in enumerate(zip(
                    rec["params"], before[0]["params"], port_mu, port_nu,
                    port_ds)):
                _check_params(p, p0, mu, nu, ds, k + 1, lr,
                              f"{mode} step {k} rank {r} port leaf {i}")
        ref_delta = [-lr * _upd64(mu, nu, k + 1) for mu, nu in zip(
            _leaves(reference, f"{mode}/{k + 1}/mu/"),
            _leaves(reference, f"{mode}/{k + 1}/nu/"))]
        ref_ds = lay.leaves([
            np.repeat(np.abs(d).reshape(-1, lay.block).max(axis=1), lay.block)
            / 127 * 1.001 for d in ref_delta])
        for i, (p, p0, mu, nu, ds) in enumerate(zip(
                after[0]["params"], before[0]["params"], ref_mu, ref_nu,
                ref_ds)):
            _check_params(p, p0, mu, nu, ds, k + 1, lr,
                          f"{mode} step {k} reference leaf {i}")
        for a, b in zip(recs[0]["params"], recs[1]["params"]):
            np.testing.assert_array_equal(a, b)  # replicas stay identical


@pytest.mark.parametrize("mode", list(MODES))
def test_zero1_int8_storage_and_record_follow_plan(ranks, mode):
    for r, out in enumerate(ranks):
        res = out[mode]
        assert res["stable"], f"{mode} rank {r}"
        rec, pred = res["record"], res["predicted"]
        assert rec["sends"] == pred["sends"], f"{mode} rank {r}"
        assert rec["send_bytes"] == round(pred["send_bytes"]), \
            f"{mode} rank {r}"
        assert rec["all_reduces"] == 2 * STEPS, f"{mode} rank {r}"
