"""repro_torch FSDP over the int8 wire against the JAX reference.

fsdp steps of the reduced llama3.2-1b on 2 gloo ranks with
``wire_codec="int8"``, the arena on (the int8 accumulation buffer and the
fp32 ``"ef"`` error feedback) and the native gather, each taken by the port
from the reference's state before that step (this rank's shards, moments,
arena and ``"ef"``, handed over with ``bridge.state_from_numpy``), against
the reference's 2-device fsdp step (one subprocess), for 3 steps.  One
microbatch, fsdp buckets of 64 KiB; gradient clipping is off (``clip_norm``
1e9) and the weights are gathered in fp32 (``gather_dtype``), so that
every bound below is one of the codec and AdamW alone: with bf16 gathers
the gradients carry bf16 roundings of their own, which
``test_torch_fsdp.py`` bounds.

Under fsdp the gradient reaches the arena already summed over the ranks
(the gathers' backward is the reduce-scatter) and is encoded once, with
error feedback, when the arena packs it; the wire carries no codec.  The
fp32 sums differ between the port and the reference in their last bits
(``d``; autograd and XLA sum in other orders), and the int8 codec turns
such a difference into a different integer wherever a value lies that
close to a rounding boundary.  ``s`` is the block scale of the port's
encode of an element's compensated gradient.  An encode moves its output by
at most twice its input's move (the value, and the scale following its
block's absmax) plus one quantum (a flipped rounding), ``2 d + s``; one
more ``s`` covers ``2 d`` up to ``s``, and the mean halves it: the
gradient is within **1 s**.  So:

* loss: rtol 1e-5, as in the fp32 test (same shards, same batch);
* ``mu``: within ``(1 - b1) s`` plus two ulps; ``nu`` within ``(1 - b2) s
  (|g| + |g'|)``, 1 % wider, plus two ulps (``g``, ``g'`` the two sides'
  gradients, from their ``mu``);
* shards: each side's new shards are its old ones times ``1 - lr wd``
  plus ``-lr`` AdamW of its own new moments, evaluated in float64, within
  four ulps and 1e-5 of the update; so every shard difference is the
  moments' difference above;
* ``"ef"``: ``comp - q * scale`` moves by one quantum from a flip and by
  the compensated gradient's difference twice: ``1.3 s``; and ``"ef"`` is
  ``comp - decode(encode(comp))`` of the port's compensated gradient
  bitwise;
* gradient norm: within the Euclidean norm of the per-element bound.

And: the arena and ``"ef"`` keep their storage; the native gathers and
reduce-scatters equal ``torch_fsdp_jobs.fsdp_prediction``, no point-to-point
message is sent; both ranks' losses are equal.  The ring gather with a
codec is refused, as the reference refuses it.
"""

import os
import tempfile

import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_fsdp_jobs as jobs
from repro_torch.runtime.train_step import (FsdpPlan, TrainStep,
                                            TrainStepConfig, data_mesh)

STEPS = 3
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=STEPS,
                         clip_norm=1e9),
           "microbatches": 1, "schedule": "accumulate_then_reduce",
           "fsdp_bucket_bytes": 64 * 1024, "gather_dtype": "float32",
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
    for key, tree in (("groups", state["groups"]),
                      ("mu", state["opt"]["mu"]),
                      ("nu", state["opt"]["nu"])):
        for name, shards in tree.items():
            for i, s in enumerate(shards):
                out[f"{{prefix}}/{{key}}/{{name}}/{{i}}"] = np.asarray(s)
    out[f"{{prefix}}/step"] = np.asarray(state["step"])
    for k in ("arena", "ef"):
        out[f"{{prefix}}/{{k}}"] = np.asarray(state[k]).reshape(2, -1)


tcfg = TrainStepConfig(dp_mode="fsdp", comm=CommConfig(**kw["comm"]),
                       optim=OptimConfig(**kw["optim"]), use_arena=True,
                       microbatches=kw["microbatches"],
                       schedule=kw["schedule"], wire_codec="int8",
                       fsdp_gather="native",
                       fsdp_bucket_bytes=kw["fsdp_bucket_bytes"],
                       gather_dtype=kw["gather_dtype"])
with mesh:
    state, _ = init_train_state(model, mesh, tcfg, key=jax.random.key(0))
    step = build_train_step(model, mesh, tcfg, bspecs)
    save("0", state)
    losses, norms, lrs = [], [], []
    for s in range({steps}):
        state, m = step(state, data.batch_at(s))
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
        lrs.append(float(m["lr"]))
        save(str(s + 1), state)
out["loss"] = np.array(losses)
out["gnorm"] = np.array(norms)
out["lr"] = np.array(lrs)
np.savez({path!r}, **out)
print("FSDP_INT8_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "fsdp_int8.npz")
        assert "FSDP_INT8_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


def _shard(full, rank):
    n = full.size // 2
    return full[rank * n:(rank + 1) * n]


def _tree(reference, prefix, rank):
    """``{name: [this rank's shards]}`` saved under ``prefix``."""
    out: dict = {}
    for key in reference:
        if key.startswith(prefix + "/"):
            name, i = key[len(prefix) + 1:].rsplit("/", 1)
            out.setdefault(name, {})[int(i)] = _shard(reference[key], rank)
    return {name: [d[i] for i in range(len(d))] for name, d in out.items()}


def _state(reference, k, rank):
    """This rank's reference state after ``k`` steps, as numpy."""
    return {"groups": _tree(reference, f"{k}/groups", rank),
            "opt": {n: _tree(reference, f"{k}/{n}", rank)
                    for n in ("mu", "nu")},
            "step": reference[f"{k}/step"],
            "arena": reference[f"{k}/arena"][rank],
            "ef": reference[f"{k}/ef"][rank]}


@pytest.fixture(scope="module")
def ranks(reference):
    handover = [[_state(reference, k, r) for k in range(STEPS)]
                for r in range(2)]
    return run_ranks(jobs.fsdp_int8_job, 2, handover, STEP_KW)


def _segments(tree: dict, lay) -> list:
    """A ``{name: [shards]}`` tree's shards in the arena's segment order
    (the sorted-name order the gradient tree flattens in)."""
    flat = [s for name in sorted(tree) for s in tree[name]]
    assert len(flat) == lay.n_segments
    return flat


def _upd64(mu, nu, t):
    mu, nu = np.asarray(mu, np.float64), np.asarray(nu, np.float64)
    return (mu / (1 - B1 ** t)) / (np.sqrt(nu / (1 - B2 ** t)) + EPS)


def _check_shards(p_new, p_old, mu, nu, t, lr, what):
    """``p_new`` is ``p_old (1 - lr wd) - lr`` AdamW of ``(mu, nu)``."""
    upd = _upd64(mu, nu, t)
    want = np.asarray(p_old, np.float64) * (1 - lr * WD) - lr * upd
    tol = (4 * np.spacing(np.maximum(np.abs(p_old), np.abs(p_new)))
           + 1e-5 * lr * np.abs(upd))
    assert np.all(np.abs(p_new - want) <= tol), what


def test_fsdp_int8_handover_step_follows_reference(reference, ranks):
    lay = FsdpPlan(jobs.fsdp_model(), data_mesh(2), jobs.fsdp_step_config(
        STEP_KW, {"arena": True, "gather": "native"}, "int8"),
        connect=False).arena_layout
    for k in range(STEPS):
        lr = float(reference["lr"][k])
        norm_bound = float(np.sqrt(sum(
            np.sum(out["handover"][k]["scales"].astype(np.float64) ** 2)
            for out in ranks)))
        for r, out in enumerate(ranks):
            rec = out["handover"][k]
            before, after = _state(reference, k, r), _state(reference, k + 1,
                                                            r)
            what = f"step {k} rank {r}"
            np.testing.assert_allclose(rec["loss"], reference["loss"][k],
                                       rtol=1e-5, err_msg=what)
            assert rec["lr"] == pytest.approx(lr, rel=1e-6)
            assert rec["step"] == int(after["step"]) == k + 1
            assert rec["ef_identity"], what
            assert np.all(np.abs(rec["ef"] - after["ef"])
                          <= 1.3 * rec["scales"]), f"{what} ef"
            # the gradient's bound (1 s), per segment
            bounds = [rec["scales"][seg.offset:seg.offset + seg.size]
                      for seg in lay.segments]
            port = {key: _segments(rec[key], lay) for key in
                    ("groups", "mu", "nu")}
            ref = {"groups": _segments(after["groups"], lay),
                   "mu": _segments(after["opt"]["mu"], lay),
                   "nu": _segments(after["opt"]["nu"], lay)}
            mu0 = _segments(before["opt"]["mu"], lay)
            p0 = _segments(before["groups"], lay)
            for i, b in enumerate(bounds):
                mu, mu_r = port["mu"][i], ref["mu"][i]
                nu, nu_r = port["nu"][i], ref["nu"][i]
                ulp_mu = 2 * np.spacing(np.maximum(np.abs(mu), np.abs(mu_r)))
                assert np.all(np.abs(mu - mu_r) <= (1 - B1) * b + ulp_mu), \
                    f"{what} mu segment {i}"
                g = np.abs(mu - B1 * mu0[i]) / (1 - B1)
                g_r = np.abs(mu_r - B1 * mu0[i]) / (1 - B1)
                ulp_nu = 2 * np.spacing(np.maximum(nu, nu_r))
                assert np.all(np.abs(nu - nu_r)
                              <= (1 - B2) * b * (g + g_r) * 1.01 + ulp_nu), \
                    f"{what} nu segment {i}"
                _check_shards(port["groups"][i], p0[i], mu, nu, k + 1, lr,
                              f"{what} port segment {i}")
                _check_shards(ref["groups"][i], p0[i], mu_r, nu_r, k + 1, lr,
                              f"{what} reference segment {i}")
            assert abs(rec["grad_norm"] - reference["gnorm"][k]) \
                <= norm_bound + 1e-5 * rec["grad_norm"], what
        assert ranks[0]["handover"][k]["loss"] == \
            ranks[1]["handover"][k]["loss"]


def test_fsdp_int8_storage_and_record_follow_plan(ranks):
    for r, out in enumerate(ranks):
        assert out["stable"], r
        rec, pred = out["record"], out["predicted"]
        for key, want in pred.items():
            assert rec[key] == want, (r, key, rec[key], want)
        assert rec["sends"] == 0 and rec["all_gathers"] > 0


def test_fsdp_ring_gather_refuses_a_wire_codec():
    """The ring gather's backward is the fsdp reduction and carries no
    codec, so a codec with it is refused, by the config and by the step
    (the reference's ``ValueError`` naming ``fsdp_gather``)."""
    cfg = TrainStepConfig(dp_mode="fsdp", fsdp_gather="ring",
                          wire_codec="int8")
    with pytest.raises(ValueError, match="fsdp_gather"):
        cfg.comm_config(("data",))
    with pytest.raises(ValueError, match="fsdp_gather"):
        TrainStep(jobs.fsdp_model(), data_mesh(1), cfg,
                  device=torch.device("cpu"))
    # the native gather takes it: the arena is int8 and "ef" follows
    step = TrainStep(jobs.fsdp_model(), data_mesh(1), TrainStepConfig(
        dp_mode="fsdp", wire_codec="int8", use_arena=True),
        device=torch.device("cpu"))
    assert step.arena.layout.payload.dtype == torch.int8
