"""repro_torch training over the int8 wire against the JAX reference.

The replicated train loop of the reduced llama3.2-1b on 2 gloo ranks with
``wire_codec="int8"``, with the arena (int8 payload, error feedback in the
``"ef"`` state tensor) and without it (int8 ring hops only), against the
reference's 2-device step (one subprocess), for 3 steps from the same
initial state.  Gradient clipping is off (``clip_norm`` 1e9) so that every
bound below is one of the codec and AdamW alone; the fp32 trajectory test
covers clipping.

Why the port and the reference do not agree bitwise: autograd and XLA sum
the same terms in other orders, so the local gradients differ in their last
bits (the fp32 test holds them to 1e-4), and the int8 codec turns such a
difference into a different integer wherever a value lies that close to a
rounding boundary.  The int8 reduction itself is bitwise the reference's
from the same local gradients (``test_torch_ring_int8.py``).  So each
quantity here is held to what the flipped quanta can do to it, with no
share of elements exempted.  ``s`` is the block scale of a rank's first
encode of an element (its compensated local gradient with the arena, its
raw local gradient without), the port's, and ``S = max(s_rank0, s_rank1)``.

Handover (step ``k`` taken by the port from the reference's state before
step ``k``, handed over with ``bridge.state_from_numpy``):

* loss: rtol 1e-5, as in the fp32 test (same parameters, same batch);
* reduced gradient: every lossy encode on an element's path moves it by at
  most its own input's move, one quantum from a flipped rounding and one
  from its scale following its block's absmax.  Without the arena the path
  is the sender's hop encode (scale <= S) and the all-gather's encode of
  the sum (scale <= 2 S), halved by the mean: ``2 S``.  With it, each
  rank's pack (S each), the hop's re-encode of the sender's decoded pack
  (<= S), the all-gather's encode (<= 2 S) and the re-encode of the mean
  (<= S) give ``11 S``.  One more ``S`` covers the local gradients' own
  difference up to 1e-3 of their block's absmax.  AdamW's moments follow:
  ``|d mu| <= (1 - b1) B`` and ``|d nu| <= (1 - b2) B (|g| + |g'|)``, plus
  two ulps;
* parameters: each side's new parameters are AdamW of its own new moments,
  in float64, to the update's fp32 rounding (so every parameter difference
  is the moments' difference above);
* ``"ef"``: ``comp - q * scale`` moves by one quantum from a flip and by
  the compensated gradient's difference twice: ``1.3 s``;
* gradient norm: within the Euclidean norm of the per-element bound.

Free run (3 steps, no handover):

* the first loss: rtol 1e-5;
* loss ``k``: the reference's own loss function at the port's parameters
  after step ``k - 1``, rtol 1e-5 (a loss is a function of the parameters
  and the batch);
* parameters: an AdamW step moves an element by at most ``lr * U_t``,
  ``U_t`` the Cauchy-Schwarz bound of ``|m_hat| / sqrt(v_hat)`` at step
  ``t``, whatever the gradient; a flipped quantum can turn a gradient of 0
  into a full step, so the bound is ``2 sum_t lr_t U_t``, loose by nature;
  the handover holds the tight part;
* ``"ef"`` is ``comp - decode(encode(comp))`` bitwise and within half a
  quantum of 0 (and the rounding of a quotient of at most 127); the arena and ``"ef"`` keep their storage; the recorded
  sends and bytes equal the plan's compressed prediction; the two replicas
  stay bitwise equal.
"""

import os
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_int8_jobs as jobs
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model

STEPS = 3
LR = 1e-2
B1, B2, EPS, WD = 0.9, 0.95, 1e-8, 0.1
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "optim": dict(base_lr=LR, warmup=1, total_steps=STEPS,
                         clip_norm=1e9),
           "seq": 32, "batch": 4}
MODES = {"arena": True, "bucket": False}
QUANTA = {"arena": 12, "bucket": 3}       # the path bounds above, in S

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
        for i, l in enumerate(jax.tree.leaves(state["opt"][k])):
            out[f"{{prefix}}/{{k}}/{{i}}"] = np.asarray(l)
    out[f"{{prefix}}/step"] = np.asarray(state["step"])
    for k in ("arena", "ef"):
        if k in state:
            out[f"{{prefix}}/{{k}}"] = np.asarray(state[k]).reshape(2, -1)


for mode, arena in (("arena", True), ("bucket", False)):
    tcfg = TrainStepConfig(dp_mode="replicated",
                           comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]), use_arena=arena,
                           wire_codec="int8")
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
print("TRAIN_INT8_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train_int8.npz")
        assert "TRAIN_INT8_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


def _leaves(reference, prefix):
    n = len([k for k in reference if k.startswith(prefix)])
    return [reference[f"{prefix}{i}"] for i in range(n)]


def _state(reference, mode, k, rank):
    """This rank's reference state after ``k`` steps, as numpy."""
    pre = f"{mode}/{k}"
    state = {"params": _leaves(reference, f"{pre}/params/"),
             "opt": {n: _leaves(reference, f"{pre}/{n}/")
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
    return run_ranks(jobs.train_int8_job, 2,
                     _leaves(reference, "arena/0/params/"), STEPS, STEP_KW,
                     handover)


def _adamw_params(p_old, mu, nu, t, lr):
    """AdamW's new parameters from the new moments, in float64."""
    p_old, mu, nu = (np.asarray(a, np.float64) for a in (p_old, mu, nu))
    upd = (mu / (1 - B1 ** t)) / (np.sqrt(nu / (1 - B2 ** t)) + EPS)
    return p_old * (1 - lr * WD) - lr * upd, lr * np.abs(upd)


def _check_adamw(p_new, p_old, mu, nu, t, lr, what):
    want, step = _adamw_params(p_old, mu, nu, t, lr)
    tol = (4 * np.spacing(np.maximum(np.abs(p_old), np.abs(p_new)))
           + 1e-5 * step)
    assert np.all(np.abs(p_new - want) <= tol), what


def _adam_bound(t):
    """Cauchy-Schwarz bound of ``|m_hat| / sqrt(v_hat)`` after ``t``
    steps, whatever the gradients."""
    i = np.arange(1, t + 1)
    w = (1 - B1) * B1 ** (t - i) / (1 - B1 ** t)
    om = (1 - B2) * B2 ** (t - i) / (1 - B2 ** t)
    return float(np.sqrt(np.sum(w * w / om)))


@pytest.mark.parametrize("mode", list(MODES))
def test_int8_handover_step_follows_reference(reference, ranks, mode):
    """Each step taken by the port from the reference's state before it."""
    for k in range(STEPS):
        before = _state(reference, mode, k, 0)
        after = [_state(reference, mode, k + 1, r) for r in range(2)]
        recs = [out[mode]["handover"][k] for out in ranks]
        lr = float(reference[f"{mode}/lr"][k])
        # the element bound, from both ranks' first-encode scales
        big_s = [np.maximum(a, b) for a, b in zip(recs[0]["scales"],
                                                  recs[1]["scales"])]
        bound = [QUANTA[mode] * s for s in big_s]
        norm_bound = float(np.sqrt(sum(np.sum(b.astype(np.float64) ** 2)
                                       for b in bound)))
        for r, rec in enumerate(recs):
            what = f"{mode} step {k} rank {r}"
            np.testing.assert_allclose(rec["loss"],
                                       reference[f"{mode}/loss"][k],
                                       rtol=1e-5, err_msg=what)
            assert rec["lr"] == pytest.approx(lr, rel=1e-6)
            assert rec["step"] == int(after[r]["step"]) == k + 1
            assert abs(rec["grad_norm"] - reference[f"{mode}/gnorm"][k]) \
                <= norm_bound + 1e-5 * rec["grad_norm"], what
            leaves = zip(rec["mu"], after[r]["opt"]["mu"], rec["nu"],
                         after[r]["opt"]["nu"], before["opt"]["mu"], bound)
            for i, (mu, mu_r, nu, nu_r, mu0, b) in enumerate(leaves):
                ulp_mu = 2 * np.spacing(np.maximum(np.abs(mu), np.abs(mu_r)))
                assert np.all(np.abs(mu - mu_r) <= (1 - B1) * b + ulp_mu), \
                    f"{what} mu leaf {i}"
                g = np.abs(mu - B1 * mu0) / (1 - B1)
                g_r = np.abs(mu_r - B1 * mu0) / (1 - B1)
                ulp_nu = 2 * np.spacing(np.maximum(nu, nu_r))
                assert np.all(np.abs(nu - nu_r)
                              <= (1 - B2) * b * (g + g_r) * 1.01 + ulp_nu), \
                    f"{what} nu leaf {i}"
            for i, (p, p0, mu, nu) in enumerate(zip(
                    rec["params"], before["params"], rec["mu"], rec["nu"])):
                _check_adamw(p, p0, mu, nu, k + 1, lr,
                             f"{what} port params leaf {i}")
            for i, (p, p0, mu, nu) in enumerate(zip(
                    after[r]["params"], before["params"],
                    after[r]["opt"]["mu"], after[r]["opt"]["nu"])):
                _check_adamw(p, p0, mu, nu, k + 1, lr,
                             f"{what} reference params leaf {i}")
            if mode == "arena":
                assert rec["ef_identity"], what
                assert np.all(np.abs(rec["ef"] - after[r]["ef"])
                              <= 1.3 * rec["ef_scales"]), f"{what} ef"


def test_int8_free_run_follows_reference(reference, ranks):
    jmodel = jax_build_model(jax_reduced_config("llama3.2-1b"))
    data = JaxSyntheticTokens(JaxDataConfig(
        vocab_size=jmodel.cfg.vocab_size, seq_len=STEP_KW["seq"],
        global_batch=STEP_KW["batch"]))
    treedef = jax.tree.structure(jmodel.abstract_params())
    loss_fn = jax.jit(jmodel.loss_fn)
    for mode in MODES:
        lrs = reference[f"{mode}/lr"]
        for r, out in enumerate(ranks):
            res = out[mode]
            free = res["free"]
            what = f"{mode} rank {r}"
            np.testing.assert_allclose(free[0]["loss"],
                                       reference[f"{mode}/loss"][0],
                                       rtol=1e-5, err_msg=what)
            bound = 0.0
            for k, rec in enumerate(free):
                bound += 2 * float(lrs[k]) * _adam_bound(k + 1)
                want = _leaves(reference, f"{mode}/{k + 1}/params/")
                for i, (p, w) in enumerate(zip(rec["params"], want)):
                    assert np.all(np.abs(p - w) <= bound + 1e-6), \
                        f"{what} step {k} leaf {i}"
                if k + 1 < STEPS:
                    # the next loss at the port's own parameters
                    params = jax.tree.unflatten(
                        treedef, [jnp.asarray(p) for p in rec["params"]])
                    want_loss = float(loss_fn(params, data.batch_at(k + 1)))
                    np.testing.assert_allclose(free[k + 1]["loss"],
                                               want_loss, rtol=1e-5,
                                               err_msg=f"{what} loss {k + 1}")
                if mode == "arena":
                    assert rec["ef_identity"], f"{what} step {k}"
                    # half a quantum, and the rounding of x / scale,
                    # whose quotient is at most 127 (127 ulps of 1)
                    assert np.all(np.abs(rec["ef"]) <= (0.5 + 127 * 2.0**-23)
                                  * rec["ef_scales"]), \
                        f"{what} step {k} ef"
            assert res["stable"], what
            rec_, pred = res["record"], res["predicted"]
            assert rec_["sends"] == pred["sends"], what
            assert rec_["send_bytes"] == round(pred["send_bytes"]), what
        for a, b in zip(ranks[0][mode]["free"][-1]["params"],
                        ranks[1][mode]["free"][-1]["params"]):
            np.testing.assert_array_equal(a, b)  # replicas stay identical
