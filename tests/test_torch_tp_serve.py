"""repro_torch tensor-parallel serving against the JAX reference.

Reduced llama3.2-1b (fp32), parameters from the reference's
``Model.init(key(0))``, on a (1, 2) ``("data", "model")`` mesh: two gloo
ranks against the reference's ``build_prefill`` / ``build_decode_step``
on 2 host devices (one subprocess, run beside the ranks).

* **Resident prefill** (weights model-sharded, the vocab shards
  gathered), with the ``flash_attn`` route (its plain version on the CPU)
  and the blockwise route, within rtol/atol 1e-4 of the reference's (the
  fp32 bound of ``test_torch_prefill.py``).  The padded-head rank: the
  reduced config pads 4 query heads to 16, so rank 1 holds only padded
  heads; it calls ``flash_attention`` no time, rank 0 once a layer with its
  4 real heads.
* **Contiguous decode** from the same tokens, greedy, against the
  reference's step by step within 1e-4, tokens equal: at an 8-slot cache
  over 12 positions (the rolling write wraps) and at 8192 slots, which
  ``decode_state_specs`` sequence-shards over the model axis (4096 slots a
  rank).
* **Rank 1 holding real heads** (16 q / 4 kv heads, so that rank 1's q
  heads 8-15 read kv heads 2-3): the resident prefill (each rank calling
  ``flash_attention`` with its 8 heads) and the decode at the 8-slot
  cache within 1e-4 of the reference's; the sequence-sharded decode
  within 1e-4 of the same decode on one rank.  The reference's
  sequence-sharded branch combines the ranks' local heads index by index,
  which pairs global head ``j`` with head ``8 + j``: its logits there
  move more than 1e-3 off its own one-device decode (the subprocess's
  ``ref_seq_sharded_err``), so it is not the port's oracle there.
* **The paged engine at R = 2** (page-parallel decode, weights replicated)
  against the port's R = 1 engine on one trace whose longest request
  crosses into rank 1's pages: every step's logits within rtol/atol 1e-4
  and the same generated tokens; the collectives a decode step equal to
  ``predicted_collectives_per_token`` (2 a layer) and the recorded bytes,
  scaled by the ring's ``2(R-1)/R``, to ``predicted_wire_bytes_per_token``
  (both re-derived here from ``src/repro/serve/engine.py:58-78`` and held
  against the reference's functions on the same plan); one flash-decode
  call a layer a step on each rank.
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

from conftest import SRC
from torch_dist_util import run_ranks
import torch_tp_jobs as jobs
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.serve import engine as ref_engine
from repro_torch.configs import reduced_config

B, S = 2, 16
DECODE = {"short": 8, "long": 8192, "steps": 12}
ENGINE_KW = {"plan": dict(page_tokens=4, page_bytes=4096, max_seqs=4,
                          max_seq_len=32),
             "trace": dict(groups=1, slots=4, long_len=24, short_len=3,
                           prompt_len=1)}
TOL = dict(rtol=1e-4, atol=1e-4)

JAX_SCRIPT = r"""
import dataclasses
import numpy as np
import jax, jax.numpy as jnp
from repro import compat
from repro.configs import reduced_config, base
from repro.models import build_model
import repro.models.transformer as T
from repro.runtime.serve_step import build_decode_step, build_prefill
from repro.sharding import shardings_of

mesh = compat.make_mesh((1, 2), ("data", "model"))
m = build_model(reduced_config("llama3.2-1b"))
params = m.init(jax.random.key(0))
inp = dict(np.load({inp!r}))
out = {{}}
pre, pspecs = build_prefill(m, mesh, base.ShapeConfig("p", {s}, {b},
                                                      "prefill"))
with mesh:
    pd = jax.jit(lambda p: p, out_shardings=shardings_of(pspecs, mesh))(
        params)
    out["prefill"] = np.asarray(pre(pd, {{"tokens": jnp.asarray(
        inp["tokens"])}}))


def loop(model, params, cache, steps, tok):
    shape = base.ShapeConfig("t", cache, tok.shape[0], "decode")
    step, pspecs, sspecs = build_decode_step(model, mesh, shape)
    logits = []
    with mesh:
        pd = jax.jit(lambda p: p,
                     out_shardings=shardings_of(pspecs, mesh))(params)
        st = T.init_decode_state(model.cfg, tok.shape[0], cache,
                                 cache_dtype=jnp.float32)
        st = jax.jit(lambda s: s,
                     out_shardings=shardings_of(sspecs, mesh))(st)
        tok = jnp.asarray(tok)
        for pos in range(steps):
            lg, st = step(pd, tok, st, jnp.asarray(pos))
            logits.append(np.asarray(lg))
            tok = jnp.argmax(lg, -1).astype(jnp.int32)
    return np.stack(logits)


for key in ("short", "long"):
    out[key] = loop(m, params, {decode}[key], {decode}["steps"],
                    inp["dtokens"])
# rank 1 holding real heads: the prefill and the unsharded-cache decode
# (the port's oracle there), and the reference's sequence-sharded decode
# against its own one-device decode
cfg = reduced_config("llama3.2-1b")
bm = build_model(cfg.with_(attn=dataclasses.replace(cfg.attn, num_heads=16,
                                                    num_kv_heads=4)))
bp = bm.init(jax.random.key(1))
pre, pspecs = build_prefill(bm, mesh, base.ShapeConfig("p", {s}, {b},
                                                       "prefill"))
with mesh:
    pd = jax.jit(lambda p: p, out_shardings=shardings_of(pspecs, mesh))(bp)
    out["big_prefill"] = np.asarray(pre(pd, {{"tokens": jnp.asarray(
        inp["tokens"])}}))
out["big_short"] = loop(bm, bp, {decode}["short"], {decode}["steps"],
                        inp["dtokens"])
tp = loop(bm, bp, 8192, 1, inp["dtokens"])[0]
one, _ = bm.decode_step(bp, jnp.asarray(inp["dtokens"]),
                        T.init_decode_state(bm.cfg, {b}, 8192,
                                            cache_dtype=jnp.float32),
                        jnp.asarray(0), seq_len=8192)
out["ref_seq_sharded_err"] = np.array(
    float(np.max(np.abs(tp - np.asarray(one)))))
np.savez({path!r}, **out)
print("TP_SERVE_REF_OK")
"""


@pytest.fixture(scope="module")
def run():
    jmodel = jax_build_model(jax_reduced_config("llama3.2-1b"))
    leaves = [np.asarray(l) for l in
              jax.tree.leaves(jmodel.init(jax.random.key(0)))]
    cfg = jax_reduced_config("llama3.2-1b")
    bmodel = jax_build_model(cfg.with_(attn=dataclasses.replace(
        cfg.attn, num_heads=16, num_kv_heads=4)))
    big_leaves = [np.asarray(l) for l in
                  jax.tree.leaves(bmodel.init(jax.random.key(1)))]
    rng = np.random.RandomState(4)
    tokens = rng.randint(0, 500, (B, S)).astype(np.int32)
    dtokens = rng.randint(0, 500, (B,)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        inp = os.path.join(tmp, "inp.npz")
        np.savez(inp, tokens=tokens, dtokens=dtokens)
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                inp=inp, s=S, b=B, decode=DECODE, path=path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(jobs.tp_serve_job, 2, leaves, big_leaves,
                              tokens, dict(DECODE, tokens=dtokens),
                              ENGINE_KW)
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "TP_SERVE_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


@pytest.mark.parametrize("impl", ["kernel", "blockwise"])
def test_resident_prefill_matches_reference(run, impl):
    v = reduced_config("llama3.2-1b").vocab_size
    for out in run["ranks"]:
        assert out[f"prefill_local_{impl}"][-1] == v // 2
        np.testing.assert_allclose(out[f"prefill_{impl}"],
                                   run["ref"]["prefill"], **TOL)


def test_padded_head_rank_launches_no_kernel(run):
    r0, r1 = run["ranks"]
    # the bridge's blocks of the reference's tree are resident_params'
    assert r0["resident_is_local"] and r1["resident_is_local"]
    assert r0["flash_attn_calls"] == [4, 4]     # 4 real heads, 2 layers
    assert r1["flash_attn_calls"] == []         # only padded heads


@pytest.mark.parametrize("key", ["short", "long"])
def test_contiguous_decode_matches_reference(run, key):
    want = run["ref"][key]
    c_local = DECODE[key] // 2 if DECODE[key] >= 8192 else DECODE[key]
    for out in run["ranks"]:
        assert all(sh == (B, 2, c_local, 16) for sh in out[f"state_{key}"])
        got = np.stack(out[f"decode_{key}"])
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_real_heads_on_rank_one_match_reference(run):
    """16 q / 4 kv heads: model rank 1 holds global q heads 8-15, which
    read kv heads 2-3.  The resident prefill (kernel route) and the decode
    at the 8-slot cache within 1e-4 of the reference's at (1, 2); each
    rank calls ``flash_attention`` once a layer with its 8 real heads."""
    for out in run["ranks"]:
        assert out["big_flash_attn_calls"] == [8, 8]
        np.testing.assert_allclose(out["big_prefill"],
                                   run["ref"]["big_prefill"], **TOL)
        got, want = np.stack(out["big_short"]), run["ref"]["big_short"]
        np.testing.assert_allclose(got, want, **TOL)
        np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


def test_seq_sharded_decode_with_real_heads_on_rank_one(run):
    for out in run["ranks"]:
        np.testing.assert_allclose(np.stack(out["big_tp"]),
                                   np.stack(out["big_one"]), **TOL)
    # the reference's sequence-sharded branch pairs head j with head 8 + j
    # here; its logits are off its own one-device decode
    assert float(run["ref"]["ref_seq_sharded_err"]) > 1e-3


def test_paged_engine_r2_matches_r1(run):
    for out in run["ranks"]:
        e1, e2 = out["engine"][1], out["engine"][2]
        assert len(e1["logits"]) == len(e2["logits"]) > 16
        for a, b in zip(e2["logits"], e1["logits"]):
            np.testing.assert_allclose(a, b, **TOL)
        assert e2["generated"] == e1["generated"]
    r0, r1 = (o["engine"][2]["logits"] for o in run["ranks"])
    for a, b in zip(r0, r1):
        np.testing.assert_array_equal(a, b)     # every rank, the same


def test_paged_engine_collectives_equal_prediction(run):
    cfg = reduced_config("llama3.2-1b")
    for out in run["ranks"]:
        e2 = out["engine"][2]
        n_layers, batch, head_dim, bpr, max_blocks = e2["plan"]
        assert bpr * 2 == max_blocks
        hq = 16                                  # 4 heads padded to 16
        r = 2
        # src/repro/serve/engine.py:58-78: a pmax and one fused stats
        # all-reduce a layer; fp32 max (B*Hq) + numerator and denominator
        # (B*Hq*(D+1)) a layer, times the ring's 2(R-1)/R
        collectives = 2 * n_layers
        wire = n_layers * (batch * hq + batch * hq * (head_dim + 1)) * 4 \
            * 2.0 * (r - 1) / r
        stand_in = SimpleNamespace(model_parallel=r, n_layers=n_layers,
                                   head_dim=head_dim)
        assert ref_engine.predicted_collectives_per_token(stand_in) == \
            collectives == e2["predicted_collectives"]
        assert ref_engine.predicted_wire_bytes_per_token(
            stand_in, jax_reduced_config("llama3.2-1b"), batch) == wire \
            == e2["predicted_bytes"]
        for st in e2["steps"]:
            rec = st["record"]
            assert rec["all_reduces"] == collectives
            assert rec["all_reduce_bytes"] * 2.0 * (r - 1) / r == wire
            assert rec["sends"] == 0
            assert st["calls"] == n_layers       # one flash-decode a layer
        assert all(st["record"] is None and st["calls"] == n_layers
                   for st in out["engine"][1]["steps"])
        assert cfg.attn.head_dim == head_dim
