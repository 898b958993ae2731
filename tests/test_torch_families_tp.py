"""The remaining families on a model axis: reduced hymba-1.5b (attention
and SSM shards) and reduced whisper-base (cross-attention shards) on a
(1, 2) ``("data", "model")`` mesh of two gloo ranks, against the
reference's ``build_train_step`` on 2 host devices on the same mesh (one
subprocess, run beside the ranks, which run beside the reference's
one-device serving).

* Training from the reference's ``Model.init(key(7))``, ``ring_hier`` at
  chunks 2 over 2 channels, 2 steps: hymba in ``zero1`` with the arena
  and in ``fsdp``, whisper in ``replicated`` over 2 microbatches (the
  frames split with the tokens; ``fsdp`` stays refused for it).  Per-step
  loss within 5e-5 absolute and the gradient norm within rtol 1e-4 of the
  reference's; the final parameters, put together from both ranks'
  blocks, within 5e-5 of the reference's (outside fsdp, whose state is
  flat shards).  Under TP hymba's ``d_inner`` (128) splits 64 / 64:
  ``x_proj``'s psum and the scan's fan-out are on the path.
* Serving on the same mesh: hymba's prefill on the kernel route and 6
  contiguous decode steps (the SSM state split over the model axis),
  whisper's decode from a state its encoder made on the mesh (cross k/v
  for the rank's query heads gathered), the vocab shards gathered, within
  rtol / atol 1e-4 of the reference's one-device ``forward`` and
  ``decode_step``.
"""

import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch_families_jobs as jobs
from conftest import SRC
from torch_dist_util import run_ranks
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
from repro_torch import tree as tree_util
from repro_torch.bridge import global_params_to_numpy
from repro_torch.configs import reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.models import build_model

ARCHS = ("hymba-1.5b", "whisper-base")
STEPS = 2
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192)}
CASES = {"hymba_zero1_arena": dict(arch=ARCHS[0], mode="zero1", arena=True,
                                   microbatches=1),
         "hymba_fsdp": dict(arch=ARCHS[0], mode="fsdp", arena=False,
                            microbatches=1),
         "whisper_replicated": dict(arch=ARCHS[1], mode="replicated",
                                    arena=False, microbatches=2)}
B, S, CACHE, TOKENS = 4, 24, 8, 6
MESH = RankMesh(("data", "model"), (1, 2))

JAX_SCRIPT = r"""
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
out = {{}}
for name, c in cases.items():
    batch = dict(np.load({batches!r}.format(c["arch"])))
    bspecs = {{k: P("data", *([None] * (v.ndim - 1)))
              for k, v in batch.items()}}
    m = build_model(reduced_config(c["arch"]))
    tcfg = TrainStepConfig(dp_mode=c["mode"], comm=CommConfig(**kw["comm"]),
                           microbatches=c["microbatches"],
                           use_arena=c["arena"])
    with mesh:
        state, _ = init_train_state(m, mesh, tcfg, key=jax.random.key(7))
        step = build_train_step(m, mesh, tcfg, bspecs)
        losses, norms = [], []
        for s in range({steps}):
            state, met = step(state, batch)
            losses.append(float(met["loss"]))
            norms.append(float(met["grad_norm"]))
    out[f"{{name}}/loss"] = np.array(losses)
    out[f"{{name}}/gnorm"] = np.array(norms)
    if c["mode"] != "fsdp":
        for i, l in enumerate(jax.tree.leaves(state["params"])):
            out[f"{{name}}/final/{{i}}"] = np.asarray(l)
np.savez({path!r}, **out)
print("FAMILIES_TP_REF_OK")
"""


def _batches() -> dict:
    rng = np.random.RandomState(0)
    out = {}
    for arch in ARCHS:
        cfg = reduced_config(arch)
        b = {"tokens": rng.randint(0, 500, (B, S)).astype(np.int32),
             "labels": rng.randint(0, 500, (B, S)).astype(np.int32)}
        if cfg.enc_seq:
            b["frames"] = (rng.randn(B, cfg.enc_seq, cfg.d_model) * 0.5
                           ).astype(np.float32)
        out[arch] = b
    return out


def _serve_reference(arch, jparams, batch, tokens) -> dict:
    """The reference's one-device prefill logits (hymba) and decode
    logits from an empty state (whisper's: from its frames), fp32."""
    jmodel = jax_build_model(jax_reduced_config(arch))
    out = {}
    if "frames" in batch:
        state = jax_encdec.init_decode_state(
            jparams, jnp.asarray(batch["frames"]), jmodel.cfg, B, CACHE,
            cache_dtype=jnp.float32)
    else:
        out["prefill"] = np.asarray(jax.jit(lambda p: jmodel.forward(
            p, {"tokens": batch["tokens"]}))(jparams))
        state = jax_init_decode_state(jmodel.cfg, B, CACHE,
                                      cache_dtype=jnp.float32)
    step = jax.jit(lambda p, t, s, pos: jmodel.decode_step(
        p, t, s, pos, seq_len=CACHE))
    logits = []
    for pos, tok in enumerate(tokens):
        got, state = step(jparams, jnp.asarray(tok), state, jnp.asarray(pos))
        logits.append(np.asarray(got))
    out["decode"] = np.stack(logits)
    return out


@pytest.fixture(scope="module")
def run():
    batches = _batches()
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 500, (TOKENS, B)).astype(np.int32)
    with tempfile.TemporaryDirectory() as tmp:
        bpath = os.path.join(tmp, "batch_{}.npz")
        for arch, b in batches.items():
            np.savez(bpath.format(arch), **b)
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                kw=STEP_KW, cases=CASES, batches=bpath, steps=STEPS,
                path=path)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        try:
            params = {arch: jax_build_model(jax_reduced_config(arch)).init(
                jax.random.key(7)) for arch in ARCHS}
            leaves = {arch: [np.asarray(l) for l in jax.tree.leaves(p)]
                      for arch, p in params.items()}
            serve = {arch: {"batch": batches[arch], "cache": CACHE,
                            "tokens": tokens} for arch in ARCHS}
            serve[ARCHS[0]]["prefill"] = True
            # the ranks in a thread, beside the reference's serving here
            with ThreadPoolExecutor(1) as pool:
                ranks = pool.submit(run_ranks, jobs.families_tp_job, 2,
                                    leaves, batches, CASES, STEPS, STEP_KW,
                                    serve)
                serve_ref = {arch: _serve_reference(arch, params[arch],
                                                    batches[arch], tokens)
                             for arch in ARCHS}
                ranks = ranks.result()
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "FAMILIES_TP_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref, "serve_ref": serve_ref}


@pytest.mark.parametrize("case", list(CASES))
def test_steps_follow_the_references_two_device_run(run, case):
    ref = run["ref"]
    outs = [r[case] for r in run["ranks"]]
    assert [o["model_index"] for o in outs] == [0, 1]
    for o in outs:
        np.testing.assert_allclose(o["loss"], ref[f"{case}/loss"], rtol=0,
                                   atol=5e-5)
        np.testing.assert_allclose(o["grad_norm"], ref[f"{case}/gnorm"],
                                   rtol=1e-4)
    if CASES[case]["mode"] == "fsdp":
        return
    model = build_model(reduced_config(CASES[case]["arch"]))
    final = tree_util.leaves(global_params_to_numpy(
        [o["params"] for o in outs], model.param_specs(MESH), MESH))
    n = len([k for k in ref if k.startswith(f"{case}/final/")])
    assert len(final) == n
    for i, got in enumerate(final):
        np.testing.assert_allclose(got, ref[f"{case}/final/{i}"], rtol=0,
                                   atol=5e-5, err_msg=f"leaf {i}")


def test_ssm_and_cross_attention_shard_over_the_model_axis():
    """What the two ranks hold: half of hymba's ``d_inner`` in every SSM
    leaf that carries it, whisper's cross-attention query heads split and
    its kv projections replicated."""
    hymba = build_model(reduced_config(ARCHS[0])).param_specs(MESH)
    ssm = hymba["blocks"][0]["ssm"]
    assert ssm["in_proj_x"]["w"] == (None, "model")
    assert ssm["x_proj"]["w"] == ("model", None)
    assert ssm["conv_w"] == (None, "model") and ssm["a_log"] == ("model",
                                                                None)
    assert ssm["dt_proj"]["b"] == ("model",)
    whisper = build_model(reduced_config(ARCHS[1])).param_specs(MESH)
    cross = whisper["dec_blocks"][0]["cross_attn"]
    assert cross["wq"]["w"] == (None, "model")
    assert cross["wk"]["w"] == (None, None)
    assert cross["wo"]["w"] == ("model", None)


@pytest.mark.parametrize("arch", ARCHS)
def test_serving_on_the_model_axis_matches_reference(run, arch):
    want = run["serve_ref"][arch]
    for r in run["ranks"]:
        got = r[f"serve/{arch}"]
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
