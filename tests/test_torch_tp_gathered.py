"""repro_torch gathered-weight serving on a ``("data", "model")`` mesh
against the JAX reference.

The reference's ``build_prefill`` and ``build_decode_step`` with
``weight_mode="gathered"`` on 4 host devices, meshes (1, 2) and (2, 2)
(one subprocess), against the port's on 2 and 4 gloo ranks on the same
meshes (two spawns, run beside it), for the 16 q / 4 kv head config of
the reduced llama3.2-1b (model rank 1 holds real heads), from the
reference's ``Model.init(key(7))``:

* each rank's shards (the reference's ``init_train_state`` in fsdp mode,
  the port's ``serve_params``) bitwise block ``d*2+m`` of the reference's
  global flat arrays;
* the prefill (B=2, S=16) and 3 decode steps against fp32 caches of 8
  slots: this rank's rows of the whole vocabulary within rtol/atol 1e-4
  of the reference's, the tolerance of ``test_torch_fsdp.py``'s gathered
  cases (the gathered weights are bf16 on both sides, fp32 compute);
* and within 1e-4 of the port's resident steps on the same mesh fed the
  parameters rounded to bf16, as the gathers round them;
* the serve CLI's contiguous loop (``run_contiguous``) at R = 2 with
  gathered weights: its first token's logits within the engine's bf16
  tolerance (rtol 2e-2 / atol 5e-2) of the resident loop's, the same
  seeded weights unrounded.
"""

import os
import tempfile
import threading

import jax
import numpy as np
import pytest

from conftest import SRC
from torch_dist_util import run_ranks
import torch_tp_jobs as jobs

_rng = np.random.RandomState(9)
SERVE_KW = {"batch": 2, "seq": 16, "cache": 8,
            "tokens": _rng.randint(0, 500, (2, 16)).astype(np.int32),
            "decode_tokens": [_rng.randint(0, 500, (2,)).astype(np.int32)
                              for _ in range(3)]}
MESHES = {"1x2": 2, "2x2": 4}

JAX_SCRIPT = r"""
import dataclasses
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh
from repro.configs import reduced_config
from repro.configs.base import ShapeConfig
from repro.models import build_model
from repro.models.transformer import init_decode_state
from repro.runtime.serve_step import build_decode_step, build_prefill
from repro.runtime.train_step import TrainStepConfig, init_train_state

serve = {serve!r}
base = reduced_config("llama3.2-1b")
model = build_model(base.with_(attn=dataclasses.replace(
    base.attn, num_heads=16, num_kv_heads=4)))
b, s, c = serve["batch"], serve["seq"], serve["cache"]
out = {{}}
for name, world in {meshes!r}.items():
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world // 2, 2),
                ("data", "model"))
    with mesh:
        state, _ = init_train_state(model, mesh,
                                    TrainStepConfig(dp_mode="fsdp"),
                                    key=jax.random.key(7))
        for g, shards in state["groups"].items():
            for i, x in enumerate(shards):
                out[f"{{name}}/groups/{{g}}/{{i}}"] = np.asarray(x)
        wp = {{"groups": state["groups"]}}
        prefill, _ = build_prefill(model, mesh,
                                   ShapeConfig("t", s, b, "prefill"),
                                   weight_mode="gathered")
        out[f"{{name}}/prefill"] = np.asarray(prefill(
            wp, {{"tokens": jnp.asarray(np.array(serve["tokens"],
                                                 np.int32))}}))
        decode, _, _ = build_decode_step(
            model, mesh, ShapeConfig("t", c, b, "decode"),
            weight_mode="gathered", donate=False)
        st = init_decode_state(model.cfg, b, c, cache_dtype=jnp.float32)
        for pos, tok in enumerate(serve["decode_tokens"]):
            logits, st = decode(wp, jnp.asarray(np.array(tok, np.int32)),
                                st, jnp.asarray(pos))
            out[f"{{name}}/decode/{{pos}}"] = np.asarray(logits)
np.savez({path!r}, **out)
print("TP_GATHERED_REF_OK")
"""


def _reference_leaves() -> list:
    import dataclasses

    from repro.configs import reduced_config
    from repro.models import build_model

    base = reduced_config("llama3.2-1b")
    model = build_model(base.with_(attn=dataclasses.replace(
        base.attn, num_heads=16, num_kv_heads=4)))
    return [np.asarray(l) for l in jax.tree.leaves(
        model.init(jax.random.key(7)))]


@pytest.fixture(scope="module")
def run():
    """The reference subprocess and the port's two spawns, side by side."""
    import subprocess
    import sys

    serve = {k: (v.tolist() if isinstance(v, np.ndarray)
                 else [x.tolist() for x in v] if isinstance(v, list) else v)
             for k, v in SERVE_KW.items()}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                serve=serve, meshes=MESHES, path=path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            leaves = _reference_leaves()
            ranks, errors = {}, {}

            def spawn(name, world):
                try:
                    ranks[name] = run_ranks(jobs.tp_gathered_job, world,
                                            leaves, SERVE_KW)
                except BaseException as e:       # re-raised below
                    errors[name] = e

            threads = [threading.Thread(target=spawn, args=item)
                       for item in MESHES.items()]
            for t in threads:
                t.start()
            for t in threads:
                t.join()
            for e in errors.values():
                raise e
        finally:
            stdout, stderr = proc.communicate(timeout=560)
        assert "TP_GATHERED_REF_OK" in stdout, stderr[-4000:]
        with np.load(path) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


def _groups(ref, prefix) -> dict:
    out: dict = {}
    for key in ref:
        if key.startswith(prefix + "/"):
            name, i = key[len(prefix) + 1:].rsplit("/", 1)
            out.setdefault(name, {})[int(i)] = ref[key]
    return {name: [d[i] for i in range(len(d))] for name, d in out.items()}


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_shards_are_the_reference_blocks(run, mesh):
    want = _groups(run["ref"], f"{mesh}/groups")
    world = MESHES[mesh]
    for r, out in enumerate(run["ranks"][mesh]):
        assert sorted(out["groups"]) == sorted(want)
        for name in want:
            for a, full in zip(out["groups"][name], want[name]):
                n = full.size // world
                np.testing.assert_array_equal(a, full[r * n:(r + 1) * n],
                                              err_msg=f"rank {r} {name}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_prefill_and_decode_match_reference(run, mesh):
    ref = run["ref"]
    for r, out in enumerate(run["ranks"][mesh]):
        rows = out["rows"]
        np.testing.assert_allclose(out["gathered/prefill"],
                                   ref[f"{mesh}/prefill"][rows], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
        for pos, logits in enumerate(out["gathered/decode"]):
            np.testing.assert_allclose(
                logits, ref[f"{mesh}/decode/{pos}"][rows], rtol=1e-4,
                atol=1e-4, err_msg=f"rank {r} position {pos}")


@pytest.mark.parametrize("mesh", list(MESHES))
def test_gathered_steps_match_resident_steps(run, mesh):
    for r, out in enumerate(run["ranks"][mesh]):
        np.testing.assert_allclose(out["gathered/prefill"],
                                   out["resident/prefill"], rtol=1e-4,
                                   atol=1e-4, err_msg=f"rank {r}")
        for pos, (g, w) in enumerate(zip(out["gathered/decode"],
                                         out["resident/decode"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4,
                                       err_msg=f"rank {r} position {pos}")


def test_contiguous_loop_serves_gathered_weights_at_two_ranks(run):
    for r, out in enumerate(run["ranks"]["1x2"]):
        got, want = out["cli"]["gathered"], out["cli"]["resident"]
        assert got.shape == want.shape == (2, 512)
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=5e-2,
                                   err_msg=f"rank {r}")
        assert not np.array_equal(got, want)     # the gathers round to bf16
