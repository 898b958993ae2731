"""repro_torch training against the JAX reference.

* Loss and gradients of the reduced dense archs (llama3.2-1b, qwen2-7b,
  phi3-medium-14b, minicpm-2b) at fp32 compute, from
  bridged parameters: rtol 1e-5 on the loss and rtol/atol 1e-4 on the
  gradients, because autograd and XLA sum the same terms in different
  orders (attention softmax, matmul reductions, the tied embedding's two
  uses).
* Synthetic batches: the same numpy code, bitwise.
* The replicated train loop on 2 gloo ranks against the reference's
  2-device step (one subprocess), from the same initial parameters, with
  the arena off and on: per-step losses within rtol 1e-5, gradient norms
  within rtol 1e-4 and final parameters within atol 1e-4.  AdamW divides
  each element's update by its own gradient scale, so where a gradient is
  near 0 the sum-order difference above moves that element's update by a
  visible share of the learning rate (1e-2); 1e-4 is 1 % of one step.  The port's recorded
  sends per step equal the plan's messages, and with the arena its bytes
  equal the plan's arena bytes, exactly.
* The train CLI resolves llama3.2-1b's full-size default to ``zero1``
  (without training 1.24 B parameters on the CPU), and runs a reduced
  ``--dp-mode zero1`` step and a reduced ``--dp-mode fsdp`` step to their
  end.
"""

import os
import tempfile

import jax
import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_rank_jobs as jobs
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model
from repro_torch import bridge
from repro_torch import tree as tree_util
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model

ARCH = "llama3.2-1b"
# the dense archs: llama3.2-1b's GQA, qwen2-7b's qkv bias and rope theta,
# phi3-medium-14b's 40 / 10 heads, minicpm-2b's tied embeddings
DENSE_ARCHS = (ARCH, "qwen2-7b", "phi3-medium-14b", "minicpm-2b")
STEPS = 3
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=STEPS),
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
for arena in (0, 1):
    tcfg = TrainStepConfig(dp_mode="replicated",
                           comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]),
                           use_arena=bool(arena))
    with mesh:
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
np.savez({path!r}, **out)
print("TRAIN_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "train.npz")
        assert "TRAIN_REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=STEP_KW, steps=STEPS, path=path),
            n_devices=2)
        with np.load(path) as f:
            return dict(f)


def _models(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(1))
    model = build_model(reduced_config(arch))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    return jmodel, jparams, model, params


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_loss_and_grads_match_reference_at_fp32(arch):
    jmodel, jparams, model, params = _models(arch)
    batch = JaxSyntheticTokens(JaxDataConfig(
        vocab_size=jmodel.cfg.vocab_size, seq_len=32,
        global_batch=2)).batch_at(0)
    jloss, jgrads = jax.value_and_grad(jmodel.loss_fn)(jparams, batch)
    leaves, treedef = tree_util.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in leaves]
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    loss = model.loss_fn(treedef.unflatten(leaves), tbatch)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    jleaves = jax.tree.leaves(jgrads)
    assert len(jleaves) == len(grads)
    for g, jg in zip(grads, jleaves):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4,
                                   atol=1e-4)


def test_synthetic_batches_are_bitwise():
    kw = dict(vocab_size=512, seq_len=64, global_batch=4, seed=3,
              mean_doc_len=16)
    port = SyntheticTokens(DataConfig(**kw))
    ref = JaxSyntheticTokens(JaxDataConfig(**kw))
    for step in (0, 1, 17):
        got, want = port.batch_at(step), ref.batch_at(step)
        for k in ("tokens", "labels"):
            assert got[k].dtype == torch.int32
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("use_arena", [False, True])
def test_two_rank_trajectory_follows_reference(reference, use_arena):
    n = len([k for k in reference if k.startswith("init/")])
    leaves = [reference[f"init/{i}"] for i in range(n)]
    ranks = run_ranks(jobs.train_job, 2, leaves, STEPS, use_arena, {},
                      STEP_KW)
    arena = int(use_arena)
    for out in ranks:
        np.testing.assert_allclose(out["loss"], reference[f"loss/{arena}"],
                                   rtol=1e-5)
        np.testing.assert_allclose(out["grad_norm"],
                                   reference[f"gnorm/{arena}"], rtol=1e-4)
        for i, p in enumerate(out["params"]):
            np.testing.assert_allclose(p, reference[f"final{arena}/{i}"],
                                       atol=1e-4, err_msg=f"leaf {i}")
        rec, pred = out["record"], out["predicted"]
        assert rec["sends"] == pred["sends"]
        if use_arena:
            assert rec["send_bytes"] == pred["send_bytes"]
        assert rec["all_reduces"] == STEPS       # the loss metric's pmean
    for a, b in zip(ranks[0]["params"], ranks[1]["params"]):
        np.testing.assert_array_equal(a, b)     # replicas stay identical


@pytest.mark.parametrize("argv", [
    ["--arch", ARCH, "--device", "cpu"],                 # defaults to zero1
    ["--arch", ARCH, "--reduced", "--dp-mode", "zero1", "--device", "cpu"],
    ["--arch", ARCH, "--reduced", "--dp-mode", "fsdp", "--device", "cpu"]])
def test_cli_refuses_unported_dp_modes(argv, capsys):
    """No mode is refused since fsdp was ported: each case checks that its
    mode resolves and, at reduced size, trains one step to its end."""
    argv = argv + ["--steps", "1"]
    if "--reduced" in argv:
        mode = argv[argv.index("--dp-mode") + 1]
        launch_train.main(argv)                  # one step, to its end
        out = capsys.readouterr().out
        assert f"dp_mode={mode}" in out and "[train] step     0" in out
    else:
        args = launch_train.parser().parse_args(argv)
        assert launch_train.resolve_dp_mode(args) == "zero1"


def test_launcher_spawns_ranks_and_reports_a_failing_one():
    assert launch_train.spawn(jobs.env_rank_job, 2, -1) == [("0", "2"),
                                                            ("1", "2")]
    with pytest.raises(RuntimeError, match="rank 1 was told to fail"):
        launch_train.spawn(jobs.env_rank_job, 2, 1)
