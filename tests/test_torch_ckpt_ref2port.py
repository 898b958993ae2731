"""A reference checkpoint written at world 2 restores on two port ranks
(gloo, CPU), for zero1 over the int8 wire with the int8 arena and for fsdp
with the arena (``tests/torch_ckpt_jobs.py``; the reduced llama3.2-1b,
``microbatches=2``):

* the reference (2 devices, one subprocess) trains 2 steps, saves its
  state as global arrays and takes a third step;
* each port rank's Trainer resumes at step 2: every rank-sharded leaf (the
  arena, ``"ef"``, zero1's moment shards, fsdp's groups and moments) is
  bitwise elements ``[r*n, (r+1)*n)`` of the file at its path, whose length
  is the global ``2n``; every replicated leaf is the file bitwise;
* the loss of the step each port rank then takes follows the reference's
  third loss within 1e-5 absolute: it is the forward pass of the same
  parameters (bitwise, above), and only the order of the fp32 sums differs
  (``test_torch_fsdp.py``'s and ``test_torch_zero1.py``'s loss bounds).
"""

import os
import tempfile

import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_ckpt_jobs as jobs
from repro_torch.checkpoint.ckpt import read_meta

JAX_SCRIPT = r"""
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.checkpoint import save
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_step import (TrainStepConfig, build_train_step,
                                      init_train_state)

kw, cases, dirs, save_at = {kw!r}, {cases!r}, {dirs!r}, {save_at}
mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
model = build_model(reduced_config("llama3.2-1b"))
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out = {{}}
for name, case in cases.items():
    tcfg = TrainStepConfig(dp_mode=case["dp_mode"],
                           comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]), use_arena=True,
                           microbatches=kw["microbatches"],
                           schedule=kw["schedule"],
                           wire_codec=case["wire_codec"],
                           fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])
    with mesh:
        state, _ = init_train_state(model, mesh, tcfg, key=jax.random.key(0))
        step = build_train_step(model, mesh, tcfg, bspecs)
        for s in range(save_at):
            state, m = step(state, data.batch_at(s))
        save(state, save_at, dirs[name])
        state, m = step(state, data.batch_at(save_at))
    out[name] = np.array(float(m["loss"]))
np.savez({path!r}, **out)
print("CKPT_REF2PORT_OK")
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {name: os.path.join(tmp, name) for name in jobs.CASES}
        path = os.path.join(tmp, "ref.npz")
        assert "CKPT_REF2PORT_OK" in run_distributed(
            JAX_SCRIPT.format(kw=jobs.STEP_KW, cases=jobs.CASES, dirs=dirs,
                              save_at=jobs.SAVE_AT, path=path), n_devices=2)
        with np.load(path) as f:
            losses = {k: float(f[k]) for k in f}
        files = {}
        for name, d in dirs.items():
            meta = read_meta(d, jobs.SAVE_AT)
            step_dir = os.path.join(d, f"step_{jobs.SAVE_AT:08d}")
            files[name] = {rec["path"]: np.load(os.path.join(
                step_dir, rec["file"])) for rec in meta["leaves"]}
        ranks = run_ranks(jobs.restore_job, 2, dirs)
        yield {"losses": losses, "files": files, "ranks": ranks}


@pytest.mark.parametrize("case", list(jobs.CASES))
def test_port_ranks_restore_the_reference_shards_bitwise(runs, case):
    files = runs["files"][case]
    n_sharded = 0
    for r, out in enumerate(runs["ranks"]):
        got = out[case]
        assert got["start"] == jobs.SAVE_AT
        assert set(got["leaves"]) == set(files)
        for path, (rule, local) in got["leaves"].items():
            full = files[path]
            if rule == "sharded":
                n = local.shape[0]
                assert full.shape == (2 * n,), path
                want = full[r * n:(r + 1) * n]
                n_sharded += 1
            else:
                want = full
            assert local.dtype == want.dtype, path
            assert np.array_equal(jobs.bits(local), jobs.bits(want)), (r, path)
    kinds = {p.split("]")[0] for p, (rule, _) in
             runs["ranks"][0][case]["leaves"].items() if rule == "sharded"}
    want_kinds = {"['arena'", "['opt'"} | ({"['ef'"} if case == "zero1_int8"
                                            else {"['groups'"})
    assert kinds == want_kinds and n_sharded


@pytest.mark.parametrize("case", list(jobs.CASES))
def test_resumed_port_step_follows_the_reference(runs, case):
    for out in runs["ranks"]:
        assert out[case]["steps"] == 1
        assert abs(out[case]["loss"] - runs["losses"][case]) < 1e-5
