"""A port checkpoint written by two ranks (gloo, CPU) resumes in the
reference at world 2, for zero1 over the int8 wire with the int8 arena and
for fsdp with the arena (``tests/torch_ckpt_jobs.py``; the reduced
llama3.2-1b, ``microbatches=2``):

* each port rank's Trainer stops after 2 steps and checkpoints: its
  sharded leaves are gathered to rank 0 in rank order (in 4 KiB messages,
  many a leaf) and written as global arrays; every sharded leaf's file has
  the global length ``2n`` (``meta.msgpack``), the reference's own global
  shape at world 2;
* a fresh two-rank port run resumes from it at step 2 and ends with the
  unbroken run's losses and final state, bitwise;
* the reference's Trainer (2 devices, one subprocess) resumes from the
  port's directory at step 2: its global arrays are bitwise every rank's
  saved shards in rank order (and the replicated leaves, each rank's), and
  the loss of the step it then takes follows the port's unbroken run
  within 1e-5 absolute (the forward pass of the same parameters).
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
from repro import compat
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.configs.base import ShapeConfig
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_loop import Trainer, TrainerConfig
from repro.runtime.train_step import TrainStepConfig

kw, cases, dirs, save_at = {kw!r}, {cases!r}, {dirs!r}, {save_at}
mesh = compat.make_mesh((2, 1), ("data", "model"))
cfg = reduced_config("llama3.2-1b")
model = build_model(cfg)
shape = ShapeConfig("tiny", kw["seq"], kw["batch"], "train")
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]), model_cfg=cfg)
out = {{}}
for name, case in cases.items():
    tcfg = TrainStepConfig(dp_mode=case["dp_mode"],
                           comm=CommConfig(**kw["comm"]),
                           optim=OptimConfig(**kw["optim"]), use_arena=True,
                           microbatches=kw["microbatches"],
                           schedule=kw["schedule"],
                           wire_codec=case["wire_codec"],
                           fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])
    tr = Trainer(model, mesh, tcfg, data, shape,
                 TrainerConfig(steps=save_at + 1, ckpt_dir=dirs[name],
                               log_every=100), log=lambda s: None)
    out[name + "/start"] = np.array(tr.start_step)
    flat, _ = jax.tree_util.tree_flatten_with_path(tr.state)
    for i, (p, leaf) in enumerate(flat):
        out[f"{{name}}/path/{{i}}"] = np.array(jax.tree_util.keystr(p))
        out[f"{{name}}/leaf/{{i}}"] = np.asarray(leaf)
    out[name + "/loss"] = np.array(tr.run()["history"][0]["loss"])
np.savez({path!r}, **out)
print("CKPT_PORT2REF_OK")
"""


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {name: os.path.join(tmp, name) for name in jobs.CASES}
        ranks = run_ranks(jobs.save_job, 2, dirs)
        metas = {name: read_meta(os.path.join(d, "for_ref"), jobs.SAVE_AT)
                 for name, d in dirs.items()}
        path = os.path.join(tmp, "ref.npz")
        assert "CKPT_PORT2REF_OK" in run_distributed(
            JAX_SCRIPT.format(kw=jobs.STEP_KW, cases=jobs.CASES,
                              dirs={n: os.path.join(d, "for_ref")
                                    for n, d in dirs.items()},
                              save_at=jobs.SAVE_AT, path=path), n_devices=2)
        with np.load(path) as f:
            ref = dict(f)
        yield {"ranks": ranks, "metas": metas, "ref": ref}


@pytest.mark.parametrize("case", list(jobs.CASES))
def test_sharded_files_have_the_global_length(runs, case):
    shapes = {rec["path"]: tuple(rec["shape"])
              for rec in runs["metas"][case]["leaves"]}
    saved = runs["ranks"][0][case]["saved"]
    assert set(shapes) == set(saved)
    for path, (rule, local) in saved.items():
        want = (2 * local.shape[0],) if rule == "sharded" else local.shape
        assert shapes[path] == want, path


@pytest.mark.parametrize("case", list(jobs.CASES))
def test_two_port_ranks_resume_bitwise(runs, case):
    for out in runs["ranks"]:
        got = out[case]
        assert got["start"] == jobs.SAVE_AT
        assert got["resumed_losses"] == got["full_losses"][jobs.SAVE_AT:]
        assert got["final_bitwise"]


@pytest.mark.parametrize("case", list(jobs.CASES))
def test_reference_resumes_the_port_shards_bitwise(runs, case):
    ref = runs["ref"]
    assert int(ref[f"{case}/start"]) == jobs.SAVE_AT
    n = len([k for k in ref if k.startswith(f"{case}/path/")])
    leaves = {str(ref[f"{case}/path/{i}"]): ref[f"{case}/leaf/{i}"]
              for i in range(n)}
    assert set(leaves) == set(runs["ranks"][0][case]["saved"])
    for r, out in enumerate(runs["ranks"]):
        for path, (rule, local) in out[case]["saved"].items():
            full = leaves[path]
            if rule == "sharded":
                k = local.shape[0]
                want = full[r * k:(r + 1) * k]
            else:
                want = full
            assert local.dtype == want.dtype, path
            assert np.array_equal(jobs.bits(local), jobs.bits(want)), (r, path)
    port_loss = runs["ranks"][0][case]["full_losses"][jobs.SAVE_AT]
    assert abs(float(ref[f"{case}/loss"]) - port_loss) < 1e-5
