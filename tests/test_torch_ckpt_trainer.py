"""The port's Trainer stops and resumes through checkpoints that cross
packages (one rank, CPU, the reduced llama3.2-1b of
``tests/test_system.py``: replicated, seq 64, batch 4, data seed 1,
``base_lr`` 3e-3 with 5 warmup steps over 12):

* (c) reference to port: the reference's Trainer runs 8 of the 12 steps
  with ``ckpt_every=4``; the port's Trainer resumes from that directory at
  ``start_step == 8`` and runs steps 8-11, whose losses follow the
  reference's unbroken 12-step run within ``test_torch_train.py``'s rtol
  1e-5 (autograd and XLA sum in different orders);
* (d) port to reference: the reverse, the reference's resumed losses held
  to the port's unbroken run;
* (e) port to port: a run stopped at 8 and resumed gives the unbroken
  run's losses and final state bitwise, and the resumed history records
  the monitor's ``straggler`` field.

One JAX subprocess (one device) runs the reference's three Trainers.
"""

import os
import shutil
import tempfile

import numpy as np
import pytest
import torch

from conftest import run_distributed
from repro_torch import tree as tree_util
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import build_model
from repro_torch.optim import OptimConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.runtime.train_step import TrainStepConfig, data_mesh

STEPS, STOP, EVERY = 12, 8, 4
OPTIM = dict(base_lr=3e-3, warmup=5, total_steps=STEPS)

JAX_SCRIPT = r"""
import dataclasses
import numpy as np
from repro import compat
from repro.configs import reduced_config
from repro.configs.base import ShapeConfig
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_loop import Trainer, TrainerConfig
from repro.runtime.train_step import TrainStepConfig

cfg = reduced_config("llama3.2-1b")
model = build_model(cfg)
shape = ShapeConfig("tiny", 64, 4, "train")
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=64, global_batch=4, seed=1),
                       model_cfg=cfg)
scfg = TrainStepConfig(dp_mode="replicated", optim=OptimConfig(**{optim!r}),
                       microbatches=1)
mesh = compat.make_mesh((1, 1), ("data", "model"))
quiet = lambda s: None
full = Trainer(model, mesh, scfg, data, shape,
               TrainerConfig(steps={steps}, log_every=100), log=quiet).run()
Trainer(model, mesh, scfg, data, shape,
        TrainerConfig(steps={stop}, ckpt_every={every}, ckpt_dir={ref_dir!r},
                      log_every=100), log=quiet).run()
resumed = Trainer(model, mesh, scfg, data, shape,
                  TrainerConfig(steps={steps}, ckpt_every={every},
                                ckpt_dir={port_dir!r}, log_every=100),
                  log=quiet)
start = resumed.start_step
tail = resumed.run()
np.savez({out!r}, full=np.array([h["loss"] for h in full["history"]]),
         resumed=np.array([h["loss"] for h in tail["history"]]),
         resumed_steps=np.array([h["step"] for h in tail["history"]]),
         start=np.array(start))
print("CKPT_TRAINER_REF_OK")
"""


def _trainer(model, ckpt_dir, steps):
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=64, global_batch=4, seed=1))
    step_cfg = TrainStepConfig(dp_mode="replicated",
                               optim=OptimConfig(**OPTIM))
    return Trainer(model, data_mesh(1), step_cfg, data,
                   TrainerConfig(steps=steps, ckpt_every=EVERY,
                                 ckpt_dir=ckpt_dir, log_every=100, seed=0),
                   device=torch.device("cpu"), log=lambda m: None)


def _losses(out):
    return [h["loss"] for h in out["history"]]


@pytest.fixture(scope="module")
def runs():
    model = build_model(reduced_config("llama3.2-1b"))
    with tempfile.TemporaryDirectory() as tmp:
        port_dir = os.path.join(tmp, "port")
        ref_dir = os.path.join(tmp, "ref")
        handed = os.path.join(tmp, "port_for_ref")
        full_tr = _trainer(model, None, STEPS)
        full = full_tr.run()
        stopped = _trainer(model, port_dir, STEPS)
        stopped.tcfg.steps = STOP                 # the run dies after 8
        stopped.run()
        shutil.copytree(port_dir, handed)
        resumed_tr = _trainer(model, port_dir, STEPS)
        start = resumed_tr.start_step
        resumed = resumed_tr.run()
        path = os.path.join(tmp, "ref.npz")
        assert "CKPT_TRAINER_REF_OK" in run_distributed(
            JAX_SCRIPT.format(optim=OPTIM, steps=STEPS, stop=STOP,
                              every=EVERY, ref_dir=ref_dir, port_dir=handed,
                              out=path), n_devices=1)
        with np.load(path) as f:
            ref = dict(f)
        from_ref_tr = _trainer(model, ref_dir, STEPS)
        from_ref_start = from_ref_tr.start_step
        from_ref = from_ref_tr.run()
        yield {"full": full, "full_state": full_tr.state,
               "resumed": resumed, "resumed_state": resumed_tr.state,
               "start": start, "ref": ref, "from_ref": from_ref,
               "from_ref_start": from_ref_start}


def test_reference_checkpoint_resumes_in_the_port(runs):
    assert runs["from_ref_start"] == STOP
    got = _losses(runs["from_ref"])
    assert [h["step"] for h in runs["from_ref"]["history"]] == list(
        range(STOP, STEPS))
    np.testing.assert_allclose(got, runs["ref"]["full"][STOP:], rtol=1e-5)


def test_port_checkpoint_resumes_in_the_reference(runs):
    ref = runs["ref"]
    assert int(ref["start"]) == STOP
    assert list(ref["resumed_steps"]) == list(range(STOP, STEPS))
    np.testing.assert_allclose(ref["resumed"], _losses(runs["full"])[STOP:],
                               rtol=1e-5)


def test_port_resume_is_bitwise_the_unbroken_run(runs):
    assert runs["start"] == STOP
    assert _losses(runs["resumed"]) == _losses(runs["full"])[STOP:]
    got, want = runs["resumed_state"], runs["full_state"]
    assert got["step"] == want["step"] == STEPS
    ga, gd = tree_util.flatten({k: v for k, v in got.items() if k != "step"})
    wa, wd = tree_util.flatten({k: v for k, v in want.items()
                                if k != "step"})
    assert gd == wd
    for a, b in zip(ga, wa):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert all(h["straggler"] in (True, False)
               for h in runs["resumed"]["history"])
    assert set(runs["resumed"]) == {"history", "wall", "straggler_events",
                                    "obs"}
