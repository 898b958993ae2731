"""Checkpoints on a ``("data", "model")`` mesh across packages.

Four gloo ranks on a (2, 2) mesh (``torch_ckpt_jobs.tp_ckpt_job``) beside
the reference on 4 host devices on the same mesh (one subprocess), in
zero1 and in fsdp, each with the fp32 arena (the reduced llama3.2-1b,
``microbatches=2``, 2 steps, a save, 2 more).  The two sides meet through
marker files: each writes its step directory, then resumes from the
other's.

* The port's step directory has the reference's leaf paths, shapes and
  dtypes (26 leaves in each: fsdp's 64 KiB buckets make several a
  block), its treedef string too: the zero1 parameters are global
  arrays, assembled from the model blocks; the flat leaves
  (``P(('data', 'model'))``) have the global length, the device at
  ``(d, m)`` holding block ``d*2+m``.
* A reference step directory restored by the port at (2, 2) and saved
  again is byte-identical: every ``arr_*.npy`` and ``meta.msgpack``.
* Port -> reference and reference -> port resumes: the two steps after
  the resume within rtol 1e-5 of the other side's unbroken run, the bound
  of ``test_torch_ckpt_trainer.py``.
* Port -> port: the resumed losses and every leaf of the final state
  bitwise the unbroken run's, on every rank.
* The train CLI with ``--nproc 4 --dp-mode fsdp --ckpt-dir`` (the default
  ``--model-parallel 2``: mesh (2, 2)) stops after 2 steps and resumes
  there.
"""

import filecmp
import os
import subprocess
import sys
import tempfile
import threading

import numpy as np
import pytest

from conftest import SRC
from torch_dist_util import run_ranks
import torch_ckpt_jobs as jobs
from repro_torch.checkpoint.ckpt import read_meta

LEAVES = 26

JAX_SCRIPT = r"""
import os
import time
import numpy as np
import jax
from jax.sharding import Mesh, PartitionSpec as P
from repro.checkpoint import restore, save
from repro.comm import CommConfig
from repro.configs import reduced_config
from repro.data import DataConfig, SyntheticTokens
from repro.models import build_model
from repro.optim import OptimConfig
from repro.runtime.train_step import (TrainStepConfig, build_train_step,
                                      init_train_state)

kw, cases, dirs, marks, save_at = ({kw!r}, {cases!r}, {dirs!r}, {marks!r},
                                   {save_at})
mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
model = build_model(reduced_config("llama3.2-1b"))
data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                  seq_len=kw["seq"],
                                  global_batch=kw["batch"]))
bspecs = {{"tokens": P("data", None), "labels": P("data", None)}}
out, built = {{}}, {{}}
try:
    for name, case in cases.items():
        tcfg = TrainStepConfig(dp_mode=case["dp_mode"],
                               comm=CommConfig(**kw["comm"]),
                               optim=OptimConfig(**kw["optim"]),
                               use_arena=True,
                               microbatches=kw["microbatches"],
                               schedule=kw["schedule"],
                               fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])
        with mesh:
            state, _ = init_train_state(model, mesh, tcfg,
                                        key=jax.random.key(0))
            step = build_train_step(model, mesh, tcfg, bspecs)
            for s in range(save_at):
                state, m = step(state, data.batch_at(s))
            save(state, save_at, dirs[name]["ref"])
            losses = []
            for s in range(save_at, save_at + 2):
                state, m = step(state, data.batch_at(s))
                losses.append(float(m["loss"]))
        out[name + "/unbroken"] = np.array(losses)
        built[name] = (step, state)
except BaseException:
    open(marks["ref_failed"], "w").write("failed\n")
    raise
open(marks["ref"], "w").write("ok\n")
deadline = time.monotonic() + 300
while not os.path.exists(marks["port"]):
    if os.path.exists(marks["port_failed"]) or time.monotonic() > deadline:
        raise SystemExit("the port ranks failed")
    time.sleep(0.1)
for name, (step, like) in built.items():
    with mesh:
        state = restore(like, save_at, dirs[name]["for_ref"])
        losses = []
        for s in range(save_at, save_at + 2):
            state, m = step(state, data.batch_at(s))
            losses.append(float(m["loss"]))
    out[name + "/from_port"] = np.array(losses)
np.savez({path!r}, **out)
print("TP_CKPT_REF_OK")
"""


def _cli(ckpt_dir: str, steps: int) -> str:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "llama3.2-1b", "--reduced", "--device", "cpu", "--nproc", "4",
         "--dp-mode", "fsdp", "--use-arena", "--seq", "16", "--batch", "4",
         "--steps", str(steps), "--ckpt-dir", ckpt_dir], env=env,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return proc.stdout


@pytest.fixture(scope="module")
def runs():
    with tempfile.TemporaryDirectory() as tmp:
        dirs = {name: {k: os.path.join(tmp, name, k)
                       for k in ("ref", "port", "for_ref", "resave")}
                for name in jobs.TP_CASES}
        marks = {k: os.path.join(tmp, k.upper()) for k in
                 ("ref", "ref_failed", "port", "port_failed")}
        cli: dict = {}

        def run_cli():
            d = os.path.join(tmp, "cli")
            try:
                cli["first"] = _cli(d, 2)
                cli["second"] = _cli(d, 3)
            except BaseException as e:           # re-raised below
                cli["error"] = e

        cli_thread = threading.Thread(target=run_cli)
        cli_thread.start()
        path = os.path.join(tmp, "ref.npz")
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(
                kw=jobs.STEP_KW, cases=jobs.TP_CASES, dirs=dirs, marks=marks,
                save_at=jobs.SAVE_AT, path=path)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            ranks = run_ranks(jobs.tp_ckpt_job, 4, dirs, marks)
        except BaseException:
            with open(marks["port_failed"], "w") as f:
                f.write("failed\n")
            raise
        finally:
            stdout, stderr = proc.communicate(timeout=560)
            cli_thread.join()
        assert "TP_CKPT_REF_OK" in stdout, stderr[-4000:]
        if "error" in cli:
            raise cli["error"]
        with np.load(path) as f:
            ref = dict(f)
        step = f"step_{jobs.SAVE_AT:08d}"
        files = {}
        for name, d in dirs.items():
            names = sorted(os.listdir(os.path.join(d["ref"], step)))
            files[name] = {
                "names": names, "resave_names": sorted(os.listdir(
                    os.path.join(d["resave"], step))),
                "different": [n for n in names if not filecmp.cmp(
                    os.path.join(d["ref"], step, n),
                    os.path.join(d["resave"], step, n), shallow=False)]}
        metas = {name: {k: read_meta(d[k], jobs.SAVE_AT)
                        for k in ("ref", "port")}
                 for name, d in dirs.items()}
        yield {"ranks": ranks, "ref": ref, "files": files, "metas": metas,
               "cli": cli}


@pytest.mark.parametrize("case", list(jobs.TP_CASES))
def test_port_directory_has_the_reference_leaves(runs, case):
    ref, port = runs["metas"][case]["ref"], runs["metas"][case]["port"]
    assert len(port["leaves"]) == len(ref["leaves"]) == LEAVES
    assert port["treedef"] == ref["treedef"]
    for a, b in zip(port["leaves"], ref["leaves"]):
        assert (a["path"], a["shape"], a["dtype"]) == (
            b["path"], b["shape"], b["dtype"])
    # every flat leaf at the global length: four ranks' blocks in order
    for r, out in enumerate(runs["ranks"]):
        shapes = {rec["path"]: tuple(rec["shape"]) for rec in port["leaves"]}
        for path, (rule, local) in out[case]["saved"].items():
            if rule == "sharded":
                assert shapes[path] == (4 * local.shape[0],), path
    rules = {str(rule) for rule, _ in runs["ranks"][0][case]["saved"]
             .values()}
    assert "sharded" in rules
    assert any(r.startswith("Blocks") for r in rules) == (case == "zero1")


@pytest.mark.parametrize("case", list(jobs.TP_CASES))
def test_reference_directory_restored_and_saved_again_is_identical(runs,
                                                                    case):
    got = runs["files"][case]
    assert got["names"] == got["resave_names"]
    assert "meta.msgpack" in got["names"]
    assert got["different"] == []


@pytest.mark.parametrize("case", list(jobs.TP_CASES))
def test_resumes_cross_packages_both_ways(runs, case):
    ref = runs["ref"]
    for out in runs["ranks"]:
        got = out[case]
        assert got["from_ref"]["start"] == jobs.SAVE_AT
        np.testing.assert_allclose(got["from_ref"]["losses"],
                                   ref[f"{case}/unbroken"], rtol=1e-5)
    np.testing.assert_allclose(ref[f"{case}/from_port"],
                               runs["ranks"][0][case]["full_losses"]
                               [jobs.SAVE_AT:], rtol=1e-5)


@pytest.mark.parametrize("case", list(jobs.TP_CASES))
def test_port_resume_is_bitwise(runs, case):
    for out in runs["ranks"]:
        got = out[case]
        assert got["start"] == jobs.SAVE_AT
        assert got["resumed_losses"] == got["full_losses"][jobs.SAVE_AT:]
        assert got["final_bitwise"]


def test_train_cli_resumes_fsdp_on_a_model_axis(runs):
    first, second = runs["cli"]["first"], runs["cli"]["second"]
    assert "mesh={'data': 2, 'model': 2}" in first and "dp_mode=fsdp" in first
    assert "resumed" not in first
    assert "[trainer] resumed from step 2" in second
