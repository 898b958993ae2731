"""The tooling slice's examples on the CPU at tiny arguments, each in a
subprocess: the all-reduce before/after on two spawned ranks, the ~100M
LM driver cut to 2 layers of 128 (two ranks, then a resume), and batched
contiguous decoding."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*argv, timeout=240) -> str:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    r = subprocess.run([sys.executable, *argv], capture_output=True,
                       text=True, cwd=REPO, env=env, timeout=timeout)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


def test_allreduce_demo_on_two_ranks():
    out = _run("examples/torch_allreduce_demo.py", "--device", "cpu",
               "--nproc", "2", "--elements", "16384", "--tensors", "8",
               "--iters", "2")
    assert "[dist] 2 ranks, backend gloo" in out
    for label in ("original", "ring x2 rails", "psum"):
        assert label in out
    assert out.count("us/reduction") == 4
    assert out.count("speedup vs original") == 3
    assert "NOTE" not in out


def test_train_lm_trains_and_resumes(tmp_path):
    argv = ["examples/torch_train_lm.py", "--device", "cpu", "--nproc", "2",
            "--seq", "16", "--batch", "4", "--layers", "2", "--d-model",
            "128", "--ckpt-dir", str(tmp_path / "ck")]
    out = _run(*argv, "--steps", "2")
    assert "final loss" in out and "2 rank(s) on cpu" in out
    out = _run(*argv, "--steps", "3")
    assert "resumed from step 2" in out and "step     2" in out


def test_serve_lm_decodes():
    out = _run("examples/torch_serve_lm.py", "--device", "cpu", "--tokens",
               "3", "--batch", "2", "--cache", "8")
    assert "decoded 6 tokens" in out and "sample stream" in out
