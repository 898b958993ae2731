"""repro_torch.obs against the reference's ``repro.obs``, and the port's
Trainer and CLIs instrumented through it.

* The bus, the tracer and the drift detector emit the reference's records
  on the same calls (one fixed clock, so the JSONL files and Chrome traces
  are equal line for line); the bench schema is shared.
* Each package's ``report.summarize`` reads the other's run directory, and
  the two render the same report.
* ``Span.fence`` waits on nothing for CPU trees (and never imports torch
  for a tree without tensors); ``ObsConfig``'s ``predict`` and
  ``tuned_db`` are not ported and raise.
* The Trainer (one rank, CPU) writes the ``data``, ``step``,
  ``dispatch``, ``wait`` and ``ckpt`` spans, the ``steps`` counter, the
  step gauges, drift samples on an explicit prediction and ``run_done``.
* The train CLI at reduced size on two CPU ranks with ``--ckpt-dir`` and
  ``--obs-dir`` saves, resumes and prints the run's obs paths; the paged
  serve CLI's ``--obs-dir`` instruments the engine and scheduler.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import repro.obs as ref_obs
from repro.obs import report as ref_report
from repro.obs import schema as ref_schema
from repro_torch import obs
from repro_torch.checkpoint import latest_step
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.obs import report, schema
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.runtime.train_step import TrainStepConfig, data_mesh

SPANS = ("data", "step", "dispatch", "wait", "ckpt")


class _Clock:
    """A clock that advances by a fixed step per read."""

    def __init__(self, dt=0.25):
        self.t, self.dt = 0.0, dt

    def __call__(self):
        self.t += self.dt
        return self.t


def _drive(pkg, run_dir):
    """The same calls on one package's bus, tracer and drift detector."""
    bus = pkg.MetricsBus(run_dir, flush_every=3, clock=_Clock())
    tracer = pkg.Tracer(bus, clock=_Clock(0.125), pid=7)
    bus.counter("steps")
    bus.counter("serve_stall", 2.0, reason="max_steps")
    bus.gauge("loss", 6.25)
    bus.gauge("queue_depth", 3, policy="continuous")
    for v in (0.5, 0.25, 2.0, 1.0):
        bus.observe("latency_s", v, policy="static")
    bus.event("admit", slot=1, pages_free=np.int64(7))
    with tracer.span("step", step=0) as sp:
        sp.fence({"loss": torch.ones(())})
        with tracer.span("dispatch", step=0):
            pass
    det = pkg.DriftDetector(0.1, bus=bus, window=4, warmup=1,
                            min_samples=2, threshold=0.5, source="explicit")
    samples = [det.update(i, t) for i, t in
               enumerate([1.0, 0.11, 0.12, 0.3, 0.31, 0.29, 0.1, 0.1, 0.1])]
    trace = tracer.export_chrome(os.path.join(run_dir, "trace.json"))
    bus.close()
    return {"summary": bus.summary(), "hist": bus.hist_summary(
        "latency_s", policy="static"), "alarms": det.alarms,
        "samples": [s.__dict__ if hasattr(s, "__dict__") else s
                    for s in samples], "trace": trace}


def test_bus_tracer_and_drift_emit_the_reference_records(tmp_path):
    mine = _drive(obs, str(tmp_path / "port"))
    theirs = _drive(ref_obs, str(tmp_path / "ref"))
    assert mine["summary"] == theirs["summary"]
    assert mine["hist"] == theirs["hist"]
    assert mine["alarms"] == theirs["alarms"] == 1
    assert [repr(s) for s in mine["samples"]] == [
        repr(s).replace("repro.obs", "repro_torch.obs")
        for s in theirs["samples"]]
    for name in ("events.jsonl", "trace.json"):
        a = (tmp_path / "port" / name).read_text()
        b = (tmp_path / "ref" / name).read_text()
        assert a == b, name


def test_reports_read_each_others_run_dirs(tmp_path):
    _drive(obs, str(tmp_path / "port"))
    _drive(ref_obs, str(tmp_path / "ref"))
    for run_dir in (tmp_path / "port", tmp_path / "ref"):
        mine = report.summarize(str(run_dir))
        theirs = ref_report.summarize(str(run_dir))
        assert mine == theirs
        assert report.render(mine) == ref_report.render(theirs)
        assert mine["phases"] and mine["drift"]["alarms"]
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs.report", "--json",
         str(tmp_path / "ref")], capture_output=True, text=True, check=True,
        env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})
    assert json.loads(out.stdout)["n_records"] == mine["n_records"]


def test_bench_schema_is_shared(tmp_path):
    text = "# c\nname,ms\nring,1.5\npsum,2\n\nx,y,z\n1,2,3\n"
    assert schema.rows_from_csv(text) == ref_schema.rows_from_csv(text)
    rows = schema.rows_from_csv(text)
    path = schema.write_bench_record(str(tmp_path), "demo", rows,
                                     meta={"card": "x"})
    assert ref_schema.load_bench_record(path)["rows"] == rows
    with pytest.raises(ValueError):
        schema.bench_record("bad", [{"k": [1]}])


def test_fence_and_null_obs():
    tracer = obs.Tracer(obs.NULL_BUS, clock=_Clock())
    with tracer.span("wait") as sp:
        assert sp.fence({"a": [torch.zeros(2)], "b": 3}) is not None
    assert tracer.events[0][0] == "wait"
    assert obs.make_obs(None) is obs.NULL_OBS
    assert obs.make_obs(obs.ObsConfig.off()) is obs.NULL_OBS
    with obs.NULL_OBS.span("x") as sp:
        sp.fence(torch.ones(1))
    assert obs.NULL_OBS.finish() == {"events": None, "trace": None}
    from repro_torch.serve.engine import NULL_OBS as engine_null

    assert engine_null is obs.NULL_OBS
    code = ("import sys; from repro_torch.obs.trace import wait_for_device; "
            "wait_for_device({'a': [1, (2.0,)]}); "
            "assert 'torch' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   env={**os.environ, "PYTHONPATH": os.pathsep.join(sys.path)})


@pytest.mark.parametrize("kw", [dict(predict=True), dict(tuned_db="db.json")])
def test_computed_predictions_are_not_ported(kw):
    """Both computed predictions are ported: the config takes them, as the
    reference's does (tests/test_torch_predict.py drives them)."""
    cfg, ref = obs.ObsConfig(**kw), ref_obs.ObsConfig(**kw)
    assert cfg.__dict__ == ref.__dict__
    assert cfg.predict == ref.predict and cfg.tuned_db == ref.tuned_db


def test_trainer_publishes_spans_gauges_and_drift(tmp_path):
    model = build_model(reduced_config("llama3.2-1b"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    run_dir = str(tmp_path / "obs")
    cfg = obs.ObsConfig(run_dir=run_dir, predicted_step_s=1e-4)
    tr = Trainer(model, data_mesh(1), TrainStepConfig(), data,
                 TrainerConfig(steps=3, ckpt_every=2,
                               ckpt_dir=str(tmp_path / "ck"), log_every=100,
                               obs=cfg),
                 device=torch.device("cpu"), log=lambda m: None)
    out = tr.run()
    assert out["obs"]["events"] == os.path.join(run_dir, "events.jsonl")
    assert latest_step(str(tmp_path / "ck")) == 3
    with open(out["obs"]["trace"]) as f:
        names = [e["name"] for e in json.load(f)["traceEvents"]]
    for name in SPANS:
        assert name in names, name
    assert names.count("ckpt") == 2 and names.count("wait") == 3
    for pkg in (report, ref_report):
        s = pkg.summarize(run_dir)
        assert s["counters"]["steps"] == 3.0
        for g in ("step_time_s", "loss", "grad_norm", "lr",
                  "model_error{metric=step_time_s}"):
            assert g in s["gauges"], g
        assert s["events"]["run_done"] == 1
        assert s["events"]["drift_sample"] == 3
        assert {r["phase"] for r in s["phases"]} == set(SPANS)
    assert tr.drift is not None and tr.drift.source == "explicit"
    assert len(out["history"]) == 3


def test_train_cli_saves_resumes_and_instruments_two_ranks(tmp_path, capfd):
    ck, od = str(tmp_path / "ck"), str(tmp_path / "obs")
    argv = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu",
            "--nproc", "2", "--seq", "32", "--batch", "4", "--use-arena",
            "--wire-codec", "int8", "--dp-mode", "zero1", "--ckpt-dir", ck,
            "--model-parallel", "1"]      # a checkpoint needs a data-only mesh
    launch_train.main(argv + ["--steps", "2", "--obs-dir", od])
    out = capfd.readouterr().out
    assert f"obs: events={od}/events.jsonl trace={od}/trace.json" in out
    assert latest_step(ck) == 2
    s = report.summarize(od)
    assert s["counters"]["steps"] == 2.0
    assert {r["phase"] for r in s["phases"]} == set(SPANS)
    launch_train.main(argv + ["--steps", "3"])
    out = capfd.readouterr().out
    assert "[trainer] resumed from step 2" in out
    assert "[train] step     2" in out and "obs:" not in out
    assert latest_step(ck) == 3


def test_serve_cli_obs_dir(tmp_path, capsys):
    od = str(tmp_path / "obs")
    launch_serve.main(["--arch", "llama3.2-1b", "--reduced", "--paged",
                       "--device", "cpu", "--groups", "1", "--long-len",
                       "8", "--obs-dir", od])
    assert f"obs: events={od}/events.jsonl" in capsys.readouterr().out
    s = report.summarize(od)
    assert s["counters"]["admits"] == 4.0
    assert s["events"]["serve_done"] == 1
    assert [r["phase"] for r in s["phases"]] == ["decode_step"]
