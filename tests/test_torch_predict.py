"""The port's step-time prediction (``repro_torch.obs.predict``) and the
launchers' tooling flags against the reference: the Roofline's terms
bitwise the reference's under the same constants; on two gloo ranks (one
spawn) at meshes (2, 1) and (1, 2), the predicted wire bytes and messages
equal to every step's CommRecord and the train state, RNG and records
bitwise unchanged by the prediction; the Trainer's ``prediction`` event and
drift gauges, and with ``tuned_db`` the same record as the reference's
Trainer on the same DB; the mesh flags' refusals."""

import json
import os

import numpy as np
import pytest
import torch

import torch_tune_jobs as jobs
from torch_dist_util import run_ranks

from repro.launch import mesh as ref_mesh
from repro.launch import roofline as ref_roofline
from repro.comm.plan import LatencyModel as RefLatencyModel
from repro_torch.comm.plan import LatencyModel
from repro_torch.configs import reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import mesh, roofline
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import build_model
from repro_torch.obs import ObsConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.runtime.train_step import TrainStepConfig
from repro_torch.tune import TuningDB, fit

BASE = ["--arch", "llama3.2-1b", "--reduced", "--device", "cpu", "--seq",
        "32", "--batch", "4", "--steps", "2"]
CASES = [  # (2, 1): the data ring; (1, 2): the model axis
    BASE + ["--model-parallel", "1", "--dp-mode", "zero1", "--use-arena"],
    BASE + ["--model-parallel", "1", "--transport", "psum"],
    BASE + ["--model-parallel", "1", "--use-arena", "--wire-codec", "int8",
            "--channels", "2"],
    BASE + ["--model-parallel", "2"],
    BASE + ["--model-parallel", "2", "--dp-mode", "fsdp", "--use-arena"],
]


def _roofline_inputs(seed: int) -> dict:
    rng = np.random.RandomState(seed)
    return dict(flops_per_device=float(rng.uniform(1e9, 1e15)),
                hbm_bytes_per_device=float(rng.uniform(1e6, 1e12)),
                wire_bytes_per_device=float(rng.uniform(0, 1e10)),
                model_flops=float(rng.uniform(0, 1e15)),
                overlap_fraction=float(rng.uniform(-0.2, 1.2)),
                messages_per_device=float(rng.randint(0, 500)),
                padding_wire_bytes_per_device=float(rng.uniform(0, 1e6)))


@pytest.mark.parametrize("seed", range(6))
def test_roofline_terms_are_the_references(seed, monkeypatch):
    monkeypatch.setattr(roofline, "PEAK_FLOPS", ref_roofline.PEAK_FLOPS)
    monkeypatch.setattr(roofline, "HBM_BW", ref_roofline.HBM_BW)
    kw = _roofline_inputs(seed)
    got, want = roofline.Roofline(**kw), ref_roofline.Roofline(**kw)
    assert got.as_dict(8) == want.as_dict(8)
    lat = (1e-4 * (seed + 1), 3e9 / (seed + 1))
    got = roofline.Roofline.from_latency(LatencyModel(*lat), **kw)
    want = ref_roofline.Roofline.from_latency(RefLatencyModel(*lat), **kw)
    assert got.as_dict(8) == want.as_dict(8)
    for prop in ("t_compute", "t_memory", "t_collective",
                 "t_exposed_collective", "bottleneck",
                 "bound_time_overlapped"):
        assert getattr(got, prop) == getattr(want, prop), prop
    assert roofline.model_flops_estimate(1000, 64, "train") == \
        ref_roofline.model_flops_estimate(1000, 64, "train")
    assert roofline.model_flops_estimate(1000, 64, "decode") == \
        ref_roofline.model_flops_estimate(1000, 64, "decode")


def test_roofline_constants_are_the_cards():
    assert roofline.PEAK_FLOPS == 989e12 and roofline.HBM_BW == 3.35e12
    assert not hasattr(roofline, "collective_wire_bytes")


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(jobs.predict_job, 2, CASES, timeout=300)


def test_predicted_wire_is_every_steps_record(ranks):
    meshes = [r["mesh"] for r in ranks[0]]
    assert meshes == [(2, 1)] * 3 + [(1, 2)] * 2
    for out in ranks:
        for case in out:
            pred = case["pred"]
            want = (pred["messages_per_device"],
                    pred["wire_bytes_per_device"])
            assert want[0] > 0 and want[1] > 0
            assert case["wire"] == [want, want], case["mesh"]


def test_prediction_leaves_the_train_state_bitwise(ranks):
    for out in ranks:
        assert all(case["unchanged"] for case in out)


def test_prediction_counts_against_the_model(ranks):
    model = build_model(reduced_config("llama3.2-1b"))
    n = model.param_count()
    for case in ranks[0]:
        pred = case["pred"]
        data, mdl = case["mesh"]
        six_nd = roofline.model_flops_estimate(n // mdl, 4 * 32 // data,
                                               "train")
        # FlopCounterMode counts the matmuls (the embedding is a gather)
        # and the attention, 6ND the parameters: within a factor 0.7-1.5
        assert 0.7 < pred["flops_per_device"] / six_nd < 1.5, case["mesh"]
        assert pred["hbm_bytes_per_device"] > 4 * n / mdl
        assert pred["source"] == "roofline"
        assert pred["t_step_s"] == max(pred["t_compute_s"],
                                       pred["t_memory_s"],
                                       pred["t_exposed_collective_s"])


def _db(path: str) -> None:
    """A DB whose records differ in mesh, channels and page size."""
    d = TuningDB()
    samples = [(8, 1e5, 1e-3, 1.0), (8, 1e6, 2e-3, 1.0), (8, 1e7, 9e-3, 1.0)]
    for i, (m, ch, page) in enumerate([("1x1", 0, 2 * 2**20),
                                       ("1x1", 2, 4096), ("2", 0, 2 * 2**20),
                                       ("1x1", 0, 4096)]):
        f = fit.fit_latency([(a, b * (i + 1), t, w)
                             for a, b, t, w in samples])
        d.put_fit(arch="generic", mesh=m, transport="ring_hier", channels=ch,
                  page_bytes=page, fit=f)
    f = fit.fit_latency(samples)
    d.put_fit(arch="generic", mesh="1x1", transport="psum", channels=0,
              page_bytes=2 * 2**20, fit=f)
    d.save(path)


def _events(run_dir: str) -> list:
    with open(os.path.join(run_dir, "events.jsonl")) as f:
        return [json.loads(line) for line in f]


def _ref_tuned_key(path: str, run_dir: str) -> str:
    """The key the reference's Trainer records for ``tuned_db=path``."""
    import jax

    from repro.configs import reduced_config as ref_reduced
    from repro.configs.base import ShapeConfig
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticTokens as RefTokens
    from repro.models import build_model as ref_build
    from repro.obs import ObsConfig as RefObs
    from repro.runtime.train_loop import Trainer as RefTrainer
    from repro.runtime.train_loop import TrainerConfig as RefTrainerConfig
    from repro.runtime.train_step import TrainStepConfig as RefStepConfig

    model = ref_build(ref_reduced("llama3.2-1b"))
    data = RefTokens(RefDataConfig(vocab_size=model.cfg.vocab_size,
                                   seq_len=32, global_batch=4))
    tr = RefTrainer(model, ref_mesh.make_host_mesh(), RefStepConfig(), data,
                    ShapeConfig("train", 32, 4, "train"),
                    RefTrainerConfig(steps=0, obs=RefObs(run_dir=run_dir,
                                                         tuned_db=path)),
                    log=lambda m: None)
    tr.obs.finish()
    assert len(jax.devices()) == 1
    (rec,) = [e for e in _events(run_dir) if e["name"] == "tuned_record"]
    return rec["fields"]["key"]


def test_trainer_predicts_and_picks_the_references_record(tmp_path):
    path = str(tmp_path / "tuning.json")
    _db(path)
    model = build_model(reduced_config("llama3.2-1b"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    keys = {}
    for name, kw in (("roofline", dict(predict=True)),
                     ("tuned", dict(tuned_db=path))):
        run_dir = str(tmp_path / name)
        tr = Trainer(model, RankMesh(("data", "model"), (1, 1)),
                     TrainStepConfig(), data,
                     TrainerConfig(steps=3, log_every=100,
                                   obs=ObsConfig(run_dir=run_dir, **kw)),
                     device=torch.device("cpu"), log=lambda m: None)
        assert tr.drift is not None and tr.drift.source == name
        tr.run()
        recs = _events(run_dir)
        events = {r["name"]: r["fields"] for r in recs
                  if r["kind"] == "event"}
        assert "predict_failed" not in events
        assert events["prediction"]["source"] == name
        assert events["prediction"]["t_step_s"] == tr.drift.predicted_s > 0
        gauges = [r for r in recs if r["kind"] == "gauge"
                  and r["name"] == "model_error"]
        assert len(gauges) == 3
        assert sorted(r["fields"]["step"] for r in recs
                      if r["name"] == "drift_sample") == [0, 1, 2]
        if name == "tuned":
            keys["port"] = events["tuned_record"]["key"]
            rec = TuningDB.load(path).records[keys["port"]]
            assert events["prediction"]["alpha_s"] == rec["fit"]["alpha_s"]
    keys["ref"] = _ref_tuned_key(path, str(tmp_path / "ref"))
    assert keys["port"] == keys["ref"] == \
        "tune|generic|1x1|ring_hier|ch0|p2097152"


def test_a_failed_prediction_is_advisory(tmp_path):
    model = build_model(reduced_config("llama3.2-1b"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=32, global_batch=4))
    run_dir = str(tmp_path / "obs")
    bad = str(tmp_path / "not_a_db.json")
    with open(bad, "w") as f:
        f.write("[]")
    tr = Trainer(model, RankMesh(("data",), (1,)), TrainStepConfig(), data,
                 TrainerConfig(steps=1, log_every=100,
                               obs=ObsConfig(run_dir=run_dir, tuned_db=bad)),
                 device=torch.device("cpu"), log=lambda m: None)
    assert tr.drift is None
    tr.run()
    names = [r["name"] for r in _events(run_dir) if r["kind"] == "event"]
    assert "predict_failed" in names and "prediction" not in names


def test_mesh_flags_refuse_a_world_of_the_wrong_size(monkeypatch):
    assert mesh.make_production_mesh() == RankMesh(("data", "model"),
                                                   (16, 16))
    assert mesh.make_production_mesh(multi_pod=True) == RankMesh(
        ("pod", "data", "model"), (2, 16, 16))
    for mp in (False, True):
        assert mesh.required_devices(mp) == ref_mesh.required_devices(mp)
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    with pytest.raises(SystemExit, match=r"required_devices\(False\) = 256"
                       r".* has 2"):
        launch_train.main(BASE + ["--nproc", "2", "--production-mesh"])
    with pytest.raises(SystemExit, match=r"required_devices\(True\) = 512"):
        launch_train.main(BASE + ["--nproc", "2", "--production-mesh",
                                  "--multi-pod"])
    with pytest.raises(SystemExit, match="--multi-pod needs"):
        launch_train.main(BASE + ["--multi-pod"])
    with pytest.raises(SystemExit, match=r"256 ranks; this launch has 1"):
        launch_serve.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                           "cpu", "--production-mesh"])
    with pytest.raises(SystemExit, match="drop --paged"):
        launch_serve.main(["--arch", "llama3.2-1b", "--reduced", "--device",
                           "cpu", "--production-mesh", "--paged"])
