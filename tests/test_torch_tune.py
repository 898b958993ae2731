"""repro_torch.tune against the reference's repro.tune: the fitter, the
synthesized (``--dry``) cells, the DB keys, ``LatencyModel.from_record``,
``CommPlan.bucket_channel``, and each package reading the tuning DB the
other wrote (one reference ``--dry`` subprocess) with the same lookup,
best config and resolution, warnings included."""

import dataclasses
import json
import os
import subprocess
import sys
import types
import warnings

import numpy as np
import pytest

from repro.comm import CommConfig as RefCommConfig
from repro.comm import Communicator as RefCommunicator
from repro.comm.plan import LatencyModel as RefLatencyModel
from repro.configs import reduced_config as ref_reduced_config
from repro.launch.settings import ArchSettings as RefArchSettings
from repro.models import build_model as ref_build_model
from repro.tune import db as ref_db
from repro.tune import fit as ref_fit
from repro.tune import probe as ref_probe
from repro.tune import resolve as ref_resolve
from repro_torch.comm import CommConfig, Communicator
from repro_torch.comm.plan import LatencyModel
from repro_torch.configs import reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.launch.settings import ArchSettings, settings_for
from repro_torch.models import build_model
from repro_torch.runtime.train_step import abstract_params
from repro_torch.tune import db, fit, probe, resolve

PLANT_ALPHA = 3.2e-6
PLANT_BW = 37.5e9
SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")


def _samples(seed: int, n: int = 12):
    """Probe-like samples: message counts and bytes varying, 0.1 % noise,
    dispersion weights."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        m = float(rng.choice([2, 4, 8, 16, 32]))
        b = float(rng.randint(1 << 10, 1 << 24))
        t = PLANT_ALPHA * m + b / PLANT_BW
        t *= 1 + 1e-3 * rng.randn()
        lo, hi = t * (1 - 1e-3 * rng.rand()), t * (1 + 1e-3 * rng.rand())
        out.append((m, b, t, fit.dispersion_weight(t, lo, hi)))
    return out


@pytest.mark.parametrize("seed", range(4))
def test_fit_latency_agrees_with_the_reference(seed):
    samples = _samples(seed)
    got, want = fit.fit_latency(samples), ref_fit.fit_latency(samples)
    for k, v in want.as_dict().items():
        g = got.as_dict()[k]
        np.testing.assert_allclose(g, v, rtol=1e-12, atol=0, err_msg=k)
    assert abs(got.alpha_s - PLANT_ALPHA) / PLANT_ALPHA < 0.01
    assert abs(got.bandwidth - PLANT_BW) / PLANT_BW < 0.01


def test_fit_clamps_like_the_reference():
    # negative α and β from the unconstrained solution
    samples = [(10, 1e6, 1e-6, 1.0), (1, 1e3, 5e-4, 1.0), (3, 5e5, 1e-7, 1.0)]
    got, want = fit.fit_latency(samples), ref_fit.fit_latency(samples)
    assert got.as_dict() == want.as_dict()
    assert got.alpha_s >= 0 and got.bandwidth <= 1e15
    with pytest.raises(ValueError):
        fit.fit_latency([])


MATRICES = [
    dict(),
    dict(transports=("ring_hier", "psum", "ring"), channels=(1, 2),
         pages=(4096, 2 * 2**20), sizes=(1 << 12, 1 << 16, 1 << 20)),
    dict(transports=("ring", "ring_hier"), mesh=(2,), axes=("data",),
         sizes=(1000, 12345), alpha_s=PLANT_ALPHA, bandwidth=PLANT_BW),
    dict(transports=("psum", "ring_hier"), mesh=(4, 2, 2),
         axes=("pod", "data", "x"), arch="llama3.2-1b"),
]


@pytest.mark.parametrize("kw", MATRICES, ids=range(len(MATRICES)))
def test_synthesized_cells_are_the_references(kw):
    got = probe.synthesize_cells(**kw)
    want = ref_probe.synthesize_cells(**kw)
    assert [c.as_dict() for c in got] == [c.as_dict() for c in want]
    groups = probe.group_cells(got)
    assert list(groups) == list(ref_probe.group_cells(want))
    for key, group in groups.items():
        f = probe.fit_cells(group).as_dict()
        assert f == ref_fit.fit_cells(ref_probe.group_cells(want)[key]
                                      ).as_dict()
    line = "CELL " + json.dumps(got[0].as_dict())
    assert probe.parse_cells("x\n" + line + "\ny") == [got[0]]


OVERRIDES = [None, {}, {"b": 1, "a": [1, 2]}, {"a": [1, 2], "b": 1},
             {"x": {"z": 1, "y": 2.5}, "q": None, "s": "str"}]


@pytest.mark.parametrize("ov", OVERRIDES, ids=range(len(OVERRIDES)))
def test_keys_are_the_references(ov):
    assert db.overrides_fingerprint(ov) == ref_db.overrides_fingerprint(ov)
    args = ("llama3.2-1b", "2x4", "ring_hier", 2, 4096)
    assert db.tune_key(*args, overrides=ov) == \
        ref_db.tune_key(*args, overrides=ov)
    assert (db.DEFAULT_DB_PATH, db.GENERIC_ARCH, db.DB_VERSION) == \
        (ref_db.DEFAULT_DB_PATH, ref_db.GENERIC_ARCH, ref_db.DB_VERSION)


def _resolutions(pkg_db, pkg_resolve, settings_cls, path):
    """Everything one package reads from the DB at ``path``."""
    d = pkg_db.TuningDB.load(path)
    out = {"len": len(d), "keys": sorted(d.records)}
    queries = [dict(), dict(transport="psum"),
               dict(transport="ring_hier", mesh="2x4", channels=2),
               dict(arch="llama3.2-1b", mesh="2x1", page_bytes=2 * 2**20),
               dict(transport="ring", channels=9), dict(mesh="nope")]
    out["lookup"] = [pkg_db.TuningDB.lookup(d, **q) for q in queries]
    out["best"] = [d.best_config(**q) for q in (
        dict(), dict(arch="llama3.2-1b", mesh="2x1"),
        dict(transport="psum", ref_bytes=1 << 20), dict(mesh="2x4"),
        dict(transport="ring"))]
    out["fits"] = {k: d.fit_for(k).as_dict() for k in d.records}
    out["errors"] = {k: pkg_db.model_error_summary(r)
                     for k, r in d.records.items()}
    res = []
    for st, kw in (
            (settings_cls("zero1", 1, "resident", transport="auto",
                          page_bytes="auto"), dict(mesh_label="2x1")),
            (settings_cls("zero1", 1, "resident"), dict()),
            (settings_cls("zero1", 1, "resident", channels=2), dict()),
            (settings_cls("fsdp", 1, "resident", transport="ring",
                          page_bytes="auto"), dict(mesh_label="2x4"))):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got, info = pkg_resolve.resolve_settings(st, "llama3.2-1b", db=d,
                                                     **kw)
        res.append((dataclasses.asdict(got), info,
                    [str(w.message).replace("repro_torch.tune",
                                            "repro.tune") for w in caught]))
    out["resolve"] = res
    return out


def test_each_package_reads_the_others_db(tmp_path):
    ref_path, port_path = str(tmp_path / "ref.json"), str(tmp_path /
                                                          "port.json")
    argv = ["--dry", "--transports", "ring_hier", "psum", "--channels", "1",
            "2", "--page-bytes", "4096", "2097152", "--sizes", "4096",
            "65536", "1048576", "--plant-alpha", str(PLANT_ALPHA),
            "--plant-bandwidth", str(PLANT_BW)]
    env = dict(os.environ, PYTHONPATH=SRC + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-m", "repro.tune.probe", *argv,
                        "--out", ref_path], capture_output=True, text=True,
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-2000:]
    assert probe.main(argv + ["--out", port_path]) == 0
    # the same file but for the records' creation times
    a, b = (json.load(open(p)) for p in (ref_path, port_path))
    for rec in list(a["records"].values()) + list(b["records"].values()):
        rec.pop("created")
    assert a == b
    for path in (ref_path, port_path):
        port = _resolutions(db, resolve, ArchSettings, path)
        ref = _resolutions(ref_db, ref_resolve, RefArchSettings, path)
        assert port == ref
        fallback = port["resolve"][3]
        assert fallback[1]["source"] == "fallback" and fallback[2]
    # and what the port writes, the reference loads (and the other way)
    d = db.TuningDB.load(ref_path)
    d.save(str(tmp_path / "again.json"))
    assert ref_db.TuningDB.load(str(tmp_path / "again.json")).records == \
        ref_db.TuningDB.load(ref_path).records


def test_resolution_warns_and_falls_back_like_the_reference():
    st = ArchSettings("replicated", 1, "resident", transport="auto",
                      page_bytes="auto")
    with pytest.warns(UserWarning, match="no tuning-DB record"):
        got, info = resolve.resolve_settings(st, "llama3.2-1b",
                                             db=db.TuningDB())
    assert info == {"source": "fallback", "hard": ["transport",
                                                   "page_bytes"]}
    assert (got.transport, got.page_bytes, got.channels) == (
        resolve.FALLBACK_TRANSPORT, resolve.FALLBACK_PAGE_BYTES, 0)
    assert (resolve.FALLBACK_TRANSPORT, resolve.FALLBACK_PAGE_BYTES) == (
        ref_resolve.FALLBACK_TRANSPORT, ref_resolve.FALLBACK_PAGE_BYTES)
    with pytest.warns(UserWarning, match="unresolved 'auto'"):
        ccfg = st.comm_config()
    assert (ccfg.transport, ccfg.page_bytes) == ("ring_hier", 2 * 2**20)
    same, info = resolve.resolve_settings(
        ArchSettings("zero1", 1, "resident", channels=1), "x")
    assert info == {"source": "unchanged"}
    assert resolve.has_auto(settings_for("llama3.2-1b"))      # channels 0
    with pytest.raises(ValueError, match="unknown arch 'nope'"):
        settings_for("nope")


def test_from_record_is_the_references():
    f = fit.fit_latency(_samples(7))
    rec = {"fit": f.as_dict()}
    for x in (f, rec, f.as_dict()):
        want = RefLatencyModel.from_record(
            ref_fit.FitResult.from_dict(f.as_dict()) if x is f else x)
        got = LatencyModel.from_record(x)
        assert (got.alpha_s, got.bandwidth) == (want.alpha_s, want.bandwidth)
        assert got.collective_seconds(14, 1e6) == \
            want.collective_seconds(14, 1e6)


@pytest.mark.parametrize("channels", [0, 1, 2, 3])
def test_bucket_channel_is_the_references(channels):
    kw = dict(transport="ring_hier", channels=channels, chunks=2,
              bucket_bytes=16 * 1024, data_axes=("data",))
    jtree = ref_build_model(ref_reduced_config("llama3.2-1b")
                            ).abstract_params()
    tree = abstract_params(build_model(reduced_config("llama3.2-1b")))
    fake = types.SimpleNamespace(axis_names=("data", "model"),
                                 devices=np.empty((2, 1)))
    jplan = RefCommunicator(fake, RefCommConfig(**kw)).plan(jtree)
    plan = Communicator(RankMesh(("data", "model"), (2, 1)),
                        CommConfig(**kw), connect=False).plan(tree)
    assert plan.n_buckets == jplan.n_buckets > 1
    for b in range(plan.n_buckets):
        assert plan.bucket_channel(b) == jplan.bucket_channel(b)
    with pytest.raises(KeyError):
        plan.bucket_channel(plan.n_buckets)


def test_timing_is_the_references(monkeypatch):
    """The port's timer: the reference's ``Timing`` (true median,
    dispersion) from ``warmup`` untimed and ``iters`` timed calls."""
    import time

    from benchmarks.common import Timing as RefTiming
    from repro_torch.tune.timing import Timing, time_call

    for samples in ([4.0, 2.0], [1.0, 2.0, 3.0, 10.0], [5.0], [3, 1, 2]):
        got, want = Timing(samples), RefTiming(samples)
        assert (float(got), got.t_min, got.t_max, got.samples,
                got.spread) == (float(want), want.t_min, want.t_max,
                                want.samples, want.spread)
    ticks = iter([0.0, 1.0, 10.0, 12.0, 20.0, 23.0, 30.0, 40.0])
    monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
    calls = []
    t = time_call(lambda: calls.append(1), warmup=2, iters=4)
    assert len(calls) == 6
    assert (float(t), t.t_min, t.t_max) == (2.5, 1.0, 10.0)
