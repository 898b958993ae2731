"""repro_torch.runtime.ft against the reference's ``repro.runtime.ft``: the
straggler monitor, heartbeats and the elastic mesh shape give the
reference's verdicts, events and shapes on the same inputs (the bus
records compared exactly, under one fixed clock)."""

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.obs.bus import MetricsBus as RefBus
from repro.runtime import ft as ref_ft
from repro_torch.core.topology import RankMesh
from repro_torch.obs.bus import MetricsBus
from repro_torch.runtime import ft


def _recording(bus_cls):
    """A bus whose records land in a list (clock fixed at 0)."""
    bus = bus_cls(clock=lambda: 0.0)
    records = []
    bus._emit = records.append
    return bus, records


def _monitor_run(mod, bus_cls, times, **kw):
    bus, records = _recording(bus_cls)
    mon = mod.StragglerMonitor(bus=bus, **kw)
    verdicts = [mon.record(i, t) for i, t in enumerate(times)]
    as_tuple = lambda e: (e.step, e.seconds, e.ewma, e.flagged,  # noqa: E731
                          bool(e), e.ratio)
    return ([as_tuple(v) for v in verdicts], [as_tuple(e) for e in mon.events],
            records, bus.counters)


MONITOR_CASES = {
    "steady": ([0.1] * 8 + [0.5, 0.1], {}),
    "compile_step_first": ([5.0, 0.1, 0.2, 0.1, 0.35, 0.1], {"warmup_steps": 2}),
    "no_warmup": ([0.2, 0.2, 0.9, 0.2, 0.21], {"warmup_steps": 0}),
    "tight": ([1.0, 1.1, 0.9, 1.3, 1.0, 2.0], {"threshold": 1.2,
                                              "decay": 0.5}),
    "all_flagged_after_warmup": ([0.1, 0.1, 0.1, 1.0, 1.0, 1.0], {}),
}


@pytest.mark.parametrize("name", list(MONITOR_CASES))
def test_straggler_monitor_matches_reference(name):
    times, kw = MONITOR_CASES[name]
    assert _monitor_run(ft, MetricsBus, times, **kw) == \
        _monitor_run(ref_ft, RefBus, times, **kw)


@settings(max_examples=100, deadline=None)
@given(times=st.lists(st.floats(1e-4, 10.0), max_size=30),
       threshold=st.floats(1.05, 4.0), decay=st.floats(0.0, 0.99),
       warmup=st.integers(0, 5))
def test_straggler_monitor_property(times, threshold, decay, warmup):
    kw = dict(threshold=threshold, decay=decay, warmup_steps=warmup)
    assert _monitor_run(ft, MetricsBus, times, **kw) == \
        _monitor_run(ref_ft, RefBus, times, **kw)


def _heartbeats(mod, bus_cls, root):
    bus, records = _recording(bus_cls)
    a = mod.Heartbeat(str(root / "beats"), "a", timeout=10.0, bus=bus)
    b = mod.Heartbeat(str(root / "beats"), "b", timeout=10.0)
    c = mod.Heartbeat(str(root / "beats"), "c", timeout=10.0)
    a.beat(now=100.0)
    b.beat(now=100.0)
    c.beat(now=95.0)
    seen = [a.dead_hosts(now=105.0), a.dead_hosts(now=110.0),
            a.dead_hosts(now=110.1), b.dead_hosts(now=110.1)]
    b.beat(now=111.0)
    seen += [a.dead_hosts(now=112.0), a.prune_stale(now=150.0),
             a.prune_stale(now=200.0), a.dead_hosts(now=200.0),
             a.prune_stale(now=1e9)]
    return seen, records


def test_heartbeat_matches_reference(tmp_path):
    mine = _heartbeats(ft, MetricsBus, tmp_path / "port")
    theirs = _heartbeats(ref_ft, RefBus, tmp_path / "ref")
    assert mine == theirs
    assert ["c"] in mine[0] and any(r["name"] == "host_pruned"
                                    for r in mine[1])


@pytest.mark.parametrize("n", [1, 2, 3, 6, 8, 12, 16, 24, 48, 256, 257])
@pytest.mark.parametrize("mp,pods", [(16, 1), (16, 2), (4, 3), (1, 1),
                                     (1, 4)])
def test_elastic_shape_matches_reference(n, mp, pods):
    assert ft.elastic_shape(n, model_parallel=mp, want_pods=pods) == \
        ref_ft.elastic_shape(n, model_parallel=mp, want_pods=pods)


def test_elastic_remesh_is_data_only():
    assert ft.elastic_remesh(6, model_parallel=1) == RankMesh(("data",), (6,))
    assert ft.elastic_remesh(6, model_parallel=1, want_pods=2) == \
        RankMesh(("pod", "data"), (2, 3))
    with pytest.raises(NotImplementedError, match="Queue 1 #6"):
        ft.elastic_remesh(32)
    with pytest.raises(ValueError):
        ft.elastic_shape(0)
