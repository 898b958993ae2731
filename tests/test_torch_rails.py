"""Each rail's collectives on a host thread of its own
(``repro_torch.comm.rails``), on two gloo CPU ranks: the threads run here
as on the card, the rails' CUDA streams only there (``chip_smoke.py``'s
rails job checks those).

At 2 and 3 rails every striped path gives bitwise what one rail gives on
the same buckets: ``all_reduce_tree``, ``reduce_scatter_tree`` +
``all_gather_buckets``, ``reduce_scheduled`` over the fp32 and the int8
arena under every schedule policy, and the all-to-all striped over the
rails.  Each is also bitwise, with every ``CommRecord`` count equal, the
same communicator's issue in program order on one thread (the order before
the rails had threads of their own).  Where striping does not change the
buckets, the sends and bytes equal one rail's; the arena lays out one span
a rail and the all-to-all splits its payload a rail, so there the bytes
equal one rail's and the messages the plan's.  The int8 arena's blocks
follow its spans, so at several rails it is held to the one-thread issue
alone.  A rail's exception reaches the caller, and the launch counters lose
no count from 8 threads.

One 2-rank spawn (``tests/torch_rails_jobs.py::rails_job``), no JAX.
"""

from __future__ import annotations

import sys
import threading

import numpy as np
import pytest
import torch

import torch_rails_jobs as jobs
from torch_dist_util import run_ranks
from repro_torch.comm import SCHEDULE_POLICIES, CommConfig, Communicator
from repro_torch.comm.rails import RailExecutor
from repro_torch.core.topology import RankMesh

MULTI = [r for r in jobs.RAIL_COUNTS if r >= 2]


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(jobs.rails_job, 2)


def _same(a: dict, b: dict, what: str) -> None:
    assert a.keys() == b.keys(), what
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=f"{what} {k}")


def _check(ranks, name: str, rails: int, *, like_one: bool,
           wire_like_one: bool) -> None:
    for r, res in enumerate(ranks):
        threads = res[(name, rails, "threads")]
        seq = res[(name, rails, "sequential")]
        one = res[(name, 1, "sequential")]
        what = f"{name} rank {r} at {rails} rails"
        _same(threads["out"], seq["out"], what + " vs one thread")
        assert threads["record"] == seq["record"], what
        if like_one:
            # (an arena's own layout, and its "ef", follow its spans)
            keys = [k for k in one["out"] if k not in ("arena", "ef")]
            _same({k: threads["out"][k] for k in keys},
                  {k: one["out"][k] for k in keys}, what + " vs one rail")
        if wire_like_one:
            assert threads["record"] == one["record"], what


@pytest.mark.parametrize("rails", MULTI)
@pytest.mark.parametrize("path", ["all_reduce", "rs_ag"])
def test_tree_collectives_bitwise_across_rails(ranks, path, rails):
    _check(ranks, path, rails, like_one=True, wire_like_one=True)


@pytest.mark.parametrize("rails", MULTI)
@pytest.mark.parametrize("arena", ["fp32", "int8"])
@pytest.mark.parametrize("policy", SCHEDULE_POLICIES)
def test_scheduled_arena_bitwise_across_rails(ranks, policy, arena, rails):
    name = f"arena_{arena}/{policy}"
    _check(ranks, name, rails, like_one=arena == "fp32",
           wire_like_one=False)
    for res in ranks:
        got = res[(name, rails, "threads")]
        one = res[(name, 1, "sequential")]
        # one span a rail: the plan's messages (two microbatches: twice
        # per step under a streamed policy), the bytes one rail's
        phases = 1 if policy == "accumulate_then_reduce" else 2
        assert got["record"]["sends"] == got["plan"] * phases
        if arena == "fp32":
            assert got["record"]["send_bytes"] == one["record"]["send_bytes"]
        np.testing.assert_array_equal(got["out"]["loss"], one["out"]["loss"])


@pytest.mark.parametrize("rails", MULTI)
@pytest.mark.parametrize("transport", jobs.A2A_TRANSPORTS)
def test_all_to_all_striped_over_rails(ranks, transport, rails):
    name = f"a2a_{transport}"
    _check(ranks, name, rails, like_one=True, wire_like_one=False)
    for res in ranks:
        got, one = res[(name, rails, "threads")], res[(name, 1, "sequential")]
        assert got["rails"] == rails and one["rails"] == 1
        # one exchange a rail, each of its slice of the payload
        moved = ("send_bytes" if transport == "ring" else "all_to_all_bytes")
        calls = "sends" if transport == "ring" else "all_to_alls"
        assert got["record"][moved] == one["record"][moved]
        assert got["record"][calls] == rails * one["record"][calls]


def test_rails_run_on_threads_of_their_own_and_raise_in_the_caller(
        monkeypatch):
    mesh = RankMesh(("data",), (1,))
    one = Communicator(mesh, CommConfig(data_axes=("data",), channels=1))
    assert one._executor is None
    assert all(r.stream is None for r in one.transport.rails)
    comm = Communicator(mesh, CommConfig(data_axes=("data",), channels=2))
    assert comm._executor is not None
    # no card here: the rails have threads and no stream
    assert all(r.stream is None for r in comm.transport.rails)
    seen = []
    real = comm.transport.all_reduce

    def spy(flat, rail=0):
        seen.append((rail, threading.current_thread().name))
        return real(flat, rail)

    monkeypatch.setattr(comm.transport, "all_reduce", spy)
    bufs = [torch.full((256,), float(i)) for i in range(4)]
    out = comm.all_reduce(bufs)
    for b, o in zip(bufs, out):
        torch.testing.assert_close(o, b, rtol=0, atol=0)
    names = {rail: {n for c, n in seen if c == rail} for rail in (0, 1)}
    main = threading.main_thread().name
    assert all(len(v) == 1 and main not in v for v in names.values())
    assert names[0] != names[1]

    def boom(flat, rail=0):
        if rail == 1:
            raise ValueError("rail broke")
        seen.append((rail, "ok"))
        return real(flat, rail)

    monkeypatch.setattr(comm.transport, "all_reduce", boom)
    seen.clear()
    with pytest.raises(ValueError, match="rail broke") as err:
        comm.all_reduce(bufs)
    assert any("rail 1" in note for note in err.value.__notes__)
    assert seen == [(0, "ok"), (0, "ok")]      # rail 0 ran to its end

    # every rail is joined before the first failure is raised
    done = []
    ex = RailExecutor([None, None, None])

    def late(i):
        def fn():
            threading.Event().wait(0.05)
            done.append(i)
        return fn

    def fail():
        raise RuntimeError("first")

    with pytest.raises(RuntimeError, match="first"):
        ex.run([(0, fail), (1, late(1)), (2, late(2))])
    assert sorted(done) == [1, 2]


def _counters():
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.pack import ops as pk
    from repro_torch.kernels.pack_quant import ops as pq
    from repro_torch.kernels.quant import ops as qt
    from repro_torch.kernels.reduce_add import ops as ra

    return fd, ra, fa, pk, qt, pq


def _snapshot():
    fd, ra, fa, pk, qt, pq = _counters()
    return (fd.LAUNCHES, ra.LAUNCHES, fa.LAUNCHES, dict(fa.LAUNCHES_BY_ROUTE),
            dict(pk.LAUNCHES), dict(pk.LAUNCHES_BY_ROUTE), dict(qt.LAUNCHES),
            dict(pq.LAUNCHES))


def test_launch_counters_lose_no_count_from_eight_threads():
    fd, ra, fa, pk, qt, pq = _counters()
    before = _snapshot()
    n, threads = 2000, 8

    def hammer():
        for _ in range(n):
            fd.count_launch()
            ra.count_launch()
            fa.count_launch("wgmma")
            pk.count_launch("write", "bulk")
            qt.count_launch("dequantize")
            pq.count_launch("read")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)              # switch threads as often as can be
    try:
        ts = [threading.Thread(target=hammer) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in ts)
        total = n * threads
        assert fd.LAUNCHES == before[0] + total
        assert ra.LAUNCHES == before[1] + total
        assert fa.LAUNCHES == before[2] + total
        assert fa.LAUNCHES_BY_ROUTE["wgmma"] == before[3]["wgmma"] + total
        assert pk.LAUNCHES["write"] == before[4]["write"] + total
        assert pk.LAUNCHES_BY_ROUTE["bulk"] == before[5]["bulk"] + total
        assert qt.LAUNCHES["dequantize"] == before[6]["dequantize"] + total
        assert pq.LAUNCHES["read"] == before[7]["read"] + total
    finally:
        sys.setswitchinterval(interval)
        fd.LAUNCHES, ra.LAUNCHES, fa.LAUNCHES = before[:3]
        fa.LAUNCHES_BY_ROUTE.update(before[3])
        pk.LAUNCHES.update(before[4])
        pk.LAUNCHES_BY_ROUTE.update(before[5])
        qt.LAUNCHES.update(before[6])
        pq.LAUNCHES.update(before[7])
