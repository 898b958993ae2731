"""repro_torch's all-to-all surface against the JAX reference.

Plan only (no ranks): ``a2a_rails``, ``moe_schedule``'s slots and
``A2APlan.describe()`` equal the reference's for every all-to-all
transport and channel count (plans are plain arithmetic, so equal), as do
each transport's predicted bytes and messages per exchange; ``_a2a_axis``
refuses a communicator of two axes and a transport without all-to-all;
an axis of one rank is the identity.

Four gloo ranks on a ``("model",)`` axis, each of ``a2a``, ``ring``,
``ring_hier`` and ``psum`` over one and two rails:

* the forward equals the tiled all-to-all's semantics computed from every
  rank's payload, for several split and concat axes, bitwise (over two
  rails, that of each stripe of the last dimension, the reference's
  channelized exchange: the tiled one wherever neither axis is the last,
  as in the MoE layer);
* the backward equals the inverse exchange of every rank's cotangent,
  bitwise;
* ``all_to_all_ragged`` delivers source ``j``'s count for this rank;
* one forward + backward records what ``A2APlan`` predicts for one
  dispatch + combine: ``all_to_all_bytes`` (``a2a``) or ``send_bytes``
  (ring) equal to ``bytes_per_device`` and the calls or sends to
  ``messages_per_device`` divided by the hops per call; under ``psum``
  the all-reduced matrix's payload times ``2(p-1)/p``.
"""

import types

import numpy as np
import pytest
import torch

import torch_moe_jobs as jobs
from torch_dist_util import run_ranks
from repro.comm import CommConfig as JaxCommConfig
from repro.comm import Communicator as JaxCommunicator
from repro_torch.comm import CommConfig, Communicator
from repro_torch.core.topology import RankMesh

WORLD = 4
SHAPES = [(2, 4, 8, 16), (4, 8, 3, 15), (8, 6)]
CASES = [((2, 4, 8, 16), 1, 0), ((4, 4, 8, 16), 0, 1), ((4, 8, 3, 15), 1, 0),
         ((8, 6), 0, 0), ((8, 12), 0, 1)]


def _pair(transport, channels, world=WORLD):
    kw = dict(transport=transport, channels=channels, data_axes=("model",))
    fake = types.SimpleNamespace(axis_names=("model",),
                                 devices=np.empty((world,)))
    return (JaxCommunicator(fake, JaxCommConfig(**kw)),
            Communicator(RankMesh(("model",), (world,)), CommConfig(**kw),
                         connect=False))


def _slots(sched):
    return [(s.phase, s.bucket_ids, s.channel, s.ready) for s in sched.slots]


@pytest.mark.parametrize("channels", [0, 1, 2, 3])
@pytest.mark.parametrize("transport", jobs.TRANSPORTS)
def test_plans_equal_reference(transport, channels):
    jcomm, comm = _pair(transport, channels)
    for shape in SHAPES:
        assert comm.a2a_rails(shape) == jcomm.a2a_rails(shape)
        for dt, jdt in ((torch.float32, np.float32),
                        (torch.bfloat16, "bfloat16")):
            assert _slots(comm.moe_schedule(shape, dt)) == \
                _slots(jcomm.moe_schedule(shape, jdt))
            assert comm.a2a_plan(shape, dt).describe() == \
                jcomm.a2a_plan(shape, jdt).describe()
    for n, p in ((1000, 2), (4096, 4), (7, 8)):
        assert comm.transport.predicted_a2a_bytes_per_device(n, p, 2) == \
            jcomm.transport.predicted_a2a_bytes_per_device(n, p, 2)
        assert comm.transport.predicted_a2a_messages_per_device(p) == \
            jcomm.transport.predicted_a2a_messages_per_device(p)


def test_refusals_and_the_one_rank_axis():
    two = Communicator(RankMesh(("data", "model"), (2, 2)),
                       CommConfig(transport="a2a",
                                  data_axes=("data", "model")),
                       connect=False)
    with pytest.raises(ValueError, match="exactly one comm axis"):
        two.all_to_all(torch.zeros(4, 4), split_axis=0, concat_axis=0)
    with pytest.raises(ValueError, match="exactly one comm axis"):
        two.a2a_plan((4, 4))
    one = Communicator(RankMesh(("model",), (1,)),
                       CommConfig(transport="ring", data_axes=("model",)))
    x = torch.randn(4, 6, requires_grad=True)
    y = one.all_to_all(x, split_axis=0, concat_axis=1)
    assert y is x
    recv, counts = one.all_to_all_ragged(
        x, torch.tensor([3]), split_axis=0, concat_axis=0)
    assert recv is x and counts.tolist() == [3]
    assert one.record.as_dict()["all_to_alls"] == 0


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(jobs.a2a_surface_job, WORLD, CASES)


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("transport", jobs.TRANSPORTS)
def test_exchange_equals_tiled_semantics(ranks, transport, channels):
    for r, out in enumerate(ranks):
        for i in range(len(CASES)):
            res = out[(transport, channels, i)]
            assert res["fwd"], (r, i)
            assert res["bwd"], (r, i)
        ragged = out[(transport, channels, "ragged")]
        assert ragged["counts"] == [r + 10 * j for j in range(WORLD)]
        assert ragged["payload"]


@pytest.mark.parametrize("channels", [1, 2])
@pytest.mark.parametrize("transport", jobs.TRANSPORTS)
def test_recorded_wire_equals_the_plan(ranks, transport, channels):
    p = WORLD
    for out in ranks:
        for i in range(len(CASES)):
            res = out[(transport, channels, i)]
            rec, plan = res["record"], res["plan"]
            rails = len(plan["channels"])
            calls = 2 * rails              # forward + backward, per rail
            if transport == "a2a":
                assert rec["all_to_alls"] == calls
                assert rec["all_to_all_bytes"] == plan["bytes_per_device"]
                assert plan["messages_per_device"] == calls * (p - 1)
                assert rec["sends"] == rec["all_reduces"] == 0
            elif transport == "psum":
                assert rec["all_reduces"] == calls
                assert rec["all_reduce_bytes"] * 2 * (p - 1) / p == \
                    plan["bytes_per_device"]
                assert plan["messages_per_device"] == calls * 2 * (p - 1)
                assert rec["sends"] == rec["all_to_alls"] == 0
            else:
                assert rec["sends"] == plan["messages_per_device"] == \
                    calls * (p - 1)
                assert rec["send_bytes"] == plan["bytes_per_device"]
                assert rec["all_to_alls"] == rec["all_reduces"] == 0
            shape = CASES[i][0]
            want_rails = channels if shape[-1] % channels == 0 else 1
            assert rails == want_rails
