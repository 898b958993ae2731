"""repro_torch's Cartesian halo exchange and its plans against the JAX
reference.

The plans are plain Python on both sides: ``halo_units`` and
``build_halo_schedule`` on ``tests/test_stencil.py``'s grid (in process),
and ``Communicator.halo_plan`` / ``halo_schedule`` with
``arena_from_halo_plan`` on meshes of 2, 4 and 8 fake devices (one JAX
subprocess), field for field.  The exchange itself runs on 2 gloo ranks
(mesh ``(2,)``) and 4 (mesh ``(2, 2)``): every schedule, halo 1 and 2,
faces that split unevenly into chunks, random data; the received faces
are exactly the ones a periodic roll of the global lattice gives, and the
sends and bytes each rank records are the plan's units on axes of more
than one rank.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_stencil_jobs as jobs

from repro.comm import build_halo_schedule as ref_build_halo_schedule
from repro.comm import halo_units as ref_halo_units
from repro.core.halo import HaloSpec as RefSpec
from repro.core.halo import chunk_sizes as ref_chunk_sizes
from repro.core.halo import face_split_dim as ref_face_split_dim
from repro_torch.comm import (CommConfig, Communicator, HALO_SCHEDULES,
                              build_halo_schedule, halo_interior_fraction,
                              halo_units)
from repro_torch.core.halo import (HaloSpec, _split_chunks, chunk_sizes,
                                   face_split_dim, halo_bytes, halo_exchange,
                                   pad_with_halos)
from repro_torch.core.topology import RankMesh
from repro_torch.mem.layout import arena_from_halo_plan

SHAPE = (6, 7, 5, 3)


def _specs(cls, halo):
    return [cls("x", 0, halo), cls("y", 1, halo), cls("z", 2, halo)]


def _schedule_fields(s) -> dict:
    return {"policy": s.policy, "microbatches": s.microbatches,
            "bucket_sizes": tuple(s.bucket_sizes), "channels": s.channels,
            "slots": [(x.phase, tuple(x.bucket_ids), x.channel, x.ready)
                      for x in s.slots],
            "overlap_fraction": s.overlap_fraction,
            "describe": s.describe()}


@pytest.mark.parametrize("schedule", HALO_SCHEDULES)
@pytest.mark.parametrize("channels", [0, 1, 2, 4])
@pytest.mark.parametrize("halo", [1, 2])
def test_halo_schedule_and_units_equal_the_reference(schedule, channels,
                                                     halo):
    for sizes in (None, {"x": 2, "y": 1, "z": 4}):
        kw = dict(schedule=schedule, chunks=3, axis_sizes=sizes)
        got = build_halo_schedule(_specs(HaloSpec, halo), SHAPE,
                                  channels=channels, **kw)
        want = ref_build_halo_schedule(_specs(RefSpec, halo), SHAPE,
                                       channels=channels, **kw)
        assert _schedule_fields(got) == _schedule_fields(want)
        assert halo_units(_specs(HaloSpec, halo), SHAPE, **kw) == \
            ref_halo_units(_specs(RefSpec, halo), SHAPE, **kw)
        assert sum(got.bucket_sizes) == halo_bytes(SHAPE,
                                                   _specs(HaloSpec, halo), 4)
    if schedule == "overlap":
        assert got.overlap_fraction == pytest.approx(
            halo_interior_fraction(SHAPE, _specs(HaloSpec, halo)))


def test_chunk_split_is_the_reference_and_round_trips():
    for n, k in [(7, 3), (5, 2), (1, 4), (12, 5), (6, 2), (8, 8)]:
        assert chunk_sizes(n, k) == ref_chunk_sizes(n, k)
    for shape, dim in [((1, 7, 5), 0), ((5, 1, 3), 1), ((9,), 0)]:
        assert face_split_dim(shape, dim) == ref_face_split_dim(shape, dim)
    face = torch.arange(1 * 7 * 5, dtype=torch.float32).reshape(1, 7, 5)
    parts = _split_chunks(face, 3, 0)
    assert [p.shape[1] for p in parts] == [3, 2, 2]
    assert torch.equal(torch.cat(parts, dim=1), face)
    s = build_halo_schedule([HaloSpec("x", 0)], (6, 7, 3),
                            schedule="chunked", chunks=3)
    assert sorted(s.bucket_sizes, reverse=True) == [36, 36, 24, 24, 24, 24]


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown halo schedule"):
        build_halo_schedule([HaloSpec("x", 0)], (4, 4), schedule="bogus")
    with pytest.raises(ValueError, match="schedule must be one of"):
        halo_exchange(torch.zeros(4, 4), [HaloSpec("x", 0)], None,
                      schedule="bogus")


def test_one_process_wraps_every_axis_onto_itself():
    """``rings=None``: each halo is this rank's own opposite face, the
    periodic lattice of one block; ``pad_with_halos`` lays it around x."""
    x = torch.from_numpy(jobs.lattice(0, (6, 5, 3)))
    specs = [HaloSpec("x", 0, 2), HaloSpec("y", 1, 1)]
    for sched in HALO_SCHEDULES:
        got = halo_exchange(x, specs, None, schedule=sched, chunks=2,
                            channels=2)
        want = jobs.expected_halos(x.numpy(), (1, 1), (0, 0), ("x", "y"), 1)
        assert torch.equal(got[("y", "-")],
                           torch.from_numpy(want[("y", "-")]))
        assert torch.equal(got[("x", "-")], x[-2:])
        assert torch.equal(got[("x", "+")], x[:2])
        padded = pad_with_halos(x, got, specs[0])
        assert torch.equal(padded, x[[4, 5, 0, 1, 2, 3, 4, 5, 0, 1]])


PLAN_CASES = [((2,), ("x",), (6, 5, 3)), ((2, 2), ("x", "y"), (5, 7, 3)),
              ((4, 2), ("x", "y"), (5, 7, 3)), ((2, 1), ("x", "y"), (6, 6, 2))]
PLAN_CHANNELS = (0, 2, 3)

REF_PLAN_SCRIPT = r"""
import json
import jax
from repro import compat
from repro.comm import CommConfig, Communicator
from repro.core.halo import HaloSpec
from repro.mem.layout import arena_from_halo_plan

out = {{}}
for mesh_shape, names, local in {cases!r}:
    n = 1
    for p in mesh_shape:
        n *= p
    mesh = compat.make_mesh(tuple(mesh_shape), tuple(names),
                            devices=jax.devices()[:n])
    for channels in {channels!r}:
        comm = Communicator(mesh, CommConfig(transport="psum",
                                             data_axes=tuple(names),
                                             channels=channels))
        for halo in (1, 2):
            specs = [HaloSpec(a, d, halo) for d, a in enumerate(names)]
            for sched in (None, "sequential", "concurrent", "chunked",
                          "overlap"):
                plan = comm.halo_plan(local, specs, schedule=sched)
                lay = arena_from_halo_plan(plan, page_bytes=512,
                                           pad_multiple=8)
                key = f"{{mesh_shape}}/{{channels}}/{{halo}}/{{sched}}"
                out[key] = {{
                    "plan": plan.describe(),
                    "seconds": plan.predicted_collective_seconds(),
                    "schedule": comm.halo_schedule(
                        local, specs, schedule=sched).describe(),
                    "chunks": comm.halo_chunks, "arena": lay.describe()}}
with open({path!r}, "w") as f:
    json.dump(out, f)
print("HALO_PLAN_REF_OK")
"""


@pytest.fixture(scope="module")
def reference_plans():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "plans.json")
        script = REF_PLAN_SCRIPT.format(
            cases=[(list(m), list(n), list(l)) for m, n, l in PLAN_CASES],
            channels=PLAN_CHANNELS, path=path)
        assert "HALO_PLAN_REF_OK" in run_distributed(script, n_devices=8)
        with open(path) as f:
            return json.load(f)


@pytest.mark.parametrize("mesh_shape,names,local", PLAN_CASES)
def test_halo_plan_and_arena_equal_the_reference(reference_plans, mesh_shape,
                                                 names, local):
    for channels in PLAN_CHANNELS:
        comm = Communicator(RankMesh(names, mesh_shape),
                            CommConfig(transport="psum", data_axes=names,
                                       channels=channels), connect=False)
        for halo in (1, 2):
            specs = [HaloSpec(a, d, halo) for d, a in enumerate(names)]
            for sched in (None, "sequential", "concurrent", "chunked",
                          "overlap"):
                want = reference_plans[
                    f"{list(mesh_shape)}/{channels}/{halo}/{sched}"]
                plan = comm.halo_plan(local, specs, schedule=sched)
                lay = arena_from_halo_plan(plan, page_bytes=512,
                                           pad_multiple=8)
                lay.validate()
                # a JSON round trip turns the reference's tuples into lists
                got = json.loads(json.dumps({
                    "plan": plan.describe(),
                    "seconds": plan.predicted_collective_seconds(),
                    "schedule": comm.halo_schedule(
                        local, specs, schedule=sched).describe(),
                    "chunks": comm.halo_chunks, "arena": lay.describe()}))
                assert got == want, (mesh_shape, channels, halo, sched)
                assert plan.channel_imbalance == pytest.approx(
                    want["plan"]["channel_imbalance"])


@pytest.mark.parametrize("world", [2, 4])
def test_received_faces_are_exact_on_every_schedule(world):
    """Random data, so a swap of the two faces between the ranks of an
    axis of two (each other's +1 and -1 neighbour) cannot pass."""
    mesh_shape, names = jobs.MESHES[world]
    local = jobs.HALO_LOCAL[world]
    gshape = tuple(n * p for n, p in zip(local, mesh_shape)) \
        + local[len(mesh_shape):]
    ranks = run_ranks(jobs.halo_job, world)
    for r, out in enumerate(ranks):
        coords = jobs.coords_of(r, mesh_shape)
        assert len(out) == 2 * len(HALO_SCHEDULES)
        for (halo, sched), got in out.items():
            want = jobs.expected_halos(jobs.lattice(10 + halo, gshape),
                                       mesh_shape, coords, names, halo)
            assert set(got["halos"]) == set(want)
            for key, face in want.items():
                np.testing.assert_array_equal(
                    got["halos"][key], face,
                    err_msg=f"world {world} rank {r} halo {halo} {sched} "
                            f"{key}")
            assert got["sends"] == got["plan_units"], (r, halo, sched)
            assert got["send_bytes"] == got["plan_bytes"], (r, halo, sched)
            assert got["sends"] > 0
