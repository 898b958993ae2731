"""repro_torch communication plans against the JAX reference, field for
field: the bucket plan, the arena layout with its spans, the CommPlan's
predicted bytes and messages and the issue schedules, for the reduced
llama3.2-1b parameters at 2 and 4 ranks.  Plans are plain arithmetic, so
they must be equal; the reference's Communicator reads only the mesh's
axis names and shape, given here without devices."""

import dataclasses
import types

import jax
import numpy as np
import pytest
import torch

from repro.comm import CommConfig as JaxCommConfig
from repro.comm import Communicator as JaxCommunicator
from repro.comm import transport_specs as jax_transport_specs
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro_torch import tree as tree_util
from repro_torch.comm import (CommConfig, Communicator, make_codec,
                              transport_specs)
from repro_torch.configs import reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.models import build_model
from repro_torch.runtime.train_step import abstract_params

ARCH = "llama3.2-1b"
CONFIGS = [  # (transport, channels, chunks, bidirectional, bucket_bytes,
             #  page_bytes, wire_dtype)
    ("ring_hier", 0, 2, True, 32 * 2**20, 2 * 2**20, None),
    ("ring_hier", 2, 2, True, 64 * 1024, 8192, None),
    ("ring", 3, 1, False, 16 * 1024, 4096, "bfloat16"),
    ("psum", 2, 2, True, 64 * 1024, 4096, None),
]


@pytest.fixture(scope="module")
def trees():
    jparams = jax_build_model(jax_reduced_config(ARCH)).abstract_params()
    return jparams, abstract_params(build_model(reduced_config(ARCH)))


def _comms(world, transport, channels, chunks, bidi, bucket_bytes,
           page_bytes, wire):
    kw = dict(transport=transport, channels=channels, chunks=chunks,
              bidirectional=bidi, bucket_bytes=bucket_bytes,
              page_bytes=page_bytes, wire_dtype=wire,
              data_axes=("data",))
    fake_mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                      devices=np.empty((world, 1)))
    return (JaxCommunicator(fake_mesh, JaxCommConfig(**kw)),
            Communicator(RankMesh(("data", "model"), (world, 1)),
                         CommConfig(**kw), connect=False))


def _slots(sched):
    return [(s.phase, s.bucket_ids, s.channel, s.ready) for s in sched.slots]


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("config", CONFIGS, ids=lambda c: f"{c[0]}-ch{c[1]}")
def test_plans_equal_reference_field_for_field(trees, world, config):
    jtree, tree = trees
    jcomm, comm = _comms(world, *config)
    jbp, bp = jcomm.bucketer.plan(jtree), comm.bucketer.plan(tree)
    assert bp.bucket_sizes == jbp.bucket_sizes
    assert bp.pad_multiple == jbp.pad_multiple
    assert len(bp.fields) == len(jbp.fields)
    for f, jf in zip(bp.fields, jbp.fields):
        assert (f.leaf, f.shape, f.bucket, f.offset, f.size) == \
            (jf.leaf, jf.shape, jf.bucket, jf.offset, jf.size)
        assert str(f.dtype).removeprefix("torch.") == jf.dtype.name
    jplan, plan = jcomm.plan(jtree), comm.plan(tree)
    assert plan.describe() == jplan.describe()
    assert plan.arena_layout.describe() == jplan.arena_layout.describe()
    for policy in ("accumulate_then_reduce", "stream", "scheduled"):
        for m in (1, 2):
            assert _slots(comm.schedule(tree, policy, m)) == \
                _slots(jcomm.schedule(jtree, policy, m))
            js = jcomm.arena_schedule(jtree, policy, m)
            s = comm.arena_schedule(tree, policy, m)
            assert _slots(s) == _slots(js)
            assert s.bucket_sizes == js.bucket_sizes
            assert s.overlap_fraction == js.overlap_fraction


def test_leaf_order_is_jax_tree_order(trees):
    jtree, tree = trees
    jleaves = jax.tree.leaves(jtree)
    leaves = tree_util.leaves(tree)
    assert [tuple(l.shape) for l in leaves] == [l.shape for l in jleaves]
    back = tree_util.flatten(tree)[1].unflatten(leaves)
    assert tree_util.leaves(back) == leaves


def test_flatten_holds_no_leaf_past_its_caller():
    """A flattened leaf is freed as soon as its last reference goes, with
    the garbage collector off: flatten keeps no reference cycle to it."""
    import gc
    import weakref

    leaf = torch.ones(3)
    ref = weakref.ref(leaf)
    enabled = gc.isenabled()
    gc.disable()
    try:
        tree = {"b": [leaf, (torch.zeros(1),)], "a": {"c": torch.zeros(2)}}
        del leaf
        flat, tdef = tree_util.flatten(tree)
        assert tree_util.leaves(tdef.unflatten(flat)) == flat
        mapped = tree_util.tree_map(lambda t: t + 1, tree)
        del tree, flat, mapped
        assert ref() is None
    finally:
        if enabled:
            gc.enable()


def test_transport_capabilities_match_reference():
    jspecs = jax_transport_specs()
    for name, spec in transport_specs().items():
        j = jspecs[name]
        assert (spec.supports_rs, spec.supports_codec, spec.wire_dtypes,
                spec.codec, spec.hierarchical) == \
            (j.supports_rs, j.supports_codec, j.wire_dtypes, j.codec,
             j.hierarchical), name


def test_construction_time_refusals():
    mesh = RankMesh(("data",), (2,))
    with pytest.raises(ValueError, match="unknown transport"):
        Communicator(mesh, CommConfig(transport="nope"), connect=False)
    with pytest.raises(ValueError, match="wire_dtype"):
        Communicator(mesh, CommConfig(transport="psum",
                                      wire_dtype="bfloat16"), connect=False)
    with pytest.raises(ValueError, match="fuse"):
        Communicator(mesh, CommConfig(fuse=False), connect=False)
    with pytest.raises(ValueError, match="local_op"):
        Communicator(mesh, CommConfig(local_op="pallas"), connect=False)
    comm = Communicator(mesh, CommConfig(transport="psum"), connect=False)
    with pytest.raises(ValueError, match="reduce-scatter"):
        comm.reduce_scatter([torch.zeros(4)])
    with pytest.raises(RuntimeError, match="only plans"):
        Communicator(mesh, CommConfig(), connect=False).all_reduce(
            [torch.zeros(1024)])


def test_int8_codec_waits_for_its_slice(trees):
    """The int8 wire's slice has landed: ``make_codec("int8")`` builds the
    block codec, and a communicator under ``wire_codec="int8"`` builds and
    plans like the reference's (its codec price compared at the reference's
    memory rate, the port's default being the H100's)."""
    codec = make_codec("int8", block=256)
    assert (codec.block, codec.impl) == (256, "kernel")
    assert codec.wire_bytes(1024) == 1024 + 4 * 4
    jtree, tree = trees
    jcomm, comm = _comms(2, "ring_hier", 0, 2, True, 64 * 1024, 8192, None)
    jcomm, comm = (type(c)(c.mesh, dataclasses.replace(c.cfg,
                                                       wire_codec="int8"),
                           **kw)
                   for c, kw in ((jcomm, {}), (comm, {"connect": False})))
    assert comm.codec == jcomm.codec == "int8"
    jplan, plan = jcomm.plan(jtree), comm.plan(tree)
    d, jd = plan.describe(), jplan.describe()
    assert d.pop("codec") == plan.codec_tradeoff()
    assert jd.pop("codec") == plan.codec_tradeoff(hbm_bandwidth=819e9)
    assert d == jd
