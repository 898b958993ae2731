"""repro_torch.sharding.rules against the reference's ``repro.sharding.rules``.

``param_specs`` (the ``tp`` and ``fsdp`` policies), ``decode_state_specs``
and ``batch_spec`` of the port equal the reference's for every one of the
10 archs on meshes (1, 2), (2, 2), (4, 2), (2, 2, 2) with a pod axis and
(16, 16), through a stand-in mesh object (``axis_names`` and
``devices.shape``), so that no JAX devices are needed.  The reference's
``PartitionSpec`` may list fewer entries than its leaf has dimensions; it
is padded with ``None`` (replicated) before the comparison, since the
port's spec has one entry per dimension.  The trees are the reference's
abstract ones (``jax.ShapeDtypeStruct`` leaves; the port reads ``shape``
only).  Also: ``local_shard`` and ``global_from_shards`` invert each other
over every rank of a mesh, ``RankMesh.groups`` gives each rank's model and
data groups on (2, 2) and (2, 2, 2), ``make_host_mesh`` equals the
reference's rule, and the new modules import nothing of JAX or ``repro``.
"""

import pathlib
import re
from types import SimpleNamespace

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.models import build_model as jax_build_model
from repro.sharding import rules as ref_rules
from repro_torch.configs import get_config
from repro_torch.core.topology import RankMesh
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.sharding import rules

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {(1, 2): ("data", "model"), (2, 2): ("data", "model"),
          (4, 2): ("data", "model"), (2, 2, 2): ("pod", "data", "model"),
          (16, 16): ("data", "model")}
DECODE = ((8, 512), (8, 8192), (32, 16384), (3, 8192))
BATCHES = (1, 2, 3, 4, 8, 16, 32, 256, 512)


def _stand_in(shape, names):
    return SimpleNamespace(axis_names=names,
                           devices=SimpleNamespace(shape=shape))


def _padded(spec, ndim):
    t = tuple(spec)
    return t + (None,) * (ndim - len(t))


def _ref_leaves(tree, specs):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    sflat = jax.tree_util.tree_flatten(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return [(jax.tree_util.keystr(p), l.shape, s)
            for (p, l), s in zip(flat, sflat)]


def _port_leaves(specs):
    return rules.spec_leaves(specs)


@pytest.mark.parametrize("mesh_shape", list(MESHES))
@pytest.mark.parametrize("arch", jax_list_archs())
def test_specs_equal_the_reference(arch, mesh_shape):
    mesh = _stand_in(mesh_shape, MESHES[mesh_shape])
    jmodel = jax_build_model(jax_get_config(arch))
    tree = jmodel.abstract_params()
    cfg = get_config(arch).with_(vocab_size=jmodel.cfg.vocab_size)
    for policy in ("tp", "fsdp"):
        want = _ref_leaves(tree, ref_rules.param_specs(
            tree, jmodel.cfg.with_(sharding=policy), mesh))
        got = _port_leaves(rules.param_specs(
            tree, cfg.with_(sharding=policy), mesh))
        assert len(got) == len(want)
        for g, (path, shape, s) in zip(got, want):
            assert g == _padded(s, len(shape)), (policy, path)
    for b, s in DECODE:
        state = jmodel.abstract_decode_state(b, s)
        want = _ref_leaves(state, ref_rules.decode_state_specs(
            state, jmodel.cfg, mesh, b))
        got = _port_leaves(rules.decode_state_specs(state, cfg, mesh, b))
        assert [g for g in got] == [_padded(w, len(shape))
                                    for _, shape, w in want], (b, s)
    for b in BATCHES:
        assert rules.batch_spec(b, mesh) == tuple(
            ref_rules.batch_spec(b, mesh))
        assert rules.batch_spec(b, RankMesh(MESHES[mesh_shape],
                                            mesh_shape)) == \
            rules.batch_spec(b, mesh)


def test_local_shard_and_global_from_shards_invert_each_other():
    mesh = RankMesh(("pod", "data", "model"), (2, 2, 2))
    rng = np.random.RandomState(0)
    tree = {"a": rng.randn(8, 6), "b": [rng.randn(4), rng.randn(2, 4, 8)]}
    specs = {"a": ("model", None), "b": [(("pod", "data"),),
                                        (None, "data", ("pod", "model"))]}
    shards = [rules.local_shard(tree, specs, mesh, r) for r in range(8)]
    assert shards[5]["a"].shape == (4, 6)
    # rank 5 = (pod 1, data 0, model 1)
    np.testing.assert_array_equal(shards[5]["a"], tree["a"][4:8])
    np.testing.assert_array_equal(shards[5]["b"][0], tree["b"][0][2:3])
    np.testing.assert_array_equal(shards[5]["b"][1],
                                  tree["b"][1][:, 0:2, 6:8])
    assert rules.local_shapes(tree, specs, mesh) == {
        "a": (4, 6), "b": [(1,), (2, 2, 2)]}
    back = rules.global_from_shards(shards, specs, mesh)
    np.testing.assert_array_equal(back["a"], tree["a"])
    for x, y in zip(back["b"], tree["b"]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape,names", [((2, 2), ("data", "model")),
                                         ((2, 2, 2),
                                          ("pod", "data", "model"))])
def test_rank_mesh_groups_give_model_and_data_groups(shape, names):
    mesh = RankMesh(names, shape)
    model_groups = mesh.groups(("model",))
    data_axes = tuple(a for a in names if a != "model")
    data_groups = mesh.groups(data_axes)
    for r in range(mesh.size):
        (mg,) = [g for g in model_groups if r in g]
        (dg,) = [g for g in data_groups if r in g]
        c = mesh.coords(r)
        # the model group: every rank that shares r's data coordinates, in
        # model order; the data group: every rank at r's model index
        assert [mesh.coords(x)[:-1] for x in mg] == [c[:-1]] * shape[-1]
        assert [mesh.coords(x)[-1] for x in mg] == list(range(shape[-1]))
        assert [mesh.coords(x)[-1] for x in dg] == [c[-1]] * len(dg)
        assert len(dg) == mesh.size // shape[-1]
        assert sorted(set(mg) & set(dg)) == [r]
    # every rank lists the groups in one order
    assert mesh.groups(("model",)) == model_groups


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8, 12])
@pytest.mark.parametrize("mp", [1, 2, 4])
def test_make_host_mesh_follows_the_reference_rule(n, mp):
    mesh = make_host_mesh(n, model_parallel=mp)
    model = mp
    while model > 1 and n % model:
        model //= 2
    assert mesh == RankMesh(("data", "model"), (n // model, model))


FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)


@pytest.mark.parametrize("path", ["src/repro_torch/sharding/rules.py",
                                  "src/repro_torch/sharding/__init__.py",
                                  "src/repro_torch/launch/mesh.py",
                                  "src/repro_torch/models/parallel.py"])
def test_new_modules_import_nothing_of_jax_or_repro(path):
    assert not FORBIDDEN.search((REPO / path).read_text()), path
