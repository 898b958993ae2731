"""The deprecated ``GradientReducer`` shim (``repro_torch.core.reducer``)
against the reference's (``repro.core.reducer``).

* The policy table and each policy's ``CommConfig`` equal the reference's
  field for field, for all six policies, the reference's ``local_op``
  values through the stated map (``"jnp"`` -> ``"plain"``, ``"pallas"`` ->
  ``"kernel"``); every public name of the reference's module exists in the
  port's, and ``repro_torch.comm`` / ``repro_torch.core`` re-export them.
* On two gloo ranks each policy's ``GradientReducer.reduce`` is bitwise the
  ``Communicator`` it builds, and within the tolerance of
  ``tests/test_comm_api.py``'s reducer check (1e-4, the int8 wire 0.08) of
  the reference's ``GradientReducer`` on 2 fake devices; the per-tensor
  baseline sends one message group per tensor, with the bytes its plan
  predicts.
* The ``DeprecationWarning`` text equals the reference's, and a
  ``TrainStepConfig`` given a policy through the legacy ``reduce`` field
  steps bitwise as one given the policy's ``CommConfig``.

One JAX subprocess (2 fake devices) and one 2-rank gloo spawn, run side by
side; the ranks' jobs are ``tests/torch_rails_jobs.py::reducer_job``.
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import subprocess
import sys
import tempfile
import warnings

import numpy as np
import pytest

import torch_rails_jobs as jobs
from conftest import SRC
from torch_dist_util import run_ranks
from repro.comm import CommConfig as JaxCommConfig
from repro.core import reducer as jax_reducer
from repro_torch.comm import CommConfig
from repro_torch.core import reducer

POLICIES = reducer.POLICIES
LEGACY_STEPS = 3
TOL = {"fused_ring_compressed": 0.08}      # tests/test_comm_api.py's bounds

JAX_SCRIPT = r"""
import warnings
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.reducer import POLICIES, GradientReducer, ReduceConfig

with np.load({src!r}) as f:
    tree = {{k: jax.numpy.asarray(v) for k, v in f.items()}}
mesh = compat.make_mesh((2,), ("data",))
specs = {{k: P() for k in tree}}

def per_device(g):
    i = jax.lax.axis_index("data")
    return jax.tree.map(lambda t: t * (1.0 + i), g)

gv = jax.jit(compat.shard_map(per_device, mesh=mesh, in_specs=(specs,),
                              out_specs=specs, check_vma=False))(tree)
out = {{}}
with warnings.catch_warnings():
    warnings.simplefilter("ignore", DeprecationWarning)
    for policy in POLICIES:
        red = GradientReducer(mesh, ReduceConfig(
            policy=policy, data_axes=("data",), chunks=2))
        got = jax.jit(lambda g: red.reduce(g, specs)[0])(gv)
        for k in tree:
            out[policy + "/" + k] = np.asarray(got[k])
np.savez({dst!r}, **out)
print("REDUCER_REF_OK")
"""


@pytest.fixture(scope="module")
def run():
    base = {k: v.numpy() for k, v in jobs.rank_tree(
        0, jobs.REDUCER_SIZES, seed=1).items()}
    with tempfile.TemporaryDirectory() as tmp:
        src, dst = os.path.join(tmp, "in.npz"), os.path.join(tmp, "ref.npz")
        np.savez(src, **base)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
        env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
        proc = subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT.format(src=src, dst=dst)],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        try:
            ranks = run_ranks(jobs.reducer_job, 2, POLICIES, LEGACY_STEPS)
        finally:
            stdout, stderr = proc.communicate(timeout=300)
        assert "REDUCER_REF_OK" in stdout, stderr[-4000:]
        with np.load(dst) as f:
            ref = dict(f)
    return {"ranks": ranks, "ref": ref}


def _fields(cfg) -> dict:
    return {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}


def _mapped(fields: dict) -> dict:
    """A reference CommConfig's or RingConfig's fields in the port's
    names: ``local_op`` through the stated map."""
    out = dict(fields)
    if "local_op" in out:
        out["local_op"] = reducer.LOCAL_OP_OF_REFERENCE[out["local_op"]]
    return out


def test_policy_table_and_comm_configs_equal_the_reference():
    assert reducer.POLICIES == jax_reducer.POLICIES
    assert set(reducer.LOCAL_OP_OF_REFERENCE) == {"jnp", "pallas"}
    assert reducer.POLICY_TO_TRANSPORT.keys() == \
        jax_reducer.POLICY_TO_TRANSPORT.keys()
    for policy, (transport, forced) in \
            jax_reducer.POLICY_TO_TRANSPORT.items():
        assert reducer.POLICY_TO_TRANSPORT[policy] == (transport,
                                                       _mapped(forced))
    # every CommConfig field of the reference's is the port's, with the
    # same default but local_op's: the port's default is the kernel
    port_fields = _fields(CommConfig())
    ref_fields = _mapped(_fields(JaxCommConfig()))
    assert (ref_fields.pop("local_op"), port_fields.pop("local_op")) == \
        ("plain", "kernel") == (_mapped(_fields(jax_reducer.ReduceConfig()))[
            "local_op"], reducer.ReduceConfig().local_op)
    assert {k: port_fields[k] for k in ref_fields} == ref_fields
    names = [*ref_fields, "local_op"]
    for policy in POLICIES:
        for ref_op, port_op in reducer.LOCAL_OP_OF_REFERENCE.items():
            for channels in (0, 2):
                want = jax_reducer.ReduceConfig(
                    policy=policy, data_axes=("data",), chunks=4,
                    bucket_bytes=8192, local_op=ref_op)
                got = reducer.ReduceConfig(
                    policy=policy, data_axes=("data",), chunks=4,
                    bucket_bytes=8192, local_op=port_op)
                g = _fields(got.comm_config(channels))
                assert {k: g[k] for k in names} == \
                    _mapped(_fields(want.comm_config(channels))), policy
            assert _fields(got.ring_config()) == \
                _mapped(_fields(want.ring_config())), policy
    # the forced fields win; fields CommConfig lacks are dropped
    c = reducer.comm_config_from_policy("baidu_original", chunks=8,
                                        bidirectional=True, nonsense=1)
    assert (c.chunks, c.bidirectional, c.local_op) == (1, False, "plain")
    assert reducer.comm_config_from_policy("native_psum").fuse is False
    with pytest.raises(ValueError, match="unknown policy"):
        reducer.comm_config_from_policy("nope")
    with pytest.raises(ValueError, match="unknown policy"):
        reducer.GradientReducer(None, reducer.ReduceConfig(policy="nope"))
    # the reference module's public surface, and the re-exports
    public = {n for n, v in vars(jax_reducer).items()
              if not n.startswith("_") and not inspect.ismodule(v)
              and getattr(v, "__module__", jax_reducer.__name__)
              == jax_reducer.__name__}
    assert public == {"POLICIES", "POLICY_TO_TRANSPORT",
                      "comm_config_from_policy", "ReduceConfig",
                      "GradientReducer", "per_tensor_reducer"}
    assert public <= set(vars(reducer))
    methods = {n for n in vars(jax_reducer.GradientReducer)
               if not n.startswith("__")}
    assert methods <= set(vars(reducer.GradientReducer))
    import repro_torch.comm as comm_pkg
    import repro_torch.core as core_pkg

    assert comm_pkg.POLICY_TO_TRANSPORT is reducer.POLICY_TO_TRANSPORT
    assert comm_pkg.comm_config_from_policy is reducer.comm_config_from_policy
    for name in ("GradientReducer", "ReduceConfig", "per_tensor_reducer"):
        assert getattr(core_pkg, name) is getattr(reducer, name)


def test_each_policy_reduces_as_its_communicator_and_the_reference(run):
    ranks, ref = run["ranks"], run["ref"]
    for policy in POLICIES:
        outs = [r["policies"][policy] for r in ranks]
        for o in outs:
            for k in o["want"]:
                np.testing.assert_array_equal(o["got"][k], o["want"][k],
                                              err_msg=f"{policy} {k}")
            lossy = policy == "fused_ring_compressed"
            assert (o["ef"] is not None) == lossy, policy
            if lossy:
                sizes = [e.size for e in o["ef"]]
                assert all(not e.any() for e in o["ef"]) and sizes
                for a, b in zip(o["new_ef"], o["want_ef"]):
                    np.testing.assert_array_equal(a, b)
            else:
                assert o["new_ef"] is None
        # the reference's inputs: rank r holds the base tree times (1 + r)
        got = outs[0]["scaled"]
        for k in got:
            np.testing.assert_array_equal(got[k], outs[1]["scaled"][k])
        err = max(float(np.abs(got[k] - ref[f"{policy}/{k}"]).max())
                  for k in got)
        assert err < TOL.get(policy, 1e-4), (policy, err)
    for r in ranks:
        base = r["per_tensor"]
        # one bucket, so one message group, per tensor: 2 (p - 1) sends of
        # one chain each (chunks 1, one direction) at the plan's bytes
        assert base["n_buckets"] == base["n_leaves"]
        assert base["record"]["sends"] == base["messages"] == \
            2 * base["n_leaves"]
        assert base["record"]["send_bytes"] == base["bytes"]


def test_deprecation_text_and_the_legacy_train_step_field(run):
    from repro import compat
    from repro_torch.core.topology import RankMesh
    from repro_torch.runtime.train_step import TrainStepConfig

    jmesh = compat.make_mesh((1,), ("data",))
    mesh = RankMesh(("data",), (1,))
    for policy in POLICIES:
        seen = []
        for mod, m in ((jax_reducer, jmesh), (reducer, mesh)):
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                mod.GradientReducer(m, mod.ReduceConfig(
                    policy=policy, data_axes=("data",)))
            (w,) = [w for w in caught
                    if issubclass(w.category, DeprecationWarning)]
            assert w.filename == __file__           # stacklevel=2
            seen.append(str(w.message))
        assert seen[0] == seen[1], policy
    # the default resolves to the CommConfig it resolved to before the
    # legacy field; a policy through it resolves as its CommConfig given
    axes = ("pod", "data")
    assert TrainStepConfig().comm_config(axes) == CommConfig()
    for policy in POLICIES:
        legacy = reducer.ReduceConfig(policy=policy)
        assert TrainStepConfig(comm=None, reduce=legacy).comm_config(axes) \
            == TrainStepConfig(comm=legacy.comm_config()).comm_config(axes)
    # and steps bitwise on two ranks
    finals = {}
    for r in run["ranks"]:
        for policy in POLICIES:
            a, b = r["train"][policy]["legacy"], r["train"][policy]["comm"]
            assert a["comm"] == b["comm"], policy
            assert a["losses"] == b["losses"], policy
            for k in a["params"]:
                np.testing.assert_array_equal(a["params"][k],
                                              b["params"][k])
            finals[policy] = a["params"]
    # the policies' wires differ: the int8 one moves other parameters
    assert any(not np.array_equal(finals["fused_ring_compressed"][k],
                                  finals["fused_ring_hierarchical"][k])
               for k in finals["fused_ring_hierarchical"])
