"""repro_torch int8 ring and int8 arena reduction against the JAX
reference with ``RingConfig(codec="int8")``, bitwise.

The same numpy buffers go through the reference's ring on 2 and 4 fake
devices (one subprocess) and through the port's ring on 2 and 4 gloo
ranks: all-reduce, reduce-scatter and all-gather, chunks 1 and 2,
bidirectional on and off, blocks 128 and 512, and a hierarchical (2 x 2)
all-reduce.  Every hop re-encodes the partial sum in int8 and the hop order
fixes the add order, so every case is bitwise equal.  So are the bucket
path's all-reduce of a tree with error feedback
(``Communicator.all_reduce_tree``) and the int8 arena's reduction
(``Communicator.reduce_scheduled`` with a ``QuantCommArena``), held against
the reference's ``_reduce_scheduled_arena_quant`` from the same fixed local
gradients.  The port's recorded sends and bytes equal the int8 prediction:
one message per channel slice per hop, ``1 + 4/block`` bytes per element.

The reference runs with two XLA passes off (``--xla_disable_hlo_passes=
fusion,algsimp``), so that it computes what its own code says, as it does
outside ``jit``: the algebraic simplifier turns ``absmax / 127`` into a
multiply by the reciprocal (one scale in about twenty-five moves by an ulp
on the CPU), and the CPU backend's fused loops contract a multiply and an
add (``q * scale + acc``, ``x - q * scale``) into one FMA, which rounds
once where the program rounds twice.  The port divides and rounds twice.
Nothing in ``src/repro`` changes for it.
"""

import os
import tempfile

import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_int8_jobs as jobs

JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.comm import CommConfig, Communicator
from repro.core import ring

sys.path.insert(0, {tests!r})
import torch_int8_jobs as jobs

out = {{}}
for world in (2, 4):
    x = jnp.asarray(jobs.ring_inputs(world).reshape(-1))
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world, 1),
                ("data", "model"))

    def body(xl):
        res = []
        for name, chunks, bidi, block in jobs.ring_cases():
            cfg = ring.RingConfig(chunks=chunks, bidirectional=bidi,
                                  codec="int8", codec_block=block)
            rs = ring.ring_reduce_scatter(xl, "data", cfg)
            res += [ring.ring_all_reduce(xl, "data", cfg), rs,
                    ring.ring_all_gather(rs, "data", cfg)]
        return tuple(res)

    fn = jax.jit(compat.shard_map(body, mesh=mesh, in_specs=(P("data"),),
                                  out_specs=P("data"), check_vma=False))
    res = fn(x)
    i = 0
    for name, *_ in jobs.ring_cases():
        for op in ("ar", "rs", "ag"):
            out[f"{{world}}/{{name}}/{{op}}"] = np.asarray(res[i]).reshape(
                world, -1)
            i += 1
    if world == 4:
        mesh2 = Mesh(np.array(jax.devices()[:4]).reshape(2, 2),
                     ("pod", "data"))
        fn = jax.jit(compat.shard_map(
            lambda xl: ring.hierarchical_all_reduce(
                xl, ("data", "pod"),
                ring.RingConfig(chunks=2, codec="int8", codec_block=128)),
            mesh=mesh2, in_specs=(P(("pod", "data")),),
            out_specs=P(("pod", "data")), check_vma=False))
        out["4/hier/ar"] = np.asarray(fn(x)).reshape(4, -1)

    comm = Communicator(mesh, CommConfig(**jobs.TREE_COMM))
    tree = {{k: jnp.asarray(v.reshape((-1,) + v.shape[2:]))
             for k, v in jobs.tree_inputs(world).items()}}
    local = {{k: jax.ShapeDtypeStruct(v.shape[1:], v.dtype)
              for k, v in jobs.tree_inputs(world).items()}}
    sizes = comm.bucketer.plan(local).bucket_sizes
    ef = [jnp.asarray(e.reshape(-1)) for e in jobs.ef_inputs(world, sizes)]
    fn = jax.jit(compat.shard_map(
        lambda t, e: comm.all_reduce_tree(t, list(e)), mesh=mesh,
        in_specs=(P("data"), P("data")), out_specs=(P("data"), P("data")),
        check_vma=False))
    red, new_ef = fn(tree, tuple(ef))
    for i, leaf in enumerate(jax.tree.leaves(red)):
        out[f"{{world}}/tree/reduced/{{i}}"] = np.asarray(leaf).reshape(
            (world, -1) + leaf.shape[1:])
    for i, e in enumerate(new_ef):
        out[f"{{world}}/tree/ef/{{i}}"] = np.asarray(e).reshape(world, -1)
    out[f"{{world}}/tree/sizes"] = np.array(sizes)

mesh = Mesh(np.array(jax.devices()[:2]).reshape(2, 1), ("data", "model"))
grads = jobs.arena_grads(2)
stacked = jax.tree.map(lambda x: jnp.asarray(x.reshape((-1,) + x.shape[2:])),
                       grads)
local = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape[2:], x.dtype),
                     grads)
batch = {{"x": jnp.zeros((2 * jobs.ARENA_MICRO, 1), jnp.float32)}}
for transport, policy, op in jobs.arena_cases():
    comm = Communicator(mesh, CommConfig(transport=transport,
                                         **jobs.ARENA_COMM))
    arena = comm.arena(local)
    lay = arena.layout
    buf0, ef0 = jobs.arena_state(2, lay.total_elems, lay.payload_elems)
    sched = comm.arena_schedule(local, policy, jobs.ARENA_MICRO)

    def body(params, b, buf, ef, comm=comm, arena=arena, sched=sched,
             op=op):
        calls = []

        def grad_fn(p, mb):
            i = len(calls)
            calls.append(i)
            return jnp.zeros(()), jax.tree.map(lambda x: x[i], p)

        _, res = comm.reduce_scheduled(grad_fn, params, b, sched, op=op,
                                       arena=arena, arena_buf=buf,
                                       ef_buf=ef)
        reduced = (jax.tree.leaves(res[0]) if op == "all_reduce"
                   else list(res[0]))
        return tuple(reduced), res[-2], res[-1]

    fn = jax.jit(compat.shard_map(body, mesh=mesh,
                                  in_specs=(P("data"),) * 4,
                                  out_specs=P("data"), check_vma=False))
    red, buf, ef = fn(stacked, batch, jnp.asarray(buf0.reshape(-1)),
                      jnp.asarray(ef0.reshape(-1)))
    key = f"arena/{{transport}}/{{policy}}/{{op}}"
    for i, t in enumerate(red):
        t = np.asarray(t)
        out[f"{{key}}/reduced/{{i}}"] = t.reshape((2, -1) + t.shape[1:])
    out[f"{{key}}/arena"] = np.asarray(buf).reshape(2, -1)
    out[f"{{key}}/ef"] = np.asarray(ef).reshape(2, -1)
np.savez({path!r}, **out)
print("RING_INT8_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring_int8.npz")
        script = JAX_SCRIPT.format(tests=os.path.dirname(__file__),
                                   path=path)
        assert "RING_INT8_REF_OK" in run_distributed(
            script, n_devices=4,
            extra_flags="--xla_disable_hlo_passes=fusion,algsimp")
        with np.load(path) as f:
            return dict(f)


@pytest.mark.parametrize("world", [2, 4])
def test_int8_ring_matches_reference_bitwise(reference, world):
    ranks = run_ranks(jobs.ring_int8_job, world)
    keys = [f"{name}/{op}" for name, *_ in jobs.ring_cases()
            for op in ("ar", "rs", "ag")]
    if world == 4:
        keys.append("hier/ar")
    exact = jobs.ring_inputs(world).astype(np.float64).sum(0)
    for key in keys:
        want = reference[f"{world}/{key}"]
        for r, out in enumerate(ranks):
            assert out[key].dtype == want.dtype, key
            np.testing.assert_array_equal(out[key], want[r],
                                          err_msg=f"{key} rank {r}")
        if key.endswith("/ar"):
            # lossy but bounded: a few int8 roundings of partial sums
            assert np.abs(ranks[0][key] - exact).max() < 0.1 * world
    for name, chunks, bidi, block in jobs.ring_cases():
        slices = chunks * (2 if bidi else 1)
        for out in ranks:
            sends, nbytes = out[f"{name}/record"]
            assert sends == 2 * (world - 1) * slices
            assert nbytes == 2 * (world - 1) * jobs.LENGTH // world * (
                1 + 4 / block)
    np.testing.assert_array_equal(ranks[0]["tree/sizes"],
                                  reference[f"{world}/tree/sizes"])
    for r, out in enumerate(ranks):
        for i, leaf in enumerate(out["tree/reduced"]):
            np.testing.assert_array_equal(
                leaf, reference[f"{world}/tree/reduced/{i}"][r],
                err_msg=f"tree leaf {i} rank {r}")
        for i, e in enumerate(out["tree/ef"]):
            np.testing.assert_array_equal(
                e, reference[f"{world}/tree/ef/{i}"][r],
                err_msg=f"ef bucket {i} rank {r}")


@pytest.fixture(scope="module")
def arena_ranks():
    return run_ranks(jobs.quant_arena_job, 2)


@pytest.mark.parametrize("transport,policy,op", jobs.arena_cases())
def test_quant_arena_reduction_matches_reference_bitwise(
        reference, arena_ranks, transport, policy, op):
    """The int8 arena's ``reduce_scheduled`` on 2 ranks against the
    reference's ``_reduce_scheduled_arena_quant`` on 2 devices, from the
    same fixed local gradients of 2 microbatches, the same stale arena
    bytes and the same error-feedback accumulator: the reduced tree (or the
    span shards), every byte of the int8 arena (payload, scales and the
    padding nobody writes) and the new accumulator are bitwise equal."""
    key = f"{transport}/{policy}/{op}"
    for r, out in enumerate(arena_ranks):
        got = out[key]
        assert got["calls"] == jobs.ARENA_MICRO
        n = len([k for k in reference if k.startswith(f"arena/{key}/red")])
        assert len(got["reduced"]) == n
        for i, t in enumerate(got["reduced"]):
            want = reference[f"arena/{key}/reduced/{i}"][r]
            assert t.dtype == want.dtype and t.shape == want.shape
            np.testing.assert_array_equal(t.view(np.int32),
                                          want.view(np.int32),
                                          err_msg=f"{key} reduced {i} rank "
                                                  f"{r}")
        np.testing.assert_array_equal(got["arena"],
                                      reference[f"arena/{key}/arena"][r],
                                      err_msg=f"{key} arena rank {r}")
        np.testing.assert_array_equal(
            got["ef"].view(np.int32),
            reference[f"arena/{key}/ef"][r].view(np.int32),
            err_msg=f"{key} ef rank {r}")
