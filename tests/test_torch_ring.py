"""repro_torch ring collectives against the JAX reference ring.

The same numpy buffers go through the reference's ``ring_all_reduce`` /
``ring_reduce_scatter`` / ``ring_all_gather`` on 2 and 4 fake devices (one
subprocess, fusion off) and through the port's ring on 2 and 4 gloo ranks.
The hop order fixes the add order, so every case is bitwise equal: fp32 and
bf16 wire, chunks 1 and 2, bidirectional on and off, and a hierarchical
(2 x 2) all-reduce.  The arena path reduces bitwise like the bucket path on
2 ranks.
"""

import os
import tempfile

import numpy as np
import pytest

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_rank_jobs as jobs

LENGTH = 3 * 1024          # divisible by 4 ranks x 2 chunks x 2 directions

JAX_SCRIPT = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import ring

sys.path.insert(0, {tests!r})
import torch_rank_jobs as jobs

out = {{}}
for world in (2, 4):
    x = jnp.asarray(jobs.ring_inputs(world, {length}).reshape(-1))
    mesh = Mesh(np.array(jax.devices()[:world]).reshape(world, 1),
                ("data", "model"))

    def body(xl):
        res = []
        for name, chunks, bidi, wire in jobs.ring_cases():
            cfg = ring.RingConfig(chunks=chunks, bidirectional=bidi,
                                  wire_dtype=wire)
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
                xl, ("data", "pod"), ring.RingConfig(chunks=2)),
            mesh=mesh2, in_specs=(P(("pod", "data")),),
            out_specs=P(("pod", "data")), check_vma=False))
        out["4/hier/ar"] = np.asarray(fn(x)).reshape(4, -1)
np.savez({path!r}, **out)
print("RING_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "ring.npz")
        script = JAX_SCRIPT.format(tests=os.path.dirname(__file__),
                                   length=LENGTH, path=path)
        assert "RING_REF_OK" in run_distributed(
            script, n_devices=4, extra_flags="--xla_disable_hlo_passes=fusion")
        with np.load(path) as f:
            return dict(f)


@pytest.mark.parametrize("world", [2, 4])
def test_ring_matches_reference_bitwise(reference, world):
    ranks = run_ranks(jobs.ring_job, world, LENGTH)
    keys = [f"{name}/{op}" for name, *_ in jobs.ring_cases()
            for op in ("ar", "rs", "ag")]
    if world == 4:
        keys.append("hier/ar")
    want_sum = jobs.ring_inputs(world, LENGTH).astype(np.float64).sum(0)
    for key in keys:
        want = reference[f"{world}/{key}"]
        for r, out in enumerate(ranks):
            got = out[key]
            assert got.dtype == want.dtype, key
            np.testing.assert_array_equal(got, want[r],
                                          err_msg=f"{key} rank {r}")
        if key.endswith("/ar") and "bf16" not in key:
            np.testing.assert_allclose(ranks[0][key], want_sum, rtol=1e-5,
                                       atol=1e-5)


def test_arena_reduction_equals_bucket_path_bitwise_on_two_ranks():
    """Every transport, op and microbatch count: the arena path equals the
    bucket path bitwise, every reduction equals the all-reduce, and two
    microbatches equal one (the grads scale by 1/2 and sum back exactly)."""
    for rank, rank_out in enumerate(run_ranks(jobs.arena_vs_buckets_job, 2)):
        for key, (buckets, arena) in rank_out.items():
            transport, op, m = key.split("/")
            want = (rank_out[f"{transport}/all_reduce/1"][0]
                    if op != "none" else None)
            for i, (b, a) in enumerate(zip(buckets, arena)):
                np.testing.assert_array_equal(a, b, err_msg=f"{key} {i}")
                if want is not None:
                    np.testing.assert_array_equal(b, want[i],
                                                  err_msg=f"{key} {i}")
                else:        # no reduction: this rank's own gradient
                    ref = rank_out[f"{transport}/none/1"][0][i]
                    np.testing.assert_array_equal(b, ref,
                                                  err_msg=f"{key} {i}")
            if op == "none" and m == "1":
                ar = rank_out[f"{transport}/all_reduce/1"][0]
                # mean over ranks scale (1 + r): 1.5x the rank-0 gradient
                scale = 1.0 + rank
                for b, r in zip(buckets, ar):
                    np.testing.assert_allclose(b / scale * 1.5, r, rtol=1e-6)
