"""repro_torch's stencil operator and even-odd Schur operator against the
JAX reference.

The distributed ``StencilOp.apply`` (halo 1 and 2) and ``EvenOddOp.apply``
run on 2 gloo ranks (mesh ``(2,)``) and 4 (mesh ``(2, 2)``) under every
halo schedule, and the reference runs the same lattices under
``shard_map`` on 4 fake devices with XLA's fusion pass off (one
subprocess): the outputs are bitwise equal, schedule by schedule.  The
single-process forms (``apply_reference`` through ``torch.roll``, the
Schur reference forms, the dense matrix, the parity masks, the spectral
enclosures) are held against the reference in process.
"""

import os
import tempfile
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_stencil_jobs as jobs

from repro.core.halo import HaloSpec as RefSpec
from repro.stencil import EvenOddOp as RefEvenOdd
from repro.stencil import StencilOp as RefOp
from repro_torch.core.halo import HaloSpec
from repro_torch.core.topology import RankMesh
from repro_torch.stencil import EvenOddOp, StencilOp

REF_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.core.halo import HaloSpec
from repro.stencil import EvenOddOp, StencilOp

sys.path.insert(0, {tests!r})
import torch_stencil_jobs as jobs

out = {{}}
for world in (2, 4):
    xg, mesh_shape, names = jobs.op_inputs(world)
    mesh = compat.make_mesh(mesh_shape, names, devices=jax.devices()[:world])
    pspec = P(*names, None)

    def run(f):
        return np.asarray(jax.jit(compat.shard_map(
            f, mesh=mesh, in_specs=pspec, out_specs=pspec,
            check_vma=False))(xg))

    for halo in (1, 2):
        specs = tuple(HaloSpec(a, d, halo) for d, a in enumerate(names))
        op = StencilOp(specs=specs, mass=jobs.OP_MASS)
        for sched in jobs.SCHEDULES:
            out[f"{{world}}/op/{{halo}}/{{sched}}"] = run(
                lambda v, s=sched: op.apply(v, schedule=s, chunks=2,
                                            channels=2))
    specs = tuple(HaloSpec(a, d, 1) for d, a in enumerate(names))
    eo = EvenOddOp(StencilOp(specs=specs, mass=jobs.OP_MASS))
    for sched in jobs.SCHEDULES:
        out[f"{{world}}/eo/1/{{sched}}"] = run(
            lambda v, s=sched: eo.apply(v * eo.parity_mask(v.shape),
                                        schedule=s, chunks=2, channels=2))
np.savez({path!r}, **out)
print("STENCIL_REF_OK")
"""


@pytest.fixture(scope="module")
def reference():
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "stencil.npz")
        script = REF_SCRIPT.format(tests=os.path.dirname(__file__),
                                   path=path)
        assert "STENCIL_REF_OK" in run_distributed(
            script, n_devices=4, extra_flags="--xla_disable_hlo_passes=fusion")
        with np.load(path) as f:
            return dict(f)


@pytest.mark.parametrize("world", [2, 4])
def test_operators_are_bitwise_the_reference_on_every_schedule(reference,
                                                               world):
    ranks = run_ranks(jobs.operator_job, world)
    keys = [("op", h, s) for h in (1, 2) for s in jobs.SCHEDULES] \
        + [("eo", 1, s) for s in jobs.SCHEDULES]
    for kind, halo, sched in keys:
        got = jobs.gather_blocks([out[(kind, halo, sched)] for out in ranks],
                                 world)
        want = reference[f"{world}/{kind}/{halo}/{sched}"]
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(
            got, want, err_msg=f"world {world} {kind} halo {halo} {sched}")
    # and the global reference form: bitwise at halo 1 (one neighbour sum
    # a direction, the same expression), within 1e-5 at halo 2 (the
    # reference form subtracts each distance's term on its own)
    xg, _, names = jobs.op_inputs(world)
    for halo in (1, 2):
        specs = tuple(HaloSpec(a, d, halo) for d, a in enumerate(names))
        ref = StencilOp(specs=specs, mass=jobs.OP_MASS).apply_reference(
            torch.from_numpy(xg)).numpy()
        got = reference[f"{world}/op/{halo}/overlap"]
        if halo == 1:
            np.testing.assert_array_equal(got, ref)
        else:
            assert np.abs(got - ref).max() < 1e-5


def _pair(shape=(8, 6), halo=1, mass=0.4):
    specs = tuple(HaloSpec(f"ax{d}", d, halo) for d in range(len(shape)))
    rspecs = tuple(RefSpec(f"ax{d}", d, halo) for d in range(len(shape)))
    return StencilOp(specs=specs, mass=mass), RefOp(specs=rspecs, mass=mass)


@pytest.mark.parametrize("halo", [1, 2])
def test_reference_forms_are_bitwise_the_reference(halo):
    op, ref = _pair(halo=halo)
    x = jobs.lattice(1, (8, 6))
    assert op.diag == ref.diag and op.kappas == ref.kappas
    assert op.eig_bounds() == ref.eig_bounds()
    np.testing.assert_array_equal(
        op.apply_reference(torch.from_numpy(x)).numpy(),
        np.asarray(ref.apply_reference(jnp.asarray(x))))
    np.testing.assert_array_equal(op.dense_matrix((8, 6)).numpy(),
                                  np.asarray(ref.dense_matrix((8, 6))))
    # one process: the distributed apply wraps every axis onto this rank
    got = op.apply(torch.from_numpy(x)).numpy()
    want = np.asarray(ref.apply_reference(jnp.asarray(x)))
    if halo == 1:
        np.testing.assert_array_equal(got, want)
    else:
        assert np.abs(got - want).max() < 1e-5


def test_schur_reference_forms_are_bitwise_the_reference():
    op, ref = _pair(mass=0.3)
    eo, reo = EvenOddOp(op, distributed=False), RefEvenOdd(ref,
                                                           distributed=False)
    assert eo.eig_bounds() == reo.eig_bounds()
    b = jobs.lattice(2, (8, 6))
    tb, jb = torch.from_numpy(b), jnp.asarray(b)
    for even in (True, False):
        np.testing.assert_array_equal(
            eo.parity_mask((8, 6), even).numpy(),
            np.asarray(reo.parity_mask((8, 6), even)))
    rhs = eo.project_rhs_reference(tb)
    rrhs = reo.project_rhs_reference(jb)
    np.testing.assert_array_equal(rhs.numpy(), np.asarray(rrhs))
    np.testing.assert_array_equal(eo.apply_reference(rhs).numpy(),
                                  np.asarray(reo.apply_reference(rrhs)))
    np.testing.assert_array_equal(
        eo.reconstruct_reference(rhs, tb).numpy(),
        np.asarray(reo.reconstruct_reference(rrhs, jb)))
    # the one-process distributed form multiplies by 1/d where the
    # reference form divides by d (as the reference's two forms do): an
    # ulp apart; the Schur matvec keeps the even support exactly
    out = eo.apply(rhs)
    np.testing.assert_allclose(out.numpy(), eo.apply_reference(rhs).numpy(),
                               rtol=1e-6, atol=1e-6)
    mo = eo.parity_mask((8, 6), False)
    assert float((mo * out).abs().max()) == 0.0
    assert float((mo * rhs).abs().max()) == 0.0


def test_parity_comes_from_the_rank_mesh_coordinates():
    """A distributed mask offsets each local coordinate by this rank's
    coordinate in the communicator's mesh times the local extent: on a
    (2, 2) mesh of (3, 4) blocks, the global checkerboard."""
    op = StencilOp(specs=(HaloSpec("x", 0), HaloSpec("y", 1)), mass=0.5)
    eo = EvenOddOp(op)
    mesh = RankMesh(("x", "y"), (2, 2))
    glob = EvenOddOp(op, distributed=False).parity_mask((6, 8)).numpy()
    for rank in range(4):
        cx, cy = mesh.coords(rank)
        comm = SimpleNamespace(mesh=mesh, rank=rank)
        got = eo.parity_mask((3, 4, 2), True, comm).numpy()
        np.testing.assert_array_equal(
            got[..., 0], glob[3 * cx:3 * cx + 3, 4 * cy:4 * cy + 4])
        np.testing.assert_array_equal(got[..., 0], got[..., 1])
    with pytest.raises(ValueError, match="needs the communicator"):
        eo.parity_mask((3, 4), True)


def test_even_odd_refuses_what_the_reference_refuses():
    op, _ = _pair(halo=2)
    with pytest.raises(ValueError, match="halo == 1"):
        EvenOddOp(op)
    with pytest.raises(ValueError, match="at least one direction"):
        StencilOp(specs=())
    with pytest.raises(ValueError, match="hopping weights"):
        StencilOp(specs=(HaloSpec("x", 0),), hopping=(0.1, 0.2))
