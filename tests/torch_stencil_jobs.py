"""Per-rank jobs of the port's halo, stencil and CG tests (run by
``torch_dist_util.run_ranks``), and the inputs both packages share.  Torch
only: the spawned ranks never import JAX.  Each job takes ``(rank, world,
...)`` and returns numpy values."""

from __future__ import annotations

import numpy as np

SCHEDULES = ("sequential", "concurrent", "chunked", "overlap")
SOLVERS = ("cg", "pipelined", "sstep")
PRECONDS = ("none", "eo")
MESHES = {2: ((2,), ("x",)), 4: ((2, 2), ("x", "y"))}
# the solver tests' meshes: two dims on both, so that 16 iterations stay
# short of convergence (a ring of 12 sites has 7 distinct eigenvalues:
# CG is exact after 7 and runs on rounding noise after that); at two
# ranks the y axis is one rank's, whose faces wrap locally
CG_MESHES = {2: ((2, 1), ("x", "y")), 4: ((2, 2), ("x", "y"))}

# local extents of the halo test: every face splits unevenly into 2 chunks
HALO_LOCAL = {2: (7, 5, 3), 4: (5, 7, 3)}
# the operator and solver tests: the reference's lattices
# (tests/test_solvers.py's history script, 6 sites a rank per direction)
OP_LOCAL = 6
COMPONENTS = 3
OP_MASS = 0.3
CG_ITERS, CG_S = 16, 4
LADDER_ITERS = 8


# the reference's side of the solver comparison (run by
# conftest.run_distributed with fake devices): the family at CG_ITERS
# unrolled iterations on the CG_MESHES lattice of each world in ``worlds``
CG_REF_SCRIPT = r"""
import sys
import numpy as np
import jax
from jax.sharding import PartitionSpec as P
from repro import compat
from repro.comm import CommConfig, Communicator
from repro.core.halo import HaloSpec
from repro.stencil import StencilOp, solve

sys.path.insert(0, {tests!r})
import torch_stencil_jobs as jobs

out = {{}}
for world in {worlds!r}:
    xg, mesh_shape, names = jobs.op_inputs(world, meshes=jobs.CG_MESHES)
    mesh = compat.make_mesh(mesh_shape, names, devices=jax.devices()[:world])
    specs = tuple(HaloSpec(a, d, 1) for d, a in enumerate(names))
    op = StencilOp(specs=specs, mass=jobs.OP_MASS)
    comm = Communicator(mesh, CommConfig(transport="psum", data_axes=names,
                                         channels=2))
    pspec = P(*names, None)
    for solver in jobs.SOLVERS:
        for precond in jobs.PRECONDS:
            def run(b, sv=solver, pc=precond):
                r = solve(op, b, comm, solver=sv, precond=pc, s=jobs.CG_S,
                          tol=None, maxiter=jobs.CG_ITERS,
                          schedule="concurrent", chunks=2, channels=2)
                return r.x, r.history
            x, h = jax.jit(compat.shard_map(
                run, mesh=mesh, in_specs=pspec, out_specs=(pspec, P()),
                check_vma=False))(xg)
            out[f"{{world}}/{{solver}}/{{precond}}/x"] = np.asarray(x)
            out[f"{{world}}/{{solver}}/{{precond}}/h"] = np.asarray(h)
np.savez({path!r}, **out)
print("CG_REF_OK")
"""


def lattice(seed: int, gshape) -> np.ndarray:
    return np.random.RandomState(seed).randn(*gshape).astype(np.float32)


def local_block(xg: np.ndarray, mesh_shape, coords, n_mesh_dims: int):
    """This rank's block of the global lattice ``xg`` (mesh dim ``d``
    shards array dim ``d``)."""
    idx = []
    for d in range(xg.ndim):
        if d < n_mesh_dims:
            n = xg.shape[d] // mesh_shape[d]
            idx.append(slice(coords[d] * n, (coords[d] + 1) * n))
        else:
            idx.append(slice(None))
    return xg[tuple(idx)]


def coords_of(rank: int, mesh_shape) -> tuple[int, ...]:
    out = []
    for n in reversed(mesh_shape):
        out.append(rank % n)
        rank //= n
    return tuple(reversed(out))


def expected_halos(xg: np.ndarray, mesh_shape, coords, names, halo: int):
    """The faces a periodic global lattice gives this rank's block:
    ``{(axis, '-'): the halo sites below it, (axis, '+'): above it}``."""
    nd = len(names)
    out = {}
    for d, axis in enumerate(names):
        n = xg.shape[d] // mesh_shape[d]
        start, size = coords[d] * n, xg.shape[d]
        lo = np.take(xg, [(start - halo + i) % size for i in range(halo)],
                     axis=d)
        hi = np.take(xg, [(start + n + i) % size for i in range(halo)],
                     axis=d)
        sub = list(coords)
        for key, face in (((axis, "-"), lo), ((axis, "+"), hi)):
            idx = []
            for e in range(xg.ndim):
                if e < nd and e != d:
                    m = xg.shape[e] // mesh_shape[e]
                    idx.append(slice(sub[e] * m, (sub[e] + 1) * m))
                else:
                    idx.append(slice(None))
            out[key] = face[tuple(idx)]
    return out


def make_comm(mesh_shape, names, *, transport: str = "psum",
              channels: int = 2, local_op: str = "kernel"):
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core.topology import RankMesh

    return Communicator(RankMesh(tuple(names), tuple(mesh_shape)),
                        CommConfig(transport=transport,
                                   data_axes=tuple(names),
                                   channels=channels, local_op=local_op))


def halo_job(rank: int, world: int) -> dict:
    """Every schedule x halo 1 and 2 through ``Communicator.halo_exchange``
    (channels 2, so chunks 2) on this rank's block of a seeded lattice:
    the received faces, and the sends and bytes each exchange recorded,
    beside the HaloPlan's units on axes of more than one rank."""
    import torch

    from repro_torch.core.halo import HaloSpec

    mesh_shape, names = MESHES[world]
    comm = make_comm(mesh_shape, names)
    coords = comm.mesh.coords(rank)
    local = HALO_LOCAL[world]
    gshape = tuple(n * p for n, p in zip(local, mesh_shape)) \
        + local[len(mesh_shape):]
    out = {}
    for halo in (1, 2):
        specs = tuple(HaloSpec(a, d, halo) for d, a in enumerate(names))
        xg = lattice(10 + halo, gshape)
        x = torch.from_numpy(np.ascontiguousarray(
            local_block(xg, mesh_shape, coords, len(names))))
        for sched in SCHEDULES:
            comm.record.reset()
            got = comm.halo_exchange(x, specs, schedule=sched)
            plan = comm.halo_plan(local, specs, schedule=sched)
            sizes = dict(zip(plan.axes, plan.axis_sizes))
            wire = [b for k, b in zip(plan.unit_keys, plan.unit_bytes)
                    if sizes[k.rstrip("+-#0123456789")] > 1]
            out[(halo, sched)] = {
                "halos": {k: v.numpy() for k, v in got.items()},
                "sends": comm.record.sends,
                "send_bytes": comm.record.send_bytes,
                "plan_units": len(wire), "plan_bytes": sum(wire)}
    return out


def op_inputs(world: int, seed: int = 5, meshes: dict = MESHES):
    """The operator and solver tests' global lattice, mesh and axes."""
    mesh_shape, names = meshes[world]
    gshape = tuple(OP_LOCAL * p for p in mesh_shape) + (COMPONENTS,)
    return lattice(seed, gshape), mesh_shape, names


def gather_blocks(blocks: list, world: int,
                  meshes: dict = MESHES) -> np.ndarray:
    """Reassemble per-rank blocks (rank order) into the global array."""
    mesh_shape, _ = meshes[world]
    if len(mesh_shape) == 1:
        return np.concatenate(blocks, axis=0)
    rows = [np.concatenate(blocks[i * mesh_shape[1]:(i + 1) * mesh_shape[1]],
                           axis=1) for i in range(mesh_shape[0])]
    return np.concatenate(rows, axis=0)


def operator_job(rank: int, world: int) -> dict:
    """``StencilOp.apply`` at halo 1 and 2 and ``EvenOddOp.apply`` (on the
    even-projected field) under every schedule on this rank's block."""
    import torch

    from repro_torch.core.halo import HaloSpec
    from repro_torch.stencil import EvenOddOp, StencilOp

    xg, mesh_shape, names = op_inputs(world)
    comm = make_comm(mesh_shape, names)
    coords = comm.mesh.coords(rank)
    x = torch.from_numpy(np.ascontiguousarray(
        local_block(xg, mesh_shape, coords, len(names))))
    out = {}
    for halo in (1, 2):
        specs = tuple(HaloSpec(a, d, halo) for d, a in enumerate(names))
        op = StencilOp(specs=specs, mass=OP_MASS)
        for sched in SCHEDULES:
            out[("op", halo, sched)] = op.apply(
                x, comm, schedule=sched, chunks=2, channels=2).numpy()
    specs = tuple(HaloSpec(a, d, 1) for d, a in enumerate(names))
    eo = EvenOddOp(StencilOp(specs=specs, mass=OP_MASS))
    xe = x * eo.parity_mask(x.shape, True, comm)
    for sched in SCHEDULES:
        out[("eo", 1, sched)] = eo.apply(xe, comm, schedule=sched, chunks=2,
                                         channels=2).numpy()
    return out


def solver_job(rank: int, world: int) -> dict:
    """The solver family x precond at ``CG_ITERS`` unrolled iterations on
    the psum and ring_hier transports (the reference comparison); at two
    ranks also every schedule and the ring's plain local add (bitwise
    checks), and the ``LADDER_ITERS`` ladder: all-reduces and halo sends
    counted by the ``CommRecord``."""
    import torch

    from repro_torch.core.halo import HaloSpec
    from repro_torch.stencil import StencilOp, solve

    xg, mesh_shape, names = op_inputs(world, meshes=CG_MESHES)
    specs = tuple(HaloSpec(a, d, 1) for d, a in enumerate(names))
    op = StencilOp(specs=specs, mass=OP_MASS)
    comms = {"psum": make_comm(mesh_shape, names),
             "ring_hier": make_comm(mesh_shape, names,
                                    transport="ring_hier"),
             "ring_hier_plain": make_comm(mesh_shape, names,
                                          transport="ring_hier",
                                          local_op="plain")}
    coords = comms["psum"].mesh.coords(rank)
    b = torch.from_numpy(np.ascontiguousarray(
        local_block(xg, mesh_shape, coords, len(names))))
    out = {}

    def run(transport, solver, precond, sched, iters=CG_ITERS):
        res = solve(op, b, comms[transport], solver=solver, precond=precond,
                    s=CG_S, tol=None, maxiter=iters, schedule=sched,
                    chunks=2, channels=2)
        out[(transport, solver, precond, sched)] = (res.x.numpy(),
                                                    res.history.numpy())

    for solver in SOLVERS:
        for precond in PRECONDS:
            for transport in ("psum", "ring_hier"):
                run(transport, solver, precond, "concurrent")
            if world != 2:
                continue
            for sched in ("sequential", "chunked", "overlap"):
                run("psum", solver, precond, sched)
            run("ring_hier_plain", solver, precond, "concurrent")
            comm = comms["psum"]
            comm.record.reset()
            solve(op, b, comm, solver=solver, precond=precond, s=CG_S,
                  tol=None, maxiter=LADDER_ITERS, schedule="overlap",
                  chunks=2, channels=2)
            out[("ladder", solver, precond)] = comm.record.as_dict()
    return out


def _rel_diff(got: np.ndarray, want: np.ndarray) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


def check_family(reference: dict, ranks: list, world: int, rtol: float,
                 transport: str = "psum") -> dict:
    """Holds ``solver_job``'s family against ``CG_REF_SCRIPT``'s: ``x`` and
    ``history`` within ``rtol`` of their largest entry, the history entry
    by entry within ``rtol`` where it is above 1e-6 of its first.  Returns
    the largest relative differences."""
    worst = {"x": 0.0, "history": 0.0}
    for solver in SOLVERS:
        for precond in PRECONDS:
            key = (transport, solver, precond, "concurrent")
            x = gather_blocks([r[key][0] for r in ranks], world, CG_MESHES)
            h = ranks[0][key][1]
            for r in ranks[1:]:
                np.testing.assert_array_equal(r[key][1], h)
            want_x = reference[f"{world}/{solver}/{precond}/x"]
            want_h = reference[f"{world}/{solver}/{precond}/h"]
            assert h.shape == want_h.shape and x.shape == want_x.shape
            dx, dh = _rel_diff(x, want_x), _rel_diff(h, want_h)
            assert dx <= rtol, (world, transport, solver, precond, dx)
            assert dh <= rtol, (world, transport, solver, precond, dh)
            big = want_h > 1e-6 * want_h[0]
            np.testing.assert_allclose(h[big], want_h[big], rtol=rtol)
            worst = {"x": max(worst["x"], dx),
                     "history": max(worst["history"], dh)}
    return worst
