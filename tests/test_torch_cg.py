"""repro_torch's CG family (cg, pipelined, s-step; with and without even-odd
preconditioning) against the JAX reference.

Distributed: the six solver x precond combinations at 16 unrolled
iterations on 2 gloo ranks (mesh ``(2, 1)``: the y faces wrap locally),
psum transport, against the reference's ``shard_map`` run on the same
lattice (one JAX subprocess): ``x`` and ``history`` within 1e-4 relative
(the two packages sum their dot products in different orders; the largest
difference seen is stated at the test).  The port's own results are
bitwise across the four halo schedules and across the psum and ring_hier
transports (the ring's local add through the kernel wrapper and through
its plain version), and its ``CommRecord`` counts the reduction ladder
17 / 8 / 2 and ``predicted_halo_exchanges`` exchanges (2 sends each) at 8
unrolled iterations.  ``test_torch_cg4.py`` holds the family on 4 ranks.

One process (in process, ``reference=True``): the family against a dense
float64 solve and the reference's iteration counts, the prediction
helpers, the refusals, the convergence property over the reference's
grid, and the reference's s-step even-odd stall at 4x4.
"""

import os
import tempfile
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conftest import run_distributed
from torch_dist_util import run_ranks
import torch_stencil_jobs as jobs

from repro.core.halo import HaloSpec as RefSpec
from repro.stencil import StencilOp as RefOp
from repro.stencil import leja_chebyshev_shifts as ref_shifts
from repro.stencil import predicted_halo_exchanges as ref_pred_ex
from repro.stencil import predicted_reduction_collectives as ref_pred_red
from repro.stencil import solve as ref_solve
from repro_torch.core.halo import HaloSpec
from repro_torch.stencil import (PRECONDS, SOLVERS, EvenOddOp, StencilOp,
                                 leja_chebyshev_shifts,
                                 predicted_halo_exchanges,
                                 predicted_reduction_collectives, solve)

# x and history between the packages, relative to their largest entry
CG_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs():
    """The reference's run (a JAX subprocess, in a thread) and the port's
    2 ranks, side by side."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "cg.npz")
        script = jobs.CG_REF_SCRIPT.format(tests=os.path.dirname(__file__),
                                           path=path, worlds=(2,))
        with ThreadPoolExecutor(1) as pool:
            ref = pool.submit(run_distributed, script, n_devices=2)
            ranks = run_ranks(jobs.solver_job, 2)
            assert "CG_REF_OK" in ref.result()
        with np.load(path) as f:
            return dict(f), ranks


@pytest.fixture(scope="module")
def two_ranks(runs):
    return runs[1]


# largest relative differences seen on the CPU (x, history), torch 2.13,
# jax 0.9.0: 3.1e-7 and 1.5e-7
def test_solver_family_matches_the_reference(runs):
    jobs.check_family(*runs, 2, CG_RTOL)


def test_two_ranks_bitwise_across_schedules_and_transports(two_ranks):
    """Every schedule moves the same faces, and at two ranks every
    transport's sum of the two partial dots is one add: the solutions and
    histories are bitwise equal, and the ring's kernel-wrapper add equals
    its plain version."""
    for out in two_ranks:
        for solver in SOLVERS:
            for precond in PRECONDS:
                base = out[("psum", solver, precond, "concurrent")]
                others = [out[("psum", solver, precond, s)]
                          for s in ("sequential", "chunked", "overlap")]
                others += [out[(t, solver, precond, "concurrent")]
                           for t in ("ring_hier", "ring_hier_plain")]
                for x, h in others:
                    np.testing.assert_array_equal(x, base[0])
                    np.testing.assert_array_equal(h, base[1])


@pytest.mark.parametrize("precond", PRECONDS)
def test_reduction_ladder_and_halo_exchanges_in_the_comm_record(two_ranks,
                                                                precond):
    """8 unrolled iterations at s = 4: cg 2 x 8 + 1 = 17 all-reduces,
    pipelined 8, s-step 2 (derived from the solvers' code:
    ``predicted_reduction_collectives``), and under ``overlap`` two sends
    (the two x faces) for each of ``predicted_halo_exchanges``."""
    ladder = {"cg": 17, "pipelined": 8, "sstep": 2}
    for out in two_ranks:
        for solver in SOLVERS:
            rec = out[("ladder", solver, precond)]
            assert rec["all_reduces"] == ladder[solver] == \
                predicted_reduction_collectives(solver, jobs.LADDER_ITERS,
                                                s=jobs.CG_S)
            exchanges = predicted_halo_exchanges(solver, precond,
                                                 jobs.LADDER_ITERS,
                                                 s=jobs.CG_S)
            assert rec["sends"] == 2 * exchanges, (solver, precond)
            face = jobs.OP_LOCAL * jobs.COMPONENTS * 4      # a (1, 6, 3) face
            assert rec["send_bytes"] == 2 * exchanges * face


SHAPE = (8, 6)


def _problem(mass=0.2, seed=0, shape=SHAPE):
    specs = tuple(HaloSpec(f"ax{d}", d, 1) for d in range(len(shape)))
    rspecs = tuple(RefSpec(f"ax{d}", d, 1) for d in range(len(shape)))
    b = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return (StencilOp(specs=specs, mass=mass), RefOp(specs=rspecs, mass=mass),
            b)


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("precond", PRECONDS)
def test_one_process_family_matches_dense_solve_and_the_reference(solver,
                                                                  precond):
    op, rop, b = _problem()
    A = op.dense_matrix(SHAPE).double().numpy()
    xref = np.linalg.solve(A, b.reshape(-1).astype(np.float64))
    res = solve(op, torch.from_numpy(b), None, solver=solver,
                precond=precond, s=4, tol=1e-5, maxiter=200, reference=True)
    want = ref_solve(rop, jnp.asarray(b), None, solver=solver,
                     precond=precond, s=4, tol=1e-5, maxiter=200,
                     reference=True)
    assert res.iters == int(want.iters)
    assert float(res.rel_residual) < 1e-5
    x = res.x.double().numpy().reshape(-1)
    assert np.linalg.norm(A @ x - b.reshape(-1)) / np.linalg.norm(b) < 1e-5
    assert np.abs(x - xref).max() < 1e-4
    h, wh = res.history.numpy(), np.asarray(want.history)
    assert h.shape == wh.shape and ((h == 0) == (wh == 0)).all()


def test_unrolled_past_convergence_is_finite():
    op, _, b = _problem()
    A = op.dense_matrix(SHAPE).double().numpy()
    xref = np.linalg.solve(A, b.reshape(-1).astype(np.float64))
    tight = {"cg": 1e-4, "sstep": 1e-4, "pipelined": 1e-2}
    for solver in SOLVERS:
        for precond in PRECONDS:
            res = solve(op, torch.from_numpy(b), None, solver=solver,
                        precond=precond, tol=None, maxiter=60,
                        reference=True)
            x = res.x.numpy()
            assert np.isfinite(x).all(), (solver, precond)
            assert np.abs(x.reshape(-1) - xref).max() < tight[solver]


def test_helpers_equal_the_reference():
    for solver in SOLVERS:
        for iters in (1, 6, 8, 10, 13, 16):
            for s in (1, 3, 4):
                assert predicted_reduction_collectives(solver, iters, s) == \
                    ref_pred_red(solver, iters, s)
                for precond in PRECONDS:
                    for rep in (0, 6):
                        assert predicted_halo_exchanges(
                            solver, precond, iters, s, rep) == ref_pred_ex(
                            solver, precond, iters, s, rep)
    for lo, hi, s in [(0.2, 1.2, 1), (0.2, 1.2, 4), (0.05, 0.7, 7)]:
        assert leja_chebyshev_shifts(lo, hi, s) == ref_shifts(lo, hi, s)
    with pytest.raises(ValueError, match="s must be"):
        leja_chebyshev_shifts(0.2, 1.2, 0)
    with pytest.raises(ValueError, match="unknown solver"):
        predicted_reduction_collectives("bogus", 4)
    with pytest.raises(ValueError, match="unknown precond"):
        predicted_halo_exchanges("cg", "bogus", 4)


def test_solver_refusals_are_the_reference():
    op, _, b = _problem()
    tb = torch.from_numpy(b)
    with pytest.raises(ValueError, match="unknown solver"):
        solve(op, tb, None, solver="bogus", reference=True)
    with pytest.raises(ValueError, match="unknown precond"):
        solve(op, tb, None, precond="bogus", reference=True)
    for kw in (dict(solver="sstep"), dict(precond="eo")):
        with pytest.raises(ValueError, match="does not support x0"):
            solve(op, tb, None, x0=torch.zeros_like(tb), reference=True,
                  **kw)
    op2 = StencilOp(specs=(HaloSpec("ax0", 0, 2),), mass=0.5)
    with pytest.raises(ValueError, match="halo == 1"):
        solve(op2, torch.zeros(8, 3), None, precond="eo", reference=True)
    op3 = StencilOp(specs=(HaloSpec("ax0", 0, 1),), mass=0.5)
    with pytest.raises(ValueError, match="even global extent"):
        solve(op3, torch.zeros(7, 3), None, precond="eo", reference=True)


# The reference's grid of tests/test_properties.py::
# test_comm_avoiding_solvers_converge_with_eo, and the case Hypothesis
# found there, (4, 4), 0.5, 0, "sstep", where the reference stalls (see
# test_sstep_eo_stall_of_the_reference): the port converges on all five.
CONVERGE_CASES = [((4, 6), 0.2, 0, "pipelined"), ((6, 4), 0.5, 1, "sstep"),
                  ((4, 4), 1.0, 2, "pipelined"), ((6, 6), 0.3, 3, "sstep"),
                  ((4, 4), 0.5, 0, "sstep")]


@pytest.mark.parametrize("shape,mass,seed,solver", CONVERGE_CASES)
def test_comm_avoiding_solvers_converge_with_eo(shape, mass, seed, solver):
    op, _, b = _problem(mass=mass, seed=seed, shape=shape)
    res = solve(op, torch.from_numpy(b), None, solver=solver, precond="eo",
                s=4, tol=1e-5, maxiter=400, reference=True)
    A = op.dense_matrix(shape).double().numpy()
    xref = np.linalg.solve(A, b.reshape(-1).astype(np.float64))
    assert float(res.rel_residual) < 1e-5
    assert np.abs(res.x.numpy().reshape(-1) - xref).max() < 1e-3


def test_sstep_eo_stall_of_the_reference():
    """At 4x4, mass 0.5, the Schur operator has 3 distinct eigenvalues, so
    the Krylov space is 3-dimensional and an s = 4 block's Gram matrix is
    singular in exact arithmetic.  The reference's fp32 LU (LAPACK sgetrf
    through jaxlib) of its first block's matrix ``W`` gives an exactly zero
    last pivot, its solve inf/NaN, the guard a = 0; the next block rebuilds
    the same basis from the unchanged residual, so every block stalls: rel
    1.0 after 400 iterations, the history flat at the first block's entry.

    ``W`` is taken from the reference's own run (a spy on
    ``jnp.linalg.solve`` inside its compiled loop) and the stall's
    assertions are made on it.  The port's ``W`` is not bitwise it: the
    compiled loop forms the block's Gram dots in XLA's fused order, up to
    189 ulps of a dot from the port's, while the reference's code run op by
    op gives dots within 3 ulps of the port's.  The port's ``W`` is held to
    the reference's element by element within 64 ulps of its diagonal scale
    ``sqrt(|W_ii W_jj|)`` (13.4 reached).  PyTorch's LU leaves a last pivot
    of order 1e-14 on either matrix, its solve is finite, and the port
    converges.  At s = 3 both converge."""
    op, rop, b = _problem(mass=0.5, seed=0, shape=(4, 4))
    eo = EvenOddOp(op, distributed=False)
    S = torch.stack([eo.apply_reference(e) for e in torch.eye(16).reshape(
        16, 4, 4)]).reshape(16, 16).T.double().numpy()
    even = eo.parity_mask((4, 4)).numpy().reshape(-1) > 0
    ev = np.linalg.eigvalsh(S[np.ix_(even, even)])
    assert len(np.unique(np.round(ev, 6))) == 3 < 4

    kw = dict(solver="sstep", precond="eo", tol=1e-5, maxiter=400,
              reference=True)
    want = ref_solve(rop, jnp.asarray(b), None, s=4, **kw)
    assert float(want.rel_residual) == 1.0 and int(want.iters) == 400
    hist = np.asarray(want.history)
    assert (hist[:100] == hist[0]).all()

    # the reference's W: the matrix of each block's second solve, whose
    # right-hand side is the vector g (the first solves the (s, s) C)
    ref_seen = []
    ref_linalg_solve = jnp.linalg.solve

    def ref_spy(a, y):
        if y.ndim == 1:
            jax.debug.callback(lambda w: ref_seen.append(np.array(w)), a)
        return ref_linalg_solve(a, y)

    jnp.linalg.solve = ref_spy
    try:
        again = ref_solve(rop, jnp.asarray(b), None, s=4, **kw)
    finally:
        jnp.linalg.solve = ref_linalg_solve
    assert float(again.rel_residual) == 1.0 and int(again.iters) == 400
    w_ref = ref_seen[0]
    assert not np.isfinite(np.asarray(jnp.linalg.solve(
        jnp.asarray(w_ref), jnp.ones(4, jnp.float32)))).all()
    lu = np.asarray(jax.lax.linalg.lu(jnp.asarray(w_ref))[0])
    assert lu[3, 3] == 0.0

    seen = []
    solve_ex = torch.linalg.solve_ex

    def spy(a, y):
        seen.append(a.clone())
        return solve_ex(a, y)

    torch.linalg.solve_ex = spy
    try:
        got = solve(op, torch.from_numpy(b), None, s=4, **kw)
    finally:
        torch.linalg.solve_ex = solve_ex
    assert float(got.rel_residual) < 1e-5 and got.iters == 8
    w = seen[1].numpy()                  # the first block's W
    scale = np.sqrt(np.abs(np.outer(np.diag(w_ref), np.diag(w_ref))))
    ulps = np.abs(w.astype(np.float64) - w_ref) / (scale * 2.0**-23)
    assert ulps.max() <= 64, ulps
    for m in (seen[1], torch.from_numpy(w_ref)):
        pivots = torch.linalg.lu_factor(m)[0].diagonal()
        assert 0.0 < float(pivots[3].abs()) < 1e-12
        assert torch.isfinite(torch.linalg.solve_ex(
            m, torch.ones(4)).result).all()

    for pkg, args in (("ref", (rop, jnp.asarray(b))),
                      ("port", (op, torch.from_numpy(b)))):
        fn = ref_solve if pkg == "ref" else solve
        res = fn(*args, None, s=3, **kw)
        assert float(res.rel_residual) < 1e-5, pkg
        assert int(res.iters) == 6, pkg
