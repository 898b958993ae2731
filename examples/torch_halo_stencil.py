"""The paper's first workload on the PyTorch port: a Wilson-like stencil
operator driven to convergence by the comm-avoiding CG family — ``solver ∈
{cg, pipelined, sstep} × precond ∈ {none, eo}`` — with the halo exchange on
the ``overlap`` schedule, the configuration of ``examples/halo_stencil.py``.
The ``reductions`` column counts the latency-bound inner-product
all-reduces each variant pays: classic CG's ``2·iters+1`` drops to
``iters`` (pipelined) to ``ceil(iters/s)`` (s-step), and even-odd
preconditioning roughly halves ``iters`` on top.

    PYTHONPATH=src python examples/torch_halo_stencil.py          # one GPU
    PYTHONPATH=src python examples/torch_halo_stencil.py --device cpu --nproc 2

Several ranks on one host are spawned as local processes (gloo on the CPU,
or several ranks sharing one card; NCCL when each rank has its own card),
each holding a ``24 x 24 x 12`` block of the lattice along the ``x`` axis.
"""

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig, Communicator
from repro_torch.core.halo import HaloSpec
from repro_torch.core.topology import RankMesh
from repro_torch.launch.train import init_distributed, spawn
from repro_torch.stencil import (PRECONDS, SOLVERS, StencilOp, global_sums,
                                 predicted_reduction_collectives, solve)

L, C = 24, 12                        # local extent, spinor-ish components


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(device: str) -> None:
    world = init_distributed(device)
    n = world.size
    dev = world.device
    specs = (HaloSpec("x", 0),)
    op = StencilOp(specs=specs, mass=0.2)
    comm = Communicator(RankMesh(("x",), (n,)),
                        CommConfig(transport="psum", data_axes=("x",),
                                   channels=2))
    rng = np.random.RandomState(0)
    bg = rng.randn(n * L, L, C).astype(np.float32)
    b = torch.from_numpy(bg[world.rank * L:(world.rank + 1) * L]).to(dev)
    log = print if world.rank == 0 else (lambda msg: None)

    hplan = comm.halo_plan((L, L, C), specs, schedule="overlap")
    log(f"ranks={n}  device={dev}  local={L}x{L}x{C}  halo bytes/exchange="
        f"{hplan.bytes_per_device:.0f}  "
        f"overlap_frac={hplan.overlap_fraction:.2f}\n")
    log(f"{'solver':10s} {'precond':8s} {'iters':>5s} {'reductions':>10s} "
        f"{'rel_resid':>10s} {'ms/solve':>9s}")

    def one(solver, precond):
        return solve(op, b, comm, solver=solver, precond=precond, s=4,
                     tol=1e-5, maxiter=300, schedule="overlap", chunks=2,
                     channels=2)

    sols = {}
    for solver in SOLVERS:
        for precond in PRECONDS:
            res = one(solver, precond)
            _sync(dev)
            t0 = time.perf_counter()
            for _ in range(3):
                one(solver, precond)
            _sync(dev)
            dt = (time.perf_counter() - t0) / 3
            sols[(solver, precond)] = res.x
            red = predicted_reduction_collectives(solver, res.iters, s=4)
            log(f"{solver:10s} {precond:8s} {res.iters:5d} {red:10d} "
                f"{float(res.rel_residual):10.2e} {dt * 1e3:9.1f}")

    ref = sols[("cg", "none")]
    worst = torch.stack([(x - ref).abs().max() for x in sols.values()]).max()
    worst = worst.reshape(1).cpu()
    if world.backend is not None:
        dist.all_reduce(worst, op=dist.ReduceOp.MAX)
    log(f"\nmax |x_variant - x_cg| across the family: {float(worst):.2e}")
    r = op.apply(ref, comm, schedule="overlap", chunks=2, channels=2) - b
    rr, bb = global_sums(comm, torch.dot(r.reshape(-1), r.reshape(-1)),
                         torch.dot(b.reshape(-1), b.reshape(-1)))
    log(f"final check ‖A x - b‖/‖b‖ = {float(torch.sqrt(rr / bb)):.2e}")
    if world.backend is not None:
        dist.destroy_process_group()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=1,
                    help="local ranks to spawn")
    args = ap.parse_args()
    if args.nproc > 1:
        spawn(run, args.nproc, args.device)
    else:
        run(args.device)


if __name__ == "__main__":
    main()
