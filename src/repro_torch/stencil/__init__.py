"""repro_torch.stencil — structured-grid PDE solvers on the Communicator.

Port of ``repro.stencil``, the paper's first workload end to end: a
Wilson-like nearest-neighbour operator over an N-D Cartesian mesh
(:mod:`repro_torch.stencil.op`) whose halo exchange runs any of the four
:data:`repro_torch.comm.HALO_SCHEDULES`, and a communication-avoiding
conjugate-gradient family (:mod:`repro_torch.stencil.cg`: classic,
pipelined and s-step CG, optionally on the even-odd Schur complement of
:mod:`repro_torch.stencil.precond`) whose inner products ride the
communicator's channelized ``all_reduce``.
"""

from repro_torch.stencil.cg import (CGResult, PRECONDS, SOLVERS, cg_solve,
                                    global_sums, leja_chebyshev_shifts,
                                    pipelined_cg_solve,
                                    predicted_halo_exchanges,
                                    predicted_reduction_collectives, solve,
                                    sstep_cg_solve)
from repro_torch.stencil.op import StencilOp
from repro_torch.stencil.precond import EvenOddOp

__all__ = [
    "CGResult", "EvenOddOp", "PRECONDS", "SOLVERS", "StencilOp", "cg_solve",
    "global_sums", "leja_chebyshev_shifts", "pipelined_cg_solve",
    "predicted_halo_exchanges", "predicted_reduction_collectives", "solve",
    "sstep_cg_solve",
]
