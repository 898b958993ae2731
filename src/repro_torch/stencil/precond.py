"""Even-odd (red-black) preconditioning of the Wilson-like stencil operator.

Port of ``repro.stencil.precond``.  Colour the periodic lattice by global
coordinate parity.  A nearest-neighbour operator ``A = d·I − H`` (``d =
StencilOp.diag``, ``H`` the hopping term) only couples sites of opposite
parity, so in the even/odd block ordering

    A = [[ d·I   −H_eo ]        S = d·I − (1/d)·H_eo·H_oe
         [ −H_oe  d·I  ]]

and solving ``A x = b`` reduces to the **Schur complement** system
``S x_e = b_e + (1/d)·H_eo b_o`` over the even sites only: half the
unknowns, a spectrum compressed quadratically, so CG needs roughly half
the iterations and half the latency-bound all-reduces.  The odd half is
recovered pointwise: ``x_o = (1/d)(b_o + H_oe x_e)``.

Fields stay full-lattice tensors whose odd (resp. even) sites are exactly
zero: ``H`` maps even-supported fields to odd-supported ones exactly, so
the Schur iterates keep their even support without masking; masks appear
only in the right-hand-side projection and the reconstruction.  Each
Schur matvec is two ``StencilOp.apply`` exchanges.

Validity: every direction must have ``halo == 1`` and every stencil
direction's **global** extent must be even (checked in
:func:`repro_torch.stencil.cg.solve`, which knows the mesh).

Parity comes from global coordinates: a distributed operator offsets each
local coordinate by this rank's coordinate in the communicator's
:class:`~repro_torch.core.topology.RankMesh` times the local extent, where
the reference reads ``lax.axis_index``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.stencil.op import StencilOp, f32


@dataclass(frozen=True)
class EvenOddOp:
    """Schur complement of a nearest-neighbour :class:`StencilOp` on the
    even sites: ``apply(x) = d·x − (1/d)·H(H(x))`` for even-supported ``x``.

    ``distributed=True`` computes site parity from *global* coordinates,
    offset by this rank's place in the mesh of the communicator passed to
    each call; ``False`` treats array coordinates as global (the
    single-process reference path).  It has :class:`StencilOp`'s ``apply``
    / ``apply_reference`` / ``eig_bounds``, so every solver in
    :mod:`repro_torch.stencil.cg` drives it unchanged.
    """

    op: StencilOp
    distributed: bool = True

    def __post_init__(self):
        bad = [s for s in self.op.specs if s.halo != 1]
        if bad:
            raise ValueError(
                f"even-odd preconditioning needs halo == 1 in every "
                f"direction (distance-2 hops couple equal parities); got "
                f"halo {tuple(s.halo for s in self.op.specs)}")

    @property
    def diag(self) -> float:
        return self.op.diag

    def eig_bounds(self) -> tuple[float, float]:
        """The Schur spectrum sits in ``[d − off²/d, d]``."""
        d = self.diag
        off = self.op.eig_bounds()[1] - d
        return d - off * off / d, d

    # -- parity ---------------------------------------------------------------

    def parity_mask(self, shape, even: bool = True, comm=None, *,
                    device=None) -> torch.Tensor:
        """fp32 indicator of the even (or odd) sites of a local shard: the
        parity of the sum of global coordinates over the stencil dims only.
        A distributed operator offsets each local coordinate by ``comm``'s
        coordinate of this rank along the spec's axis times the local
        extent."""
        if self.distributed and comm is None:
            raise ValueError("a distributed EvenOddOp needs the "
                             "communicator for its parity")
        coords = (dict(zip(comm.mesh.axis_names, comm.mesh.coords(comm.rank)))
                  if self.distributed else {})
        par = torch.zeros((1,) * len(shape), dtype=torch.int64, device=device)
        for spec in self.op.specs:
            n = int(shape[spec.dim])
            coord = torch.arange(n, device=device) + coords.get(spec.axis,
                                                                0) * n
            bshape = [1] * len(shape)
            bshape[spec.dim] = n
            par = par + coord.reshape(bshape)
        mask = (par % 2 == 0) if even else (par % 2 == 1)
        return mask.expand(tuple(int(n) for n in shape)).to(torch.float32)

    # -- hopping term ---------------------------------------------------------

    def _hop(self, x: torch.Tensor, comm, apply_kw: dict) -> torch.Tensor:
        """``H x = d·x − A x``: one halo exchange, flips site parity."""
        return f32(self.diag) * x - self.op.apply(x, comm, **apply_kw)

    def _hop_reference(self, xg: torch.Tensor) -> torch.Tensor:
        return f32(self.diag) * xg - self.op.apply_reference(xg)

    def _div_diag(self, t: torch.Tensor) -> torch.Tensor:
        """``t / d`` as a true division (a division by a Python scalar may
        run as a product with its reciprocal on CUDA)."""
        return t / torch.tensor(f32(self.diag), dtype=t.dtype,
                                device=t.device)

    # -- Schur matvec (same protocol as StencilOp.apply) ----------------------

    def apply(self, x: torch.Tensor, comm=None, *,
              schedule: str = "concurrent", chunks: int = 4,
              channels: int = 0) -> torch.Tensor:
        """Schur matvec on an even-supported local shard: two halo
        exchanges (even → odd → even), no masking."""
        kw = dict(schedule=schedule, chunks=chunks, channels=channels)
        inv = f32(1.0 / self.diag)
        return f32(self.diag) * x - inv * self._hop(self._hop(x, comm, kw),
                                                    comm, kw)

    def apply_reference(self, xg: torch.Tensor) -> torch.Tensor:
        """Global-lattice Schur matvec via ``torch.roll`` (no mesh)."""
        return f32(self.diag) * xg - self._div_diag(
            self._hop_reference(self._hop_reference(xg)))

    # -- one-time projection / reconstruction ---------------------------------

    def project_rhs(self, b: torch.Tensor, comm=None, *,
                    schedule: str = "concurrent", chunks: int = 4,
                    channels: int = 0) -> torch.Tensor:
        """Schur right-hand side ``b̂_e = b_e + (1/d)·H b_o`` (one halo
        exchange; even-supported)."""
        kw = dict(schedule=schedule, chunks=chunks, channels=channels)
        me = self.parity_mask(b.shape, True, comm, device=b.device)
        mo = self.parity_mask(b.shape, False, comm, device=b.device)
        bf = b.float()
        return me * (bf + f32(1.0 / self.diag) * self._hop(mo * bf, comm, kw))

    def reconstruct(self, x_e: torch.Tensor, b: torch.Tensor, comm=None, *,
                    schedule: str = "concurrent", chunks: int = 4,
                    channels: int = 0) -> torch.Tensor:
        """Full-lattice solution ``x = x_e + (1/d)·𝟙_o·(b + H x_e)`` (one
        halo exchange)."""
        kw = dict(schedule=schedule, chunks=chunks, channels=channels)
        mo = self.parity_mask(b.shape, False, comm, device=b.device)
        xf = x_e.float()
        return xf + mo * (b.float() + self._hop(xf, comm, kw)) \
            * f32(1.0 / self.diag)

    def project_rhs_reference(self, bg: torch.Tensor) -> torch.Tensor:
        me = self.parity_mask(bg.shape, True, device=bg.device)
        mo = self.parity_mask(bg.shape, False, device=bg.device)
        bf = bg.float()
        return me * (bf + self._div_diag(self._hop_reference(mo * bf)))

    def reconstruct_reference(self, x_e: torch.Tensor,
                              bg: torch.Tensor) -> torch.Tensor:
        mo = self.parity_mask(bg.shape, False, device=bg.device)
        xf = x_e.float()
        return xf + self._div_diag(mo * (bg.float()
                                         + self._hop_reference(xf)))
