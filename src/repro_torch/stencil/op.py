"""Wilson-like covariant stencil operator over an N-D Cartesian mesh.

Port of ``repro.stencil.op``.  The operator is the 2·d·w-point
nearest-neighbour matrix the paper's QCD workload (Grid's Dslash) applies
between halo exchanges:

    (A x)[i] = (mass + 2 Σ_d κ_d w_d) x[i]
               − Σ_d κ_d Σ_{s=1..w_d} ( x[i − s e_d] + x[i + s e_d] )

over a periodic global lattice, with per-direction hopping weights ``κ_d``
and face width ``w_d`` (= ``HaloSpec.halo``).  It is symmetric, and SPD
whenever ``mass > 0`` and every ``κ_d > 0``.

The apply is an **interior/boundary split**: each direction's
neighbour-sum is first computed on the sites that need no halo, from local
data only, while the faces are in flight; the two ``halo``-wide boundary
slabs are then computed from the received faces.  Every site's value is
the same expression whichever part computes it, and the schedules only
move faces, so the result does not depend on the schedule.  The
reference computes its interior on a zero-padded copy whose boundary
sites it overwrites; the port reads the interior straight from ``x``
(the same values, one copy of the field fewer per direction).

The reference's roundings are kept: ``diag`` and ``κ`` are rounded to
fp32 (``jnp.asarray(..., x.dtype)``) and every product and difference is
its own operation, so the CPU, the card and the reference (run with XLA's
fusion pass off) agree bit for bit.  ``optimization_barrier`` has no
counterpart here: eager ops are never fused across it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from repro_torch.core.halo import HaloSpec, halo_exchange


def f32(v: float) -> float:
    """``v`` rounded to fp32, as a Python float: a product with an fp32
    tensor then rounds once, on any device."""
    return float(np.float32(v))


def _neighbour_sum(xc: torch.Tensor, start: int, count: int, width: int,
                   dim: int) -> torch.Tensor:
    """Σ_{s=1..width} (xc[i−s] + xc[i+s]) for sites [start, start+count) of
    ``xc`` along ``dim``.  Accumulation order is fixed (ascending ``s``,
    minus then plus) so every caller produces the same bits."""
    acc = None
    for s in range(1, width + 1):
        t = xc.narrow(dim, start - s, count) + xc.narrow(dim, start + s,
                                                         count)
        acc = t if acc is None else acc + t
    return acc


@dataclass(frozen=True)
class StencilOp:
    """Wilson-like operator: ``specs`` name the stencil directions (array
    dim × mesh axis × face width), ``hopping`` the per-direction κ.  With
    no ``hopping`` given every direction gets ``κ = 1 / (4 · n_dirs)``."""

    specs: tuple[HaloSpec, ...]
    mass: float = 1.0
    hopping: tuple[float, ...] = ()

    def __post_init__(self):
        if not self.specs:
            raise ValueError("StencilOp needs at least one direction spec")
        if self.hopping and len(self.hopping) != len(self.specs):
            raise ValueError(
                f"{len(self.hopping)} hopping weights for "
                f"{len(self.specs)} direction specs")

    @property
    def kappas(self) -> tuple[float, ...]:
        if self.hopping:
            return self.hopping
        return (1.0 / (4.0 * len(self.specs)),) * len(self.specs)

    @property
    def diag(self) -> float:
        """Diagonal coefficient; exceeds the off-diagonal row sum by
        ``mass``."""
        return self.mass + 2.0 * sum(k * s.halo
                                     for k, s in zip(self.kappas, self.specs))

    def eig_bounds(self) -> tuple[float, float]:
        """Analytic spectral enclosure ``[λmin, λmax]`` of the periodic
        operator: every eigenvalue ``diag − Σ_d κ_d Σ_s 2·cos(s·θ_d)`` lies
        within ``off = 2·Σ_d κ_d·w_d`` of the diagonal."""
        off = 2.0 * sum(k * s.halo for k, s in zip(self.kappas, self.specs))
        return self.diag - off, self.diag + off

    # -- local compute -------------------------------------------------------

    def _interior(self, x: torch.Tensor,
                  spec: HaloSpec) -> torch.Tensor | None:
        """One direction's neighbour-sum on the sites ``[w, n - w)``, which
        need no halo; the boundary slabs are left for :meth:`_dir_sum`.
        ``None`` when ``n < 2w`` (:meth:`_dir_sum` then pads directly)."""
        d, w, n = spec.dim, spec.halo, x.shape[spec.dim]
        if n < 2 * w:
            return None
        out = torch.empty_like(x)
        out.narrow(d, w, n - 2 * w).copy_(_neighbour_sum(x, w, n - 2 * w,
                                                         w, d))
        return out

    def _dir_sum(self, x: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor,
                 spec: HaloSpec, interior: torch.Tensor | None = None
                 ) -> torch.Tensor:
        """One direction's neighbour-sum from local data + received faces:
        the interior (``interior``, or computed here), then the two
        boundary slabs from the real halos.  Falls back to the directly
        padded form when the local extent is too small to keep the slabs
        disjoint (``n < 2·halo``)."""
        d, w, n = spec.dim, spec.halo, x.shape[spec.dim]
        if n < 2 * w:
            return _neighbour_sum(torch.cat([lo, x, hi], dim=d), w, n, w, d)
        s0 = interior if interior is not None else self._interior(x, spec)
        # lo slab: sites [0, w) need the lo halo and x[0, 2w)
        xlo = torch.cat([lo, x.narrow(d, 0, 2 * w)], dim=d)
        s0.narrow(d, 0, w).copy_(_neighbour_sum(xlo, w, w, w, d))
        # hi slab: sites [n-w, n) need x[n-2w, n) and the hi halo; site n-w
        # sits at offset w of the 3w-long window
        xhi = torch.cat([x.narrow(d, n - 2 * w, 2 * w), hi], dim=d)
        s0.narrow(d, n - w, w).copy_(_neighbour_sum(xhi, w, w, w, d))
        return s0

    def apply_halos(self, x: torch.Tensor, halos: dict,
                    interiors: Sequence | None = None) -> torch.Tensor:
        """Apply the operator given already-received halos (the compute half
        of :meth:`apply`, schedule-independent by construction);
        ``interiors`` are the directions' :meth:`_interior` sums when they
        were computed while the faces were in flight."""
        if interiors is None:
            interiors = [None] * len(self.specs)
        y = f32(self.diag) * x
        for spec, kappa, inner in zip(self.specs, self.kappas, interiors):
            s = self._dir_sum(x, halos[(spec.axis, "-")],
                              halos[(spec.axis, "+")], spec, inner)
            y = y - f32(kappa) * s
        return y

    # -- distributed apply --------------------------------------------------

    def apply(self, x: torch.Tensor, comm=None, *,
              schedule: str = "concurrent", chunks: int = 4,
              channels: int = 0) -> torch.Tensor:
        """Halo exchange + apply on this rank's local shard.  ``comm`` is
        the :class:`~repro_torch.comm.Communicator` whose rails carry the
        faces, or ``None`` for one process (every axis wraps onto this
        rank).  The faces go out first; the interior sums run while they
        are in flight; the boundary slabs wait for them.  The schedule
        decides how the faces move; the arithmetic is the same for all."""
        rings = comm.halo_rings() if comm is not None else None
        pending = halo_exchange(x, self.specs, rings, schedule=schedule,
                                chunks=chunks, channels=channels, wait=False)
        interiors = [self._interior(x, spec) for spec in self.specs]
        return self.apply_halos(x, pending.wait(), interiors)

    # -- references (single process, global lattice) -------------------------

    def apply_reference(self, xg: torch.Tensor) -> torch.Tensor:
        """Reference on a *global* periodic lattice via ``torch.roll`` —
        what the distributed apply must reproduce."""
        y = f32(self.diag) * xg
        for spec, kappa in zip(self.specs, self.kappas):
            for s in range(1, spec.halo + 1):
                y = y - f32(kappa) * (torch.roll(xg, s, dims=spec.dim)
                                      + torch.roll(xg, -s, dims=spec.dim))
        return y

    def dense_matrix(self, shape: Sequence[int]) -> torch.Tensor:
        """The operator as an explicit (N, N) fp32 matrix over a global
        lattice of ``shape`` (tiny lattices only)."""
        n = 1
        for s in shape:
            n *= int(s)
        eye = torch.eye(n, dtype=torch.float32).reshape((n,) + tuple(shape))
        cols = torch.stack([self.apply_reference(e) for e in eye])
        return cols.reshape(n, n).T
