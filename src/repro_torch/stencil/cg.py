"""Conjugate-gradient solver family on a distributed stencil operator.

Port of ``repro.stencil.cg``.  The matrix-vector product is
:meth:`repro_torch.stencil.op.StencilOp.apply` (halo exchange + local
stencil) and the global inner products ride the communicator's
channelized ``all_reduce`` (:func:`global_sums` packs the partial dots
into one flat buffer padded to the transport's divisor; on the ring
transports every hop's add is the ``reduce_add`` kernel on the card):

``cg``
    Textbook CG: two inner-product reductions per iteration
    (``2·iters + 1`` with the initial ``‖r‖²/‖b‖²`` batch).
``pipelined``
    Ghysels–Vanroose pipelined CG: one batched reduction per iteration
    (``γ = ‖r‖²``, ``δ = (w,r)`` and the latched ``‖b‖²``), independent of
    the same iteration's matvec; periodic residual replacement
    (``replace_every``).  ``iters`` reductions.
``sstep``
    Communication-avoiding s-step CG (Chronopoulos–Gear blocks, Newton
    basis with Leja-ordered Chebyshev shifts): one fused reduction per
    block of ``s`` matvecs, ``ceil(iters/s)`` reductions.

``precond="eo"`` solves the even-odd Schur complement
(:mod:`repro_torch.stencil.precond`) with any of the three.

Iteration modes (all solvers):

* ``tol`` given — runs to ``‖r‖ ≤ tol·‖b‖`` or ``maxiter``, testing the
  reference's ``while_loop`` condition exactly, so ``iters``, ``history``
  (fixed length, tail 0) and ``rel_residual`` mean what they mean there.
  The condition reads a reduced scalar on the host: one device sync an
  iteration (a block for ``sstep``).
* ``tol=None`` — a fixed iteration/block count.  It issues exactly
  :func:`predicted_halo_exchanges` exchanges and
  :func:`predicted_reduction_collectives` reductions (``x0=None``): a
  matvec whose result nothing reads — where XLA drops it from the
  reference's unrolled graph — is not computed, which changes no value.

``CGResult.history`` records ``‖r‖²`` at each reduction point (iteration
entry for ``cg``/``pipelined``, block entry for ``sstep``); ``iters`` is a
Python ``int``.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from repro_torch.core.topology import padded_size
from repro_torch.stencil.op import f32
from repro_torch.stencil.precond import EvenOddOp

SOLVERS = ("cg", "pipelined", "sstep")
PRECONDS = ("none", "eo")


class CGResult(NamedTuple):
    """Solution plus convergence record (local-shard views)."""

    x: torch.Tensor
    iters: int               # iterations actually run
    rel_residual: torch.Tensor  # ‖r‖ / ‖b‖ at exit (recurrence residual)
    history: torch.Tensor       # ‖r‖² per reduction point; tail entries 0


def global_sums(comm, *vals):
    """Sum scalars over the communicator's data axes on its channelized
    ``all_reduce``: the partial dots stacked into one flat fp32 buffer,
    zero-padded to the transport's flat divisor, reduced, and unpacked.
    ``comm=None`` (or a mesh with no data axes) means one process: the
    values come back unchanged."""
    if comm is None or not comm.axes:
        return vals if len(vals) > 1 else vals[0]
    vec = torch.stack([v.float().reshape(()) for v in vals])
    n = padded_size(len(vals), comm.transport.flat_divisor(comm.axis_sizes))
    vec = torch.cat([vec, vec.new_zeros(n - len(vals))])
    out = comm.all_reduce([vec])[0]
    return tuple(out[i] for i in range(len(vals))) if len(vals) > 1 \
        else out[0]


def _dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.dot(a.float().reshape(-1), b.float().reshape(-1))


def _guarded_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    """``num / den`` where ``den > 0``, else 0 (the reference's
    ``where(den > 0, num / where(den > 0, den, 1), 0)``)."""
    pos = den > 0.0
    return torch.where(pos, num / torch.where(pos, den, torch.ones_like(den)),
                       torch.zeros_like(num))


def leja_chebyshev_shifts(lo: float, hi: float, s: int) -> tuple[float, ...]:
    """Leja-ordered Chebyshev points of ``[lo, hi]`` — the Newton-basis
    shifts for one s-step block (start from the extreme point, then
    greedily maximise the distance product to the points placed)."""
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if not hi > lo:
        raise ValueError(f"need hi > lo, got [{lo}, {hi}]")
    mid, rad = (lo + hi) / 2.0, (hi - lo) / 2.0
    pts = [mid + rad * math.cos((2 * k + 1) * math.pi / (2 * s))
           for k in range(s)]
    ordered = [max(pts, key=abs)]
    pts.remove(ordered[0])
    while pts:
        nxt = max(pts, key=lambda t: math.prod(abs(t - u) for u in ordered))
        pts.remove(nxt)
        ordered.append(nxt)
    return tuple(ordered)


# ---------------------------------------------------------------------------
# prediction helpers (exact for the fixed-count mode with x0=None; upper
# bounds with tol set), copied from the reference
# ---------------------------------------------------------------------------


def predicted_reduction_collectives(solver: str, iters: int, s: int = 4
                                    ) -> int:
    """Inner-product reductions one fixed-count solve issues: ``cg`` two
    per iteration plus the initial batch, ``pipelined`` one per iteration,
    ``sstep`` one per block."""
    if solver == "cg":
        return 2 * iters + 1
    if solver == "pipelined":
        return iters
    if solver == "sstep":
        return math.ceil(iters / max(s, 1))
    raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")


def predicted_halo_exchanges(solver: str, precond: str, iters: int,
                             s: int = 4, replace_every: int = 6) -> int:
    """Halo exchanges (operator applications) one fixed-count solve
    issues.  ``pipelined`` pays one extra matvec for ``w₀ = A r₀`` but its
    last iteration's matvec is dead (the two cancel); each residual
    replacement computes four matvecs and nets three (the previous
    iteration's matvec is dead).  ``sstep`` completes whole blocks;
    even-odd doubles the per-matvec exchanges and adds one each for the
    projection and the reconstruction."""
    if solver == "cg":
        base = iters
    elif solver == "pipelined":
        n_rep = (iters - 1) // replace_every if replace_every > 0 else 0
        base = iters + 3 * n_rep
    elif solver == "sstep":
        base = max(s, 1) * math.ceil(iters / max(s, 1))
    else:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    if precond == "none":
        return base
    if precond == "eo":
        return 2 * base + 2
    raise ValueError(f"unknown precond {precond!r}; one of {PRECONDS}")


def _default_matvec(op, comm, schedule, chunks, channels):
    return lambda v: op.apply(v, comm, schedule=schedule, chunks=chunks,
                              channels=channels)


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(v, dtype=torch.float32, device=like.device)


def _rel(rs: torch.Tensor, bs: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(rs) / torch.clamp(torch.sqrt(bs), min=1e-30)


# ---------------------------------------------------------------------------
# classic CG
# ---------------------------------------------------------------------------


def cg_solve(op, b: torch.Tensor, comm=None, *,
             x0: torch.Tensor | None = None, tol: float | None = 1e-6,
             maxiter: int = 100, schedule: str = "concurrent",
             chunks: int = 4, channels: int = 0, matvec=None) -> CGResult:
    """Solve ``op x = b`` (SPD ``op``) by classic conjugate gradients.

    ``b`` is this rank's local shard; ``op`` a :class:`StencilOp` (or any
    object with its ``apply``).  ``schedule``/``chunks``/``channels``
    select the halo schedule of every matvec; ``comm`` carries the faces
    and the inner products (``None`` = one process).  ``matvec`` overrides
    the product, e.g. ``op.apply_reference`` on a global lattice."""
    if matvec is None:
        matvec = _default_matvec(op, comm, schedule, chunks, channels)
    x = torch.zeros_like(b) if x0 is None else x0
    r = b - matvec(x) if x0 is not None else b
    p = r
    rs, bs = global_sums(comm, _dot(r, r), _dot(b, b))
    hist = torch.zeros(maxiter + 1, dtype=torch.float32, device=b.device)
    hist[0] = rs

    def step(x, r, p, rs):
        ap = matvec(p)
        pap = global_sums(comm, _dot(p, ap))
        # guarded divisions: past convergence the fixed-count mode stalls
        # at 0 instead of NaN
        alpha = _guarded_div(rs, pap)
        x = x + alpha * p.float()
        r = r - alpha * ap.float()
        rs_new = global_sums(comm, _dot(r, r))
        beta = _guarded_div(rs_new, rs)
        p = r + beta * p
        return x, r, p, rs_new

    x, r, p = x.float(), r.float(), p.float()
    if tol is None:
        for k in range(maxiter):
            x, r, p, rs = step(x, r, p, rs)
            hist[k + 1] = rs
        iters = maxiter
    else:
        limit = _scalar(tol * tol, b) * bs
        iters = 0
        while iters < maxiter and bool(rs > limit):
            x, r, p, rs = step(x, r, p, rs)
            hist[iters + 1] = rs
            iters += 1
    return CGResult(x=x.to(b.dtype), iters=iters,
                    rel_residual=_rel(rs, bs), history=hist)


# ---------------------------------------------------------------------------
# pipelined CG (Ghysels & Vanroose)
# ---------------------------------------------------------------------------


def pipelined_cg_solve(op, b: torch.Tensor, comm=None, *,
                       x0: torch.Tensor | None = None,
                       tol: float | None = 1e-6, maxiter: int = 100,
                       schedule: str = "concurrent", chunks: int = 4,
                       channels: int = 0, matvec=None,
                       replace_every: int = 6) -> CGResult:
    """Pipelined CG: one reduction per iteration, whose operands come from
    the previous iteration's state, so it shares no data with the
    iteration's matvec ``q = A w``.  Every ``replace_every`` iterations
    (``0``: never) the residual is replaced: ``r = b − A x``, ``w = A r``,
    ``s = A p`` and ``z = A s`` recomputed, ``p`` and the scalars kept (four
    matvecs, no reduction).  ``q`` is not computed where nothing reads it:
    on the last iteration run, and before a replacement."""
    if matvec is None:
        matvec = _default_matvec(op, comm, schedule, chunks, channels)
    x = (torch.zeros_like(b) if x0 is None else x0).float()
    r = (b - matvec(x) if x0 is not None else b).float()
    w = matvec(r).float()
    zero = torch.zeros_like(r)
    hist = torch.zeros(maxiter + 1, dtype=torch.float32, device=b.device)
    bf = b.float()
    limit2 = _scalar(tol * tol, b) if tol is not None else None

    def replace(x, p):
        rr = bf - matvec(x).float()
        ss = matvec(p).float()
        return rr, matvec(rr).float(), ss, matvec(ss).float()

    def replaces_at(k: int) -> bool:
        return replace_every > 0 and k > 0 and k % replace_every == 0

    def step(k, x, r, w, z, s_, p, g_old, a_old, bs):
        g, de, bsp = global_sums(comm, _dot(r, r), _dot(w, r), _dot(bf, bf))
        bs = bsp if k == 0 else bs
        # does an iteration k + 1 run?  The reference's loop condition,
        # read here because this iteration's matvec feeds only the next
        if tol is None:
            more = k + 1 < maxiter
        else:
            more = k + 1 < maxiter and bool(g > limit2 * bs)
        q = matvec(w) if more and not replaces_at(k + 1) else None
        beta = (torch.zeros_like(g) if k == 0 else _guarded_div(g, g_old))
        den = de - beta * g / torch.where(a_old > 0.0, a_old,
                                          torch.ones_like(a_old))
        alpha = _guarded_div(g, den)
        if q is not None:
            z = q + beta * z
        s_ = w + beta * s_
        p = r + beta * p
        x = x + alpha * p
        r = r - alpha * s_
        if q is not None:
            w = w - alpha * z
        else:                  # dead: the loop ends or replace() rebuilds
            w = z = None
        return (x, r, w, z, s_, p, g, alpha, bs, g), more

    z = s_ = p = zero
    g_old = a_old = _scalar(1.0, b)
    bs = rs = _scalar(math.inf, b)
    k = 0
    more = tol is not None or maxiter > 0   # the while form runs once
    while more:
        if replaces_at(k):
            r, w, s_, z = replace(x, p)
        (x, r, w, z, s_, p, g_old, a_old, bs, rs), more = step(
            k, x, r, w, z, s_, p, g_old, a_old, bs)
        hist[k] = rs
        k += 1
    return CGResult(x=x.to(b.dtype), iters=k, rel_residual=_rel(rs, bs),
                    history=hist)


# ---------------------------------------------------------------------------
# s-step CG (Chronopoulos & Gear blocks, Newton basis)
# ---------------------------------------------------------------------------


def _tri_pairs(s: int) -> list[tuple[int, int]]:
    """Upper-triangle index pairs of the (s+1)×(s+1) basis Gram matrix."""
    return [(i, j) for i in range(s + 1) for j in range(i, s + 1)]


def sstep_cg_solve(op, b: torch.Tensor, comm=None, *, s: int = 4,
                   x0: torch.Tensor | None = None,
                   tol: float | None = 1e-6, maxiter: int = 100,
                   schedule: str = "concurrent", chunks: int = 4,
                   channels: int = 0, matvec=None,
                   eig_bounds: tuple[float, float] | None = None
                   ) -> CGResult:
    """Communication-avoiding s-step CG: one fused reduction per ``s``
    iterations.

    Each block builds the Newton-basis Krylov block ``v₀ = r, v_{j+1} =
    (A − θ_j)·v_j`` (``s`` matvecs; shifts from :func:`leja_chebyshev_shifts`
    over ``eig_bounds``, default ``op.eig_bounds()``), then reduces every
    scalar it needs in **one** :func:`global_sums`: the basis Gram matrix,
    the coupling to the previous direction block and the Galerkin
    correction.  The (s×s) solves (``torch.linalg.solve_ex``, which gives
    inf/NaN for a singular matrix where ``solve`` raises) then advance
    ``x`` by ``s`` iterations; a block whose solve is not finite, or whose
    residual is 0, stalls at ``a = 0`` as in the reference.

    ``maxiter`` counts fine-grained iterations; blocks always complete.
    ``x0`` is not supported (the first block's reduction doubles as the
    ``‖b‖²`` measurement)."""
    if x0 is not None:
        raise ValueError("sstep_cg_solve does not support x0 (the first "
                         "block's reduction doubles as the ‖b‖² batch)")
    if s < 1:
        raise ValueError(f"s must be >= 1, got {s}")
    if matvec is None:
        matvec = _default_matvec(op, comm, schedule, chunks, channels)
    lo, hi = eig_bounds if eig_bounds is not None else op.eig_bounds()
    theta = leja_chebyshev_shifts(lo, hi, s)
    nblocks = math.ceil(max(int(maxiter), 1) / s)
    pairs = _tri_pairs(s)
    dev = b.device
    rows, cols = torch.tensor(pairs, device=dev).T
    theta_t = torch.tensor(theta, dtype=torch.float32, device=dev)
    th = theta_t.reshape((s,) + (1,) * b.dim())
    eye = torch.eye(s, dtype=torch.float32, device=dev)
    zeros_ss = torch.zeros((s, s), dtype=torch.float32, device=dev)
    zeros_s = torch.zeros((s,), dtype=torch.float32, device=dev)

    def block(x, r, P, AP, W_old):
        V = [r]
        for j in range(s):
            V.append(matvec(V[j]).float() - f32(theta[j]) * V[j])
        Vs = torch.stack(V)                            # (s+1,) + shape
        # one fused reduction: Gram upper triangle + coupling + correction
        dots = [_dot(V[i], V[j]) for i, j in pairs]
        dots += [_dot(AP[i], V[j]) for i in range(s) for j in range(s)]
        dots += [_dot(P[i], r) for i in range(s)]
        red = global_sums(comm, *dots)
        red = torch.stack(red) if isinstance(red, tuple) else red[None]
        n_g = len(pairs)
        G = torch.zeros((s + 1, s + 1), dtype=torch.float32, device=dev)
        G[rows, cols] = red[:n_g]
        G[cols, rows] = red[:n_g]
        C = red[n_g:n_g + s * s].reshape(s, s)
        h = red[n_g + s * s:n_g + s * s + s]
        rs = G[0, 0]
        # RᵀAR via the shift recurrence A v_j = v_{j+1} + θ_j v_j
        M = G[:s, 1:s + 1] + G[:s, :s] * theta_t
        # guards: a singular Gram solve (past convergence, or a Krylov
        # space smaller than s) stalls the block at a = 0, and dropping B
        # restarts the next block's conjugation
        ok = rs > 0.0
        W_safe = torch.where(ok, W_old, eye)
        B = -torch.linalg.solve_ex(W_safe, C).result
        B = torch.where(torch.isfinite(B).all(), B, zeros_ss)
        W = M + C.T @ B + B.T @ C + B.T @ W_safe @ B
        W = 0.5 * (W + W.T)
        g = G[0, :s] + B.T @ h
        W_solve = torch.where(ok, W, eye)
        a = torch.linalg.solve_ex(W_solve, g).result
        a = torch.where(ok & torch.isfinite(a).all(), a, zeros_s)
        Pn = Vs[:s] + torch.tensordot(B, P, dims=([0], [0]))
        APn = (Vs[1:] + th * Vs[:s]) + torch.tensordot(B, AP, dims=([0], [0]))
        x = x + torch.tensordot(a, Pn, dims=([0], [0]))
        r = r - torch.tensordot(a, APn, dims=([0], [0]))
        return x, r, Pn, APn, W_solve, rs

    x = torch.zeros_like(b, dtype=torch.float32)
    r = b.float()
    P = AP = torch.zeros((s,) + tuple(b.shape), dtype=torch.float32,
                         device=dev)
    W = eye
    hist = torch.zeros(nblocks + 1, dtype=torch.float32, device=dev)
    rs = bs = _scalar(math.inf, b)
    limit2 = _scalar(tol * tol, b) if tol is not None else None
    k = 0
    while k == 0 or (k < nblocks
                     and (tol is None or bool(rs > limit2 * bs))):
        x, r, P, AP, W, rs = block(x, r, P, AP, W)
        if k == 0:
            bs = rs
        hist[k] = rs
        k += 1
    return CGResult(x=x.to(b.dtype), iters=k * s, rel_residual=_rel(rs, bs),
                    history=hist)


# ---------------------------------------------------------------------------
# dispatcher
# ---------------------------------------------------------------------------

_SOLVER_FNS = {"cg": cg_solve, "pipelined": pipelined_cg_solve,
               "sstep": sstep_cg_solve}


def _check_even_extents(op, b: torch.Tensor, comm, reference: bool) -> None:
    """Even-odd needs an even *global* extent along every stencil dim."""
    sizes = {}
    if comm is not None and not reference:
        sizes = comm.mesh.sizes()
    for spec in op.specs:
        n = int(b.shape[spec.dim]) * int(sizes.get(spec.axis, 1))
        if n % 2:
            raise ValueError(
                f"even-odd preconditioning needs an even global extent in "
                f"every stencil direction; dim {spec.dim} (axis "
                f"{spec.axis!r}) has global extent {n}")


def solve(op, b: torch.Tensor, comm=None, *, solver: str = "cg",
          precond: str = "none", s: int = 4, x0: torch.Tensor | None = None,
          tol: float | None = 1e-6, maxiter: int = 100,
          schedule: str = "concurrent", chunks: int = 4, channels: int = 0,
          replace_every: int = 6, reference: bool = False) -> CGResult:
    """Solve ``op x = b`` with any ``solver`` × ``precond`` combination.

    ``reference=True`` solves on a *global* lattice in one process via
    ``op.apply_reference`` (parity from array coordinates).  Otherwise
    ``b`` is this rank's shard and ``comm`` its communicator (``None``:
    one process, every axis wrapping onto it).

    With ``precond="eo"`` the solver runs on the even-odd Schur complement;
    ``iters``/``rel_residual``/``history`` then describe the Schur solve,
    while ``x`` is the reconstructed full-lattice solution."""
    if solver not in _SOLVER_FNS:
        raise ValueError(f"unknown solver {solver!r}; one of {SOLVERS}")
    if precond not in PRECONDS:
        raise ValueError(f"unknown precond {precond!r}; one of {PRECONDS}")
    kw = dict(x0=x0, tol=tol, maxiter=maxiter, schedule=schedule,
              chunks=chunks, channels=channels)
    fn = _SOLVER_FNS[solver]
    if solver == "sstep":
        kw["s"] = s
    elif solver == "pipelined":
        kw["replace_every"] = replace_every

    if precond == "none":
        matvec = op.apply_reference if reference else None
        return fn(op, b, comm, matvec=matvec, **kw)

    if x0 is not None:
        raise ValueError("precond='eo' does not support x0 (the Schur "
                         "right-hand side would need projecting around it)")
    _check_even_extents(op, b, comm, reference)
    distributed = (comm is not None and bool(comm.axes)) and not reference
    eo = EvenOddOp(op, distributed=distributed)
    apply_kw = dict(schedule=schedule, chunks=chunks, channels=channels)
    if reference:
        rhs = eo.project_rhs_reference(b)
        res = fn(eo, rhs, comm, matvec=eo.apply_reference, **kw)
        x = eo.reconstruct_reference(res.x, b)
    else:
        rhs = eo.project_rhs(b, comm, **apply_kw)
        res = fn(eo, rhs, comm, **kw)
        x = eo.reconstruct(res.x, b, comm, **apply_kw)
    return res._replace(x=x.to(b.dtype))
