"""Cartesian halo exchange over mesh axes (the paper's QCD workload).

Port of ``repro.core.halo``.  Every rank sends its faces to the +/-
neighbours along each Cartesian direction; four schedules reproduce the
paper's experimental columns:

* ``sequential``  — one face at a time, each waited for before the next is
  issued (the 'Seq' columns; the reference threads an order token through
  the chain);
* ``concurrent``  — every face of every direction in one batch (the
  'Concurrent' columns);
* ``chunked``     — each face further split into ``chunks`` pieces along
  :func:`face_split_dim` (uneven where it does not divide,
  :func:`chunk_sizes`), every piece its own message (the 'Threaded'
  multi-EP columns); no split on an axis of one rank;
* ``overlap``     — whole faces striped over ``channels`` rails
  (:func:`repro_torch.comm.plan.assign_channels`), each rail's faces FIFO
  on that rail's own process groups, their staging copies on the rail's
  own CUDA stream when it has one; ``channels == 0`` leaves them all
  unconstrained on the first rail.  :class:`repro_torch.stencil.op.StencilOp`
  computes its interior while they are in flight.

Where the reference reaches ``ppermute`` through the ambient ``shard_map``,
:func:`halo_exchange` takes the rings it runs on: ``rings[c][axis]`` is
rail ``c``'s :class:`~repro_torch.core.p2p.RingAxis` along mesh axis
``axis`` (:meth:`repro_torch.comm.Communicator.halo_rings`), or ``None``
for one process, where every axis wraps onto this rank.  The preferred
entry point is :meth:`repro_torch.comm.Communicator.halo_exchange`.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Mapping, Sequence

import torch

from repro_torch.core.p2p import RingAxis, Shift

SCHEDULES = ("sequential", "concurrent", "chunked", "overlap")

Rings = Sequence[Mapping[str, RingAxis]]


@dataclass(frozen=True)
class HaloSpec:
    """One exchanged direction: array dim ``dim`` over mesh axis ``axis``."""

    axis: str           # mesh axis name
    dim: int            # array dimension sharded over that axis
    halo: int = 1       # face width


def _face(x: torch.Tensor, dim: int, lo: bool, width: int) -> torch.Tensor:
    n = x.shape[dim]
    return x.narrow(dim, 0 if lo else n - width, width)


def face_split_dim(shape: Sequence[int], dim: int) -> int:
    """The dim a face is chunked along: largest non-halo dim, so pieces stay
    contiguous (``dim`` itself only when the face is 1-D)."""
    return max((d for d in range(len(shape)) if d != dim),
               key=lambda d: shape[d], default=dim)


def chunk_sizes(n: int, chunks: int) -> list[int]:
    """Piece lengths splitting ``n`` into ``min(chunks, n)`` near-equal
    parts: the first ``n % k`` pieces are one longer.  Shared by the
    executor (:func:`_split_chunks`) and the prediction layer
    (:func:`repro_torch.comm.schedule.build_halo_schedule`)."""
    k = max(1, min(int(chunks), int(n)))
    base, extra = divmod(int(n), k)
    return [base + 1] * extra + [base] * (k - extra)


def _split_chunks(face: torch.Tensor, chunks: int,
                  dim: int) -> list[torch.Tensor]:
    if chunks <= 1:
        return [face]
    split_dim = face_split_dim(face.shape, dim)
    return list(torch.split(face, chunk_sizes(face.shape[split_dim], chunks),
                            dim=split_dim))


def _axis_size(rings: Rings | None, axis: str) -> int:
    if rings is None:
        return 1
    try:
        return rings[0][axis].size
    except KeyError:
        raise ValueError(f"no ring for mesh axis {axis!r}; the rings cover "
                         f"{tuple(rings[0])}") from None


class PendingHalos:
    """A :func:`halo_exchange` in flight; :meth:`wait` returns the halo
    dict."""

    def __init__(self, shifts: list, units: list, specs, x_shape):
        self._shifts = shifts      # (Shift, [unit index per payload])
        self._units = units        # (key, n pieces)
        self._specs = specs
        self._x_shape = x_shape
        self._out: dict | None = None

    def wait(self) -> dict:
        if self._out is not None:
            return self._out
        pieces: dict[int, list] = {}
        for shift, owners in self._shifts:
            for (u, c), t in zip(owners, shift.wait()):
                pieces.setdefault(u, {})[c] = t
        out = {}
        for u, (key, n) in enumerate(self._units):
            parts = [pieces[u][c] for c in range(n)]
            out[key] = (parts[0] if n == 1
                        else _reassemble(parts, key, self._specs,
                                         self._x_shape))
        self._out = out
        return out


def halo_exchange(x: torch.Tensor, specs: Sequence[HaloSpec],
                  rings: Rings | None, *, schedule: str = "concurrent",
                  chunks: int = 4, channels: int = 0,
                  streams: Sequence | None = None,
                  wait: bool = True) -> "dict | PendingHalos":
    """Exchange faces along every spec'd direction.

    Returns ``{(axis, '+'): received_hi_face, (axis, '-'): received_lo_face}``
    — the halos a stencil pads with.  '+' is the face received *from* the
    +1 neighbour (its low face), this rank's high halo.  ``wait=False``
    returns a :class:`PendingHalos` whose ``wait()`` gives the dict once the
    faces land (``sequential`` has finished by then already: each of its
    faces is waited for before the next goes out).

    ``channels`` only matters to ``overlap``: ``>= 1`` stripes the faces
    over that many rails, ``rings[c]`` for rail ``c``; ``0`` sends them all
    on ``rings[0]`` with no order among them.  ``streams[c]`` (rail ``c``'s
    CUDA stream, or ``None``) carries the staging copies of rail ``c``'s
    faces under ``overlap``.
    """
    if schedule not in SCHEDULES:
        raise ValueError(f"schedule must be one of {SCHEDULES}")

    sends = []  # (key, payloads, axis, direction)
    for s in specs:
        p = _axis_size(rings, s.axis)
        n_chunks = chunks if (schedule == "chunked" and p > 1) else 1
        hi = _face(x, s.dim, lo=False, width=s.halo)   # to +1; its lo halo
        lo = _face(x, s.dim, lo=True, width=s.halo)    # to -1; its hi halo
        sends.append(((s.axis, "-"), _split_chunks(hi, n_chunks, s.dim),
                      s.axis, +1))
        sends.append(((s.axis, "+"), _split_chunks(lo, n_chunks, s.dim),
                      s.axis, -1))

    rail_of = [0] * len(sends)
    if schedule == "overlap" and channels >= 1:
        # core<->comm layering: the striping rule lives with the channel
        # machinery
        from repro_torch.comm.plan import assign_channels

        sizes = [sum(math.prod(c.shape) for c in payloads)
                 for _, payloads, _, _ in sends]
        for a in assign_channels(sizes, channels):
            for u in a.buckets:
                rail_of[u] = a.channel
        if rings is not None and channels > len(rings):
            raise ValueError(f"{channels} halo channels but the rings hold "
                             f"{len(rings)} rails")

    units = [(key, len(payloads)) for key, payloads, _, _ in sends]
    # every payload's tag is its place in the exchange: the same on every
    # rank, so the two faces between the ranks of an axis of two never cross
    flat, tag = [], 0
    for u, (key, payloads, axis, direction) in enumerate(sends):
        for c, t in enumerate(payloads):
            flat.append((u, c, t, axis, direction, rail_of[u], tag))
            tag += 1

    def start(batch) -> list:
        """One ``start_shift`` per ring the batch touches, in first-use
        order (the same on every rank)."""
        by_ring: dict = {}
        for u, c, t, axis, direction, rail, tg in batch:
            key = (rail, axis)
            by_ring.setdefault(key, []).append((u, c, t, direction, tg))
        out = []
        for (rail, axis), items in by_ring.items():
            payloads = [t for _, _, t, _, _ in items]
            if rings is None:          # one process: every face wraps back
                shift = Shift(None, payloads, [], False, None)
            else:
                shift = rings[rail][axis].start_shift(
                    payloads, [d for _, _, _, d, _ in items],
                    [tg for *_, tg in items],
                    stream=(streams[rail] if schedule == "overlap"
                            and streams else None))
            out.append((shift, [(u, c) for u, c, *_ in items]))
        return out

    if schedule == "sequential":
        shifts = []
        for item in flat:          # one face at a time, each waited for
            for shift, owners in start([item]):
                shift.wait()
                shifts.append((shift, owners))
    else:
        shifts = start(flat)
    pending = PendingHalos(shifts, units, specs, tuple(x.shape))
    return pending.wait() if wait else pending


def _reassemble(parts: list[torch.Tensor], key, specs,
                x_shape) -> torch.Tensor:
    spec = next(s for s in specs if s.axis == key[0])
    face_shape = list(x_shape)
    face_shape[spec.dim] = spec.halo
    return torch.cat(parts, dim=face_split_dim(face_shape, spec.dim))


def pad_with_halos(x: torch.Tensor, halos: dict,
                   spec: HaloSpec) -> torch.Tensor:
    """Concatenate received halos onto ``x`` along ``spec.dim``."""
    lo = halos[(spec.axis, "-")]
    hi = halos[(spec.axis, "+")]
    return torch.cat([lo, x, hi], dim=spec.dim)


def halo_bytes(x_shape: Sequence[int], specs: Sequence[HaloSpec],
               itemsize: int) -> int:
    """Bidirectional bytes injected per device per exchange (analysis)."""
    total = 0
    for s in specs:
        face = 1
        for d, n in enumerate(x_shape):
            face *= s.halo if d == s.dim else n
        total += 2 * face * itemsize
    return total
