"""CommSchedule: dependency-aware issue order for streamed bucket reduction.

Port of the gradient-reduction half of ``repro.comm.schedule`` (plain
Python; a schedule here equals the reference's slot for slot).  A
:class:`CommSchedule` is an ordered list of :class:`IssueSlot`\\ s, each
saying which buckets go out on which virtual channel after which phase of
the step's compute, derived from backward-pass readiness order (the last
layer's gradients are ready first).  Policies (``SCHEDULE_POLICIES``):

* ``accumulate_then_reduce`` — every bucket issues after all microbatches;
* ``stream`` — each microbatch's buckets issue after its backward;
* ``scheduled`` — like ``stream``, in readiness order within a phase.

``overlap_fraction = sum_slots (w_slot / W) * (1 - ready_slot)`` is the
share of collective traffic that could hide under remaining compute.
:func:`build_halo_schedule` gives one Cartesian halo exchange's issue slots
(``HALO_SCHEDULES``, executed by :func:`repro_torch.core.halo.halo_exchange`)
as a schedule of the same kind, and :func:`build_moe_schedule` one
expert-parallel dispatch and combine.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

from repro_torch.comm.plan import assign_channels

SCHEDULE_POLICIES = ("accumulate_then_reduce", "stream", "scheduled")

# halo-exchange issue orders (the paper's Seq / Concurrent / Threaded columns
# plus the interior-compute overlap schedule)
HALO_SCHEDULES = ("sequential", "concurrent", "chunked", "overlap")


@dataclass(frozen=True)
class IssueSlot:
    """One issue of one bucket's collective on one virtual channel."""

    phase: int
    bucket_ids: tuple[int, ...]
    channel: int
    ready: float

    @property
    def exposed(self) -> float:
        """Fraction of step compute with nothing left to hide this slot."""
        return max(0.0, min(1.0, self.ready))


@dataclass(frozen=True)
class CommSchedule:
    """Explicit issue order for one gradient reduction.

    ``channels == 0``: every bucket is its own independent collective;
    ``channels >= 1``: exactly that many rails, each issuing its slots in
    FIFO order (in the port, program order on the rail's process group).
    """

    policy: str
    microbatches: int
    bucket_sizes: tuple[int, ...]
    channels: int                      # the config knob (0 = unconstrained)
    slots: tuple[IssueSlot, ...]

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def n_channels(self) -> int:
        return len({s.channel for s in self.slots}) if self.slots else 0

    @property
    def n_collectives(self) -> int:
        return sum(len(s.bucket_ids) for s in self.slots)

    def slots_for_phase(self, phase: int) -> tuple[IssueSlot, ...]:
        """This phase's slots, in issue order."""
        return tuple(s for s in self.slots if s.phase == phase)

    @property
    def total_weight(self) -> float:
        return float(sum(sum(self.bucket_sizes[b] for b in s.bucket_ids)
                         for s in self.slots))

    @property
    def overlap_fraction(self) -> float:
        w_total = self.total_weight
        if w_total <= 0.0:
            return 0.0
        acc = 0.0
        for s in self.slots:
            w = sum(self.bucket_sizes[b] for b in s.bucket_ids)
            acc += w * (1.0 - s.exposed)
        return acc / w_total

    def describe(self, max_slots: int = 128) -> dict:
        """JSON-friendly summary; slot-by-slot detail is elided past
        ``max_slots``."""
        out = {
            "policy": self.policy,
            "microbatches": self.microbatches,
            "n_buckets": self.n_buckets,
            "channels": self.channels,
            "n_collectives": self.n_collectives,
            "overlap_fraction": self.overlap_fraction,
        }
        if len(self.slots) <= max_slots:
            out["slots"] = [{"phase": s.phase, "buckets": list(s.bucket_ids),
                             "channel": s.channel, "ready": round(s.ready, 6)}
                            for s in self.slots]
        else:
            out["slots_elided"] = len(self.slots)
        return out

    def validate(self) -> None:
        """Structural invariants every executor relies on."""
        expected_phases = (range(self.microbatches)
                           if self.policy != "accumulate_then_reduce"
                           else (self.microbatches - 1,))
        for phase in expected_phases:
            seen = sorted(b for s in self.slots_for_phase(phase)
                          for b in s.bucket_ids)
            if seen != list(range(self.n_buckets)):
                raise ValueError(
                    f"schedule {self.policy!r} phase {phase}: buckets {seen} "
                    f"!= 0..{self.n_buckets - 1}")
        by_channel: dict[int, float] = {}
        for s in self.slots:
            prev = by_channel.get(s.channel, -1.0)
            if s.ready < prev - 1e-9:
                raise ValueError(
                    f"channel {s.channel} readiness not monotone: "
                    f"{s.ready} after {prev}")
            by_channel[s.channel] = s.ready


def _bucket_channels(bucket_sizes: Sequence[int], channels: int) -> list[int]:
    """bucket index -> channel id under the communicator's striping rule
    (``channels == 0``: one private channel per bucket)."""
    n = channels if channels >= 1 else max(len(bucket_sizes), 1)
    chan_of = [0] * len(bucket_sizes)
    for a in assign_channels(bucket_sizes, n):
        for b in a.buckets:
            chan_of[b] = a.channel
    return chan_of


def build_schedule(policy: str, bucket_sizes: Sequence[int],
                   microbatches: int = 1, channels: int = 0) -> CommSchedule:
    """The issue slots for ``policy`` over the bucket layout (the
    reference's readiness model: compute divides evenly across
    microbatches; within one, bucket ``B-1`` is ready first)."""
    if policy not in SCHEDULE_POLICIES:
        raise ValueError(f"unknown schedule policy {policy!r}; one of "
                         f"{SCHEDULE_POLICIES}")
    m = max(int(microbatches), 1)
    sizes = tuple(int(s) for s in bucket_sizes)
    n = len(sizes)
    chan_of = _bucket_channels(sizes, channels)
    slots: list[IssueSlot] = []
    if policy == "accumulate_then_reduce":
        for b in range(n):
            slots.append(IssueSlot(phase=m - 1, bucket_ids=(b,),
                                   channel=chan_of[b], ready=1.0))
    elif policy == "stream":
        for i in range(m):
            ready = (i + 1) / m
            for b in range(n):
                slots.append(IssueSlot(phase=i, bucket_ids=(b,),
                                       channel=chan_of[b], ready=ready))
    else:
        total = float(sum(sizes)) or 1.0
        for i in range(m):
            done = 0.0
            for b in reversed(range(n)):
                done += sizes[b]
                ready = (i + done / total) / m
                slots.append(IssueSlot(phase=i, bucket_ids=(b,),
                                       channel=chan_of[b], ready=ready))
    sched = CommSchedule(policy=policy, microbatches=m, bucket_sizes=sizes,
                         channels=int(channels), slots=tuple(slots))
    sched.validate()
    return sched


def halo_interior_fraction(local_shape: Sequence[int], specs) -> float:
    """Share of local lattice sites computable before any halo arrives: the
    interior block, ``halo`` sites away from every exchanged face (what
    :class:`repro_torch.stencil.op.StencilOp` computes while faces fly)."""
    frac = 1.0
    for s in specs:
        n = int(local_shape[s.dim])
        frac *= max(n - 2 * s.halo, 0) / max(n, 1)
    return frac


def halo_units(specs, local_shape: Sequence[int], *, schedule: str,
               chunks: int = 1, itemsize: int = 4,
               axis_sizes: dict | None = None
               ) -> tuple[tuple[str, ...], tuple[int, ...]]:
    """One exchange's payloads, ``(keys, bytes)``, one entry per unit in
    issue order: per spec the ``'-'`` then ``'+'`` direction, each split
    into its chunk pieces under ``chunked`` (``"x-#2"``-style keys).
    ``axis_sizes`` (mesh axis -> size), when known, suppresses the chunk
    split on size-1 axes as the executor does."""
    from repro_torch.core.halo import chunk_sizes, face_split_dim

    keys: list[str] = []
    unit_bytes: list[int] = []
    for s in specs:
        face_shape = [int(n) for n in local_shape]
        face_shape[s.dim] = s.halo
        elems = math.prod(face_shape)
        p = axis_sizes.get(s.axis, 2) if axis_sizes is not None else 2
        if schedule == "chunked" and chunks > 1 and p > 1:
            split_dim = face_split_dim(tuple(face_shape), s.dim)
            row = elems // max(face_shape[split_dim], 1)
            pieces = [row * c for c in
                      chunk_sizes(face_shape[split_dim], chunks)]
        else:
            pieces = [elems]
        for d in ("-", "+"):                  # both directions, spec order
            keys.extend(f"{s.axis}{d}" + (f"#{c}" if len(pieces) > 1 else "")
                        for c in range(len(pieces)))
            unit_bytes.extend(p * itemsize for p in pieces)
    return tuple(keys), tuple(unit_bytes)


def build_halo_schedule(specs, local_shape: Sequence[int], *,
                        schedule: str, channels: int = 0, chunks: int = 1,
                        itemsize: int = 4,
                        axis_sizes: dict | None = None) -> CommSchedule:
    """Issue slots for one Cartesian halo exchange.  Units are the
    exchange's payloads (:func:`halo_units`), ``bucket_sizes`` their bytes.

    * ``sequential`` — every unit on rail 0, one FIFO chain;
    * ``concurrent`` / ``chunked`` — every unit its own rail;
    * ``overlap`` — units striped over ``channels`` rails (``0`` =
      unconstrained), issued at ``ready = 1 - interior_fraction``: only the
      interior compute can hide a face in flight.
    """
    if schedule not in HALO_SCHEDULES:
        raise ValueError(f"unknown halo schedule {schedule!r}; one of "
                         f"{HALO_SCHEDULES}")
    _, unit_bytes = halo_units(specs, local_shape, schedule=schedule,
                               chunks=chunks, itemsize=itemsize,
                               axis_sizes=axis_sizes)
    n_units = len(unit_bytes)
    ready = 1.0
    if schedule == "overlap":
        ready = 1.0 - halo_interior_fraction(local_shape, specs)
    if schedule == "sequential":
        chan_of = [0] * n_units
        knob = 1
    elif schedule == "overlap" and channels >= 1:
        chan_of = [0] * n_units
        for a in assign_channels(unit_bytes, channels):
            for u in a.buckets:
                chan_of[u] = a.channel
        knob = channels
    else:                                     # concurrent/chunked/overlap@0
        chan_of = list(range(n_units))
        knob = 0
    slots = tuple(IssueSlot(phase=0, bucket_ids=(u,), channel=chan_of[u],
                            ready=ready) for u in range(n_units))
    sched = CommSchedule(policy=schedule, microbatches=1,
                         bucket_sizes=tuple(unit_bytes), channels=knob,
                         slots=slots)
    sched.validate()
    return sched


def build_moe_schedule(phase_bytes: float, rails: int = 1) -> CommSchedule:
    """Issue slots for one EP dispatch + combine all-to-all round-trip.

    The units are per-rail all-to-all payloads: ``rails`` dispatch units
    (the capacity buffer striped along its feature dimension) followed by
    ``rails`` combine units of the same size.  Rail ``c`` carries dispatch
    unit ``c`` and combine unit ``rails + c`` in FIFO order; the staggered
    readiness models the rail pipeline (rail ``c``'s dispatch flies while
    rail ``c - 1``'s expert GEMM runs, each combine overlaps the remaining
    expert compute), so :attr:`CommSchedule.overlap_fraction` prices how
    much of the exchange the GEMMs can hide.
    """
    rails = max(int(rails), 1)
    n = 2 * rails
    per = int(round(phase_bytes / rails))
    slots = []
    for c in range(rails):                     # dispatch rails, issued early
        slots.append(IssueSlot(phase=0, bucket_ids=(c,), channel=c,
                               ready=c / n))
    for c in range(rails):                     # combine rails, after GEMM c
        slots.append(IssueSlot(phase=0, bucket_ids=(rails + c,), channel=c,
                               ready=(rails + c) / n))
    sched = CommSchedule(policy="moe", microbatches=1,
                         bucket_sizes=tuple(per for _ in range(n)),
                         channels=rails, slots=tuple(slots))
    sched.validate()
    return sched
