"""ArenaLayout: page-quantized placement of buffers in one flat arena.

Port of ``repro.mem.layout`` (the quantized-wire and halo layouts arrive
with their slices): every buffer becomes an :class:`ArenaSegment` whose
element offset and padded size are quantized to ``page_bytes`` (default the
2 MiB huge page), and segments sharing a virtual channel fuse into one
contiguous :class:`ArenaSpan`, which moves as one collective.  Its users are
the serving KV arena (:mod:`repro_torch.serve.kv`) and the gradient arena
(:func:`arena_from_bucket_plan`, :class:`repro_torch.mem.arena.CommArena`);
:func:`fuse_schedule` turns a bucket schedule into the span schedule the
arena executes.  An oversized bucket (one leaf larger than the bucketer's
target) gets its own segment like any other, with a warning once per
process.

The arithmetic is plain Python, so a plan here equals the reference's field
for field; only the dtype is a ``torch.dtype``.
"""

from __future__ import annotations

import math
import warnings
from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.comm.schedule import CommSchedule, IssueSlot
from repro_torch.core.bucketing import BucketPlan
from repro_torch.core.topology import padded_size

PAGE_BYTES = 2 * 2**20     # the paper's huge-page size

_warned_oversized = False  # the oversized-bucket warning fires once


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"`` (numpy/JAX spelling)."""
    return str(dtype).removeprefix("torch.")


@dataclass(frozen=True)
class ArenaSegment:
    """One source buffer's page-quantized slot inside the arena."""

    bucket: int        # source bucket / unit id
    channel: int       # virtual channel carrying this segment
    offset: int        # element offset into the arena (quantum-aligned)
    size: int          # used elements (the source buffer's length)
    padded: int        # quantum-aligned element count (>= size)

    @property
    def padding(self) -> int:
        return self.padded - self.size

    @property
    def waste(self) -> float:
        """This segment's fragmentation: padding share of its footprint."""
        return self.padding / self.padded if self.padded else 0.0


@dataclass(frozen=True)
class ArenaSpan:
    """A contiguous run of same-channel segments — one fused collective."""

    channel: int
    buckets: tuple[int, ...]   # member bucket ids, in arena order
    offset: int                # element offset of the first segment
    size: int                  # padded elements covered (incl. padding)


@dataclass(frozen=True)
class ArenaLayout:
    """Placement of a set of buffers in one flat arena."""

    dtype: torch.dtype         # element type of the arena
    page_bytes: int            # requested page size (allocation granule)
    quantum: int               # element quantization unit (see plan_arena)
    segments: tuple[ArenaSegment, ...]   # in arena (offset) order
    spans: tuple[ArenaSpan, ...]

    # -- shape ---------------------------------------------------------------

    @property
    def n_segments(self) -> int:
        return len(self.segments)

    @property
    def n_spans(self) -> int:
        return len(self.spans)

    @property
    def total_elems(self) -> int:
        last = self.segments[-1] if self.segments else None
        return last.offset + last.padded if last else 0

    @property
    def total_bytes(self) -> int:
        return self.total_elems * self.dtype.itemsize

    @property
    def n_pages(self) -> int:
        """Whole pages the arena allocates (total is page-quantized)."""
        return -(-self.total_bytes // self.page_bytes)

    # -- padding accounting --------------------------------------------------

    @property
    def used_elems(self) -> int:
        return sum(s.size for s in self.segments)

    @property
    def padding_elems(self) -> int:
        return self.total_elems - self.used_elems

    @property
    def padding_fraction(self) -> float:
        t = self.total_elems
        return self.padding_elems / t if t else 0.0

    def segment_of(self, bucket: int) -> ArenaSegment:
        for s in self.segments:
            if s.bucket == bucket:
                return s
        raise KeyError(bucket)

    def validate(self) -> None:
        """Structural invariants the executors rely on."""
        end = 0
        by_bucket = {}
        for s in self.segments:
            if s.offset % self.quantum or s.padded % self.quantum:
                raise ValueError(f"segment {s.bucket}: offset/padded not "
                                 f"quantized to {self.quantum} elems")
            if s.offset < end:
                raise ValueError(f"segment {s.bucket} overlaps its "
                                 f"predecessor ({s.offset} < {end})")
            if s.size > s.padded:
                raise ValueError(f"segment {s.bucket}: size {s.size} > "
                                 f"padded {s.padded}")
            end = s.offset + s.padded
            by_bucket[s.bucket] = s
        for sp in self.spans:
            segs = [by_bucket[b] for b in sp.buckets]
            if not segs:
                raise ValueError("empty span")
            if sp.offset != segs[0].offset:
                raise ValueError(f"span@{sp.offset}: first segment at "
                                 f"{segs[0].offset}")
            if sp.size != sum(s.padded for s in segs):
                raise ValueError(f"span@{sp.offset}: size {sp.size} != "
                                 f"member total")
            run = sp.offset
            for s in segs:
                if s.offset != run or s.channel != sp.channel:
                    raise ValueError(f"span@{sp.offset}: segment "
                                     f"{s.bucket} not contiguous on "
                                     f"channel {sp.channel}")
                run += s.padded

    def describe(self) -> dict:
        """JSON-friendly summary (the reference's keys)."""
        return {
            "page_bytes": self.page_bytes,
            "quantum_elems": self.quantum,
            "dtype": dtype_name(self.dtype),
            "n_segments": self.n_segments,
            "n_spans": self.n_spans,
            "total_elems": self.total_elems,
            "total_bytes": self.total_bytes,
            "n_pages": self.n_pages,
            "padding_elems": self.padding_elems,
            "padding_fraction": self.padding_fraction,
            "segments": [{"bucket": s.bucket, "channel": s.channel,
                          "offset": s.offset, "size": s.size,
                          "padded": s.padded, "waste": s.waste}
                         for s in self.segments],
            "spans": [{"channel": sp.channel, "buckets": list(sp.buckets),
                       "offset": sp.offset, "size": sp.size}
                      for sp in self.spans],
        }


def plan_arena(sizes: Sequence[int], *, page_bytes: int = PAGE_BYTES,
               dtype: torch.dtype = torch.float32,
               channel_of: Sequence[int] | None = None,
               pad_multiple: int = 1, bucket_bytes: int | None = None,
               warn_oversized: bool = True) -> ArenaLayout:
    """Pack flat buffers of ``sizes`` elements into one page-quantized arena.

    ``channel_of[i]`` is the virtual channel carrying buffer ``i`` (default:
    every buffer its own channel).  Buffers are laid out grouped by channel
    (ascending, original order within a channel), so each channel's
    segments form one contiguous :class:`ArenaSpan`.  The quantization unit
    is ``lcm(page_bytes / itemsize, pad_multiple)``.
    """
    if page_bytes <= 0 or page_bytes % dtype.itemsize:
        raise ValueError(f"page_bytes must be a positive multiple of the "
                         f"itemsize ({dtype.itemsize}), got {page_bytes}")
    if pad_multiple <= 0:
        raise ValueError(f"pad_multiple must be positive, got {pad_multiple}")
    sizes = [int(n) for n in sizes]
    if channel_of is None:
        channel_of = list(range(len(sizes)))
    if len(channel_of) != len(sizes):
        raise ValueError(f"channel_of has {len(channel_of)} entries for "
                         f"{len(sizes)} buffers")
    quantum = math.lcm(page_bytes // dtype.itemsize, int(pad_multiple))

    if bucket_bytes is not None and warn_oversized:
        oversized = [i for i, n in enumerate(sizes)
                     if n * dtype.itemsize > bucket_bytes]
        global _warned_oversized
        if oversized and not _warned_oversized:
            _warned_oversized = True
            warnings.warn(
                f"{len(oversized)} bucket(s) exceed the {bucket_bytes}-byte "
                f"target (oversized tree leaves are never split); each gets "
                f"a dedicated page-aligned arena segment (ids "
                f"{oversized[:8]}{'...' if len(oversized) > 8 else ''})",
                RuntimeWarning, stacklevel=2)

    # channel-grouped order: each channel's buffers land contiguously
    order = sorted(range(len(sizes)), key=lambda i: (channel_of[i], i))
    segments: list[ArenaSegment] = []
    runs: list[tuple[int, int, list[int]]] = []   # (channel, offset, members)
    offset = 0
    for i in order:
        padded = padded_size(max(sizes[i], 1), quantum)
        seg = ArenaSegment(bucket=i, channel=int(channel_of[i]),
                           offset=offset, size=sizes[i], padded=padded)
        segments.append(seg)
        if runs and runs[-1][0] == seg.channel:
            runs[-1][2].append(i)
        else:
            runs.append((seg.channel, offset, [i]))
        offset += padded
    ends = [r[1] for r in runs[1:]] + [offset]
    spans = [ArenaSpan(channel=ch, buckets=tuple(members), offset=off,
                       size=end - off)
             for (ch, off, members), end in zip(runs, ends)]

    layout = ArenaLayout(dtype=dtype, page_bytes=int(page_bytes),
                         quantum=quantum, segments=tuple(segments),
                         spans=tuple(spans))
    layout.validate()
    return layout


def arena_from_bucket_plan(plan: BucketPlan, *,
                           page_bytes: int = PAGE_BYTES,
                           channel_of: Sequence[int] | None = None,
                           pad_multiple: int = 1,
                           bucket_bytes: int | None = None,
                           warn_oversized: bool = True) -> ArenaLayout:
    """Arena layout of a bucket plan: one segment per bucket, in the plan's
    dtype."""
    return plan_arena(plan.bucket_sizes, page_bytes=page_bytes,
                      dtype=plan.bucket_dtype, channel_of=channel_of,
                      pad_multiple=max(pad_multiple, plan.pad_multiple),
                      bucket_bytes=bucket_bytes,
                      warn_oversized=warn_oversized)


def fuse_schedule(schedule: CommSchedule, layout: ArenaLayout
                  ) -> CommSchedule:
    """The span-level schedule an arena executor runs: per phase, each
    :class:`ArenaSpan` issues one collective over its members' contiguous
    segments (padding included).  Slot ``bucket_ids`` index
    :attr:`ArenaLayout.spans`; a span is ready when its last member is."""
    if layout.n_segments != schedule.n_buckets:
        raise ValueError(
            f"layout has {layout.n_segments} segments but the schedule has "
            f"{schedule.n_buckets} buckets; build both from the same plan")
    phases = sorted({s.phase for s in schedule.slots})
    span_sizes = tuple(sp.size for sp in layout.spans)
    slots: list[IssueSlot] = []
    for phase in phases:
        ready_of: dict[int, float] = {}
        for s in schedule.slots_for_phase(phase):
            for b in s.bucket_ids:
                ready_of[b] = max(ready_of.get(b, 0.0), s.ready)
        phase_slots = [IssueSlot(phase=phase, bucket_ids=(idx,),
                                 channel=sp.channel,
                                 ready=max(ready_of[b] for b in sp.buckets))
                       for idx, sp in enumerate(layout.spans)]
        slots.extend(sorted(phase_slots, key=lambda s: (s.ready, s.channel)))
    fused = CommSchedule(policy=schedule.policy,
                         microbatches=schedule.microbatches,
                         bucket_sizes=span_sizes,
                         channels=schedule.channels, slots=tuple(slots))
    fused.validate()
    return fused
