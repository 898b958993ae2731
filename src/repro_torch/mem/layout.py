"""ArenaLayout: page-quantized placement of buffers in one flat arena.

Port of ``repro.mem.layout``:
every buffer becomes an :class:`ArenaSegment` whose element offset and
padded size are quantized to ``page_bytes`` (default the 2 MiB huge page),
and segments sharing a virtual channel fuse into one contiguous
:class:`ArenaSpan`, which moves as one collective.  Its users are the
serving KV arena (:mod:`repro_torch.serve.kv`), the gradient arena
(:func:`arena_from_bucket_plan`, :class:`repro_torch.mem.arena.CommArena`)
the int8 wire's arena (:func:`quant_arena_from_bucket_plan`, an int8
payload laid out like the fp32 arena plus a trailing segment of fp32
scales, :class:`repro_torch.mem.arena.QuantCommArena`) and the layout of a
halo exchange's faces (:func:`arena_from_halo_plan`, a layout only: the
exchange sends its faces as they are);
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


SCALE_BYTES = 4  # one fp32 scale per codec block, stored as arena bytes


@dataclass(frozen=True)
class QuantArenaLayout:
    """Placement of a wire-codec arena: the int8 quantized payload laid out
    exactly like an fp32 :class:`ArenaLayout` (one element is one byte),
    plus one trailing page-quantized **scale segment** holding the fp32
    scale of every codec block.  One flat int8 tensor carries payload and
    scales; segments and spans delegate to the payload layout.

    Payload offsets and padded sizes are ``block`` multiples (the plan folds
    the codec block into the pad multiple), so a segment's first scale is
    at ``offset // block`` (segments never share a scale block) and padding
    occupies whole quant blocks, read by nobody.
    """

    payload: ArenaLayout       # int8 payload placement
    block: int                 # codec block: payload elements per scale

    # -- payload delegation (element counts == byte counts for int8) ---------

    @property
    def dtype(self) -> torch.dtype:
        return self.payload.dtype

    @property
    def page_bytes(self) -> int:
        return self.payload.page_bytes

    @property
    def quantum(self) -> int:
        return self.payload.quantum

    @property
    def segments(self) -> tuple[ArenaSegment, ...]:
        return self.payload.segments

    @property
    def spans(self) -> tuple[ArenaSpan, ...]:
        return self.payload.spans

    @property
    def n_segments(self) -> int:
        return self.payload.n_segments

    @property
    def n_spans(self) -> int:
        return self.payload.n_spans

    @property
    def used_elems(self) -> int:
        return self.payload.used_elems

    @property
    def padding_elems(self) -> int:
        return self.payload.padding_elems

    @property
    def padding_fraction(self) -> float:
        return self.payload.padding_fraction

    def segment_of(self, bucket: int) -> ArenaSegment:
        return self.payload.segment_of(bucket)

    # -- the trailing scale segment ------------------------------------------

    @property
    def payload_elems(self) -> int:
        return self.payload.total_elems

    @property
    def n_scales(self) -> int:
        return self.payload.total_elems // self.block

    @property
    def scale_offset(self) -> int:
        """Byte offset of the scale segment (page-aligned, since the payload
        total is quantum-aligned)."""
        return self.payload.total_elems

    @property
    def scale_region_bytes(self) -> int:
        return padded_size(max(self.n_scales * SCALE_BYTES, 1),
                           self.page_bytes)

    @property
    def total_elems(self) -> int:
        return self.scale_offset + self.scale_region_bytes

    @property
    def total_bytes(self) -> int:
        return self.total_elems  # int8

    @property
    def n_pages(self) -> int:
        return -(-self.total_bytes // self.page_bytes)

    def scale_byte_range(self, offset: int, size: int) -> tuple[int, int]:
        """Arena byte range of the scales covering payload
        ``[offset : offset + size]``."""
        lo = self.scale_offset + (offset // self.block) * SCALE_BYTES
        return lo, lo + (size // self.block) * SCALE_BYTES

    # -- wire accounting -----------------------------------------------------

    @property
    def wire_bytes_per_elem(self) -> float:
        """Bytes one payload element costs on the wire: the int8 value plus
        its share of the block scale."""
        return 1.0 + SCALE_BYTES / self.block

    def validate(self) -> None:
        self.payload.validate()
        if self.payload.dtype != torch.int8:
            raise ValueError(f"quant arena payload must be int8, got "
                             f"{self.payload.dtype}")
        if self.block <= 0:
            raise ValueError(f"block must be positive, got {self.block}")
        for s in self.segments:
            if s.offset % self.block or s.padded % self.block:
                raise ValueError(f"segment {s.bucket}: offset/padded not a "
                                 f"multiple of codec block {self.block}")

    def describe(self) -> dict:
        """JSON-friendly summary (the reference's keys)."""
        return self.payload.describe() | {
            "codec": "int8",
            "codec_block": self.block,
            "payload_elems": self.payload_elems,
            "n_scales": self.n_scales,
            "scale_offset": self.scale_offset,
            "scale_region_bytes": self.scale_region_bytes,
            "total_elems": self.total_elems,
            "total_bytes": self.total_bytes,
            "n_pages": self.n_pages,
            "wire_bytes_per_elem": self.wire_bytes_per_elem,
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


def plan_quant_arena(sizes: Sequence[int], *, page_bytes: int = PAGE_BYTES,
                     block: int = 512,
                     channel_of: Sequence[int] | None = None,
                     pad_multiple: int = 1, bucket_bytes: int | None = None,
                     warn_oversized: bool = True) -> QuantArenaLayout:
    """Quantized-wire variant of :func:`plan_arena`: ``sizes`` are fp32
    *value* counts, placed as int8 payload with the codec ``block`` folded
    into the pad multiple (so segment offsets and padded sizes hold whole
    quant blocks) and a trailing page-quantized scale segment appended."""
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    pad = math.lcm(int(pad_multiple), int(block))
    # sizes count fp32 gradient values; scale the oversized threshold to
    # the int8 itemsize so the warning fires for the same leaves as fp32
    bb = None if bucket_bytes is None else max(1, int(bucket_bytes) // 4)
    payload = plan_arena(sizes, page_bytes=page_bytes, dtype=torch.int8,
                         channel_of=channel_of, pad_multiple=pad,
                         bucket_bytes=bb, warn_oversized=warn_oversized)
    layout = QuantArenaLayout(payload=payload, block=int(block))
    layout.validate()
    return layout


def quant_arena_from_bucket_plan(plan: BucketPlan, *,
                                 page_bytes: int = PAGE_BYTES,
                                 block: int = 512,
                                 channel_of: Sequence[int] | None = None,
                                 pad_multiple: int = 1,
                                 bucket_bytes: int | None = None,
                                 warn_oversized: bool = True
                                 ) -> QuantArenaLayout:
    """Quantized arena layout of a bucket plan: one int8 segment per bucket
    plus the trailing scale segment."""
    return plan_quant_arena(plan.bucket_sizes, page_bytes=page_bytes,
                            block=block, channel_of=channel_of,
                            pad_multiple=max(pad_multiple,
                                             plan.pad_multiple),
                            bucket_bytes=bucket_bytes,
                            warn_oversized=warn_oversized)


def arena_from_halo_plan(halo_plan, *, page_bytes: int = PAGE_BYTES,
                         itemsize: int = 4, dtype: torch.dtype = torch.float32,
                         pad_multiple: int = 1) -> ArenaLayout:
    """Arena layout for halo face payloads: one segment per exchange unit
    of a :class:`~repro_torch.comm.plan.HaloPlan` (whose ``unit_bytes`` are
    bytes; segments here are elements), grouped by the plan's halo channels
    so each rail's faces fuse into one contiguous span."""
    sizes = [-(-int(b) // itemsize) for b in halo_plan.unit_bytes]
    chan_of = [0] * len(sizes)
    for hc in halo_plan.channels:
        for u in hc.units:
            chan_of[u] = hc.channel
    return plan_arena(sizes, page_bytes=page_bytes, dtype=dtype,
                      channel_of=chan_of, pad_multiple=pad_multiple)


def fuse_schedule(schedule: CommSchedule,
                  layout: ArenaLayout | QuantArenaLayout) -> CommSchedule:
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
