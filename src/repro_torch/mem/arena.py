"""CommArena: the allocate-once, written-in-place communication buffer.

Port of ``repro.mem.arena``.  A :class:`CommArena` owns an
:class:`~repro_torch.mem.layout.ArenaLayout` and moves flat buckets in and
out of the arena tensor; a :class:`QuantCommArena` does the same for the
int8 wire, encoding on the way in and decoding on the way out.

The persistence contract is the paper's pre-registered huge-page buffer.
The reference allocates the arena once in the train state and *donates* it
through the jitted step, so XLA reuses the allocation.  PyTorch has no
donation; here the arena is one tensor allocated once (:meth:`zeros`) and
written **in place** by :meth:`pack_into` every step, so its ``data_ptr()``
never changes.  Page-padding gaps keep whatever they held (they are never
read back).

``impl`` selects the copies: ``"kernel"`` (the default) runs the
:mod:`repro_torch.kernels.pack` (and, for the int8 arena,
:mod:`repro_torch.kernels.pack_quant`) CUDA kernels for CUDA tensors (their
plain versions for CPU tensors); ``"plain"`` runs the plain versions
anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.core.topology import padded_size
from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.pack import ref as pack_ref
from repro_torch.kernels.pack_quant import ops as pq_ops
from repro_torch.kernels.pack_quant import ref as pq_ref
from repro_torch.mem.layout import ArenaLayout, QuantArenaLayout

PACK_IMPLS = ("kernel", "plain")


@dataclass(frozen=True)
class CommArena:
    """One persistent, page-aligned communication buffer + its layout."""

    layout: ArenaLayout
    impl: str = "kernel"

    def __post_init__(self):
        if self.impl not in PACK_IMPLS:
            raise ValueError(f"impl must be one of {PACK_IMPLS}, "
                             f"got {self.impl!r}")

    def zeros(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """The arena, allocated once (zeroed) on ``device``."""
        return torch.zeros((self.layout.total_elems,),
                           dtype=self.layout.dtype, device=device)

    def _write(self, arena, src, offset):
        mod = pack_ops if self.impl == "kernel" else pack_ref
        return mod.write_flat(arena, src, offset)

    def _read(self, arena, offset, size):
        mod = pack_ops if self.impl == "kernel" else pack_ref
        return mod.read_flat(arena, offset, size)

    def _check(self, arena: torch.Tensor) -> None:
        if tuple(arena.shape) != (self.layout.total_elems,):
            raise ValueError(f"arena shape {tuple(arena.shape)} != "
                             f"({self.layout.total_elems},)")

    def pack_into(self, arena: torch.Tensor,
                  buffers: Sequence[torch.Tensor]) -> torch.Tensor:
        """Writes ``buffers[i]`` (bucket-id order) into segment ``i``'s slot
        of ``arena``, in place, one copy per segment; returns ``arena``."""
        lay = self.layout
        if len(buffers) != lay.n_segments:
            raise ValueError(f"arena has {lay.n_segments} segments, got "
                             f"{len(buffers)} buffers")
        self._check(arena)
        for seg in lay.segments:
            b = buffers[seg.bucket].reshape(-1)
            if b.shape[0] != seg.size:
                raise ValueError(f"bucket {seg.bucket} has {b.shape[0]} "
                                 f"elems, segment expects {seg.size}")
            self._write(arena, b, seg.offset)
        return arena

    def pack(self, buffers: Sequence[torch.Tensor]) -> torch.Tensor:
        """A fresh arena with ``buffers`` packed and padding zeroed."""
        return self.pack_into(self.zeros(buffers[0].device), buffers)

    def unpack(self, arena: torch.Tensor) -> list[torch.Tensor]:
        """Fresh copies of the segment payloads, indexed by bucket id."""
        self._check(arena)
        out: list = [None] * self.layout.n_segments
        for seg in self.layout.segments:
            out[seg.bucket] = self._read(arena, seg.offset, seg.size)
        return out

    def unpack_spans(self, spans: Sequence[torch.Tensor]
                     ) -> list[torch.Tensor]:
        """Bucket payloads out of per-span buffers (e.g. all-gathered ZeRO
        spans), indexed by bucket id."""
        lay = self.layout
        if len(spans) != lay.n_spans:
            raise ValueError(f"arena has {lay.n_spans} spans, got "
                             f"{len(spans)}")
        out: list = [None] * lay.n_segments
        for idx, sp in enumerate(lay.spans):
            buf = spans[idx].reshape(-1)
            if buf.shape[0] != sp.size:
                raise ValueError(f"span {idx} has {buf.shape[0]} elems, "
                                 f"expected {sp.size}")
            for b in sp.buckets:
                seg = lay.segment_of(b)
                out[b] = self._read(buf, seg.offset - sp.offset, seg.size)
        return out


@dataclass(frozen=True)
class QuantCommArena:
    """The int8 wire's arena: one persistent **int8** tensor holding the
    per-block absmax payload and, in its trailing scale segment, the fp32
    scales (:class:`~repro_torch.mem.layout.QuantArenaLayout`).

    Packing *encodes*: :meth:`pack_into` runs the fused pack+quantize kernel
    once per segment, with error feedback applied on the way in and its
    residual written back; :meth:`unpack` and :meth:`dequant_span` run the
    fused dequant+unpack.  The persistence contract is :class:`CommArena`'s,
    for both tensors: the arena (:meth:`zeros`) and the fp32 error-feedback
    accumulator (:meth:`ef_zeros`) are allocated once and updated **in
    place** (their ``data_ptr()`` never changes) where the reference donates
    them through its jitted step.
    """

    layout: QuantArenaLayout
    impl: str = "kernel"

    def __post_init__(self):
        if self.impl not in PACK_IMPLS:
            raise ValueError(f"impl must be one of {PACK_IMPLS}, "
                             f"got {self.impl!r}")

    def zeros(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """The int8 arena, allocated once (zeroed) on ``device``."""
        return torch.zeros((self.layout.total_elems,), dtype=torch.int8,
                           device=device)

    def ef_zeros(self, device: str | torch.device = "cuda") -> torch.Tensor:
        """The error-feedback accumulator, allocated once (zeroed): one fp32
        residual per payload element."""
        return torch.zeros((self.layout.payload_elems,), dtype=torch.float32,
                           device=device)

    def _write_quant(self, arena, src, offset, ef=None):
        mod = pq_ops if self.impl == "kernel" else pq_ref
        return mod.write_quant_flat(arena, src, offset,
                                    self.layout.scale_offset,
                                    self.layout.block, ef)

    def _read_dequant(self, arena, offset, size):
        mod = pq_ops if self.impl == "kernel" else pq_ref
        return mod.read_dequant_flat(arena, offset, size,
                                     self.layout.scale_offset,
                                     self.layout.block)

    def _check(self, arena: torch.Tensor) -> None:
        if tuple(arena.shape) != (self.layout.total_elems,):
            raise ValueError(f"arena shape {tuple(arena.shape)} != "
                             f"({self.layout.total_elems},)")

    def pack_into(self, arena: torch.Tensor,
                  buffers: Sequence[torch.Tensor],
                  ef: torch.Tensor | None = None):
        """Quantizes ``buffers[i]`` (bucket-id order) into segment ``i`` and
        its scales, in place, one launch per segment.

        When ``ef`` (the flat fp32 error-feedback accumulator) is given,
        each bucket is compensated with its stored residual before encoding
        and ``ef`` is overwritten, in place, with the fresh residual.
        Returns ``(arena, ef)``.
        """
        lay = self.layout
        if len(buffers) != lay.n_segments:
            raise ValueError(f"arena has {lay.n_segments} segments, got "
                             f"{len(buffers)} buffers")
        self._check(arena)
        if ef is not None and tuple(ef.shape) != (lay.payload_elems,):
            raise ValueError(f"ef shape {tuple(ef.shape)} != "
                             f"({lay.payload_elems},)")
        for seg in lay.segments:
            b = buffers[seg.bucket].reshape(-1)
            if b.shape[0] != seg.size:
                raise ValueError(f"bucket {seg.bucket} has {b.shape[0]} "
                                 f"elems, segment expects {seg.size}")
            # encode whole quant blocks: sizes not already block multiples
            # are zero-extended into the segment's block-aligned padding
            bsize = padded_size(seg.size, lay.block)
            b = b.to(torch.float32)
            if bsize != seg.size:
                b = torch.nn.functional.pad(b, (0, bsize - seg.size))
            self._write_quant(arena, b, seg.offset,
                              None if ef is None
                              else ef[seg.offset:seg.offset + bsize])
        return arena, ef

    def unpack(self, arena: torch.Tensor) -> list[torch.Tensor]:
        """Fused dequant+unpack: fp32 segment payloads, by bucket id."""
        self._check(arena)
        out: list = [None] * self.layout.n_segments
        for seg in self.layout.segments:
            bsize = padded_size(seg.size, self.layout.block)
            dec = self._read_dequant(arena, seg.offset, bsize)
            out[seg.bucket] = dec[:seg.size] if bsize != seg.size else dec
        return out

    def dequant_span(self, arena: torch.Tensor, idx: int) -> torch.Tensor:
        """Span ``idx``'s payload decoded to fp32 (span sizes are whole
        quant blocks by layout)."""
        sp = self.layout.spans[idx]
        return self._read_dequant(arena, sp.offset, sp.size)

    def requant_span(self, arena: torch.Tensor, idx: int,
                     values: torch.Tensor) -> torch.Tensor:
        """Re-encodes reduced fp32 ``values`` into span ``idx``'s payload and
        scales, in place (no residual: error feedback compensates the encode
        of the *local* gradient, not the reduced sum); returns ``arena``."""
        sp = self.layout.spans[idx]
        if tuple(values.shape) != (sp.size,):
            raise ValueError(f"span {idx} expects ({sp.size},), got "
                             f"{tuple(values.shape)}")
        return self._write_quant(arena, values, sp.offset)

    def unpack_spans(self, spans: Sequence[torch.Tensor]
                     ) -> list[torch.Tensor]:
        """Bucket payloads out of per-span **fp32** buffers (e.g.
        all-gathered ZeRO deltas): plain slicing, no codec."""
        return CommArena(self.layout.payload, self.impl).unpack_spans(spans)
