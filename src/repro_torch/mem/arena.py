"""CommArena: the allocate-once, written-in-place communication buffer.

Port of the fp32/bf16 half of ``repro.mem.arena`` (``QuantCommArena``
arrives with the int8-wire slice).  A :class:`CommArena` owns an
:class:`~repro_torch.mem.layout.ArenaLayout` and moves flat buckets in and
out of the arena tensor.

The persistence contract is the paper's pre-registered huge-page buffer.
The reference allocates the arena once in the train state and *donates* it
through the jitted step, so XLA reuses the allocation.  PyTorch has no
donation; here the arena is one tensor allocated once (:meth:`zeros`) and
written **in place** by :meth:`pack_into` every step, so its ``data_ptr()``
never changes.  Page-padding gaps keep whatever they held (they are never
read back).

``impl`` selects the copies: ``"kernel"`` (the default) runs the
:mod:`repro_torch.kernels.pack` CUDA kernels for CUDA tensors (their plain
versions for CPU tensors); ``"plain"`` runs the plain versions anywhere.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import torch

from repro_torch.kernels.pack import ops as pack_ops
from repro_torch.kernels.pack import ref as pack_ref
from repro_torch.mem.layout import ArenaLayout

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
