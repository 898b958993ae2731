"""Paged KV cache: the serving generalisation of the huge-page arena.

Port of ``repro.serve.kv``.  A **KV page** holds one layer's K and V blocks
for ``page_tokens`` token positions of one sequence.  All pages are laid out
in a single flat arena by :func:`repro_torch.mem.layout.plan_arena`, so every
page starts on a ``page_bytes`` boundary and the padding accounting comes
for free.  The arena tensor is allocated **once** (:meth:`KVArenaPlan.zeros`)
and the decode step writes into it in place: the PyTorch counterpart of the
reference's donated buffer.

In-page element layout (cache dtype, default bf16)::

    [ K: (Hkv, page_tokens, head_dim) ][ V: same ][ page padding ]

Host-side ownership is a free-list :class:`KVPageAllocator` plus a
per-sequence :class:`PageTable` — ``table[slot, block, layer]`` is the page
id backing token positions ``[block*page_tokens, (block+1)*page_tokens)``
of ``slot`` at ``layer`` (``-1`` = unmapped).

``max_blocks`` is padded up to a multiple of ``model_parallel``: page-parallel
decode gives each rank a static chunk of the block columns.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.mem.layout import (PAGE_BYTES, ArenaLayout, dtype_name,
                                    plan_arena)
from repro_torch.refusal import Refusal


def kv_page_payload_elems(cfg: ModelConfig, page_tokens: int) -> int:
    """Used elements of one KV page: K + V for one layer's page_tokens."""
    a = cfg.attn
    return 2 * a.num_kv_heads * page_tokens * a.head_dim


def _require_pageable(cfg: ModelConfig) -> None:
    """Paged decode covers decoder-only, all-global-attention transformers.

    Rolling window/chunk caches reuse slots out of order, which a page table
    keyed by absolute block index cannot express; SSM/hybrid carry non-KV
    decode state.  Every unsupported family fails loudly here, at plan time.
    """
    if cfg.attn is None or cfg.family not in ("dense", "moe") \
            or cfg.frontend is not None or cfg.enc_layers:
        raise Refusal(
            f"paged KV serving is decoder-only (family={cfg.family!r}, "
            f"frontend={cfg.frontend!r})")
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        if kind["mixer"] != "attn" or not kind.get("attn_global", True):
            raise Refusal(
                f"paged KV serving needs global attention at every layer; "
                f"layer {i} is {kind['mixer']}/local (window={cfg.attn.window}, "
                f"chunk={cfg.attn.chunk})")


@dataclass(frozen=True)
class KVArenaPlan:
    """Placement of a serving fleet's KV pages in one flat arena."""

    layout: ArenaLayout          # one segment per KV page, equal sizes
    page_tokens: int             # token positions per page
    max_seqs: int                # sequence slots the arena was sized for
    max_blocks: int              # page-table columns (model-parallel padded)
    n_layers: int
    num_kv_heads: int
    head_dim: int
    model_parallel: int          # ranks the block dim tiles

    # -- shape ---------------------------------------------------------------

    @property
    def n_kv_pages(self) -> int:
        """Allocatable KV pages (arena segments)."""
        return self.layout.n_segments

    @property
    def page_stride(self) -> int:
        """Element stride between consecutive pages (page-quantized)."""
        return self.layout.segments[0].padded if self.layout.segments else 0

    @property
    def payload_elems(self) -> int:
        return self.layout.segments[0].size if self.layout.segments else 0

    @property
    def k_offset(self) -> int:
        return 0

    @property
    def v_offset(self) -> int:
        return self.num_kv_heads * self.page_tokens * self.head_dim

    @property
    def total_elems(self) -> int:
        return self.layout.total_elems

    @property
    def total_bytes(self) -> int:
        return self.layout.total_bytes

    @property
    def n_arena_pages(self) -> int:
        """Whole ``page_bytes`` allocation granules (huge pages)."""
        return self.layout.n_pages

    @property
    def padding_fraction(self) -> float:
        return self.layout.padding_fraction

    @property
    def blocks_per_rank(self) -> int:
        return self.max_blocks // self.model_parallel

    def page_offset(self, page_id: int) -> int:
        return self.layout.segments[page_id].offset

    def zeros(self, device: str | torch.device) -> torch.Tensor:
        """The allocate-once arena tensor (the engine writes it in place;
        never reallocate per token)."""
        return torch.zeros((self.total_elems,), dtype=self.layout.dtype,
                           device=device)

    def describe(self) -> dict:
        return {
            "page_tokens": self.page_tokens,
            "max_seqs": self.max_seqs,
            "max_blocks": self.max_blocks,
            "n_layers": self.n_layers,
            "num_kv_heads": self.num_kv_heads,
            "head_dim": self.head_dim,
            "model_parallel": self.model_parallel,
            "n_kv_pages": self.n_kv_pages,
            "page_stride": self.page_stride,
            "payload_elems": self.payload_elems,
            "total_bytes": self.total_bytes,
            "n_arena_pages": self.n_arena_pages,
            "page_bytes": self.layout.page_bytes,
            "padding_fraction": self.padding_fraction,
            "dtype": dtype_name(self.layout.dtype),
        }


def plan_kv_arena(cfg: ModelConfig, *, model_parallel: int = 1,
                  page_tokens: int = 16, page_bytes: int = PAGE_BYTES,
                  max_seqs: int = 8, max_seq_len: int = 256,
                  cache_dtype: torch.dtype = torch.bfloat16) -> KVArenaPlan:
    """Page-quantized KV arena for up to ``max_seqs`` concurrent sequences
    of up to ``max_seq_len`` tokens.

    Sizing: ``max_seqs * ceil(max_seq_len / page_tokens) * num_layers``
    pages (block count padded to a multiple of ``model_parallel``), each the
    page-aligned slot of one layer's K+V block.
    """
    _require_pageable(cfg)
    if page_tokens < 1:
        raise ValueError(f"page_tokens must be >= 1, got {page_tokens}")
    if max_seqs < 1 or max_seq_len < 1:
        raise ValueError(f"max_seqs/max_seq_len must be >= 1, got "
                         f"{max_seqs}/{max_seq_len}")
    if model_parallel < 1:
        raise ValueError(f"model_parallel must be >= 1, got {model_parallel}")
    mp = int(model_parallel)
    blocks = math.ceil(max_seq_len / page_tokens)
    max_blocks = math.ceil(blocks / mp) * mp          # tile the ranks
    n_pages = max_seqs * max_blocks * cfg.num_layers
    payload = kv_page_payload_elems(cfg, page_tokens)
    layout = plan_arena([payload] * n_pages, page_bytes=page_bytes,
                        dtype=cache_dtype, channel_of=[0] * n_pages)
    return KVArenaPlan(layout=layout, page_tokens=page_tokens,
                       max_seqs=max_seqs, max_blocks=max_blocks,
                       n_layers=cfg.num_layers,
                       num_kv_heads=cfg.attn.num_kv_heads,
                       head_dim=cfg.attn.head_dim, model_parallel=mp)


class KVPageAllocator:
    """LIFO free-list over the arena's KV pages (host side).

    Invariants: a page is never handed out twice, ``free`` of a page not
    currently allocated raises, and ``n_free + n_allocated == n_total``.
    """

    def __init__(self, n_pages: int):
        if n_pages < 1:
            raise ValueError(f"n_pages must be >= 1, got {n_pages}")
        self.n_total = int(n_pages)
        self._free: list[int] = list(range(n_pages - 1, -1, -1))
        self._allocated: set[int] = set()

    @property
    def n_free(self) -> int:
        return len(self._free)

    @property
    def n_allocated(self) -> int:
        return len(self._allocated)

    def alloc(self, n: int) -> list[int]:
        """``n`` page ids, or raises if the arena is out of pages (callers
        check :attr:`n_free` first; the scheduler queues instead)."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} pages")
        if n > len(self._free):
            raise MemoryError(f"KV arena out of pages: want {n}, "
                              f"free {len(self._free)}/{self.n_total}")
        out = [self._free.pop() for _ in range(n)]
        self._allocated.update(out)
        return out

    def free(self, pages) -> None:
        for p in pages:
            p = int(p)
            if p not in self._allocated:
                raise ValueError(f"page {p} is not allocated "
                                 f"(double free or foreign id)")
            self._allocated.remove(p)
            self._free.append(p)


class PageTable:
    """Fixed-shape ``(slots, max_blocks, n_layers)`` int32 page map.

    ``-1`` marks an unmapped block; the decode step clamps ids and masks
    those positions invalid, so a partially filled table is always safe.
    """

    def __init__(self, slots: int, max_blocks: int, n_layers: int):
        self.table = np.full((slots, max_blocks, n_layers), -1, np.int32)

    def map_block(self, slot: int, block: int, layer_pages) -> None:
        """Back ``(slot, block)`` with one page per layer."""
        if len(layer_pages) != self.table.shape[2]:
            raise ValueError(f"need {self.table.shape[2]} pages (one per "
                             f"layer), got {len(layer_pages)}")
        if (self.table[slot, block] >= 0).any():
            raise ValueError(f"slot {slot} block {block} already mapped")
        self.table[slot, block] = np.asarray(layer_pages, np.int32)

    def clear_slot(self, slot: int) -> list[int]:
        """Unmap every block of ``slot``; returns the freed page ids."""
        pages = self.table[slot][self.table[slot] >= 0].tolist()
        self.table[slot] = -1
        return pages
