"""Plain PyTorch arena pack/unpack: the CUDA kernels' plain versions.

Port of ``repro.kernels.pack.ref``.  The reference's write is functional
(XLA aliases the donated buffer); here the arena is one tensor written in
place, and a read is a fresh copy, so later writes into the arena never
alias what was read out.
"""

from __future__ import annotations

import torch


def write_flat(arena: torch.Tensor, src: torch.Tensor,
               offset: int) -> torch.Tensor:
    """Writes ``src`` (cast to the arena dtype) into
    ``arena[offset : offset + src.numel()]`` in place; returns ``arena``."""
    arena[offset:offset + src.numel()].copy_(src.reshape(-1))
    return arena


def read_flat(arena: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """A fresh copy of ``arena[offset : offset + size]``."""
    return arena[offset:offset + size].clone()
