"""Plain PyTorch fused pack+quantize arena copies: the CUDA kernels' plain
versions.

Port of ``repro.kernels.pack_quant.ref``: the arithmetic is
:mod:`repro_torch.kernels.quant.ref`'s, and the fp32 scale of every quant
block is stored, bit for bit, in the trailing scale segment of the same
flat int8 arena.  The reference's write is functional and returns the
residual ``x - q * scale``; here the arena is written in place, and the
residual goes into the error-feedback slice ``ef`` when one is given
(``x = src + ef`` is what is quantized, the reference's compensation at
pack time), else nowhere.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.quant import ref as quant_ref

SCALE_BYTES = 4  # one fp32 scale per quant block


def scale_byte_offset(scale_offset: int, offset: int, block: int) -> int:
    """Arena byte index of the scale for the quant block starting at
    payload element ``offset`` (offsets are block multiples by layout)."""
    return scale_offset + (offset // block) * SCALE_BYTES


def _scale_view(arena: torch.Tensor, offset: int, size: int,
                scale_offset: int, block: int) -> torch.Tensor:
    """The fp32 scales of ``arena[offset : offset + size]``: a view of the
    arena's trailing scale bytes, shape ``(size // block,)``."""
    lo = scale_byte_offset(scale_offset, offset, block)
    hi = scale_byte_offset(scale_offset, offset + size, block)
    return arena[lo:hi].view(torch.float32)


def write_quant_flat(arena: torch.Tensor, src: torch.Tensor, offset: int,
                     scale_offset: int, block: int,
                     ef: torch.Tensor | None = None) -> torch.Tensor:
    """Quantizes flat ``src`` (plus ``ef`` when given) into
    ``arena[offset : offset + n]`` (int8 payload) and its scales into the
    trailing scale segment, in place; with ``ef``, overwrites ``ef`` with
    the residual ``x - dequant(quant(x))``.  Returns ``arena``."""
    x = src.to(torch.float32)
    if ef is not None:
        x = x + ef
    x = x.reshape(-1, block)
    q, s = quant_ref.quantize_blocks(x)
    if ef is not None:
        ef.copy_((x - quant_ref.dequantize_blocks(q, s)).reshape(-1))
    arena[offset:offset + q.numel()].copy_(q.reshape(-1))
    _scale_view(arena, offset, q.numel(), scale_offset,
                block).copy_(s.reshape(-1))
    return arena


def read_dequant_flat(arena: torch.Tensor, offset: int, size: int,
                      scale_offset: int, block: int) -> torch.Tensor:
    """Fused dequant+unpack: ``arena[offset : offset + size]`` decoded to a
    fresh flat fp32 tensor with its trailing scales."""
    q = arena[offset:offset + size]
    s = _scale_view(arena, offset, size, scale_offset, block)
    return quant_ref.dequantize_blocks(q.reshape(-1, block),
                                       s.reshape(-1, 1)).reshape(-1)
