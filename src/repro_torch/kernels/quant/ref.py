"""Plain PyTorch block-absmax int8 codec: the CUDA kernels' plain versions.

Port of ``repro.kernels.quant.ref`` (which mirrors the reference's
``Int8BlockCodec``) op for op: ``scale = max(absmax / 127, tiny)`` and
``q = clip(round(x / scale), ±127)`` per block, ``q * scale`` back.

Every division is a true IEEE division.  The divisor 127 is a 0-dim tensor
on the input's device (filled there, so a CUDA graph can capture it), not a
Python number: PyTorch's CUDA division by a host scalar multiplies by its
reciprocal, which can round the scale one ulp away from the kernel's (and
the reference's) ``absmax / 127``.
"""

from __future__ import annotations

import torch

TINY = torch.finfo(torch.float32).tiny


def quantize_blocks(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``x``: (n_blocks, block) -> (int8 q of the same shape, fp32
    (n_blocks, 1) scales)."""
    x = x.to(torch.float32)
    absmax = torch.amax(torch.abs(x), dim=1, keepdim=True)
    scale = torch.maximum(absmax / torch.full((), 127.0, device=x.device),
                          torch.full((), TINY, device=x.device))
    q = torch.clamp(torch.round(x / scale), -127.0, 127.0)
    # a block whose scale is NaN or inf has NaN quotients; casting NaN to
    # int8 is undefined in C++, and XLA (the reference, on the CPU) makes
    # it 0, so the port makes it 0 explicitly
    q = torch.nan_to_num(q, nan=0.0).to(torch.int8)
    return q, scale


def dequantize_blocks(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """int8 (n_blocks, block) and fp32 (n_blocks, 1) -> fp32 ``q * scale``."""
    return q.to(torch.float32) * scale


def quantize(x: torch.Tensor, block: int = 512,
             out: tuple[torch.Tensor, torch.Tensor] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat fp32 (n,) -> (int8 (n,), fp32 scales (n / block,)), written
    into ``out`` when it is given."""
    if x.shape[0] % block:
        raise ValueError(f"size {x.shape[0]} not divisible by block {block}")
    q, s = quantize_blocks(x.reshape(-1, block))
    if out is None:
        return q.reshape(-1), s.reshape(-1)
    out[0].copy_(q.reshape(-1))
    out[1].copy_(s.reshape(-1))
    return out


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               block: int = 512) -> torch.Tensor:
    """Inverse of :func:`quantize`: flat int8 (n,) and (n / block,) scales
    -> fp32 (n,)."""
    if q.shape[0] % block:
        raise ValueError(f"size {q.shape[0]} not divisible by block {block}")
    return dequantize_blocks(q.reshape(-1, block),
                             scales.reshape(-1, 1)).reshape(-1)
