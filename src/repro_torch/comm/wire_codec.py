"""Wire codecs and error feedback for collective payloads.

Port of ``repro.comm.wire_codec``.  A codec turns a flat fp32 partial sum
into the payload a ring hop carries and back:

* :class:`IdentityCodec` carries it as is, or cast to a narrow wire dtype
  (the bf16 rail);
* :class:`Int8BlockCodec` carries per-block absmax int8 values and one fp32
  scale per ``block`` values (``1 + 4/block`` bytes per value against 4).
  Its encode and decode are the :mod:`repro_torch.kernels.quant` kernels
  (``impl="kernel"``, their plain versions for CPU tensors) or the plain
  versions anywhere (``impl="plain"``).

A payload is one flat tensor, so a ring hop sends one message per chain.

:class:`ErrorFeedback` re-injects each rank's own quantisation error into
its next encode, so the error telescopes instead of accumulating.  The
arithmetic is the reference's: ``scale = max(absmax/127, tiny)``;
``q = clip(round(x/scale), ±127)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch

from repro_torch.core.ring import LOCAL_OPS


class IdentityCodec:
    """No-op codec; optionally casts to a narrow wire dtype (bf16 rail)."""

    block = 1

    def __init__(self, wire_dtype: str | torch.dtype | None = None):
        if isinstance(wire_dtype, str):
            wire_dtype = getattr(torch, wire_dtype)
        self.wire_dtype = wire_dtype

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        if self.wire_dtype is not None:
            x = x.to(self.wire_dtype)
        return x

    def decode(self, payload: torch.Tensor) -> torch.Tensor:
        return payload

    def wire_bytes(self, n_elems: int,
                   accum_dtype: torch.dtype = torch.float32) -> int:
        dt = self.wire_dtype or accum_dtype
        return n_elems * dt.itemsize


class Int8BlockCodec:
    """Per-block absmax int8 quantisation.

    ``encode`` views flat ``x`` as (n/block, block), scales each block by
    ``absmax/127`` and rounds to nearest into int8; ``decode`` inverts.
    Sizes must be block multiples (the bucketer's pad multiple guarantees
    it).  The payload is one flat int8 tensor: the n/block fp32 scales'
    bytes, then the n values (the reference's ``{"q", "scale"}`` pair in
    one buffer; scales first, so their bytes are 4-byte aligned at any
    block size).
    """

    def __init__(self, block: int = 512, impl: str = "kernel"):
        if block <= 0:
            raise ValueError("block must be positive")
        if impl not in LOCAL_OPS:
            raise ValueError(f"impl must be one of {LOCAL_OPS}, got "
                             f"{impl!r}")
        self.block = block
        self.impl = impl

    def _ops(self):
        if self.impl == "kernel":
            from repro_torch.kernels.quant import ops

            return ops
        from repro_torch.kernels.quant import ref

        return ref

    def split(self, payload: torch.Tensor
              ) -> tuple[torch.Tensor, torch.Tensor]:
        """Views of a payload's int8 values and fp32 scales."""
        n_blocks, rem = divmod(payload.numel(), self.block + 4)
        if rem or payload.ndim != 1:
            raise ValueError(f"payload of shape {tuple(payload.shape)} is "
                             f"not whole blocks of {self.block}")
        head = 4 * n_blocks
        return payload[head:], payload[:head].view(torch.float32)

    def encode(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[0]
        if n % self.block:
            raise ValueError(f"size {n} not divisible by codec block "
                             f"{self.block}")
        payload = torch.empty((self.wire_bytes(n),), dtype=torch.int8,
                              device=x.device)
        self._ops().quantize(x.to(torch.float32), self.block,
                             out=self.split(payload))
        return payload

    def decode(self, payload: torch.Tensor) -> torch.Tensor:
        return self._ops().dequantize(*self.split(payload), self.block)

    def wire_bytes(self, n_elems: int,
                   accum_dtype: torch.dtype = torch.float32) -> int:
        return n_elems * 1 + (n_elems // self.block) * 4


def make_codec(name: str | None, *, wire_dtype=None, block: int = 512,
               impl: str = "kernel"):
    if name in (None, "none", "identity"):
        return IdentityCodec(wire_dtype=wire_dtype)
    if name == "int8":
        return Int8BlockCodec(block=block, impl=impl)
    raise ValueError(f"unknown codec {name!r}")


@dataclass
class ErrorFeedback:
    """Source-side error feedback for lossy wire codecs.

    ``compensate`` adds the residual carried from the previous step and
    returns the new residual (the part of the compensated gradient the codec
    cannot represent).  State is a list congruent with the bucket list.
    """

    codec: Any

    def init(self, buckets: list[torch.Tensor]) -> list[torch.Tensor]:
        return [torch.zeros_like(b, dtype=torch.float32) for b in buckets]

    def compensate(self, buckets: list[torch.Tensor],
                   residuals: list[torch.Tensor]
                   ) -> tuple[list[torch.Tensor], list[torch.Tensor]]:
        comp, new_res = [], []
        for b, r in zip(buckets, residuals):
            y = b.to(torch.float32) + r
            decoded = self.codec.decode(self.codec.encode(y))
            comp.append(y)
            new_res.append(y - decoded)
        return comp, new_res
