"""Wire codecs for collective payloads.

Port of the identity half of ``repro.comm.wire_codec``.  A codec turns a
flat fp32 partial sum into the payload a ring hop carries and back:
:class:`IdentityCodec` carries it as is, or cast to a narrow wire dtype
(the bf16 rail).  The int8 block codec and its error feedback arrive with
the int8-wire slice; :func:`make_codec` refuses ``"int8"`` until then
rather than carrying another format.
"""

from __future__ import annotations

import torch

Payload = dict[str, torch.Tensor]


class IdentityCodec:
    """No-op codec; optionally casts to a narrow wire dtype (bf16 rail)."""

    block = 1

    def __init__(self, wire_dtype: str | torch.dtype | None = None):
        if isinstance(wire_dtype, str):
            wire_dtype = getattr(torch, wire_dtype)
        self.wire_dtype = wire_dtype

    def encode(self, x: torch.Tensor) -> Payload:
        if self.wire_dtype is not None:
            x = x.to(self.wire_dtype)
        return {"x": x}

    def decode(self, payload: Payload) -> torch.Tensor:
        return payload["x"]

    def wire_bytes(self, n_elems: int,
                   accum_dtype: torch.dtype = torch.float32) -> int:
        dt = self.wire_dtype or accum_dtype
        return n_elems * dt.itemsize


def make_codec(name: str | None, *, wire_dtype=None, block: int = 512):
    if name in (None, "none", "identity"):
        return IdentityCodec(wire_dtype=wire_dtype)
    if name == "int8":
        raise NotImplementedError(
            "the int8 wire codec (Int8BlockCodec, ErrorFeedback) is not "
            "ported yet; it arrives with the int8-wire slice together with "
            "the pack_quant and quant kernels")
    raise ValueError(f"unknown codec {name!r}")
