"""Explicit ring collectives built from point-to-point hops.

Port of ``repro.core.ring``.  The reduction is an explicit reduce-scatter +
all-gather ring whose schedule the code controls, as in the reference:

* **bidirectional rings** — each segment's payload is split in half and the
  halves travel clockwise and counter-clockwise at once;
* **chunked multi-channel transfers** — the payload is further split into
  ``chunks`` independent chains; every ring step of every chain goes out in
  one ``dist.batch_isend_irecv`` (:meth:`RingAxis.hop`), so they overlap;
* **fused local reduce** — the per-hop ``acc += recv`` is the
  ``kernels/reduce_add`` CUDA kernel (``local_op="kernel"``, the default;
  its plain version for CPU tensors) with fp32 accumulation.  The hop order
  fixes the add order, so results equal the reference's bit for bit;
* **wire dtype** — hops can carry a narrow (bf16) copy of the partial sum.

All functions take flat, pre-padded 1-D buffers (``core.bucketing``
produces them) and the :class:`~repro_torch.core.p2p.RingAxis` of each mesh
axis they reduce over.  ``ring_all_to_all`` arrives with the MoE slice.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from repro_torch.core.p2p import RingAxis

LocalAdd = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
LOCAL_OPS = ("kernel", "plain")


@dataclass(frozen=True)
class RingConfig:
    """Static schedule knobs."""

    chunks: int = 1
    bidirectional: bool = True
    wire_dtype: str | None = None      # None = carry accum dtype on the wire
    accum_dtype: str = "float32"
    local_op: str = "kernel"           # "kernel" (kernels/reduce_add) | "plain"
    codec: str | None = None           # None | "int8" (the int8-wire slice)
    codec_block: int = 512

    def make_codec(self):
        from repro_torch.comm.wire_codec import make_codec

        return make_codec(self.codec, wire_dtype=self.wire_dtype,
                          block=self.codec_block)

    @property
    def channel_divisor(self) -> int:
        """Per-segment width divisor imposed by channels + codec blocks."""
        d = self.chunks * (2 if self.bidirectional else 1)
        if self.codec is not None:
            d *= self.codec_block
        return d

    def flat_divisor(self, axis_sizes: Sequence[int]) -> int:
        """Flat-buffer length divisor for a (possibly hierarchical)
        schedule: a reduce-scatter over one axis hands ``L / p`` to the
        next, so the requirement composes multiplicatively."""
        d = 1
        for p in axis_sizes:
            d *= p * self.channel_divisor
        return max(d, 1)


def _resolve_local_add(cfg: RingConfig) -> LocalAdd:
    accum = getattr(torch, cfg.accum_dtype)
    if cfg.local_op == "kernel":
        from repro_torch.kernels.reduce_add import ops

        return functools.partial(ops.add_accum, accum_dtype=accum)
    if cfg.local_op == "plain":
        from repro_torch.kernels.reduce_add import ref

        return functools.partial(ref.add_accum, accum_dtype=accum)
    raise ValueError(f"local_op must be one of {LOCAL_OPS}, got "
                     f"{cfg.local_op!r}")


def _channel_slices(seg: int, cfg: RingConfig) -> list[tuple[int, int, int]]:
    """(start, width, direction) channel layout of one owned segment."""
    w = seg // cfg.chunks
    out = []
    for c in range(cfg.chunks):
        base = c * w
        if cfg.bidirectional:
            h = w // 2
            out.append((base, h, +1))
            out.append((base + h, w - h, -1))
        else:
            out.append((base, w, +1))
    return out


def _check_divisible(seg: int, cfg: RingConfig) -> None:
    if seg % (cfg.channel_divisor or 1) != 0:
        raise ValueError(
            f"segment {seg} not divisible by channel divisor "
            f"{cfg.channel_divisor} (chunks={cfg.chunks}, "
            f"bidirectional={cfg.bidirectional}, codec={cfg.codec})")


def _encode(codec, x: torch.Tensor) -> list[torch.Tensor]:
    payload = codec.encode(x)
    return [payload[k] for k in sorted(payload)]


def _decode(codec, parts: list[torch.Tensor], keys) -> torch.Tensor:
    return codec.decode(dict(zip(keys, parts)))


def ring_reduce_scatter(x: torch.Tensor, axis: RingAxis,
                        cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Multi-channel ring reduce-scatter of a flat buffer.

    ``x``: (L,), ``L % (p * channel_divisor) == 0``.  Returns this rank's
    fully reduced segment ``x[r*L/p:(r+1)*L/p]`` (summed over the axis) in
    ``cfg.accum_dtype``."""
    p, r = axis.size, axis.index
    length = x.shape[0]
    if length % max(p, 1) != 0:
        raise ValueError(f"flat length {length} not divisible by ring size "
                         f"{p}")
    seg = length // p
    _check_divisible(seg, cfg)
    accum = getattr(torch, cfg.accum_dtype)
    if p == 1:
        return x.to(accum)
    local_add = _resolve_local_add(cfg)
    codec = cfg.make_codec()
    xs = x.view(p, seg)
    slices = _channel_slices(seg, cfg)
    # ownership offset chosen so the final fully reduced segment is r's
    accs = [xs[(r - d) % p, start:start + width].to(accum)
            for start, width, d in slices]
    keys = sorted(codec.encode(accs[0][:0]))
    for s in range(p - 1):
        wire = [t for a in accs for t in _encode(codec, a)]
        dirs = [d for _, _, d in slices for _ in keys]
        recv = axis.hop(wire, dirs)
        k = len(keys)
        accs = [local_add(_decode(codec, recv[i * k:(i + 1) * k], keys),
                          xs[(r - d - (s + 1) * d) % p, start:start + width])
                for i, (start, width, d) in enumerate(slices)]
    return torch.cat(accs) if len(accs) > 1 else accs[0]


def ring_all_gather(shard: torch.Tensor, axis: RingAxis,
                    cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Inverse of :func:`ring_reduce_scatter` (same channel layout).  The
    payload is encoded once at its source and forwarded verbatim; the
    rank's own block goes through the same encode/decode, as in the
    reference."""
    seg = shard.shape[0]
    _check_divisible(seg, cfg)
    p, r = axis.size, axis.index
    if p == 1:
        return shard
    codec = cfg.make_codec()
    slices = _channel_slices(seg, cfg)
    keys = sorted(codec.encode(shard[:0]))
    k = len(keys)
    cur = [t for start, width, _ in slices
           for t in _encode(codec, shard[start:start + width])]
    outs = [torch.empty((p,) + t.shape, dtype=t.dtype, device=t.device)
            for t in cur]                       # (p, width) per payload part
    for o, t in zip(outs, cur):
        o[r] = t
    dirs = [d for _, _, d in slices for _ in keys]
    for s in range(p - 1):
        cur = axis.hop(cur, dirs)
        for i, (o, t) in enumerate(zip(outs, cur)):
            o[(r - (s + 1) * dirs[i]) % p] = t
    blocks = [_decode(codec, outs[i * k:(i + 1) * k], keys).to(shard.dtype)
              for i in range(len(slices))]
    return (torch.cat(blocks, dim=1) if len(blocks) > 1
            else blocks[0]).reshape(-1)


def ring_all_reduce(x: torch.Tensor, axis: RingAxis,
                    cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Bandwidth-optimal all-reduce: reduce-scatter, then all-gather."""
    return ring_all_gather(ring_reduce_scatter(x, axis, cfg), axis, cfg)


def hierarchical_all_reduce(x: torch.Tensor, axes: Sequence[RingAxis],
                            cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Pod-aware all-reduce: reduce-scatter over the innermost axis
    (``axes[0]``), recurse over the outer axes on the 1/p shard, then
    all-gather back."""
    if len(axes) == 0:
        return x
    if len(axes) == 1:
        return ring_all_reduce(x, axes[0], cfg)
    inner, outer = axes[0], axes[1:]
    shard = ring_reduce_scatter(x, inner, cfg)
    shard = hierarchical_all_reduce(shard, outer, cfg)
    return ring_all_gather(shard, inner, cfg)


def flat_all_reduce(x: torch.Tensor, axes: Sequence[RingAxis],
                    cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Naive multi-axis schedule: a full-size ring all-reduce per axis in
    turn (the multi-pod baseline)."""
    for axis in axes:
        x = ring_all_reduce(x, axis, cfg)
    return x
