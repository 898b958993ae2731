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
* **wire dtype** — hops can carry a narrow (bf16) copy of the partial sum;
* **wire codec** — or an int8 block-absmax payload (``codec="int8"``):
  every reduce-scatter hop re-encodes the running partial sum and decodes
  what it receives, the all-gather encodes each block once at its source.
  Encode and decode are the ``kernels/quant`` CUDA kernels under
  ``local_op="kernel"`` (their plain versions for CPU tensors).

All functions take flat, pre-padded 1-D buffers (``core.bucketing``
produces them) and the :class:`~repro_torch.core.p2p.RingAxis` of each mesh
axis they reduce over.  :func:`ring_all_to_all` is the expert-parallel
exchange built from ``p - 1`` pairwise hops.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Sequence

import torch

from repro_torch.core.p2p import RingAxis, concat_blocks, split_blocks

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
    codec: str | None = None           # None | "int8" (lossy block codec)
    codec_block: int = 512

    def make_codec(self):
        """The hop codec; an int8 codec's encode and decode follow
        ``local_op``, the knob that also selects the local add."""
        from repro_torch.comm.wire_codec import make_codec

        return make_codec(self.codec, wire_dtype=self.wire_dtype,
                          block=self.codec_block, impl=self.local_op)

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
    dirs = [d for _, _, d in slices]
    for s in range(p - 1):
        recv = axis.hop([codec.encode(a) for a in accs], dirs)
        accs = [local_add(codec.decode(t),
                          xs[(r - d - (s + 1) * d) % p, start:start + width])
                for t, (start, width, d) in zip(recv, slices)]
    return torch.cat(accs) if len(accs) > 1 else accs[0]


def ring_all_gather(shard: torch.Tensor, axis: RingAxis,
                    cfg: RingConfig = RingConfig()) -> torch.Tensor:
    """Inverse of :func:`ring_reduce_scatter` (same channel layout).  The
    payload is encoded once at its source and forwarded verbatim; the
    rank's own block goes through the same encode/decode, as in the
    reference; each of the p payloads of a channel slice is decoded on its
    own."""
    seg = shard.shape[0]
    _check_divisible(seg, cfg)
    p, r = axis.size, axis.index
    if p == 1:
        return shard
    codec = cfg.make_codec()
    slices = _channel_slices(seg, cfg)
    dirs = [d for _, _, d in slices]
    cur = [codec.encode(shard[start:start + width])
           for start, width, _ in slices]
    rows = [[t] * p for t in cur]        # each slice's payloads by source
    for s in range(p - 1):
        cur = axis.hop(cur, dirs)
        for row, t, d in zip(rows, cur, dirs):
            row[(r - (s + 1) * d) % p] = t
    blocks = [torch.stack([codec.decode(t) for t in row]).to(shard.dtype)
              for row in rows]                  # (p, width) each
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


# ---------------------------------------------------------------------------
# all-to-all (expert-parallel dispatch/combine)
# ---------------------------------------------------------------------------


def ring_all_to_all(x: torch.Tensor, axis: RingAxis, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
    """Tiled all-to-all (``lax.all_to_all(tiled=True)``'s semantics) from
    ``p - 1`` pairwise hops: ``x`` splits into ``p`` blocks along
    ``split_axis``, block ``j`` travels to the rank at index ``j``, and the
    received blocks concatenate along ``concat_axis`` in source order.

    Hop ``s`` ships the block for ``(r + s) % p`` with
    :meth:`RingAxis.start_shift` (direction ``s``) and receives the block
    rank ``(r - s) % p`` holds for this rank, so each block crosses the wire
    once: ``p - 1`` sends of ``(p - 1)/p`` of the payload in all.  Every
    step moves data only, so the inverse exchange is its transpose."""
    p, r = axis.size, axis.index
    if x.shape[split_axis] % max(p, 1):
        raise ValueError(f"all_to_all split dim {x.shape[split_axis]} not "
                         f"divisible by axis size {p}")
    if p == 1:
        return x
    blocks = split_blocks(x, p, split_axis)          # [j]: bound for rank j
    recv = [None] * p
    recv[r] = blocks[r]
    for s in range(1, p):
        got = axis.start_shift([blocks[(r + s) % p]], directions=[s]).wait()
        recv[(r - s) % p] = got[0]
    return concat_blocks(torch.stack(recv), concat_axis)
