"""CommPlan: one object describing how a gradient tree moves.

Port of the gradient half of ``repro.comm.plan`` (plain Python; the numbers
equal the reference's): the bucket layout, the channel striping (which
bucket rides which virtual channel) and the predicted wire bytes and
messages per device, for the bucket path and for the page-aligned arena.
The recording wrapper of :mod:`repro_torch.core.p2p` counts the same two
quantities on the wire, so a run can be held against its plan.
``HaloPlan``, ``A2APlan`` and the int8 codec's trade-off arrive with their
slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

from repro_torch.core.bucketing import BucketPlan

# The reference's α/β constants: a modelled per-message latency and link
# rate (its own napkin math, not a measurement of any card in this port).
ALPHA_S = 1.5e-6
LINK_BANDWIDTH = 50e9


@dataclass(frozen=True)
class LatencyModel:
    """α/β cost model of one device's collective traffic:
    ``t = α · messages + bytes / bandwidth``."""

    alpha_s: float = ALPHA_S
    bandwidth: float = LINK_BANDWIDTH

    def collective_seconds(self, messages: float, nbytes: float) -> float:
        return self.alpha_s * float(messages) + float(nbytes) / self.bandwidth


@dataclass(frozen=True)
class ChannelAssignment:
    """Buckets carried by one virtual channel (independent collective)."""

    channel: int
    buckets: tuple[int, ...]   # indices into the bucket list, ascending
    elems: int                 # total padded elements on this channel


def assign_channels(bucket_sizes: Sequence[int], channels: int
                    ) -> tuple[ChannelAssignment, ...]:
    """Greedy least-loaded striping of buckets across ``channels`` virtual
    channels: largest bucket first, ties by index, each onto the currently
    lightest channel."""
    n = max(int(channels), 1)
    loads = [0] * n
    members: list[list[int]] = [[] for _ in range(n)]
    order = sorted(range(len(bucket_sizes)),
                   key=lambda i: (-int(bucket_sizes[i]), i))
    for i in order:
        c = min(range(n), key=lambda j: (loads[j], j))
        members[c].append(i)
        loads[c] += int(bucket_sizes[i])
    return tuple(ChannelAssignment(c, tuple(sorted(members[c])), loads[c])
                 for c in range(n))


@dataclass(frozen=True)
class CommPlan:
    """Bucket layout + channel striping + predicted bytes for one tree."""

    transport: str
    axes: tuple[str, ...]
    axis_sizes: tuple[int, ...]
    bucket_plan: BucketPlan
    channels: tuple[ChannelAssignment, ...]
    wire_bytes_per_elem: float     # codec/wire-dtype bytes per element
    bytes_per_device: float        # predicted all-reduce wire bytes/device
    messages_per_device: float = 0.0  # discrete sends/device (α term)
    # arena mode: the page-quantized layout, whose padding crosses the wire
    arena_layout: "object | None" = None     # repro_torch.mem.ArenaLayout
    arena_bytes_per_device: float = 0.0
    arena_messages_per_device: float = 0.0
    wire_codec: str | None = None
    codec_block: int = 512

    @property
    def n_buckets(self) -> int:
        return self.bucket_plan.n_buckets

    @property
    def n_channels(self) -> int:
        return len(self.channels)

    @property
    def total_elems(self) -> int:
        return self.bucket_plan.total_elems

    @property
    def world(self) -> int:
        w = 1
        for p in self.axis_sizes:
            w *= p
        return w

    @property
    def channel_imbalance(self) -> float:
        """max/mean channel load (1.0 = perfectly striped)."""
        loads = [a.elems for a in self.channels]
        mean = sum(loads) / max(len(loads), 1)
        return max(loads) / mean if mean else 1.0

    def predicted_collective_bytes(self) -> dict[str, float]:
        out = {
            "bytes_per_device": self.bytes_per_device,
            "grad_bytes": self.bucket_plan.used_elems * 4.0,
            "wire_bytes_per_elem": self.wire_bytes_per_elem,
            "n_channels": float(self.n_channels),
            "channel_imbalance": self.channel_imbalance,
            "messages_per_device": self.messages_per_device,
        }
        if self.arena_layout is not None:
            out.update({
                "arena_bytes_per_device": self.arena_bytes_per_device,
                "arena_messages_per_device": self.arena_messages_per_device,
                "arena_pages": float(self.arena_layout.n_pages),
                "arena_total_bytes": float(self.arena_layout.total_bytes),
                "arena_padding_fraction": self.arena_layout.padding_fraction,
            })
        return out

    def predicted_collective_seconds(self, model: LatencyModel = LatencyModel()
                                     ) -> float:
        """α·messages + bytes/bw for one reduction of this plan."""
        return model.collective_seconds(self.messages_per_device,
                                        self.bytes_per_device)

    def describe(self) -> dict:
        """JSON-friendly summary (the reference's keys)."""
        out = {
            "transport": self.transport,
            "axes": list(self.axes),
            "axis_sizes": list(self.axis_sizes),
            "world": self.world,
            "n_buckets": self.n_buckets,
            "total_elems": self.total_elems,
            "padding_waste": self.bucket_plan.padding_waste,
            "channels": [{"channel": a.channel, "buckets": list(a.buckets),
                          "elems": a.elems} for a in self.channels],
            **self.predicted_collective_bytes(),
        }
        if self.arena_layout is not None:
            out["arena"] = self.arena_layout.describe()
        return out
