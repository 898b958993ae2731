"""CommPlan: one object describing how a gradient tree moves.

Port of the gradient half of ``repro.comm.plan`` (plain Python; the numbers
equal the reference's): the bucket layout, the channel striping (which
bucket rides which virtual channel) and the predicted wire bytes and
messages per device, for the bucket path and for the page-aligned arena,
and under the int8 wire codec the compressed bytes and their price
(:meth:`CommPlan.codec_tradeoff`).  The recording wrapper of
:mod:`repro_torch.core.p2p` counts the same two quantities on the wire, so a
run can be held against its plan.  :class:`HaloPlan` is the same view of
one Cartesian halo exchange, and :class:`A2APlan` of one expert-parallel
dispatch and combine.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Sequence

from repro_torch.core.bucketing import BucketPlan

# The reference's α/β constants: a modelled per-message latency and link
# rate (its own napkin math, not a measurement of any card in this port).
ALPHA_S = 1.5e-6
LINK_BANDWIDTH = 50e9
# Device memory rate, bytes/s, that prices the codec's streaming kernels:
# the NVIDIA H100 SXM's published 3.35 TB/s (its data sheet).  The reference
# prices the TPU it targets instead; pass its rate to compare with it.
HBM_BANDWIDTH = 3.35e12


@dataclass(frozen=True)
class LatencyModel:
    """α/β cost model of one device's collective traffic:
    ``t = α · messages + bytes / bandwidth``."""

    alpha_s: float = ALPHA_S
    bandwidth: float = LINK_BANDWIDTH

    def collective_seconds(self, messages: float, nbytes: float) -> float:
        return self.alpha_s * float(messages) + float(nbytes) / self.bandwidth

    @classmethod
    def from_record(cls, record) -> "LatencyModel":
        """Measured constants from a tuning-DB record, a bare fit dict or a
        :class:`repro_torch.tune.fit.FitResult`."""
        if hasattr(record, "alpha_s"):          # FitResult (duck-typed)
            return cls(alpha_s=float(record.alpha_s),
                       bandwidth=float(record.bandwidth))
        fit = record.get("fit", record)         # DB record or raw fit dict
        return cls(alpha_s=float(fit["alpha_s"]),
                   bandwidth=float(fit["bandwidth"]))


def record_wire(record, axis_size: int) -> tuple[float, float]:
    """``(messages, wire_bytes)`` of a :class:`~repro_torch.core.p2p.
    CommRecord` (or its ``as_dict``) in the plans' units: a point-to-point
    send is one message of its bytes; the native collectives over an axis
    of ``axis_size`` ranks count as their ring equivalents, the units in
    which the transports predict (``2(p-1)`` messages and ``2(p-1)/p`` of
    the payload for an all-reduce; ``p-1`` messages for an all-gather, of
    ``p-1`` shards, a reduce-scatter, of ``(p-1)/p`` of its input, and an
    all-to-all, whose recorded bytes are already those that leave)."""
    r = record if isinstance(record, dict) else asdict(record)
    p = max(int(axis_size), 1)
    messages = (r["sends"] + 2 * (p - 1) * r["all_reduces"]
                + (p - 1) * (r["all_gathers"] + r["reduce_scatters"]
                             + r["all_to_alls"]))
    wire = (r["send_bytes"] + 2 * (p - 1) / p * r["all_reduce_bytes"]
            + (p - 1) * r["all_gather_bytes"]
            + (p - 1) / p * r["reduce_scatter_bytes"]
            + r["all_to_all_bytes"])
    return float(messages), float(wire)


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
    arena_layout: "object | None" = None     # ArenaLayout | QuantArenaLayout
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

    def bucket_channel(self, bucket: int) -> int:
        """The virtual channel bucket ``bucket`` rides."""
        for a in self.channels:
            if bucket in a.buckets:
                return a.channel
        raise KeyError(bucket)

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

    def codec_tradeoff(self, model: LatencyModel = LatencyModel(),
                       hbm_bandwidth: float = HBM_BANDWIDTH) -> dict:
        """Prices the quantized wire end to end: fp32 against int8+scales,

            t_fp32  = α·msgs + bytes_fp32 / bw_link
            t_codec = α·msgs + bytes_codec / bw_link + hbm_bytes / bw_hbm

        with the same message count on both sides (the codec shrinks hop
        payloads, not hop counts).  Kernel memory traffic per reduction, per
        element of ``w = 1 + 4/block`` wire bytes: the encode reads the fp32
        gradient and the error-feedback accumulator and writes the
        accumulator and the wire form (``4+4+4+w``); the decode reads the
        wire form and writes fp32 (``w+4``).

        Computed for this plan's codec, or as a what-if at ``codec_block``
        when ``wire_codec`` is ``None`` (``applied`` says which).  Arena
        plans price the arena wire bytes (page padding included).
        """
        arena = self.arena_layout is not None
        nbytes = (self.arena_bytes_per_device if arena
                  else self.bytes_per_device)
        msgs = (self.arena_messages_per_device if arena
                else self.messages_per_device)
        wpe_q = 1.0 + 4.0 / self.codec_block
        fp32_bytes = nbytes * 4.0 / self.wire_bytes_per_elem
        codec_bytes = (nbytes if self.wire_codec is not None
                       else fp32_bytes * wpe_q / 4.0)
        kernel_bytes = self.total_elems * ((4.0 + 4.0 + 4.0 + wpe_q)
                                           + (wpe_q + 4.0))
        kernel_s = kernel_bytes / hbm_bandwidth
        t_fp32 = model.collective_seconds(msgs, fp32_bytes)
        t_codec = model.collective_seconds(msgs, codec_bytes) + kernel_s
        return {
            "applied": self.wire_codec is not None,
            "codec": self.wire_codec or "int8",
            "codec_block": self.codec_block,
            "wire_bytes_fp32": fp32_bytes,
            "wire_bytes_codec": codec_bytes,
            "compression_ratio": (fp32_bytes / codec_bytes if codec_bytes
                                  else 0.0),
            "kernel_hbm_bytes": kernel_bytes,
            "t_kernel_s": kernel_s,
            "t_fp32_s": t_fp32,
            "t_codec_s": t_codec,
            "speedup": t_fp32 / t_codec if t_codec else 0.0,
        }

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
        if self.wire_codec is not None:
            out["wire_codec"] = self.wire_codec
            out["codec_block"] = self.codec_block
            out["codec"] = self.codec_tradeoff()
        return out


@dataclass(frozen=True)
class HaloChannel:
    """Units carried by one halo rail, with their payload *bytes* (unlike
    :class:`ChannelAssignment`, whose loads are element counts)."""

    channel: int
    units: tuple[int, ...]     # indices into the unit list, ascending
    bytes: int


@dataclass(frozen=True)
class HaloPlan:
    """The halo-exchange analogue of :class:`CommPlan`: bytes per direction
    x channel for one Cartesian exchange, plus the predicted wire bytes.

    ``units`` are the exchange's payloads (one per direction, times the
    chunk split under ``chunked``), labelled ``"<axis><dir>[#chunk]"``.
    Each crosses the wire once, so ``bytes_per_device`` is the payload
    total.  Like the reference's, the plan counts the units of an axis of
    one rank too, which the port wraps locally without a message: a
    :class:`~repro_torch.core.p2p.CommRecord` holds the units on axes of
    more than one rank.
    """

    schedule: str
    axes: tuple[str, ...]          # mesh axis per exchanged direction spec
    axis_sizes: tuple[int, ...]
    local_shape: tuple[int, ...]
    halos: tuple[int, ...]         # face width per spec
    unit_keys: tuple[str, ...]
    unit_bytes: tuple[int, ...]
    channels: tuple[HaloChannel, ...]
    overlap_fraction: float

    @property
    def n_units(self) -> int:
        return len(self.unit_bytes)

    @property
    def bytes_per_device(self) -> float:
        """Predicted wire bytes per device per exchange (one hop per unit)."""
        return float(sum(self.unit_bytes))

    @property
    def messages_per_device(self) -> float:
        """Each unit is one discrete send per device per exchange."""
        return float(self.n_units)

    def predicted_collective_seconds(self, model: LatencyModel = LatencyModel()
                                     ) -> float:
        """alpha * messages + bytes / bw for one halo exchange."""
        return model.collective_seconds(self.messages_per_device,
                                        self.bytes_per_device)

    @property
    def channel_imbalance(self) -> float:
        """max/mean channel load (1.0 = perfectly striped)."""
        loads = [a.bytes for a in self.channels]
        mean = sum(loads) / max(len(loads), 1)
        return max(loads) / mean if mean else 1.0

    def describe(self) -> dict:
        """JSON-friendly summary."""
        return {
            "schedule": self.schedule,
            "axes": list(self.axes),
            "axis_sizes": list(self.axis_sizes),
            "local_shape": list(self.local_shape),
            "halos": list(self.halos),
            "n_units": self.n_units,
            "units": [{"key": k, "bytes": b}
                      for k, b in zip(self.unit_keys, self.unit_bytes)],
            "channels": [{"channel": a.channel, "units": list(a.units),
                          "bytes": a.bytes} for a in self.channels],
            "bytes_per_device": self.bytes_per_device,
            "messages_per_device": self.messages_per_device,
            "channel_imbalance": self.channel_imbalance,
            "overlap_fraction": self.overlap_fraction,
        }


@dataclass(frozen=True)
class A2APlan:
    """The all-to-all analogue of :class:`CommPlan`: predicted wire cost of
    one expert-parallel dispatch + combine round-trip of a local capacity
    buffer of ``elems_per_device`` elements.

    ``units`` are the per-rail all-to-all payloads, ``dispatch#c`` /
    ``combine#c`` per rail, and ``unit_bytes[i]`` the *wire* bytes that
    rail puts in flight per exchange (already scaled by the transport:
    ``(R-1)/R`` of the payload for the ring and native all-to-alls,
    ``2(R-1)`` times it for the replicated-psum fallback).
    """

    transport: str
    axis: str
    axis_size: int
    elems_per_device: int          # local capacity-buffer elements, one phase
    itemsize: int
    unit_keys: tuple[str, ...]     # "dispatch#c" / "combine#c"
    unit_bytes: tuple[int, ...]
    messages_per_unit: float       # hops per rail exchange (R-1 or 2(R-1))
    channels: tuple[HaloChannel, ...]
    overlap_fraction: float

    @property
    def n_units(self) -> int:
        return len(self.unit_bytes)

    @property
    def bytes_per_device(self) -> float:
        """Predicted wire bytes per device per dispatch+combine round-trip."""
        return float(sum(self.unit_bytes))

    @property
    def messages_per_device(self) -> float:
        """Sends per device: the hop count per rail, summed over units."""
        return self.messages_per_unit * self.n_units

    @property
    def dispatch_bytes_per_device(self) -> float:
        """Wire bytes of the dispatch half alone."""
        return float(sum(b for k, b in zip(self.unit_keys, self.unit_bytes)
                         if k.startswith("dispatch")))

    def predicted_collective_seconds(self, model: LatencyModel = LatencyModel()
                                     ) -> float:
        """alpha * messages + bytes / bw for one dispatch+combine."""
        return model.collective_seconds(self.messages_per_device,
                                        self.bytes_per_device)

    @property
    def channel_imbalance(self) -> float:
        """max/mean channel load (1.0 = perfectly striped)."""
        loads = [a.bytes for a in self.channels]
        mean = sum(loads) / max(len(loads), 1)
        return max(loads) / mean if mean else 1.0

    def describe(self) -> dict:
        """JSON-friendly summary."""
        return {
            "transport": self.transport,
            "axis": self.axis,
            "axis_size": self.axis_size,
            "elems_per_device": self.elems_per_device,
            "itemsize": self.itemsize,
            "n_units": self.n_units,
            "units": [{"key": k, "bytes": b}
                      for k, b in zip(self.unit_keys, self.unit_bytes)],
            "channels": [{"channel": a.channel, "units": list(a.units),
                          "bytes": a.bytes} for a in self.channels],
            "bytes_per_device": self.bytes_per_device,
            "dispatch_bytes_per_device": self.dispatch_bytes_per_device,
            "messages_per_device": self.messages_per_device,
            "channel_imbalance": self.channel_imbalance,
            "overlap_fraction": self.overlap_fraction,
        }
