"""Transport registry: named collective schedules with declared capabilities.

Port of ``repro.comm.registry``.  A transport is one way of moving a flat,
pre-padded bucket across the data axes; it registers under a short name
with a :class:`TransportSpec` of what it can do, so an invalid combination
fails when the :class:`~repro_torch.comm.api.Communicator` is built.

========================  ====================================================
``ring``                  flat multi-channel bidirectional ring per axis
``ring_hier``             pod-aware hierarchical ring (RS inner, recurse outer)
``psum``                  ``dist.all_reduce`` over the joint group (vendor
                          reference); its all-to-all is the replicated
                          emulation (the whole exchange matrix all-reduced)
``a2a``                   ``dist.all_to_all_single`` (the vendor all-to-all,
                          one call an exchange); its all-reduce the joint
                          group's
========================  ====================================================

A transport runs on one rail at a time: ``rails[c]`` holds the rings of
rail ``c``'s process groups (:class:`Rail`), and the rings the halo
exchange runs on along every mesh axis.  :meth:`Transport.all_to_all` is
the expert-parallel exchange over a communicator of one axis: the ring
transports hop ``p - 1`` times (:func:`~repro_torch.core.ring.ring_all_to_all`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence, Type

import torch

from repro_torch.core import ring as ring_lib
from repro_torch.core.p2p import RingAxis, concat_blocks, split_blocks
from repro_torch.core.ring import RingConfig

WIRE_DTYPES_ANY = (None, "bfloat16", "float16", "float32")


@dataclass(frozen=True)
class TransportSpec:
    """Construction-time capability declaration of one transport."""

    name: str
    supports_rs: bool                      # reduce_scatter / all_gather pairs
    supports_codec: bool                   # lossy block codec on the wire
    wire_dtypes: tuple[str | None, ...]    # allowed narrow wire dtypes
    codec: str | None                      # codec this transport always uses
    hierarchical: bool                     # pod-aware byte accounting
    supports_a2a: bool                     # all_to_all (EP dispatch/combine)
    description: str


_TRANSPORTS: dict[str, tuple[TransportSpec, Type["Transport"]]] = {}


def register_transport(name: str, *, supports_rs: bool,
                       supports_codec: bool = False,
                       wire_dtypes: tuple[str | None, ...] = WIRE_DTYPES_ANY,
                       codec: str | None = None,
                       hierarchical: bool = False,
                       supports_a2a: bool = False,
                       description: str = "") -> Callable[[type], type]:
    """Class decorator registering a :class:`Transport` under ``name``."""

    def deco(cls: type) -> type:
        if name in _TRANSPORTS:
            raise ValueError(f"transport {name!r} already registered")
        spec = TransportSpec(name=name, supports_rs=supports_rs,
                             supports_codec=supports_codec,
                             wire_dtypes=wire_dtypes, codec=codec,
                             hierarchical=hierarchical,
                             supports_a2a=supports_a2a,
                             description=description
                             or (cls.__doc__ or "").strip())
        _TRANSPORTS[name] = (spec, cls)
        cls.spec = spec
        return cls

    return deco


def get_transport(name: str) -> tuple[TransportSpec, Type["Transport"]]:
    """Lookup; raises with the full menu on an unknown name."""
    try:
        return _TRANSPORTS[name]
    except KeyError:
        raise ValueError(
            f"unknown transport {name!r}; registered transports: "
            f"{tuple(sorted(_TRANSPORTS))}") from None


def list_transports() -> tuple[str, ...]:
    return tuple(sorted(_TRANSPORTS))


def transport_specs() -> dict[str, TransportSpec]:
    return {name: spec for name, (spec, _) in _TRANSPORTS.items()}


@dataclass(frozen=True)
class Rail:
    """One rail's process groups: a ring per data axis (mesh order), the
    joint group over all of them, and the halo exchange's ring along every
    mesh axis (the data axes' own rings, and rings of their own for the
    other axes); and, on a machine with a card and at ``channels >= 2``,
    the CUDA stream its collectives run on (:mod:`repro_torch.comm.rails`;
    ``None`` otherwise)."""

    axes: tuple[RingAxis, ...]
    joint: RingAxis
    halo: Mapping[str, RingAxis]
    stream: "torch.cuda.Stream | None" = None


class Transport:
    """One collective schedule over the data axes, on flat 1-D buffers
    already padded to :meth:`flat_divisor`.  ``axes`` is mesh-ordered
    (outermost first); schedules that care about locality reverse it."""

    spec: TransportSpec  # filled in by @register_transport

    def __init__(self, axes: Sequence[str], ring_cfg: RingConfig,
                 rails: Sequence[Rail] = ()):
        self.axes = tuple(axes)
        self.ring_cfg = ring_cfg
        self.rails = tuple(rails)

    @property
    def ordered_axes(self) -> tuple[str, ...]:
        """Inner (fastest / intra-pod) axis first: RS ownership order."""
        return tuple(reversed(self.axes))

    def _rings(self, rail: int) -> tuple[RingAxis, ...]:
        """The rail's rings in :attr:`ordered_axes` order."""
        if not self.rails:
            raise RuntimeError("this communicator only plans: it was built "
                               "without process groups (connect=False)")
        return tuple(reversed(self.rails[rail].axes))

    def _joint(self, rail: int) -> RingAxis:
        """The rail's joint group over every comm axis."""
        if not self.rails:
            self._rings(rail)                 # raises: plan-only
        return self.rails[rail].joint

    def flat_divisor(self, axis_sizes: Sequence[int]) -> int:
        return self.ring_cfg.flat_divisor(axis_sizes)

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        raise NotImplementedError

    def reduce_scatter(self, flat: torch.Tensor,
                       rail: int = 0) -> torch.Tensor:
        raise NotImplementedError(
            f"transport {self.spec.name!r} does not support reduce-scatter")

    def all_gather(self, shard: torch.Tensor, rail: int = 0) -> torch.Tensor:
        raise NotImplementedError(
            f"transport {self.spec.name!r} does not support all-gather")

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                   rail: int = 0) -> torch.Tensor:
        """Tiled all-to-all over the single comm axis (EP dispatch and
        combine)."""
        raise NotImplementedError(
            f"transport {self.spec.name!r} does not support all-to-all")

    # -- analysis -----------------------------------------------------------

    def predicted_bytes_per_device(self, n_elems: int,
                                   axis_sizes: Sequence[int]) -> float:
        """Wire bytes per device for one all-reduce of ``n_elems``."""
        codec = self.ring_cfg.make_codec()
        wire_per_elem = codec.wire_bytes(max(n_elems, 1)) / max(n_elems, 1)
        if self.spec.hierarchical and len(axis_sizes) > 0:
            inner_p = axis_sizes[-1]
            world = 1
            for p in axis_sizes:
                world *= p
            outer = world // max(inner_p, 1)
            inner_bytes = (2 * (inner_p - 1) / max(inner_p, 1) * n_elems
                           * wire_per_elem)
            outer_bytes = (2 * (outer - 1) / outer * (n_elems / inner_p)
                           * wire_per_elem if outer > 1 else 0.0)
            return inner_bytes + outer_bytes
        total = 0.0
        for p in axis_sizes:
            total += 2 * (p - 1) / max(p, 1) * n_elems * wire_per_elem
        return total

    def predicted_messages_per_device(self, axis_sizes: Sequence[int]
                                      ) -> float:
        """Discrete sends per device for one all-reduce of one bucket:
        ``(p-1)`` reduce-scatter plus ``(p-1)`` all-gather hops per axis."""
        return float(sum(2 * (p - 1) for p in axis_sizes))

    def predicted_a2a_bytes_per_device(self, n_elems: int, axis_size: int,
                                       itemsize: int = 4) -> float:
        """Wire bytes per device for one all-to-all of a local ``n_elems``
        payload: ``(p-1)/p`` of it leaves the device (its own block
        stays)."""
        p = max(int(axis_size), 1)
        return (p - 1) / p * n_elems * itemsize

    def predicted_a2a_messages_per_device(self, axis_size: int) -> float:
        """Sends per device for one all-to-all: ``p - 1`` pairwise hops."""
        return float(max(int(axis_size) - 1, 0))


@register_transport(
    "ring", supports_rs=True, supports_codec=True, supports_a2a=True,
    description="flat multi-channel bidirectional ring; every byte crosses "
                "every axis at full size (pod-oblivious baseline)")
class RingTransport(Transport):
    """Flat ring: full-size ring all-reduce per data axis in turn."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        rings = tuple(reversed(self._rings(rail)))       # mesh order
        return ring_lib.flat_all_reduce(flat, rings, self.ring_cfg)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                   rail: int = 0) -> torch.Tensor:
        return ring_lib.ring_all_to_all(x, self._rings(rail)[0], split_axis,
                                        concat_axis)

    def predicted_messages_per_device(self, axis_sizes: Sequence[int]
                                      ) -> float:
        mult = self.ring_cfg.chunks * (2 if self.ring_cfg.bidirectional
                                       else 1)
        return super().predicted_messages_per_device(axis_sizes) * mult

    def reduce_scatter(self, flat: torch.Tensor,
                       rail: int = 0) -> torch.Tensor:
        for ring in self._rings(rail):
            flat = ring_lib.ring_reduce_scatter(flat, ring, self.ring_cfg)
        return flat

    def all_gather(self, shard: torch.Tensor, rail: int = 0) -> torch.Tensor:
        for ring in reversed(self._rings(rail)):
            shard = ring_lib.ring_all_gather(shard, ring, self.ring_cfg)
        return shard


@register_transport(
    "ring_hier", supports_rs=True, supports_codec=True, hierarchical=True,
    supports_a2a=True,
    description="pod-aware hierarchical ring: reduce-scatter the intra-pod "
                "axis first so cross-pod bytes shrink by the pod size")
class HierRingTransport(RingTransport):
    """Hierarchical ring (the paper's optimised schedule; default)."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        return ring_lib.hierarchical_all_reduce(flat, self._rings(rail),
                                                self.ring_cfg)


@register_transport(
    "psum", supports_rs=False, wire_dtypes=(None,), supports_a2a=True,
    description="dist.all_reduce over the joint data group (vendor "
                "reference point); no explicit schedule, no RS/AG; "
                "all_to_all is the honest replicated fallback (full-matrix "
                "all-reduce)")
class PsumTransport(Transport):
    """``dist.all_reduce`` over the data axes' joint group."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        return self._joint(rail).all_reduce(flat)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                   rail: int = 0) -> torch.Tensor:
        """Replicated emulation, the pre-all-to-all MoE dispatch: each rank
        writes its row of the (source, destination) exchange matrix into a
        zero-padded ``(p, p, ...)`` buffer, the whole matrix is all-reduced
        and each rank slices its own column.  Every byte of the matrix
        crosses the wire; kept so the A/B cost is measurable."""
        joint = self._joint(rail)
        p, i = joint.size, joint.index
        if p == 1:
            return x
        blocks = split_blocks(x, p, split_axis)           # (p_dst, ...)
        full = blocks.new_zeros((p,) + tuple(blocks.shape))
        full[i] = blocks
        full = joint.all_reduce(full)                     # (p_src, p_dst, ...)
        return concat_blocks(full[:, i], concat_axis)

    def predicted_messages_per_device(self, axis_sizes: Sequence[int]
                                      ) -> float:
        # one fused op over the joint group: a ring-equivalent hop count
        # over the whole world, not one ring per axis
        world = 1
        for p in axis_sizes:
            world *= p
        return float(2 * (world - 1)) if world > 1 else 0.0

    def predicted_a2a_bytes_per_device(self, n_elems: int, axis_size: int,
                                       itemsize: int = 4) -> float:
        # the full (p, n) exchange matrix is all-reduced: 2(p-1)/p of
        # p*n elements per device
        p = max(int(axis_size), 1)
        return 2 * (p - 1) * n_elems * itemsize

    def predicted_a2a_messages_per_device(self, axis_size: int) -> float:
        p = max(int(axis_size), 1)
        return float(2 * (p - 1))


@register_transport(
    "a2a", supports_rs=False, wire_dtypes=(None,), supports_a2a=True,
    description="dist.all_to_all_single (one vendor all-to-all per "
                "exchange); all_reduce over the joint group")
class NativeA2ATransport(Transport):
    """The vendor all-to-all, the reference's ``lax.all_to_all``."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        return self._joint(rail).all_reduce(flat)

    def all_to_all(self, x: torch.Tensor, split_axis: int, concat_axis: int,
                   rail: int = 0) -> torch.Tensor:
        return self._rings(rail)[0].all_to_all(x, split_axis, concat_axis)
