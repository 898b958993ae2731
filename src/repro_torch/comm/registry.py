"""Transport registry: named collective schedules with declared capabilities.

Port of ``repro.comm.registry``.  A transport is one way of moving a flat,
pre-padded bucket across the data axes; it registers under a short name
with a :class:`TransportSpec` of what it can do, so an invalid combination
fails when the :class:`~repro_torch.comm.api.Communicator` is built.

========================  ====================================================
``ring``                  flat multi-channel bidirectional ring per axis
``ring_hier``             pod-aware hierarchical ring (RS inner, recurse outer)
``psum``                  ``dist.all_reduce`` over the joint group (vendor
                          reference)
========================  ====================================================

A transport runs on one rail at a time: ``rails[c]`` holds the rings of
rail ``c``'s process groups (:class:`Rail`), and the rings the halo
exchange runs on along every mesh axis.  The ``a2a`` transport and
every ``all_to_all`` arrive with the MoE slice.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Mapping, Sequence, Type

import torch

from repro_torch.core import ring as ring_lib
from repro_torch.core.p2p import RingAxis
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
    other axes)."""

    axes: tuple[RingAxis, ...]
    joint: RingAxis
    halo: Mapping[str, RingAxis]


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


@register_transport(
    "ring", supports_rs=True, supports_codec=True, supports_a2a=True,
    description="flat multi-channel bidirectional ring; every byte crosses "
                "every axis at full size (pod-oblivious baseline)")
class RingTransport(Transport):
    """Flat ring: full-size ring all-reduce per data axis in turn."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        rings = tuple(reversed(self._rings(rail)))       # mesh order
        return ring_lib.flat_all_reduce(flat, rings, self.ring_cfg)

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
                "reference point); no explicit schedule, no RS/AG")
class PsumTransport(Transport):
    """``dist.all_reduce`` over the data axes' joint group."""

    def all_reduce(self, flat: torch.Tensor, rail: int = 0) -> torch.Tensor:
        if not self.rails:
            self._rings(rail)                 # raises: plan-only
        return self.rails[rail].joint.all_reduce(flat)

    def predicted_messages_per_device(self, axis_sizes: Sequence[int]
                                      ) -> float:
        # one fused op over the joint group: a ring-equivalent hop count
        # over the whole world, not one ring per axis
        world = 1
        for p in axis_sizes:
            world *= p
        return float(2 * (world - 1)) if world > 1 else 0.0
