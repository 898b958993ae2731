"""Ring and mesh topology helpers for the explicit collective schedules.

Port of ``repro.core.topology``.  The reference names mesh axes inside a
``shard_map``; here a :class:`RankMesh` lays the ranks of a
``torch.distributed`` world out on named axes (row-major, like a JAX mesh),
so every ring of :mod:`repro_torch.core.ring` draws its neighbours from one
table.  JAX's ``order_token`` has no counterpart: in the port, FIFO order
on a rail is the program order of the sends on that rail's process group.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Sequence

Axis = str


def ring_perm(size: int, direction: int = +1) -> list[tuple[int, int]]:
    """Permutation table sending rank ``i`` -> ``i + direction (mod size)``."""
    if direction not in (+1, -1):
        raise ValueError(f"ring direction must be +-1, got {direction}")
    return [(i, (i + direction) % size) for i in range(size)]


@dataclass(frozen=True)
class ChannelSpec:
    """One concurrent communication channel (paper: one comm thread).

    ``direction`` is the ring orientation; ``chunk`` indexes the payload
    slice this channel carries.
    """

    direction: int
    chunk: int


def channel_schedule(n_chunks: int, bidirectional: bool) -> list[ChannelSpec]:
    dirs = (+1, -1) if bidirectional else (+1,)
    return [ChannelSpec(d, c) for c in range(n_chunks) for d in dirs]


def padded_size(n: int, multiple: int) -> int:
    """Smallest ``m >= n`` with ``m % multiple == 0`` (lane/ring alignment)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return int(math.ceil(n / multiple) * multiple)


def reduce_axes_of(mesh_axis_names: Sequence[Axis],
                   data_axes: Sequence[Axis]) -> tuple[Axis, ...]:
    """The subset of ``data_axes`` actually present on the mesh,
    mesh-ordered."""
    present = [a for a in mesh_axis_names if a in set(data_axes)]
    return tuple(present)


@dataclass(frozen=True)
class RankMesh:
    """Ranks ``0 .. size-1`` laid out row-major on named axes, the port's
    stand-in for a JAX device mesh: rank ``r`` sits at the coordinates of
    ``r`` in a C-ordered array of ``shape``."""

    axis_names: tuple[str, ...]
    shape: tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.shape):
            raise ValueError(f"axis names {self.axis_names} do not match "
                             f"shape {self.shape}")
        if any(n < 1 for n in self.shape):
            raise ValueError(f"mesh shape must be positive, got {self.shape}")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    def sizes(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.shape))

    def coords(self, rank: int) -> tuple[int, ...]:
        out = []
        for n in reversed(self.shape):
            out.append(rank % n)
            rank //= n
        return tuple(reversed(out))

    def rank_of(self, coords: Sequence[int]) -> int:
        r = 0
        for c, n in zip(coords, self.shape):
            r = r * n + c
        return r

    def groups(self, axes: Sequence[Axis]) -> list[list[int]]:
        """Every group of ranks that differ only along ``axes`` (each group
        ordered by its joint index over ``axes``, mesh-ordered), in one
        fixed order: what every rank must create its process groups in."""
        dims = [self.axis_names.index(a) for a in axes]
        rest = [d for d in range(len(self.shape)) if d not in dims]
        out = []
        for fixed in itertools.product(*(range(self.shape[d]) for d in rest)):
            members = []
            for moving in itertools.product(*(range(self.shape[d])
                                              for d in sorted(dims))):
                c = [0] * len(self.shape)
                for d, v in zip(rest, fixed):
                    c[d] = v
                for d, v in zip(sorted(dims), moving):
                    c[d] = v
                members.append(self.rank_of(c))
            out.append(members)
        return out
