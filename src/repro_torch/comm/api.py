"""The Communicator: the gradient collectives behind one object.

Port of ``repro.comm.api`` for the data-parallel gradient path.  Built once
from ``(mesh, CommConfig)``, a :class:`Communicator` owns

* the **transport** — a registered schedule (:mod:`repro_torch.comm.registry`)
  whose capabilities are checked here, at construction;
* the **bucketer** — fused, alignment-guaranteed flat buffers
  (:mod:`repro_torch.core.bucketing`);
* the **rails** — ``cfg.channels`` independent virtual channels.  Each rail
  is its own set of process groups; buckets striped onto a rail issue on it
  in FIFO order (the reference threads order tokens through XLA).  At
  ``channels >= 2`` each rail's collectives run on a host thread and, on
  the card, a CUDA stream of the rail's own, all rails at once
  (:mod:`repro_torch.comm.rails`); ``channels == 1`` runs them in program
  order on the caller's thread and stream, and ``channels == 0`` leaves
  every bucket an independent collective on that one rail.
* the **record** — a :class:`~repro_torch.core.p2p.CommRecord` of every
  message and byte this rank sent, to hold a step against :meth:`plan`.

Under ``wire_codec="int8"`` ring hops carry int8 payloads, the arena is the
int8 :class:`~repro_torch.mem.arena.QuantCommArena` and gradients are
compensated with error feedback (:meth:`Communicator.reduce_scheduled`,
:meth:`Communicator.all_reduce_tree`).  ZeRO-1 reduce-scatters into
flat shards and all-gathers them back (:meth:`Communicator.reduce_scatter_tree`,
:meth:`Communicator.all_gather_buckets`).  FSDP gathers each flat weight
shard and sums its gradient back into the shard with
:meth:`Communicator.gather_flat`.  The Cartesian halo exchange shares the
rails (:meth:`Communicator.halo_exchange`, :meth:`halo_plan`,
:meth:`halo_schedule`).  A communicator over one axis (the model axis)
runs the expert-parallel all-to-all on the same rails
(:meth:`Communicator.all_to_all`, :meth:`a2a_plan`, :meth:`moe_schedule`).
Collectives are eager; they run in the caller's process on its rank, over
the world ``torch.distributed`` was initialised with.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass
from typing import TYPE_CHECKING, Callable, Sequence

import torch
import torch.distributed as dist

from repro_torch import tree as tree_util
from repro_torch.comm.plan import (A2APlan, ChannelAssignment, CommPlan,
                                   HaloChannel, HaloPlan, assign_channels)
from repro_torch.comm.rails import Call, RailExecutor, new_rail_stream
from repro_torch.comm.registry import Rail, Transport, get_transport
from repro_torch.comm.schedule import (CommSchedule, build_halo_schedule,
                                       build_moe_schedule, build_schedule,
                                       halo_units)
from repro_torch.comm.wire_codec import ErrorFeedback
from repro_torch.core.bucketing import BucketPlan, GradientBucketer
from repro_torch.core.halo import HaloSpec
from repro_torch.core.halo import halo_exchange as _halo_exchange
from repro_torch.core.p2p import (CommRecord, axis_rings,
                                  differentiable_all_to_all, joint_ring)
from repro_torch.core.ring import LOCAL_OPS, RingConfig
from repro_torch.core.topology import RankMesh, reduce_axes_of
from repro_torch.fake import fake_mode_active

if TYPE_CHECKING:  # repro_torch.mem imports comm.schedule: import it lazily
    from repro_torch.mem.arena import CommArena, QuantCommArena
    from repro_torch.mem.layout import ArenaLayout, QuantArenaLayout


@dataclass(frozen=True)
class CommConfig:
    """Static description of the communication substrate (the reference's
    fields; ``local_op`` names the port's two local-op implementations)."""

    transport: str = "ring_hier"
    data_axes: tuple[str, ...] = ("pod", "data")
    bucket_bytes: int = 4 * 2**20
    page_bytes: int = 2 * 2**20    # arena quantization granule (huge page)
    channels: int = 0              # 0 = unconstrained; N = N guaranteed rails
    chunks: int = 2                # per-segment ring chains
    bidirectional: bool = True
    wire_dtype: str | None = None
    wire_codec: str | None = None  # "int8": quantized wire + arena codec
    codec_block: int = 512
    local_op: str = "kernel"       # "kernel" (CUDA kernels) | "plain"
    mean: bool = True
    fuse: bool = True              # False: per-tensor collectives, no buckets

    def ring_config(self, codec: str | None = None) -> RingConfig:
        return RingConfig(chunks=self.chunks, bidirectional=self.bidirectional,
                          wire_dtype=self.wire_dtype, local_op=self.local_op,
                          codec=codec, codec_block=self.codec_block)


GradFn = Callable[[dict, dict], "tuple[torch.Tensor, dict]"]


def _device(buffers: Sequence[torch.Tensor]) -> torch.device | None:
    return buffers[0].device if buffers else None


class _GatherFlat(torch.autograd.Function):
    """:meth:`Communicator.gather_flat` with its transpose as backward."""

    @staticmethod
    def forward(ctx, shard, comm, native):
        ctx.comm, ctx.native = comm, native
        return comm._gather(shard, native)

    @staticmethod
    def backward(ctx, grad):
        return ctx.comm._scatter(grad.contiguous(), ctx.native), None, None


class Communicator:
    """Channelized collectives over the data axes of ``mesh``.

    ``connect=False`` builds a communicator that only plans (no process
    groups: :meth:`plan`, :meth:`arena_layout`, :meth:`schedule` work, the
    collectives raise).  Otherwise every rank of the world must build its
    communicators in the same order, since creating groups is collective.
    """

    def __init__(self, mesh: RankMesh, cfg: CommConfig = CommConfig(), *,
                 connect: bool = True):
        spec, cls = get_transport(cfg.transport)   # unknown -> ValueError
        if cfg.wire_dtype not in spec.wire_dtypes:
            raise ValueError(
                f"transport {cfg.transport!r} does not support "
                f"wire_dtype={cfg.wire_dtype!r} (allowed: {spec.wire_dtypes})")
        if cfg.channels < 0:
            raise ValueError(f"channels must be >= 0, got {cfg.channels}")
        if cfg.chunks < 1:
            raise ValueError(f"chunks must be >= 1, got {cfg.chunks}")
        if not cfg.fuse and spec.supports_rs:
            raise ValueError(
                f"transport {cfg.transport!r} requires fused aligned buckets "
                f"(fuse=True); only native transports support fuse=False")
        if cfg.local_op not in LOCAL_OPS:
            raise ValueError(f"local_op must be one of {LOCAL_OPS}, got "
                             f"{cfg.local_op!r}")
        codec = cfg.wire_codec if cfg.wire_codec is not None else spec.codec
        if codec not in (None, "int8"):
            raise ValueError(f"unknown wire_codec {codec!r} "
                             f"(supported: 'int8')")
        if cfg.wire_codec is not None and cfg.wire_dtype is not None:
            raise ValueError("wire_codec and wire_dtype are exclusive wire "
                             "formats; set at most one")
        self.mesh = mesh
        self.cfg = cfg
        self.spec = spec
        self.codec = codec
        self.axes = reduce_axes_of(mesh.axis_names, cfg.data_axes)
        sizes = mesh.sizes()
        self.axis_sizes = tuple(sizes[a] for a in self.axes)
        self.world = math.prod(self.axis_sizes)
        self._ring_cfg = cfg.ring_config(
            codec=codec if spec.supports_codec else None)
        self.record = CommRecord()
        # this process's rank in the world (its place in ``mesh``)
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        rails: list[Rail] = []
        if connect:
            rank = self.rank
            others = [a for a in mesh.axis_names if a not in self.axes]
            # groups are made in one fixed order on every rank: rail by
            # rail, the data axes, their joint group, then the other axes
            concurrent = cfg.channels >= 2
            for _ in range(max(cfg.channels, 1)):
                axes = tuple(axis_rings(mesh, rank, self.axes, self.record))
                joint = joint_ring(mesh, rank, self.axes, self.record)
                halo = dict(zip(self.axes, axes))
                halo.update(zip(others, axis_rings(mesh, rank, others,
                                                   self.record)))
                rails.append(Rail(axes=axes, joint=joint, halo=halo,
                                  stream=(new_rail_stream() if concurrent
                                          else None)))
        self.transport: Transport = cls(self.axes, self._ring_cfg,
                                        tuple(rails))
        # the rails' threads (made at first use) and streams
        self._executor = (RailExecutor([r.stream for r in rails])
                          if len(rails) >= 2 else None)
        pad = self.transport.flat_divisor(self.axis_sizes)
        if codec is not None:
            # quantized segments hold whole codec blocks even when the
            # transport's own divisor (e.g. psum) does not include them
            pad = math.lcm(pad, cfg.codec_block)
        self.bucketer = GradientBucketer(bucket_bytes=cfg.bucket_bytes,
                                         pad_multiple=pad)
        self._ef = (ErrorFeedback(self._ring_cfg.make_codec())
                    if self._ring_cfg.codec is not None else None)

    # -- layout / planning ---------------------------------------------------

    @property
    def ordered_axes(self) -> tuple[str, ...]:
        """Innermost (fastest / intra-pod) axis first."""
        return self.transport.ordered_axes

    def stripe(self, bucket_sizes: Sequence[int]
               ) -> tuple[ChannelAssignment, ...]:
        """Partition a bucket list across the virtual channels (every bucket
        its own channel when ``channels == 0``)."""
        n = (self.cfg.channels if self.cfg.channels >= 1
             else max(len(bucket_sizes), 1))
        return assign_channels(bucket_sizes, n)

    def plan(self, tree) -> CommPlan:
        """The communication plan of one gradient-shaped tree (leaves need
        only ``shape`` and ``dtype``), with its arena layout."""
        bplan = self.bucketer.plan(tree)
        chans = self.stripe(bplan.bucket_sizes)
        n = max(bplan.used_elems, 1)
        wire_per_elem = self._ring_cfg.make_codec().wire_bytes(n) / n
        bytes_dev = self.transport.predicted_bytes_per_device(
            bplan.used_elems, self.axis_sizes)
        msgs_per_unit = self.transport.predicted_messages_per_device(
            self.axis_sizes)
        layout = self.arena_layout(tree, warn=False, _chans=chans)
        # a quantized arena moves its (padded) payload at the codec's bytes
        # per element; its scale segment never travels as a unit (scales
        # ride each hop's payload, or stay local under an fp32 transport)
        wire_elems = getattr(layout, "payload_elems", layout.total_elems)
        arena_bytes = self.transport.predicted_bytes_per_device(
            wire_elems, self.axis_sizes)
        return CommPlan(transport=self.cfg.transport, axes=self.axes,
                        axis_sizes=self.axis_sizes, bucket_plan=bplan,
                        channels=chans, wire_bytes_per_elem=wire_per_elem,
                        bytes_per_device=bytes_dev,
                        messages_per_device=msgs_per_unit * bplan.n_buckets,
                        arena_layout=layout,
                        arena_bytes_per_device=arena_bytes,
                        arena_messages_per_device=(msgs_per_unit
                                                   * layout.n_spans),
                        wire_codec=self.codec,
                        codec_block=self.cfg.codec_block)

    def arena_layout(self, tree, *, warn: bool = True,
                     _chans: tuple[ChannelAssignment, ...] | None = None
                     ) -> "ArenaLayout | QuantArenaLayout":
        """The page-quantized arena placement of ``tree``'s buckets:
        offsets quantized to ``cfg.page_bytes`` (lcm'd with the transport's
        flat divisor so spans stay reduce-scatter legal), one contiguous
        span per virtual channel.  Under a wire codec it is the int8
        :class:`~repro_torch.mem.layout.QuantArenaLayout` (payload and
        trailing scale segment)."""
        from repro_torch.mem.layout import (arena_from_bucket_plan,
                                            quant_arena_from_bucket_plan)

        bplan = self.bucketer.plan(tree)
        chans = (_chans if _chans is not None
                 else self.stripe(bplan.bucket_sizes))
        chan_of = [0] * bplan.n_buckets
        for a in chans:
            for b in a.buckets:
                chan_of[b] = a.channel
        if self.codec is not None:
            return quant_arena_from_bucket_plan(
                bplan, page_bytes=self.cfg.page_bytes,
                block=self.cfg.codec_block, channel_of=chan_of,
                pad_multiple=self.bucketer.pad_multiple,
                bucket_bytes=self.cfg.bucket_bytes, warn_oversized=warn)
        return arena_from_bucket_plan(
            bplan, page_bytes=self.cfg.page_bytes, channel_of=chan_of,
            pad_multiple=self.bucketer.pad_multiple,
            bucket_bytes=self.cfg.bucket_bytes, warn_oversized=warn)

    def arena(self, tree) -> "CommArena | QuantCommArena":
        """A :class:`~repro_torch.mem.arena.CommArena` (a
        :class:`~repro_torch.mem.arena.QuantCommArena` under a wire codec)
        over :meth:`arena_layout`; its kernels follow ``cfg.local_op``, the
        knob that also selects the ring's local add and hop codec."""
        from repro_torch.mem.arena import CommArena, QuantCommArena

        if self.codec is not None:
            return QuantCommArena(self.arena_layout(tree),
                                  impl=self.cfg.local_op)
        return CommArena(self.arena_layout(tree), impl=self.cfg.local_op)

    # -- channelized execution ----------------------------------------------

    def _on_rails(self, calls: Sequence[Call], device) -> list:
        """``fn()`` for every ``(rail, fn)`` of ``calls``, each rail's in
        their order: at ``channels >= 2`` on the rails' own threads and
        streams, all rails at once (:class:`RailExecutor`), else here, in
        order.  Under a fake-tensor mode (the dry-run, which the rails'
        threads would not see) always here, in order.  Results in the order
        of ``calls``."""
        if self._executor is None or fake_mode_active():
            return [fn() for _, fn in calls]
        return self._executor.run(calls, device)

    def _run_striped(self, op, items: list) -> list:
        """``op(buffer, rail)`` on every flat buffer, each rail's buffers in
        FIFO order on that rail."""
        if self.cfg.channels < 1:
            return [op(x, 0) for x in items]
        order = [(a.channel, i)
                 for a in self.stripe([int(x.shape[0]) for x in items])
                 for i in a.buckets]
        done = self._on_rails([(c, functools.partial(op, items[i], c))
                               for c, i in order], _device(items))
        out: list = [None] * len(items)
        for (_, i), r in zip(order, done):
            out[i] = r
        return out

    def _run_slots(self, schedule: CommSchedule, phase: int, fn,
                   n: int, device) -> list:
        """``fn(unit, rail)`` for every unit of ``schedule``'s slots of
        ``phase``, each rail's in slot order, the rails together
        (:meth:`_on_rails`) and joined at the phase's end.  Returns the
        results by unit, ``None`` for the ``n`` units of other phases."""
        chained = schedule.channels >= 1
        units = [(slot.channel if chained else 0, u)
                 for slot in schedule.slots_for_phase(phase)
                 for u in slot.bucket_ids]
        done = self._on_rails([(rail, functools.partial(fn, u, rail))
                               for rail, u in units], device)
        out: list = [None] * n
        for (_, u), r in zip(units, done):
            out[u] = r
        return out

    def all_reduce(self, buckets: list) -> list:
        """Sum each flat bucket over the data axes (no mean)."""
        return self._run_striped(self.transport.all_reduce, buckets)

    def _require_rs(self, what: str) -> None:
        if not self.spec.supports_rs:
            raise ValueError(
                f"transport {self.cfg.transport!r} does not support "
                f"{what} (supports_rs=False)")

    def reduce_scatter(self, buckets: list) -> list:
        """Sum-and-shard each flat bucket (inner axis segments first)."""
        self._require_rs("reduce-scatter")
        return self._run_striped(self.transport.reduce_scatter, buckets)

    def all_gather(self, shards: list) -> list:
        """Inverse of :meth:`reduce_scatter` (same ownership layout)."""
        self._require_rs("all-gather")
        return self._run_striped(self.transport.all_gather, shards)

    def gather_flat(self, shard: torch.Tensor, *,
                    native: bool = False) -> torch.Tensor:
        """All-gather of one flat shard over the data axes (the FSDP weight
        path), differentiable: its backward is the sum-and-shard of the
        cotangent, as the reference's autodiff transpose of the gather.

        ``native=True``: ``dist.all_gather_into_tensor`` over each data
        axis's group, outermost first; backward ``dist.reduce_scatter_tensor``
        innermost first, summing in the cotangent's dtype (the reference's
        ``lax.all_gather`` and its transpose ``psum_scatter``).  Otherwise
        the transport's ring all-gather; backward its ring reduce-scatter,
        whose hops add in fp32 with the ``reduce_add`` kernel on CUDA
        tensors and whose sum is rounded once to the cotangent's dtype.
        The reference's transpose of its unrolled ring adds hop by hop in
        the cotangent's dtype: for a bf16 gather the two are the same sum
        at two ranks (one add, one rounding) and can differ in the last
        bf16 place from three ranks on, where the reference rounds each
        partial sum and the port only the last."""
        return _GatherFlat.apply(shard, self, native)

    def _gather(self, shard: torch.Tensor, native: bool) -> torch.Tensor:
        if native:
            for ring in self.transport.rails[0].axes:    # outermost first
                shard = ring.all_gather(shard)
            return shard
        self._require_rs("all-gather")
        return self.transport.all_gather(shard)

    def _scatter(self, full: torch.Tensor, native: bool) -> torch.Tensor:
        if native:
            for ring in reversed(self.transport.rails[0].axes):
                full = ring.reduce_scatter(full)
            return full
        return self.transport.reduce_scatter(full).to(full.dtype)

    def _mean_buckets(self, buckets: list) -> list:
        if not self.cfg.mean:
            return buckets
        return [b * (1.0 / self.world) for b in buckets]

    def all_reduce_tree(self, grads, ef_state: list | None = None):
        """All-reduce(-mean) a local gradient tree.  Returns
        ``(reduced, new_ef_state)``: under a lossy hop codec, ``ef_state``
        (one fp32 residual per bucket, :meth:`ErrorFeedback.init`) is
        compensated into the buckets first and the new residuals come back;
        otherwise it passes through."""
        if not self.axes:
            return grads, ef_state
        if not self.cfg.fuse:
            leaves, treedef = tree_util.flatten(grads)
            red = [self.transport.all_reduce(x.reshape(-1)).view(x.shape)
                   for x in leaves]
            if self.cfg.mean:
                red = [(x.float() * (1.0 / self.world)).to(x.dtype)
                       for x in red]
            return treedef.unflatten(red), ef_state
        buckets, bplan = self.bucketer.bucketize(grads)
        new_res = ef_state
        if self._ef is not None and ef_state is not None:
            buckets, new_res = self._ef.compensate(buckets, list(ef_state))
        reduced = self._mean_buckets(self.all_reduce(buckets))
        return self.bucketer.debucketize(reduced, bplan), new_res

    def reduce_scatter_tree(self, grads):
        """Reduce-scatter(-mean) a local gradient tree into flat bucket
        shards (the ZeRO path).  Returns ``(shards, bucket_plan)``; invert
        with :meth:`all_gather_buckets`."""
        buckets, bplan = self.bucketer.bucketize(grads)
        return self._mean_buckets(self.reduce_scatter(buckets)), bplan

    def all_gather_buckets(self, shards: list,
                           bplan: BucketPlan | None = None):
        """Inverse of :meth:`reduce_scatter_tree`: the full buckets, or the
        debucketized tree when ``bplan`` is given."""
        full = self.all_gather(shards)
        return full if bplan is None else self.bucketer.debucketize(full,
                                                                    bplan)

    def init_ef_state(self, grads_like, specs=None) -> list | None:
        """Zero residual buckets (fp32) for this rank's local tree, one per
        bucket, on its leaves' device (``grads_like``'s leaves need only
        ``shape`` and ``dtype``; the CPU when they are not tensors); the
        ``ef_state`` of :meth:`all_reduce_tree`.  ``None`` when the
        transport is lossless.  ``specs`` is the reference's and unused: the
        port has no SPMD level."""
        if self._ef is None:
            return None
        leaves = tree_util.leaves(grads_like)
        device = (leaves[0].device if leaves
                  and isinstance(leaves[0], torch.Tensor) else None)
        return [torch.zeros((n,), dtype=torch.float32, device=device)
                for n in self.bucketer.plan(grads_like).bucket_sizes]

    def predicted_collective_bytes(self, grads_like) -> dict[str, float]:
        """Napkin-math wire bytes per device (reads the :class:`CommPlan`)."""
        return self.plan(grads_like).predicted_collective_bytes()

    # -- Cartesian halo exchange ---------------------------------------------

    @property
    def halo_chunks(self) -> int:
        """Pieces each face splits into under the ``chunked`` schedule:
        the channel knob when set, else 4 (the paper's threaded default)."""
        return self.cfg.channels if self.cfg.channels >= 1 else 4

    def _halo_schedule_name(self, schedule: str | None) -> str:
        return schedule if schedule is not None else (
            "chunked" if self.cfg.channels >= 2 else "concurrent")

    def halo_rings(self) -> tuple:
        """Each rail's rings along every mesh axis, ``rings[c][axis]``: what
        :func:`repro_torch.core.halo.halo_exchange` runs on."""
        if not self.transport.rails:
            raise RuntimeError("this communicator only plans: it was built "
                               "without process groups (connect=False)")
        return tuple(rail.halo for rail in self.transport.rails)

    def halo_exchange(self, x: torch.Tensor, specs: Sequence[HaloSpec], *,
                      schedule: str | None = None) -> dict:
        """Cartesian halo exchange sharing the communicator's channel knob:
        under ``chunked`` every face splits into :attr:`halo_chunks` pieces;
        under ``overlap`` whole faces stripe over the ``channels`` rails,
        FIFO on each (the rule of :meth:`reduce_scheduled`).  Sends and
        bytes go into :attr:`record`."""
        return _halo_exchange(x, specs, self.halo_rings(),
                              schedule=self._halo_schedule_name(schedule),
                              chunks=self.halo_chunks,
                              channels=self.cfg.channels,
                              streams=tuple(rail.stream for rail in
                                            self.transport.rails))

    def halo_schedule(self, x_shape: Sequence[int], specs: Sequence[HaloSpec],
                      *, schedule: str | None = None,
                      itemsize: int = 4) -> CommSchedule:
        """The issue slots :meth:`halo_exchange` executes for one local
        shard of ``x_shape``."""
        return build_halo_schedule(specs, x_shape,
                                   schedule=self._halo_schedule_name(schedule),
                                   channels=self.cfg.channels,
                                   chunks=self.halo_chunks,
                                   itemsize=itemsize,
                                   axis_sizes=self.mesh.sizes())

    def halo_plan(self, x_shape: Sequence[int], specs: Sequence[HaloSpec], *,
                  schedule: str | None = None, itemsize: int = 4) -> HaloPlan:
        """Halo bytes per direction x channel for one exchange."""
        sched = self.halo_schedule(x_shape, specs, schedule=schedule,
                                   itemsize=itemsize)
        sizes = self.mesh.sizes()
        keys, _ = halo_units(specs, x_shape, schedule=sched.policy,
                             chunks=self.halo_chunks,
                             itemsize=itemsize, axis_sizes=sizes)
        by_channel: dict[int, list[int]] = {}
        for slot in sched.slots:
            by_channel.setdefault(slot.channel, []).extend(slot.bucket_ids)
        chans = tuple(HaloChannel(c, tuple(sorted(u)), sum(
            sched.bucket_sizes[i] for i in u)) for c, u in
            sorted(by_channel.items()))
        return HaloPlan(
            schedule=sched.policy,
            axes=tuple(s.axis for s in specs),
            axis_sizes=tuple(sizes.get(s.axis, 1) for s in specs),
            local_shape=tuple(int(n) for n in x_shape),
            halos=tuple(s.halo for s in specs),
            unit_keys=tuple(keys),
            unit_bytes=sched.bucket_sizes,
            channels=chans,
            overlap_fraction=sched.overlap_fraction,
        )

    # -- all-to-all (expert-parallel dispatch/combine) -----------------------

    def _a2a_axis(self) -> str:
        if len(self.axes) != 1:
            raise ValueError(
                f"all_to_all needs exactly one comm axis, got {self.axes}; "
                f"construct the Communicator with data_axes=('model',) (or "
                f"the single EP axis)")
        if not self.spec.supports_a2a:
            raise ValueError(
                f"transport {self.cfg.transport!r} does not support "
                f"all-to-all (supports_a2a=False); use 'a2a', a ring "
                f"transport, or 'psum' (honest replicated fallback)")
        return self.axes[0]

    def a2a_rails(self, shape: Sequence[int]) -> int:
        """Rails one all-to-all of ``shape`` splits into: the payload is
        striped along its last (feature) dimension over ``cfg.channels``
        rails when that divides it, else it rides one rail.  Each rail's
        exchange runs on that rail's own process groups."""
        c = self.cfg.channels
        if c <= 1:
            return 1
        return c if int(shape[-1]) % c == 0 else 1

    def all_to_all(self, x: torch.Tensor, *, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """Channelized tiled all-to-all over the single comm axis
        (``lax.all_to_all(tiled=True)``): ``x`` splits into ``R`` blocks
        along ``split_axis``, block ``j`` travels to rank ``j``, and the
        received blocks concatenate along ``concat_axis`` in source order.
        Differentiable: the backward is the same transport's exchange with
        the axes swapped, recorded like the forward's."""
        self._a2a_axis()
        if self.axis_sizes[0] == 1:
            return x                   # one rank: nothing moves
        return differentiable_all_to_all(self._all_to_all, x, split_axis,
                                         concat_axis)

    def _all_to_all(self, x: torch.Tensor, split_axis: int,
                    concat_axis: int) -> torch.Tensor:
        rails = self.a2a_rails(x.shape)
        if rails <= 1:
            return self.transport.all_to_all(x, split_axis, concat_axis)
        parts = torch.chunk(x, rails, dim=-1)
        return torch.cat(self._on_rails(
            [(c, functools.partial(self.transport.all_to_all, part,
                                   split_axis, concat_axis, rail=c))
             for c, part in enumerate(parts)], x.device), dim=-1)

    def all_to_all_ragged(self, payload: torch.Tensor, counts: torch.Tensor,
                          *, split_axis: int, concat_axis: int
                          ) -> tuple[torch.Tensor, torch.Tensor]:
        """All-to-all of capacity-padded blocks plus their valid-row counts:
        each of the ``R`` destination blocks along ``split_axis`` is padded
        to the static capacity and ``counts`` (int32, ``(R,)``) says how
        many leading rows of each are real.  Returns ``(recv_payload,
        recv_counts)``: ``recv_counts[j]`` rows of source ``j``'s block are
        real, the rest is pad for the caller to mask."""
        self._a2a_axis()
        r = self.axis_sizes[0]
        if counts.shape[0] != r:
            raise ValueError(
                f"counts must have shape ({r},), got {tuple(counts.shape)}")
        recv = self.all_to_all(payload, split_axis=split_axis,
                               concat_axis=concat_axis)
        counts = counts.to(torch.int32)
        if r == 1:
            return recv, counts
        return recv, self.transport.all_to_all(counts, 0, 0)

    def _a2a_sizes(self, shape: Sequence[int], dtype: torch.dtype
                   ) -> tuple[int, int, int]:
        n = 1
        for d in shape:
            n *= int(d)
        return self.axis_sizes[0], n, torch.empty((), dtype=dtype
                                                  ).element_size()

    def moe_schedule(self, shape: Sequence[int],
                     dtype: torch.dtype = torch.float32) -> CommSchedule:
        """Issue slots for one EP dispatch + combine round-trip of a local
        capacity buffer of ``shape``: per-rail dispatch slots ready early
        and combine slots ready late (:func:`build_moe_schedule`)."""
        self._a2a_axis()
        r, n, itemsize = self._a2a_sizes(shape, dtype)
        phase_bytes = self.transport.predicted_a2a_bytes_per_device(
            n, r, itemsize)
        return build_moe_schedule(phase_bytes, self.a2a_rails(shape))

    def a2a_plan(self, shape: Sequence[int],
                 dtype: torch.dtype = torch.float32) -> A2APlan:
        """Predicted wire cost of one EP dispatch + combine round-trip of a
        local capacity buffer of ``shape`` (:class:`A2APlan`)."""
        axis = self._a2a_axis()
        r, n, itemsize = self._a2a_sizes(shape, dtype)
        rails = self.a2a_rails(shape)
        sched = self.moe_schedule(shape, dtype)
        by_channel: dict[int, list[int]] = {}
        for slot in sched.slots:
            by_channel.setdefault(slot.channel, []).extend(slot.bucket_ids)
        chans = tuple(HaloChannel(c, tuple(sorted(u)), sum(
            sched.bucket_sizes[i] for i in u)) for c, u in
            sorted(by_channel.items()))
        keys = tuple(f"{phase}#{c}" for phase in ("dispatch", "combine")
                     for c in range(rails))
        return A2APlan(
            transport=self.cfg.transport, axis=axis, axis_size=r,
            elems_per_device=n, itemsize=itemsize, unit_keys=keys,
            unit_bytes=sched.bucket_sizes,
            messages_per_unit=self.transport
            .predicted_a2a_messages_per_device(r),
            channels=chans, overlap_fraction=sched.overlap_fraction)

    # -- dependency-aware scheduled reduction --------------------------------

    def schedule(self, tree, policy: str, microbatches: int = 1
                 ) -> CommSchedule:
        """The :class:`~repro_torch.comm.schedule.CommSchedule` this
        communicator executes for one gradient-shaped tree."""
        if not self.cfg.fuse:
            sizes = [math.prod(l.shape) for l in tree_util.leaves(tree)]
            return build_schedule(policy, sizes, microbatches=microbatches,
                                  channels=self.cfg.channels)
        bplan = self.bucketer.plan(tree)
        return build_schedule(policy, bplan.bucket_sizes,
                              microbatches=microbatches,
                              channels=self.cfg.channels)

    def arena_schedule(self, tree, policy: str, microbatches: int = 1
                       ) -> CommSchedule:
        """The span-level schedule of the arena mode: each channel's
        contiguous arena span is one issue."""
        from repro_torch.mem.layout import fuse_schedule

        return fuse_schedule(self.schedule(tree, policy, microbatches),
                             self.arena_layout(tree))

    def _collective(self, op: str):
        """``collective(buf, rail)`` of a scheduled reduction's ``op``."""
        return (self.transport.all_reduce if op == "all_reduce"
                else self.transport.reduce_scatter)

    @staticmethod
    def _microbatches(batch: dict, m: int) -> list[dict]:
        if m == 1:
            return [batch]
        return [{k: v.reshape((m, v.shape[0] // m) + tuple(v.shape[1:]))[i]
                 for k, v in batch.items()} for i in range(m)]

    def reduce_scheduled(self, grad_fn: GradFn, params, batch: dict,
                         schedule: CommSchedule, *, op: str = "all_reduce",
                         arena: "CommArena | QuantCommArena | None" = None,
                         arena_buf: torch.Tensor | None = None,
                         ef_buf: torch.Tensor | None = None):
        """Runs ``grad_fn(params, microbatch) -> (loss, grads)`` over
        ``schedule.microbatches`` slices of ``batch`` (split on the leading
        axis), issuing each bucket's collective at its schedule slot.

        ``op``: ``"all_reduce"`` -> ``(mean_loss, reduced_tree)``;
        ``"reduce_scatter"`` -> ``(mean_loss, (shards, bucket_plan))``;
        ``"none"`` -> ``(mean_loss, accumulated_tree)``.

        **Arena mode** (``arena`` given): gradients pack into the arena
        buffer ``arena_buf`` (allocated once by the caller, written in
        place) and each slot reduces one contiguous span of it; ``schedule``
        must be the span-level :meth:`arena_schedule`.  Returns
        ``(loss, (tree, arena_buf))`` for ``all_reduce`` and ``none``,
        ``(loss, (span_shards, bucket_plan, arena_buf))`` for
        ``reduce_scatter``.

        **Quantized arena mode** (``arena`` a
        :class:`~repro_torch.mem.arena.QuantCommArena`): packing *encodes*
        (fused pack+quantize, compensated with the ``ef_buf`` error-feedback
        accumulator, which is updated in place), spans are decoded to fp32
        before their collective (codec-capable transports re-encode on every
        hop, so the wire carries int8 and scales; others reduce fp32), and
        the reduced values re-encode into the arena for the fused
        dequant+unpack out.  Every return gains ``ef_buf``:
        ``(loss, (tree, arena_buf, ef_buf))`` for ``all_reduce`` and
        ``none``, ``(loss, (span_shards, bucket_plan, arena_buf, ef_buf))``
        for ``reduce_scatter``.
        """
        if op not in ("all_reduce", "reduce_scatter", "none"):
            raise ValueError(f"op must be all_reduce|reduce_scatter|none, "
                             f"got {op!r}")
        if op == "reduce_scatter":
            self._require_rs("reduce-scatter")
        if arena is not None:
            from repro_torch.mem.arena import QuantCommArena

            if isinstance(arena, QuantCommArena):
                return self._reduce_scheduled_arena_quant(
                    grad_fn, params, batch, schedule, op, arena, arena_buf,
                    ef_buf)
            return self._reduce_scheduled_arena(grad_fn, params, batch,
                                                schedule, op, arena,
                                                arena_buf)
        if not self.axes:
            if op == "reduce_scatter":
                raise ValueError("reduce_scatter schedule needs data axes; "
                                 "this communicator's mesh has none")
            op = "none"
        m = max(schedule.microbatches, 1)
        issue = self._collective(op)
        inv = 1.0 / m
        streamed = schedule.policy != "accumulate_then_reduce"
        fused = self.cfg.fuse
        losses = []
        acc = None
        bplan: BucketPlan | None = None
        treedef = None
        for i, mb in enumerate(self._microbatches(batch, m)):
            loss, grads = grad_fn(params, mb)
            losses.append(loss)
            if op == "none":
                if m > 1:
                    grads = tree_util.tree_map(lambda g: g.float() * inv,
                                               grads)
                acc = (grads if acc is None
                       else tree_util.tree_map(torch.add, acc, grads))
                continue
            if fused:
                buckets, bplan = self.bucketer.bucketize(grads)
            else:                            # per-tensor: leaf == "bucket"
                buckets, treedef = tree_util.flatten(grads)
                shapes = [b.shape for b in buckets]
                buckets = [b.reshape(-1) for b in buckets]
            del grads
            if len(buckets) != schedule.n_buckets:
                raise ValueError(
                    f"schedule has {schedule.n_buckets} buckets but the "
                    f"gradient tree bucketizes into {len(buckets)}; build "
                    f"the schedule with Communicator.schedule on the same "
                    f"tree")
            if m > 1:
                buckets = [b.float() * inv for b in buckets]
            if streamed:
                out = self._run_slots(
                    schedule, i, lambda b, rail: issue(buckets[b], rail),
                    len(buckets), _device(buckets))
                acc = out if acc is None else [a + o for a, o in zip(acc, out)]
            else:
                acc = (buckets if acc is None
                       else [a + b for a, b in zip(acc, buckets)])
        if op != "none" and not streamed:
            acc = self._run_slots(
                schedule, m - 1, lambda b, rail: issue(acc[b], rail),
                len(acc), _device(acc))
        loss = losses[0] if m == 1 else torch.stack(losses).mean()
        if op == "none":
            return loss, acc
        if not fused:                        # per-tensor mean, dtype-stable
            acc = [a.view(shape) for a, shape in zip(acc, shapes)]
            if self.cfg.mean:
                acc = [(a.float() * (1.0 / self.world)).to(a.dtype)
                       for a in acc]
            return loss, treedef.unflatten(acc)
        acc = self._mean_buckets(acc)
        if op == "reduce_scatter":
            return loss, (acc, bplan)
        return loss, self.bucketer.debucketize(acc, bplan)

    def _reduce_scheduled_arena(self, grad_fn: GradFn, params, batch: dict,
                                schedule: CommSchedule, op: str,
                                arena: "CommArena",
                                arena_buf: torch.Tensor | None):
        """Arena-mode body of :meth:`reduce_scheduled`.  Every collective
        moves one contiguous page-quantized span of the arena (padding
        crosses the wire), reduced in place.

        The returned arena holds what the reference's does, so that a
        checkpoint of the same state writes the same files: the reduced
        mean after an all-reduce, the microbatch sum for ``op="none"``, and
        the last microbatch's pack after a reduce-scatter.  With several
        microbatches the first packs into the arena itself and each later
        one into a step-local buffer of the arena's size that is added in
        (the same adds, in the same order, as a sum kept beside it); a
        reduce-scatter accumulates its packs in the step-local buffer."""
        layout = arena.layout
        if not self.axes:
            raise ValueError("arena mode needs data axes; this "
                             "communicator's mesh has none")
        if op != "none":
            if not self.cfg.fuse:
                raise ValueError("arena mode needs fused aligned buckets "
                                 "(fuse=True)")
            if schedule.n_buckets != layout.n_spans:
                raise ValueError(
                    f"arena mode expects a span-level schedule with "
                    f"{layout.n_spans} spans, got {schedule.n_buckets}; "
                    f"build it with Communicator.arena_schedule")
        m = max(schedule.microbatches, 1)
        issue = self._collective(op)
        inv = 1.0 / m

        def accumulate(acc, t):
            if m == 1:
                return t
            if acc is None:
                return t.clone()
            return acc.add_(t)

        in_place = op != "reduce_scatter"     # the arena is the accumulator
        scratch = None

        def target(i: int, device) -> torch.Tensor:
            """The buffer microbatch ``i`` packs into."""
            nonlocal buf, scratch
            if buf is None:
                buf = arena.zeros(device)
            if i == 0 or not in_place:
                return buf
            if scratch is None:
                scratch = arena.zeros(device)
            return scratch

        def add_into_arena(i: int, t: torch.Tensor) -> torch.Tensor:
            if i > 0:
                buf.add_(t)
            return buf

        def span(buf, s: int) -> torch.Tensor:
            sp = layout.spans[s]
            return buf[sp.offset:sp.offset + sp.size]

        def reduce_spans(buf, phase):
            """All-reduce each span of ``buf`` in place."""
            self._run_slots(
                schedule, phase,
                lambda s, rail: span(buf, s).copy_(issue(span(buf, s), rail)),
                layout.n_spans, buf.device)
            return buf

        def scatter_spans(buf, phase):
            """Reduce-scatter each span of ``buf`` into its shard slot."""
            return self._run_slots(
                schedule, phase,
                lambda s, rail: issue(span(buf, s), rail),
                layout.n_spans, buf.device)

        streamed = schedule.policy != "accumulate_then_reduce"
        losses = []
        acc = None
        bplan: BucketPlan | None = None
        treedef = None
        leaf_meta: list[tuple] = []
        buf = arena_buf
        for i, mb in enumerate(self._microbatches(batch, m)):
            loss, grads = grad_fn(params, mb)
            losses.append(loss)
            if op == "none":
                leaves, treedef = tree_util.flatten(grads)
                del grads
                if len(leaves) != layout.n_segments:
                    raise ValueError(
                        f"arena has {layout.n_segments} segments but the "
                        f"gradient tree has {len(leaves)} leaves; build "
                        f"the arena from the same tree")
                leaf_meta = [(l.shape, l.dtype) for l in leaves]
                flat = [(l.float() * inv if m > 1 else l).reshape(-1)
                        for l in leaves]
                del leaves
                tgt = target(i, flat[0].device)
                arena.pack_into(tgt, flat)
                del flat
                acc = add_into_arena(i, tgt)
                continue
            buckets, bplan = self.bucketer.bucketize(grads)
            del grads
            if bplan.n_buckets != layout.n_segments:
                raise ValueError(
                    f"arena has {layout.n_segments} segments but the "
                    f"gradient tree bucketizes into {bplan.n_buckets}; "
                    f"build the arena with Communicator.arena on the same "
                    f"tree")
            if m > 1:
                buckets = [b.float() * inv for b in buckets]
            tgt = target(i, buckets[0].device)
            arena.pack_into(tgt, buckets)
            del buckets
            if op == "all_reduce":
                acc = add_into_arena(i, reduce_spans(tgt, i) if streamed
                                     else tgt)
            elif not streamed:
                acc = accumulate(acc, buf)
            else:
                out = scatter_spans(buf, i)
                acc = out if acc is None else [a + o
                                               for a, o in zip(acc, out)]
        if op != "none" and not streamed:
            acc = (reduce_spans(acc, m - 1) if op == "all_reduce"
                   else scatter_spans(acc, m - 1))
        loss = losses[0] if m == 1 else torch.stack(losses).mean()
        if op == "none":
            leaves = [u.view(shape).to(torch.float32 if m > 1 else dtype)
                      for u, (shape, dtype) in zip(arena.unpack(acc),
                                                   leaf_meta)]
            return loss, (treedef.unflatten(leaves), buf)
        if op == "reduce_scatter":
            inv_w = 1.0 / self.world if self.cfg.mean else 1.0
            return loss, ([s * inv_w for s in acc], bplan, buf)
        if self.cfg.mean:
            acc.mul_(1.0 / self.world)
        tree = self.bucketer.debucketize(arena.unpack(acc), bplan)
        return loss, (tree, buf)

    def _reduce_scheduled_arena_quant(self, grad_fn: GradFn, params,
                                      batch: dict, schedule: CommSchedule,
                                      op: str, arena: "QuantCommArena",
                                      arena_buf: torch.Tensor | None,
                                      ef_buf: torch.Tensor | None):
        """Quantized-arena body of :meth:`reduce_scheduled` (see there).

        The int8 arena cannot accumulate across microbatches, so gradients
        accumulate in fp32 (bucket lists, or reduced span values under a
        streamed policy) and the arena encodes at issue boundaries: fused
        pack+quantize on the way in (error feedback compensated from
        ``ef_buf``, residual written back), span dequant before each
        collective, and, for ``all_reduce``, a re-encode of the reduced mean
        so that the gradient the caller sees comes out of the fused
        dequant+unpack, exactly what the wire would carry.
        """
        layout = arena.layout
        if not self.axes:
            raise ValueError("arena mode needs data axes; this "
                             "communicator's mesh has none")
        if op != "none":
            if not self.cfg.fuse:
                raise ValueError("arena mode needs fused aligned buckets "
                                 "(fuse=True)")
            if schedule.n_buckets != layout.n_spans:
                raise ValueError(
                    f"arena mode expects a span-level schedule with "
                    f"{layout.n_spans} spans, got {schedule.n_buckets}; "
                    f"build it with Communicator.arena_schedule")
        m = max(schedule.microbatches, 1)
        issue = self._collective(op)
        inv = 1.0 / m
        buf = arena_buf
        ef = ef_buf
        streamed = schedule.policy != "accumulate_then_reduce"
        losses = []
        span_acc: list | None = None   # fp32 reduced spans (AR) / shards (RS)
        bucket_acc: list | None = None  # accumulate_then_reduce fp32 buckets
        leaf_acc: list | None = None    # op == "none" fp32 leaves
        bplan: BucketPlan | None = None
        treedef = None
        leaf_meta: list[tuple] = []

        def run_phase(phase):
            """Decode each of the phase's spans and issue its collective,
            both on the span's rail."""
            return self._run_slots(
                schedule, phase,
                lambda s, rail: issue(arena.dequant_span(buf, s), rail),
                layout.n_spans, buf.device)

        for i, mb in enumerate(self._microbatches(batch, m)):
            loss, grads = grad_fn(params, mb)
            losses.append(loss)
            if op == "none":
                leaves, treedef = tree_util.flatten(grads)
                del grads
                if len(leaves) != layout.n_segments:
                    raise ValueError(
                        f"arena has {layout.n_segments} segments but the "
                        f"gradient tree has {len(leaves)} leaves; build "
                        f"the arena from the same tree")
                leaf_meta = [(l.shape, l.dtype) for l in leaves]
                flat = [l.reshape(-1).float() for l in leaves]
                if m > 1:
                    flat = [l * inv for l in flat]
                leaf_acc = (flat if leaf_acc is None
                            else [a + l for a, l in zip(leaf_acc, flat)])
                continue
            buckets, bplan = self.bucketer.bucketize(grads)
            del grads
            if bplan.n_buckets != layout.n_segments:
                raise ValueError(
                    f"arena has {layout.n_segments} segments but the "
                    f"gradient tree bucketizes into {bplan.n_buckets}; "
                    f"build the arena with Communicator.arena on the same "
                    f"tree")
            buckets = [b.float() for b in buckets]
            if m > 1:
                buckets = [b * inv for b in buckets]
            if buf is None:
                buf = arena.zeros(buckets[0].device)
            if not streamed:
                bucket_acc = (buckets if bucket_acc is None
                              else [a + b
                                    for a, b in zip(bucket_acc, buckets)])
                del buckets
                continue
            arena.pack_into(buf, buckets, ef)
            del buckets
            out = run_phase(i)
            span_acc = (out if span_acc is None
                        else [a + o for a, o in zip(span_acc, out)])
        if op != "none" and not streamed:
            arena.pack_into(buf, bucket_acc, ef)
            del bucket_acc
            span_acc = run_phase(m - 1)
        loss = losses[0] if m == 1 else torch.stack(losses).mean()
        if op == "none":
            if buf is None:
                buf = arena.zeros(leaf_acc[0].device)
            arena.pack_into(buf, leaf_acc, ef)
            leaves = [u.view(shape).to(torch.float32 if m > 1 else dtype)
                      for u, (shape, dtype) in zip(arena.unpack(buf),
                                                   leaf_meta)]
            return loss, (treedef.unflatten(leaves), buf, ef)
        if op == "reduce_scatter":
            inv_w = 1.0 / self.world if self.cfg.mean else 1.0
            return loss, ([s * inv_w for s in span_acc], bplan, buf, ef)
        if self.cfg.mean:
            span_acc = [s * (1.0 / self.world) for s in span_acc]
        for s, vals in enumerate(span_acc):
            arena.requant_span(buf, s, vals)
        del span_acc
        tree = self.bucketer.debucketize(arena.unpack(buf), bplan)
        return loss, (tree, buf, ef)
