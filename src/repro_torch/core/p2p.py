"""The port's wire: ``torch.distributed`` calls behind one recording wrapper.

The reference's collectives are ``lax.ppermute`` / ``lax.psum`` inside a
``shard_map``; here they are point-to-point sends and receives
(``dist.batch_isend_irecv``) and ``dist.all_reduce`` on process groups.
Every call goes through a :class:`RingAxis`, which

* batches one ring step of every channel chain into one
  ``batch_isend_irecv`` (the chains overlap on the wire);
* shifts payloads to the +1 and -1 neighbours and receives from both
  (:meth:`RingAxis.start_shift`, the halo exchange's ``ppermute``), as a
  handle to wait on later, so that compute can run while faces fly; an
  axis of one rank wraps its payloads back locally;
* stages CUDA payloads through pinned host memory when the group's backend
  is gloo (ranks sharing one card: NCCL refuses two ranks on one device,
  and gloo moves only CPU tensors) — explicitly, and only then;
* records every message and its bytes in a :class:`CommRecord`, the port's
  stand-in for the reference dry-run's collective counts from HLO.

Besides the hops, an axis runs the vendor collectives the reference reaches
through ``lax.psum``, ``lax.all_gather`` and ``lax.psum_scatter``:
``dist.all_reduce``, ``dist.all_gather_into_tensor`` and
``dist.reduce_scatter_tensor`` (FSDP's native weight gather and its
transpose; ``all_gather_single`` and ``reduce_scatter_single`` where
PyTorch has renamed them), and the tiled all-to-all the reference reaches
through ``lax.all_to_all`` (``dist.all_to_all_single``, the expert-parallel
dispatch and combine), staged and recorded alike.
:func:`differentiable_all_to_all` gives any tiled all-to-all its inverse
exchange as backward.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import asdict, dataclass
from typing import Sequence

import torch
import torch.distributed as dist

from repro_torch.core.topology import RankMesh


# one lock for every record: a communicator's rails add to their shared
# record from host threads of their own (repro_torch.comm.rails)
_RECORD_LOCK = threading.Lock()


@dataclass
class CommRecord:
    """What this rank put on the wire since the last :meth:`reset`.

    Every count goes in through :meth:`add`, under a lock, so the rails'
    threads lose none.  ``staging_s`` sums each call's host time; with
    several rails staging at once it sums over the rails, so it can exceed
    the wall time it spans."""

    sends: int = 0               # point-to-point messages sent
    send_bytes: int = 0
    all_reduces: int = 0         # dist.all_reduce calls
    all_reduce_bytes: int = 0    # their payload bytes
    all_gathers: int = 0         # dist.all_gather_into_tensor calls
    all_gather_bytes: int = 0    # the bytes of the shards they gathered
    reduce_scatters: int = 0     # dist.reduce_scatter_tensor calls
    reduce_scatter_bytes: int = 0  # the bytes of the buffers they summed
    all_to_alls: int = 0         # dist.all_to_all_single calls
    all_to_all_bytes: int = 0    # the bytes they sent away: (p-1)/p of each
                                 # payload (this rank's own block stays)
    staging_s: float = 0.0       # host time copying through pinned memory,
                                 # summed over the rails

    def add(self, **counts) -> None:
        """Adds each ``field=amount`` to its field, all under one lock."""
        with _RECORD_LOCK:
            for name, amount in counts.items():
                setattr(self, name, getattr(self, name) + amount)

    def reset(self) -> None:
        with _RECORD_LOCK:
            self.sends = self.send_bytes = 0
            self.all_reduces = self.all_reduce_bytes = 0
            self.all_gathers = self.all_gather_bytes = 0
            self.reduce_scatters = self.reduce_scatter_bytes = 0
            self.all_to_alls = self.all_to_all_bytes = 0
            self.staging_s = 0.0

    def as_dict(self) -> dict:
        return asdict(self)


# the flat gather and sum-and-shard collectives; newer PyTorch renames them
# (the old names still work there, with a deprecation warning)
_all_gather_flat = getattr(dist, "all_gather_single",
                           dist.all_gather_into_tensor)
_reduce_scatter_flat = getattr(dist, "reduce_scatter_single",
                               dist.reduce_scatter_tensor)


_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def split_blocks(x: torch.Tensor, p: int, split_axis: int) -> torch.Tensor:
    """``x`` cut into ``p`` equal blocks along ``split_axis``, stacked on a
    new leading dimension (block ``j`` at ``[j]``), contiguous."""
    n = x.shape[split_axis]
    if n % p:
        raise ValueError(f"all_to_all split dim {n} not divisible by axis "
                         f"size {p}")
    return torch.stack(torch.chunk(x, p, dim=split_axis)).contiguous()


def concat_blocks(blocks: torch.Tensor, concat_axis: int) -> torch.Tensor:
    """The blocks of a stacked ``(p, ...)`` tensor concatenated along
    ``concat_axis`` in order (the inverse of :func:`split_blocks`)."""
    return torch.cat(list(blocks.unbind(0)), dim=concat_axis)


def _mark_used(obj, stream: "torch.cuda.Stream") -> None:
    """``record_stream(stream)`` on every CUDA tensor in ``obj`` (a tensor,
    or lists, tuples and dicts of them)."""
    if isinstance(obj, torch.Tensor):
        if obj.is_cuda:
            obj.record_stream(stream)
    elif isinstance(obj, (list, tuple)):
        for x in obj:
            _mark_used(x, stream)
    elif isinstance(obj, dict):
        for x in obj.values():
            _mark_used(x, stream)


@contextlib.contextmanager
def on_stream(stream: "torch.cuda.Stream | None"):
    """The body on ``stream``, after ``stream`` waits for the current
    stream's work so far; nothing changes for ``None``."""
    if stream is None:
        yield
        return
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    with torch.cuda.device(stream.device), torch.cuda.stream(stream):
        yield


def join_stream(stream: "torch.cuda.Stream | None", tensors) -> None:
    """The current stream waits for ``stream``'s work so far, and the CUDA
    tensors in ``tensors`` (made on ``stream``) are marked used on it;
    nothing for ``None``."""
    if stream is None:
        return
    cur = torch.cuda.current_stream(stream.device)
    cur.wait_stream(stream)
    _mark_used(tensors, cur)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, fn, split_axis, concat_axis):
        ctx.fn, ctx.split, ctx.concat = fn, split_axis, concat_axis
        return fn(x, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, grad):
        # a tiled all-to-all is a permutation; its transpose is the inverse
        # exchange, the same one with the split and concat axes swapped
        return ctx.fn(grad.contiguous(), ctx.concat, ctx.split), None, None, \
            None


def differentiable_all_to_all(fn, x: torch.Tensor, split_axis: int,
                              concat_axis: int) -> torch.Tensor:
    """``fn(x, split_axis, concat_axis)`` (a tiled all-to-all) under
    autograd: the backward runs ``fn`` on the cotangent with the axes
    swapped, so its messages are recorded like the forward's."""
    return _AllToAll.apply(x, fn, split_axis, concat_axis)


class RingAxis:
    """One mesh axis as this rank sees it: the ring of global ranks along
    the axis, this rank's index in it, and the process group its messages
    travel on (``None`` for an axis of one rank)."""

    def __init__(self, ranks: Sequence[int], index: int, group,
                 record: CommRecord):
        self.ranks = tuple(ranks)
        self.index = index
        self.group = group
        self.record = record
        self.stage = (group is not None
                      and dist.get_backend(group) == dist.Backend.GLOO)

    @property
    def size(self) -> int:
        return len(self.ranks)

    def _stage_out(self, ts: list[torch.Tensor]) -> list[torch.Tensor]:
        """Pinned host copies of CUDA tensors bound for a gloo group.  The
        current stream's pending work is waited for first, so the recorded
        time is the copies' own.  On a rail of its own that stream is the
        rail's, which waited for the caller's stream before its first op
        (:class:`repro_torch.comm.rails.RailExecutor`): only the rail's
        work is waited for, and the copies run on the rail's stream."""
        torch.cuda.current_stream(ts[0].device).synchronize()
        t0 = time.perf_counter()
        out = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
               for t in ts]
        self.record.add(staging_s=time.perf_counter() - t0)
        return out

    def _stage_in(self, ts: list[torch.Tensor],
                  device: torch.device) -> list[torch.Tensor]:
        t0 = time.perf_counter()
        out = [t.to(device) for t in ts]
        self.record.add(staging_s=time.perf_counter() - t0)
        return out

    def start_shift(self, payloads: Sequence[torch.Tensor],
                    directions: Sequence[int],
                    tags: Sequence[int] | None = None,
                    stream: "torch.cuda.Stream | None" = None) -> "Shift":
        """Puts every ``payloads[i]`` on its way to the neighbour
        ``directions[i]`` steps along the ring, and a same-shaped receive
        from the opposite neighbour, in one ``batch_isend_irecv`` under tag
        ``tags[i]`` (default ``i``); returns at once.  Two ranks that are
        each other's +1 and -1 neighbour (an axis of two) pair their
        messages by tag, never by order.  On an axis of one rank the
        payloads come straight back (a periodic wrap onto this rank), and
        nothing is sent or recorded.  ``stream`` (a rail's): the staging
        copies, out here and back in :meth:`Shift.wait`, run on it."""
        if tags is None:
            tags = range(len(payloads))
        if self.size == 1:
            return Shift(self, list(payloads), [], False, None)
        p, r = self.size, self.index
        staged = self.stage and payloads[0].is_cuda
        if staged:
            with on_stream(stream):
                sends = self._stage_out(list(payloads))
            recvs = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                     for t in sends]
        else:
            sends = [t.contiguous() for t in payloads]
            recvs = [torch.empty_like(t) for t in sends]
        ops = []
        for tag, s, rv, d in zip(tags, sends, recvs, directions):
            ops.append(dist.P2POp(dist.isend, s, self.ranks[(r + d) % p],
                                  self.group, tag))
            ops.append(dist.P2POp(dist.irecv, rv, self.ranks[(r - d) % p],
                                  self.group, tag))
        works = dist.batch_isend_irecv(ops)
        self.record.add(sends=len(sends),
                        send_bytes=sum(_nbytes(s) for s in sends))
        return Shift(self, recvs, works, staged, payloads[0].device,
                     keep=sends, stream=stream if staged else None)

    def hop(self, payloads: list[torch.Tensor],
            directions: Sequence[int]) -> list[torch.Tensor]:
        """One ring step of every chain at once: ``payloads[i]`` goes to the
        neighbour ``directions[i]`` steps along the ring and the same-shaped
        tensor comes back from the opposite neighbour (tag ``i``, so chains
        between the same two ranks never cross)."""
        return self.start_shift(payloads, directions).wait()

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """Sum (``op="max"``: maximum) of ``t`` over the axis (a fresh
        tensor; ``t`` is untouched)."""
        if self.size == 1:
            return t.clone()
        staged = self.stage and t.is_cuda
        wire = self._stage_out([t])[0] if staged else t.clone()
        dist.all_reduce(wire, op=_REDUCE_OPS[op], group=self.group)
        self.record.add(all_reduces=1, all_reduce_bytes=_nbytes(wire))
        return self._stage_in([wire], t.device)[0] if staged else wire

    def _flat(self, fn, t: torch.Tensor, out_len: int) -> torch.Tensor:
        """``fn(out, t)`` over the axis's group into a fresh flat ``out`` of
        ``out_len`` elements, staged through pinned memory when needed."""
        staged = self.stage and t.is_cuda
        src = self._stage_out([t])[0] if staged else t.contiguous()
        out = torch.empty((out_len,), dtype=src.dtype, pin_memory=staged,
                          device=None if staged else src.device)
        fn(out, src.reshape(-1), group=self.group)
        return self._stage_in([out], t.device)[0] if staged else out

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """The axis's flat shards concatenated in ring order: rank ``i``'s
        ``t`` at ``[i*n, (i+1)*n)`` (``lax.all_gather(tiled=True)``)."""
        if self.size == 1:
            return t
        out = self._flat(_all_gather_flat, t, self.size * t.numel())
        self.record.add(all_gathers=1, all_gather_bytes=_nbytes(t))
        return out

    def all_to_all(self, x: torch.Tensor, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """Tiled all-to-all over the axis (``lax.all_to_all(tiled=True)``):
        ``x`` splits into ``size`` blocks along ``split_axis``, block ``j``
        goes to the rank at index ``j``, and the blocks received (one per
        source, in ring order) concatenate along ``concat_axis``.  One
        ``dist.all_to_all_single``; records the bytes that leave the rank."""
        if self.size == 1:
            return x
        blocks = split_blocks(x, self.size, split_axis)
        staged = self.stage and x.is_cuda
        src = self._stage_out([blocks])[0] if staged else blocks
        out = torch.empty(src.shape, dtype=src.dtype, pin_memory=staged,
                          device=None if staged else src.device)
        dist.all_to_all_single(out, src, group=self.group)
        self.record.add(all_to_alls=1,
                        all_to_all_bytes=(_nbytes(src) // self.size
                                          * (self.size - 1)))
        if staged:
            out = self._stage_in([out], x.device)[0]
        return concat_blocks(out, concat_axis)

    def reduce_scatter(self, t: torch.Tensor) -> torch.Tensor:
        """Sum of the flat ``t`` over the axis, this rank's ``1/size`` of it:
        elements ``[i*n/p, (i+1)*n/p)`` at index ``i``
        (``lax.psum_scatter(tiled=True)``), in ``t``'s dtype."""
        if self.size == 1:
            return t
        if t.numel() % self.size:
            raise ValueError(f"flat length {t.numel()} not divisible by "
                             f"the axis's {self.size} ranks")
        out = self._flat(_reduce_scatter_flat, t, t.numel() // self.size)
        self.record.add(reduce_scatters=1, reduce_scatter_bytes=_nbytes(t))
        return out


class Shift:
    """A :meth:`RingAxis.start_shift` in flight: :meth:`wait` returns the
    received tensors (on the payloads' device), in payload order."""

    def __init__(self, axis: RingAxis, recvs: list[torch.Tensor],
                 works: list, staged: bool, device, keep=(), stream=None):
        self.axis = axis
        self._recvs = recvs
        self._works = works
        self._staged = staged
        self._device = device
        self._keep = keep            # the send buffers, alive until waited
        self._stream = stream        # the rail's, for the copies back in

    def wait(self) -> list[torch.Tensor]:
        for work in self._works:
            work.wait()
        self._works, self._keep = [], ()
        if self._staged:
            with on_stream(self._stream):
                self._recvs = self.axis._stage_in(self._recvs, self._device)
            join_stream(self._stream, self._recvs)
            self._staged = False
        return self._recvs


def axis_rings(mesh: RankMesh, rank: int, axes: Sequence[str],
               record: CommRecord) -> list[RingAxis]:
    """This rank's :class:`RingAxis` for each of ``axes``, each over fresh
    process groups.  Every rank must call this with the same arguments in
    the same order: creating a group is collective over the whole world."""
    return [_ring_of(mesh, rank, (axis,), record) for axis in axes]


def joint_ring(mesh: RankMesh, rank: int, axes: Sequence[str],
               record: CommRecord) -> RingAxis:
    """One :class:`RingAxis` over all of ``axes`` at once (the reference's
    ``psum`` over several axes is one collective over their joint group)."""
    return _ring_of(mesh, rank, tuple(axes), record)


def _ring_of(mesh: RankMesh, rank: int, axes: tuple[str, ...],
             record: CommRecord) -> RingAxis:
    mine = None
    for ranks in mesh.groups(axes):
        group = None
        if len(ranks) > 1:
            if not dist.is_initialized():
                raise RuntimeError(f"a ring over {len(ranks)} ranks needs an "
                                   f"initialised torch.distributed world")
            group = dist.new_group(ranks=ranks)
        if rank in ranks:
            mine = RingAxis(ranks, ranks.index(rank), group, record)
    if mine is None:
        raise ValueError(f"rank {rank} is not on the mesh {mesh}")
    return mine
