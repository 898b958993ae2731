"""Each rail's collectives on a host thread and a CUDA stream of their own.

The paper gets its bandwidth from "multiple independent communicators":
threads that drive independent endpoints at the same time.  A
:class:`~repro_torch.comm.api.Communicator` of ``channels >= 2`` rails
hands each rail's FIFO list of collectives to a :class:`RailExecutor`,
which runs it on a host thread of that rail's own (kept for the
communicator's life) and, for tensors on the card, on the rail's
``torch.cuda.Stream`` (:attr:`repro_torch.comm.registry.Rail.stream`):

* before its first op a rail's stream waits for the work queued so far on
  the caller's current stream, so the buckets' producers have finished;
* at the join the caller's stream waits for each rail's, and every CUDA
  tensor a rail hands back is marked used on the caller's stream
  (``record_stream``): it was allocated on the rail's stream, and the
  caching allocator would otherwise recycle it under a kernel still queued
  on the caller's;
* an exception raised on a rail is re-raised in the caller at the join,
  with a note naming the rail, once every rail has finished: the run never
  goes on with a rail missing.

Each rail keeps its collectives in the same order on every rank and no two
rails share a process group, so two ranks cannot deadlock, and each
collective still runs start to end on one thread, so every result is
bitwise what one rail gives on the same buckets.  The caller's grad and
inference modes hold on the rails' threads too.  At ``channels <= 1`` no
executor, thread or stream is made: the caller's thread and stream run
every collective, in program order.
"""

from __future__ import annotations

import contextlib
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Sequence

import torch

from repro_torch.core.p2p import join_stream

Call = tuple[int, Callable[[], Any]]


def new_rail_stream() -> "torch.cuda.Stream | None":
    """A stream for one rail on the current card; ``None`` without one."""
    return torch.cuda.Stream() if torch.cuda.is_available() else None


class RailExecutor:
    """Runs the calls of several rails at once, one host thread per rail.

    ``streams[c]`` is rail ``c``'s CUDA stream (``None`` without a card);
    a call on CUDA tensors needs its rail's stream on their device."""

    def __init__(self, streams: Sequence["torch.cuda.Stream | None"]):
        self.streams = tuple(streams)
        self._pools: list[ThreadPoolExecutor | None] = [None] * len(streams)
        self._lock = threading.Lock()

    def _pool(self, rail: int) -> ThreadPoolExecutor:
        with self._lock:
            if self._pools[rail] is None:
                self._pools[rail] = ThreadPoolExecutor(
                    1, thread_name_prefix=f"rail{rail}")
            return self._pools[rail]

    def _stream(self, rail: int, device: torch.device) -> "torch.cuda.Stream":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        stream = self.streams[rail]
        if stream is None or stream.device != device:
            raise ValueError(
                f"rail {rail} has its stream on "
                f"{None if stream is None else stream.device}; the tensors "
                f"are on {device}")
        return stream

    def run(self, calls: Sequence[Call],
            device: torch.device | None = None) -> list:
        """``fn()`` for every ``(rail, fn)`` of ``calls``, each rail's in
        their order on the rail's thread (and, when ``device`` is a CUDA
        device, on the rail's stream), the rails at the same time.
        Returns the results in the order of ``calls``."""
        by_rail: dict[int, list[int]] = {}
        for i, (rail, _) in enumerate(calls):
            by_rail.setdefault(rail, []).append(i)
        streams = ({rail: self._stream(rail, device) for rail in by_rail}
                   if device is not None and device.type == "cuda" else {})
        for stream in streams.values():       # after the caller's work
            stream.wait_stream(torch.cuda.current_stream(device))
        grad = torch.is_grad_enabled()
        inference = torch.is_inference_mode_enabled()

        def body(rail: int, idx: list[int]) -> list:
            with contextlib.ExitStack() as stack:
                stack.enter_context(torch.set_grad_enabled(grad))
                if inference:
                    stack.enter_context(torch.inference_mode())
                if rail in streams:
                    stack.enter_context(torch.cuda.device(device))
                    stack.enter_context(torch.cuda.stream(streams[rail]))
                return [calls[i][1]() for i in idx]

        pending = [(rail, idx, self._pool(rail).submit(body, rail, idx))
                   for rail, idx in by_rail.items()]
        results: list = [None] * len(calls)
        failed: BaseException | None = None
        for rail, idx, future in pending:
            try:
                out = future.result()
            except BaseException as exc:   # re-raised below, every rail joined
                exc.add_note(f"raised on rail {rail} of "
                             f"{len(self.streams)}")
                failed = failed or exc
                continue
            join_stream(streams.get(rail), out)
            for i, r in zip(idx, out):
                results[i] = r
        if failed is not None:
            raise failed
        return results
