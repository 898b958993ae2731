"""Phase-span tracing: host wall-clock spans exportable as Chrome trace JSON.

Port of ``repro.obs.trace``.  A :class:`Span` brackets one phase of a step
(data, dispatch, collective wait, checkpoint, decode...) with
``time.perf_counter`` stamps.  Because CUDA launches are asynchronous, a
span that should account for *device* work must fence: ``sp.fence(tree)``
registers a tree of tensors, and on exit the span records an event on the
current stream of every CUDA device the tree's tensors live on and waits
for it, so the recorded duration covers the device work queued before the
span closed, not just the Python that enqueued it.  A tree of CPU tensors
(or none) needs no fence.

Spans export two ways:

* mirrored onto the :class:`~repro_torch.obs.bus.MetricsBus` as ``span`` JSONL
  records (what the report CLI aggregates), and
* as Chrome ``trace_event`` complete events (``"ph": "X"``, microsecond
  timestamps) via :meth:`Tracer.export_chrome` — the resulting
  ``trace.json`` loads directly in Perfetto / ``chrome://tracing``.

The disabled tracer hands out a shared no-op span: no clock reads, no
allocation, no fencing — the opt-out leaves the step loop untouched.
"""

from __future__ import annotations

import json
import os
import time

from repro_torch.obs.bus import NULL_BUS, _jsonable


def _cuda_devices(tree, out: set) -> set:
    if isinstance(tree, dict):
        for v in tree.values():
            _cuda_devices(v, out)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            _cuda_devices(v, out)
    elif getattr(tree, "is_cuda", False):
        out.add(tree.device)
    return out


def wait_for_device(tree) -> None:
    """Waits until the work queued on the current stream of every CUDA
    device that ``tree``'s tensors live on is done: an event recorded
    there, synchronized on.  A tree without CUDA tensors returns at once
    (and never imports torch)."""
    devices = _cuda_devices(tree, set())
    if not devices:
        return
    import torch  # lazy: the tracer itself stays torch-free

    for dev in sorted(devices, key=str):
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(dev))
        ev.synchronize()


class Span:
    """One phase; use as a context manager (see :meth:`Tracer.span`)."""

    __slots__ = ("_tracer", "name", "labels", "_fence", "t0", "dur_s")

    def __init__(self, tracer: "Tracer", name: str, labels: dict):
        self._tracer = tracer
        self.name = name
        self.labels = labels
        self._fence = None
        self.t0 = None
        self.dur_s = None

    def fence(self, tree):
        """Register a tree (nested dicts, lists and tuples of tensors) to
        wait on before the span closes (device work launched in the span
        lands in its duration).  Returns ``tree`` so call sites can fence
        inline."""
        self._fence = tree
        return tree

    def __enter__(self) -> "Span":
        self.t0 = self._tracer._clock()
        return self

    def __exit__(self, exc_type, exc, tb) -> bool:
        if self._fence is not None:
            wait_for_device(self._fence)
            self._fence = None
        self.dur_s = self._tracer._clock() - self.t0
        self._tracer._record(self.name, self.t0, self.dur_s, self.labels)
        return False


class _NullSpan:
    """Shared no-op span: enter/exit/fence do nothing."""

    __slots__ = ()
    name = None
    dur_s = None

    def fence(self, tree):
        return tree

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return False


NULL_SPAN = _NullSpan()


class Tracer:
    """Span factory + Chrome ``trace_event`` exporter."""

    def __init__(self, bus=NULL_BUS, *, enabled: bool = True,
                 clock=time.perf_counter, pid: int | None = None,
                 tid: int = 0):
        self.enabled = enabled
        self.bus = bus
        self._clock = clock
        self.pid = os.getpid() if pid is None else pid
        self.tid = tid
        self.epoch = clock() if enabled else 0.0
        # (name, t0, dur_s, labels) tuples; t0 on the clock's timeline
        self.events: list[tuple] = []

    def span(self, name: str, **labels):
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, labels)

    def _record(self, name: str, t0: float, dur_s: float,
                labels: dict) -> None:
        self.events.append((name, t0, dur_s, labels))
        self.bus.span(name, dur_s, **labels)

    def export_chrome(self, path: str) -> str:
        """Write the spans as a Perfetto-loadable Chrome trace and return
        the path.  Complete (``"ph": "X"``) events, µs since the tracer's
        epoch, labels carried in ``args``."""
        trace_events = [
            {"name": name, "ph": "X", "cat": "obs",
             "ts": (t0 - self.epoch) * 1e6, "dur": dur_s * 1e6,
             "pid": self.pid, "tid": self.tid, "args": labels or {}}
            for name, t0, dur_s, labels in self.events
        ]
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"traceEvents": trace_events,
                       "displayTimeUnit": "ms"}, f, default=_jsonable)
        return path


class _NullTracer:
    enabled = False
    events: tuple = ()
    bus = NULL_BUS

    def span(self, name, **labels):
        return NULL_SPAN

    def export_chrome(self, path):
        return None


NULL_TRACER = _NullTracer()
