"""Fault tolerance: straggler detection, heartbeats, elastic re-meshing.

Port of ``repro.runtime.ft``: the same decision logic and event names.

On a real multi-pod deployment these hook into the cluster scheduler; here
they are host-level components with the same decision logic, exercised by
the FT tests via simulated failures.

* ``StragglerMonitor`` — EWMA of step wall-times; flags steps slower than
  ``threshold x`` the running estimate.  At scale the flagged rank triggers
  (a) re-dispatch of its shard (synchronous recovery) or (b) its removal at
  the next elastic boundary; here every sample yields a structured
  :class:`StragglerEvent` (routed onto the obs bus when one is attached).
* ``Heartbeat`` — liveness file per host; ``dead_hosts`` reports *other*
  hosts whose beat is older than the timeout (the caller's own liveness is
  self-evident — it is running); ``prune_stale`` garbage-collects beat
  files of hosts long gone so a drained host doesn't alarm forever.
* ``elastic_remesh`` — rebuilds the largest usable mesh from the
  surviving rank count as a :class:`~repro_torch.core.topology.RankMesh`
  (the port's meshes are data-only: a model axis above 1 raises);
  training resumes from the latest committed checkpoint, whose global
  arrays each rank slices to its own shard on restore.
"""

from __future__ import annotations

import os
import statistics
import time
from dataclasses import dataclass, field
from typing import Any

from repro_torch.core.topology import RankMesh
from repro_torch.obs.bus import NULL_BUS


@dataclass(frozen=True)
class StragglerEvent:
    """One step's verdict.  Truthiness == ``flagged``, so every call site
    that treated :meth:`StragglerMonitor.record`'s old bare bool as a
    condition keeps working unchanged."""

    step: int
    seconds: float
    ewma: float          # the baseline the step was judged against
                         # (0.0 during warmup: no baseline yet)
    flagged: bool

    @property
    def ratio(self) -> float:
        """How many baselines this step took (inf with no baseline)."""
        return self.seconds / self.ewma if self.ewma > 0 else float("inf")

    def __bool__(self) -> bool:
        return self.flagged


@dataclass
class StragglerMonitor:
    """EWMA straggler detector.

    The first ``warmup_steps`` samples only *collect*: the EWMA is seeded
    from their **median**, not from the first step — step 0 is the compile
    step, typically 10-1000x a steady-state step, and seeding from it
    inflates the baseline so early real stragglers sail under
    ``threshold × ewma`` unflagged.  Warmup samples never emit events.

    With a ``bus`` attached, every flagged step publishes a ``straggler``
    event and bumps the ``straggler_events`` counter.
    """

    threshold: float = 2.0
    decay: float = 0.9
    warmup_steps: int = 3
    bus: Any = field(default=None, repr=False)
    _ewma: float | None = None
    _steps: int = 0
    _warmup: list = field(default_factory=list)
    events: list = field(default_factory=list)

    def record(self, step: int, seconds: float) -> StragglerEvent:
        """Judge one step; returns a :class:`StragglerEvent` (truthy when
        flagged).  Flagged events accumulate in ``self.events``."""
        bus = self.bus if self.bus is not None else NULL_BUS
        self._steps += 1
        if self._steps <= self.warmup_steps:
            # warmup: collect only — no baseline yet, no events
            self._warmup.append(seconds)
            if self._steps == self.warmup_steps:
                self._ewma = statistics.median(self._warmup)
            return StragglerEvent(step, seconds, 0.0, False)
        if self._ewma is None:   # warmup_steps == 0: seed from first sample
            self._ewma = seconds
            return StragglerEvent(step, seconds, 0.0, False)
        flagged = seconds > self.threshold * self._ewma
        ev = StragglerEvent(step, seconds, self._ewma, flagged)
        if flagged:
            self.events.append(ev)
            bus.counter("straggler_events")
            bus.event("straggler", step=step, seconds=seconds,
                      ewma=self._ewma, ratio=ev.ratio,
                      threshold=self.threshold)
        else:
            # stragglers are excluded from the estimate (they'd poison it)
            self._ewma = self.decay * self._ewma + (1 - self.decay) * seconds
        return ev


class Heartbeat:
    """File-based liveness beacons (one per host), publishing onto the obs
    bus when one is attached."""

    def __init__(self, beat_dir: str, host_id: str, timeout: float = 60.0,
                 bus: Any = None):
        self.beat_dir = beat_dir
        self.host_id = host_id
        self.timeout = timeout
        self.bus = bus if bus is not None else NULL_BUS
        self._dead_seen: set[str] = set()
        os.makedirs(beat_dir, exist_ok=True)

    def _path(self, host_id: str) -> str:
        return os.path.join(self.beat_dir, f"{host_id}.beat")

    def beat(self, now: float | None = None):
        now = time.time() if now is None else now
        with open(self._path(self.host_id), "w") as f:
            f.write(f"{now:.3f}\n")
        self.bus.gauge("heartbeat_ts", now, host=self.host_id)

    def _last_beats(self) -> dict[str, float]:
        beats = {}
        for name in os.listdir(self.beat_dir):
            if not name.endswith(".beat"):
                continue
            with open(os.path.join(self.beat_dir, name)) as f:
                beats[name[:-5]] = float(f.read().strip() or 0)
        return beats

    def dead_hosts(self, now: float | None = None) -> list[str]:
        """Hosts whose last beat is *strictly* older than ``timeout``
        seconds — excluding this host (its liveness is self-evident; a
        scheduler draining "dead" hosts must never drain the reporter on
        the strength of its own stale file).  Newly-dead hosts publish a
        ``host_dead`` event; the ``dead_hosts`` gauge tracks the count."""
        now = time.time() if now is None else now
        dead = []
        for host, last in self._last_beats().items():
            if host == self.host_id:
                continue
            if now - last > self.timeout:
                dead.append(host)
        dead = sorted(dead)
        for host in dead:
            if host not in self._dead_seen:
                self.bus.event("host_dead", host=host,
                               stale_s=now - self._last_beats()[host])
        self._dead_seen = set(dead)
        self.bus.gauge("dead_hosts", len(dead))
        return dead

    def prune_stale(self, now: float | None = None,
                    grace: float | None = None) -> list[str]:
        """Remove beat files (other hosts') stale past ``grace`` seconds
        (default ``10 × timeout``): a host drained long ago stops showing
        up in ``dead_hosts`` forever.  Returns the pruned host ids."""
        now = time.time() if now is None else now
        grace = 10.0 * self.timeout if grace is None else grace
        pruned = []
        for host, last in self._last_beats().items():
            if host == self.host_id:
                continue
            if now - last > grace:
                os.remove(self._path(host))
                pruned.append(host)
        pruned = sorted(pruned)
        for host in pruned:
            self._dead_seen.discard(host)
            self.bus.event("host_pruned", host=host)
        return pruned


def elastic_shape(n_devices: int, *, model_parallel: int = 16,
                  want_pods: int = 1) -> tuple[tuple[int, ...], tuple[str, ...]]:
    """Largest (pod, data, model) shape that fits ``n_devices`` surviving
    devices, shrinking data-parallelism first (the dimension the synchronous
    SGD math tolerates: global batch per step shrinks, semantics don't)."""
    model = model_parallel
    while model > 1 and n_devices % model != 0:
        model //= 2
    rest = n_devices // model
    pods = want_pods
    while pods > 1 and rest % pods != 0:
        pods -= 1
    data = rest // pods
    if data < 1:
        raise ValueError(f"cannot build a mesh from {n_devices} devices")
    shape = (pods, data, model) if pods > 1 else (data, model)
    names = ("pod", "data", "model") if pods > 1 else ("data", "model")
    return shape, names


def elastic_remesh(n_devices: int, *, model_parallel: int = 16,
                   want_pods: int = 1) -> RankMesh:
    """The mesh of :func:`elastic_shape` as a data-only
    :class:`RankMesh` (``("data",)``, or ``("pod", "data")``); the model
    axis of size 1 is dropped.  A model axis above 1 raises: tensor
    parallelism is not ported (ROADMAP Queue 1 #6)."""
    shape, names = elastic_shape(n_devices, model_parallel=model_parallel,
                                 want_pods=want_pods)
    sizes = dict(zip(names, shape))
    if sizes["model"] > 1:
        raise NotImplementedError(
            f"elastic_remesh: {n_devices} devices give a model axis of "
            f"{sizes['model']}; the port's meshes are data-only until "
            f"tensor parallelism is ported (ROADMAP Queue 1 #6) — pass "
            f"model_parallel=1")
    kept = tuple(n for n in names if n != "model")
    return RankMesh(kept, tuple(sizes[n] for n in kept))
