"""repro_torch.obs — runtime telemetry bus, phase-span tracing, drift
detection.  Port of ``repro.obs``:

* :class:`~repro_torch.obs.bus.MetricsBus` — counters/gauges/histograms
  with labels, JSONL sink (``events.jsonl``);
* :class:`~repro_torch.obs.trace.Tracer` — host wall-clock phase spans
  with optional fencing on CUDA events, exported as Chrome
  ``trace_event`` JSON (Perfetto-loadable ``trace.json``);
* :class:`~repro_torch.obs.drift.DriftDetector` — per-step
  measured-vs-predicted comparison emitting ``model_error`` gauges and
  ``drift_alarm`` events;
* :mod:`repro_torch.obs.schema` — the shared ``BENCH_<name>.json`` row
  schema;
* ``python -m repro_torch.obs.report <run_dir>`` — the offline summarizer.

The records keep the reference's names and fields, so either package's
report reads either package's run directory.  Everything importable here
is stdlib-only (torch is touched lazily, inside span fencing).
``ObsConfig(enabled=False)`` — or simply a ``None`` config — resolves to
:data:`NULL_OBS`, whose every operation is a no-op.

Not ported: the step-time prediction from the AOT roofline
(``ObsConfig.predict``) and from a tuning DB (``tuned_db``) raise
``NotImplementedError`` (ROADMAP Queue 1 #9); an explicit
``predicted_step_s`` drives drift detection.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

from repro_torch.obs.bus import MetricsBus, NULL_BUS
from repro_torch.obs.drift import DriftDetector, DriftSample
from repro_torch.obs.schema import (bench_record, load_bench_record,
                                    rows_from_csv, write_bench_record)
from repro_torch.obs.trace import NULL_SPAN, NULL_TRACER, Span, Tracer

__all__ = [
    "ObsConfig", "Obs", "make_obs", "NULL_OBS",
    "MetricsBus", "NULL_BUS", "Tracer", "Span", "NULL_TRACER", "NULL_SPAN",
    "DriftDetector", "DriftSample",
    "bench_record", "write_bench_record", "load_bench_record",
    "rows_from_csv",
]


@dataclass(frozen=True)
class ObsConfig:
    """Everything the runtime needs to instrument (or not instrument) a run.

    ``enabled=False`` is the hard opt-out: :func:`make_obs` returns
    :data:`NULL_OBS` and no clock, file or dict is ever touched.  With
    ``run_dir=None`` the bus aggregates in memory only (no JSONL sink, no
    trace file) — useful for tests and embedded use."""

    enabled: bool = True
    run_dir: str | None = None
    trace: bool = True                 # collect spans + export trace.json
    flush_every: int = 64              # JSONL buffer flush cadence
    # drift detection (active only when a prediction is available)
    drift_threshold: float = 0.5       # |rolling median rel err| alarm bar
    drift_window: int = 8
    drift_warmup: int = 1              # leading samples excluded (compile)
    drift_min_samples: int = 3
    predicted_step_s: float | None = None  # explicit prediction
    predict: bool = False              # not ported: raises
    tuned_db: str | None = None        # not ported: raises

    def __post_init__(self):
        if self.predict or self.tuned_db:
            raise NotImplementedError(
                "ObsConfig.predict and tuned_db price the step through the "
                "reference's AOT roofline and tuning DB, which are not "
                "ported (ROADMAP Queue 1 #9); pass predicted_step_s")

    @classmethod
    def off(cls) -> "ObsConfig":
        return cls(enabled=False)


class Obs:
    """The bundle a run holds: one bus + one tracer + config, with the
    convenience delegates hot loops call."""

    enabled = True

    def __init__(self, cfg: ObsConfig):
        self.cfg = cfg
        self.bus = MetricsBus(cfg.run_dir, flush_every=cfg.flush_every)
        self.tracer = Tracer(self.bus, enabled=cfg.trace)

    # -- delegates -----------------------------------------------------------

    def span(self, name: str, **labels):
        return self.tracer.span(name, **labels)

    def counter(self, name: str, value: float = 1.0, **labels):
        return self.bus.counter(name, value, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        self.bus.gauge(name, value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        self.bus.observe(name, value, **labels)

    def event(self, name: str, **fields) -> None:
        self.bus.event(name, **fields)

    # -- drift ---------------------------------------------------------------

    def drift_detector(self, predicted_s: float,
                       metric: str = "step_time_s",
                       source: str = "roofline") -> DriftDetector:
        """A detector wired to this bus with the config's thresholds."""
        return DriftDetector(predicted_s, metric=metric, bus=self.bus,
                             threshold=self.cfg.drift_threshold,
                             window=self.cfg.drift_window,
                             warmup=self.cfg.drift_warmup,
                             min_samples=self.cfg.drift_min_samples,
                             source=source)

    # -- lifecycle -----------------------------------------------------------

    def finish(self) -> dict:
        """Flush the sink and (when a run_dir is bound) export the Chrome
        trace; returns the artifact paths."""
        trace_path = None
        if (self.cfg.run_dir is not None and self.tracer.enabled
                and self.tracer.events):
            trace_path = self.tracer.export_chrome(
                os.path.join(self.cfg.run_dir, "trace.json"))
        self.bus.close()
        return {"events": self.bus.path, "trace": trace_path}


class _NullObs:
    """`Obs` with every operation a no-op (the ``enabled=False`` case)."""

    enabled = False
    cfg = ObsConfig(enabled=False)
    bus = NULL_BUS
    tracer = NULL_TRACER

    def span(self, name, **labels):
        return NULL_SPAN

    def counter(self, name, value=1.0, **labels):
        return 0.0

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def event(self, name, **fields):
        pass

    def drift_detector(self, predicted_s, metric="step_time_s",
                       source="roofline"):
        return None

    def finish(self):
        return {"events": None, "trace": None}


NULL_OBS = _NullObs()


def make_obs(cfg: ObsConfig | None) -> Obs | _NullObs:
    """The single constructor every subsystem funnels through: a real
    :class:`Obs` when ``cfg.enabled``, else the shared :data:`NULL_OBS`."""
    if cfg is None or not cfg.enabled:
        return NULL_OBS
    return Obs(cfg)
