"""Live predicted-vs-measured drift detection.

Port of ``repro.obs.drift``.  A byte count that matches its plan says
nothing about whether a latency model still tracks the machine at runtime.
The
:class:`DriftDetector` closes that loop per step: it compares each measured
step (or exposed-comm) time against the prediction for the active config,
publishes the relative error as a ``model_error`` gauge, and raises a
``drift_alarm`` event when the **rolling median** of the error crosses a
threshold — the rolling median so one GC pause or straggler step cannot
fire the alarm, and so a genuine regression (cache behaviour diverging from
the model, the DD-αAMG-on-QPACE-3 failure mode) trips it within a window.

Warmup samples (compile steps, typically 10–1000× steady state) are gauged
but excluded from the alarm window.  The alarm fires on the *transition*
into drift, not once per drifting step; ``drift_alarms`` counts
transitions.
"""

from __future__ import annotations

import statistics
from collections import deque
from dataclasses import dataclass

from repro_torch.obs.bus import NULL_BUS


@dataclass(frozen=True)
class DriftSample:
    """One step's comparison (also emitted as a ``drift_sample`` event)."""

    step: int
    metric: str
    measured_s: float
    predicted_s: float
    rel_err: float                     # (measured - predicted) / predicted
    median_rel_err: float | None      # rolling median (None until the
                                      # window has min_samples)
    drifting: bool
    warmup: bool


class DriftDetector:
    """Per-step comparison of a measured time series against a scalar
    prediction, with rolling-median alarm logic.

    ``predicted_s`` is the model's time for the active config; in the port
    an explicit prediction (``ObsConfig.predicted_step_s``): the AOT
    roofline and tuning-DB pricing are not ported.
    """

    def __init__(self, predicted_s: float, *, metric: str = "step_time_s",
                 bus=NULL_BUS, threshold: float = 0.5, window: int = 8,
                 warmup: int = 1, min_samples: int = 3,
                 source: str = "roofline"):
        if not predicted_s > 0:
            raise ValueError(f"predicted_s must be > 0, got {predicted_s}")
        self.predicted_s = float(predicted_s)
        self.metric = metric
        self.bus = bus
        self.threshold = float(threshold)
        self.warmup = int(warmup)
        self.min_samples = max(int(min_samples), 1)
        self.source = source
        self._window: deque = deque(maxlen=max(int(window), 1))
        self._n = 0
        self._drifting = False
        self.alarms = 0

    def update(self, step: int, measured_s: float) -> DriftSample:
        """Record one measurement; emits the ``model_error`` gauge (every
        sample) and a ``drift_alarm`` event on the transition into drift."""
        self._n += 1
        rel = (float(measured_s) - self.predicted_s) / self.predicted_s
        warm = self._n <= self.warmup
        median = None
        drifting = False
        if not warm:
            self._window.append(rel)
            if len(self._window) >= self.min_samples:
                median = statistics.median(self._window)
                drifting = abs(median) > self.threshold
        self.bus.gauge("model_error", rel, metric=self.metric)
        if median is not None:
            self.bus.gauge("model_error_median", median, metric=self.metric)
        if drifting and not self._drifting:
            self.alarms += 1
            self.bus.counter("drift_alarms", metric=self.metric)
            self.bus.event("drift_alarm", step=step, metric=self.metric,
                           median_rel_err=median, rel_err=rel,
                           measured_s=float(measured_s),
                           predicted_s=self.predicted_s,
                           threshold=self.threshold, source=self.source)
        self._drifting = drifting
        sample = DriftSample(step=step, metric=self.metric,
                             measured_s=float(measured_s),
                             predicted_s=self.predicted_s, rel_err=rel,
                             median_rel_err=median, drifting=drifting,
                             warmup=warm)
        self.bus.event("drift_sample", step=step, metric=self.metric,
                       measured_s=float(measured_s),
                       predicted_s=self.predicted_s, rel_err=rel,
                       median_rel_err=median, drifting=drifting,
                       warmup=warm)
        return sample

    @property
    def drifting(self) -> bool:
        return self._drifting
