"""MetricsBus: process-local counters/gauges/histograms with a JSONL sink.

Port of ``repro.obs.bus``.  The bus is the port's single telemetry spine:
the Trainer, the serve scheduler/engine, the fault-tolerance monitors and
the DriftDetector all publish through it, and ``repro_torch.obs.report``
re-aggregates the JSONL stream after the fact.  The records have the
reference's names and fields, so either package's report reads either
package's run directory.  Design constraints, in order:

* **Host-side only.**  Nothing here touches torch — publishing a metric
  never launches a kernel or waits for the device.
* **Zero-overhead opt-out.**  :data:`NULL_BUS` implements the same surface
  as no-ops; callers hold a bus reference unconditionally and never branch.
* **The JSONL file is the source of truth.**  In-memory aggregates exist
  for tests and end-of-run summaries; the report CLI reads only the file,
  so a crashed run's telemetry survives up to the last flush.

Record shapes (one JSON object per line)::

    {"ts": s, "kind": "counter|gauge|hist", "name": n, "value": v,
     "labels": {...}}
    {"ts": s, "kind": "span",  "name": n, "dur_s": d, "labels": {...}}
    {"ts": s, "kind": "event", "name": n, "fields": {...}}
"""

from __future__ import annotations

import json
import os
import time


def _jsonable(obj):
    """numpy scalars (and anything with ``.item()``) -> python scalars."""
    if hasattr(obj, "item"):
        try:
            return obj.item()
        except Exception:
            pass
    return str(obj)


class MetricsBus:
    """Labelled counters, gauges and histograms with an append-only JSONL
    sink (``<run_dir>/events.jsonl``); ``run_dir=None`` keeps everything
    in memory (aggregates only, no file)."""

    def __init__(self, run_dir: str | None = None, *, flush_every: int = 64,
                 clock=time.time):
        self.run_dir = run_dir
        self.flush_every = max(int(flush_every), 1)
        self._clock = clock
        self.counters: dict = {}
        self.gauges: dict = {}
        self.hists: dict = {}
        self.spans: dict = {}
        self.n_records = 0
        self._buf: list[str] = []
        self._fh = None
        self.path = None
        if run_dir is not None:
            os.makedirs(run_dir, exist_ok=True)
            self.path = os.path.join(run_dir, "events.jsonl")

    # -- keys ----------------------------------------------------------------

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted(labels.items())))

    # -- sink ----------------------------------------------------------------

    def _emit(self, rec: dict) -> None:
        self.n_records += 1
        if self.path is None:
            return
        self._buf.append(json.dumps(rec, default=_jsonable))
        if len(self._buf) >= self.flush_every:
            self.flush()

    def flush(self) -> None:
        if self.path is None or not self._buf:
            return
        if self._fh is None:
            self._fh = open(self.path, "a")
        self._fh.write("\n".join(self._buf) + "\n")
        self._fh.flush()
        self._buf.clear()

    def close(self) -> None:
        self.flush()
        if self._fh is not None:
            self._fh.close()
            self._fh = None

    # -- instruments ---------------------------------------------------------

    def counter(self, name: str, value: float = 1.0, **labels) -> float:
        """Monotonic accumulator; returns the new total."""
        k = self._key(name, labels)
        total = self.counters.get(k, 0.0) + float(value)
        self.counters[k] = total
        self._emit({"ts": self._clock(), "kind": "counter", "name": name,
                    "value": float(value), "labels": labels})
        return total

    def gauge(self, name: str, value: float, **labels) -> None:
        """Last-value-wins instrument (step time, queue depth, model_error)."""
        self.gauges[self._key(name, labels)] = float(value)
        self._emit({"ts": self._clock(), "kind": "gauge", "name": name,
                    "value": float(value), "labels": labels})

    def observe(self, name: str, value: float, **labels) -> None:
        """Histogram sample (summarised by :meth:`hist_summary`)."""
        self.hists.setdefault(self._key(name, labels), []).append(float(value))
        self._emit({"ts": self._clock(), "kind": "hist", "name": name,
                    "value": float(value), "labels": labels})

    def event(self, name: str, **fields) -> None:
        """Structured one-off record (straggler, drift_alarm, admit, ...)."""
        self._emit({"ts": self._clock(), "kind": "event", "name": name,
                    "fields": fields})

    def span(self, name: str, dur_s: float, **labels) -> None:
        """Completed phase-span occurrence (published by the Tracer)."""
        self.spans.setdefault(name, []).append(float(dur_s))
        self._emit({"ts": self._clock(), "kind": "span", "name": name,
                    "dur_s": float(dur_s), "labels": labels})

    # -- reading (tests / end-of-run summaries) ------------------------------

    def counter_value(self, name: str, **labels) -> float:
        return self.counters.get(self._key(name, labels), 0.0)

    def counter_total(self, name: str) -> float:
        """Sum over every label combination of ``name``."""
        return sum(v for (n, _), v in self.counters.items() if n == name)

    def gauge_value(self, name: str, **labels) -> float | None:
        return self.gauges.get(self._key(name, labels))

    def has_gauge(self, name: str) -> bool:
        return any(n == name for (n, _) in self.gauges)

    def hist_summary(self, name: str, **labels) -> dict | None:
        vals = self.hists.get(self._key(name, labels))
        if not vals:
            return None
        s = sorted(vals)
        return {"count": len(s), "sum": sum(s), "min": s[0], "max": s[-1],
                "mean": sum(s) / len(s), "p50": s[len(s) // 2]}

    def summary(self) -> dict:
        def label_str(key):
            name, items = key
            if not items:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in items) + "}"

        return {
            "counters": {label_str(k): v for k, v in self.counters.items()},
            "gauges": {label_str(k): v for k, v in self.gauges.items()},
            "hists": {label_str(k): len(v) for k, v in self.hists.items()},
            "spans": {n: {"count": len(d), "total_s": sum(d)}
                      for n, d in self.spans.items()},
            "n_records": self.n_records,
        }


class _NullBus:
    """The opt-out: every instrument is a no-op, every read is empty.  Hot
    paths hold this unconditionally — no ``if obs:`` branches anywhere."""

    path = None
    run_dir = None
    counters: dict = {}
    gauges: dict = {}
    hists: dict = {}
    spans: dict = {}
    n_records = 0

    def counter(self, name, value=1.0, **labels):
        return 0.0

    def gauge(self, name, value, **labels):
        pass

    def observe(self, name, value, **labels):
        pass

    def event(self, name, **fields):
        pass

    def span(self, name, dur_s, **labels):
        pass

    def flush(self):
        pass

    def close(self):
        pass

    def counter_value(self, name, **labels):
        return 0.0

    def counter_total(self, name):
        return 0.0

    def gauge_value(self, name, **labels):
        return None

    def has_gauge(self, name):
        return False

    def hist_summary(self, name, **labels):
        return None

    def summary(self):
        return {"counters": {}, "gauges": {}, "hists": {}, "spans": {},
                "n_records": 0}


NULL_BUS = _NullBus()
