"""Run-directory summarizer: ``python -m repro_torch.obs.report <run_dir>``.

Port of ``repro.obs.report``.  Reads the JSONL event stream a
:class:`~repro_torch.obs.bus.MetricsBus` (or the reference's) wrote
(plus the Chrome ``trace.json`` when present) and renders:

* the per-phase time breakdown (span name → count / total / mean / p50 /
  max, sorted by total time);
* the predicted-vs-measured drift table (from ``drift_sample`` events:
  last samples, the rolling median, alarm transitions) and the top drift
  cells — the steps where the latency model sat furthest from reality;
* counters (stragglers, serve stalls, drift alarms, ...) and final gauges.

Stdlib-only, so summarizing a run never needs torch.  ``--json`` emits the
summary as one machine-readable object (the same rows+meta shape as
``BENCH_*.json`` consumers expect).
"""

from __future__ import annotations

import argparse
import json
import os
import sys


def read_events(run_dir: str) -> list[dict]:
    path = os.path.join(run_dir, "events.jsonl")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no events.jsonl under {run_dir!r} — was "
                                f"the run instrumented (ObsConfig.run_dir)?")
    records = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: bad JSONL line: {e}")
    return records


def _label_str(name: str, labels: dict) -> str:
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


def summarize(run_dir: str) -> dict:
    """Aggregate the event stream into the report's data model."""
    records = read_events(run_dir)
    spans: dict[str, list[float]] = {}
    counters: dict[str, float] = {}
    gauges: dict[str, float] = {}
    drift_samples: list[dict] = []
    alarms: list[dict] = []
    events: dict[str, int] = {}
    t_lo, t_hi = None, None
    for rec in records:
        ts = rec.get("ts")
        if isinstance(ts, (int, float)):
            t_lo = ts if t_lo is None else min(t_lo, ts)
            t_hi = ts if t_hi is None else max(t_hi, ts)
        kind = rec.get("kind")
        if kind == "span":
            spans.setdefault(rec["name"], []).append(float(rec["dur_s"]))
        elif kind == "counter":
            key = _label_str(rec["name"], rec.get("labels") or {})
            counters[key] = counters.get(key, 0.0) + float(rec["value"])
        elif kind == "gauge":
            key = _label_str(rec["name"], rec.get("labels") or {})
            gauges[key] = float(rec["value"])
        elif kind == "event":
            events[rec["name"]] = events.get(rec["name"], 0) + 1
            if rec["name"] == "drift_sample":
                drift_samples.append(rec.get("fields") or {})
            elif rec["name"] == "drift_alarm":
                alarms.append(rec.get("fields") or {})

    phase_rows = []
    for name, durs in spans.items():
        s = sorted(durs)
        phase_rows.append({
            "phase": name, "count": len(s), "total_s": sum(s),
            "mean_s": sum(s) / len(s), "p50_s": s[len(s) // 2],
            "max_s": s[-1],
        })
    phase_rows.sort(key=lambda r: -r["total_s"])

    trace_path = os.path.join(run_dir, "trace.json")
    trace = None
    if os.path.exists(trace_path):
        with open(trace_path) as f:
            tr = json.load(f)
        trace = {"path": trace_path,
                 "n_events": len(tr.get("traceEvents", []))}

    top_drift = sorted((d for d in drift_samples if not d.get("warmup")),
                       key=lambda d: -abs(d.get("rel_err", 0.0)))[:5]
    return {
        "run_dir": run_dir,
        "n_records": len(records),
        "wall_s": (t_hi - t_lo) if t_lo is not None else 0.0,
        "phases": phase_rows,
        "counters": dict(sorted(counters.items())),
        "gauges": dict(sorted(gauges.items())),
        "events": dict(sorted(events.items())),
        "drift": {"samples": drift_samples, "alarms": alarms,
                  "top": top_drift},
        "trace": trace,
    }


def _fmt_s(sec: float) -> str:
    if sec >= 1.0:
        return f"{sec:8.3f}s "
    return f"{sec * 1e3:8.2f}ms"


def render(summary: dict) -> str:
    out = []
    w = out.append
    w(f"# obs report: {summary['run_dir']}")
    w(f"{summary['n_records']} records over {summary['wall_s']:.3f}s wall")
    if summary["trace"]:
        w(f"trace: {summary['trace']['path']} "
          f"({summary['trace']['n_events']} events — load in Perfetto)")
    w("")

    if summary["phases"]:
        w("## per-phase time breakdown")
        total = sum(r["total_s"] for r in summary["phases"]) or 1.0
        w(f"{'phase':<20}{'count':>7}{'total':>11}{'mean':>11}"
          f"{'p50':>11}{'max':>11}{'share':>8}")
        for r in summary["phases"]:
            w(f"{r['phase']:<20}{r['count']:>7}{_fmt_s(r['total_s']):>11}"
              f"{_fmt_s(r['mean_s']):>11}{_fmt_s(r['p50_s']):>11}"
              f"{_fmt_s(r['max_s']):>11}{100 * r['total_s'] / total:>7.1f}%")
        w("")

    drift = summary["drift"]
    if drift["samples"]:
        w("## predicted vs measured (drift)")
        w(f"{'step':>6}{'metric':>16}{'predicted':>12}{'measured':>12}"
          f"{'rel_err':>10}{'median':>10}  state")
        for d in drift["samples"][-10:]:
            med = d.get("median_rel_err")
            state = ("warmup" if d.get("warmup")
                     else "DRIFT" if d.get("drifting") else "ok")
            w(f"{d.get('step', '?'):>6}{d.get('metric', ''):>16}"
              f"{_fmt_s(d.get('predicted_s', 0.0)):>12}"
              f"{_fmt_s(d.get('measured_s', 0.0)):>12}"
              f"{d.get('rel_err', 0.0):>+10.2f}"
              f"{(f'{med:+.2f}' if med is not None else '—'):>10}  {state}")
        if drift["top"]:
            w("top drift cells (|rel_err|):")
            for d in drift["top"]:
                w(f"  step {d.get('step', '?'):>5}: measured "
                  f"{_fmt_s(d.get('measured_s', 0.0)).strip()} vs predicted "
                  f"{_fmt_s(d.get('predicted_s', 0.0)).strip()} "
                  f"(rel_err {d.get('rel_err', 0.0):+.2f})")
        w(f"alarms: {len(drift['alarms'])}")
        w("")

    if summary["counters"]:
        w("## counters")
        for k, v in summary["counters"].items():
            w(f"  {k:<40}{v:>12g}")
        w("")
    if summary["gauges"]:
        w("## gauges (last value)")
        for k, v in summary["gauges"].items():
            w(f"  {k:<40}{v:>12.6g}")
        w("")
    if summary["events"]:
        w("## events")
        for k, v in summary["events"].items():
            w(f"  {k:<40}{v:>12}")
    return "\n".join(out) + "\n"


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.report",
        description="Summarize an instrumented run directory "
                    "(events.jsonl + trace.json).")
    ap.add_argument("run_dir", help="directory an ObsConfig.run_dir wrote")
    ap.add_argument("--json", action="store_true",
                    help="emit the summary as JSON instead of text")
    args = ap.parse_args(argv)
    summary = summarize(args.run_dir)
    if args.json:
        json.dump(summary, sys.stdout, indent=1, sort_keys=True)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
