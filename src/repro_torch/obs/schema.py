"""The shared machine-readable result schema for benches and obs consumers.

Port of ``repro.obs.schema``; the schema name stays the reference's, so a
record written by either package loads in the other.

Every registered benchmark prints CSV blocks for humans; this module turns
them into one canonical JSON artifact per bench —
``BENCH_<name>.json`` — so the perf trajectory is diffable run-over-run
(``benchmarks/run.py --json <dir>``).  The same record shape carries any
tabular obs payload (probe matrices, report summaries), so there is exactly
one "rows + meta" format in the repo.

Record shape::

    {"schema": "repro.obs.bench/v1", "name": ..., "created": iso8601,
     "n_rows": N, "rows": [{col: scalar, ...}, ...], "meta": {...}}

Pure stdlib — importable from the report CLI and the bench harness without
pulling torch.
"""

from __future__ import annotations

import json
import os
import time

SCHEMA = "repro.obs.bench/v1"

_SCALARS = (str, int, float, bool, type(None))


def _coerce(cell: str):
    """CSV cell -> int | float | str (in that preference order)."""
    try:
        return int(cell)
    except ValueError:
        pass
    try:
        return float(cell)
    except ValueError:
        return cell


def rows_from_csv(text: str) -> list[dict]:
    """Parse bench stdout into row dicts.

    The benches print one or more CSV blocks: an all-string header line
    names the columns; data lines map onto it positionally.  Blank lines
    end a block (the next block may carry a new header); ``#`` lines are
    commentary.  Data rows with no preceding header (or a mismatched column
    count) fall back to positional ``col<i>`` keys — parse never fails, it
    degrades."""
    rows: list[dict] = []
    header: list[str] | None = None
    for raw in text.splitlines():
        line = raw.strip()
        if not line:
            header = None
            continue
        if line.startswith("#"):
            continue
        if "," not in line:
            continue
        cells = [c.strip() for c in line.split(",")]
        vals = [_coerce(c) for c in cells]
        all_str = all(isinstance(v, str) for v in vals)
        if header is None and all_str:
            header = cells
            continue
        if header is not None and len(cells) != len(header):
            if all_str:                     # a new header mid-block
                header = cells
                continue
            header = None                   # shape changed: degrade
        keys = header if header is not None \
            else [f"col{i}" for i in range(len(cells))]
        rows.append(dict(zip(keys, vals)))
    return rows


def bench_record(name: str, rows: list[dict], meta: dict | None = None,
                 created: str | None = None) -> dict:
    """Build (and validate) one schema record."""
    rec = {
        "schema": SCHEMA,
        "name": str(name),
        "created": created or time.strftime("%Y-%m-%dT%H:%M:%S"),
        "n_rows": len(rows),
        "rows": list(rows),
        "meta": dict(meta or {}),
    }
    validate_record(rec)
    return rec


def validate_record(rec: dict) -> None:
    """Raise ``ValueError`` unless ``rec`` is a well-formed schema record."""
    if not isinstance(rec, dict) or rec.get("schema") != SCHEMA:
        raise ValueError(f"not a {SCHEMA} record: "
                         f"schema={rec.get('schema') if isinstance(rec, dict) else rec!r}")
    for field in ("name", "created", "rows", "meta", "n_rows"):
        if field not in rec:
            raise ValueError(f"record missing field {field!r}")
    rows = rec["rows"]
    if not isinstance(rows, list) or rec["n_rows"] != len(rows):
        raise ValueError("rows must be a list with n_rows == len(rows)")
    for i, row in enumerate(rows):
        if not isinstance(row, dict):
            raise ValueError(f"row {i} is not a dict: {row!r}")
        for k, v in row.items():
            if not isinstance(k, str) or not isinstance(v, _SCALARS):
                raise ValueError(
                    f"row {i} cell {k!r} must be a str key with a scalar "
                    f"value, got {type(v).__name__}")


def bench_path(out_dir: str, name: str) -> str:
    return os.path.join(out_dir, f"BENCH_{name}.json")


def write_bench_record(out_dir: str, name: str, rows: list[dict],
                       meta: dict | None = None) -> str:
    """Write ``BENCH_<name>.json`` under ``out_dir``; returns the path."""
    rec = bench_record(name, rows, meta=meta)
    os.makedirs(out_dir, exist_ok=True)
    path = bench_path(out_dir, name)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return path


def load_bench_record(path: str) -> dict:
    with open(path) as f:
        rec = json.load(f)
    validate_record(rec)
    return rec
