"""The tuning database: fitted α/bandwidth records persisted as JSON.

Port of ``repro.tune.db``, in the reference's file format field for field,
so that each package reads the database the other wrote.  Keyed by every
knob that changes what was measured::

    tune|<arch>|<mesh>|<transport>|ch<channels>|p<page_bytes>[|ov[...]]

with an order-insensitive overrides fingerprint.  A record stores the
fitted constants plus what is needed to (a) rebuild a
:class:`~repro_torch.comm.plan.LatencyModel` (``LatencyModel.from_record``),
(b) report the fit's quality and (c) rank configs for ``"auto"``
resolution: ``messages_ref`` (the hop count of the largest probe cell) and
``wire_factor`` (wire bytes per payload byte, page padding and codec
included) let :meth:`TuningDB.best_config` price any reference payload
under each candidate's measured constants.
"""

from __future__ import annotations

import json
import os
import time
from typing import Iterable, Mapping

from repro_torch.tune.fit import FitResult

DB_VERSION = 1
DEFAULT_DB_PATH = "experiments/tuning.json"

# arch the probe runner records when not calibrating for a specific model's
# gradient tree; resolution falls back to it when the exact arch is missing
GENERIC_ARCH = "generic"


def overrides_fingerprint(overrides: dict | None) -> str:
    """Deterministic, order-insensitive fingerprint of a cell's overrides
    (the reference's, so that both packages key a record alike)."""
    if not overrides:
        return ""
    items = sorted((str(k), json.dumps(v, sort_keys=True, default=str))
                   for k, v in overrides.items())
    return ",".join(f"{k}={v}" for k, v in items)


def tune_key(arch: str, mesh: str, transport: str, channels: int,
             page_bytes: int, overrides: dict | None = None) -> str:
    """DB key of one fitted probe group."""
    base = f"tune|{arch}|{mesh}|{transport}|ch{int(channels)}|p{int(page_bytes)}"
    fp = overrides_fingerprint(overrides)
    return f"{base}|ov[{fp}]" if fp else base


class TuningDB:
    """JSON-persisted map of tune keys → fitted records."""

    def __init__(self, records: dict | None = None, path: str | None = None):
        self.records: dict[str, dict] = dict(records or {})
        self.path = path

    # -- persistence ---------------------------------------------------------

    @classmethod
    def load(cls, path: str) -> "TuningDB":
        """Load a DB file; a missing path yields an empty DB bound to it."""
        if not os.path.exists(path):
            return cls(path=path)
        with open(path) as f:
            data = json.load(f)
        if not isinstance(data, dict) or "records" not in data:
            raise ValueError(f"{path} is not a tuning DB "
                             f"(expected {{'version', 'records'}})")
        return cls(records=data["records"], path=path)

    def save(self, path: str | None = None) -> str:
        path = path or self.path
        if path is None:
            raise ValueError("no path bound to this TuningDB")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump({"version": DB_VERSION, "records": self.records},
                      f, indent=1, sort_keys=True)
        self.path = path
        return path

    # -- writing -------------------------------------------------------------

    def put_fit(self, *, arch: str, mesh: str, transport: str, channels: int,
                page_bytes: int, fit: FitResult,
                cells: Iterable | None = None,
                overrides: dict | None = None) -> str:
        """Store one fitted probe group; returns its key."""
        key = tune_key(arch, mesh, transport, channels, page_bytes, overrides)
        cells = list(cells or [])
        rec = {
            "arch": arch, "mesh": mesh, "transport": transport,
            "channels": int(channels), "page_bytes": int(page_bytes),
            "overrides": overrides_fingerprint(overrides),
            "fit": fit.as_dict(),
            "created": time.strftime("%Y-%m-%dT%H:%M:%S"),
        }
        if cells:
            ref = max(cells, key=lambda c: c.nbytes)
            payload = max(ref.elems * 4.0, 1.0)
            rec["cells"] = [c.as_dict() for c in cells]
            rec["messages_ref"] = float(ref.messages)
            rec["wire_factor"] = float(ref.nbytes) / payload
        self.records[key] = rec
        return key

    # -- reading -------------------------------------------------------------

    def get(self, arch: str, mesh: str, transport: str, channels: int,
            page_bytes: int, overrides: dict | None = None) -> dict | None:
        return self.records.get(
            tune_key(arch, mesh, transport, channels, page_bytes, overrides))

    def lookup(self, *, transport: str | None = None, arch: str | None = None,
               mesh: str | None = None, channels: int | None = None,
               page_bytes: int | None = None) -> tuple[str, dict] | None:
        """Most-specific record match.

        ``transport`` (when given) is a hard requirement — fitted constants
        from one schedule do not transfer to another.  The soft dimensions
        score exact matches highest, the :data:`GENERIC_ARCH` fallback next,
        and any-value last, so a cell always gets the closest calibration
        available (a probe run on the 2×4 host mesh still prices a 16×16
        cell when nothing closer exists)."""
        best: tuple[int, str, dict] | None = None
        for key, rec in self.records.items():
            if transport is not None and rec.get("transport") != transport:
                continue
            score = 0
            if arch is not None:
                if rec.get("arch") == arch:
                    score += 8
                elif rec.get("arch") == GENERIC_ARCH:
                    score += 4
            if mesh is not None and rec.get("mesh") == mesh:
                score += 2
            if channels is not None and rec.get("channels") == channels:
                score += 2
            if page_bytes is not None and rec.get("page_bytes") == page_bytes:
                score += 1
            if best is None or (score, key) > (best[0], best[1]):
                best = (score, key, rec)
        return (best[1], best[2]) if best is not None else None

    def matching(self, *, arch: str | None = None, mesh: str | None = None
                 ) -> list[tuple[str, dict]]:
        """Records usable for (arch, mesh): exact arch or the generic
        fallback; any mesh (exact matches sort first)."""
        out = []
        for key, rec in self.records.items():
            if arch is not None and rec.get("arch") not in (arch,
                                                            GENERIC_ARCH):
                continue
            exact_mesh = mesh is None or rec.get("mesh") == mesh
            out.append((not exact_mesh, key, rec))
        out.sort(key=lambda x: (x[0], x[1]))
        # keep only the best mesh tier available
        if out and not out[0][0]:
            out = [o for o in out if not o[0]]
        return [(key, rec) for _, key, rec in out]

    def best_config(self, *, arch: str | None = None, mesh: str | None = None,
                    transport: str | None = None,
                    ref_bytes: float = 256 * 2**20) -> dict | None:
        """The measured-best (transport, channels, page_bytes) for a
        reference gradient payload of ``ref_bytes``: each candidate record
        is priced at its *fitted* constants,

            t = α·messages_ref + ref_bytes · wire_factor / bandwidth

        (``messages_ref`` is size-invariant for ring schedules; the wire
        factor carries page padding and codec overhead), and the cheapest
        wins.  ``transport`` (when given) restricts the candidates — used
        when the transport is pinned and only channels/page are ``"auto"``.
        Returns ``None`` when no record matches."""
        best = None
        for key, rec in self.matching(arch=arch, mesh=mesh):
            fit = rec.get("fit", {})
            if "messages_ref" not in rec or not fit:
                continue
            if transport is not None and rec.get("transport") != transport:
                continue
            t = (fit["alpha_s"] * rec["messages_ref"]
                 + ref_bytes * rec.get("wire_factor", 1.0)
                 / max(fit["bandwidth"], 1.0))
            if best is None or t < best["t_ref_s"]:
                best = {"transport": rec["transport"],
                        "channels": rec["channels"],
                        "page_bytes": rec["page_bytes"],
                        "t_ref_s": t, "key": key,
                        "alpha_s": fit["alpha_s"],
                        "bandwidth": fit["bandwidth"]}
        return best

    # -- convenience ---------------------------------------------------------

    def __len__(self) -> int:
        return len(self.records)

    def fit_for(self, key: str) -> FitResult:
        return FitResult.from_dict(self.records[key]["fit"])


def model_error_summary(record: Mapping) -> dict:
    """The ``model_error`` block of a record: how far the fitted model's
    predictions sat from the probe measurements (the Trainer's
    ``tuned_record`` event carries it)."""
    fit = record.get("fit", record)
    return {
        "mean_rel_err": float(fit["mean_rel_err"]),
        "max_rel_err": float(fit["max_rel_err"]),
        "rms_residual_s": float(fit["rms_residual_s"]),
        "n_cells": int(fit["n_cells"]),
    }
