"""Least-squares calibration of the α/β latency model from probe timings.

Port of ``repro.tune.fit`` (numpy, as the reference).  One fit per
(transport × channels × page_bytes) probe group, over the message-size
sweep::

    t_i = α · messages_i + bytes_i / bandwidth

is linear in ``(α, β = 1/bandwidth)``, so a weighted two-column least
squares recovers the measured per-message latency and per-link bandwidth
that :class:`repro_torch.comm.plan.LatencyModel` otherwise takes as given.
The fit also returns each cell's predicted-vs-measured relative error.

Cells carry their timing dispersion (the min and max of the timed calls,
:mod:`repro_torch.tune.timing`); noisy cells are down-weighted by
``1/σ²`` with ``σ = max(spread/2, rel_floor·t)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterable, Sequence

import numpy as np

# β is clamped to this floor instead of zero or below, so that
# ``bandwidth`` stays finite and JSON-serialisable
_MAX_BANDWIDTH = 1e15
# relative timing-noise floor: a zero-spread cell is taken as good to 1 %
_REL_FLOOR = 0.01


@dataclass(frozen=True)
class FitResult:
    """Measured α/bandwidth plus the fit-quality record.

    ``rel_errors[i]`` is ``|t_pred − t_meas| / t_meas`` for probe cell
    ``i`` under the fitted constants; ``max_rel_err``/``mean_rel_err``
    summarise them."""

    alpha_s: float              # measured per-message latency
    bandwidth: float            # measured per-link bytes/s
    n_cells: int
    rel_errors: tuple[float, ...]
    mean_rel_err: float
    max_rel_err: float
    rms_residual_s: float

    def predicted_seconds(self, messages: float, nbytes: float) -> float:
        return self.alpha_s * float(messages) + float(nbytes) / self.bandwidth

    def as_dict(self) -> dict:
        return {
            "alpha_s": self.alpha_s,
            "bandwidth": self.bandwidth,
            "n_cells": self.n_cells,
            "rel_errors": list(self.rel_errors),
            "mean_rel_err": self.mean_rel_err,
            "max_rel_err": self.max_rel_err,
            "rms_residual_s": self.rms_residual_s,
        }

    @classmethod
    def from_dict(cls, d: dict) -> "FitResult":
        return cls(alpha_s=float(d["alpha_s"]),
                   bandwidth=float(d["bandwidth"]),
                   n_cells=int(d["n_cells"]),
                   rel_errors=tuple(float(e) for e in d["rel_errors"]),
                   mean_rel_err=float(d["mean_rel_err"]),
                   max_rel_err=float(d["max_rel_err"]),
                   rms_residual_s=float(d["rms_residual_s"]))


def dispersion_weight(seconds: float, t_min: float, t_max: float,
                      rel_floor: float = _REL_FLOOR) -> float:
    """``1/σ²`` weight from a cell's timing spread (min/max over iters)."""
    sigma = max((float(t_max) - float(t_min)) / 2.0,
                rel_floor * abs(float(seconds)), 1e-12)
    return 1.0 / (sigma * sigma)


def fit_latency(samples: Sequence[tuple[float, float, float, float]]
                ) -> FitResult:
    """Weighted least squares of ``t = α·m + b/bw``.

    ``samples``: ``(messages, nbytes, seconds, weight)`` tuples.  The
    coefficients are clamped to α ≥ 0 and bandwidth ≤ 1e15 B/s; a clamped
    coordinate triggers a one-parameter refit of the other, so that the
    constants stay least-squares optimal on the boundary."""
    rows = [(float(m), float(b), float(t), float(w))
            for m, b, t, w in samples]
    if not rows:
        raise ValueError("fit_latency needs at least one probe sample")
    m = np.array([r[0] for r in rows])
    b = np.array([r[1] for r in rows])
    t = np.array([r[2] for r in rows])
    sw = np.sqrt(np.array([r[3] for r in rows]))

    A = np.stack([m * sw, b * sw], axis=1)
    y = t * sw
    coef, *_ = np.linalg.lstsq(A, y, rcond=None)
    alpha, beta = float(coef[0]), float(coef[1])

    def _refit_single(col: np.ndarray) -> float:
        denom = float(np.dot(col * sw, col * sw))
        return float(np.dot(col * sw, y)) / denom if denom > 0 else 0.0

    if alpha < 0.0:
        alpha = 0.0
        beta = _refit_single(b)
    if beta < 1.0 / _MAX_BANDWIDTH:
        beta = 1.0 / _MAX_BANDWIDTH
        if np.any(m > 0):
            alpha = max(_refit_single(m), 0.0)
    bandwidth = 1.0 / beta

    pred = alpha * m + beta * b
    resid = pred - t
    denom = np.where(np.abs(t) > 0, np.abs(t), 1.0)
    rel = np.abs(resid) / denom
    return FitResult(
        alpha_s=alpha, bandwidth=bandwidth, n_cells=len(rows),
        rel_errors=tuple(float(e) for e in rel),
        mean_rel_err=float(np.mean(rel)),
        max_rel_err=float(np.max(rel)),
        rms_residual_s=float(np.sqrt(np.mean(resid * resid))),
    )


def fit_cells(cells: Iterable) -> FitResult:
    """Fit one group of :class:`repro_torch.tune.probe.ProbeCell` records,
    weighting by each cell's measured dispersion."""
    samples = [(c.messages, c.nbytes, c.seconds,
                dispersion_weight(c.seconds, c.t_min, c.t_max))
               for c in cells]
    return fit_latency(samples)
