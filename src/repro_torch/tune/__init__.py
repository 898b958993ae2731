"""repro_torch.tune — the measured auto-tuner of the communication
substrate (port of ``repro.tune``).

* :mod:`repro_torch.tune.probe` drives the benches (allreduce, arena, halo,
  cg) as a calibration matrix over transport × channels × page_bytes ×
  message size, on ranks it spawns itself;
* :mod:`repro_torch.tune.fit` least-squares the measured timings against
  ``t = α·messages + bytes/bandwidth`` per group, with per-cell
  predicted-vs-measured errors;
* :mod:`repro_torch.tune.db` persists the fits as a JSON tuning database in
  the reference's format (either package reads the other's);
* :mod:`repro_torch.tune.resolve` turns ``"auto"`` knobs in
  :class:`repro_torch.launch.settings.ArchSettings` into the DB's measured
  best config at launch, falling back to the defaults with a warning.

``python -m repro_torch.tune.probe --out experiments/tuning.json`` builds
the DB; ``python -m repro_torch.launch.train --tuned experiments/tuning.json
--obs-predict`` resolves a launch from it and prices its steps with the
measured constants.
"""

from repro_torch.tune.db import (DEFAULT_DB_PATH, TuningDB,
                                 overrides_fingerprint, tune_key)
from repro_torch.tune.fit import FitResult, fit_cells, fit_latency
from repro_torch.tune.probe import ProbeCell, group_cells, synthesize_cells
from repro_torch.tune.resolve import resolve_settings

__all__ = [
    "DEFAULT_DB_PATH", "FitResult", "ProbeCell", "TuningDB", "fit_cells",
    "fit_latency", "group_cells", "overrides_fingerprint",
    "resolve_settings", "synthesize_cells", "tune_key",
]
