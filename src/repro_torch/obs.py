"""No-op observability handle, the port of ``repro.obs.NULL_OBS``.

The engine and scheduler keep the reference's instrumentation calls; until
the observability slice lands they all go here and cost nothing.
"""

from __future__ import annotations

import contextlib


class _NullObs:
    """An ``Obs`` whose every operation is a no-op."""

    def span(self, name, **labels):
        return contextlib.nullcontext()

    def counter(self, name, value=1.0, **labels):
        return 0.0

    def gauge(self, name, value, **labels):
        pass

    def event(self, name, **fields):
        pass


NULL_OBS = _NullObs()
