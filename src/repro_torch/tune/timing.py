"""The probe's timer: the median, ``t_min`` and ``t_max`` of blocked calls.

The reference times a call from the host clock to ``block_until_ready`` of
its result.  Here a timed call starts after a barrier across the ranks (so
that no rank's clock includes another's lateness) and ends when the call's
result is on the device: ``torch.cuda.synchronize`` of the device the
call ran on, then the host clock.  A gloo collective blocks the host until
its data has moved, so the host clock is the right one for it; a CUDA
kernel's tail is covered by the synchronize.
"""

from __future__ import annotations

import time


class Timing(float):
    """Median seconds that still is a float, carrying the dispersion the
    fitter weights by (the reference's ``benchmarks.common.Timing``)."""

    t_min: float
    t_max: float
    samples: tuple

    def __new__(cls, samples):
        ts = sorted(float(t) for t in samples)
        if not ts:
            raise ValueError("Timing needs at least one sample")
        mid = len(ts) // 2
        # the true median: the mean of the middle pair for an even count
        med = ts[mid] if len(ts) & 1 else 0.5 * (ts[mid - 1] + ts[mid])
        self = super().__new__(cls, med)
        self.t_min = ts[0]
        self.t_max = ts[-1]
        self.samples = tuple(ts)
        return self

    @property
    def spread(self) -> float:
        return self.t_max - self.t_min


def _fence(device) -> None:
    import torch

    if device is not None and torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def time_call(fn, *args, warmup: int = 1, iters: int = 3,
              device=None) -> Timing:
    """Median wall-seconds of ``iters`` blocked calls of ``fn(*args)``,
    after ``warmup`` untimed ones, as a :class:`Timing`.

    Each timed call starts after a barrier across the ranks of the
    default process group (when one exists) and a synchronize of
    ``device`` (when it is a CUDA device), and ends after the call returns
    and ``device`` is synchronized again."""
    for _ in range(warmup):
        fn(*args)
        _fence(device)
    ts = []
    for _ in range(iters):
        _fence(device)
        _barrier()
        t0 = time.perf_counter()
        fn(*args)
        _fence(device)
        ts.append(time.perf_counter() - t0)
    return Timing(ts)
