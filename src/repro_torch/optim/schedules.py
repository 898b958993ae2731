"""LR schedules: warmup-cosine (default), WSD (minicpm), constant, linear.

Port of ``repro.optim.schedules``; ``fn(step) -> lr`` on host floats.
"""

from __future__ import annotations

import math


def make_schedule(name: str, *, base_lr: float, warmup: int = 100,
                  total: int = 1000, stable_frac: float = 0.8,
                  min_frac: float = 0.1):
    w = max(warmup, 1)

    def warm(step):
        return min(step / w, 1.0)

    def clip01(x):
        return min(max(x, 0.0), 1.0)

    if name == "constant":
        return lambda step: base_lr * warm(step)

    if name == "linear":
        def lin(step):
            t = clip01((step - w) / max(total - w, 1))
            return base_lr * warm(step) * (1 - (1 - min_frac) * t)
        return lin

    if name == "cosine":
        def cos(step):
            t = clip01((step - w) / max(total - w, 1))
            return base_lr * warm(step) * (min_frac + (1 - min_frac) * 0.5
                                           * (1 + math.cos(math.pi * t)))
        return cos

    if name == "wsd":
        stable_end = w + int((total - w) * stable_frac)

        def wsd(step):
            decay_t = clip01((step - stable_end) / max(total - stable_end, 1))
            decay = 1.0 - (1.0 - min_frac) * math.sqrt(decay_t)
            return base_lr * warm(step) * (1.0 if step < stable_end
                                           else decay)
        return wsd

    raise ValueError(f"unknown schedule {name!r}")
