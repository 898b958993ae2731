"""Alignment helper of ``repro.core.topology`` (the ring permutation tables
arrive with the communicator slice)."""

from __future__ import annotations

import math


def padded_size(n: int, multiple: int) -> int:
    """Smallest ``m >= n`` with ``m % multiple == 0`` (lane/ring alignment)."""
    if multiple <= 0:
        raise ValueError(f"multiple must be positive, got {multiple}")
    return int(math.ceil(n / multiple) * multiple)
