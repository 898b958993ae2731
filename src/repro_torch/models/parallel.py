"""ParallelCtx: the collectives model and step code call explicitly.

Port of the data-parallel half of ``repro.models.parallel``.  In the
reference the whole step runs inside a fully manual ``shard_map`` and model
code calls ``ctx.psum`` after row-parallel contractions; the port has no
tensor parallelism yet, so every model-axis collective is the identity and
only the data-axis helpers move data: ``pmean_data`` is one
``dist.all_reduce`` over the data group, through the communicator's
recording wrapper.  ``ParallelCtx()`` is the single-rank context.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.p2p import RingAxis


@dataclass(frozen=True)
class ParallelCtx:
    data: RingAxis | None = None     # joint group of the data axes

    def psum(self, x):
        return x

    def fan_out(self, x):
        return x

    def pmax(self, x):
        return x

    def model_size(self) -> int:
        return 1

    def model_index(self) -> int:
        return 0

    def dp_world(self) -> int:
        return self.data.size if self.data is not None else 1

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        return self.data.all_reduce(x) if self.data is not None else x

    def pmean_data(self, x: torch.Tensor) -> torch.Tensor:
        if self.data is None:
            return x
        return self.psum_data(x) / self.dp_world()


SINGLE = ParallelCtx()
