"""Plain PyTorch ring-hop accumulate: the CUDA kernel's plain version.

Port of ``repro.kernels.reduce_add.ref``: ``out = cast(a) + cast(b)`` in
the accumulation dtype, cast to ``out_dtype``.
"""

from __future__ import annotations

import torch


def add_accum(a: torch.Tensor, b: torch.Tensor, *,
              accum_dtype: torch.dtype = torch.float32,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    out_dtype = out_dtype or accum_dtype
    return (a.to(accum_dtype) + b.to(accum_dtype)).to(out_dtype)
