"""repro_torch.core — the wire, the ring collectives, buckets, the halo
exchange and the deprecated :class:`GradientReducer` shim (port of
``repro.core``)."""

from repro_torch.core.reducer import (GradientReducer, ReduceConfig,
                                      per_tensor_reducer)

__all__ = ["GradientReducer", "ReduceConfig", "per_tensor_reducer"]
