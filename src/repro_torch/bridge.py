"""Parameter and train-state bridge between the reference's numpy trees and
the port.

The reference initialises parameters from ``jax.random``, which PyTorch
cannot replay, so every model-level equivalence test starts from a tree the
reference made, converted leaf by leaf.  A tree is nested dicts and lists
(tuples allowed) of arrays; the structure and every dtype are kept, and a
round trip is bitwise.  :func:`state_from_numpy` and :func:`state_to_numpy`
carry a whole train state the same way (parameters, AdamW moments, the
int8 arena and the fp32 ``"ef"`` accumulator; under fsdp the ``"groups"``
of flat shards and moments of the same shape, ``{name: [shards]}``), so
that a step can start from the same state on both sides; the step counter
is a Python ``int`` in the port.  Under tensor parallelism
:func:`local_params_from_numpy` hands a rank its blocks of the reference's
full tree (the reference's ``NamedSharding`` placement, through
:func:`repro_torch.sharding.rules.local_shard`), and
:func:`global_params_to_numpy` puts the ranks' blocks back together, so
that tests compare whole trees.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device


def _bf16_numpy_dtype():
    # numpy has no bfloat16 of its own; the reference's arrays use ml_dtypes'
    import ml_dtypes

    return np.dtype(ml_dtypes.bfloat16)


def _to_torch(a, device: torch.device) -> torch.Tensor:
    a = np.array(a, order="C")      # own, writable copy: no aliasing
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    """A copy on the host, never a view: the port updates some state
    tensors (the arena, ``"ef"``) in place.  A numpy array is copied as it
    is."""
    if isinstance(t, np.ndarray):
        return t.copy()
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_bf16_numpy_dtype()).copy()
    return t.numpy().copy()


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, fn) for v in tree)
    return fn(tree)


def params_from_numpy(tree, device: str | torch.device = "cuda"):
    """numpy (or array-like) tree -> the same tree of tensors on ``device``."""
    dev = resolve_device(device)
    return _map(tree, lambda a: _to_torch(a, dev))


def params_to_numpy(tree):
    """Tensor tree -> the same tree of numpy arrays on the host."""
    return _map(tree, _to_numpy)


def state_from_numpy(state: dict, device: str | torch.device = "cuda"
                     ) -> dict:
    """One rank's train state as numpy (``"step"`` a scalar) -> the port's
    state on ``device``."""
    out = params_from_numpy({k: v for k, v in state.items() if k != "step"},
                            device)
    out["step"] = int(state["step"])
    return out


def state_to_numpy(state: dict) -> dict:
    """The port's train state -> numpy (``"step"`` an int64 scalar)."""
    out = params_to_numpy({k: v for k, v in state.items() if k != "step"})
    out["step"] = np.int64(state["step"])
    return out


def local_params_from_numpy(tree, specs, mesh, rank: int,
                            device: str | torch.device = "cuda"):
    """This rank's blocks of a full numpy tree (``specs``: the port's spec
    tree on ``mesh``), as tensors on ``device``."""
    from repro_torch.sharding.rules import local_shard

    return params_from_numpy(local_shard(tree, specs, mesh, rank), device)


def global_params_to_numpy(shards, specs, mesh):
    """The full numpy tree from every rank's tree of blocks (``shards[r]``
    rank ``r``'s, tensors or numpy), the inverse of
    :func:`local_params_from_numpy`."""
    from repro_torch.sharding.rules import global_from_shards

    return global_from_shards([params_to_numpy(t) for t in shards], specs,
                              mesh)
