"""Serving-step builders: prefill and single-token decode on one device.

Port of ``repro.runtime.serve_step`` for resident weights on one rank.
The prefill returns logits and fills no cache, and the decode step decodes
one token against the contiguous rolling caches, as in the reference.  The
decode step writes the caches in place, which stands for the reference's
donation of the state.  ``weight_mode="gathered"`` (parameters stored as
FSDP flat shards and all-gathered per layer) arrives with the fsdp slice.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models.model_api import Model

WEIGHT_MODES = ("resident", "gathered")


def _require_resident(weight_mode: str) -> None:
    if weight_mode == "gathered":
        raise NotImplementedError(
            "weight_mode='gathered' streams FSDP flat shards, which arrive "
            "with the fsdp slice; use weight_mode='resident'")
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}, got "
                         f"{weight_mode!r}")


def build_prefill(model: Model, shape_cfg: ShapeConfig, *,
                  weight_mode: str = "resident", causal_skip: bool = True,
                  attn_impl: str = "kernel",
                  device: str | torch.device = "cuda"):
    """Returns ``prefill(params, batch) -> logits (B, S, V)`` for batches
    of ``shape_cfg``'s (global_batch, seq_len) tokens.  With
    ``attn_impl="kernel"`` every layer's attention runs the ``flash_attn``
    kernel (its plain version for CPU tensors); ``"blockwise"`` runs the
    reference's blockwise loop."""
    _require_resident(weight_mode)
    dev = resolve_device(device)
    want = (shape_cfg.global_batch, shape_cfg.seq_len)

    def prefill(params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if tuple(tokens.shape) != want:
            raise ValueError(f"prefill built for tokens {want}, got "
                             f"{tuple(tokens.shape)}")
        with torch.no_grad():
            return model.forward(params, {"tokens": tokens},
                                 causal_skip=causal_skip, attn_impl=attn_impl)

    return prefill


def build_decode_step(model: Model, shape_cfg: ShapeConfig, *,
                      weight_mode: str = "resident",
                      device: str | torch.device = "cuda"):
    """Returns ``decode(params, token, state, pos) -> (logits (B, V),
    state)`` for ``shape_cfg.global_batch`` sequences against caches of
    ``shape_cfg.seq_len`` positions (``Model.init_decode_state``)."""
    _require_resident(weight_mode)
    dev = resolve_device(device)
    seq_len = shape_cfg.seq_len

    def decode(params: dict, token, state: list, pos: int):
        token = torch.as_tensor(token, device=dev)
        with torch.no_grad():
            return model.decode_step(params, token, state, int(pos),
                                     seq_len=seq_len)

    return decode
