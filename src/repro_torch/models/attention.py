"""GQA attention parameters and head layout.

Port of the parts of ``repro.models.attention`` that decode needs: query
heads are zero-padded up to a multiple of ``HEAD_PAD_TO`` (the padded rows
of ``wo`` are zero, so padded heads never reach the output), and the
``(B, S, H*D) <-> (B, H, S, D)`` head split.  The training attention path
arrives with the training slice.
"""

from __future__ import annotations

import math

import torch

from repro_torch.configs.base import AttnConfig
from repro_torch.models.common import dense_init

HEAD_PAD_TO = 16  # model-axis size the padded head count must tile


def padded_heads(n: int, pad_to: int = HEAD_PAD_TO) -> int:
    return int(math.ceil(n / pad_to) * pad_to)


def attn_init(generator, cfg: AttnConfig, d_model: int, *,
              dtype: torch.dtype = torch.float32, device=None,
              pad_to: int = HEAD_PAD_TO) -> dict:
    """Query heads padded to tile the model axis, padded ``wo`` rows zero;
    KV heads are never padded."""
    hq = padded_heads(cfg.num_heads, pad_to)
    hkv = cfg.num_kv_heads
    hd = cfg.head_dim
    kw = dict(dtype=dtype, device=device)
    p = {
        "wq": dense_init(generator, d_model, hq * hd, bias=cfg.qkv_bias, **kw),
        "wk": dense_init(generator, d_model, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wv": dense_init(generator, d_model, hkv * hd, bias=cfg.qkv_bias, **kw),
        "wo": dense_init(generator, hq * hd, d_model, **kw),
    }
    if hq > cfg.num_heads:
        p["wo"]["w"][cfg.num_heads * hd:] = 0.0
    return p


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n_heads, -1).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)
