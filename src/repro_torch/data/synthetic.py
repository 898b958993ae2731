"""Deterministic synthetic token pipeline.

Port of ``repro.data.synthetic``: Zipf-distributed tokens with
EOS-delimited documents and next-token labels, deterministic in
``(seed, step)``.  ``batch_at`` is the reference's numpy code, so its
batches equal the reference's bit for bit; they come back as CPU int32
tensors (the caller moves them to its device).  The vision and audio stub
inputs arrive with their model families.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    eos_id: int = 1
    mean_doc_len: int = 512


class SyntheticTokens:
    """Stateless batch generator: ``batch_at(step)`` is pure."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        u = rng.random(shape)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        return np.minimum(toks, self.cfg.vocab_size - 1)

    def batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        toks = self._tokens(rng, (b, s + 1))
        eos_mask = rng.random((b, s + 1)) < 1.0 / max(cfg.mean_doc_len, 2)
        toks = np.where(eos_mask, cfg.eos_id, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        return {k: torch.from_numpy(np.ascontiguousarray(v))
                for k, v in self.batch_numpy(step).items()}
