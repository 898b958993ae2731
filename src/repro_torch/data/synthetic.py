"""Deterministic synthetic token pipeline.

Port of ``repro.data.synthetic``: Zipf-distributed tokens with
EOS-delimited documents and next-token labels, deterministic in
``(seed, step)``.  ``batch_at`` is the reference's numpy code, so its
batches equal the reference's bit for bit; they come back as CPU tensors
(the caller moves them to its device): int32 tokens and labels and, given
the model's config, its modality stub's inputs, drawn first and in the
reference's order: a vision stub's patch embeddings ``extra_embeds`` (B,
P, d), which shorten the text to ``seq_len - P``, then an audio stub's (or
an encoder-decoder's) ``frames`` (B, F, d), both ``N(0, 1) * 0.02`` in
fp32 rounded to bf16 to nearest even, the reference's ``jnp.asarray(...,
jnp.bfloat16)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig


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

    def __init__(self, cfg: DataConfig, model_cfg: ModelConfig | None = None):
        self.cfg = cfg
        self.model_cfg = model_cfg
        ranks = np.arange(1, cfg.vocab_size + 1, dtype=np.float64)
        probs = 1.0 / np.power(ranks, cfg.zipf_a)
        self._cdf = np.cumsum(probs / probs.sum())

    def _tokens(self, rng: np.random.Generator, shape) -> np.ndarray:
        u = rng.random(shape)
        toks = np.searchsorted(self._cdf, u).astype(np.int32)
        return np.minimum(toks, self.cfg.vocab_size - 1)

    def batch_numpy(self, step: int) -> dict[str, np.ndarray]:
        """The batch as numpy, the stub inputs still fp32 (numpy has no
        bf16; :meth:`batch_at` rounds them)."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        b, s = cfg.global_batch, cfg.seq_len
        mc = self.model_cfg
        text = s
        extra: dict = {}
        if mc is not None and mc.frontend == "vision_stub" and mc.frontend_seq:
            text = s - mc.frontend_seq
            extra["extra_embeds"] = rng.standard_normal(
                (b, mc.frontend_seq, mc.d_model), dtype=np.float32) * 0.02
        if mc is not None and (mc.family == "encdec"
                               or mc.frontend == "audio_stub"):
            extra["frames"] = rng.standard_normal(
                (b, mc.enc_seq, mc.d_model), dtype=np.float32) * 0.02
        toks = self._tokens(rng, (b, text + 1))
        eos_mask = rng.random((b, text + 1)) < 1.0 / max(cfg.mean_doc_len, 2)
        toks = np.where(eos_mask, cfg.eos_id, toks)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:], **extra}

    def batch_at(self, step: int) -> dict[str, torch.Tensor]:
        out = {}
        for k, v in self.batch_numpy(step).items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            # float32 -> bfloat16 rounds to nearest even, as ml_dtypes does
            out[k] = t.to(torch.bfloat16) if t.dtype == torch.float32 else t
        return out
