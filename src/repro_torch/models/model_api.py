"""Model facade: one object per architecture.

Port of ``repro.models.model_api``.  Vocab sizes are padded to a multiple
of 128 exactly as in the reference (labels never reference pad rows; the pad
is included in the reported parameter count).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.parallel import SINGLE, ParallelCtx

VOCAB_PAD_TO = 128


def padded_vocab(v: int) -> int:
    return int(math.ceil(v / VOCAB_PAD_TO) * VOCAB_PAD_TO)


@dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        self.cfg = self.cfg.with_(vocab_size=padded_vocab(self.cfg.vocab_size))
        if self.cfg.family == "encdec" or self.cfg.frontend == "audio_stub":
            raise NotImplementedError(
                f"{self.cfg.name}: encoder-decoder models are not ported yet "
                f"(remaining-families slice)")
        if self.cfg.frontend == "vision_stub":
            raise NotImplementedError(
                f"{self.cfg.name}: the vision stub's patch embeddings are not "
                f"ported yet (remaining-families slice)")

    def init(self, generator: torch.Generator,
             device: str | torch.device = "cuda") -> dict:
        """Fresh parameters on ``device``, drawn from ``generator`` (which
        must live on that device)."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"generator lives on {generator.device}, "
                             f"parameters are made on {dev}")
        return transformer.init_params(generator, self.cfg, dev)

    def param_specs(self, mesh):
        """The ``tp``-policy spec tree of the parameters on ``mesh`` (the
        data axes are realised by the step's flat shards, never by the
        parameter specs, as in the reference)."""
        from repro_torch.sharding.rules import param_specs

        tree = transformer.init_params(None, self.cfg, torch.device("meta"))
        return param_specs(tree, self.cfg.with_(sharding="tp"), mesh)

    def loss_fn(self, params: dict, batch: dict, *,
                ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
                block_resolver=None,
                stats_out: list | None = None) -> torch.Tensor:
        """Token-mean cross entropy of ``batch`` plus the weighted MoE
        load-balancing loss (the reference's ``Model.loss_fn`` on one rank
        of the mesh ``ctx`` describes); ``block_resolver`` gathers FSDP
        blocks (:func:`transformer.forward`); ``stats_out`` receives
        ``{"moe_drop_fraction": ...}``."""
        return transformer.loss_fn(params, batch, self.cfg, ctx=ctx,
                                   causal_skip=causal_skip,
                                   block_resolver=block_resolver,
                                   stats_out=stats_out)

    def forward(self, params: dict, batch: dict, *,
                ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
                attn_impl: str = "blockwise",
                block_resolver=None) -> torch.Tensor:
        """Logits over this rank's vocab shard (all of it on one rank)."""
        logits, _, _ = transformer.forward(params, batch["tokens"], self.cfg,
                                           ctx=ctx, causal_skip=causal_skip,
                                           attn_impl=attn_impl,
                                           block_resolver=block_resolver)
        return logits

    def init_decode_state(self, batch: int, seq_len: int, *,
                          device: str | torch.device = "cuda") -> list:
        """Zero bf16 KV caches for ``batch`` sequences of ``seq_len``
        positions on ``device``."""
        return transformer.init_decode_state(self.cfg, batch, seq_len,
                                             device=resolve_device(device))

    def decode_step(self, params: dict, token: torch.Tensor, state: list,
                    pos: int, *, ctx: ParallelCtx = SINGLE,
                    seq_len: int | None = None,
                    block_resolver=None) -> tuple[torch.Tensor, list]:
        return transformer.decode_step(params, token, state, pos, self.cfg,
                                       ctx=ctx, seq_len=seq_len,
                                       block_resolver=block_resolver)

    def param_count(self) -> int:
        """Element count of the tree, from shapes alone (nothing allocated)."""
        tree = transformer.init_params(None, self.cfg, torch.device("meta"))
        return sum(t.numel() for t in _leaves(tree))

    def active_param_count(self) -> int:
        """MoE: only ``top_k`` of ``num_experts`` expert stacks are active
        per token; the count of the others is taken out."""
        total = self.param_count()
        moe = self.cfg.moe
        if moe is None:
            return total
        tree = transformer.init_params(None, self.cfg, torch.device("meta"))
        expert_leaf = sum(
            bp["moe"][n].numel() for bp in tree["blocks"] if "moe" in bp
            for n in ("w_gate", "w_up", "w_down"))
        return int(total - expert_leaf * (1 - moe.top_k / moe.num_experts))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
