"""Model facade: one object per architecture.

Port of ``repro.models.model_api``.  Vocab sizes are padded to a multiple
of 128 exactly as in the reference (labels never reference pad rows; the pad
is included in the reported parameter count).  Encoder-decoder and
audio-stub archs (whisper-base) dispatch to :mod:`repro_torch.models.
encdec`, every other family to :mod:`repro_torch.models.transformer`
(a vision stub's ``extra_embeds`` prepended to the text).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.parallel import SINGLE, ParallelCtx
from repro_torch.refusal import Refusal

VOCAB_PAD_TO = 128


def padded_vocab(v: int) -> int:
    return int(math.ceil(v / VOCAB_PAD_TO) * VOCAB_PAD_TO)


@dataclass
class Model:
    cfg: ModelConfig

    def __post_init__(self):
        self.cfg = self.cfg.with_(vocab_size=padded_vocab(self.cfg.vocab_size))
        self.is_encdec = (self.cfg.family == "encdec"
                        or self.cfg.frontend == "audio_stub")
        self._module = encdec if self.is_encdec else transformer

    def init(self, generator: torch.Generator,
             device: str | torch.device = "cuda") -> dict:
        """Fresh parameters on ``device``, drawn from ``generator`` (which
        must live on that device)."""
        dev = resolve_device(device)
        if generator.device.type != dev.type:
            raise ValueError(f"generator lives on {generator.device}, "
                             f"parameters are made on {dev}")
        return self._module.init_params(generator, self.cfg, dev)

    def abstract_params(self) -> dict:
        """The parameter tree on the ``meta`` device (shapes and dtypes
        only, nothing allocated)."""
        return self._module.init_params(None, self.cfg, torch.device("meta"))

    def param_specs(self, mesh):
        """The ``tp``-policy spec tree of the parameters on ``mesh`` (the
        data axes are realised by the step's flat shards, never by the
        parameter specs, as in the reference)."""
        from repro_torch.sharding.rules import param_specs

        return param_specs(self.abstract_params(),
                           self.cfg.with_(sharding="tp"), mesh)

    def loss_fn(self, params: dict, batch: dict, *,
                ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
                block_resolver=None,
                stats_out: list | None = None) -> torch.Tensor:
        """Token-mean cross entropy of ``batch`` plus the weighted MoE
        load-balancing loss (the reference's ``Model.loss_fn`` on one rank
        of the mesh ``ctx`` describes); ``block_resolver`` gathers FSDP
        blocks (:func:`transformer.forward`; decoder-only, as in the
        reference); ``stats_out`` receives ``{"moe_drop_fraction": ...}``
        (0 for an encoder-decoder stack, which has no MoE layer)."""
        if self.is_encdec:
            if block_resolver is not None:
                raise Refusal(
                    "FSDP block_resolver is decoder-only; enc-dec archs use "
                    "tp/zero1 sharding")
            if stats_out is not None:
                stats_out.append({"moe_drop_fraction": torch.zeros(
                    (), dtype=torch.float32,
                    device=batch["tokens"].device)})
            return encdec.loss_fn(params, batch, self.cfg, ctx=ctx,
                                  causal_skip=causal_skip)
        return transformer.loss_fn(params, batch, self.cfg, ctx=ctx,
                                   causal_skip=causal_skip,
                                   block_resolver=block_resolver,
                                   stats_out=stats_out)

    def forward(self, params: dict, batch: dict, *,
                ctx: ParallelCtx = SINGLE, causal_skip: bool = False,
                attn_impl: str = "blockwise",
                block_resolver=None) -> torch.Tensor:
        """Logits over this rank's vocab shard (all of it on one rank):
        of ``batch["frames"]`` and the tokens for an encoder-decoder, else
        of the tokens behind ``batch["extra_embeds"]`` where it is given
        (their positions included)."""
        if self.is_encdec:
            if block_resolver is not None:
                raise Refusal(
                    "FSDP block_resolver is decoder-only")
            return encdec.forward(params, batch["frames"], batch["tokens"],
                                  self.cfg, ctx=ctx, causal_skip=causal_skip,
                                  attn_impl=attn_impl)
        logits, _, _ = transformer.forward(
            params, batch["tokens"], self.cfg, ctx=ctx,
            extra_embeds=batch.get("extra_embeds"), causal_skip=causal_skip,
            attn_impl=attn_impl, block_resolver=block_resolver)
        return logits

    def init_decode_state(self, batch: int, seq_len: int, *, params=None,
                          frames: torch.Tensor | None = None,
                          ctx: ParallelCtx = SINGLE,
                          cache_dtype: torch.dtype = torch.bfloat16,
                          attn_impl: str = "blockwise",
                          device: str | torch.device = "cuda") -> list:
        """Zero decode state for ``batch`` sequences of ``seq_len``
        positions on ``device`` (KV caches in ``cache_dtype``, SSM states
        in fp32).  An encoder-decoder runs its encoder over ``frames``
        with ``params`` first (through ``attn_impl``) and caches the cross
        k/v beside empty self-attention caches, on the parameters'
        device."""
        if self.is_encdec:
            if params is None or frames is None:
                raise ValueError(f"{self.cfg.name}: the decode state of an "
                                 f"encoder-decoder needs params and frames")
            return encdec.init_decode_state(params, frames, self.cfg, batch,
                                            seq_len, cache_dtype=cache_dtype,
                                            ctx=ctx, attn_impl=attn_impl)
        return transformer.init_decode_state(self.cfg, batch, seq_len,
                                             cache_dtype=cache_dtype,
                                             device=resolve_device(device))

    def decode_step(self, params: dict, token: torch.Tensor, state: list,
                    pos: int, *, ctx: ParallelCtx = SINGLE,
                    seq_len: int | None = None,
                    block_resolver=None) -> tuple[torch.Tensor, list]:
        if self.is_encdec:
            if block_resolver is not None:
                raise Refusal(
                    "FSDP block_resolver is decoder-only")
            return encdec.decode_step(params, token, state, pos, self.cfg,
                                      ctx=ctx)
        return transformer.decode_step(params, token, state, pos, self.cfg,
                                       ctx=ctx, seq_len=seq_len,
                                       block_resolver=block_resolver)

    def param_count(self) -> int:
        """Element count of the tree, from shapes alone (nothing allocated)."""
        return sum(t.numel() for t in _leaves(self.abstract_params()))

    def active_param_count(self) -> int:
        """MoE: only ``top_k`` of ``num_experts`` expert stacks are active
        per token; the count of the others is taken out."""
        total = self.param_count()
        moe = self.cfg.moe
        if moe is None:
            return total
        tree = self.abstract_params()
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
