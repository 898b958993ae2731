"""Serving-step builders: prefill and single-token decode.

Port of ``repro.runtime.serve_step``.  The prefill returns logits and fills
no cache, and the decode step decodes one token against the contiguous
rolling caches, as in the reference.  The decode step writes the caches in
place, which stands for the reference's donation of the state.
Every family is served: a prefill batch carries a vision stub's
``extra_embeds`` or an encoder-decoder's ``frames`` beside the tokens, an
SSM or hybrid layer's decode state is its fp32 scan state, and an
encoder-decoder's is made by running its encoder over the frames
(:func:`init_decode_state` with ``params`` and ``frames``).

``weight_mode``:

* ``resident`` — every rank holds the whole parameter tree;
* ``gathered`` — the parameters are FSDP flat shards
  (``{"groups": {name: [shards]}}``, :meth:`FsdpPlan.shard_state` of the
  plan the step was built with, ``TrainStepConfig(dp_mode="fsdp")``, the
  step's ``fsdp``; :func:`serve_params` makes them), each rank holding
  ``1/world`` of every bucket of its model block; the root groups are
  gathered in bf16 at every call and each block as the model reaches it.
  Decoder-only stacks only, as in the reference.

A step built over a mesh of several ranks (``mesh``; one rank by
default) takes the global batch and computes this rank's rows of it, as
the reference shards the batch over ``("pod", "data")`` when they divide
it, else over ``data`` alone, else not at all; the decode state holds this
rank's rows (:func:`local_batch`).  Under ``gathered`` every rank must
call the step together: the gathers are collectives.

On a mesh with a model axis above 1 the step runs tensor-parallel: the
parameters are this rank's blocks (:func:`resident_params`; under
``gathered`` its data shards of them, gathered over the data axes), the decode
state is laid out by ``decode_state_specs`` (:func:`init_decode_state`:
caches of 8192 slots or more are sequence-sharded over the model axis),
and the logits are this rank's vocab shard; :func:`gather_vocab` gathers
them (``step.ctx``, the step's context).  Building the step makes the
model axis's process groups, and every rank calls it together.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.configs.base import ShapeConfig
from repro_torch.core.topology import RankMesh
from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.models.model_api import Model
from repro_torch.models.parallel import SINGLE, ParallelCtx, make_ctx
from repro_torch.refusal import Refusal
from repro_torch.runtime.train_step import (FsdpPlan, TrainStepConfig,
                                            data_mesh, model_size_of)
from repro_torch.sharding.rules import (decode_state_specs, local_shapes,
                                        local_shard, map_specs)

WEIGHT_MODES = ("resident", "gathered")


def _check_weight_mode(weight_mode: str) -> None:
    if weight_mode not in WEIGHT_MODES:
        raise ValueError(f"weight_mode must be one of {WEIGHT_MODES}, got "
                         f"{weight_mode!r}")


def _require_decoder_only(cfg, what: str) -> None:
    """Gathered serving streams the parameters through the decoder-only
    forward and decode step; any other family (encoder-decoder, SSM and
    hybrid state, audio or vision front ends) is refused when the step is
    built, as the reference refuses it."""
    if cfg.family not in ("dense", "moe") or cfg.frontend is not None:
        raise Refusal(
            f"gathered {what} is decoder-only: family={cfg.family!r} "
            f"frontend={cfg.frontend!r} is not supported (use "
            f"weight_mode='resident')")


def _batch_rows(mesh: RankMesh, global_batch: int) -> slice:
    """This rank's rows of the global batch (the reference's
    ``batch_spec``)."""
    sizes = mesh.sizes()
    rank = dist.get_rank() if dist.is_initialized() else 0
    coords = dict(zip(mesh.axis_names, mesh.coords(rank)))
    axes = [a for a in ("pod", "data") if a in sizes]
    for cand in (axes, [a for a in ("data",) if a in sizes]):
        p = math.prod(sizes[a] for a in cand)
        if cand and global_batch % p == 0:
            idx = 0
            for a in cand:
                idx = idx * sizes[a] + coords[a]
            n = global_batch // p
            return slice(idx * n, (idx + 1) * n)
    return slice(0, global_batch)


def local_batch(shape_cfg: ShapeConfig, mesh: RankMesh | None = None) -> int:
    """The rows of ``shape_cfg.global_batch`` a rank of ``mesh`` serves:
    the batch of its decode state."""
    rows = _batch_rows(mesh or data_mesh(1), shape_cfg.global_batch)
    return rows.stop - rows.start


def resident_params(model: Model, params, mesh: RankMesh | None = None):
    """This rank's blocks of a full parameter tree for resident serving on
    ``mesh`` (the tree itself without a model axis above 1)."""
    mesh = mesh or data_mesh(1)
    if model_size_of(mesh) == 1:
        return params
    rank = dist.get_rank() if dist.is_initialized() else 0
    return local_shard(params, model.param_specs(mesh), mesh, rank)


def init_decode_state(model: Model, shape_cfg: ShapeConfig,
                      mesh: RankMesh | None = None, *,
                      params=None, frames=None,
                      ctx: ParallelCtx | None = None,
                      cache_dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda") -> list:
    """Decode state of this rank for ``shape_cfg`` (global batch and cache
    length) on ``mesh``: its rows, and on a model axis above 1 its slots of
    every sequence-sharded cache and its ``d_inner`` channels of every SSM
    state (``decode_state_specs``).  Zeros (KV caches in ``cache_dtype``,
    SSM states fp32), except an encoder-decoder's: its encoder runs once
    over this rank's rows of the global ``frames`` with ``params`` (the
    step's parameters; on a model axis this rank's blocks, with the step's
    ``ctx``), its self-attention on the ``flash_attn`` kernel as the
    prefill's, and the cross k/v it caches sit beside empty
    self-attention caches."""
    mesh = mesh or data_mesh(1)
    dev = resolve_device(device)
    if model.is_encdec:
        return _encdec_state(model, shape_cfg, mesh, params, frames, ctx,
                             cache_dtype, dev)
    full = transformer.init_decode_state(model.cfg, shape_cfg.global_batch,
                                         shape_cfg.seq_len,
                                         cache_dtype=cache_dtype,
                                         device=torch.device("meta"))
    specs = decode_state_specs(full, model.cfg, mesh, shape_cfg.global_batch)
    if model_size_of(mesh) == 1:
        # the data-parallel rows, as build_decode_step serves them
        b = local_batch(shape_cfg, mesh)
        return transformer.init_decode_state(model.cfg, b, shape_cfg.seq_len,
                                             cache_dtype=cache_dtype,
                                             device=dev)
    return map_specs(lambda leaf, shape: torch.zeros(
        shape, dtype=leaf.dtype, device=dev), full,
        local_shapes(full, specs, mesh))


def _encdec_state(model: Model, shape_cfg: ShapeConfig, mesh: RankMesh,
                  params, frames, ctx, cache_dtype: torch.dtype,
                  dev: torch.device) -> list:
    """:func:`init_decode_state` of an encoder-decoder: its self caches are
    never sequence-sharded (its decode step scores the whole cache)."""
    if params is None or frames is None:
        raise ValueError(f"{model.cfg.name}: an encoder-decoder's decode "
                         f"state runs the encoder: pass params and frames")
    if model_size_of(mesh) > 1 and shape_cfg.seq_len >= 8192:
        raise Refusal(
            f"{model.cfg.name}: a cache of {shape_cfg.seq_len} slots would "
            f"be sequence-sharded, which the encoder-decoder's decode step "
            f"does not score")
    rows = _batch_rows(mesh, shape_cfg.global_batch)
    frames = torch.as_tensor(frames, device=dev)[rows]
    return model.init_decode_state(
        frames.shape[0], shape_cfg.seq_len, params=params, frames=frames,
        ctx=ctx or SINGLE, cache_dtype=cache_dtype, attn_impl="kernel")


def serve_params(step, model: Model, params, mesh: RankMesh | None = None):
    """The parameters a built prefill or decode ``step`` takes, from the
    full tree: this rank's blocks (``resident``), or this rank's fsdp
    shards of them (``gathered``, the step's plan)."""
    local = resident_params(model, params, mesh)
    if step.fsdp is None:
        return local
    return {"groups": step.fsdp.shard_state(local)}


def gather_vocab(ctx: ParallelCtx, logits: torch.Tensor) -> torch.Tensor:
    """The ranks' vocab shards of ``logits`` (last dimension) gathered into
    the whole vocabulary, on every rank (the identity at one rank)."""
    if ctx.model_size() == 1:
        return logits
    t = logits.movedim(-1, 0)
    return ctx.gather_replicated(t).movedim(0, -1)


def _weights(model: Model, mesh: RankMesh, weight_mode: str, what: str):
    """``(fn, plan)``: ``fn`` maps the step's ``params`` to the tree and the
    keyword arguments the model is called with: the parameters as they are
    (``resident``, plan ``None``; this rank's blocks on a model axis), or
    the gathered roots and the block resolver of the :class:`FsdpPlan`
    ``plan`` (``gathered``; building it makes its process groups)."""
    _check_weight_mode(weight_mode)
    if weight_mode == "resident":
        return (lambda params: (params, {})), None
    _require_decoder_only(model.cfg, what)
    plan = FsdpPlan(model, mesh, TrainStepConfig(dp_mode="fsdp"))

    def gathered(params):
        tree, resolver = plan.params_and_resolver(params["groups"],
                                                  torch.bfloat16)
        return tree, {"block_resolver": resolver}

    return gathered, plan


def build_prefill(model: Model, shape_cfg: ShapeConfig, *,
                  weight_mode: str = "resident", causal_skip: bool = True,
                  attn_impl: str = "kernel",
                  device: str | torch.device = "cuda",
                  mesh: RankMesh | None = None):
    """Returns ``prefill(params, batch) -> logits (B, S, V_local)`` for
    batches of ``shape_cfg``'s global_batch and seq_len; ``B`` is this
    rank's rows (all of them on one rank), ``V_local`` its vocab shard (all
    of it without a model axis).  The batch holds the tokens and the
    arch's stub inputs, as ``Model.input_specs`` gives them in the
    reference: a vision stub's ``extra_embeds`` (B, P, d) ahead of
    ``seq_len - P`` tokens (the logits cover all ``seq_len`` positions), an
    encoder-decoder's ``frames`` (B, F, d) beside ``seq_len`` tokens.  With
    ``attn_impl="kernel"`` every global or windowed layer's
    self-attention runs the ``flash_attn`` kernel (its plain version for
    CPU tensors) on this rank's real heads, and a chunked-local layer and
    every cross-attention the blockwise loop
    (:func:`~repro_torch.models.transformer.layer_attn_impl`,
    :mod:`~repro_torch.models.encdec`); ``"blockwise"`` runs the
    reference's blockwise loop everywhere."""
    dev = resolve_device(device)
    mesh = mesh or data_mesh(1)
    weights, plan = _weights(model, mesh, weight_mode, "prefill")
    ctx = make_ctx(mesh)              # the model axis's groups come after
    cfg = model.cfg
    text = shape_cfg.seq_len
    if cfg.frontend == "vision_stub" and cfg.frontend_seq:
        text -= cfg.frontend_seq
    want = (shape_cfg.global_batch, text)
    rows = _batch_rows(mesh, shape_cfg.global_batch)

    def prefill(params: dict, batch: dict) -> torch.Tensor:
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        if tuple(tokens.shape) != want:
            raise ValueError(f"prefill built for tokens {want}, got "
                             f"{tuple(tokens.shape)}")
        mine = {"tokens": tokens[rows]}
        for k in ("extra_embeds", "frames"):
            if k in batch:
                mine[k] = torch.as_tensor(batch[k], device=dev)[rows]
        with torch.no_grad():
            tree, kw = weights(params)
            return model.forward(tree, mine, ctx=ctx,
                                 causal_skip=causal_skip, attn_impl=attn_impl,
                                 **kw)

    prefill.ctx, prefill.fsdp = ctx, plan
    return prefill


def build_decode_step(model: Model, shape_cfg: ShapeConfig, *,
                      weight_mode: str = "resident",
                      device: str | torch.device = "cuda",
                      mesh: RankMesh | None = None):
    """Returns ``decode(params, token, state, pos) -> (logits (B,
    V_local), state)`` for the ``shape_cfg.global_batch`` tokens ``token``
    against caches of ``shape_cfg.seq_len`` positions (this rank's
    :func:`init_decode_state`: its :func:`local_batch` rows, which ``B``
    counts, and its slots of a sequence-sharded cache)."""
    dev = resolve_device(device)
    mesh = mesh or data_mesh(1)
    weights, plan = _weights(model, mesh, weight_mode, "decode")
    ctx = make_ctx(mesh)              # the model axis's groups come after
    seq_len = shape_cfg.seq_len
    rows = _batch_rows(mesh, shape_cfg.global_batch)

    def decode(params: dict, token, state: list, pos: int):
        token = torch.as_tensor(token, device=dev)
        with torch.no_grad():
            tree, kw = weights(params)
            return model.decode_step(tree, token[rows], state, int(pos),
                                     ctx=ctx, seq_len=seq_len, **kw)

    decode.ctx, decode.fsdp = ctx, plan
    return decode
