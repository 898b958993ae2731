"""The data-parallel train step: ``replicated``, ``zero1`` and ``fsdp``.

Port of ``repro.runtime.train_step``.  Every rank computes the gradients of
its shard of the global batch with autograd, and the
:class:`~repro_torch.comm.api.Communicator` reduces them (mean) with its
transport, issuing each bucket at its :class:`CommSchedule` slot.

* ``replicated`` — every rank holds the parameters and the AdamW state;
  the gradients are all-reduced.  The 2017 paper's setting.
* ``zero1`` — the gradients are *reduce-scattered* into flat shards (one
  per bucket, or one per fused arena span); each rank keeps the AdamW
  moments of its own shards only, updates them, and the parameter
  **delta** is all-gathered and applied to the full parameters with the
  decoupled weight decay.  The same wire volume as the all-reduce; the
  optimizer memory falls by the data world size.  The global gradient
  norm is the shards' weighted sum of squares, all-reduced once over data
  and once over the model axis (:func:`norm_weight_runs`: the arena's
  page padding weighs 0, a model-replicated field ``1/model_size``).

Tensor parallelism: over a ``("data", "model")`` mesh (``"pod"`` may lead)
each rank holds its block of every parameter (:meth:`Model.param_specs`,
:func:`~repro_torch.sharding.rules.local_shard`) and of the AdamW state,
the model code calls the model-axis collectives of :func:`make_ctx`'s
context (Megatron-style), and the communicator reduces over the data axes
only: over the ranks that share this rank's model index, whose local
shards have the same shapes.  Every mode runs on a model axis: under
``fsdp`` the flat buckets are those of this rank's block, sharded over the
data axes, as the reference's.

With
``use_arena`` the gradients pack into the page-aligned
:class:`~repro_torch.mem.arena.CommArena` (a tensor in the train state,
allocated once and written in place every step) and each channel's
contiguous span is reduced as one collective.

``wire_codec="int8"`` quantizes the wire: ring hops carry int8 payloads
with one fp32 scale per block, and with ``use_arena`` the arena is the int8
:class:`~repro_torch.mem.arena.QuantCommArena` written by the fused
pack+quantize kernel, and the state grows an ``"ef"`` tensor, the fp32
error-feedback residual of every payload element, compensated into every
encode so that the quantisation error telescopes instead of accumulating.
Both are allocated once and updated in place.

``fsdp`` (ZeRO-3): every block, and each root entry (the embedding, the
final norm), is a group of flat fp32 bucket shards (:class:`FsdpPlan`),
and each rank keeps only its ``1/world`` of every bucket, with the AdamW
moments of that shard.  The step gathers each group in ``gather_dtype``
(bf16) as the model reaches it, the blocks inside their ``remat="layer"``
recomputation, through :meth:`Communicator.gather_flat`, whose backward is
the reduce-scatter: the gradients arrive as shards, and the schedule only
shapes their accumulation over microbatches (the arena is then the
accumulation buffer).  The shards are updated in place of the parameters.
``fsdp_gather="native"`` gathers with ``dist.all_gather_into_tensor``,
``"ring"`` with the transport's ring, whose reduce-scatter adds with the
``reduce_add`` kernel; a wire codec is refused with the ring gather.  On a
model axis the gathered block is this rank's block of the layer, and the
layer's model-axis collectives run inside the same recomputed function.

MoE expert parallelism rides a communicator of its own
(:func:`build_moe_comm`): ``moe_transport`` / ``moe_channels`` configure
the one-axis all-to-all over ``"model"`` that the models reach through
``ParallelCtx.all_to_all`` (the capacity buffer's dispatch and combine);
its traffic records into that communicator's record (``step.moe_comm``).
The routing's capacity drops surface as the ``moe_drop_fraction``
metric, averaged over the data axes, next to the loss in every mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from functools import cached_property
from typing import Sequence

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import REPLICATED, SHARDED, Blocks, RankShards
from repro_torch.comm.api import CommConfig, Communicator
from repro_torch.comm.schedule import (SCHEDULE_POLICIES, CommSchedule,
                                       build_schedule)
from repro_torch.core.bucketing import BucketPlan
from repro_torch.core.p2p import CommRecord, RingAxis
from repro_torch.core.reducer import ReduceConfig
from repro_torch.core.topology import RankMesh
from repro_torch.fake import is_fake
from repro_torch.mem.arena import CommArena, QuantCommArena
from repro_torch.mem.layout import (ArenaLayout, QuantArenaLayout, plan_arena,
                                    plan_quant_arena)
from repro_torch.models.model_api import Model
from repro_torch.models.parallel import make_ctx
from repro_torch.models.transformer import moe_layer_count
from repro_torch.optim import (OptimConfig, adamw_flat_update,
                               adamw_tree_update, clip_factor,
                               global_grad_norm, init_opt_state,
                               init_opt_state_flat, make_schedule)
from repro_torch.refusal import Refusal
from repro_torch.sharding.rules import (MODEL_AXIS, is_model_sharded,
                                        local_shapes, local_shard, map_specs,
                                        spec_leaves)

DP_MODES = ("replicated", "zero1", "fsdp")
FSDP_GATHERS = ("native", "ring")


def require_ported(dp_mode: str) -> None:
    """Every mode of :data:`DP_MODES` is ported; any other raises."""
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}, got "
                         f"{dp_mode!r}")


@dataclass(frozen=True)
class TrainStepConfig:
    dp_mode: str = "replicated"
    comm: CommConfig | None = None     # preferred: the Communicator config
    reduce: ReduceConfig = field(default_factory=ReduceConfig)  # legacy
    optim: OptimConfig = field(default_factory=OptimConfig)
    microbatches: int = 1              # grad-accumulation slices
    schedule: str = "accumulate_then_reduce"  # SCHEDULE_POLICIES member
    use_arena: bool = False            # page-aligned CommArena, fused spans
    wire_codec: str | None = None      # None | "int8": quantized wire; with
                                       # use_arena the int8 arena and the
                                       # "ef" state tensor
    causal_skip: bool = False
    gather_dtype: str = "bfloat16"     # fsdp weight-gather wire dtype
    fsdp_bucket_bytes: int = 512 * 2**20
    fsdp_gather: str = "native"        # "native" (dist.all_gather_into_
                                       # tensor) | "ring" (the transport's)
    moe_transport: str = "a2a"         # EP dispatch/combine over the model
                                       # axis: "a2a" (all_to_all_single) |
                                       # "ring" | "ring_hier" (p - 1 hops) |
                                       # "psum" (replicated fallback)
    moe_channels: int = 0              # stripe the EP payload's feature dim
                                       # over N rails (0/1 = one)

    def comm_config(self, data_axes: tuple[str, ...]) -> CommConfig:
        """The communicator config for this step: ``comm`` when given,
        otherwise the legacy ``reduce`` policy mapped onto a transport."""
        ccfg = self.comm if self.comm is not None else self.reduce.comm_config()
        if self.wire_codec is not None:
            ccfg = replace(ccfg, wire_codec=self.wire_codec)
        if (ccfg.wire_codec is not None and self.dp_mode == "fsdp"
                and self.fsdp_gather == "ring"):
            # the reduction is the gather's backward, which carries no
            # codec: the quantized wire would silently fall away
            raise ValueError(
                "wire_codec is incompatible with fsdp_gather='ring' "
                "(the reduction rides the gather transpose and the "
                "codec has no useful gradient); use fsdp_gather="
                "'native'")
        return replace(ccfg, data_axes=data_axes)

    @property
    def schedule_policy(self) -> str:
        if self.schedule not in SCHEDULE_POLICIES:
            raise ValueError(f"unknown schedule policy {self.schedule!r}; "
                             f"one of {SCHEDULE_POLICIES}")
        return self.schedule


def build_moe_comm(mesh: RankMesh, cfg: TrainStepConfig
                   ) -> Communicator | None:
    """The EP communicator over the model axis whose ``all_to_all`` the
    models' context carries (None without a model axis of two ranks or
    more: nothing would move).  Building it makes process groups: every
    rank builds it at the same point, after the data communicator and
    before the model axis's own ring
    (:func:`~repro_torch.models.parallel.make_ctx`)."""
    if mesh.sizes().get(MODEL_AXIS, 1) < 2:
        return None
    return Communicator(mesh, CommConfig(
        transport=cfg.moe_transport, data_axes=(MODEL_AXIS,),
        channels=cfg.moe_channels))


def data_mesh(world: int) -> RankMesh:
    """The data-parallel mesh: every rank on one ``data`` axis."""
    return RankMesh(("data",), (world,))


def model_size_of(mesh: RankMesh) -> int:
    return mesh.sizes().get(MODEL_AXIS, 1)


def shard_batch(batch: dict, index: int, world: int) -> dict:
    """This rank's rows of a global batch (the reference's ``P("data")``
    batch spec: rank ``r`` holds rows ``r*B/p .. (r+1)*B/p``)."""
    out = {}
    for k, v in batch.items():
        if v.shape[0] % world:
            raise ValueError(f"global batch {v.shape[0]} does not split "
                             f"over {world} ranks")
        n = v.shape[0] // world
        out[k] = v[index * n:(index + 1) * n]
    return out


def abstract_params(model: Model) -> dict:
    """The parameter tree on the ``meta`` device (shapes and dtypes only)."""
    return model.abstract_params()


def build_norm_weights(plan: BucketPlan, specs_flat: Sequence | None = None,
                       model_size: int = 1) -> list[torch.Tensor]:
    """Per-bucket fp32 weight vectors of the zero1 gradient norm: 1.0 on
    model-sharded fields, ``1/model_size`` elsewhere (``specs_flat``: each
    leaf's spec in flatten order), so that the sum over the model axis
    counts every parameter once."""
    rep_w = 1.0 / max(model_size, 1)
    weights = [torch.full((n,), rep_w, dtype=torch.float32)
               for n in plan.bucket_sizes]
    if specs_flat is not None:
        for f in plan.fields:
            if is_model_sharded(specs_flat[f.leaf]):
                weights[f.bucket][f.offset:f.offset + f.size] = 1.0
    return weights


def build_span_norm_weights(layout: ArenaLayout | QuantArenaLayout,
                            bucket_weights: Sequence[torch.Tensor]
                            ) -> list[torch.Tensor]:
    """Per-*span* norm weights of the arena's zero1 path: each span's
    vector holds its buckets' weights at their offsets in the span and 0 on
    the page padding, which must never count in the norm."""
    out = []
    for sp in layout.spans:
        w = torch.zeros((sp.size,), dtype=torch.float32)
        for b in sp.buckets:
            seg = layout.segment_of(b)
            off = seg.offset - sp.offset
            w[off:off + seg.size] = bucket_weights[b]
        out.append(w)
    return out


def _owned_range(n: int, rings: Sequence[RingAxis]) -> tuple[int, int]:
    """This rank's reduce-scatter shard of an ``n``-element buffer as the
    range ``[start, stop)``, in the ring's ownership layout (``rings``
    inner axis first): rank ``r`` of an axis of ``p`` owns elements
    ``[r*n/p, (r+1)*n/p)`` of what the axes before it left."""
    start = 0
    for ring in rings:
        n //= ring.size
        start += ring.index * n
    return start, start + n


def _slice_like_shard(w: torch.Tensor,
                      rings: Sequence[RingAxis]) -> torch.Tensor:
    """``w`` cut down to this rank's reduce-scatter shard."""
    start, stop = _owned_range(w.shape[0], rings)
    return w[start:stop]


Runs = list[tuple[int, int, float]]


def norm_weight_runs(plan: BucketPlan, specs_flat: Sequence | None = None,
                     model_size: int = 1) -> list[Runs]:
    """:func:`build_norm_weights` as runs ``(start, stop, value)`` covering
    each bucket, read from the plan's fields without building the vector
    (nor reading one: the dry-run's fake tensors hold no values)."""
    rep_w = float(torch.tensor(1.0 / max(model_size, 1),
                               dtype=torch.float32, device="cpu"))
    sharded: list[list[tuple[int, int]]] = [[] for _ in plan.bucket_sizes]
    if specs_flat is not None:
        for f in plan.fields:
            if is_model_sharded(specs_flat[f.leaf]):
                sharded[f.bucket].append((f.offset, f.offset + f.size))
    out = []
    for n, ones in zip(plan.bucket_sizes, sharded):
        runs, at = [], 0
        for a, z in sorted(ones):
            if at < a:
                runs.append((at, a, rep_w))
            runs.append((a, z, 1.0))
            at = z
        if at < n:
            runs.append((at, n, rep_w))
        out.append(runs)
    return out


def span_norm_weight_runs(layout: ArenaLayout | QuantArenaLayout,
                          bucket_runs: Sequence[Runs]) -> list[Runs]:
    """:func:`build_span_norm_weights` as runs: each span's buckets' runs at
    their offsets in the span, 0 on the page padding."""
    out = []
    for sp in layout.spans:
        runs, at = [], 0
        for b in sp.buckets:
            off = layout.segment_of(b).offset - sp.offset
            if at < off:
                runs.append((at, off, 0.0))
            runs += [(off + a, off + z, v) for a, z, v in bucket_runs[b]]
            at = runs[-1][1] if runs else at
        if at < sp.size:
            runs.append((at, sp.size, 0.0))
        out.append(runs)
    return out


def norm_ranges_from_runs(weight_runs: Sequence[Runs],
                          rings: Sequence[RingAxis]) -> tuple[list, list]:
    """Per zero1 shard, the runs of one value of its norm weights
    (``weight_runs``: :func:`norm_weight_runs`, under the arena
    :func:`span_norm_weight_runs`) cut to this rank's shard: the
    shard-local ranges and their values, equal neighbours merged, the runs
    of 0 (page padding) left out.  The step sums the squares over these
    ranges, so that no weight vector lives beside the shards."""
    all_ranges, all_values = [], []
    for runs in weight_runs:
        n = runs[-1][1] if runs else 0
        start, stop = _owned_range(n, rings)
        merged: Runs = []
        for a, z, v in runs:
            a, z = max(a, start) - start, min(z, stop) - start
            if a >= z:
                continue
            if merged and merged[-1][2] == v and merged[-1][1] == a:
                merged[-1] = (merged[-1][0], z, v)
            else:
                merged.append((a, z, v))
        kept = [(a, z, v) for a, z, v in merged if v != 0]
        all_ranges.append([(a, z) for a, z, _ in kept])
        all_values.append([v for _, _, v in kept])
    return all_ranges, all_values


class FsdpPlan:
    """Per-group flat-bucket layout of ``fsdp``: every block (``blocks.i``)
    and each root entry (``root.embed``, ``root.final_norm``) is bucketed
    on its own, so that a layer gathers and releases its weights alone.
    The buckets hold this rank's block of each group (the model-local
    shapes of :meth:`Model.param_specs`; the whole group without a model
    axis), sharded over the data axes.

    Owns the communicator of the fsdp collectives, with buckets of
    ``cfg.fsdp_bucket_bytes``; building it creates process groups, which is
    collective (every rank builds its plans in the same order).  Under
    ``use_arena`` the arena layout holds one segment per group-bucket shard,
    in the sorted-name order in which the gradient tree flattens: fp32, or
    the int8 layout under a wire codec.  :attr:`norm_runs` holds, per
    group, :func:`norm_weight_runs` of its buckets.
    """

    def __init__(self, model: Model, mesh: RankMesh, cfg: TrainStepConfig,
                 *, connect: bool = True):
        if cfg.fsdp_gather not in FSDP_GATHERS:
            raise ValueError(f"fsdp_gather must be one of {FSDP_GATHERS}, "
                             f"got {cfg.fsdp_gather!r}")
        if model.is_encdec:
            # the reference's Model.loss_fn refuses the block resolver
            raise Refusal(
                f"{model.cfg.name}: FSDP block_resolver is decoder-only; "
                f"enc-dec archs use tp/zero1 sharding")
        self.model = model
        self.mesh = mesh
        self.gather_impl = cfg.fsdp_gather
        self.comm = Communicator(mesh, replace(
            cfg.comm_config(("pod", "data")),
            bucket_bytes=cfg.fsdp_bucket_bytes), connect=connect)
        if self.gather_impl == "ring" and not self.comm.spec.supports_rs:
            raise ValueError(
                f"fsdp_gather='ring' needs a transport with supports_rs; "
                f"{self.comm.cfg.transport!r} has none — use fsdp_gather="
                f"'native' or a ring transport")
        self.dp_world = self.comm.world
        self.bucketer = self.comm.bucketer
        self.specs = model.param_specs(mesh)
        full = abstract_params(model)
        local = map_specs(lambda leaf, shape: torch.empty(
            shape, dtype=leaf.dtype, device="meta"), full,
            local_shapes(full, self.specs, mesh))
        self.block_keys = [k for k in ("blocks",) if k in local]
        self.groups: dict[str, object] = {}
        for k in sorted(local):
            if k in self.block_keys:
                for i, blk in enumerate(local[k]):
                    self.groups[f"{k}.{i}"] = blk
            else:
                self.groups[f"root.{k}"] = local[k]
        self.plans = {name: self.bucketer.plan(tree)
                      for name, tree in self.groups.items()}
        self.shard_sizes = {name: [n // self.dp_world
                                   for n in plan.bucket_sizes]
                            for name, plan in self.plans.items()}
        self.arena_layout: ArenaLayout | QuantArenaLayout | None = None
        if cfg.use_arena:
            sizes = [n for name in sorted(self.plans)
                     for n in self.shard_sizes[name]]
            if self.comm.codec is not None:
                self.arena_layout = plan_quant_arena(
                    sizes, page_bytes=self.comm.cfg.page_bytes,
                    block=self.comm.cfg.codec_block)
            else:
                self.arena_layout = plan_arena(
                    sizes, page_bytes=self.comm.cfg.page_bytes,
                    dtype=torch.float32)
        self.model_size = model_size_of(mesh)
        self.norm_runs = {
            name: norm_weight_runs(
                self.plans[name],
                spec_leaves(self._group_of(self.specs, name)),
                self.model_size)
            for name in self.groups}

    @cached_property
    def norm_weights(self) -> dict[str, list[torch.Tensor]]:
        """Per group, :func:`build_norm_weights` of its buckets: the vectors
        :attr:`norm_runs` describe."""
        return {name: build_norm_weights(
            self.plans[name], spec_leaves(self._group_of(self.specs, name)),
            self.model_size) for name in self.groups}

    def _group_of(self, tree, name: str):
        kind, _, idx = name.partition(".")
        if kind in self.block_keys:
            return tree[kind][int(idx)]
        return tree[idx]

    def shard_group(self, tree, name: str) -> list[torch.Tensor]:
        """A group's tree -> this rank's flat fp32 shard of each bucket."""
        buckets, _ = self.bucketer.bucketize(tree, self.plans[name])
        rings = tuple(reversed(self.comm.transport.rails[0].axes))
        out = []
        for b in buckets:
            start, stop = _owned_range(b.shape[0], rings)
            out.append(b[start:stop].clone())
        return out

    def shard_state(self, params) -> dict:
        """``{group name: [shards]}`` of a full parameter tree."""
        return {name: self.shard_group(self._group_of(params, name), name)
                for name in self.groups}

    def gather_group(self, shards, name: str,
                     dtype: torch.dtype | None = None):
        """A group's shards -> its tree, gathered over the data axes in
        ``dtype`` (differentiable: the backward is the reduce-scatter)."""
        full = [self.comm.gather_flat(s if dtype is None else s.to(dtype),
                                      native=self.gather_impl != "ring")
                for s in shards]
        return self.bucketer.debucketize(full, self.plans[name],
                                         cast_to=dtype)

    def params_and_resolver(self, groups: dict, dtype: torch.dtype):
        """The root groups gathered now; the blocks left as shard lists,
        with the resolver the model calls inside each layer's recomputed
        function (:func:`~repro_torch.models.transformer.forward`)."""
        params: dict = {}
        for name, shards in groups.items():
            kind, _, idx = name.partition(".")
            if kind == "root":
                params[idx] = self.gather_group(shards, name, dtype)
        for k in self.block_keys:
            n = sum(1 for name in groups if name.startswith(k + "."))
            params[k] = [groups[f"{k}.{i}"] for i in range(n)]

        def resolver(kind: str, i: int, shards):
            return self.gather_group(shards, f"{kind}.{i}", dtype)

        return params, resolver


def _fsdp_schedule(plan: FsdpPlan, microbatches: int) -> CommSchedule:
    """fsdp reports the ``scheduled`` readiness model whatever the policy:
    its reduction is the gather's backward, issued in readiness order."""
    sizes = [n for name in sorted(plan.plans)
             for n in plan.plans[name].bucket_sizes]
    return build_schedule("scheduled", sizes, microbatches=microbatches,
                          channels=plan.comm.cfg.channels)


class TrainStep:
    """``step(state, batch) -> (state, metrics)`` for one rank.

    Builds its :class:`Communicator` on construction, which is collective:
    every rank of the mesh builds its steps in the same order.  Under
    ``zero1`` it also holds the shard sizes of the optimizer state (one per
    bucket, or one per arena span) and, per shard, the ranges that count in
    the gradient norm (:func:`norm_ranges_from_runs`).  Under ``fsdp`` it
    holds the :class:`FsdpPlan` (:attr:`fsdp`), whose communicator is the
    step's, and the same ranges of the plan's norm runs, per group-bucket shard
    in sorted group order.  On a model axis the context's model-axis
    collectives record into :attr:`model_record`, and the EP all-to-alls
    of MoE layers into ``moe_comm.record`` (:attr:`moe_comm`, the
    communicator :func:`build_moe_comm` makes for a MoE stack; None for a
    dense one).

    For checkpoints it holds :attr:`ranks` (this rank's place in the global
    arrays and, over several ranks, a gloo group of its own when the
    default group is not gloo, created with the communicator's groups) and
    gives each state leaf's layout (:meth:`state_layout`).
    """

    def __init__(self, model: Model, mesh: RankMesh, cfg: TrainStepConfig,
                 *, device: torch.device):
        require_ported(cfg.dp_mode)
        self.model = model
        self.mesh = mesh
        self.cfg = cfg
        self.device = device
        self.model_size = model_size_of(mesh)
        self.lr_fn = make_schedule(cfg.optim.schedule,
                                   base_lr=cfg.optim.base_lr,
                                   warmup=cfg.optim.warmup,
                                   total=cfg.optim.total_steps)
        self.shard_sizes: list[int] = []
        self.norm_ranges: list[list[tuple[int, int]]] = []
        self.norm_weights: list[list[float]] = []
        self.fsdp: FsdpPlan | None = None
        self._drops: list = []       # this step's microbatch drop fractions
        self._n_moe = moe_layer_count(model.cfg)
        policy = cfg.schedule_policy
        self.specs = model.param_specs(mesh)
        self.model_record = CommRecord()
        if cfg.dp_mode == "fsdp":
            self.fsdp = FsdpPlan(model, mesh, cfg)
            self.comm = self.fsdp.comm
            self.ranks = self._checkpoint_ranks()
            # the EP communicator's (MoE stacks only) and the model axis's
            # own groups, made after the data communicator's
            self.moe_comm = build_moe_comm(mesh, cfg) if self._n_moe \
                else None
            self.ctx = make_ctx(mesh, self.comm.transport.rails[0].joint,
                                self.model_record, self.moe_comm)
            self.plan = None
            lay = self.fsdp.arena_layout
            self.arena = (None if lay is None else
                          QuantCommArena(lay, impl=self.comm.cfg.local_op)
                          if isinstance(lay, QuantArenaLayout)
                          else CommArena(lay, impl=self.comm.cfg.local_op))
            self.schedule = _fsdp_schedule(self.fsdp, cfg.microbatches)
            rings = tuple(reversed(self.comm.transport.rails[0].axes))
            self.norm_ranges, self.norm_weights = norm_ranges_from_runs(
                [r for name in sorted(self.fsdp.groups)
                 for r in self.fsdp.norm_runs[name]], rings)
            return
        self.comm = Communicator(mesh, cfg.comm_config(("pod", "data")))
        self.ranks = self._checkpoint_ranks()
        # the EP communicator's (MoE stacks only) and the model axis's own
        # groups, made after the data communicator's
        self.moe_comm = build_moe_comm(mesh, cfg) if self._n_moe else None
        self.ctx = make_ctx(mesh, self.comm.transport.rails[0].joint,
                            self.model_record, self.moe_comm)
        local = self.local_params(abstract_params(model))
        self.plan = self.comm.plan(local)
        self.arena = self.comm.arena(local) if cfg.use_arena else None
        self.schedule: CommSchedule = (
            self.comm.arena_schedule(local, policy, cfg.microbatches)
            if cfg.use_arena
            else self.comm.schedule(local, policy, cfg.microbatches))
        if cfg.dp_mode == "zero1":
            if not self.comm.spec.supports_rs:
                raise ValueError(
                    f"dp_mode='zero1' needs a transport with supports_rs; "
                    f"{self.comm.cfg.transport!r} has none (the ring "
                    f"transports do)")
            world = self.comm.world
            rings = tuple(reversed(self.comm.transport.rails[0].axes))
            # the shards follow the fused spans under the arena
            lay = self.arena.layout if self.arena is not None else None
            self.shard_sizes = [n // world for n in (
                [sp.size for sp in lay.spans] if lay is not None
                else self.plan.bucket_plan.bucket_sizes)]
            runs = norm_weight_runs(self.plan.bucket_plan,
                                    spec_leaves(self.specs), self.model_size)
            if lay is not None:
                runs = span_norm_weight_runs(lay, runs)
            self.norm_ranges, self.norm_weights = norm_ranges_from_runs(
                runs, rings)

    @property
    def data_index(self) -> int:
        """This rank's joint index over the data axes: its rows of the
        global batch (the ranks of one model group share them)."""
        data = self.ctx.data
        return data.index if data is not None else 0

    @property
    def data_world(self) -> int:
        return self.ctx.dp_world()

    def local_params(self, params):
        """This rank's block of a full parameter tree (``params`` itself
        without a model axis; a leaf split over the model axis is copied,
        so that the full tree can be freed; abstract ``meta`` leaves stay
        views, and the dry-run's fake ones are copied as real ones are)."""
        if self.model_size == 1:
            return params
        rank = self.comm.rank
        local = local_shard(params, self.specs, self.mesh, rank)
        return tree_util.tree_map(
            lambda blk, full: blk if blk.shape == full.shape or (
                blk.device.type == "meta" and not is_fake(blk))
            else blk.clone(), local, params)

    def _checkpoint_ranks(self) -> RankShards:
        """This rank's place in the global arrays of a checkpoint and the
        host-side group the checkpoint gathers over (over several ranks, a
        gloo group of its own when the default group is not gloo).  A flat
        leaf is split over every axis of the mesh (the reference's
        ``P(('data', 'model'))``): the device at ``(d, m)`` holds block
        ``d * model_size + m``, which must be its rank in the group, and its
        shard must be block ``d`` of the data ring's ownership order (rank
        ``r`` owns elements ``[r*n/p, (r+1)*n/p)`` of every
        reduce-scatter).  Collective over several ranks."""
        if self.mesh.size == 1:
            return RankShards()
        import torch.distributed as dist

        rank = dist.get_rank()
        sizes = self.mesh.sizes()
        coords = dict(zip(self.mesh.axis_names, self.mesh.coords(rank)))
        block = data_block = 0
        for a in self.mesh.axis_names:
            block = block * sizes[a] + coords[a]
            if a != MODEL_AXIS:
                data_block = data_block * sizes[a] + coords[a]
        rings = tuple(reversed(self.comm.transport.rails[0].axes))
        world = self.comm.world
        if self.mesh.size != dist.get_world_size() or block != rank or \
                _owned_range(world, rings) != (data_block, data_block + 1):
            raise Refusal(
                "checkpoints need the mesh laid out in rank order, with the "
                "data ring's ownership following the data coordinate")
        # gloo serves as it is; the dry-run's "fake" backend saves nothing
        backend = str(dist.get_backend())
        group = (None if backend == "gloo" or "fake" in backend
                 else dist.new_group(backend="gloo"))
        return RankShards(rank, self.mesh.size, group,
                          self.mesh if self.model_size > 1 else None)

    def state_layout(self, state: dict) -> dict:
        """Per leaf of ``state``, :data:`~repro_torch.checkpoint.SHARDED`
        where each rank holds its own 1-D block of a flat global array (the
        reference's ``P(('data', 'model'))`` leaves: the arena, ``"ef"``,
        zero1's moment shards, fsdp's groups and their moments),
        :class:`~repro_torch.checkpoint.Blocks` where it holds its block of
        a leaf split over the model axis (a parameter, or a ``replicated``
        AdamW moment, whose spec names ``"model"``),
        :data:`~repro_torch.checkpoint.REPLICATED` elsewhere (the other
        parameters and moments, ``step``)."""
        flat = {"arena", "ef"}
        if self.cfg.dp_mode in ("zero1", "fsdp"):
            flat |= {"opt", "groups"}

        def by_spec(tree):
            return map_specs(
                lambda _, spec: Blocks(spec) if self.model_size > 1 and
                is_model_sharded(spec) else REPLICATED, tree, self.specs)

        out = {}
        for k, v in state.items():
            if k in flat:
                out[k] = tree_util.tree_map(lambda _: SHARDED, v)
            elif k == "params":
                out[k] = by_spec(v)
            elif k == "opt":
                out[k] = {m: by_spec(t) for m, t in v.items()}
            else:
                out[k] = tree_util.tree_map(lambda _: REPLICATED, v)
        return out

    def _grad_fn(self, params, mb):
        """``(loss, grads)`` of one microbatch; under fsdp ``params`` is
        the ``{group: [shards]}`` tree, gathered here, and the gradients
        come back as shards (the gathers' backward reduce-scatters).  The
        microbatch's drop fraction goes to :attr:`_drops`."""
        leaves, treedef = tree_util.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        tree, kw = treedef.unflatten(leaves), {}
        if self.fsdp is not None:
            tree, kw["block_resolver"] = self.fsdp.params_and_resolver(
                tree, getattr(torch, self.cfg.gather_dtype))
        stats: list = []
        loss = self.model.loss_fn(tree, mb, ctx=self.ctx,
                                  causal_skip=self.cfg.causal_skip,
                                  stats_out=stats, **kw)
        self._drops.append(stats[0]["moe_drop_fraction"])
        del tree
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), treedef.unflatten(grads)

    def _drop_metric(self) -> torch.Tensor:
        """The step's ``moe_drop_fraction``: the microbatches' mean,
        averaged over the data axes.  A dense stack's is 0 on every rank,
        so it needs no all-reduce."""
        drop = sum(self._drops) / max(len(self._drops), 1)
        self._drops = []
        drop = torch.as_tensor(drop, dtype=torch.float32, device=self.device)
        return self.ctx.pmean_data(drop) if self._n_moe else drop

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        self._drops = []
        if self.fsdp is not None:
            return self._fsdp_step(state, batch)
        zero1 = self.cfg.dp_mode == "zero1"
        kw = {}
        if self.arena is not None:
            kw = {"arena": self.arena, "arena_buf": state["arena"]}
            if isinstance(self.arena, QuantCommArena):
                kw["ef_buf"] = state["ef"]
        # zero1: the buckets (spans) reduce-scatter as their microbatch's
        # backward finishes; the mean shards accumulate over microbatches
        op = "reduce_scatter" if zero1 else "all_reduce"
        loss, out = self.comm.reduce_scheduled(
            self._grad_fn, state["params"], batch, self.schedule, op=op,
            **kw)
        if not zero1 and self.arena is None:
            out = (out,)
        n_reduced = 2 if zero1 else 1         # (shards, plan) or (tree,)
        extra = out[n_reduced:]               # the arena (and "ef")
        lr = self.lr_fn(state["step"])
        if zero1:
            shards, bplan = out[:2]
            del out
            gnorm = self._shard_norm(shards)
            factor = clip_factor(gnorm, self.cfg.optim.clip_norm)
            for s in shards:                  # step-local: clipped in place
                s.mul_(factor)
            deltas, new_opt = adamw_flat_update(shards, state["opt"],
                                                state["step"], lr,
                                                self.cfg.optim)
            del shards
            # the delta tree: one more full fp32 copy of the parameters
            if self.arena is not None:
                spans = self.comm.all_gather(deltas)
                del deltas
                delta_tree = self.comm.bucketer.debucketize(
                    self.arena.unpack_spans(spans), bplan)
                del spans
            else:
                delta_tree = self.comm.all_gather_buckets(deltas, bplan)
                del deltas
            wd = 1 - lr * self.cfg.optim.weight_decay
            new_p = tree_util.tree_map(
                lambda p, d: (p.float() * wd + d.float()).to(p.dtype),
                state["params"], delta_tree)
        else:
            grads = out[0]
            del out
            gnorm = global_grad_norm(grads, self.specs, self.ctx)
            factor = clip_factor(gnorm, self.cfg.optim.clip_norm)
            grads = tree_util.tree_map(lambda g: g * factor, grads)
            new_p, new_opt = adamw_tree_update(state["params"], grads,
                                               state["opt"], state["step"],
                                               lr, self.cfg.optim)
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        for key, buf in zip(("arena", "ef"), extra):
            new_state[key] = buf
        metrics = {"loss": self.ctx.pmean_data(loss), "grad_norm": gnorm,
                   "lr": lr, "moe_drop_fraction": self._drop_metric()}
        return new_state, metrics

    def _fsdp_step(self, state: dict, batch: dict) -> tuple[dict, dict]:
        """The fsdp step: the gradient shards (summed over data by the
        gathers' backward, accumulated over microbatches in the arena when
        it is on) are made a mean, clipped by the global norm and handed to
        AdamW group by group; the fp32 shards take the decoupled weight
        decay and the delta."""
        kw = {}
        if self.arena is not None:
            kw = {"arena": self.arena, "arena_buf": state["arena"]}
            if isinstance(self.arena, QuantCommArena):
                kw["ef_buf"] = state["ef"]
        loss, out = self.comm.reduce_scheduled(
            self._grad_fn, state["groups"], batch, self.schedule, op="none",
            **kw)
        grads, extra = (out[0], out[1:]) if self.arena is not None else (
            out, ())
        del out
        inv = 1.0 / self.fsdp.dp_world
        for name in grads:
            for g in grads[name]:          # step-local: scaled in place
                g.mul_(inv)
        # each shard weighed by its norm weights (1/model_size on the
        # fields the model axis replicates)
        gnorm = self._shard_norm([g for name in sorted(grads)
                                  for g in grads[name]])
        factor = clip_factor(gnorm, self.cfg.optim.clip_norm)
        lr = self.lr_fn(state["step"])
        wd = 1 - lr * self.cfg.optim.weight_decay
        new_groups, new_mu, new_nu = {}, {}, {}
        for name in state["groups"]:
            shards = grads.pop(name)
            for g in shards:
                g.mul_(factor)
            deltas, nopt = adamw_flat_update(
                shards, {"mu": state["opt"]["mu"][name],
                         "nu": state["opt"]["nu"][name]},
                state["step"], lr, self.cfg.optim)
            del shards
            new_groups[name] = [(p.float() * wd + d).to(p.dtype)
                                for p, d in zip(state["groups"][name],
                                                deltas)]
            new_mu[name], new_nu[name] = nopt["mu"], nopt["nu"]
        new_state = {"groups": new_groups,
                     "opt": {"mu": new_mu, "nu": new_nu},
                     "step": state["step"] + 1}
        for key, buf in zip(("arena", "ef"), extra):
            new_state[key] = buf
        metrics = {"loss": self.ctx.pmean_data(loss), "grad_norm": gnorm,
                   "lr": lr, "moe_drop_fraction": self._drop_metric()}
        return new_state, metrics

    def _shard_norm(self, shards: list) -> torch.Tensor:
        """The exact global norm of the reduced gradient from this rank's
        shards: the sum of squares over :attr:`norm_ranges`, each range
        times its weight in :attr:`norm_weights` (the reference's weighted
        sum; the ranges of weight 0 left out), summed over data and over
        the model axis."""
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for s, ranges, weights in zip(shards, self.norm_ranges,
                                      self.norm_weights):
            for (start, stop), w in zip(ranges, weights):
                part = torch.sum(torch.square(s[start:stop]))
                sq = sq + (part if w == 1.0 else part * w)
        return torch.sqrt(self.ctx.psum(self.ctx.psum_data(sq)))


def init_train_state(model: Model, step: TrainStep, *, params=None,
                     generator: torch.Generator | None = None) -> dict:
    """``{"params", "opt", "step"}`` (+ ``"arena"``, and under a wire codec
    ``"ef"``, both allocated here once) on the step's device: ``params``
    (the full tree) when given (e.g. bridged from the reference), else
    fresh ones drawn from ``generator``; on a model axis this rank keeps
    its block of them (:meth:`TrainStep.local_params`).  Under ``zero1``,
    ``opt`` holds lists of this rank's fp32 moment shards
    (:attr:`TrainStep.shard_sizes`).  Under ``fsdp`` the parameters are
    this rank's data shards of its block instead:
    ``{"groups": {name: [fp32 shards]}, "opt": {"mu", "nu"} of the same
    shape, "step"}``."""
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator")
        params = model.init(generator, step.device)
    params = step.local_params(params)
    if step.fsdp is not None:
        groups = step.fsdp.shard_state(params)
        del params
        opts = {name: init_opt_state_flat(shards)
                for name, shards in groups.items()}
        state = {"groups": groups, "step": 0,
                 "opt": {k: {name: o[k] for name, o in opts.items()}
                         for k in ("mu", "nu")}}
    else:
        if step.cfg.dp_mode == "zero1":
            opt = init_opt_state_flat([torch.empty(n, device=step.device)
                                       for n in step.shard_sizes])
        else:
            opt = init_opt_state(params)
        state = {"params": params, "opt": opt, "step": 0}
    if step.arena is not None:
        state["arena"] = step.arena.zeros(step.device)
        if isinstance(step.arena, QuantCommArena):
            state["ef"] = step.arena.ef_zeros(step.device)
    return state
