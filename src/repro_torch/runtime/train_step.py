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
  (:func:`build_norm_weights`: the arena's page padding weighs 0).

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
``reduce_add`` kernel; a wire codec is refused with the ring gather.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Sequence

import torch

from repro_torch import tree as tree_util
from repro_torch.checkpoint import REPLICATED, SHARDED, RankShards
from repro_torch.comm.api import CommConfig, Communicator
from repro_torch.comm.schedule import (SCHEDULE_POLICIES, CommSchedule,
                                       build_schedule)
from repro_torch.core.bucketing import BucketPlan
from repro_torch.core.p2p import RingAxis
from repro_torch.core.topology import RankMesh
from repro_torch.mem.arena import CommArena, QuantCommArena
from repro_torch.mem.layout import (ArenaLayout, QuantArenaLayout, plan_arena,
                                    plan_quant_arena)
from repro_torch.models.model_api import Model
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim import (OptimConfig, adamw_flat_update,
                               adamw_tree_update, clip_factor,
                               global_grad_norm, init_opt_state,
                               init_opt_state_flat, make_schedule)

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
    comm: CommConfig = field(default_factory=CommConfig)
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

    def comm_config(self, data_axes: tuple[str, ...]) -> CommConfig:
        ccfg = self.comm
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


def data_mesh(world: int) -> RankMesh:
    """The data-parallel mesh: every rank on one ``data`` axis."""
    return RankMesh(("data",), (world,))


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
    return init_params(None, model.cfg, torch.device("meta"))


def build_norm_weights(plan: BucketPlan) -> list[torch.Tensor]:
    """Per-bucket fp32 weight vectors of the zero1 gradient norm.  The
    reference weighs a model-replicated field ``1/model_size`` so that its
    sum over the model axis counts every parameter once; the port has no
    model axis (``model_size`` 1), so every element weighs 1.0."""
    return [torch.ones((n,), dtype=torch.float32) for n in plan.bucket_sizes]


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


def span_norm_ranges(layout: ArenaLayout | QuantArenaLayout,
                     rings: Sequence[RingAxis]
                     ) -> list[list[tuple[int, int]]]:
    """Per span, the ranges of this rank's shard (shard-local) that hold a
    bucket's payload: where the slice of :func:`build_span_norm_weights`'
    vector is 1.0 (the port has no model axis), the page padding left out.
    The zero1 norm sums the squares over these ranges, so that no weight
    vector lives beside the shards."""
    out = []
    for sp in layout.spans:
        lo, hi = _owned_range(sp.size, rings)
        ranges = []
        for b in sp.buckets:
            seg = layout.segment_of(b)
            start = max(seg.offset - sp.offset, lo)
            stop = min(seg.offset - sp.offset + seg.size, hi)
            if start < stop:
                ranges.append((start - lo, stop - lo))
        out.append(ranges)
    return out


class FsdpPlan:
    """Per-group flat-bucket layout of ``fsdp``: every block (``blocks.i``)
    and each root entry (``root.embed``, ``root.final_norm``) is bucketed
    on its own, so that a layer gathers and releases its weights alone.

    Owns the communicator of the fsdp collectives, with buckets of
    ``cfg.fsdp_bucket_bytes``; building it creates process groups, which is
    collective (every rank builds its plans in the same order).  Under
    ``use_arena`` the arena layout holds one segment per group-bucket shard,
    in the sorted-name order in which the gradient tree flattens: fp32, or
    the int8 layout under a wire codec.
    """

    def __init__(self, model: Model, mesh: RankMesh, cfg: TrainStepConfig,
                 *, connect: bool = True):
        if cfg.fsdp_gather not in FSDP_GATHERS:
            raise ValueError(f"fsdp_gather must be one of {FSDP_GATHERS}, "
                             f"got {cfg.fsdp_gather!r}")
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
        local = abstract_params(model)
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
    the gradient norm (:func:`span_norm_ranges`).  Under ``fsdp`` it holds
    the :class:`FsdpPlan` (:attr:`fsdp`), whose communicator is the step's.

    For checkpoints it holds :attr:`ranks` (this rank's place in the global
    arrays and, over several ranks, a gloo group of its own when the
    default group is not gloo, created with the communicator's groups) and
    gives each state leaf's layout (:meth:`state_layout`).
    """

    def __init__(self, model: Model, mesh: RankMesh, cfg: TrainStepConfig,
                 *, device: torch.device):
        require_ported(cfg.dp_mode)
        self.model = model
        self.cfg = cfg
        self.device = device
        self.lr_fn = make_schedule(cfg.optim.schedule,
                                   base_lr=cfg.optim.base_lr,
                                   warmup=cfg.optim.warmup,
                                   total=cfg.optim.total_steps)
        self.shard_sizes: list[int] = []
        self.norm_ranges: list[list[tuple[int, int]]] = []
        self.fsdp: FsdpPlan | None = None
        policy = cfg.schedule_policy
        if cfg.dp_mode == "fsdp":
            self.fsdp = FsdpPlan(model, mesh, cfg)
            self.comm = self.fsdp.comm
            self.ctx = ParallelCtx(data=self.comm.transport.rails[0].joint)
            self.plan = None
            lay = self.fsdp.arena_layout
            self.arena = (None if lay is None else
                          QuantCommArena(lay, impl=cfg.comm.local_op)
                          if isinstance(lay, QuantArenaLayout)
                          else CommArena(lay, impl=cfg.comm.local_op))
            self.schedule = _fsdp_schedule(self.fsdp, cfg.microbatches)
            self.ranks = self._checkpoint_ranks()
            return
        self.comm = Communicator(mesh, cfg.comm_config(("pod", "data")))
        self.ranks = self._checkpoint_ranks()
        self.ctx = ParallelCtx(data=self.comm.transport.rails[0].joint)
        local = abstract_params(model)
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
            if self.arena is not None:
                # the shards follow the fused spans; padding weighs zero
                lay = self.arena.layout
                rings = tuple(reversed(self.comm.transport.rails[0].axes))
                self.shard_sizes = [sp.size // world for sp in lay.spans]
                self.norm_ranges = span_norm_ranges(lay, rings)
            else:
                self.shard_sizes = [n // world for n in
                                    self.plan.bucket_plan.bucket_sizes]
                self.norm_ranges = [[(0, n)] for n in self.shard_sizes]

    def _checkpoint_ranks(self) -> RankShards:
        """This rank's place in the global arrays of a checkpoint: its
        index on the data axes, which must be its ring's ownership order
        (rank ``r`` owns elements ``[r*n/p, (r+1)*n/p)`` of every
        reduce-scatter), and the host-side group the checkpoint gathers
        over.  Collective over several ranks."""
        world = self.comm.world
        if world == 1:
            return RankShards()
        import torch.distributed as dist

        rank = dist.get_rank()
        rings = tuple(reversed(self.comm.transport.rails[0].axes))
        if world != dist.get_world_size() or \
                _owned_range(world, rings) != (rank, rank + 1):
            raise NotImplementedError(
                "checkpoints need a data-only mesh whose ring ownership "
                "follows the rank order")
        group = (None if dist.get_backend() == "gloo"
                 else dist.new_group(backend="gloo"))
        return RankShards(rank, world, group)

    def state_layout(self, state: dict) -> dict:
        """Per leaf of ``state``, :data:`~repro_torch.checkpoint.SHARDED`
        where each rank holds its own 1-D shard of a global array (the
        reference's flat ``P(('data', 'model'))`` leaves: the arena,
        ``"ef"``, zero1's moment shards, fsdp's groups and their moments),
        :data:`~repro_torch.checkpoint.REPLICATED` elsewhere (the
        parameters, the replicated moments, ``step``)."""
        sharded = {"arena", "ef"}
        if self.cfg.dp_mode in ("zero1", "fsdp"):
            sharded |= {"opt", "groups"}
        return {k: tree_util.tree_map(
            lambda _, rule=SHARDED if k in sharded else REPLICATED: rule, v)
            for k, v in state.items()}

    def _grad_fn(self, params, mb):
        """``(loss, grads)`` of one microbatch; under fsdp ``params`` is
        the ``{group: [shards]}`` tree, gathered here, and the gradients
        come back as shards (the gathers' backward reduce-scatters)."""
        leaves, treedef = tree_util.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        tree, kw = treedef.unflatten(leaves), {}
        if self.fsdp is not None:
            tree, kw["block_resolver"] = self.fsdp.params_and_resolver(
                tree, getattr(torch, self.cfg.gather_dtype))
        loss = self.model.loss_fn(tree, mb, causal_skip=self.cfg.causal_skip,
                                  **kw)
        del tree
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), treedef.unflatten(grads)

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        batch = {k: v.to(self.device) for k, v in batch.items()}
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
            gnorm = global_grad_norm(grads)
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
                   "lr": lr}
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
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for name in sorted(grads):
            for g in grads[name]:          # step-local: scaled in place
                g.mul_(inv)
                # bucket padding has a zero gradient: every element weighs 1
                sq = sq + torch.sum(torch.square(g))
        gnorm = torch.sqrt(self.ctx.psum(self.ctx.psum_data(sq)))
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
                   "lr": lr}
        return new_state, metrics

    def _shard_norm(self, shards: list) -> torch.Tensor:
        """The exact global norm of the reduced gradient from this rank's
        shards: the sum of squares over :attr:`norm_ranges` (the reference's
        weighted sum, every weight 1.0 or 0), summed over data."""
        sq = torch.zeros((), dtype=torch.float32, device=self.device)
        for s, ranges in zip(shards, self.norm_ranges):
            for start, stop in ranges:
                sq = sq + torch.sum(torch.square(s[start:stop]))
        return torch.sqrt(self.ctx.psum(self.ctx.psum_data(sq)))


def init_train_state(model: Model, step: TrainStep, *, params=None,
                     generator: torch.Generator | None = None) -> dict:
    """``{"params", "opt", "step"}`` (+ ``"arena"``, and under a wire codec
    ``"ef"``, both allocated here once) on the step's device: ``params``
    when given (e.g. bridged from the reference), else fresh ones drawn
    from ``generator``.  Under ``zero1``, ``opt`` holds lists of this
    rank's fp32 moment shards (:attr:`TrainStep.shard_sizes`).  Under
    ``fsdp`` the parameters are this rank's shards instead:
    ``{"groups": {name: [fp32 shards]}, "opt": {"mu", "nu"} of the same
    shape, "step"}``."""
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator")
        params = model.init(generator, step.device)
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
