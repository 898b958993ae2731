"""The replicated data-parallel train step.

Port of the ``replicated`` mode of ``repro.runtime.train_step``: every rank
holds the parameters and AdamW state, computes the gradients of its shard of
the global batch with autograd, and the
:class:`~repro_torch.comm.api.Communicator` reduces them (mean) with its
transport, issuing each bucket at its :class:`CommSchedule` slot.  With
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

``zero1`` and ``fsdp`` arrive with their own slice; asking for them raises
rather than training another mode.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace

import torch

from repro_torch import tree as tree_util
from repro_torch.comm.api import CommConfig, Communicator
from repro_torch.comm.schedule import SCHEDULE_POLICIES, CommSchedule
from repro_torch.core.topology import RankMesh
from repro_torch.mem.arena import QuantCommArena
from repro_torch.models.model_api import Model
from repro_torch.models.parallel import ParallelCtx
from repro_torch.models.transformer import init_params
from repro_torch.optim import (OptimConfig, adamw_tree_update, clip_factor,
                               global_grad_norm, init_opt_state,
                               make_schedule)

DP_MODES = ("replicated", "zero1", "fsdp")


def require_replicated(dp_mode: str) -> None:
    """The port trains ``replicated`` only; the other modes raise."""
    if dp_mode not in DP_MODES:
        raise ValueError(f"dp_mode must be one of {DP_MODES}, got "
                         f"{dp_mode!r}")
    if dp_mode != "replicated":
        raise NotImplementedError(
            f"dp_mode={dp_mode!r} is not ported yet (it arrives with the "
            f"zero1/fsdp slice); the port trains dp_mode='replicated' only")


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

    def comm_config(self, data_axes: tuple[str, ...]) -> CommConfig:
        ccfg = self.comm
        if self.wire_codec is not None:
            ccfg = replace(ccfg, wire_codec=self.wire_codec)
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


class TrainStep:
    """``step(state, batch) -> (state, metrics)`` for one rank.

    Builds its :class:`Communicator` on construction, which is collective:
    every rank of the mesh builds its steps in the same order.
    """

    def __init__(self, model: Model, mesh: RankMesh, cfg: TrainStepConfig,
                 *, device: torch.device):
        require_replicated(cfg.dp_mode)
        self.model = model
        self.cfg = cfg
        self.device = device
        self.comm = Communicator(mesh, cfg.comm_config(("pod", "data")))
        self.ctx = ParallelCtx(data=self.comm.transport.rails[0].joint)
        self.lr_fn = make_schedule(cfg.optim.schedule,
                                   base_lr=cfg.optim.base_lr,
                                   warmup=cfg.optim.warmup,
                                   total=cfg.optim.total_steps)
        local = abstract_params(model)
        policy = cfg.schedule_policy
        self.plan = self.comm.plan(local)
        self.arena = self.comm.arena(local) if cfg.use_arena else None
        self.schedule: CommSchedule = (
            self.comm.arena_schedule(local, policy, cfg.microbatches)
            if cfg.use_arena
            else self.comm.schedule(local, policy, cfg.microbatches))

    def _grad_fn(self, params, mb):
        leaves, treedef = tree_util.flatten(params)
        leaves = [p.detach().requires_grad_(True) for p in leaves]
        loss = self.model.loss_fn(treedef.unflatten(leaves), mb,
                                  causal_skip=self.cfg.causal_skip)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        return loss.detach(), treedef.unflatten(grads)

    def __call__(self, state: dict, batch: dict) -> tuple[dict, dict]:
        batch = {k: v.to(self.device) for k, v in batch.items()}
        ef = None
        if isinstance(self.arena, QuantCommArena):
            loss, (grads, buf, ef) = self.comm.reduce_scheduled(
                self._grad_fn, state["params"], batch, self.schedule,
                op="all_reduce", arena=self.arena, arena_buf=state["arena"],
                ef_buf=state["ef"])
        elif self.arena is not None:
            loss, (grads, buf) = self.comm.reduce_scheduled(
                self._grad_fn, state["params"], batch, self.schedule,
                op="all_reduce", arena=self.arena, arena_buf=state["arena"])
        else:
            loss, grads = self.comm.reduce_scheduled(
                self._grad_fn, state["params"], batch, self.schedule,
                op="all_reduce")
        gnorm = global_grad_norm(grads)
        factor = clip_factor(gnorm, self.cfg.optim.clip_norm)
        grads = tree_util.tree_map(lambda g: g * factor, grads)
        lr = self.lr_fn(state["step"])
        new_p, new_opt = adamw_tree_update(state["params"], grads,
                                           state["opt"], state["step"], lr,
                                           self.cfg.optim)
        new_state = {"params": new_p, "opt": new_opt,
                     "step": state["step"] + 1}
        if self.arena is not None:
            new_state["arena"] = buf
        if ef is not None:
            new_state["ef"] = ef
        metrics = {"loss": self.ctx.pmean_data(loss), "grad_norm": gnorm,
                   "lr": lr}
        return new_state, metrics


def init_train_state(model: Model, step: TrainStep, *, params=None,
                     generator: torch.Generator | None = None) -> dict:
    """``{"params", "opt", "step"}`` (+ ``"arena"``, and under a wire codec
    ``"ef"``, both allocated here once) on the step's device: ``params``
    when given (e.g. bridged from the reference), else fresh ones drawn
    from ``generator``."""
    if params is None:
        if generator is None:
            raise ValueError("pass params or a generator")
        params = model.init(generator, step.device)
    state = {"params": params, "opt": init_opt_state(params), "step": 0}
    if step.arena is not None:
        state["arena"] = step.arena.zeros(step.device)
        if isinstance(step.arena, QuantCommArena):
            state["ef"] = step.arena.ef_zeros(step.device)
    return state
