"""ParallelCtx: the collectives model and step code call explicitly.

Port of ``repro.models.parallel``.  In the reference the whole step runs
inside a fully manual ``shard_map``: model code sees its local weight
shards and calls ``ctx.psum`` after row-parallel contractions
(Megatron-style tensor parallelism, every collective visible).  Here the
model axis is a :class:`~repro_torch.core.p2p.RingAxis` over the ranks
that share this rank's data coordinates (its own process group, apart from
the communicator's rails), and each collective with a custom gradient is a
``torch.autograd.Function``:

* :meth:`ParallelCtx.psum` — all-reduce forward, identity backward (the
  output is consumed as replicated);
* :meth:`ParallelCtx.fan_out` — identity forward, all-reduce backward
  (Megatron's ``f``, before column-parallel branches);
* :meth:`ParallelCtx.gather_replicated` — tiled all-gather forward on the
  leading dimension, this rank's slice of the cotangent backward;
* :func:`sum_grads_over_model` — identity forward, all-reduce backward, on
  the weights a rank uses in a rank-dependent way (the kv projections
  under the GQA head gather);
* :meth:`ParallelCtx.all_to_all` — the tiled all-to-all of expert
  parallelism, through the EP communicator's transport when one is
  attached (``a2a``), else ``dist.all_to_all_single`` on the model axis's
  own group (the reference's ``lax.all_to_all`` default); its backward is
  the inverse exchange.

The data axes are one joint ring (``data``): ``psum_data`` is one
``dist.all_reduce`` over it.  ``ParallelCtx()`` is the single-rank
context: every collective is the identity.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch

from repro_torch import tree as tree_util
from repro_torch.core.p2p import (CommRecord, RingAxis,
                                  differentiable_all_to_all, joint_ring)
from repro_torch.core.topology import RankMesh
from repro_torch.sharding.rules import MODEL_AXIS


class _PsumIdBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return axis.all_reduce(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _PsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.axis.all_reduce(grad.contiguous()), None


class _GatherIdBwd(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.n = axis, x.shape[0]
        full = axis.all_gather(x.contiguous())
        return full.view((axis.size * x.shape[0],) + tuple(x.shape[1:]))

    @staticmethod
    def backward(ctx, grad):
        i = ctx.axis.index
        return grad[i * ctx.n:(i + 1) * ctx.n], None


@dataclass(frozen=True)
class ParallelCtx:
    data: RingAxis | None = None     # joint group of the data axes
    model: RingAxis | None = None    # the model axis (tensor parallelism)
    # the EP communicator's all_to_all(x, *, split_axis, concat_axis)
    # (differentiable); None -> the model ring's own all-to-all
    a2a: Any = field(default=None, compare=False)

    # -- model-axis collectives ------------------------------------------

    def _tp(self) -> bool:
        return self.model is not None and self.model.size > 1

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        """Row-parallel completion sum, replicated over the model axis;
        the backward passes the (replicated) cotangent through."""
        return _PsumIdBwd.apply(x, self.model) if self._tp() else x

    def fan_out(self, x: torch.Tensor) -> torch.Tensor:
        """Identity on a replicated activation about to feed rank-sharded
        branches; the backward sums their cotangents over the model axis.
        The dual of :meth:`psum`."""
        return _PsumGrad.apply(x, self.model) if self._tp() else x

    def pmax(self, x: torch.Tensor) -> torch.Tensor:
        """Maximum over the model axis (no gradient)."""
        return self.model.all_reduce(x.detach(), op="max") if self._tp() \
            else x

    def gather_replicated(self, x: torch.Tensor) -> torch.Tensor:
        """The ranks' blocks of ``x`` concatenated along dimension 0 in
        model order; the backward returns this rank's slice."""
        return _GatherIdBwd.apply(x, self.model) if self._tp() else x

    def all_to_all(self, x: torch.Tensor, *, split_axis: int,
                   concat_axis: int) -> torch.Tensor:
        """Tiled all-to-all over the model axis (EP dispatch and combine):
        ``x`` splits into ``model_size`` blocks along ``split_axis``, block
        ``j`` goes to model rank ``j``, the received blocks concatenate
        along ``concat_axis`` in rank order.  The backward is the inverse
        exchange."""
        if not self._tp():
            return x
        if self.a2a is not None:
            return self.a2a(x, split_axis=split_axis, concat_axis=concat_axis)
        return differentiable_all_to_all(self.model.all_to_all, x,
                                         split_axis, concat_axis)

    def model_size(self) -> int:
        return self.model.size if self.model is not None else 1

    def model_index(self) -> int:
        return self.model.index if self.model is not None else 0

    # -- data-axis helpers -----------------------------------------------

    def dp_world(self) -> int:
        return self.data.size if self.data is not None else 1

    def psum_data(self, x: torch.Tensor) -> torch.Tensor:
        return self.data.all_reduce(x) if self.data is not None else x

    def pmean_data(self, x: torch.Tensor) -> torch.Tensor:
        if self.data is None:
            return x
        return self.psum_data(x) / self.dp_world()


SINGLE = ParallelCtx()


def make_ctx(mesh: RankMesh, data: RingAxis | None = None,
             record: CommRecord | None = None,
             moe_comm=None) -> ParallelCtx:
    """The models' explicit-collective context on ``mesh``: ``data`` (the
    communicator's joint ring of the data axes), the EP communicator
    ``moe_comm`` (a :class:`~repro_torch.comm.api.Communicator` over the
    model axis, whose ``all_to_all`` the context's exchanges go through)
    and, when the mesh has a model axis above 1, a ring over it on process
    groups of its own, recording into ``record``.

    Creating groups is collective, and a mismatch in their order deadlocks
    gloo, so every rank makes them in one order: the data communicator's
    rails, then the EP communicator's rails over ``("model",)``
    (:func:`~repro_torch.runtime.train_step.build_moe_comm`), then the
    model axis's own ring, here."""
    model = None
    if mesh.sizes().get(MODEL_AXIS, 1) > 1:
        import torch.distributed as dist

        rank = dist.get_rank() if dist.is_initialized() else 0
        model = joint_ring(mesh, rank, (MODEL_AXIS,),
                           record if record is not None else CommRecord())
    a2a = moe_comm.all_to_all if moe_comm is not None else None
    return ParallelCtx(data=data, model=model, a2a=a2a)


def sum_grads_over_model(tree, ctx: ParallelCtx):
    """Identity on values; each leaf's cotangent is summed over the model
    axis (weights replicated over it and used differently on each rank)."""
    if not ctx._tp():
        return tree
    return tree_util.tree_map(lambda t: _PsumGrad.apply(t, ctx.model), tree)
