"""Bridge from the prediction stack to the DriftDetector (port of
``repro.obs.predict``).

The reference AOT-lowers the live step and reads XLA's ``cost_analysis``
and the collectives of its HLO.  The port prices the same three roofline
terms (:class:`~repro_torch.launch.roofline.Roofline`) from what PyTorch
can see of the step it runs:

* FLOPs: one forward and backward of the step's loss on its first batch
  (every microbatch, through the step's own ``_grad_fn``) under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts matmuls and
  attention (XLA also counts elementwise work);
* memory bytes: a :class:`torch.utils._python_dispatch.TorchDispatchMode`
  that sums each aten op's operand and output bytes (views excluded): the
  eager, unfused program the port runs;
* wire bytes and messages: the step's plan for its gradient reduction on
  the data axis (``CommPlan``: the arena's spans, or the buckets with
  their padding), plus what the pass records: the model-axis and EP
  collectives of the forward and backward, under fsdp the data axis's
  gathers and reduce-scatters (they are the forward's and backward's own),
  and the scalar all-reduces the step adds (the loss's mean, the gradient
  norm's sums, the MoE drop fraction's mean), run on the pass's own
  values.  Native collectives count as their ring equivalents
  (:func:`~repro_torch.comm.plan.record_wire`), so the prediction equals
  what a step's :class:`~repro_torch.core.p2p.CommRecord` holds;
* the overlap fraction: the step's :class:`CommSchedule` (``TrainStep
  .schedule``, built by the reference's ``build_step_schedule`` rules).

The pass is collective when the mesh has more than one rank: every rank
predicts at the same point.  It leaves the train state bitwise unchanged
(parameters, optimizer state, ``.grad``, the arena, error feedback, the
step counter, the RNG state) and the communicators' records as they were:
nothing is reduced over the data axis by the plan's path and no update is
taken.  With a tuning DB the collective term is priced at the record's
measured α and bandwidth (:meth:`LatencyModel.from_record`).
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.comm.plan import LatencyModel, record_wire
from repro_torch.launch.roofline import Roofline


class ByteCounter(TorchDispatchMode):
    """A dispatch mode summing every aten op's operand and output tensor
    bytes (views move nothing and are skipped)."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not getattr(func, "is_view", False):
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def step_records(step) -> list:
    """``(record, axis size)`` of every communicator the step records into:
    the data axis's (its ring and joint group), the model axis's and the
    EP communicator's."""
    out = [(step.comm.record, step.comm.world)]
    if step.model_size > 1:
        out.append((step.model_record, step.model_size))
        if step.moe_comm is not None:
            out.append((step.moe_comm.record, step.model_size))
    return out


def plan_wire(step) -> tuple[float, float]:
    """``(messages, wire_bytes)`` one step's gradient reduction puts on the
    data axis, from its plan (0 under fsdp, whose reduction is the
    gathers' backward, counted in the pass)."""
    plan = step.plan
    if plan is None or not step.comm.axes:
        return 0.0, 0.0
    if step.arena is not None:
        return (float(plan.arena_messages_per_device),
                float(plan.arena_bytes_per_device))
    bplan = plan.bucket_plan
    # the wire carries each bucket's padding, at the plan's rate
    return (float(plan.messages_per_device),
            float(step.comm.transport.predicted_bytes_per_device(
                bplan.total_elems, step.comm.axis_sizes)))


def _pass(step, state: dict, batch: dict) -> None:
    """One forward and backward of every microbatch of ``batch`` through
    the step's own gradient function, then the step's scalar reductions on
    the pass's values; nothing is kept."""
    from repro_torch.comm.api import Communicator
    from repro_torch.optim.adamw import global_grad_norm

    params = state["groups"] if step.fsdp is not None else state["params"]
    batch = {k: v.to(step.device) for k, v in batch.items()}
    step._drops = []
    losses, grads = [], None
    for mb in Communicator._microbatches(batch, step.cfg.microbatches):
        loss, g = step._grad_fn(params, mb)
        losses.append(loss)
        grads = g                       # one microbatch's: the norm's shape
    step.ctx.pmean_data(sum(losses) / len(losses))
    if step.fsdp is not None:
        step._shard_norm([x for name in sorted(grads) for x in grads[name]])
    elif step.cfg.dp_mode == "zero1":
        step._shard_norm([torch.zeros(n, device=step.device)
                          for n in step.shard_sizes])
    else:
        global_grad_norm(grads, step.specs, step.ctx)
    step._drop_metric()


def count_step(step, state: dict, batch: dict) -> dict:
    """FLOPs, memory bytes, wire bytes and messages of one step of
    ``step`` (a :class:`~repro_torch.runtime.train_step.TrainStep`) on this
    rank's ``batch``, with the train state, the RNG and the records left as
    they were."""
    dev = step.device
    cpu_rng = torch.get_rng_state()
    cuda_rng = (torch.cuda.get_rng_state(dev) if dev.type == "cuda"
                else None)
    records = step_records(step)
    saved = [rec.as_dict() for rec, _ in records]
    for rec, _ in records:
        rec.reset()
    try:
        flops = FlopCounterMode(display=False)
        mem = ByteCounter()
        with flops, mem:
            _pass(step, state, batch)
        messages, wire = plan_wire(step)
        for rec, p in records:
            m, b = record_wire(rec, p)
            messages += m
            wire += b
    finally:
        for (rec, _), before in zip(records, saved):
            for k, v in before.items():
                setattr(rec, k, v)
        step._drops = []
        torch.set_rng_state(cpu_rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state(cuda_rng, dev)
    return {"flops": float(flops.get_total_flops()),
            "hbm_bytes": float(mem.bytes), "wire_bytes": wire,
            "messages": messages}


def step_wire(step, before: list[dict]) -> tuple[float, float]:
    """``(messages, wire_bytes)`` the step's records gained since
    ``before`` (:func:`record_snapshot`), in the prediction's units."""
    messages = wire = 0.0
    for (rec, p), old in zip(step_records(step), before):
        now = rec.as_dict()
        m, b = record_wire({k: now[k] - old[k] for k in now}, p)
        messages += m
        wire += b
    return messages, wire


def record_snapshot(step) -> list[dict]:
    """The step's records as they stand (for :func:`step_wire`)."""
    return [rec.as_dict() for rec, _ in step_records(step)]


def predict_step_time(step_fn, example_args, *,
                      overlap_fraction: float = 0.0,
                      latency: LatencyModel | None = None) -> dict:
    """Price one step of ``step_fn`` (a ``TrainStep``) on ``example_args``
    (``(state, batch)``, this rank's rows).

    Returns the roofline terms plus ``t_step_s`` (the overlap-honest bound
    the drift detector compares measured steps against).  ``latency``
    replaces the reference's α/β constants with measured ones (a
    tuning-DB record); ``overlap_fraction`` is the step schedule's.  The
    reference's ``mesh`` argument has no counterpart: the step holds its
    own."""
    state, batch = example_args
    counts = count_step(step_fn, state, batch)
    roof_kw = dict(
        flops_per_device=counts["flops"],
        hbm_bytes_per_device=counts["hbm_bytes"],
        wire_bytes_per_device=counts["wire_bytes"],
        overlap_fraction=overlap_fraction,
        messages_per_device=counts["messages"],
    )
    roof = (Roofline.from_latency(latency, **roof_kw) if latency is not None
            else Roofline(**roof_kw))
    return {
        "t_step_s": roof.bound_time_overlapped,
        "t_compute_s": roof.t_compute,
        "t_memory_s": roof.t_memory,
        "t_collective_s": roof.t_collective,
        "t_exposed_collective_s": roof.t_exposed_collective,
        "bottleneck": roof.bottleneck,
        "overlap_fraction": overlap_fraction,
        "flops_per_device": counts["flops"],
        "hbm_bytes_per_device": counts["hbm_bytes"],
        "wire_bytes_per_device": counts["wire_bytes"],
        "messages_per_device": counts["messages"],
        "alpha_s": roof.alpha_s,
        "link_bandwidth": roof.link_bandwidth,
        "source": "tuned" if latency is not None else "roofline",
    }


def tuned_latency(db_path: str, *, transport: str | None = None,
                  mesh_label: str | None = None, channels: int | None = None,
                  page_bytes: int | None = None, arch: str | None = None
                  ) -> tuple[LatencyModel, dict, str] | None:
    """A :class:`LatencyModel` (plus its fit-residual summary and DB key)
    from a tuning DB for the active comm config; ``None`` when no record
    matches (the caller falls back to the reference's constants)."""
    from repro_torch.tune.db import TuningDB, model_error_summary

    db = TuningDB.load(db_path)
    got = db.lookup(transport=transport, arch=arch, mesh=mesh_label,
                    channels=channels, page_bytes=page_bytes)
    if got is None:
        return None
    key, rec = got
    return LatencyModel.from_record(rec), model_error_summary(rec), key
