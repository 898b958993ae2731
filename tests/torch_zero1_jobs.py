"""Per-rank jobs of the port's ZeRO-1 CPU tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never import
JAX.  Each job takes ``(rank, world, ...)`` and returns numpy values."""

from __future__ import annotations

import numpy as np


def zero1_step_config(step_kw: dict, use_arena: bool,
                      wire_codec: str | None = None):
    """The zero1 :class:`TrainStepConfig` of the tests."""
    from repro_torch.comm import CommConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    return TrainStepConfig(
        dp_mode="zero1", comm=CommConfig(**step_kw["comm"]),
        optim=OptimConfig(**step_kw["optim"]), use_arena=use_arena,
        microbatches=step_kw["microbatches"], schedule=step_kw["schedule"],
        wire_codec=wire_codec)


def zero1_prediction(step, steps: int) -> dict:
    """Sends and bytes of ``steps`` zero1 steps, from the plan.

    The plan prices one all-reduce per bucket (span): ``p - 1``
    reduce-scatter plus ``p - 1`` all-gather hops per chain, each hop
    moving one chain's slice, so the reduce-scatter is half of the
    all-reduce's sends and bytes and the all-gather the other half.  A
    zero1 step reduce-scatters once per microbatch issue phase (every phase
    of a streamed schedule, the last of ``accumulate_then_reduce``) and
    all-gathers the deltas once, after AdamW.  Without the arena the wire
    carries each bucket's padding too, at the same rate.
    """
    plan, comm = step.plan, step.comm
    sched = step.schedule
    phases = len({slot.phase for slot in sched.slots})
    halves = (phases + 1) * steps             # in units of half a step
    if step.arena is not None:
        sends, nbytes = (plan.arena_messages_per_device,
                         plan.arena_bytes_per_device)
    else:
        sends = plan.messages_per_device
        nbytes = comm.transport.predicted_bytes_per_device(
            plan.bucket_plan.total_elems, comm.axis_sizes)
    return {"sends": sends * halves / 2, "send_bytes": nbytes * halves / 2}


def norm_weight_slices(step) -> list:
    """This rank's slice of each zero1 norm-weight vector of ``step``'s
    bucket plan (and arena layout), as ``_slice_like_shard`` cuts it."""
    from repro_torch.runtime.train_step import (_slice_like_shard,
                                                build_norm_weights,
                                                build_span_norm_weights)

    weights = build_norm_weights(step.plan.bucket_plan)
    if step.arena is not None:
        weights = build_span_norm_weights(step.arena.layout, weights)
    rings = tuple(reversed(step.comm.transport.rails[0].axes))
    return [_slice_like_shard(w, rings).numpy().copy() for w in weights]


def norm_masks(step) -> list:
    """The weights that ``step``'s gradient norm gives each shard element:
    1.0 inside its ``norm_ranges``, 0 elsewhere."""
    out = []
    for n, ranges in zip(step.shard_sizes, step.norm_ranges):
        mask = np.zeros((n,), dtype=np.float32)
        for start, stop in ranges:
            mask[start:stop] = 1.0
        out.append(mask)
    return out


def zero1_train_job(rank: int, world: int, leaves: list, steps: int,
                    use_arena: bool, step_kw: dict) -> dict:
    """The zero1 train loop of the reduced llama from the given parameter
    leaves (JAX tree order): the loss, gradient norm and parameters after
    every step, the final moment shards, the rank's norm-weight slices
    and the weights the step's norm gives its shards, the
    communicator's record beside the plan, and two communicator checks on
    a seeded tree: the reduce-scatter shard is ``[r*n/p, (r+1)*n/p)`` of
    the sum, and ``reduce_scatter_tree`` + ``all_gather_buckets`` equals
    ``all_reduce_tree`` bitwise."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import (abstract_params, data_mesh,
                                                shard_batch)

    model = build_model(reduced_config("llama3.2-1b"))
    treedef = tree_util.flatten(abstract_params(model))[1]
    params = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))
    trainer = Trainer(model, data_mesh(world), zero1_step_config(
        step_kw, use_arena), data, TrainerConfig(steps=steps),
        device=torch.device("cpu"), rank=rank, params=params,
        log=lambda msg: None)
    step, state = trainer.step_fn, trainer.state
    comm = step.comm
    ptr = state["arena"].data_ptr() if use_arena else None
    comm.record.reset()
    losses, norms, by_step = [], [], []
    for s in range(steps):
        state, metrics = step(state, shard_batch(data.batch_at(s), rank,
                                                 world))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
        by_step.append(bridge.params_to_numpy(
            tree_util.leaves(state["params"])))
    record = comm.record.as_dict()

    rng = np.random.RandomState(11 + rank)
    tree = {"a": torch.from_numpy(rng.randn(3000).astype(np.float32)),
            "b": [torch.from_numpy(rng.randn(17, 9).astype(np.float32))]}
    shards, bplan = comm.reduce_scatter_tree(tree)
    gathered = comm.all_gather_buckets(shards, bplan)
    reduced, _ = comm.all_reduce_tree(tree)
    buckets, _ = comm.bucketer.bucketize(tree)
    summed = comm.all_reduce(buckets)      # sums; shard r is r's slice
    own = []
    for shard, full in zip(shards, summed):
        n = full.shape[0] // world
        own.append(torch.equal(shard, full[rank * n:(rank + 1) * n] / world))
    return {"loss": np.array(losses), "grad_norm": np.array(norms),
            "params": by_step,
            "mu": [m.numpy().copy() for m in state["opt"]["mu"]],
            "nu": [v.numpy().copy() for v in state["opt"]["nu"]],
            "norm_weights": norm_weight_slices(step),
            "norm_masks": norm_masks(step),
            "shard_sizes": list(step.shard_sizes),
            "stable": (state["arena"].data_ptr() == ptr) if use_arena
            else True,
            "record": record, "predicted": zero1_prediction(step, steps),
            "rs_shard_is_owned_slice": all(own),
            "rs_ag_equals_ar": all(
                torch.equal(a, b) for a, b in
                zip(tree_util.leaves(gathered), tree_util.leaves(reduced)))}


def zero1_int8_job(rank: int, world: int, handover: list, step_kw: dict
                   ) -> dict:
    """Zero1 steps under the int8 wire, with the arena (``"arena"``) and
    without (``"bucket"``): step ``k`` taken from ``handover[rank][mode]
    [k]``, this rank's reference state before step ``k`` (numpy; the moments
    as this rank's shards).  Per step: the loss, gradient norm, new
    parameters (tree leaves), new moment shards and ``"ef"``; the block
    scale of this rank's first encode of every gradient element in the
    layout of the shards' full vectors (per bucket, or per arena span, 0 on
    page padding: ``"scales"``); the block scale of the all-gather's encode
    of every element of this rank's delta shards (``"delta_scales"``);
    whether ``"ef"`` is ``comp - decode(encode(comp))`` of the compensated
    local gradient bitwise, with the arena; whether every step kept the
    arena and ``"ef"`` in their storage; and the record of the steps beside
    the plan."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.comm import Int8BlockCodec
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.runtime.train_step import (TrainStep, abstract_params,
                                                data_mesh, shard_batch)

    model = build_model(reduced_config("llama3.2-1b"))
    treedef = tree_util.flatten(abstract_params(model))[1]
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))
    out = {}
    for mode, use_arena in (("arena", True), ("bucket", False)):
        step = TrainStep(model, data_mesh(world),
                         zero1_step_config(step_kw, use_arena, "int8"),
                         device=torch.device("cpu"))
        comm = step.comm
        block = comm.cfg.codec_block
        codec = Int8BlockCodec(block, impl="plain")
        gathered = []                       # the deltas all_gather is given
        all_gather = comm.all_gather

        def keep(shards, _all_gather=all_gather):
            gathered.append([s.clone() for s in shards])
            return _all_gather(shards)

        comm.all_gather = keep

        def scales_of(x):
            """Per-element block scales of ``x``'s encode."""
            return codec.split(codec.encode(x))[1].repeat_interleave(block)

        def checked_step(state, s):
            batch = shard_batch(data.batch_at(s), rank, world)
            _, grads = step._grad_fn(state["params"], batch)
            buckets, _ = comm.bucketer.bucketize(grads)
            if use_arena:
                lay = step.arena.layout
                want_ef = state["ef"].clone()
                scales = [torch.zeros(sp.size) for sp in lay.spans]
                for seg in lay.segments:
                    lo, hi = seg.offset, seg.offset + seg.size
                    comp = buckets[seg.bucket] + want_ef[lo:hi]
                    payload = codec.encode(comp)
                    want_ef[lo:hi] = comp - codec.decode(payload)
                    sp = next(i for i, sp in enumerate(lay.spans)
                              if seg.bucket in sp.buckets)
                    off = seg.offset - lay.spans[sp].offset
                    scales[sp][off:off + seg.size] = scales_of(comp)
            else:
                scales = [scales_of(b) for b in buckets]
            gathered.clear()
            state, metrics = step(state, batch)
            (deltas,) = gathered
            back = bridge.state_to_numpy(state)
            rec = {"loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "step": int(back["step"]),
                   "params": tree_util.leaves(back["params"]),
                   "mu": back["opt"]["mu"], "nu": back["opt"]["nu"],
                   "scales": [x.numpy() for x in scales],
                   "delta_scales": [scales_of(d).numpy() for d in deltas]}
            if use_arena:
                rec["ef"] = back["ef"]
                rec["ef_identity"] = bool(torch.equal(state["ef"], want_ef))
            return state, rec

        res = {"handover": [], "stable": True}
        comm.record.reset()
        for k, ref in enumerate(handover[rank][mode]):
            ref = dict(ref)
            ref["params"] = treedef.unflatten(ref["params"])
            state = bridge.state_from_numpy(ref, "cpu")
            ptrs = [state[key].data_ptr() for key in ("arena", "ef")
                    if key in state]
            new, rec = checked_step(state, k)
            res["stable"] &= [new[key].data_ptr() for key in ("arena", "ef")
                              if key in new] == ptrs
            res["handover"].append(rec)
        res["record"] = comm.record.as_dict()
        res["predicted"] = zero1_prediction(step, len(handover[rank][mode]))
        out[mode] = res
    return out
