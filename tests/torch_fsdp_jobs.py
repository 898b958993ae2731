"""Per-rank jobs of the port's FSDP CPU tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never import
JAX.  Each job takes ``(rank, world, ...)`` and returns numpy values."""

from __future__ import annotations

import numpy as np


def fsdp_step_config(step_kw: dict, case: dict, wire_codec=None):
    """The fsdp :class:`TrainStepConfig` of one test case."""
    from repro_torch.comm import CommConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    return TrainStepConfig(
        dp_mode="fsdp", comm=CommConfig(**step_kw["comm"]),
        optim=OptimConfig(**step_kw["optim"]), use_arena=case["arena"],
        microbatches=step_kw["microbatches"],
        schedule=case.get("schedule", step_kw["schedule"]),
        fsdp_gather=case["gather"],
        fsdp_bucket_bytes=step_kw["fsdp_bucket_bytes"],
        gather_dtype=step_kw.get("gather_dtype", "bfloat16"),
        wire_codec=wire_codec)


def fsdp_model(remat: str = "none"):
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    return build_model(reduced_config("llama3.2-1b").with_(remat=remat))


def fsdp_prediction(step, steps: int) -> dict:
    """What ``steps`` fsdp steps put on the wire, from the plan and the
    code, for one data axis of ``p`` ranks.

    Per microbatch every group bucket is gathered once in the forward pass
    and, under ``remat="layer"``, a block's buckets once more when the
    backward pass recomputes the block; the backward reduce-scatters every
    bucket once.  The ring gather sends each channel slice of the
    ``n / p``-element shard ``p - 1`` times in the gather dtype; the ring
    reduce-scatter the same slices in fp32, its accumulation dtype.  The
    native gather is one ``all_gather_into_tensor`` of the shard and one
    ``reduce_scatter_tensor`` of the ``n``-element cotangent, in the
    gather dtype.  Every step all-reduces two fp32 scalars over data: the
    loss's mean and the norm's sum of squares."""
    import torch

    from repro_torch.core.ring import _channel_slices

    plan, comm = step.fsdp, step.comm
    assert len(comm.axes) == 1, "the prediction counts one data axis"
    p = comm.world
    runs = step.schedule.microbatches * steps
    item = getattr(torch, step.cfg.gather_dtype).itemsize
    remat = step.model.cfg.remat == "layer"
    out = dict.fromkeys(("sends", "send_bytes", "all_gathers",
                         "all_gather_bytes", "reduce_scatters",
                         "reduce_scatter_bytes"), 0)
    out.update(all_reduces=2 * steps, all_reduce_bytes=2 * 4 * steps)
    if p == 1:
        return out
    for name, bplan in plan.plans.items():
        gathers = 2 if remat and name.startswith("blocks.") else 1
        for n in bplan.bucket_sizes:
            shard = n // p
            if plan.gather_impl == "ring":
                slices = len(_channel_slices(shard, comm.transport.ring_cfg))
                out["sends"] += (gathers + 1) * slices * (p - 1) * runs
                out["send_bytes"] += ((gathers * item + 4) * shard
                                      * (p - 1) * runs)
            else:
                out["all_gathers"] += gathers * runs
                out["all_gather_bytes"] += gathers * shard * item * runs
                out["reduce_scatters"] += runs
                out["reduce_scatter_bytes"] += n * item * runs
    return out


def _plan_record(step) -> dict:
    """The plan's groups, bucket sizes and arena segments."""
    plan = step.fsdp
    out = {"groups": sorted(plan.groups),
           "sizes": {name: list(b.bucket_sizes)
                     for name, b in plan.plans.items()}}
    lay = plan.arena_layout
    if lay is not None:
        out["arena"] = np.array([[s.offset, s.size, s.padded]
                                 for s in lay.segments])
        out["arena_total"] = lay.total_elems
    return out


def _numpy_groups(groups) -> dict:
    from repro_torch import bridge

    return {name: bridge.params_to_numpy(shards)
            for name, shards in groups.items()}


def _train(rank, world, leaves, case, steps, step_kw, data,
           at_weights=None) -> dict:
    """One case's fsdp run from the bridged parameter leaves.  Besides the
    run's results it keeps the shards that entered the last step
    (``"pre_last"``).  With ``at_weights`` (``{group: [global buckets]}``)
    it then takes the last step once more from this rank's shards of those
    weights, and returns that step's loss (``"loss_at"``); the record and
    the results above are taken before it."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.runtime.train_step import (TrainStep, abstract_params,
                                                data_mesh, init_train_state,
                                                shard_batch)

    model = fsdp_model(case["remat"])
    treedef = tree_util.flatten(abstract_params(model))[1]
    params = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    step = TrainStep(model, data_mesh(world), fsdp_step_config(step_kw, case),
                     device=torch.device("cpu"))
    state = init_train_state(model, step, params=params)
    init = _numpy_groups(state["groups"])
    ptr = state["arena"].data_ptr() if "arena" in state else None
    step.comm.record.reset()
    losses, norms = [], []
    for s in range(steps):
        if s == steps - 1:
            pre_last = {"groups": state["groups"], "opt": state["opt"],
                        "step": state["step"]}
            pre_last_np = _numpy_groups(state["groups"])
        state, metrics = step(state, shard_batch(data.batch_at(s), rank,
                                                 world))
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    out = {"plan": _plan_record(step), "init": init,
            "loss": np.array(losses), "grad_norm": np.array(norms),
            "groups": _numpy_groups(state["groups"]),
            "mu": _numpy_groups(state["opt"]["mu"]),
            "nu": _numpy_groups(state["opt"]["nu"]),
            "stable": ptr is None or state["arena"].data_ptr() == ptr,
            "record": step.comm.record.as_dict(),
            "predicted": fsdp_prediction(step, steps),
            "pre_last": pre_last_np}
    if at_weights is not None:
        groups = {}
        for name, fulls in at_weights.items():
            groups[name] = []
            for full, mine in zip(fulls, pre_last["groups"][name]):
                n = full.size // world
                groups[name].append(torch.from_numpy(np.ascontiguousarray(
                    full[rank * n:(rank + 1) * n])).to(mine.dtype))
        again = dict(state, groups=groups, opt=pre_last["opt"],
                     step=pre_last["step"])
        _, metrics = step(again, shard_batch(data.batch_at(steps - 1), rank,
                                             world))
        out["loss_at"] = float(metrics["loss"])
    return out


def _gather_flat_checks(rank: int, world: int) -> dict:
    """``gather_flat`` of seeded shards, both implementations, fp32 and
    bf16: the gather is the concatenation of every rank's shard, and the
    shard's gradient under a seeded per-rank cotangent is this rank's slice
    of the cotangents' sum, rounded once to the dtype, bitwise."""
    import torch

    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.runtime.train_step import data_mesh

    comm = Communicator(data_mesh(world), CommConfig(transport="ring_hier",
                                                     chunks=2))
    out = {}
    for dtype in (torch.float32, torch.bfloat16):
        rng = np.random.RandomState(100)
        n = 1024 * world
        shards = [torch.from_numpy(rng.randn(n // world).astype(np.float32))
                  .to(dtype) for _ in range(world)]
        cots = [torch.from_numpy(rng.randn(n).astype(np.float32)).to(dtype)
                for _ in range(world)]
        summed = sum(c.float() for c in cots).to(dtype)
        want = summed[rank * (n // world):(rank + 1) * (n // world)]
        for native in (True, False):
            shard = shards[rank].clone().requires_grad_(True)
            full = comm.gather_flat(shard, native=native)
            (grad,) = torch.autograd.grad(full, shard, cots[rank])
            key = f"{'native' if native else 'ring'}/{str(dtype)[6:]}"
            out[key] = {"gather": bool(torch.equal(full.detach(),
                                                   torch.cat(shards))),
                        "gather_dtype": full.dtype == dtype,
                        "grad": bool(torch.equal(grad, want)),
                        "grad_dtype": grad.dtype == dtype}
    return out


def _gathered_serve(rank: int, world: int, leaves: list, serve_kw: dict
                    ) -> dict:
    """The gathered prefill and decode steps over ``world`` ranks: this
    rank's shards of the bridged parameters, its rows of the logits."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models.transformer import init_decode_state
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill, local_batch)
    from repro_torch.runtime.train_step import (FsdpPlan, TrainStepConfig,
                                                abstract_params, data_mesh)

    model = fsdp_model()
    mesh = data_mesh(world)
    treedef = tree_util.flatten(abstract_params(model))[1]
    params = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    groups = FsdpPlan(model, mesh, TrainStepConfig(
        dp_mode="fsdp")).shard_state(params)
    b, s = serve_kw["batch"], serve_kw["seq"]
    prefill = build_prefill(model, ShapeConfig("t", s, b, "prefill"),
                            weight_mode="gathered", device="cpu", mesh=mesh)
    logits = prefill({"groups": groups},
                     {"tokens": torch.from_numpy(serve_kw["tokens"])})
    shape = ShapeConfig("t", serve_kw["cache"], b, "decode")
    decode = build_decode_step(model, shape, weight_mode="gathered",
                               device="cpu", mesh=mesh)
    state = init_decode_state(model.cfg, local_batch(shape, mesh),
                              serve_kw["cache"], cache_dtype=torch.float32,
                              device="cpu")
    steps = []
    for pos, tok in enumerate(serve_kw["decode_tokens"]):
        out, state = decode({"groups": groups}, torch.from_numpy(tok), state,
                            pos)
        steps.append(out.numpy().copy())
    return {"groups": _numpy_groups(groups), "prefill": logits.numpy(),
            "decode": steps}


def fsdp_job(rank: int, world: int, leaves: list, cases: dict, steps: int,
             step_kw: dict, policies: list, serve_kw: dict,
             at_weights: dict | None = None) -> dict:
    """Every 2-rank check of ``test_torch_fsdp.py`` in one spawn: each
    case's run (:func:`_train`, its last step taken again from
    ``at_weights[case]`` where given), the native gather's run under each of
    ``policies`` for 2 steps, the :func:`_gather_flat_checks` and the
    gathered serving steps."""
    from repro_torch.data import DataConfig, SyntheticTokens

    model = fsdp_model()
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))
    at_weights = at_weights or {}
    out = {"cases": {name: _train(rank, world, leaves, case, steps, step_kw,
                                  data, at_weights.get(name))
                     for name, case in cases.items()}}
    out["policies"] = {
        policy: _train(rank, world, leaves,
                       dict(cases["native"], schedule=policy), 2, step_kw,
                       data)
        for policy in policies}
    out["gather_flat"] = _gather_flat_checks(rank, world)
    out["serve"] = _gathered_serve(rank, world, leaves, serve_kw)
    return out


def fsdp_int8_job(rank: int, world: int, handover: list, step_kw: dict
                  ) -> dict:
    """fsdp steps under the int8 wire with the arena, the native gather:
    step ``k`` taken from ``handover[rank][k]``, this rank's reference
    state before step ``k`` (numpy).  Per step: the loss, gradient norm,
    learning rate, new shards, new moments and ``"ef"``; the block scale of
    the arena's encode of every element of this rank's compensated
    gradient shards, in the ``"ef"`` layout (``"scales"``); whether
    ``"ef"`` is ``comp - decode(encode(comp))`` of them bitwise; whether
    the arena and ``"ef"`` kept their storage; the record of the steps
    beside :func:`fsdp_prediction`."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.comm import Int8BlockCodec
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.runtime.train_step import (TrainStep, data_mesh,
                                                shard_batch)

    model = fsdp_model()
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))
    step = TrainStep(model, data_mesh(world), fsdp_step_config(
        step_kw, {"arena": True, "gather": "native"}, "int8"),
        device=torch.device("cpu"))
    lay = step.arena.layout
    block = lay.block
    codec = Int8BlockCodec(block, impl="plain")
    res = {"handover": [], "stable": True}
    step.comm.record.reset()
    calls = 0
    for k, ref in enumerate(handover[rank]):
        state = bridge.state_from_numpy(ref, "cpu")
        ptrs = [state[key].data_ptr() for key in ("arena", "ef")]
        batch = shard_batch(data.batch_at(k), rank, world)
        # the reduced gradient shards the arena encodes (one microbatch:
        # the gathers' backward sums them over the ranks); every rank asks
        # together, the gathers are collectives
        _, grads = step._grad_fn(state["groups"], batch)
        calls += 1
        want_ef = state["ef"].clone()
        scales = torch.zeros(lay.payload_elems)
        for seg, g in zip(lay.segments, tree_util.leaves(grads)):
            lo, hi = seg.offset, seg.offset + seg.size
            comp = g.reshape(-1) + want_ef[lo:hi]
            payload = codec.encode(comp)
            want_ef[lo:hi] = comp - codec.decode(payload)
            scales[lo:hi] = codec.split(payload)[1].repeat_interleave(block)
        del grads
        new, metrics = step(state, batch)
        res["stable"] &= [new[key].data_ptr() for key in ("arena", "ef")] \
            == ptrs
        back = bridge.state_to_numpy(new)
        res["handover"].append({
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "lr": float(metrics["lr"]), "step": int(back["step"]),
            "groups": back["groups"], "mu": back["opt"]["mu"],
            "nu": back["opt"]["nu"], "ef": back["ef"],
            "scales": scales.numpy(),
            "ef_identity": bool(torch.equal(new["ef"], want_ef))})
    res["record"] = step.comm.record.as_dict()
    # the extra gradient pass per step runs the step's gathers again
    pred = fsdp_prediction(step, len(handover[rank]) + calls)
    pred["all_reduces"] = 2 * len(handover[rank])
    pred["all_reduce_bytes"] = 8 * len(handover[rank])
    res["predicted"] = pred
    return res
