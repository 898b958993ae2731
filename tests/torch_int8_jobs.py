"""Per-rank jobs of the port's int8-wire CPU tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never import
JAX.  Each job takes ``(rank, world, ...)`` and returns numpy values."""

from __future__ import annotations

import numpy as np

LENGTH = 4096      # 4 ranks x 2 chunks x 2 directions x block 128, twice


def ring_cases():
    """(name, chunks, bidirectional, codec_block) of the int8 ring tests."""
    return [("c1_bi_b128", 1, True, 128), ("c2_bi_b128", 2, True, 128),
            ("c2_uni_b128", 2, False, 128), ("c1_bi_b512", 1, True, 512)]


def ring_inputs(world: int) -> np.ndarray:
    """(world, LENGTH) fp32: row ``r`` is rank ``r``'s buffer."""
    return (np.random.RandomState(100 + world).randn(world, LENGTH)
            * 2.0).astype(np.float32)


def tree_inputs(world: int) -> dict:
    """A gradient-shaped tree per rank: leaf ``k`` is (world, ...)."""
    rng = np.random.RandomState(200 + world)
    return {"a": rng.randn(world, 1000).astype(np.float32),
            "b": rng.randn(world, 7, 33).astype(np.float32),
            "c": rng.randn(world, 2048).astype(np.float32)}


def ef_inputs(world: int, sizes) -> list:
    """Error-feedback residuals per bucket: (world, size) each."""
    rng = np.random.RandomState(300 + world)
    return [(rng.randn(world, n) * 0.05).astype(np.float32) for n in sizes]


TREE_COMM = dict(transport="ring_hier", data_axes=("data",),
                 wire_codec="int8", codec_block=128, chunks=1,
                 bucket_bytes=8192)


def ring_int8_job(rank: int, world: int) -> dict:
    """Every int8 ring case on this rank: all-reduce, reduce-scatter and the
    all-gather of that reduce-scatter (plus a hierarchical all-reduce over a
    (2, 2) mesh at 4 ranks), the sends and bytes recorded, and the bucket
    path's all-reduce of a tree with error feedback."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core import ring
    from repro_torch.core.p2p import CommRecord, axis_rings
    from repro_torch.core.topology import RankMesh

    x = torch.from_numpy(ring_inputs(world)[rank])
    record = CommRecord()
    (axis,) = axis_rings(RankMesh(("data",), (world,)), rank, ("data",),
                         record)
    out = {}
    for name, chunks, bidi, block in ring_cases():
        cfg = ring.RingConfig(chunks=chunks, bidirectional=bidi,
                              codec="int8", codec_block=block)
        record.reset()
        out[f"{name}/ar"] = ring.ring_all_reduce(x, axis, cfg).numpy()
        out[f"{name}/record"] = (record.sends, record.send_bytes)
        rs = ring.ring_reduce_scatter(x, axis, cfg)
        out[f"{name}/rs"] = rs.numpy()
        out[f"{name}/ag"] = ring.ring_all_gather(rs, axis, cfg).numpy()
    if world == 4:
        pod, data = axis_rings(RankMesh(("pod", "data"), (2, 2)), rank,
                               ("pod", "data"), record)
        cfg = ring.RingConfig(chunks=2, codec="int8", codec_block=128)
        out["hier/ar"] = ring.hierarchical_all_reduce(x, [data, pod],
                                                      cfg).numpy()
    comm = Communicator(RankMesh(("data",), (world,)),
                        CommConfig(**TREE_COMM))
    tree = {k: torch.from_numpy(v[rank].copy())
            for k, v in tree_inputs(world).items()}
    sizes = comm.bucketer.plan(tree).bucket_sizes
    ef = [torch.from_numpy(e[rank].copy()) for e in ef_inputs(world, sizes)]
    red, new_ef = comm.all_reduce_tree(tree, ef)
    out["tree/reduced"] = [t.numpy() for t in tree_util.leaves(red)]
    out["tree/ef"] = [e.numpy() for e in new_ef]
    out["tree/sizes"] = list(sizes)
    return out


def train_int8_job(rank: int, world: int, leaves: list, steps: int,
                   step_kw: dict, handover: list) -> dict:
    """The replicated train loop of the reduced llama under the int8 wire,
    with the arena and without (``"arena"`` and ``"bucket"`` in the
    result), from the given parameter leaves (JAX tree order).

    Free run: ``steps`` steps from the initial state, with per step the
    loss, gradient norm, parameters, ``"ef"``, whether that ``"ef"`` is
    ``comp - decode(encode(comp))`` of the step's compensated local
    gradient bitwise, the storage of the arena and ``"ef"`` and the record
    of the run beside the plan.  Handover: step ``k`` taken once more from
    ``handover[rank][mode][k]``, this rank's reference state before step
    ``k`` (numpy), with the loss, gradient norm, new parameters, moments
    and ``"ef"``.  Every step also reports the block scale of this rank's
    first encode of every gradient element, shaped like the parameters
    (``"scales"``) and, with the arena, laid out like ``"ef"`` (0 where no
    segment lies, ``"ef_scales"``)."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.comm import CommConfig, Int8BlockCodec
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import (TrainStepConfig,
                                                abstract_params, data_mesh,
                                                shard_batch)

    model = build_model(reduced_config("llama3.2-1b"))
    treedef = tree_util.flatten(abstract_params(model))[1]
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))

    out = {}
    for mode, use_arena in (("arena", True), ("bucket", False)):
        params = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
        step_cfg = TrainStepConfig(
            comm=CommConfig(**step_kw["comm"]),
            optim=OptimConfig(**step_kw["optim"]), use_arena=use_arena,
            wire_codec="int8")
        trainer = Trainer(model, data_mesh(world), step_cfg, data,
                          TrainerConfig(steps=steps),
                          device=torch.device("cpu"), rank=rank,
                          params=params, log=lambda msg: None)
        step, state = trainer.step_fn, trainer.state
        comm = step.comm
        block = comm.cfg.codec_block
        codec = Int8BlockCodec(block, impl="plain")

        def checked_step(state, s):
            """One step on batch ``s``, and what the step's first encodes
            of this rank's local gradient give (autograd on the CPU is
            deterministic, so the gradient is computed again here): the
            new ``"ef"`` they predict and their block scales, per
            gradient element."""
            batch = shard_batch(data.batch_at(s), rank, world)
            _, grads = step._grad_fn(state["params"], batch)
            buckets, bplan = comm.bucketer.bucketize(grads)
            scales = []
            want_ef = None
            if use_arena:
                want_ef = state["ef"].clone()
                for seg in step.arena.layout.segments:
                    lo, hi = seg.offset, seg.offset + seg.size
                    buckets[seg.bucket] = buckets[seg.bucket] + want_ef[lo:hi]
            for b in buckets:
                payload = codec.encode(b)
                scales.append(codec.split(payload)[1].repeat_interleave(
                    block))
                b.sub_(codec.decode(payload))       # the residual
            if use_arena:
                ef_scales = torch.zeros_like(want_ef)
                for seg in step.arena.layout.segments:
                    lo, hi = seg.offset, seg.offset + seg.size
                    want_ef[lo:hi] = buckets[seg.bucket]
                    ef_scales[lo:hi] = scales[seg.bucket]
            state, metrics = step(state, batch)
            back = bridge.state_to_numpy(state)     # the reference's form
            rec = {"loss": float(metrics["loss"]),
                   "grad_norm": float(metrics["grad_norm"]),
                   "lr": float(metrics["lr"]), "step": int(back["step"]),
                   "params": tree_util.leaves(back["params"]),
                   "mu": tree_util.leaves(back["opt"]["mu"]),
                   "nu": tree_util.leaves(back["opt"]["nu"]),
                   "scales": tree_util.leaves(bridge.params_to_numpy(
                       comm.bucketer.debucketize(scales, bplan)))}
            if use_arena:
                rec["ef"] = back["ef"]
                rec["ef_identity"] = bool(torch.equal(state["ef"], want_ef))
                rec["ef_scales"] = ef_scales.numpy()
            return state, rec

        ptrs = [state[k].data_ptr() for k in ("arena", "ef") if k in state]
        comm.record.reset()
        history = []
        for s in range(steps):
            state, rec = checked_step(state, s)
            history.append(rec)
        res = {"free": history,
               "stable": [state[k].data_ptr() for k in ("arena", "ef")
                          if k in state] == ptrs,
               "record": comm.record.as_dict()}
        plan = step.plan
        res["predicted"] = (
            {"sends": plan.arena_messages_per_device * steps,
             "send_bytes": plan.arena_bytes_per_device * steps}
            if use_arena else
            # the plan's bucket bytes count the used elements; the wire
            # carries the buckets' padding too, at the same rate
            {"sends": plan.messages_per_device * steps,
             "send_bytes": comm.transport.predicted_bytes_per_device(
                 plan.bucket_plan.total_elems, comm.axis_sizes) * steps})
        res["handover"] = []
        for k, ref in enumerate(handover[rank][mode]):
            ref = dict(ref)
            ref["params"] = treedef.unflatten(ref["params"])
            ref["opt"] = {n: treedef.unflatten(v)
                          for n, v in ref["opt"].items()}
            _, rec = checked_step(bridge.state_from_numpy(ref, "cpu"), k)
            res["handover"].append(rec)
        out[mode] = res
    return out


ARENA_COMM = dict(data_axes=("data",), channels=2, bucket_bytes=2048,
                  page_bytes=1024, chunks=1, wire_codec="int8",
                  codec_block=128)
ARENA_MICRO = 2


def arena_cases():
    """(transport, policy, op) of the int8 arena reduction tests, each over
    ``ARENA_MICRO`` microbatches."""
    policies = ("accumulate_then_reduce", "stream")
    return ([("ring_hier", pol, op) for pol in policies
             for op in ("all_reduce", "reduce_scatter")]
            + [("psum", pol, "all_reduce") for pol in policies])


def arena_grads(world: int) -> dict:
    """Fixed local gradients: leaf ``k`` is (world, ARENA_MICRO, ...), rank
    ``r``'s gradient of microbatch ``i`` at ``[r, i]``."""
    rng = np.random.RandomState(400 + world)
    m = ARENA_MICRO
    tree = {f"g{i}": (rng.randn(world, m, 500 + 128 * i) * (1 + i))
            .astype(np.float32) for i in range(4)}
    tree["m"] = [rng.randn(world, m, 7, 33).astype(np.float32)]
    return tree


def arena_state(world: int, total: int, payload: int):
    """The arena bytes and error-feedback accumulator each rank starts
    from: (world, total) int8 (stale bytes everywhere) and (world, payload)
    fp32."""
    rng = np.random.RandomState(500 + world)
    arena = rng.randint(-128, 128, (world, total)).astype(np.int8)
    ef = (rng.randn(world, payload) * 0.02).astype(np.float32)
    return arena, ef


def quant_arena_job(rank: int, world: int) -> dict:
    """The int8 arena's ``reduce_scheduled`` on this rank for every case of
    :func:`arena_cases`, from :func:`arena_grads` (a ``grad_fn`` that hands
    back microbatch ``i``'s fixed gradient on its ``i``-th call, so
    autograd plays no part) and :func:`arena_state`: the reduced tree (or
    span shards), the arena bytes and the new accumulator."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core.topology import RankMesh

    grads = tree_util.tree_map(lambda x: torch.from_numpy(x[rank].copy()),
                               arena_grads(world))
    local = tree_util.tree_map(lambda x: x[0], grads)
    batch = {"x": torch.zeros(ARENA_MICRO, 1)}
    out = {}
    for transport, policy, op in arena_cases():
        comm = Communicator(RankMesh(("data",), (world,)),
                            CommConfig(transport=transport, **ARENA_COMM))
        arena = comm.arena(local)
        lay = arena.layout
        buf0, ef0 = arena_state(world, lay.total_elems, lay.payload_elems)
        buf = torch.from_numpy(buf0[rank].copy())
        ef = torch.from_numpy(ef0[rank].copy())
        calls = []

        def grad_fn(params, mb):
            i = len(calls)
            calls.append(i)
            return torch.zeros(()), tree_util.tree_map(lambda x: x[i],
                                                       params)

        sched = comm.arena_schedule(local, policy, ARENA_MICRO)
        _, res = comm.reduce_scheduled(grad_fn, grads, batch, sched, op=op,
                                       arena=arena, arena_buf=buf,
                                       ef_buf=ef)
        assert res[-2] is buf and res[-1] is ef          # in place
        reduced = (tree_util.leaves(res[0]) if op == "all_reduce"
                   else res[0])
        out[f"{transport}/{policy}/{op}"] = {
            "reduced": [t.numpy().copy() for t in reduced],
            "arena": buf.numpy().copy(), "ef": ef.numpy().copy(),
            "calls": len(calls)}
    return out
