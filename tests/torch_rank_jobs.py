"""Per-rank jobs of the port's multi-rank CPU tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never import
JAX.  Each job takes ``(rank, world, ...)`` and returns numpy values."""

from __future__ import annotations

import numpy as np


def ring_cases():
    """(name, chunks, bidirectional, wire_dtype) of the ring tests."""
    return [("c1_bi_f32", 1, True, None), ("c2_bi_f32", 2, True, None),
            ("c1_uni_f32", 1, False, None), ("c2_uni_f32", 2, False, None),
            ("c2_bi_bf16", 2, True, "bfloat16"),
            ("c1_uni_bf16", 1, False, "bfloat16")]


def ring_inputs(world: int, length: int) -> np.ndarray:
    """(world, length) fp32: row ``r`` is rank ``r``'s buffer."""
    return np.random.RandomState(world).randn(world, length).astype(
        np.float32)


def ring_job(rank: int, world: int, length: int) -> dict:
    """Every ring case on this rank: all-reduce, reduce-scatter and the
    all-gather of that reduce-scatter, plus a hierarchical all-reduce over
    a (2, world/2) mesh when ``world == 4``."""
    import torch

    from repro_torch.core import ring
    from repro_torch.core.p2p import CommRecord, axis_rings
    from repro_torch.core.topology import RankMesh

    x = torch.from_numpy(ring_inputs(world, length)[rank])
    record = CommRecord()
    (axis,) = axis_rings(RankMesh(("data",), (world,)), rank, ("data",),
                         record)
    out = {}
    for name, chunks, bidi, wire in ring_cases():
        cfg = ring.RingConfig(chunks=chunks, bidirectional=bidi,
                              wire_dtype=wire)
        out[f"{name}/ar"] = ring.ring_all_reduce(x, axis, cfg).numpy()
        rs = ring.ring_reduce_scatter(x, axis, cfg)
        out[f"{name}/rs"] = rs.numpy()
        out[f"{name}/ag"] = ring.ring_all_gather(rs, axis, cfg).numpy()
    if world == 4:
        pod, data = axis_rings(RankMesh(("pod", "data"), (2, 2)), rank,
                               ("pod", "data"), record)
        cfg = ring.RingConfig(chunks=2)
        out["hier/ar"] = ring.hierarchical_all_reduce(x, [data, pod],
                                                      cfg).numpy()
    return out


def arena_vs_buckets_job(rank: int, world: int) -> dict:
    """One gradient tree reduced through the bucket path and through the
    arena path of the same communicator config, for every transport, every
    ``reduce_scheduled`` op and one and two microbatches.  All-reduce
    results come back as trees; reduce-scatter shards are all-gathered and
    unpacked into trees; ``op="none"`` returns the local accumulation."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core.topology import RankMesh
    from repro_torch.mem.arena import CommArena
    from repro_torch.mem.layout import plan_arena

    rng = np.random.RandomState(3)
    tree = {f"g{i}": torch.from_numpy(
        rng.randn(500 + 128 * i).astype(np.float32)) for i in range(4)}
    tree["m"] = [torch.from_numpy(rng.randn(7, 33).astype(np.float32))]
    batch = {"x": torch.zeros(4, 3)}

    def grad_fn(params, mb):
        scale = 1.0 + rank
        return (torch.zeros(()),
                tree_util.tree_map(lambda t: t * scale, params))

    def numpy_tree(t):
        return [x.numpy().copy() for x in tree_util.leaves(t)]

    mesh = RankMesh(("data",), (world,))
    out = {}
    for transport in ("ring_hier", "ring", "psum"):
        comm = Communicator(mesh, CommConfig(
            transport=transport, data_axes=("data",), channels=2,
            bucket_bytes=2048, page_bytes=1024, chunks=1))
        # op="none" packs leaves, not buckets: one segment per leaf (the
        # reference's fsdp accumulation arena)
        leaf_arena = CommArena(plan_arena(
            [x.numel() for x in tree_util.leaves(tree)], page_bytes=1024))
        ops = (("all_reduce", "none") if transport == "psum"
               else ("all_reduce", "reduce_scatter", "none"))
        for op in ops:
            for m in (1, 2):
                policy = "scheduled" if m == 1 else "accumulate_then_reduce"
                sched = comm.schedule(tree, policy, m)
                _, got = comm.reduce_scheduled(grad_fn, tree, batch, sched,
                                               op=op)
                if op == "reduce_scatter":
                    shards, bplan = got
                    got = comm.bucketer.debucketize(comm.all_gather(shards),
                                                    bplan)
                arena = leaf_arena if op == "none" else comm.arena(tree)
                buf = arena.zeros("cpu")
                ptr = buf.data_ptr()
                _, agot = comm.reduce_scheduled(
                    grad_fn, tree, batch, comm.arena_schedule(tree, policy, m),
                    op=op, arena=arena, arena_buf=buf)
                assert agot[-1].data_ptr() == ptr
                if op == "reduce_scatter":
                    spans, bplan, _ = agot
                    agot = comm.bucketer.debucketize(
                        arena.unpack_spans(comm.all_gather(spans)), bplan)
                else:
                    agot = agot[0]
                out[f"{transport}/{op}/{m}"] = (numpy_tree(got),
                                                numpy_tree(agot))
    return out


def train_job(rank: int, world: int, leaves: list, steps: int,
              use_arena: bool, model_kw: dict, step_kw: dict) -> dict:
    """The replicated train loop of the reduced llama from the given
    parameter leaves (JAX tree order); returns the loss trajectory, the
    final parameter leaves and the communicator's record of one step."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.comm import CommConfig
    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import (TrainStepConfig,
                                                abstract_params, data_mesh)

    model = build_model(reduced_config("llama3.2-1b").with_(**model_kw))
    treedef = tree_util.flatten(abstract_params(model))[1]
    params = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    step_cfg = TrainStepConfig(
        comm=CommConfig(**step_kw["comm"]),
        optim=OptimConfig(**step_kw["optim"]), use_arena=use_arena)
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=step_kw["seq"],
                                      global_batch=step_kw["batch"]))
    trainer = Trainer(model, data_mesh(world), step_cfg, data,
                      TrainerConfig(steps=steps), device=torch.device("cpu"),
                      rank=rank, params=params, log=lambda msg: None)
    comm = trainer.step_fn.comm
    comm.record.reset()
    hist = trainer.run()["history"]
    record = comm.record.as_dict()
    plan = trainer.step_fn.plan
    return {"loss": np.array([h["loss"] for h in hist]),
            "grad_norm": np.array([h["grad_norm"] for h in hist]),
            "params": [bridge.params_to_numpy(p) for p in
                       tree_util.leaves(trainer.state["params"])],
            "record": record,
            "predicted": {
                "sends": (plan.arena_messages_per_device if use_arena
                          else plan.messages_per_device) * steps,
                "send_bytes": (plan.arena_bytes_per_device if use_arena
                               else plan.bytes_per_device) * steps}}


def env_rank_job(fail_rank: int) -> tuple[str, str]:
    """A launcher job: this process's rank and world from its environment;
    raises on ``fail_rank``."""
    import os

    rank = os.environ["RANK"]
    if int(rank) == fail_rank:
        raise ValueError(f"rank {rank} was told to fail")
    return rank, os.environ["WORLD_SIZE"]
