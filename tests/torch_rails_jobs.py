"""Per-rank jobs of ``tests/test_torch_rails.py`` and
``tests/test_torch_reducer.py`` (run by ``torch_dist_util.run_ranks``).
Torch only: the spawned ranks never import JAX.  Each job takes ``(rank,
world, ...)`` and returns numpy values and plain dicts."""

from __future__ import annotations

import numpy as np

RAIL_COUNTS = (1, 2, 3)
TREE_SIZES = ((37, 19), (512,), (1000,), (3, 128), (2048,), (5,), (64, 33))
A2A_TRANSPORTS = ("a2a", "ring")

# the reducer tests' tree: every leaf a multiple of the bucketer's 128
# elements, so that the per-tensor baseline's buckets carry no padding and
# the plan's bytes (of the used elements) are the wire's
REDUCER_SIZES = ((24, 16), (256,), (3, 128), (1024,), (128,))


def rank_tree(rank: int, sizes=TREE_SIZES, seed: int = 0) -> dict:
    """A gradient-shaped tree of fp32 leaves of ``sizes``, different on
    every rank (``seed`` and ``rank`` pick the stream)."""
    import torch

    g = torch.Generator().manual_seed(1000 * seed + rank)
    return {f"w{i}": torch.randn(s, generator=g)
            for i, s in enumerate(sizes)}


def _np(tree) -> dict:
    return {k: v.numpy().copy() for k, v in tree.items()}


def _wire(record) -> dict:
    """Every count of a record but ``staging_s`` (host time)."""
    return {k: v for k, v in record.as_dict().items() if k != "staging_s"}


def _tree_cases(comm, tree) -> dict:
    """all_reduce_tree, and reduce_scatter_tree + all_gather_buckets."""
    out = {}
    comm.record.reset()
    red, _ = comm.all_reduce_tree(tree)
    out["all_reduce"] = {"out": _np(red), "record": _wire(comm.record)}
    comm.record.reset()
    shards, bplan = comm.reduce_scatter_tree(tree)
    full = comm.all_gather_buckets(shards, bplan)
    out["rs_ag"] = {"out": {**_np(full),
                            **{f"shard{i}": s.numpy().copy()
                               for i, s in enumerate(shards)}},
                    "record": _wire(comm.record)}
    return out


def _arena_cases(comm, tree, batch: dict) -> dict:
    """reduce_scheduled over the communicator's arena (fp32, or int8 under
    its wire codec) under every schedule policy, two microbatches."""
    from repro_torch.comm import SCHEDULE_POLICIES

    def grad_fn(params, mb):
        s = mb["x"].sum()
        return s, {k: v * s for k, v in params.items()}

    arena = comm.arena(tree)
    quant = comm.codec is not None
    kind = "int8" if quant else "fp32"
    out = {}
    for policy in SCHEDULE_POLICIES:
        sched = comm.arena_schedule(tree, policy, 2)
        buf = arena.zeros("cpu")
        ef = arena.ef_zeros("cpu") if quant else None
        comm.record.reset()
        loss, res = comm.reduce_scheduled(grad_fn, tree, batch, sched,
                                          arena=arena, arena_buf=buf,
                                          ef_buf=ef)
        vals = {**_np(res[0]), "loss": loss.numpy().copy(),
                "arena": res[1].numpy().copy()}
        if quant:
            vals["ef"] = res[2].numpy().copy()
        out[f"arena_{kind}/{policy}"] = {
            "out": vals, "record": _wire(comm.record),
            "plan": comm.plan(tree).arena_messages_per_device}
    return out


def _a2a_cases(comm, x) -> dict:
    comm.record.reset()
    y = comm.all_to_all(x, split_axis=0, concat_axis=1)
    return {f"a2a_{comm.cfg.transport}": {
        "out": {"y": y.numpy().copy()}, "record": _wire(comm.record),
        "rails": comm.a2a_rails(x.shape)}}


def rails_job(rank: int, world: int) -> dict:
    """Every striped path at 1, 2 and 3 rails on this rank.  At 2 rails and
    more each path runs twice on one communicator: on the rails' threads,
    and then in program order on this thread (``_executor`` removed: the
    issue order before the rails had threads), so both see the same
    groups.  Returns ``{(path, rails, mode): {"out", "record", ...}}`` with
    mode ``"threads"`` or ``"sequential"`` (``"sequential"`` only at one
    rail)."""
    import torch

    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core.topology import RankMesh

    mesh = RankMesh(("data",), (world,))
    tree = rank_tree(rank)
    g = torch.Generator().manual_seed(7 + rank)
    batch = {"x": torch.randn(4, 3, generator=g)}
    # (tokens, capacity, features): the rails split the features, the
    # exchange the tokens
    x = torch.randn(4 * world, 3, 6, generator=g)
    results = {}

    def run(comm, cases, *args):
        modes = ["threads", "sequential"] if comm.cfg.channels >= 2 \
            else ["sequential"]
        for mode in modes:
            if mode == "sequential":
                comm._executor = None
            for name, val in cases(comm, *args).items():
                results[(name, comm.cfg.channels, mode)] = val

    for rails in RAIL_COUNTS:
        base = dict(transport="ring_hier", data_axes=("data",),
                    bucket_bytes=4096, chunks=2, channels=rails)
        run(Communicator(mesh, CommConfig(**base)), _tree_cases, tree)
        for codec in (None, "int8"):
            run(Communicator(mesh, CommConfig(**base, page_bytes=4096,
                                              wire_codec=codec)),
                _arena_cases, tree, batch)
        for transport in A2A_TRANSPORTS:
            run(Communicator(mesh, CommConfig(
                transport=transport, data_axes=("data",), channels=rails)),
                _a2a_cases, x)
    return results


def reducer_job(rank: int, world: int, policies: tuple, steps: int) -> dict:
    """Each policy's GradientReducer on this rank against the Communicator
    of the policy's CommConfig, the per-tensor baseline's record against
    its plan, and one TrainStepConfig per policy given through the legacy
    ``reduce`` field against the same one given its CommConfig."""
    import warnings

    from repro_torch.comm import Communicator
    from repro_torch.core.reducer import (GradientReducer, ReduceConfig,
                                          per_tensor_reducer)
    from repro_torch.core.topology import RankMesh

    mesh = RankMesh(("data",), (world,))
    tree = rank_tree(rank, REDUCER_SIZES, seed=1)
    scaled = {k: v * (1.0 + rank) for k, v in rank_tree(
        0, REDUCER_SIZES, seed=1).items()}
    out = {"policies": {}}
    warnings.simplefilter("ignore", DeprecationWarning)
    for policy in policies:
        cfg = ReduceConfig(policy=policy, data_axes=("data",), chunks=2)
        red = GradientReducer(mesh, cfg)
        comm = Communicator(mesh, cfg.comm_config())
        ef = red.init_ef_state(tree)
        got, new_ef = red.reduce(tree, None, ef)
        want, want_ef = comm.all_reduce_tree(tree, ef)
        # the reference's inputs: rank r holds the base tree times (1 + r)
        ref_in, _ = red.reduce(scaled)
        out["policies"][policy] = {
            "got": _np(got), "want": _np(want), "scaled": _np(ref_in),
            "ef": None if ef is None else [e.numpy().copy() for e in ef],
            "new_ef": None if new_ef is None else
            [e.numpy().copy() for e in new_ef],
            "want_ef": None if want_ef is None else
            [e.numpy().copy() for e in want_ef]}
    base = per_tensor_reducer(mesh, ReduceConfig(data_axes=("data",)))
    base.comm.record.reset()
    base.reduce(tree)
    plan = base.comm.plan(tree)
    out["per_tensor"] = {
        "record": _wire(base.comm.record), "n_buckets":
        plan.bucket_plan.n_buckets, "n_leaves": len(tree),
        "messages": plan.messages_per_device,
        "bytes": base.predicted_collective_bytes(tree)["bytes_per_device"]}
    out["train"] = {p: _legacy_steps(mesh, rank, world, p, steps)
                    for p in policies}
    return out


def _legacy_steps(mesh, rank: int, world: int, policy: str,
                  steps: int) -> dict:
    """``steps`` replicated steps of a reduced llama under
    ``TrainStepConfig(comm=None, reduce=ReduceConfig(policy))`` and under
    ``TrainStepConfig(comm=<the policy's CommConfig>)``: losses and final
    parameters of each."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.core.reducer import ReduceConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                                init_train_state,
                                                shard_batch)

    model = build_model(reduced_config("llama3.2-1b"))
    legacy = ReduceConfig(policy=policy, chunks=2)
    # no warmup: every step moves the parameters by the reduced gradient
    optim = OptimConfig(schedule="constant", warmup=0, base_lr=1e-3)
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=16, global_batch=2 * world,
                                      seed=3), model.cfg)
    out = {}
    for name, cfg in (("legacy", TrainStepConfig(comm=None, reduce=legacy,
                                                 optim=optim)),
                      ("comm", TrainStepConfig(comm=legacy.comm_config(),
                                               optim=optim))):
        step = TrainStep(model, mesh, cfg, device=torch.device("cpu"))
        state = init_train_state(model, step,
                                 generator=torch.Generator().manual_seed(0))
        losses = []
        for i in range(steps):
            batch = shard_batch(data.batch_at(i), rank, world)
            state, metrics = step(state, batch)
            losses.append(float(metrics["loss"]))
        out[name] = {"losses": losses,
                     "params": {k: v.detach().numpy().copy() for k, v in
                                _flat(state["params"]).items()},
                     "comm": step.comm.cfg}
    return out


def _flat(tree) -> dict:
    from repro_torch import tree as tree_util

    leaves, _ = tree_util.flatten(tree)
    return {f"leaf{i}": t for i, t in enumerate(leaves)}
