"""Per-rank jobs of the port's tensor-parallel CPU tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never import
JAX.  Each job takes ``(rank, world, ...)`` and returns numpy values."""

from __future__ import annotations

import dataclasses

import numpy as np

ARCH = "llama3.2-1b"


def _mesh(shape):
    from repro_torch.core.topology import RankMesh

    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    return RankMesh(names, tuple(shape))


def ctx_job(rank: int, world: int) -> dict:
    """The model-axis collectives of ``make_ctx`` on a (2, 2) mesh, forward
    and gradient, with rank-dependent inputs (closed forms in the test):
    ``psum``, ``fan_out``, ``gather_replicated``, ``sum_grads_over_model``,
    ``pmax``, ``model_index``, and what the model ring recorded."""
    import torch

    from repro_torch.core.p2p import CommRecord
    from repro_torch.models.parallel import make_ctx, sum_grads_over_model

    mesh = _mesh((2, 2))
    rec = CommRecord()
    ctx = make_ctx(mesh, record=rec)
    out = {"model_index": ctx.model_index(), "model_size": ctx.model_size(),
           "model_ranks": list(ctx.model.ranks)}
    base = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    c = (rank + 1.0) * torch.ones(2, 3) + base
    for name, fn in (("psum", ctx.psum), ("fan_out", ctx.fan_out)):
        x = (base + 10 * rank).requires_grad_(True)
        y = fn(x)
        (g,) = torch.autograd.grad((y * c).sum(), x)
        out[name] = (y.detach().numpy(), g.numpy())
    x = (base + 10 * rank).requires_grad_(True)
    y = ctx.gather_replicated(x)
    cg = torch.arange(12, dtype=torch.float32).reshape(4, 3) * (rank + 1)
    (g,) = torch.autograd.grad((y * cg).sum(), x)
    out["gather"] = (y.detach().numpy(), g.numpy())
    w = (base * (rank + 1)).requires_grad_(True)
    tree = sum_grads_over_model({"w": w, "b": [w]}, ctx)
    (g,) = torch.autograd.grad((tree["w"] * c).sum()
                               + (tree["b"][0] * 2 * c).sum(), w)
    out["sum_grads"] = (tree["w"].detach().numpy(), g.numpy())
    out["pmax"] = ctx.pmax(torch.tensor([float(rank), -float(rank)])).numpy()
    out["record"] = rec.as_dict()
    return out


# ---------------------------------------------------------------------------
# training on a (data, model) mesh
# ---------------------------------------------------------------------------


def tp_step_config(mode: str, use_arena: bool, step_kw: dict):
    from repro_torch.comm import CommConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    return TrainStepConfig(dp_mode=mode, comm=CommConfig(**step_kw["comm"]),
                           microbatches=step_kw["microbatches"],
                           use_arena=use_arena)


def tp_train_job(rank: int, world: int, leaves: dict, batch: dict,
                 cases: list, steps: int, step_kw: dict,
                 heads: dict) -> dict:
    """Per case ``(mode, use_arena)``: a TrainStep over the (2, 2) mesh from
    the given full parameter leaves (JAX tree order, ``leaves["base"]``),
    the first step's reduced gradient (``replicated`` without the arena:
    this rank's blocks, the tree before clipping), the loss and gradient
    norm of every step, the final local parameters, the model ring's and
    the communicator's records of the steps.  Under ``"heads"`` the same
    for ``replicated`` on the config with ``heads`` (``leaves["heads"]``)."""
    import torch

    from repro_torch.configs import reduced_config

    cfg = reduced_config(ARCH)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {case: _train_case(cfg, leaves["base"], tb, *case, steps,
                             step_kw) for case in cases}
    out["heads"] = _train_case(
        cfg.with_(attn=dataclasses.replace(cfg.attn, **heads)),
        leaves["heads"], tb, "replicated", False, steps, step_kw)
    return out


def _train_case(cfg, leaves: list, batch: dict, mode: str, use_arena: bool,
                steps: int, step_kw: dict) -> dict:
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.models import build_model
    from repro_torch.runtime.train_step import (TrainStep, abstract_params,
                                                init_train_state,
                                                shard_batch)

    model = build_model(cfg)
    treedef = tree_util.flatten(abstract_params(model))[1]
    full = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    step = TrainStep(model, _mesh((2, 2)),
                     tp_step_config(mode, use_arena, step_kw),
                     device=torch.device("cpu"))
    state = init_train_state(model, step, params=full)
    mine = shard_batch(batch, step.data_index, step.data_world)
    res = {"data_index": step.data_index,
           "model_index": step.ctx.model_index()}
    if mode == "replicated" and not use_arena:
        _, grads = step.comm.reduce_scheduled(
            step._grad_fn, state["params"], mine, step.schedule,
            op="all_reduce")
        res["grads"] = bridge.params_to_numpy(grads)
    step.comm.record.reset()
    step.model_record.reset()
    losses, norms = [], []
    for _ in range(steps):
        state, metrics = step(state, mine)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    res.update(loss=np.array(losses), grad_norm=np.array(norms),
               params=bridge.params_to_numpy(state["params"]),
               model_record=step.model_record.as_dict(),
               record=step.comm.record.as_dict())
    return res


# ---------------------------------------------------------------------------
# serving on a (1, 2) mesh
# ---------------------------------------------------------------------------


def tp_serve_job(rank: int, world: int, leaves: list, big_leaves: list,
                 tokens: np.ndarray, decode: dict, engine_kw: dict) -> dict:
    """Resident prefill (kernel and blockwise attention) and contiguous
    decode on the (1, 2) mesh, the vocab shards gathered; the kernel's
    calls a prefill on this rank; the contiguous loop at a short rolling
    cache and at a sequence-sharded one; for a config whose second rank
    holds real heads (``big_leaves``), the kernel prefill with its calls,
    the decode at the short cache, and the sequence-sharded decode beside
    its one-rank decode; the paged engine at R = 2 beside R = 1 on one
    trace, with the recorded collectives a decode step and the
    flash-decode calls a step."""
    import torch

    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.kernels import flash_attn
    from repro_torch.models import attention, build_model
    from repro_torch.runtime import serve_step
    from repro_torch.runtime.train_step import abstract_params

    torch.manual_seed(0)
    mesh = _mesh((1, 2))
    model = build_model(reduced_config(ARCH))
    treedef = tree_util.flatten(abstract_params(model))[1]
    full = bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")
    params = bridge.local_params_from_numpy(
        treedef.unflatten(leaves), model.param_specs(mesh), mesh, rank,
        "cpu")
    out = {"resident_is_local": all(
        torch.equal(a, b) for a, b in zip(
            tree_util.leaves(params),
            tree_util.leaves(serve_step.resident_params(model, full,
                                                        mesh))))}
    b, s = tokens.shape
    shape = ShapeConfig("prefill", s, b, "prefill")
    calls = []
    real = flash_attn.flash_attention

    def spy(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    # a config whose rank 1 holds real heads (16 of 16)
    cfg = reduced_config(ARCH)
    bmodel = build_model(cfg.with_(attn=dataclasses.replace(
        cfg.attn, num_heads=16, num_kv_heads=4)))
    btreedef = tree_util.flatten(abstract_params(bmodel))[1]
    bfull = bridge.params_from_numpy(btreedef.unflatten(big_leaves), "cpu")
    bparams = serve_step.resident_params(bmodel, bfull, mesh)
    attention.flash_attention = spy
    try:
        for impl in ("kernel", "blockwise"):
            pre = serve_step.build_prefill(model, shape, attn_impl=impl,
                                           device="cpu", mesh=mesh)
            local = pre(params, {"tokens": torch.from_numpy(tokens)})
            out[f"prefill_local_{impl}"] = local.shape
            out[f"prefill_{impl}"] = serve_step.gather_vocab(
                pre.ctx, local).numpy()
        out["flash_attn_calls"] = list(calls)
        calls.clear()
        pre = serve_step.build_prefill(bmodel, shape, device="cpu",
                                       mesh=mesh)
        out["big_prefill"] = serve_step.gather_vocab(
            pre.ctx, pre(bparams, {"tokens": torch.from_numpy(tokens)})
        ).numpy()
        out["big_flash_attn_calls"] = calls
    finally:
        attention.flash_attention = real
    for key, cache in (("short", decode["short"]), ("long", decode["long"])):
        out[f"decode_{key}"] = _decode_loop(model, params, mesh, cache,
                                            decode["tokens"], decode["steps"])
        out[f"state_{key}"] = [tuple(layer["kv"]["k"].shape) for layer in
                               serve_step.init_decode_state(
                                   model, ShapeConfig(
                                       "s", cache, decode["tokens"].shape[0],
                                       "decode"), mesh,
                                   cache_dtype=torch.float32, device="cpu")]
    out["big_short"] = _decode_loop(bmodel, bparams, mesh,
                                    decode["short"], decode["tokens"],
                                    decode["steps"])
    # the sequence-sharded decode against the same decode on one rank
    out["big_tp"] = _decode_loop(bmodel, bparams, mesh, decode["long"],
                                 decode["tokens"], decode["steps"])
    out["big_one"] = _decode_loop(bmodel, bfull, _mesh((1, 1)),
                                  decode["long"], decode["tokens"],
                                  decode["steps"])
    out["engine"] = _engine_pair(model, full, engine_kw)
    return out


def _decode_loop(model, params, mesh, cache: int, tokens: np.ndarray,
                 steps: int) -> list:
    """Whole-vocabulary logits of ``steps`` decode steps from ``tokens``
    (fed back greedily) against an fp32 cache of ``cache`` slots."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import serve_step

    shape = ShapeConfig("serve", cache, tokens.shape[0], "decode")
    step = serve_step.build_decode_step(model, shape, device="cpu",
                                        mesh=mesh)
    state = serve_step.init_decode_state(model, shape, mesh,
                                         cache_dtype=torch.float32,
                                         device="cpu")
    tok = torch.from_numpy(tokens)
    logits = []
    for pos in range(steps):
        local, state = step(params, tok, state, pos)
        full = serve_step.gather_vocab(step.ctx, local)
        logits.append(full.numpy())
        tok = full.argmax(-1).to(torch.int32)
    return logits


def _engine_pair(model, params, engine_kw: dict) -> dict:
    """The paged engine at R = 1 (no collective) and at R = 2 over the
    (1, 2) mesh on the same trace: every step's logits of each, the
    collectives and bytes the R = 2 engine recorded a step, and the
    flash-decode calls a step on this rank."""
    import torch

    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.serve import (PagedDecodeEngine, ServeScheduler,
                                   mixed_trace, plan_kv_arena)
    from repro_torch.serve.engine import (predicted_collectives_per_token,
                                          predicted_wire_bytes_per_token)

    trace_kw, plan_kw = engine_kw["trace"], engine_kw["plan"]
    out = {}
    real = fd_ops.flash_decode_stats
    for r in (1, 2):
        calls = []

        def spy(*a, **kw):
            calls.append(1)
            return real(*a, **kw)

        fd_ops.flash_decode_stats = spy
        try:
            plan = plan_kv_arena(model.cfg, model_parallel=r, **plan_kw)
            eng = PagedDecodeEngine(model, plan, device="cpu",
                                    mesh=_mesh((1, r)))
        finally:
            fd_ops.flash_decode_stats = real
        logits = []
        decode = eng.decode

        def record(params_, token, _decode=decode):
            if eng.comm is not None:
                eng.comm.record.reset()
            calls.clear()
            lg = _decode(params_, token)
            logits.append(lg.numpy().copy())
            steps.append({"calls": len(calls),
                          "record": (eng.comm.record.as_dict()
                                     if eng.comm is not None else None)})
            return lg

        steps: list = []
        eng.decode = record
        res = ServeScheduler(eng, "continuous").run(params,
                                                    mixed_trace(**trace_kw))
        out[r] = {"logits": logits, "steps": steps,
                  "generated": res["generated_tokens"],
                  "predicted_collectives":
                      predicted_collectives_per_token(plan),
                  "predicted_bytes": predicted_wire_bytes_per_token(
                      plan, model.cfg, plan.max_seqs),
                  "plan": (plan.n_layers, plan.max_seqs, plan.head_dim,
                           plan.blocks_per_rank, plan.max_blocks)}
    return out


def seq_sharded_job(rank: int, world: int, batch: int, cache: int,
                    steps: int) -> tuple:
    """A reduced llama with 16 real query heads (so that rank 1 of the
    (1, 2) mesh holds real ones), decoded ``steps`` positions against a
    ``cache``-slot fp32 cache sequence-sharded over the model axis (each
    rank ``cache // 2`` slots), and the same decode unsharded on this rank
    alone: both as whole-vocabulary logits a step."""
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime import serve_step

    cfg = reduced_config(ARCH)
    model = build_model(cfg.with_(attn=dataclasses.replace(
        cfg.attn, num_heads=16, num_kv_heads=4)))
    full = model.init(torch.Generator().manual_seed(2), "cpu")
    shape = ShapeConfig("serve", cache, batch, "decode")
    tok0 = torch.arange(batch, dtype=torch.int32) * 7
    out = []
    for mesh, params in ((_mesh((1, 2)),
                          serve_step.resident_params(model, full,
                                                     _mesh((1, 2)))),
                         (_mesh((1, 1)), full)):
        step = serve_step.build_decode_step(model, shape, device="cpu",
                                            mesh=mesh)
        state = model.init_decode_state(
            batch, cache // mesh.sizes()["model"], device="cpu")
        state = [{"kv": {k: v.float() for k, v in layer["kv"].items()}}
                 for layer in state]
        tok, logits = tok0, []
        for pos in range(steps):
            local, state = step(params, tok, state, pos)
            full_logits = serve_step.gather_vocab(step.ctx, local)
            logits.append(full_logits.numpy())
            tok = full_logits.argmax(-1).to(torch.int32)
        out.append(np.stack(logits))
    return tuple(out)


# ---------------------------------------------------------------------------
# fsdp on a (data, model) mesh
# ---------------------------------------------------------------------------


def tp_model(kind: str):
    """The reduced configs of the (2, 2) fsdp, gathered and checkpoint
    tests: ``"base"`` (llama3.2-1b: 4 q heads padded to 16, all on model
    rank 0), ``"heads"`` (16 q / 4 kv heads: model rank 1 holds real
    ones) and ``"qwen"`` (qwen2-7b, fsdp by default, qkv biases)."""
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model

    if kind == "qwen":
        return build_model(reduced_config("qwen2-7b"))
    cfg = reduced_config(ARCH)
    if kind == "heads":
        cfg = cfg.with_(attn=dataclasses.replace(cfg.attn, num_heads=16,
                                                 num_kv_heads=4))
    return build_model(cfg)


def tp_fsdp_config(case: dict, step_kw: dict):
    return dataclasses.replace(tp_step_config("fsdp", case["arena"], step_kw),
                      fsdp_gather=case["gather"],
                      fsdp_bucket_bytes=step_kw["fsdp_bucket_bytes"])


def full_params(model, leaves: list):
    """The full parameter tree from the reference's leaves (JAX order)."""
    from repro_torch import bridge
    from repro_torch import tree as tree_util
    from repro_torch.runtime.train_step import abstract_params

    treedef = tree_util.flatten(abstract_params(model))[1]
    return bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")


def fsdp_plan_record(plan) -> dict:
    """An :class:`FsdpPlan`'s groups, bucket sizes, arena segments and
    norm weights (each group's buckets' vectors, concatenated)."""
    import torch

    out = {"groups": sorted(plan.groups),
           "sizes": {n: list(p.bucket_sizes) for n, p in plan.plans.items()},
           "norm_weights": {n: torch.cat(w).numpy()
                            for n, w in plan.norm_weights.items()}}
    if plan.arena_layout is not None:
        out["arena"] = np.array([[s.offset, s.size, s.padded]
                                 for s in plan.arena_layout.segments])
    return out


def tp_fsdp_job(rank: int, world: int, leaves: dict, batch: dict,
                cases: dict, steps: int, step_kw: dict) -> dict:
    """Per case (``{"model", "gather", "arena"}``): fsdp on the (2, 2) mesh
    from the full parameters ``leaves[model]``: the plan, this rank's
    initial shards, the loss and gradient norm of every step, the final
    shards and the records of the model axis and of the communicator."""
    import torch

    from repro_torch import bridge
    from repro_torch.runtime.train_step import (TrainStep,
                                                init_train_state,
                                                shard_batch)

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, case in cases.items():
        model = tp_model(case["model"])
        step = TrainStep(model, _mesh((2, 2)), tp_fsdp_config(case, step_kw),
                         device=torch.device("cpu"))
        state = init_train_state(model, step, params=full_params(
            model, leaves[case["model"]]))
        res = {"plan": fsdp_plan_record(step.fsdp),
               "init": {n: bridge.params_to_numpy(s)
                        for n, s in state["groups"].items()},
               "data_index": step.data_index,
               "model_index": step.ctx.model_index()}
        mine = shard_batch(tb, step.data_index, step.data_world)
        step.comm.record.reset()
        step.model_record.reset()
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, mine)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        res.update(loss=np.array(losses), grad_norm=np.array(norms),
                   groups={n: bridge.params_to_numpy(s)
                           for n, s in state["groups"].items()},
                   model_record=step.model_record.as_dict(),
                   record=step.comm.record.as_dict())
        out[name] = res
    return out


# ---------------------------------------------------------------------------
# gathered-weight serving on a (data, model) mesh
# ---------------------------------------------------------------------------


def tp_gathered_job(rank: int, world: int, leaves: list,
                    serve_kw: dict) -> dict:
    """The 16 q / 4 kv head config on a ``(world // 2, 2)`` mesh: the
    prefill and ``len(decode_tokens)`` decode steps (fp32 caches) with
    gathered weights (this rank's fsdp shards of its model block), and the
    same with resident weights rounded to bf16 as the gathers round them;
    every output as this rank's rows of the whole vocabulary."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.runtime import serve_step

    mesh = _mesh((world // 2, 2))
    model = tp_model("heads")
    full = full_params(model, leaves)
    rounded = tree_util.tree_map(
        lambda t: t.to(torch.bfloat16).to(t.dtype), full)
    b, s, c = serve_kw["batch"], serve_kw["seq"], serve_kw["cache"]
    tokens = torch.from_numpy(serve_kw["tokens"])
    out = {"rows": serve_step._batch_rows(mesh, b)}
    for mode, tree in (("gathered", full), ("resident", rounded)):
        pre = serve_step.build_prefill(
            model, ShapeConfig("t", s, b, "prefill"), weight_mode=mode,
            device="cpu", mesh=mesh)
        params = serve_step.serve_params(pre, model, tree, mesh)
        if mode == "gathered":
            out["groups"] = {n: [x.numpy() for x in v]
                             for n, v in params["groups"].items()}
        out[f"{mode}/prefill"] = serve_step.gather_vocab(
            pre.ctx, pre(params, {"tokens": tokens})).numpy()
        shape = ShapeConfig("t", c, b, "decode")
        dec = serve_step.build_decode_step(model, shape, weight_mode=mode,
                                           device="cpu", mesh=mesh)
        params = serve_step.serve_params(dec, model, tree, mesh)
        state = serve_step.init_decode_state(model, shape, mesh,
                                             cache_dtype=torch.float32,
                                             device="cpu")
        steps = []
        for pos, tok in enumerate(serve_kw["decode_tokens"]):
            logits, state = dec(params, torch.from_numpy(tok), state, pos)
            steps.append(serve_step.gather_vocab(dec.ctx, logits).numpy())
        out[f"{mode}/decode"] = steps
    if world == 2:
        # the serve CLI's contiguous loop at R = 2, a dense arch gathered
        from repro_torch.launch import serve as launch_serve

        args = launch_serve.parser().parse_args(
            ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
             "--cache", "8", "--tokens", "1", "--model-parallel", "2"])
        out["cli"] = {wm: launch_serve.run_contiguous(
            args, "cpu", weight_mode=wm)["logits"].numpy()
            for wm in ("gathered", "resident")}
    return out


def model_axis_builds_job(rank: int, world: int, what: str,
                          ckpt_dir: str | None = None) -> dict:
    """What ROADMAP Queue 1 #6b lifted, built and run once on the (1, 2)
    mesh of the reduced llama3.2-1b: ``"train"``, an fsdp step and a
    Trainer with ``ckpt_dir`` (one step, saved at the end, the leaves'
    layout rules); ``"decode"``, the gathered decode step (one token)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.runtime import serve_step
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                                init_train_state)

    mesh = _mesh((1, 2))
    model = tp_model("base")
    cpu = torch.device("cpu")
    gen = torch.Generator().manual_seed(0)
    if what == "decode":
        shape = ShapeConfig("serve", 8, 2, "decode")
        dec = serve_step.build_decode_step(model, shape,
                                           weight_mode="gathered",
                                           device="cpu", mesh=mesh)
        params = serve_step.serve_params(dec, model, model.init(gen, cpu),
                                         mesh)
        state = serve_step.init_decode_state(model, shape, mesh,
                                             device="cpu")
        logits, _ = dec(params, torch.zeros(2, dtype=torch.int32), state, 0)
        return {"logits": tuple(logits.shape),
                "finite": bool(torch.isfinite(logits).all())}
    step = TrainStep(model, mesh, TrainStepConfig(dp_mode="fsdp"),
                     device=cpu)
    state = init_train_state(model, step, generator=gen)
    batch = {"tokens": torch.zeros(2, 8, dtype=torch.int64),
             "labels": torch.ones(2, 8, dtype=torch.int64)}
    _, metrics = step(state, batch)
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=8, global_batch=2))
    tr = Trainer(model, mesh, TrainStepConfig(), data,
                 TrainerConfig(steps=1, ckpt_dir=ckpt_dir), device=cpu,
                 rank=rank, log=lambda msg: None)
    tr.run()
    rules = sorted({type(r).__name__ if not isinstance(r, str) else r
                    for r in _leaves_of(tr.step_fn.state_layout(tr.state))})
    return {"fsdp_loss": float(metrics["loss"]), "rules": rules}


def _leaves_of(tree) -> list:
    from repro_torch.checkpoint.ckpt import flatten_with_path

    return [leaf for _, leaf in flatten_with_path(tree)[0]]
