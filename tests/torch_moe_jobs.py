"""Per-rank jobs of the MoE tests (torch only; run through
``torch_dist_util.run_ranks``)."""

from __future__ import annotations

import numpy as np

TRANSPORTS = ("a2a", "ring", "ring_hier", "psum")


def _mesh(shape, names=("model",)):
    from repro_torch.core.topology import RankMesh

    return RankMesh(tuple(names), tuple(shape))


def _payload(rank: int, shape, seed: int):
    import torch

    g = torch.Generator().manual_seed(1000 * seed + rank)
    return torch.randn(shape, generator=g)


def _tiled(xs: list, me: int, split: int, concat: int, rails: int = 1):
    """``lax.all_to_all(tiled=True)``'s result on rank ``me`` from every
    rank's ``xs[j]``: block ``me`` of each source, concatenated in source
    order; over ``rails`` the same for each stripe of the last dimension,
    the stripes concatenated (the reference's channelized exchange, which
    is the tiled one where neither axis is the last)."""
    import torch

    p = len(xs)
    stripes = zip(*[torch.chunk(x, rails, dim=-1) for x in xs])
    return torch.cat([torch.cat([torch.chunk(x, p, dim=split)[me]
                                 for x in part], dim=concat)
                      for part in stripes], dim=-1)


# ---------------------------------------------------------------------------
# the Communicator's all-to-all surface (4 ranks on one model axis)
# ---------------------------------------------------------------------------


def a2a_surface_job(rank: int, world: int, cases: list) -> dict:
    """For each transport and channel count (communicators built in one
    order on every rank) and each ``(shape, split, concat)`` case: the
    forward against the tiled semantics from every rank's payload, the
    backward against the inverse exchange of every rank's cotangent (both
    bitwise), the record of one forward + backward, and the ragged
    exchange's counts."""
    import torch

    from repro_torch.comm import CommConfig, Communicator

    mesh = _mesh((world,))
    comms = {(t, c): Communicator(mesh, CommConfig(
        transport=t, data_axes=("model",), channels=c))
        for t in TRANSPORTS for c in (1, 2)}
    out: dict = {}
    for (t, c), comm in comms.items():
        for i, (shape, split, concat) in enumerate(cases):
            xs = [_payload(j, shape, i) for j in range(world)]
            x = xs[rank].clone().requires_grad_(True)
            comm.record.reset()
            y = comm.all_to_all(x, split_axis=split, concat_axis=concat)
            gs = [_payload(j, tuple(y.shape), 100 + i) for j in range(world)]
            (gx,) = torch.autograd.grad(y, x, gs[rank])
            rails = comm.a2a_rails(shape)
            out[(t, c, i)] = {
                "fwd": torch.equal(y.detach(), _tiled(xs, rank, split,
                                                      concat, rails)),
                "bwd": torch.equal(gx, _tiled(gs, rank, concat, split,
                                              rails)),
                "record": comm.record.as_dict(),
                "plan": comm.a2a_plan(shape, torch.float32).describe()}
        counts = torch.arange(world, dtype=torch.int32) + 10 * rank
        x = _payload(rank, (world * 2, 8), 99)
        recv, rc = comm.all_to_all_ragged(x, counts, split_axis=0,
                                          concat_axis=0)
        out[(t, c, "ragged")] = {
            "counts": rc.tolist(),
            "payload": torch.equal(recv, _tiled(
                [_payload(j, (world * 2, 8), 99) for j in range(world)],
                rank, 0, 0))}
    return out


# ---------------------------------------------------------------------------
# expert parallelism against the port's own one-rank MoE (2 ranks)
# ---------------------------------------------------------------------------


def _moe_case(kw: dict, seed: int, d: int):
    import torch

    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.moe import moe_init

    cfg = MoEConfig(**kw)
    g = torch.Generator().manual_seed(seed)
    return cfg, moe_init(g, cfg, d)


def _local_moe(p: dict, cfg, rank: int, r: int) -> dict:
    """This rank's blocks of a full MoE tree: the expert stacks by expert
    under ``ep``, by ffn column (gate/up) and row (down) under ``tp``; the
    router and the shared expert stay whole."""
    out = dict(p)
    if cfg.parallelism == "ep":
        el = cfg.num_experts // r
        for n in ("w_gate", "w_up", "w_down"):
            out[n] = p[n][rank * el:(rank + 1) * el]
    else:
        fl = cfg.expert_ff // r
        for n, dim in (("w_gate", 2), ("w_up", 2), ("w_down", 1)):
            out[n] = p[n].narrow(dim, rank * fl, fl)
    return out


def _moe_loss_grads(p: dict, x, w, cfg, ctx):
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.models.moe import moe_apply

    leaves, treedef = tree_util.flatten(p)
    leaves = [t.detach().clone().requires_grad_(True) for t in leaves]
    xx = x.clone().requires_grad_(True)
    y, aux, drop = moe_apply(treedef.unflatten(leaves), xx, cfg, "silu",
                             ctx=ctx, compute_dtype=torch.float32)
    loss = torch.sum(y * w) + aux
    grads = torch.autograd.grad(loss, leaves + [xx])
    return {"y": y.detach().numpy(), "loss": loss.item(),
            "drop": drop.item(),
            "grads": treedef.unflatten([g.numpy() for g in grads[:-1]]),
            "gx": grads[-1].numpy()}


def ep_job(rank: int, world: int, cases: dict, ref_params: dict,
           ref_inputs: dict) -> dict:
    """Each case ``name: (MoEConfig kwargs, B, S, d, transport)``: the
    two-rank moe_apply (EP or TP in the expert) and the port's one-rank
    moe_apply on the same full tree, loss ``sum(y * w) + aux``, with the
    EP communicator's record of the step.  ``ref_params`` / ``ref_inputs``
    (numpy, the reference's tree and ``x``, ``w``) add case ``"reference"``
    on the ``a2a`` transport."""
    import torch

    from repro_torch import bridge
    from repro_torch.configs.base import MoEConfig
    from repro_torch.models.parallel import SINGLE, make_ctx
    from repro_torch.runtime.train_step import (TrainStepConfig,
                                                build_moe_comm)

    mesh = _mesh((world,))
    # one EP communicator per transport, then the model ring: one order
    comms = {t: build_moe_comm(mesh, TrainStepConfig(moe_transport=t))
             for t in ("a2a", "ring", "psum")}
    ctxs = {t: make_ctx(mesh, moe_comm=comms[t]) for t in comms}
    out: dict = {}
    for name, (kw, b, s, d, transport) in cases.items():
        cfg, full = _moe_case(kw, sorted(cases).index(name), d)
        rs = np.random.RandomState(sorted(cases).index(name))
        x = torch.from_numpy(rs.randn(b, s, d).astype(np.float32))
        w = torch.from_numpy(rs.randn(b, s, d).astype(np.float32))
        one = _moe_loss_grads(full, x, w, cfg, SINGLE)
        comms[transport].record.reset()
        ep = _moe_loss_grads(_local_moe(full, cfg, rank, world), x, w, cfg,
                             ctxs[transport])
        out[name] = {"one": one, "ep": ep,
                     "record": comms[transport].record.as_dict()}
    cfg = MoEConfig(**ref_inputs["kw"])
    full = bridge.params_from_numpy(ref_params, "cpu")
    x, w = (torch.from_numpy(ref_inputs[k]) for k in ("x", "w"))
    out["reference"] = {"ep": _moe_loss_grads(
        _local_moe(full, cfg, rank, world), x, w, cfg, ctxs["a2a"])}
    return out


# ---------------------------------------------------------------------------
# MoE training on a (1, 2) mesh
# ---------------------------------------------------------------------------


def moe_config(case: dict):
    """The reduced arch of a train case, with its experts sharded over the
    model axis when ``case["ep"]`` (mixtral publishes ``tp``)."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config(case["arch"])
    if case.get("ep"):
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, parallelism="ep"))
    return cfg


def moe_train_job(rank: int, world: int, leaves: dict, batch: dict,
                  cases: dict, steps: int, step_kw: dict) -> dict:
    """Per case: a TrainStep of ``case["mode"]`` on the (1, 2) mesh from the
    reference's full parameter leaves, the loss, gradient norm and
    ``moe_drop_fraction`` of every step, and the EP communicator's record
    of the steps."""
    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                                init_train_state,
                                                shard_batch)
    from torch_tp_jobs import full_params

    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = {}
    for name, case in cases.items():
        model = build_model(moe_config(case))
        tcfg = TrainStepConfig(dp_mode=case["mode"],
                               comm=CommConfig(**step_kw["comm"]),
                               moe_transport=step_kw["moe_transport"],
                               moe_channels=step_kw["moe_channels"])
        step = TrainStep(model, _mesh((1, world), ("data", "model")), tcfg,
                         device=torch.device("cpu"))
        state = init_train_state(model, step,
                                 params=full_params(model, leaves[name]))
        mine = shard_batch(tb, step.data_index, step.data_world)
        step.moe_comm.record.reset()
        losses, norms, drops = [], [], []
        for _ in range(steps):
            state, metrics = step(state, mine)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            drops.append(float(metrics["moe_drop_fraction"]))
        out[name] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                     "drop": np.array(drops),
                     "moe_record": step.moe_comm.record.as_dict()}
    return out


# ---------------------------------------------------------------------------
# the paged engine's MoE decode at model_parallel 2
# ---------------------------------------------------------------------------


def paged_moe_job(rank: int, world: int, params: dict, plan_kw: dict,
                  tokens: np.ndarray, live: list) -> dict:
    """The paged engine at ``model_parallel = world`` on the (1, world)
    mesh, the full tree on every rank: each step's logits and the
    communicator's record of the whole run."""
    import torch

    from repro_torch import bridge
    from repro_torch.models import build_model
    from repro_torch.serve import PagedDecodeEngine, plan_kv_arena

    model = build_model(serve_moe_config())
    plan = plan_kv_arena(model.cfg, model_parallel=world,
                         cache_dtype=torch.float32, **plan_kw)
    eng = PagedDecodeEngine(model, plan, device="cpu",
                            mesh=_mesh((1, world), ("data", "model")))
    for s in live:
        eng.admit(s)
    full = bridge.params_from_numpy(params, "cpu")
    logits = [eng.decode(full, tok).numpy() for tok in tokens]
    return {"logits": np.stack(logits), "record": eng.comm.record.as_dict()}


def serve_moe_config():
    """Reduced mixtral with every layer global (``window=None``): the MoE
    config the paged engine can serve (windowed and chunked layers are
    refused by the page table)."""
    import dataclasses

    from repro_torch.configs import reduced_config

    cfg = reduced_config("mixtral-8x7b")
    return cfg.with_(attn=dataclasses.replace(cfg.attn, window=None))
