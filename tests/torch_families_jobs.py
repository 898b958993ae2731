"""Per-rank jobs of the remaining families' model-axis tests (torch only;
run through ``torch_dist_util.run_ranks``)."""

from __future__ import annotations

import numpy as np


def _mesh(shape):
    from repro_torch.core.topology import RankMesh

    return RankMesh(("data", "model"), tuple(shape))


def _full(model, leaves: list):
    """The full parameter tree from the reference's leaves (JAX order)."""
    from repro_torch import bridge
    from repro_torch import tree as tree_util

    treedef = tree_util.flatten(model.abstract_params())[1]
    return bridge.params_from_numpy(treedef.unflatten(leaves), "cpu")


def families_tp_job(rank: int, world: int, leaves: dict, batches: dict,
                    cases: dict, steps: int, step_kw: dict,
                    serve: dict) -> dict:
    """Per training case (``{"arch", "mode", "arena", "microbatches"}``):
    a TrainStep on the (1, world) mesh from the reference's full leaves of
    the arch, the loss and gradient norm of every step and, outside fsdp,
    the final local parameters.  Then serving on the same mesh (``serve``): the arch's
    prefill logits on the kernel route and the logits of a few contiguous
    decode steps, the vocab shards gathered."""
    import torch

    from repro_torch import bridge
    from repro_torch.comm import CommConfig
    from repro_torch.configs import reduced_config
    from repro_torch.models import build_model
    from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                                init_train_state,
                                                shard_batch)

    mesh = _mesh((1, world))
    out: dict = {}
    for name, case in cases.items():
        model = build_model(reduced_config(case["arch"]))
        tcfg = TrainStepConfig(dp_mode=case["mode"],
                               comm=CommConfig(**step_kw["comm"]),
                               microbatches=case["microbatches"],
                               use_arena=case["arena"])
        step = TrainStep(model, mesh, tcfg, device=torch.device("cpu"))
        state = init_train_state(model, step, params=_full(
            model, leaves[case["arch"]]))
        batch = {k: torch.from_numpy(v)
                 for k, v in batches[case["arch"]].items()}
        mine = shard_batch(batch, step.data_index, step.data_world)
        losses, norms = [], []
        for _ in range(steps):
            state, metrics = step(state, mine)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
        out[name] = {"loss": np.array(losses), "grad_norm": np.array(norms),
                     "model_index": step.ctx.model_index()}
        if case["mode"] != "fsdp":
            out[name]["params"] = bridge.params_to_numpy(state["params"])
    for arch, job in serve.items():
        out[f"serve/{arch}"] = _serve_case(arch, leaves[arch], job, mesh)
    return out


def _serve_case(arch: str, leaves: list, job: dict, mesh) -> dict:
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill, gather_vocab,
                                                init_decode_state,
                                                resident_params)

    model = build_model(reduced_config(arch))
    params = resident_params(model, _full(model, leaves), mesh)
    batch = job["batch"]
    b, s = batch["tokens"].shape
    res: dict = {}
    if "prefill" in job:
        prefill = build_prefill(model, ShapeConfig("p", s, b, "prefill"),
                                device="cpu", mesh=mesh)
        res["prefill"] = gather_vocab(prefill.ctx, prefill(
            params, batch)).numpy()
    shape = ShapeConfig("serve", job["cache"], b, "decode")
    step = build_decode_step(model, shape, device="cpu", mesh=mesh)
    state = init_decode_state(model, shape, mesh, params=params,
                              frames=batch.get("frames"), ctx=step.ctx,
                              cache_dtype=torch.float32, device="cpu")
    logits = []
    for pos, tok in enumerate(job["tokens"]):
        got, state = step(params, torch.from_numpy(tok), state, pos)
        logits.append(gather_vocab(step.ctx, got).numpy())
    res["decode"] = np.stack(logits)
    return res
