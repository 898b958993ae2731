"""Per-rank jobs of the tooling slice's tests
(``tests/test_torch_tune_probe.py``, ``tests/test_torch_predict.py``), run
on gloo CPU ranks by ``torch_dist_util.run_ranks``.  They import torch and
the port only."""

from __future__ import annotations

import torch

from repro_torch import tree as tree_util

# the probe at tiny sizes: every bench, both transports, one and two rails
PROBE_MATRIX = dict(benches=("allreduce", "arena", "halo", "cg"),
                    transports=("ring_hier", "psum"), channels=(1, 2),
                    pages=(4096, 8192), sizes=(1 << 10, 1 << 12, 1 << 14),
                    mesh=(2,), warmup=1, iters=2, cg_iters=4)


def probe_job(rank: int, world: int) -> dict:
    from repro_torch.tune.probe import probe_config, probe_rank

    return probe_rank(probe_config(**PROBE_MATRIX), "cpu")


def _state_bytes(state: dict, params) -> list:
    """Every tensor of the train state (and each parameter's ``.grad``),
    as bytes, in tree order."""
    out = [t.detach().cpu().numpy().tobytes() if isinstance(t, torch.Tensor)
           else repr(t) for t in tree_util.leaves(state)]
    out += [repr(p.grad) for p in tree_util.leaves(params)
            if isinstance(p, torch.Tensor)]
    return out


def predict_job(rank: int, world: int, cases: list) -> list:
    """For each ``(argv, model_parallel)`` case: the train CLI's setup on
    this rank, the prediction's counts (the train state, the RNG and the
    records before and after it), then two steps, each step's wire beside
    the prediction's."""
    from repro_torch.launch import train as launch_train
    from repro_torch.obs import predict
    from repro_torch.runtime.train_step import shard_batch

    out = []
    for argv in cases:
        args = launch_train.parser().parse_args(argv)
        w = launch_train.World(rank, world, torch.device("cpu"), "gloo")
        run = launch_train.setup(args, w)
        tr = run.trainer
        step = tr.step_fn
        params = tr.state.get("params", tr.state.get("groups"))
        before = _state_bytes(tr.state, params)
        rng = torch.get_rng_state().numpy().tobytes()
        recs = predict.record_snapshot(step)
        batch = shard_batch(tr.data.batch_at(0), step.data_index,
                            step.data_world)
        pred = predict.predict_step_time(
            step, (tr.state, batch),
            overlap_fraction=step.schedule.overlap_fraction)
        unchanged = (_state_bytes(tr.state, params) == before
                     and torch.get_rng_state().numpy().tobytes() == rng
                     and predict.record_snapshot(step) == recs)
        wire = []
        for s in range(2):
            snap = predict.record_snapshot(step)
            b = shard_batch(tr.data.batch_at(s), step.data_index,
                            step.data_world)
            tr.state, _ = step(tr.state, b)
            wire.append(predict.step_wire(step, snap))
        out.append({"mesh": step.mesh.shape, "pred": pred,
                    "unchanged": unchanged, "wire": wire,
                    "dp_mode": step.cfg.dp_mode,
                    "arena": step.arena is not None})
    return out
