"""Per-rank jobs of the port's two-rank checkpoint tests (run by
``torch_dist_util.run_ranks``).  Torch only: the spawned ranks never
import JAX.  Each job takes ``(rank, world, ...)`` and returns numpy
values."""

from __future__ import annotations

import os
import shutil

import numpy as np

# zero1 over the int8 wire with the int8 arena (its "ef"), and fsdp with the
# fp32 arena: every kind of rank-sharded leaf the train states hold
CASES = {"zero1_int8": dict(dp_mode="zero1", wire_codec="int8"),
         "fsdp": dict(dp_mode="fsdp", wire_codec=None)}
SAVE_AT = 2
STEP_KW = {"comm": dict(transport="ring_hier", chunks=2, channels=2,
                        bucket_bytes=64 * 1024, page_bytes=8192),
           "optim": dict(base_lr=1e-2, warmup=1, total_steps=SAVE_AT + 2),
           "microbatches": 2, "schedule": "scheduled",
           "fsdp_bucket_bytes": 64 * 1024, "seq": 32, "batch": 4}


def step_config(case: dict, kw: dict = STEP_KW):
    from repro_torch.comm import CommConfig
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    return TrainStepConfig(
        dp_mode=case["dp_mode"], comm=CommConfig(**kw["comm"]),
        optim=OptimConfig(**kw["optim"]), use_arena=True,
        microbatches=kw["microbatches"], schedule=kw["schedule"],
        wire_codec=case["wire_codec"],
        fsdp_bucket_bytes=kw["fsdp_bucket_bytes"])


def _trainer(rank: int, world: int, case: dict, ckpt_dir, steps: int,
             mesh=None):
    import torch

    from repro_torch.configs import reduced_config
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import data_mesh

    model = build_model(reduced_config("llama3.2-1b"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=STEP_KW["seq"],
                                      global_batch=STEP_KW["batch"]))
    return Trainer(model, mesh or data_mesh(world), step_config(case), data,
                   TrainerConfig(steps=steps, ckpt_every=100,
                                 ckpt_dir=ckpt_dir, seed=0),
                   device=torch.device("cpu"), rank=rank,
                   log=lambda msg: None)


def bits(a) -> np.ndarray:
    """The bytes of an array, for bitwise comparisons (0-d included)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def local_leaves(trainer) -> dict:
    """``{path: (layout rule, this rank's leaf as numpy)}``."""
    from repro_torch.checkpoint.ckpt import flatten_with_path

    flat, _ = flatten_with_path(trainer.state)
    rules = flatten_with_path(trainer.step_fn.state_layout(trainer.state))[0]
    return {path: (rule, leaf.numpy().copy() if hasattr(leaf, "numpy")
                   else np.asarray(leaf, np.int32))
            for (path, leaf), (_, rule) in zip(flat, rules)}


def restore_job(rank: int, world: int, dirs: dict) -> dict:
    """Per case: a Trainer resumes from the reference's checkpoint in
    ``dirs[case]``; its start step, this rank's restored leaves and the
    loss of the step it then takes."""
    out = {}
    for name, case in CASES.items():
        tr = _trainer(rank, world, case, dirs[name], SAVE_AT + 1)
        start = tr.start_step
        leaves = local_leaves(tr)
        hist = tr.run()["history"]
        out[name] = {"start": start, "leaves": leaves,
                     "loss": hist[0]["loss"], "steps": len(hist)}
    return out


def save_job(rank: int, world: int, dirs: dict) -> dict:
    """Per case: an unbroken run of ``SAVE_AT + 2`` steps; a run stopped at
    ``SAVE_AT`` that checkpoints into ``dirs[case]/port`` (rank 0 then
    copies the directory to ``dirs[case]/for_ref``, what the reference
    resumes from); and a fresh Trainer that resumes from ``port`` and runs
    to the end.  Returns this rank's saved leaves, both runs' losses, and
    whether the resumed run's final state is the unbroken run's bitwise.
    The gather to rank 0 runs in messages of 4 KiB here, so that every
    sharded leaf takes many."""
    import torch.distributed as dist

    from repro_torch.checkpoint import ckpt

    ckpt._GATHER_CHUNK = 4096
    out = {}
    for name, case in CASES.items():
        full = _trainer(rank, world, case, None, SAVE_AT + 2)
        full_hist = full.run()["history"]
        port_dir = os.path.join(dirs[name], "port")
        stopped = _trainer(rank, world, case, port_dir, SAVE_AT + 2)
        stopped.tcfg.steps = SAVE_AT                # the run dies here
        stopped.run()
        saved = local_leaves(stopped)
        dist.barrier()
        if rank == 0:
            shutil.copytree(port_dir, os.path.join(dirs[name], "for_ref"))
        dist.barrier()
        resumed = _trainer(rank, world, case, port_dir, SAVE_AT + 2)
        start = resumed.start_step
        hist = resumed.run()["history"]
        got, want = local_leaves(resumed), local_leaves(full)
        same = (got.keys() == want.keys() and all(
            got[k][1].dtype == want[k][1].dtype
            and np.array_equal(bits(got[k][1]), bits(want[k][1]))
            for k in got))
        out[name] = {"saved": saved, "start": start,
                     "full_losses": [h["loss"] for h in full_hist],
                     "resumed_losses": [h["loss"] for h in hist],
                     "final_bitwise": same}
    return out


# ---------------------------------------------------------------------------
# a (data, model) mesh of four ranks
# ---------------------------------------------------------------------------

# zero1 and fsdp with the fp32 arena on the (2, 2) mesh: the flat leaves and
# the model-sharded parameters (zero1) or the groups (fsdp)
TP_CASES = {"zero1": dict(dp_mode="zero1", wire_codec=None),
            "fsdp": dict(dp_mode="fsdp", wire_codec=None)}


def wait_for(path: str, failed: str, timeout: float = 300.0) -> None:
    """Waits until the file ``path`` exists; raises if ``failed`` appears
    first or ``timeout`` seconds pass."""
    import time

    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if os.path.exists(failed):
            raise RuntimeError(f"the other side failed ({failed})")
        if time.monotonic() > deadline:
            raise TimeoutError(f"{path} did not appear in {timeout} s")
        time.sleep(0.1)


def tp_ckpt_job(rank: int, world: int, dirs: dict, marks: dict) -> dict:
    """Per case of :data:`TP_CASES` on the (2, 2) mesh: an unbroken run of
    ``SAVE_AT + 2`` steps; a run stopped at ``SAVE_AT`` that checkpoints
    into ``dirs[case]["port"]`` (rank 0 copies it to ``"for_ref"``, what
    the reference resumes from); a fresh Trainer resuming from ``"port"``.
    Then (after ``marks["port"]`` is written and the reference's
    ``marks["ref"]`` appears) a Trainer resuming from the reference's
    ``"ref"`` directory, whose restored state is saved again into
    ``"resave"`` and which runs to the end.  Returns the losses, the
    resumes' start steps, this rank's saved leaves and whether the port's
    resumed final state is the unbroken run's bitwise."""
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.core.topology import RankMesh

    mesh = RankMesh(("data", "model"), (2, 2))
    out = {}
    try:
        for name, case in TP_CASES.items():
            d = dirs[name]
            full = _trainer(rank, world, case, None, SAVE_AT + 2, mesh)
            full_hist = full.run()["history"]
            stopped = _trainer(rank, world, case, d["port"], SAVE_AT + 2,
                               mesh)
            stopped.tcfg.steps = SAVE_AT            # the run dies here
            stopped.run()
            saved = local_leaves(stopped)
            dist.barrier()
            if rank == 0:
                shutil.copytree(d["port"], d["for_ref"])
            dist.barrier()
            resumed = _trainer(rank, world, case, d["port"], SAVE_AT + 2,
                               mesh)
            start = resumed.start_step
            hist = resumed.run()["history"]
            got, want = local_leaves(resumed), local_leaves(full)
            same = (got.keys() == want.keys() and all(
                got[k][1].dtype == want[k][1].dtype
                and np.array_equal(bits(got[k][1]), bits(want[k][1]))
                for k in got))
            out[name] = {"saved": saved, "start": start,
                         "full_losses": [h["loss"] for h in full_hist],
                         "resumed_losses": [h["loss"] for h in hist],
                         "final_bitwise": same}
        dist.barrier()
    except BaseException:
        with open(marks["port_failed"], "w") as f:
            f.write("failed\n")
        raise
    if rank == 0:
        with open(marks["port"], "w") as f:
            f.write("ok\n")
    wait_for(marks["ref"], marks["ref_failed"])
    for name, case in TP_CASES.items():
        d = dirs[name]
        tr = _trainer(rank, world, case, d["ref"], SAVE_AT + 2, mesh)
        start = tr.start_step
        mgr = CheckpointManager(d["resave"], async_save=False,
                                ranks=tr.step_fn.ranks)
        mgr.save(tr.state, SAVE_AT, layout=tr.step_fn.state_layout(tr.state))
        mgr.wait()
        hist = tr.run()["history"]
        out[name]["from_ref"] = {"start": start,
                                 "losses": [h["loss"] for h in hist]}
    return out
