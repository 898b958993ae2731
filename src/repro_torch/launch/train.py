"""Training entry point: data parallelism over the port's ring.

Port of ``repro.launch.train`` (same flags; ``--layers`` cuts depth,
``--nproc`` spawns that many local ranks).  Rank count and rank come from
``torch.distributed``'s environment (``WORLD_SIZE``, ``RANK``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); ranks take cards
round-robin.  The backend is fixed when the group is created and printed:
NCCL when every rank has a card of its own, gloo with the ring's hops
staged explicitly through pinned host memory otherwise (several ranks on
one card), gloo on the CPU.  ::

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3.2-1b \\
        --reduced --steps 20 --device cpu --nproc 2 --use-arena \\
        --wire-codec int8

The ranks form the reference's host mesh, ``("data", "model")`` with a
model axis of ``--model-parallel`` (2 by default) halved until it divides
the rank count (``launch/mesh.py``): ``--nproc 2`` trains tensor-parallel
on (1, 2), ``--nproc 4`` on (2, 2).  Every ``--dp-mode`` and ``--ckpt-dir``
run on a model axis (fsdp shards each rank's model block over the data
axes; the checkpoint holds global arrays, as the reference's).

It runs on ``cuda`` unless ``--device cpu`` is given.  ``--dp-mode`` is
``replicated``, ``zero1`` (llama3.2-1b's own default at full size) or
``fsdp`` (the full-size default of qwen2-7b and the larger archs);
``--reduced`` defaults to ``replicated``, as in the reference.  The fsdp
gather (``native`` or ``ring``) and its dtype are set on
``TrainStepConfig`` only, as in the reference, whose CLI has no flag for
them.

``--ckpt-dir DIR`` saves the train state every 50 steps and at the end (the
reference's on-disk format; the sharded leaves gathered into global arrays
on rank 0) and resumes from the newest committed step; ``--obs-dir DIR``
instruments rank 0's run (``events.jsonl`` and ``trace.json`` under DIR,
read with ``python -m repro_torch.obs.report DIR``).

``--tuned DB`` resolves the arch's ``"auto"`` comm knobs, and a
``channels=0``, to the tuning DB's measured best config before the launch
(``python -m repro_torch.tune.probe`` writes the DB) and prints a
``tuned:`` line; as in the reference, settings with ``channels=0`` are
resolved against ``experiments/tuning.json`` when it exists even without
the flag.  ``--obs-predict`` prices the step at start (the live step's
roofline; with ``--tuned``, the DB's measured α/bandwidth) and tracks the
measured steps against it: every rank runs the pricing pass, rank 0
records.  ``--production-mesh`` lays the ranks out as the reference's
16 x 16 ``("data", "model")`` mesh, ``--multi-pod`` as 2 x 16 x 16 with a
``"pod"`` axis; a world of any other size than
``launch.mesh.required_devices`` is refused.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import queue as queue_mod
import socket
import time
import traceback
from dataclasses import dataclass

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.comm.registry import list_transports
from repro_torch.comm.schedule import SCHEDULE_POLICIES
from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.core.topology import RankMesh
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.device import resolve_device
from repro_torch.launch.settings import settings_for
from repro_torch.tune import resolve
from repro_torch.models import Model, build_model
from repro_torch.obs import ObsConfig
from repro_torch.optim import OptimConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.launch.mesh import (make_host_mesh,
                                     require_production_world)
from repro_torch.runtime.train_step import (DP_MODES, TrainStepConfig,
                                            require_ported)


@dataclass(frozen=True)
class World:
    """This process's place in the run."""

    rank: int
    size: int
    device: torch.device
    backend: str | None          # None: one rank, no process group


def init_distributed(device: str | torch.device = "cuda") -> World:
    """Joins the world ``torch.distributed``'s environment describes (one
    rank when ``WORLD_SIZE`` is unset) and picks this rank's device and the
    backend, once."""
    dev = resolve_device(device)
    size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", "0"))
    local = int(os.environ.get("LOCAL_RANK", str(rank)))
    if dev.type == "cuda":
        n_cards = torch.cuda.device_count()
        dev = torch.device("cuda", local % n_cards)
        torch.cuda.set_device(dev)
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
        backend = "nccl" if local_size <= n_cards else "gloo"
    else:
        backend = "gloo"
        # ranks sharing a host split its cores rather than each taking all
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", str(size)))
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // local_size))
    if size == 1:
        return World(0, 1, dev, None)
    if not dist.is_initialized():
        dist.init_process_group(
            backend, rank=rank, world_size=size,
            device_id=dev if backend == "nccl" else None)
    if rank == 0:
        print(f"[dist] {size} ranks, backend {backend}"
              + (" (ring hops staged through pinned host memory)"
                 if backend == "gloo" and dev.type == "cuda" else ""),
              flush=True)
    return World(rank, size, dev, backend)


def resolve_dp_mode(args) -> str:
    """The reference CLI's rule: ``--dp-mode``, else the arch's setting at
    full size, else ``replicated``."""
    st = settings_for(args.arch)
    mode = args.dp_mode or (st.dp_mode if not args.reduced else "replicated")
    require_ported(mode)
    return mode


@dataclass
class TrainRun:
    model: Model
    trainer: Trainer
    world: World


def setup(args, world: World, *,
          step_overrides: dict | None = None,
          model_overrides: dict | None = None) -> TrainRun:
    """The model (random weights from ``--seed``), data, step config and
    trainer of one rank.  ``step_overrides`` replaces fields of the step
    config that the reference's CLI has no flag for either (e.g.
    ``fsdp_gather``), ``model_overrides`` fields of the model config (e.g.
    a MoE config whose experts shard over the model axis)."""
    dp_mode = resolve_dp_mode(args)
    mesh = launch_mesh(args, world.size)
    log = print if world.rank == 0 else (lambda msg: None)
    st = tuned_settings(args, mesh, log)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if args.layers is not None:
        cfg = cfg.with_(num_layers=args.layers)
    if model_overrides:
        cfg = cfg.with_(**model_overrides)
    model = build_model(cfg)
    ccfg = st.comm_config(bucket_bytes=32 * 2**20)
    if args.transport:
        ccfg = dataclasses.replace(ccfg, transport=args.transport)
    if args.channels is not None:
        ccfg = dataclasses.replace(ccfg, channels=args.channels)
    if args.page_bytes is not None:
        ccfg = dataclasses.replace(ccfg, page_bytes=args.page_bytes)
    schedule = "wsd" if args.arch == "minicpm-2b" else "cosine"
    step_cfg = TrainStepConfig(
        dp_mode=dp_mode, comm=ccfg,
        optim=OptimConfig(base_lr=args.lr, warmup=min(20, args.steps // 5),
                          schedule=schedule, total_steps=args.steps),
        microbatches=1 if args.reduced else st.microbatches,
        schedule=args.accum_policy or "accumulate_then_reduce",
        use_arena=args.use_arena, wire_codec=args.wire_codec,
        moe_transport=st.moe_transport, moe_channels=st.moe_channels)
    if step_overrides:
        step_cfg = dataclasses.replace(step_cfg, **step_overrides)
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch),
                           model_cfg=cfg)
    # one run directory: rank 0 instruments the run; a computed prediction
    # is collective, so every rank asks for it
    obs_cfg = None
    run_dir = args.obs_dir if world.rank == 0 else None
    if args.obs_predict:
        obs_cfg = ObsConfig(run_dir=run_dir, predict=True,
                            tuned_db=args.tuned)
    elif run_dir:
        obs_cfg = ObsConfig(run_dir=run_dir)
    trainer = Trainer(model, mesh, step_cfg, data,
                      TrainerConfig(steps=args.steps, ckpt_every=50,
                                    ckpt_dir=args.ckpt_dir, log_every=10,
                                    seed=args.seed, obs=obs_cfg),
                      device=world.device, rank=world.rank, log=log)
    log(f"arch={args.arch} layers={cfg.num_layers} "
        f"params={model.param_count() / 1e6:.1f}M world={world.size} "
        f"mesh={mesh.sizes()} "
        f"device={world.device} dp_mode={dp_mode} "
        f"transport={ccfg.transport} channels={ccfg.channels} "
        f"arena={args.use_arena} wire_codec={args.wire_codec}"
        + (f" fsdp_gather={step_cfg.fsdp_gather}" if dp_mode == "fsdp"
           else ""))
    return TrainRun(model, trainer, world)


def launch_mesh(args, world: int) -> RankMesh:
    """The production mesh under ``--production-mesh`` (refused unless the
    world fills it), else the host mesh of ``--model-parallel``."""
    if args.production_mesh:
        return require_production_world(world, args.multi_pod)
    return make_host_mesh(world, args.model_parallel)


def tuned_settings(args, mesh: RankMesh, log=print):
    """The arch's settings, their ``"auto"`` knobs (and ``channels=0``)
    resolved from ``--tuned`` (or ``experiments/tuning.json``) as the
    reference's CLI does; logs the ``tuned:`` line when a record won."""
    st = settings_for(args.arch)
    if args.tuned or resolve.has_auto(st):
        label = "x".join(str(d) for d in mesh.shape)
        st, info = resolve.resolve_settings(st, args.arch, mesh_label=label,
                                            db_path=args.tuned)
        if info["source"] == "db":
            log(f"tuned: {info['key']} "
                f"(alpha={info['alpha_s']*1e6:.2f}us "
                f"bw={info['bandwidth']/1e9:.2f}GB/s) -> "
                f"transport={st.transport} channels={st.channels} "
                f"page_bytes={st.page_bytes}")
    return st


def run(args) -> dict:
    """One rank's training run; returns the trainer's history, wall,
    straggler events and obs paths."""
    world = init_distributed(args.device)
    try:
        out = setup(args, world).trainer.run()
        if out["obs"]["events"]:
            print(f"obs: events={out['obs']['events']} "
                  f"trace={out['obs']['trace']}")
        return out
    finally:
        if world.backend is not None:
            dist.destroy_process_group()


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_entry(rank: int, nproc: int, port: int, queue, fn, fn_args):
    os.environ.update(WORLD_SIZE=str(nproc), RANK=str(rank),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nproc),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    try:
        queue.put((rank, "ok", fn(*fn_args)))
    except BaseException:               # the parent reports it and raises
        queue.put((rank, "error", traceback.format_exc()))
        raise


def spawn(fn, nproc: int, *fn_args, timeout: float = 1800.0) -> list:
    """Runs ``fn(*fn_args)`` on ``nproc`` local ranks (fresh ``spawn``
    processes with the ``torch.distributed`` environment set); returns the
    per-rank results in rank order.  Raises if any rank fails, dies without
    a result or outlives ``timeout`` seconds; every rank is stopped before
    this returns."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_entry,
                         args=(r, nproc, port, queue, fn, fn_args))
             for r in range(nproc)]
    for p in procs:
        p.start()
    results: dict[int, object] = {}
    error = None
    deadline = time.monotonic() + timeout
    try:
        while len(results) < nproc and error is None:   # drain, then join
            try:
                rank, status, value = queue.get(timeout=5)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0) and r not in results]
                if dead:
                    error = (f"rank {dead[0]} died (exit "
                             f"{procs[dead[0]].exitcode})")
                elif time.monotonic() > deadline:
                    error = f"ranks still running after {timeout} s"
                continue
            if status == "ok":
                results[rank] = value
            else:
                error = f"rank {rank} failed:\n{value}"
    finally:
        for p in procs:
            p.join(timeout=60 if error is None else 10)
            if p.is_alive():
                p.kill()
                p.join()
    if error is not None:
        raise RuntimeError(error)
    return [results[r] for r in range(nproc)]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true",
                    help="smoke-scale config")
    ap.add_argument("--layers", type=int, default=None,
                    help="cut the depth to this many layers (widths stay)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the ranks)")
    ap.add_argument("--transport", default=None, choices=list_transports(),
                    help="comm transport (default: the arch's setting)")
    ap.add_argument("--channels", type=int, default=None,
                    help="virtual comm rails (0 = unconstrained)")
    ap.add_argument("--dp-mode", default=None, choices=DP_MODES)
    ap.add_argument("--accum-policy", default=None, choices=SCHEDULE_POLICIES,
                    help="gradient-reduction issue schedule (default: "
                         "accumulate_then_reduce)")
    ap.add_argument("--use-arena", action="store_true",
                    help="reduce out of the page-aligned CommArena (fused "
                         "spans, one buffer allocated once)")
    ap.add_argument("--page-bytes", type=int, default=None,
                    help="arena page size (default 2 MiB)")
    ap.add_argument("--wire-codec", default=None, choices=["int8"],
                    help="quantize the gradient wire (int8 payload + "
                         "per-block scales; with --use-arena the fused "
                         "pack+quantize arena and error feedback)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="instrument the run: JSONL event stream + Chrome "
                         "trace under DIR (read with "
                         "python -m repro_torch.obs.report DIR)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    ap.add_argument("--model-parallel", type=int, default=2,
                    help="model axis of the (data, model) host mesh, halved "
                         "until it divides the rank count (1: data-only)")
    ap.add_argument("--nproc", type=int, default=None,
                    help="spawn this many local ranks (else one rank, or "
                         "the world of torch.distributed's environment)")
    ap.add_argument("--tuned", default=None, metavar="DB",
                    help="tuning DB (repro_torch.tune.probe output): resolve "
                         "the arch's 'auto' comm knobs, and any channels=0, "
                         "to the DB's measured best config before launch")
    ap.add_argument("--obs-predict", action="store_true",
                    help="price the step at start (roofline; with --tuned, "
                         "the DB's measured alpha/beta) and track live "
                         "predicted-vs-measured drift")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the 16x16 (data, model) mesh (needs 256 ranks)")
    ap.add_argument("--multi-pod", action="store_true",
                    help="with --production-mesh: 2x16x16 (pod, data, "
                         "model), 512 ranks")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    resolve_dp_mode(args)                  # refuse before spawning anything
    if args.multi_pod and not args.production_mesh:
        raise SystemExit("--multi-pod needs --production-mesh")
    if args.production_mesh:
        require_production_world(
            args.nproc or int(os.environ.get("WORLD_SIZE", "1")),
            args.multi_pod)
    if args.nproc:
        spawn(run, args.nproc, args)
    else:
        run(args)


if __name__ == "__main__":
    main()
