"""Serving entry point on one GPU, with weights drawn from a seeded
generator.  Port of ``repro.launch.serve``'s two paths:

* default: the contiguous-cache decode loop over ``build_decode_step``,
  from position 0 with token 0 and greedy argmax, printing tokens/s::

      PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
          --batch 4 --cache 512 --tokens 16

* ``--paged``: the ``repro_torch.serve`` stack (page arena, scheduler, CUDA
  flash-decode attention) over a mixed-length synthetic trace;
  ``--policy both`` runs the continuous-vs-static A/B::

      PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \\
          --paged --policy both

It runs on ``cuda`` unless ``--device cpu`` is given.  ``--model-parallel
R`` spawns R local ranks on a ``(1, R)`` ``("data", "model")`` mesh (gloo
on the CPU or for ranks sharing one card): with ``--paged`` each rank
scores its slice of the page-table columns and the ranks merge the softmax
statistics (page-parallel decode, weights replicated); the contiguous loop
runs tensor-parallel (weights model-sharded, caches of 8192 slots or more
sequence-sharded, the vocab shards gathered for the argmax), with each
rank's block resident or, where the arch's setting says ``gathered``, as
fsdp shards gathered at every step.  Rank 0
prints.  ``--production-mesh`` runs the contiguous loop on the
reference's 16 x 16 ``("data", "model")`` mesh, in a world of
``launch.mesh.required_devices(False)`` = 256 ranks launched through
``torch.distributed``'s environment (``WORLD_SIZE``, ``RANK``, ...); a
world of any other size is refused, as is ``--paged`` with it (the
reference serves the paged engine on its host mesh only).  With
``--paged``, ``--obs-dir DIR`` instruments rank 0's engine and scheduler
(``events.jsonl`` and ``trace.json`` under DIR, read with ``python -m
repro_torch.obs.report DIR``).
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass

import torch

from repro_torch.configs import get_config, list_archs, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.topology import RankMesh
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import (make_production_mesh,
                                     require_production_world)
from repro_torch.launch.settings import settings_for
from repro_torch.models import Model, build_model
from repro_torch.obs import ObsConfig, make_obs
from repro_torch.runtime.serve_step import (build_decode_step, gather_vocab,
                                            init_decode_state, serve_params)
from repro_torch.serve.engine import (PagedDecodeEngine,
                                      predicted_collectives_per_token,
                                      predicted_wire_bytes_per_token)
from repro_torch.serve.kv import KVArenaPlan, plan_kv_arena
from repro_torch.serve.scheduler import Request, ServeScheduler, mixed_trace


@dataclass
class PagedServe:
    """Everything one paged serving run is made of."""

    model: Model
    plan: KVArenaPlan
    engine: PagedDecodeEngine
    params: dict
    trace: list[Request]


def serve_mesh(model_parallel: int) -> RankMesh:
    """The ``(1, R)`` ``("data", "model")`` mesh of ``--model-parallel``."""
    return RankMesh(("data", "model"), (1, model_parallel))


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def _log(msg: str) -> None:
    if _rank() == 0:
        print(msg, flush=True)


def setup_paged(args, device=None) -> PagedServe:
    """Builds the model, its random weights (``--seed``), the KV arena plan,
    the engine (on the ``(1, --model-parallel)`` mesh) and the request
    trace; ``device`` overrides ``--device`` (a spawned rank's card)."""
    dev = resolve_device(device if device is not None else args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    model = build_model(cfg)
    longest = args.prompt_len + max(args.long_len, args.short_len)
    plan = plan_kv_arena(model.cfg, model_parallel=args.model_parallel,
                         page_tokens=args.page_tokens,
                         max_seqs=args.slots, max_seq_len=longest)
    obs = make_obs(ObsConfig(run_dir=args.obs_dir)
                   if args.obs_dir and _rank() == 0 else None)
    engine = PagedDecodeEngine(model, plan, attn_impl=args.attn_impl,
                               device=dev, obs=obs,
                               mesh=serve_mesh(args.model_parallel))
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = model.init(gen, dev)
    trace = mixed_trace(groups=args.groups, slots=args.slots,
                        long_len=args.long_len, short_len=args.short_len,
                        prompt_len=args.prompt_len)
    _log(f"{args.arch}: paged serve on {dev}, {len(trace)} requests, "
         f"{plan.n_kv_pages} KV pages ({plan.total_bytes} B arena), "
         f"page_tokens={plan.page_tokens}, R={plan.model_parallel} "
         f"({predicted_collectives_per_token(plan)} collectives/token, "
         f"{predicted_wire_bytes_per_token(plan, model.cfg, plan.max_seqs):.0f}"
         f" wire B/token)")
    return PagedServe(model, plan, engine, params, trace)


def serve_policies(run: PagedServe, policies: list[str]) -> dict:
    """Serves the whole trace under each policy; returns the scheduler's
    statistics per policy plus the wall time (device work included) and
    generated tokens per second."""
    results = {}
    for policy in policies:
        sched = ServeScheduler(run.engine, policy)
        t0 = time.perf_counter()
        res = sched.run(run.params, list(run.trace))
        if run.engine.device.type == "cuda":
            torch.cuda.synchronize(run.engine.device)
        res["wall_s"] = time.perf_counter() - t0
        res["tokens_per_s"] = res["generated_tokens"] / res["wall_s"]
        results[policy] = res
        _log(f"  {policy:10s}: {res['steps']} steps, "
             f"{res['generated_tokens']} tokens, "
             f"{res['tokens_per_step']:.3f} tok/step, "
             f"{res['tokens_per_s']:.1f} tok/s, "
             f"mean live slots {res['mean_live_slots']:.2f}")
    if len(results) == 2:
        ratio = (results["continuous"]["tokens_per_step"]
                 / results["static"]["tokens_per_step"])
        _log(f"  continuous / static throughput: {ratio:.2f}x")
    return results


def run_paged(args, device=None) -> dict:
    policies = (["continuous", "static"] if args.policy == "both"
                else [args.policy])
    run = setup_paged(args, device)
    results = serve_policies(run, policies)
    paths = run.engine.obs.finish()
    if paths.get("events"):
        _log(f"  obs: events={paths['events']} trace={paths['trace']}")
    return results


def run_contiguous(args, device=None, weight_mode: str | None = None
                   ) -> dict:
    """Decodes ``--tokens`` tokens for ``--batch`` sequences against
    ``--cache``-slot caches, from position 0 with token 0, feeding back the
    greedy argmax, on the ``(1, --model-parallel)`` mesh; returns the wall
    time (device work included), tokens/s and the last logits (the whole
    vocabulary, on the CPU).  The weights are the arch's ``serve_weights``
    at full size and resident with ``--reduced``, unless ``weight_mode``
    says otherwise (the reference's CLI has no flag for it)."""
    dev = resolve_device(device if device is not None else args.device)
    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    if cfg.family == "encdec":
        # the reference's CLI exits here too: the loop starts from empty
        # caches, and an encoder-decoder's state needs its frames encoded
        raise SystemExit("enc-dec serving: build the decode state with "
                         "runtime.serve_step.init_decode_state(params=, "
                         "frames=) and decode with build_decode_step")
    model = build_model(cfg)
    mesh = (make_production_mesh() if args.production_mesh
            else serve_mesh(args.model_parallel))
    shape = ShapeConfig("serve", args.cache, args.batch, "decode")
    wm = weight_mode or (settings_for(args.arch).serve_weights
                         if not args.reduced else "resident")
    step = build_decode_step(model, shape, weight_mode=wm, device=dev,
                             mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = serve_params(step, model, model.init(gen, dev), mesh)
    state = init_decode_state(model, shape, mesh, device=dev)
    token = torch.zeros((args.batch,), dtype=torch.int32, device=dev)
    logits = None
    t0 = time.perf_counter()
    for pos in range(args.tokens):
        logits, state = step(params, token, state, pos)
        logits = gather_vocab(step.ctx, logits)
        token = torch.clamp(torch.argmax(logits, -1).to(torch.int32), 0,
                            model.cfg.vocab_size - 1)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    _log(f"{args.arch}: {args.tokens * args.batch / dt:.1f} tok/s "
         f"(batch {args.batch}, cache {args.cache}) R={args.model_parallel}"
         f" weights={wm}")
    return {"wall_s": dt, "tokens_per_s": args.tokens * args.batch / dt,
            "logits": logits.cpu()}


def _rank_main(args) -> dict:
    """One spawned rank of a ``--model-parallel`` run."""
    from repro_torch.launch.train import init_distributed

    import torch.distributed as dist

    world = init_distributed(args.device)
    try:
        return (run_paged if args.paged else run_contiguous)(args,
                                                             world.device)
    finally:
        dist.destroy_process_group()


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", required=True, choices=list_archs())
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--batch", type=int, default=4,
                    help="contiguous: sequences decoded together")
    ap.add_argument("--cache", type=int, default=512,
                    help="contiguous: KV-cache slots per sequence")
    ap.add_argument("--tokens", type=int, default=16,
                    help="contiguous: tokens decoded per sequence")
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged KV engine + continuous "
                         "batching scheduler instead of the "
                         "contiguous-cache loop")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "attention instead of the CUDA kernel)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--policy", default="continuous",
                    choices=["continuous", "static", "both"],
                    help="paged: batching policy ('both' prints the A/B "
                         "ratio)")
    ap.add_argument("--attn-impl", default="kernel", choices=["kernel", "ref"],
                    help="paged: score pages with the CUDA flash-decode "
                         "kernel or its plain PyTorch version")
    ap.add_argument("--page-tokens", type=int, default=16,
                    help="paged: token positions per KV page")
    ap.add_argument("--slots", type=int, default=4,
                    help="paged: concurrent sequence slots")
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="spawn this many ranks on a (1, R) (data, model) "
                         "mesh: page-parallel decode with --paged, else "
                         "tensor-parallel resident decode")
    ap.add_argument("--groups", type=int, default=4,
                    help="paged: mixed-trace groups (1 long + slots-1 short "
                         "requests each)")
    ap.add_argument("--long-len", type=int, default=64)
    ap.add_argument("--short-len", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=1)
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="paged: instrument the run (JSONL events + Chrome "
                         "trace under DIR)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="contiguous: the 16x16 (data, model) mesh (a "
                         "world of 256 ranks from torch.distributed's "
                         "environment)")
    return ap


def main(argv: list[str] | None = None) -> None:
    args = parser().parse_args(argv)
    if args.model_parallel < 1:
        raise SystemExit("--model-parallel must be >= 1")
    if args.production_mesh:
        if args.paged:
            raise SystemExit("--production-mesh serves the contiguous loop; "
                             "drop --paged")
        require_production_world(int(os.environ.get("WORLD_SIZE", "1")),
                                 False)
        _rank_main(args)
    elif args.model_parallel > 1:
        from repro_torch.launch.train import spawn

        resolve_device(args.device)        # refuse before spawning anything
        spawn(_rank_main, args.model_parallel, args)
    elif args.paged:
        run_paged(args)
    else:
        run_contiguous(args)


if __name__ == "__main__":
    main()
