"""Run a function on N gloo CPU ranks and collect each rank's output.

The ranks are fresh ``spawn`` processes that meet through a
``torch.distributed.FileStore`` in a temporary directory, so no TCP port is
chosen and parallel test workers never race for one.  ``fn`` must be a
module-level function (it is pickled by reference); it is called as
``fn(rank, world, *args)`` after ``init_process_group`` and returns a
picklable value (numpy arrays, dicts, numbers).
"""

from __future__ import annotations

import os
import pickle
import sys
import tempfile
import traceback

import torch.multiprocessing as mp

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "src")
TESTS = os.path.dirname(os.path.abspath(__file__))


def _rank_main(rank: int, world: int, store_path: str, out_dir: str, fn,
               args) -> None:
    for p in (SRC, TESTS):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    out = os.path.join(out_dir, f"rank{rank}.pkl")
    try:
        store = dist.FileStore(store_path, world)
        dist.init_process_group("gloo", store=store, rank=rank,
                                world_size=world)
        try:
            result = ("ok", fn(rank, world, *args))
        finally:
            dist.destroy_process_group()
    except BaseException:                 # reported to the parent, re-raised
        result = ("error", traceback.format_exc())
        with open(out, "wb") as f:
            pickle.dump(result, f)
        raise
    with open(out, "wb") as f:
        pickle.dump(result, f)


def run_ranks(fn, world: int, *args, timeout: float = 240.0) -> list:
    """``[fn(0, world, *args), ..., fn(world - 1, world, *args)]``, each run
    on its own gloo rank.  Raises with the failing rank's traceback."""
    with tempfile.TemporaryDirectory() as tmp:
        store_path = os.path.join(tmp, "store")
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, world, store_path, tmp, fn, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout)
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join(10)
        results = []
        for r in range(world):
            path = os.path.join(tmp, f"rank{r}.pkl")
            if not os.path.exists(path):
                raise AssertionError(
                    f"rank {r} left no result (exit code "
                    f"{procs[r].exitcode}{', timed out' if alive else ''})")
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                raise AssertionError(f"rank {r} failed:\n{value}")
            results.append(value)
        return results
