"""The paper's headline experiment on the PyTorch port: all-reduce a
gradient-sized tree with the original Baidu-style schedule and with the
optimised ones, through ``Communicator.all_reduce_tree`` on ranks the port
spawns itself (counterpart of ``examples/allreduce_demo.py``).

    PYTHONPATH=src python examples/torch_allreduce_demo.py --elements 4194304
    PYTHONPATH=src python examples/torch_allreduce_demo.py --device cpu \\
        --nproc 2 --elements 65536 --tensors 8

Four schedules: per-tensor uni-directional ring (one bucket a tensor, one
chain), buckets with bidirectional chunks, the same striped over two
rails, and psum (one native all-reduce a tensor).  It needs ``--nproc 2``
or more to do any hop; several ranks on one card share it over gloo.
"""

import argparse

import numpy as np
import torch

from repro_torch.comm import CommConfig, Communicator
from repro_torch.core.topology import RankMesh
from repro_torch.launch.train import init_distributed, spawn
from repro_torch.tune.timing import time_call

SCHEDULES = [
    ("original         (per-tensor, uni-ring)",
     dict(transport="ring", chunks=1, bidirectional=False, bucket_bytes=1)),
    ("ring             (buckets + bi + chunks)",
     dict(transport="ring", chunks=2, bucket_bytes=32 * 2**20)),
    ("ring x2 rails    (channel striping)",
     dict(transport="ring", chunks=2, channels=2, bucket_bytes=32 * 2**20)),
    ("psum             (native all-reduce)",
     dict(transport="psum", fuse=False)),
]


def demo(device: str, elements: int, tensors: int, iters: int) -> dict:
    world = init_distributed(device)
    log = print if world.rank == 0 else (lambda msg: None)
    if world.size == 1:
        log("NOTE: one rank: the rings do no hop, so this measures the "
            "bucketing alone; run with --nproc 2 or more to see the "
            "paper's before/after.")
    mesh = RankMesh(("data",), (world.size,))
    rng = np.random.RandomState(world.rank)
    sizes = np.full(tensors, elements // tensors)
    sizes[0] += elements - sizes.sum()
    tree = {f"g{i}": torch.from_numpy(rng.randn(int(s)).astype(np.float32))
            .to(world.device) for i, s in enumerate(sizes)}
    results = {}
    for name, kw in SCHEDULES:
        comm = Communicator(mesh, CommConfig(data_axes=("data",), **kw))
        t = time_call(lambda: comm.all_reduce_tree(tree), warmup=1,
                      iters=iters, device=world.device)
        results[name] = float(t)
        log(f"{name}: {t * 1e6:10.1f} us/reduction "
            f"(min {t.t_min * 1e6:.1f}, max {t.t_max * 1e6:.1f})")
    base = results[SCHEDULES[0][0]]
    for name, dt in list(results.items())[1:]:
        log(f"speedup vs original — {name.split('(')[0].strip()}: "
            f"{base / dt:.1f}x")
    return results


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--elements", type=int, default=1 << 22)
    ap.add_argument("--tensors", type=int, default=64)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=2,
                    help="local ranks to spawn (1: this process alone)")
    args = ap.parse_args()
    fn_args = (args.device, args.elements, args.tensors, args.iters)
    if args.nproc > 1:
        spawn(demo, args.nproc, *fn_args)
    else:
        demo(*fn_args)


if __name__ == "__main__":
    main()
