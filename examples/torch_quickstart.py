"""Quickstart of the PyTorch port: train a tiny llama on synthetic data with
the paper's gradient reduction (chunked bidirectional ring, hierarchical
transport), the same configuration as ``examples/quickstart.py``.

    PYTHONPATH=src python examples/torch_quickstart.py            # one GPU
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --nproc 2
    PYTHONPATH=src python examples/torch_quickstart.py --device cpu --nproc 2 \
        --wire-codec int8 --use-arena

``--wire-codec int8`` quantizes the gradient wire (int8 values and one fp32
scale per block on every ring hop); with ``--use-arena`` the reduction also
runs through the int8 arena with error feedback.

Several ranks on one host are spawned as local processes (gloo on the CPU,
or several ranks sharing one card; NCCL when each rank has its own card)
and laid out as the reference's host mesh, ``("data", "model")`` with a
model axis of 2 where the rank count allows: two ranks train
tensor-parallel, four on a (2, 2) mesh.
"""

import argparse

from repro_torch.comm import CommConfig
from repro_torch.configs import reduced_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.train import init_distributed, spawn
from repro_torch.models import build_model
from repro_torch.optim import OptimConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.runtime.train_step import TrainStepConfig


def train(device: str, wire_codec: str | None = None,
          use_arena: bool = False) -> dict:
    world = init_distributed(device)
    model = build_model(reduced_config("llama3.2-1b").with_(
        num_layers=4, d_model=128, d_ff=512))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=128, global_batch=8))
    step_cfg = TrainStepConfig(
        dp_mode="replicated",
        comm=CommConfig(transport="ring_hier", chunks=2),
        optim=OptimConfig(base_lr=3e-3, warmup=10, total_steps=60),
        use_arena=use_arena, wire_codec=wire_codec)
    log = print if world.rank == 0 else (lambda msg: None)
    mesh = make_host_mesh(world.size)
    log(f"ranks: {world.size}, mesh: {mesh.sizes()}, device: {world.device}, "
        f"backend: {world.backend}, wire codec: {wire_codec}, "
        f"arena: {use_arena}")
    trainer = Trainer(model, mesh, step_cfg, data,
                      TrainerConfig(steps=60, log_every=10),
                      device=world.device, rank=world.rank, log=log)
    out = trainer.run()
    first, last = out["history"][0]["loss"], out["history"][-1]["loss"]
    log(f"\nloss {first:.4f} -> {last:.4f} over {len(out['history'])} "
        f"steps ({out['wall']:.1f}s)")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=1,
                    help="local ranks to spawn")
    ap.add_argument("--wire-codec", default=None, choices=["int8"],
                    help="quantize the gradient wire")
    ap.add_argument("--use-arena", action="store_true",
                    help="reduce through the page-aligned arena")
    args = ap.parse_args()
    fn_args = (args.device, args.wire_codec, args.use_arena)
    if args.nproc > 1:
        spawn(train, args.nproc, *fn_args)
    else:
        train(*fn_args)


if __name__ == "__main__":
    main()
