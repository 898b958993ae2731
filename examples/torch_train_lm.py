"""End-to-end driver on the PyTorch port: train a ~100M-parameter LM with
checkpoint/restart, straggler accounting and the paper's reducer
(counterpart of ``examples/train_lm.py``).

    PYTHONPATH=src python examples/torch_train_lm.py --steps 300 \\
        --transport ring_hier --channels 2 --dp-mode zero1
    PYTHONPATH=src python examples/torch_train_lm.py --device cpu --nproc 2 \\
        --steps 4 --seq 32 --batch 4 --layers 2 --d-model 128

Interrupt it and run it again: it resumes from the last committed
checkpoint (``--ckpt-dir``, ``build/torch_train_lm`` by default).
``--layers`` and ``--d-model`` cut the model (8 layers of 512 by
default); several ranks are spawned with ``--nproc`` and laid out as the
host mesh.
"""

import argparse
import dataclasses

from repro_torch.comm import CommConfig
from repro_torch.comm.registry import list_transports
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.train import init_distributed, spawn
from repro_torch.models import build_model
from repro_torch.optim import OptimConfig
from repro_torch.runtime.train_loop import Trainer, TrainerConfig
from repro_torch.runtime.train_step import DP_MODES, TrainStepConfig


def build_100m(layers: int = 8, d_model: int = 512):
    """The reference example's ~100M-parameter llama-style config (8
    layers of 512, 8 q / 4 kv heads of 64, vocab 32000, fp32)."""
    cfg = get_config("llama3.2-1b").with_(
        num_layers=layers, d_model=d_model, d_ff=4 * d_model,
        vocab_size=32000, dtype="float32", remat="none", sharding="tp")
    heads = max(d_model // 64, 2)
    attn = dataclasses.replace(cfg.attn, num_heads=heads,
                               num_kv_heads=heads // 2, head_dim=64)
    return build_model(cfg.with_(attn=attn))


def train(args) -> dict:
    world = init_distributed(args.device)
    log = print if world.rank == 0 else (lambda msg: None)
    model = build_100m(args.layers, args.d_model)
    log(f"model: {model.param_count() / 1e6:.1f}M params, {world.size} "
        f"rank(s) on {world.device}")
    mesh = make_host_mesh(world.size)
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=args.seq,
                                      global_batch=args.batch))
    step_cfg = TrainStepConfig(
        dp_mode=args.dp_mode,
        comm=CommConfig(transport=args.transport, channels=args.channels,
                        chunks=2, bucket_bytes=32 * 2**20),
        optim=OptimConfig(base_lr=args.lr, warmup=20, schedule="wsd",
                          total_steps=args.steps),
        microbatches=args.microbatches, schedule="stream",
        use_arena=args.use_arena, wire_codec=args.wire_codec)
    trainer = Trainer(model, mesh, step_cfg, data,
                      TrainerConfig(steps=args.steps, ckpt_every=50,
                                    ckpt_dir=args.ckpt_dir, log_every=20),
                      device=world.device, rank=world.rank, log=log)
    out = trainer.run()
    hist = out["history"]
    if hist:
        log(f"\nfinal loss {hist[-1]['loss']:.4f}; "
            f"{len(out['straggler_events'])} straggler events; median step "
            f"{sorted(h['sec'] for h in hist)[len(hist) // 2] * 1e3:.0f} ms")
    return {"history": hist}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--transport", default="ring_hier",
                    choices=list_transports())
    ap.add_argument("--channels", type=int, default=0,
                    help="virtual comm rails (0 = unconstrained)")
    ap.add_argument("--dp-mode", default="zero1", choices=DP_MODES)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--use-arena", action="store_true",
                    help="reduce out of the page-aligned arena")
    ap.add_argument("--wire-codec", default=None, choices=["int8"],
                    help="quantize the gradient wire (int8 + per-block "
                         "scales with error feedback)")
    ap.add_argument("--ckpt-dir", default="build/torch_train_lm")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nproc", type=int, default=1,
                    help="local ranks to spawn")
    args = ap.parse_args()
    if args.nproc > 1:
        spawn(train, args.nproc, args)
    else:
        train(args)


if __name__ == "__main__":
    main()
