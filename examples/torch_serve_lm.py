"""Batched serving on the PyTorch port: decode tokens step by step for a
batch of sequences against contiguous KV caches (counterpart of
``examples/serve_lm.py``).

    PYTHONPATH=src python examples/torch_serve_lm.py --tokens 32
    PYTHONPATH=src python examples/torch_serve_lm.py --device cpu --tokens 4
"""

import argparse
import time

import torch

from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.runtime.serve_step import (build_decode_step, gather_vocab,
                                            init_decode_state, serve_params)
from repro_torch.launch.mesh import make_host_mesh


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=32)
    ap.add_argument("--cache", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    dev = resolve_device(args.device)
    model = build_model(reduced_config("llama3.2-1b").with_(
        num_layers=4, d_model=128, d_ff=512))
    mesh = make_host_mesh(1)
    shape = ShapeConfig("serve", args.cache, args.batch, "decode")
    step = build_decode_step(model, shape, device=dev, mesh=mesh)
    gen = torch.Generator(device=dev).manual_seed(0)
    params = serve_params(step, model, model.init(gen, dev), mesh)
    state = init_decode_state(model, shape, mesh, device=dev)

    token = torch.randint(0, 100, (args.batch,), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(0)).to(dev)
    out_tokens = []
    t0 = time.perf_counter()
    for pos in range(args.tokens):
        logits, state = step(params, token, state, pos)
        logits = gather_vocab(step.ctx, logits)
        token = torch.clamp(torch.argmax(logits, -1).to(torch.int32), 0,
                            model.cfg.vocab_size - 1)
        out_tokens.append(token.cpu())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    toks = args.tokens * args.batch
    print(f"decoded {toks} tokens in {dt:.2f}s ({toks / dt:.1f} tok/s on "
          f"{dev})")
    print("sample stream:", [int(t[0]) for t in out_tokens[:16]])


if __name__ == "__main__":
    main()
