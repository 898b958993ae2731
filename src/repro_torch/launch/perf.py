"""Re-trace one dry-run cell with overrides and record it under a tag
(port of ``repro.launch.perf``), so :mod:`repro_torch.launch.report` can
set a variant beside the baseline::

    PYTHONPATH=src python -m repro_torch.launch.perf --arch llama3.2-1b \\
        --shape train_4k --tag wire_bf16 --set comm_wire_dtype=bfloat16

Override keys are :func:`repro_torch.launch.dryrun.make_step_config`'s:
any ``CommConfig`` field as ``comm_<field>``, any ``TrainStepConfig``
field (``microbatches``, ``schedule``, ``use_arena``, ``causal_skip``,
``fsdp_gather``, ``gather_dtype``, ``fsdp_bucket_bytes``, ...), and
``serve_weights`` for the serving shapes.  The legacy
``accum_microbatches`` / ``accum_policy`` spellings map onto
``microbatches`` / ``schedule``; ``reduce_*`` keys are refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time


def parse_val(v: str):
    """``true``/``false``, then an int, then a float, else the string."""
    if v in ("true", "True"):
        return True
    if v in ("false", "False"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        return v


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single", choices=["single", "multi"])
    ap.add_argument("--tag", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="key=value override (repeatable)")
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    args = ap.parse_args(argv)

    from repro_torch.launch.dryrun import run_cell

    overrides = {}
    for kv in args.set:
        k, _, v = kv.partition("=")
        overrides[k] = parse_val(v)

    t0 = time.time()
    rec = run_cell(args.arch, args.shape, args.mesh == "multi", overrides)
    rec["tag"] = args.tag
    rec["overrides"] = {k: str(v) for k, v in overrides.items()}

    cache = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            cache = json.load(f)
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    key = f"{args.tag}|{args.arch}|{args.shape}|{args.mesh}"
    cache[key] = rec
    with open(args.out, "w") as f:
        json.dump(cache, f, indent=1)
    r = rec["roofline"]
    print(f"[{args.tag}] {args.arch}x{args.shape}: "
          f"Tc={r['t_compute_s']:.4f}s Tm={r['t_memory_s']:.4f}s "
          f"Tx={r['t_collective_s']:.4f}s bottleneck={r['bottleneck']} "
          f"frac={r['compute_fraction']:.3f} "
          f"peak={rec['memory']['peak_gb']:.2f}GB ({time.time()-t0:.0f}s)")


if __name__ == "__main__":
    main()
