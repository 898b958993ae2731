"""Render the §Dry-run and §Roofline tables from the port's dry-run JSON
(port of ``repro.launch.report``)::

    PYTHONPATH=src python -m repro_torch.launch.report \\
        experiments/dryrun_torch.json

The columns are the reference's, with the memory columns the port's: the
peak of live storage in a step (``peak GB``) and whether it fits the card
(``fits H100 80GB``).  A cell the port refused, or one that failed,
shows its reason.
"""

from __future__ import annotations

import argparse
import json
import os

from repro_torch.configs import applicable_shapes, get_config, list_archs
from repro_torch.launch.dryrun import CARD_NAME

FIT_COLUMN = "fits " + CARD_NAME.removeprefix("NVIDIA ").rsplit(" ", 1)[0]
SHAPE_ORDER = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]


def fmt_bytes(b: float) -> str:
    if b >= 2**30:
        return f"{b/2**30:.2f}G"
    if b >= 2**20:
        return f"{b/2**20:.2f}M"
    return f"{b/2**10:.1f}K"


def fmt_t(s: float) -> str:
    if s >= 1:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s*1e3:.2f}ms"
    return f"{s*1e6:.0f}us"


def _find(cache: dict, tag: str, arch: str, shape: str, mesh: str):
    """The record of one cell: the plain key (``perf.py``'s) or a key with
    an overrides fingerprint (the dry-run's)."""
    base = f"{tag}|{arch}|{shape}|{mesh}"
    if base in cache:
        return cache[base]
    for key, rec in sorted(cache.items()):
        if key.startswith(base + "|"):
            return rec
    return None


def roofline_table(cache: dict, tag: str = "baseline",
                   mesh: str = "single") -> str:
    rows = ["| arch | shape | T_compute | T_memory | T_collective | "
            "T_exposed | bottleneck | compute-frac | useful-FLOPs | "
            "wire/dev | peak GB |",
            "|" + "---|" * 11]
    for arch in list_archs():
        cfg = get_config(arch)
        for shape in SHAPE_ORDER:
            if shape not in applicable_shapes(cfg):
                rows.append(f"| {arch} | {shape} | — | — | — | — | "
                            f"skipped (full attention) | — | — | — | — |")
                continue
            rec = _find(cache, tag, arch, shape, mesh)
            if rec is None:
                rows.append(f"| {arch} | {shape} | … | … | … | … | pending "
                            f"| … | … | … | … |")
                continue
            if "refused" in rec or "error" in rec:
                why = (f"refused: {rec['refused'][:60]}" if "refused" in rec
                       else f"FAILED: {rec['error'][:60]}")
                rows.append(f"| {arch} | {shape} | — | — | — | — | {why} | "
                            f"— | — | — | — |")
                continue
            r, m = rec["roofline"], rec["memory"]
            rows.append(
                f"| {arch} | {shape} | {fmt_t(r['t_compute_s'])} | "
                f"{fmt_t(r['t_memory_s'])} | {fmt_t(r['t_collective_s'])} | "
                f"{fmt_t(r['t_exposed_collective_s'])} | "
                f"{r['bottleneck']} | {r['compute_fraction']:.2f} | "
                f"{r['useful_flops_ratio']:.2f} | "
                f"{fmt_bytes(r['wire_bytes_per_device'])} | "
                f"{m['peak_gb']:.1f} |")
    return "\n".join(rows)


def dryrun_table(cache: dict, tag: str = "baseline") -> str:
    rows = [f"| arch | shape | mesh | trace | FLOPs/dev | HBM bytes/dev | "
            f"wire/dev | collectives | {FIT_COLUMN} |",
            "|" + "---|" * 9]
    cells = sorted((k, v) for k, v in cache.items()
                   if k.startswith(tag + "|") and "roofline" in v
                   and "memory" in v)
    for _, rec in cells:
        r = rec["roofline"]
        cc = rec["collectives"]["counts"]
        cstr = " ".join(f"{k.split('-')[0][:3]}×{v}"
                        for k, v in sorted(cc.items())) or "—"
        rows.append(
            f"| {rec['arch']} | {rec['shape']} | {rec['mesh']} | "
            f"{rec['trace_s']:.0f}s | {r['flops_per_device']:.2e} | "
            f"{r['hbm_bytes_per_device']:.2e} | "
            f"{fmt_bytes(r['wire_bytes_per_device'])} | {cstr} | "
            f"{'✓' if rec['memory']['fits'] else 'no'} |")
    for _, v in sorted((k, v) for k, v in cache.items()
                       if k.startswith(tag + "|")
                       and ("refused" in v or "error" in v)):
        why = (f"refused: {v['refused'][:80]}" if "refused" in v
               else f"FAILED: {v['error'][:80]}")
        rows.append(f"| {v.get('arch', '?')} | {v.get('shape', '?')} | — | "
                    f"— | — | — | — | {why} | — |")
    return "\n".join(rows)


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("path", nargs="*",
                    default=["experiments/dryrun_torch.json"])
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--section", default="both",
                    choices=["roofline", "dryrun", "both"])
    args = ap.parse_args(argv)
    cache = {}
    for p in args.path:
        if os.path.exists(p):
            with open(p) as f:
                cache.update(json.load(f))
    if args.section in ("roofline", "both"):
        print("### Roofline (single-pod 16x16, per device)\n")
        print(roofline_table(cache, args.tag, "single"))
    if args.section in ("dryrun", "both"):
        print("\n### Dry-run records (both meshes)\n")
        print(dryrun_table(cache, args.tag))


if __name__ == "__main__":
    main()
