#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on a failed check (exit code != 0):

1. build    — ``nvcc`` builds the flash-decode CUDA kernel for sm_90a from
              the repository's sources;
2. kernel   — the kernel against its plain PyTorch version on card inputs
              at the serve shape and around it (fp32 statistics, rtol/atol
              1e-4: only the summation order differs), and run-to-run
              bitwise;
3. serve    — the port's ``launch.serve --paged`` path on llama3.2-1b at
              full width with seeded random weights, continuous and static
              policies over a mixed trace; every layer of every decode step
              must launch the kernel (launches == steps x 16) and every
              logit must be finite;
4. profile  — one full-batch decode step under ``torch.profiler``: host
              wall, device busy time and the top device activities;
5. engines  — a kernel engine and a plain-attention engine, same weights,
              same 20 tokens: logits within bf16 tolerance;
6. timing   — device time per call (profiler) of the kernel, its plain
              version and PyTorch's ``scaled_dot_product_attention``
              (yardstick only) at the serve shape, beside the bound the
              card's memory rate sets.

It prints a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` gives them, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO / "src"))

ARCH = "llama3.2-1b"
SERVE_ARGS = ["--arch", ARCH, "--paged", "--device", "cuda", "--seed", "0",
              "--slots", "4", "--page-tokens", "16", "--groups", "2",
              "--long-len", "192", "--short-len", "4", "--prompt-len", "8",
              "--policy", "both"]
# the H100 SXM's published HBM3 rate and fp32 (non-tensor-core) peak
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
KERNEL_RTOL = KERNEL_ATOL = 1e-4
# logits are bf16 of O(1) magnitude (bf16 spacing 2^-7 at 1): a few
# roundings of the attention output that flip between the two engines
ENGINE_RTOL, ENGINE_ATOL = 2e-2, 5e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def gpu_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def device_activity(fn, iters: int) -> tuple[float, dict]:
    """Profiles ``iters`` calls of ``fn``; returns the host wall time per
    call (ms, ending in a synchronize) and the device time per call of each
    GPU activity by name (ms, CUPTI durations via ``torch.profiler``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
    by_name: dict[str, float] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    return wall, by_name


def events_ms(fn, iters: int, warmup: int = 10) -> float:
    """Mean time per call between CUDA events around ``iters`` back-to-back
    calls; inputs stay L2-resident, as the engine's fresh K/V are.  Where
    the host cannot enqueue as fast as the device runs, this is the host's
    time per call."""
    import torch

    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int) -> float:
    """Device time per call: the summed durations of every GPU activity
    the call issues.  Fails if the profiler saw none."""
    _, by_name = device_activity(fn, iters)
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity")
    return sum(by_name.values())


def kernel_inputs(dev, seed, b, hq, hkv, length, d, dtype, q_dtype):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((b, hkv, length, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, length, d), generator=gen, device=dev).to(dtype)
    # each row valid up to its own length, as a paged slot is
    lens = torch.randint(1, length + 1, (b,), generator=gen, device=dev)
    valid = torch.arange(length, device=dev)[None, :] < lens[:, None]
    return q, k, v, valid


def phase_build() -> None:
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_decode import ops

    t0 = time.perf_counter()
    path, report = _build.build(ops.SOURCE)
    ops._kernel_fn()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.1f} s")
    for line in report.splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"[build]   {line.strip()}")


def phase_kernel(dev) -> float:
    """Kernel vs plain version; returns the largest |difference|."""
    import torch

    from repro_torch.kernels.flash_decode import ops, ref

    cases = [  # name, d, kv dtype, q dtype, Hq, Hkv, L, all-invalid row
        ("serve", 64, torch.bfloat16, torch.bfloat16, 32, 32, 208, False),
        ("gqa", 64, torch.bfloat16, torch.bfloat16, 32, 8, 208, False),
        ("one_tile", 64, torch.bfloat16, torch.bfloat16, 32, 32, 80, False),
        ("fp32_cache", 64, torch.float32, torch.float32, 32, 32, 208, False),
        ("no_valid_row", 64, torch.bfloat16, torch.bfloat16, 32, 32, 208,
         True),
        ("d16", 16, torch.bfloat16, torch.float32, 16, 2, 200, False),
        ("d128", 128, torch.float32, torch.bfloat16, 8, 2, 131, False),
    ]
    worst = 0.0
    for i, (name, d, dt, qdt, hq, hkv, length, empty) in enumerate(cases):
        q, k, v, valid = kernel_inputs(dev, i, 4, hq, hkv, length, d, dt, qdt)
        if empty:
            valid[2] = False
        got = ops.flash_decode_stats(q, k, v, valid)
        again = ops.flash_decode_stats(q, k, v, valid)
        g = hq // hkv
        want = ref.decode_stats(q, torch.repeat_interleave(k, g, 1),
                                torch.repeat_interleave(v, g, 1), valid)
        torch.cuda.synchronize(dev)
        err = 0.0
        for x, y, w, what in zip(got, again, want, ("acc", "m", "l")):
            if not torch.equal(x, y):
                raise AssertionError(f"[kernel] {name}: {what} differs "
                                     f"between two runs")
            torch.testing.assert_close(x, w, rtol=KERNEL_RTOL,
                                       atol=KERNEL_ATOL,
                                       msg=lambda m: f"[kernel] {name} "
                                                     f"{what}: {m}")
            err = max(err, (x - w).abs().max().item())
        if empty and not torch.all(got[1][2] == ref.NEG_INF):
            raise AssertionError("[kernel] the all-invalid row lost NEG_INF")
        worst = max(worst, err)
        log(f"[kernel] {name:12s} d={d} {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} "
            f"L={length}: max |kernel - plain| {err:.3e}, bitwise rerun ok")
    return worst


def phase_serve(dev):
    import torch

    from repro_torch.kernels.flash_decode import ops
    from repro_torch.launch import serve

    args = serve.parser().parse_args(SERVE_ARGS)
    run = serve.setup_paged(args)
    cfg = run.model.cfg
    a = cfg.attn
    if (cfg.num_layers, cfg.d_model, a.num_heads, a.num_kv_heads, a.head_dim,
            cfg.vocab_size) != (16, 2048, 32, 8, 64, 128256):
        raise AssertionError(f"[serve] not llama3.2-1b at full width: {cfg}")
    plan = run.plan
    if plan.blocks_per_rank * plan.page_tokens != 208:
        raise AssertionError("[serve] expected a local L of 208 (ragged tile)")

    eng = run.engine
    eng.admit(0)                       # warm-up step: cuBLAS, allocator
    eng.decode(run.params, [1, 0, 0, 0])
    eng.retire(0)
    torch.cuda.synchronize(dev)

    finite = torch.ones((), dtype=torch.bool, device=dev)
    step = eng.decode

    def checked_decode(params, token):
        # every row, free slots' garbage rows included, must stay finite
        nonlocal finite
        logits = step(params, token)
        finite = finite & torch.isfinite(logits).all()
        return logits

    eng.decode = checked_decode
    ops.LAUNCHES = 0
    results = serve.serve_policies(run, ["continuous", "static"])
    launches = ops.LAUNCHES
    eng.decode = step
    steps = sum(r["steps"] for r in results.values())
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"[serve] {launches} kernel launches for {steps} "
                             f"steps x {cfg.num_layers} layers")
    if not bool(finite):
        raise AssertionError("[serve] non-finite logits")
    for policy, r in results.items():
        log(f"[serve] {policy}: {r['steps']} steps, {r['generated_tokens']} "
            f"tokens, {r['tokens_per_s']:.1f} tok/s, arena "
            f"{plan.total_bytes} B ({plan.n_kv_pages} pages)")
    log(f"[serve] kernel launches {launches} == {steps} steps x "
        f"{cfg.num_layers} layers")
    return {"launches": launches, "steps": steps, "policies": results,
            "arena_bytes": plan.total_bytes}, run


def phase_engines(dev, run) -> float:
    import numpy as np
    import torch

    from repro_torch.serve import PagedDecodeEngine

    engines = [PagedDecodeEngine(run.model, run.plan, attn_impl=impl,
                                 device=dev) for impl in ("kernel", "ref")]
    for e in engines:
        for s in range(run.plan.max_seqs):
            e.admit(s)
    rng = np.random.RandomState(0)
    worst = rel = 0.0
    for t in range(20):
        tok = rng.randint(0, run.model.cfg.vocab_size,
                          (run.plan.max_seqs,)).astype(np.int32)
        got, want = (e.decode(run.params, tok).float() for e in engines)
        torch.testing.assert_close(got, want, rtol=ENGINE_RTOL,
                                   atol=ENGINE_ATOL,
                                   msg=lambda m: f"[engines] step {t}: {m}")
        worst = max(worst, (got - want).abs().max().item())
        rel = max(rel, ((got - want).norm() / want.norm()).item())
    log(f"[engines] kernel vs plain-attention engine, 20 tokens x "
        f"{run.plan.max_seqs} slots: max |logit diff| {worst:.3e} "
        f"(rtol {ENGINE_RTOL}, atol {ENGINE_ATOL}), max relative L2 "
        f"{rel:.3e}")
    return worst


def phase_timing(dev) -> dict:
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    b, hq, length, d = 4, 32, 208, 64
    q, k, v, valid = kernel_inputs(dev, 99, b, hq, hq, length, d,
                                   torch.bfloat16, torch.bfloat16)
    mask = valid[:, None, None, :]
    calls = {
        "kernel": lambda: ops.flash_decode_stats(q, k, v, valid),
        "plain": lambda: ref.decode_stats(q, k, v, valid),
        "library": lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=mask),
    }
    launches = ops.LAUNCHES
    dev_ms = {n: device_ms(f, 200) for n, f in calls.items()}
    wall_ms = {n: events_ms(f, 200) for n, f in calls.items()}
    ops.LAUNCHES = launches            # timing launches are not the path's
    nbytes = sum(t.numel() * t.element_size() for t in (q, k, v, valid)) \
        + b * hq * (d + 2) * 4         # acc, m, l written once
    flops = 4 * b * hq * length * d    # q.k and p.v, multiply-add = 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    out = {"ms": dev_ms["kernel"], "plain_ms": dev_ms["plain"],
           "library_ms": dev_ms["library"],
           "bound_ms": max(t_bytes, t_ops),
           "bound_by": "bytes" if t_bytes >= t_ops else "operations",
           "call_wall_ms": wall_ms}
    log(f"[timing] B={b} Hq=Hkv={hq} L={length} D={d} bf16, device time per "
        f"call: kernel {dev_ms['kernel'] * 1e3:.2f} us, plain "
        f"{dev_ms['plain'] * 1e3:.2f} us, sdpa {dev_ms['library'] * 1e3:.2f} "
        f"us; bound {out['bound_ms'] * 1e3:.2f} us ({out['bound_by']}: "
        f"{nbytes} B)")
    log("[timing] back-to-back time per call (CUDA events): " + ", ".join(
        f"{n} {t * 1e3:.2f} us" for n, t in wall_ms.items()))
    return out


def phase_profile(dev, run) -> dict:
    """Where a full-batch decode step's time goes: host wall per step,
    device busy time per step, and the device's top activities."""
    eng = run.engine
    for s in range(run.plan.max_seqs):
        eng.admit(s)
    tok = [1] * run.plan.max_seqs
    wall, by_name = device_activity(lambda: eng.decode(run.params, tok), 10)
    for s in range(run.plan.max_seqs):
        eng.retire(s)
    if not by_name:
        raise RuntimeError("[profile] no device activity in a decode step")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[profile] decode step, {run.plan.max_seqs} live slots: wall "
        f"{wall:.2f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}")
    for name, ms in top:
        log(f"[profile]   {ms * 1e3:9.1f} us/step  {name[:90]}")
    return {"step_wall_ms": wall, "step_device_ms": busy,
            "idle_share": 1 - busy / wall,
            "top_device_ms_per_step": dict(top)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every number of the run as JSON here")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: CUDA is not available; this script measures "
                 "the port on an NVIDIA GPU")
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False      # plain version: fp32
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    phase_build()
    kernel_err = phase_kernel(dev)
    serve, run = phase_serve(dev)
    profile = phase_profile(dev, run)
    engine_err = phase_engines(dev, run)
    del run
    timing = phase_timing(dev)
    call_wall_ms = timing.pop("call_wall_ms")
    gpu = gpu_line()
    kernels = {"kernels": [{
        "name": "flash_decode_stats", "route": "cuda",
        "source": "src/repro_torch/kernels/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/flash_decode.py:91",
        "launches": serve["launches"], "max_abs_err": kernel_err, **timing}],
        "gpu": gpu}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {**kernels, "serve": serve, "engine_max_abs_err": engine_err,
             "call_wall_ms": call_wall_ms, "profile": profile,
             "torch": torch.__version__, "cuda": torch.version.cuda,
             "wall_s": time.perf_counter() - t_start}, indent=1))
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
