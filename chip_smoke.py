#!/usr/bin/env python3
"""Drives the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments::

    python3 chip_smoke.py [--out FILE]

Phases, each of which raises on a failed check (exit code != 0):

1. build    — ``nvcc`` builds the seven CUDA sources for sm_90a from the
              repository, one compiler per source, all at once;
2. kernel   — the flash-decode kernel against its plain PyTorch version on
              card inputs at the serve shape and around it (fp32
              statistics, rtol/atol 1e-4: only the summation order
              differs), and run-to-run bitwise: K/V expanded and
              unexpanded (8 and 1 kv heads for 32 q heads), L from 1 to
              16384 (the key axis split over a cluster), key runs with no
              valid position across the cluster's splits, rows with none;
3. kernels  — the ring's ``reduce_add`` (fp32+fp32->fp32, bf16+fp32->fp32,
              fp32+fp32->bf16 at lengths 1024*k, 1000 and 7, one tile of
              the kernel and one tile +- 1, and 2^26 + 5, aligned and
              unaligned starts) and the arena's ``pack`` write/read
              (2 MiB-aligned and odd offsets, fp32 into a bf16 arena; on
              the bulk route 1 element, below, at and one past one stage,
              a head misaligned alike on both sides and 2^26 + 5 elements;
              on the vector route sources not congruent mod 16 bytes and
              casts both ways; each case's route asserted, both routes
              launched) against their plain versions: bitwise, and run to
              run;
4. serve    — the port's ``launch.serve --paged`` path on llama3.2-1b at
              full width with seeded random weights, continuous and static
              policies over a mixed trace; every layer of every decode step
              must launch the kernel (launches == steps x 16), hand it the
              gathered K/V unexpanded (8 kv heads for 32 q heads), and
              every logit must be finite;
5. profile  — one full-batch decode step under ``torch.profiler``: host
              wall, device busy time, the top device activities and the
              ``index_select`` kernels per step (the K/V expansion the
              engine no longer makes);
6. engines  — a kernel engine and a plain-attention engine, same weights,
              same 20 tokens: logits within bf16 tolerance;
7. timing   — time per call of the flash-decode kernel, its plain version
              and PyTorch's ``scaled_dot_product_attention`` (``enable_gqa``;
              yardstick only) at the serve path's shape (8 kv heads), at
              the expanded shape the engine passed before (32 kv heads) and
              at long context (L = 16384, K/V past the L2), beside the
              bound the card's memory rate sets: CUDA events around
              replays of a CUDA graph of many calls (reported), printed
              beside eager CUDA events, the host clock and the profiler's
              device activities;
8. kernels_attn — the flash-attention kernels against their plain version
              over S in {1, 7, 64, 127, 128, 129, 200, 255, 256, 257, 1000,
              4096} x (Hq, Hkv) in {(32, 8), (4, 2), (8, 1)} x D in {16, 32,
              64, 128} x causal, window 64 and non-causal x fp32 (the SIMT
              kernel) and bf16 (the wgmma kernel), then bf16 in two
              layouts TMA cannot take (a 260-element sequence stride, k/v
              2 bytes past alignment) on the SIMT route, each case's route
              asserted and each route's launches counted (the reference's
              tolerances: rtol/atol 2e-5 at fp32, atol 3e-2 at bf16),
              run-to-run bitwise; Sq != Sk and requires_grad raise;
9. prefill  — ``build_prefill`` on llama3.2-1b at full width (16 layers,
              seeded random weights): at B=1, S=4096, for ten seeds of
              weights and tokens, the kernel prefill against the fp32
              blockwise (plain attention) prefill: at fp32 compute every
              logit within rtol/atol 1e-4; at bf16 compute the kernel
              prefill's relative L2 error at most 1.05 times the bf16
              blockwise prefill's and its count of logits outside rtol
              2e-2 / atol 5e-2 at most 1.25 times; every fp32 prefill
              launches the SIMT kernel and every bf16 one the wgmma kernel,
              once per layer; at B=1, S=32768 (prefill_32k's length)
              one warm, one timed and one profiled prefill, every one
              launching the wgmma kernel once per layer (16), the SIMT
              kernel and every other kernel never, logits finite; wall,
              peak memory, device busy and idle share;
10. serve_contiguous — ``launch.serve`` without ``--paged``: the
              contiguous-cache loop at full width with the reference's
              defaults (batch 4, cache 512, 16 tokens): logits finite,
              tokens/s, no kernel launched (its decode attention is plain,
              as the reference's);
11. timing  — time per call of the wgmma flash-attention kernel at one
              prefill layer's shape (q (1, 32, 32768, 64), k/v (1, 8, 32768,
              64), bf16, causal) beside PyTorch's fused
              ``scaled_dot_product_attention`` (yardstick only; it rounds P
              to bf16 once, the kernel splits it in two bf16 halves) and
              the bound the card's dense
              bf16 rate sets for the function's work (``attention_flops``),
              with the flops the kernel executes printed beside it; the
              kernel's output held against the plain version's (query
              blocks of 1024) at that shape (atol 3e-2), the plain version
              timed there too, and both at S=4096; the SIMT kernel, the
              plain version and SDPA at fp32, S=4096;
12. train    — ``launch.train``'s setup on one rank: full llama3.2-1b (16
              layers), replicated, ``ring_hier``, chunks 2, the arena on,
              seq 256, global batch 8, bf16 compute over fp32 master
              weights, 3 steps: losses finite, the arena's ``data_ptr()``
              unchanged, pack write and read launches == segments x steps,
              every one on the bulk route; then one profiled step;
13. train_ring — two ranks spawned on the one card (gloo, hops staged
              through pinned host memory), full width at 4 layers, 3 steps:
              ``reduce_add`` launches == spans x channel slices x (p-1) x
              steps, pack launches == segments x steps (all bulk),
              recorded sends and bytes == the CommPlan's; one more step
              through the kernels
              and through the plain versions from the same state and the
              same local gradients: reduced gradients and new parameters
              bitwise equal (64-bit digests of their bytes, on the card);
14. timing  — time per call, by the same four clocks, of ``reduce_add``
              at the largest hop and at the median hop (inputs rotated past
              the L2, checked bitwise) and of pack write and pack read at the
              train layout's largest segment, its median segment (inputs
              rotated past the L2) and over the whole layout (``pack_into``
              and ``unpack`` of its 82 segments), then the vector route at
              the largest segment (a source 4 bytes off, a cast into bf16),
              their plain versions and one PyTorch call each
              (``torch.add``, ``copy_``, ``clone``, ``_foreach_copy_``;
              yardsticks only), beside the memory-rate bound;
15. kernels_int8 — the int8 codec's ``quantize``/``dequantize`` and the
              arena's ``write_quant``/``read_dequant`` (blocks 512, 128 and
              96; 1, 7 and about 500,000 blocks; a zero block, and a
              block holding a NaN and one holding an inf; arena offsets 0,
              a 2 MiB page and a block multiple that is not a page
              multiple; in place; error feedback fused and not) against
              their plain versions: bitwise (NaN where they have NaN), and
              run to run;
16. train_int8 — the train phase with ``--wire-codec int8``: the int8
              arena and the ``"ef"`` accumulator keep their ``data_ptr()``,
              ``write_quant`` launches == (segments + spans) x steps,
              ``read_dequant`` launches == (spans + segments) x steps, no
              ``quantize`` launch (one rank makes no hop), the first loss
              equal to the train phase's; then one profiled step;
17. train_ring_int8 — train_ring with ``--wire-codec int8``: ``quantize``
              launches == channel slices x p x steps, ``dequantize``
              launches == channel slices x (2p - 1) x steps,
              the other launches as predicted, recorded sends and bytes ==
              the CommPlan's compressed prediction, and one step through
              the kernels and through the plain versions from the same
              state and the same local gradients: reduced gradients, new
              parameters and new ``"ef"`` bitwise equal; then one step
              with the arena off, every bucket through the int8 ring:
              launches as predicted, sends and bytes == the plan's;
18. timing  — time per call of ``write_quant`` (with error feedback) and
              ``read_dequant`` at train_int8's largest segment and of
              ``quantize``/``dequantize`` at train_ring_int8's largest hop,
              their plain versions and, for the decodes, one PyTorch call
              (``torch.mul`` of int8 by fp32 scales; no single PyTorch call
              quantizes by block absmax), beside the memory-rate bound;
19. train_zero1 — the train phase's run with no ``--dp-mode``, so that
              llama3.2-1b's own default, ``zero1``, resolves (asserted):
              one rank, 16 layers, the arena on, 3 steps: losses finite,
              the first two the train phase's bitwise, and all within 5e-5
              of a replicated run of the same seed and batches made in
              this phase, both under ``torch.use_deterministic_algorithms``
              (the index ops' backward adds with atomics), the arena's
              ``data_ptr()`` unchanged, pack writes == segments x steps and
              pack reads == segments x steps (``unpack_spans`` reading the
              all-gathered delta spans), every one bulk; one step through
              the kernels and through the plain versions from the same
              state and local gradients: shards, parameters and gradient
              norm bitwise; then one profiled step, with the peak;
20. train_ring_zero1 — train_ring's checks for zero1, under deterministic
              algorithms (two ranks, full
              width at ``ZERO1_RING_LAYERS`` = 16 layers, the full depth;
              it runs right after the build, while this process holds
              nothing on the card, and every two-rank phase logs what the
              card holds before its ranks spawn): ``reduce_add``
              launches == the reduce-scatter hops, pack writes and reads ==
              segments x steps, sends and bytes == the CommPlan's (the
              reduce-scatter and the delta all-gather make one
              all-reduce's), both ranks' parameters bitwise equal, the
              kernel step == the plain step bitwise; then one step with
              the arena off over the buckets;
21. train_ring_zero1_int8 — the same at 4 layers with ``--wire-codec
              int8``: ``quantize`` == channel slices x p x steps and
              ``dequantize`` == channel slices x (2p - 1) x steps, the
              delta all-gather's encode at the source and p decodes
              included; ``write_quant`` == segments x steps and
              ``read_dequant`` == spans x steps (no re-encode of a reduced
              span, no int8 unpack: the delta spans are fp32 pack reads);
22. train_fsdp — the train phase's run with ``--dp-mode fsdp`` (ZeRO-3,
              the native gather, bf16): one rank, 16 layers, the arena on,
              3 steps under ``torch.use_deterministic_algorithms``: with
              ``gather_dtype="float32"`` the first batch's gradients are a
              replicated step's bitwise, leaf by leaf; with the bf16
              gathers the first two losses are train_zero1's deterministic
              replicated run's bitwise (the third is reported); pack
              writes and reads == group buckets x steps (18 at 16 layers),
              all bulk, the kernel step == the plain step bitwise; one
              profiled step, the peak;
23. train_ring_fsdp — two fsdp ranks at the full 16 layers over the ring
              gather (``fsdp_gather="ring"`` on the CLI's step config),
              deterministic, right after train_ring_zero1 (which runs
              deterministic too): ``reduce_add`` (fp32 + bf16 -> fp32)
              launches == the backward reduce-scatter's hops, pack writes
              and reads == group buckets x steps, sends and bytes == the
              forward gathers, the remat re-gathers and the reduce-scatter
              (:func:`fsdp_expected`), the first two losses bitwise
              train_ring_zero1's, each rank's kernel step (its own backward
              pass) == its plain step bitwise; then one step with the arena
              off;
24. train_ring_fsdp_int8 — two fsdp ranks at 4 layers over the native
              gather (``all_gather_into_tensor``/``reduce_scatter_tensor``
              staged through pinned memory) with ``--wire-codec int8``:
              ``write_quant`` and ``read_dequant`` == segments x steps, no
              hop, native gathers and reduce-scatters and their bytes as
              expected, the kernel step == the plain step bitwise;
25. prefill_gathered — ``build_prefill(weight_mode="gathered")`` at full
              width, 16 layers, B=1, S=4096, the weights as fsdp shards:
              16 wgmma flash-attention launches and no other, logits within
              the engine's bf16 tolerance of the resident prefill's;
26. timing  — ``reduce_add`` at fsdp's mix (fp32 + bf16 -> fp32) at the
              largest (embedding) and median (block) hop of
              train_ring_fsdp, bitwise its plain version, beside
              ``torch.add(fp32, bf16)`` and the bound (10 bytes an
              element).
27. train_ckpt — one rank, zero1 (the arch's default), the arena on,
              seq 256, batch 8, full width at 4 layers (cut further, with
              the reason printed, if two step directories do not fit the
              free disk), under deterministic algorithms: an unbroken
              4-step run; a run stopped after 2 steps, whose final save
              writes the reference's on-disk format under ``build/``; a
              fresh Trainer with ``--obs-dir`` that resumes at step 2: the
              resumed losses and every leaf of the final state bitwise the
              unbroken run's, the restored arena and moment shards bitwise
              what was saved, the launches a step equal in the three runs,
              ``trace.json`` holding the data, step, dispatch, wait and
              ckpt spans (each step's dispatch and wait inside its step),
              a span fenced on a tensor covering the device work queued
              before it; the bytes written, the save's blocking part, its
              async write, the restore with its sha256 verify and the free
              disk space printed; the directories deleted;
28. train_ring_ckpt — the same on two ranks over gloo, zero1 over the
              int8 wire with the int8 arena (its sharded leaves gathered
              to rank 0 as global arrays): losses and final state bitwise
              on both ranks, each rank's restored arena, ``"ef"`` and
              moment shards bitwise what it saved, the launches a step of
              ``pack``, ``pack_quant``, ``quant`` and ``reduce_add`` equal
              to the unbroken run's.

Each phase prints its seconds (``[phase]``).  It prints a ``{"kernels": [...]}`` line, the card's name and power limit as
``nvidia-smi`` gives them, and as its last line
``{"ok": true, "device": {...}}``.  Without CUDA, or outside a checkout of
the repository, it exits with an error and prints no result.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import json
import math
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
L2_BYTES = 50e6                  # the H100's L2 cache
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


# the port's kernels as the profiler names them
PORT_KERNELS = ("flash_decode_stats_kernel", "reduce_add_kernel",
                "bulk_copy_kernel", "vector_copy_kernel", "quantize_kernel",
                "write_quant_kernel", "read_dequant_kernel",
                "flash_attn_fwd_kernel", "flash_attn_wgmma_kernel")


def device_activity(fn, iters: int,
                    warm: bool = True) -> tuple[float, dict, dict]:
    """Profiles ``iters`` calls of ``fn`` (after one unprofiled call when
    ``warm``); returns the host wall time per call (ms, ending in a
    synchronize), the device time per call of each GPU activity by name
    (ms, CUPTI durations via ``torch.profiler``) and the number of
    activities the profiler recorded by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warm:
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
    counts: dict[str, int] = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            counts[e.name] = counts.get(e.name, 0) + 1
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3 / iters)
    return wall, by_name, counts


def port_kernels_seen(counts: dict) -> int:
    """How many launches of the port's kernels the profiler recorded
    (``quantize_kernel`` also matches ``dequantize_kernel``)."""
    return sum(c for name, c in counts.items()
               if any(k in name for k in PORT_KERNELS))


def _kernel_ops():
    from repro_torch.kernels.flash_attn import ops as fa
    from repro_torch.kernels.flash_decode import ops as fd
    from repro_torch.kernels.pack import ops as pk
    from repro_torch.kernels.pack_quant import ops as pq
    from repro_torch.kernels.quant import ops as qt
    from repro_torch.kernels.reduce_add import ops as ra

    return fd, ra, pk, qt, pq, fa


def launch_counters() -> dict:
    """Every kernel wrapper's launch count, by kernel."""
    fd, ra, pk, qt, pq, fa = _kernel_ops()
    return {"flash_decode": fd.LAUNCHES, "flash_attn": fa.LAUNCHES,
            "reduce_add": ra.LAUNCHES,
            "pack_write": pk.LAUNCHES["write"],
            "pack_read": pk.LAUNCHES["read"],
            "quantize": qt.LAUNCHES["quantize"],
            "dequantize": qt.LAUNCHES["dequantize"],
            "pack_quant_write": pq.LAUNCHES["write"],
            "pack_quant_read": pq.LAUNCHES["read"]}


def set_launch_counters(saved: dict) -> None:
    """Sets the counts :func:`launch_counters` reads (restoring them after
    launches made to time or check a kernel, which are not the main
    path's)."""
    fd, ra, pk, qt, pq, fa = _kernel_ops()
    fd.LAUNCHES, ra.LAUNCHES = saved["flash_decode"], saved["reduce_add"]
    fa.LAUNCHES = saved["flash_attn"]
    pk.LAUNCHES.update(write=saved["pack_write"], read=saved["pack_read"])
    qt.LAUNCHES.update(quantize=saved["quantize"],
                       dequantize=saved["dequantize"])
    pq.LAUNCHES.update(write=saved["pack_quant_write"],
                       read=saved["pack_quant_read"])


def attn_routes() -> dict:
    """flash_attn's launches by route: "wgmma" (bf16) and "simt" (fp32)."""
    return dict(_kernel_ops()[5].LAUNCHES_BY_ROUTE)


def set_attn_routes(saved: dict) -> None:
    _kernel_ops()[5].LAUNCHES_BY_ROUTE.update(saved)


def pack_routes() -> dict:
    """pack's launches by route: "bulk" (same type, addresses congruent mod
    16 bytes) and "vector" (casts and the rest)."""
    return dict(_kernel_ops()[2].LAUNCHES_BY_ROUTE)


def set_pack_routes(saved: dict) -> None:
    _kernel_ops()[2].LAUNCHES_BY_ROUTE.update(saved)


def reset_launch_counters() -> None:
    set_launch_counters(dict.fromkeys(launch_counters(), 0))
    set_attn_routes(dict.fromkeys(attn_routes(), 0))
    set_pack_routes(dict.fromkeys(pack_routes(), 0))


def events_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean time per call between CUDA events around ``iters`` back-to-back
    calls.  Where the host cannot enqueue as fast as the device runs, this
    is the host's time per call."""
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


def graph_ms(fn, iters: int, reps: int = 3) -> float:
    """Device time per call: CUDA events around ``reps`` replays of a CUDA
    graph that holds ``iters`` calls of ``fn``, so that the host's enqueue
    time stays out of it.  Inputs stay in L2 where they fit."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):      # warm-up off the capture, as
        for _ in range(3):             # CUDA graph capture asks
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    torch.cuda.empty_cache()
    return start.elapsed_time(end) / (reps * iters)


def call_times(fn, iters: int) -> dict:
    """One call's time per call by four clocks: CUDA events around graph
    replays (``graph_ms``, the number reported), CUDA events and the host
    clock around back-to-back eager calls, and the profiler's summed
    device activities (with the activities it recorded per call)."""
    import torch

    events = events_ms(fn, iters)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    host = (time.perf_counter() - t0) / iters * 1e3
    # the profiler keeps only some of the activities of a window of
    # back-to-back calls, and at times none (PERF.md section 6): its clock
    # is printed beside the CUDA-event clocks, "not recorded" when empty
    _, by_name, counts = device_activity(fn, iters)
    return {"graph_ms": graph_ms(fn, iters), "events_ms": events,
            "host_ms": host,
            "profiler_ms": sum(by_name.values()) if by_name else None,
            "profiler_activities_per_call": sum(counts.values()) / iters}


def times_line(name: str, times: dict) -> str:
    prof = ("not recorded" if times["profiler_ms"] is None
            else f"{times['profiler_ms'] * 1e3:9.2f} us")
    return (f"[timing]   {name:8s} graph+events {times['graph_ms'] * 1e3:9.2f}"
            f" us | eager events {times['events_ms'] * 1e3:9.2f} us | host "
            f"clock {times['host_ms'] * 1e3:9.2f} us | profiler {prof} "
            f"({times['profiler_activities_per_call']:.2f} activities/call)")


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
    """Builds every kernel from the checkout's sources, one ``nvcc`` per
    source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attn import ops as fa_ops
    from repro_torch.kernels.flash_decode import ops as fd_ops
    from repro_torch.kernels.pack import ops as pack_ops
    from repro_torch.kernels.pack_quant import ops as pq_ops
    from repro_torch.kernels.quant import ops as q_ops
    from repro_torch.kernels.reduce_add import ops as ra_ops

    t0 = time.perf_counter()
    sources = [fd_ops.SOURCE, ra_ops.SOURCE, pack_ops.SOURCE, q_ops.SOURCE,
               pq_ops.SOURCE, fa_ops.SOURCE, fa_ops.WGMMA_SOURCE]
    with ThreadPoolExecutor(len(sources)) as pool:
        built = list(pool.map(_build.build, sources))
    fd_ops._kernel_fn()
    ra_ops._kernel_fn()
    pack_ops._kernel_fns()
    q_ops._kernel_fns()
    pq_ops._kernel_fns()
    fa_ops._kernel_fn()
    fa_ops._wgmma_fn()
    log(f"[build] {', '.join(path.name for path, _ in built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for _, report in built:
        for line in report.splitlines():
            if any(w in line.lower() for w in ("registers", "spill", "error",
                                               "warning")):
                log(f"[build]   {line.strip()}")


def phase_kernel(dev) -> float:
    """Kernel vs plain version; returns the largest |difference|."""
    import torch

    from repro_torch.kernels.flash_decode import ops, ref

    bf16, f32 = torch.bfloat16, torch.float32
    # name, d, kv dtype, q dtype, Hq, Hkv, L, which rows have invalid runs:
    # "row" a row with no valid key, "splits" runs across the cluster's
    # splits (a whole split, all but one key, one boundary) and a row with
    # no valid key
    cases = [
        ("serve", 64, bf16, bf16, 32, 32, 208, None),
        ("gqa", 64, bf16, bf16, 32, 8, 208, None),
        ("one_tile", 64, bf16, bf16, 32, 32, 80, None),
        ("fp32_cache", 64, f32, f32, 32, 32, 208, None),
        ("no_valid_row", 64, bf16, bf16, 32, 32, 208, "row"),
        ("d16", 16, bf16, f32, 16, 2, 200, None),
        ("d128", 128, f32, bf16, 8, 2, 131, None),
        ("long_gqa", 64, bf16, bf16, 32, 8, 16384, None),
        ("long_invalid", 64, bf16, bf16, 32, 8, 16384, "splits"),
        ("long_one_kv", 64, bf16, bf16, 32, 1, 16384, None),
        ("one_key", 64, bf16, bf16, 32, 8, 1, None),
        ("one_key_one_kv", 64, bf16, bf16, 32, 1, 1, "row"),
        ("one_kv", 64, bf16, bf16, 32, 1, 208, None),
    ]
    sms = ops._sm_count(dev.index or 0)
    worst = 0.0
    for i, (name, d, dt, qdt, hq, hkv, length, empty) in enumerate(cases):
        q, k, v, valid = kernel_inputs(dev, i, 4, hq, hkv, length, d, dt, qdt)
        shape = ops.launch_shape(4, hq, hkv, length, d, k.element_size(),
                                 sms)
        if empty == "row":
            valid[2] = False
        elif empty == "splits":
            splits = shape[4]
            if splits < 3:
                raise AssertionError(f"[kernel] {name}: a cluster of "
                                     f"{splits}, expected 3 or more")
            tile = ops.TILE_BYTES // (d * k.element_size())
            tiles = -(-length // tile)
            cut = [tiles * c // splits * tile for c in range(1, splits)]
            valid[:] = True
            valid[0, cut[0] - 100:cut[1] + 100] = False
            valid[1, :cut[-1] + 7] = False
            valid[1, cut[-1] + 8:] = False
            valid[2] = False
            valid[3, cut[0] - 1:cut[0] + 1] = False
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
        if empty == "splits" and not torch.all(got[1][:2] > ref.NEG_INF):
            raise AssertionError(f"[kernel] {name}: an all-invalid split "
                                 f"was not cleared")
        worst = max(worst, err)
        log(f"[kernel] {name:14s} d={d} {str(dt)[6:]:8s} Hq={hq} Hkv={hkv} "
            f"L={length} (route, heads per warp, head warps, head chunks, "
            f"cluster) {shape}: max |kernel - plain| {err:.3e}, bitwise "
            f"rerun ok")
    return worst


def phase_serve(dev):
    import torch

    from repro_torch.kernels.flash_decode import ops
    from repro_torch.launch import serve

    # the K/V head counts the engine hands the kernel: its step looks the
    # wrapper up when it is built
    kv_heads = set()
    wrapper = ops.flash_decode_stats

    def seen(q, k, v, valid):
        kv_heads.add((q.shape[1], k.shape[1], v.shape[1]))
        return wrapper(q, k, v, valid)

    args = serve.parser().parse_args(SERVE_ARGS)
    ops.flash_decode_stats = seen
    try:
        run = serve.setup_paged(args)
    finally:
        ops.flash_decode_stats = wrapper
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
    reset_launch_counters()
    results = serve.serve_policies(run, ["continuous", "static"])
    launches = ops.LAUNCHES
    eng.decode = step
    steps = sum(r["steps"] for r in results.values())
    if launches != steps * cfg.num_layers:
        raise AssertionError(f"[serve] {launches} kernel launches for {steps} "
                             f"steps x {cfg.num_layers} layers")
    if kv_heads != {(a.num_heads, a.num_kv_heads, a.num_kv_heads)}:
        raise AssertionError(f"[serve] the kernel was handed (q, k, v) heads "
                             f"{sorted(kv_heads)}, expected K/V unexpanded "
                             f"at {a.num_kv_heads} kv heads")
    if not bool(finite):
        raise AssertionError("[serve] non-finite logits")
    for policy, r in results.items():
        log(f"[serve] {policy}: {r['steps']} steps, {r['generated_tokens']} "
            f"tokens, {r['tokens_per_s']:.1f} tok/s, arena "
            f"{plan.total_bytes} B ({plan.n_kv_pages} pages)")
    log(f"[serve] kernel launches {launches} == {steps} steps x "
        f"{cfg.num_layers} layers, every one handed K/V unexpanded: (q, k, "
        f"v) heads {sorted(kv_heads)}")
    return {"launches": launches, "steps": steps, "policies": results,
            "arena_bytes": plan.total_bytes,
            "kv_heads": sorted(kv_heads)}, run


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
    """Time per call of the flash-decode kernel, its plain version and
    PyTorch's ``scaled_dot_product_attention`` (``enable_gqa``, a boolean
    mask; yardstick only) at the serve path's shape (K/V unexpanded, 8 kv
    heads), at the shape the engine passed before it handed the kernel
    unexpanded K/V (32 kv heads), and at long context (L = 16384, K/V
    past the L2), beside the bound the card's memory rate sets.  Returns
    the serve path's row, with the others under ``"rows"``."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.flash_decode import ops, ref

    b, hq, d = 4, 32, 64
    rows = {}
    launches = ops.LAUNCHES
    for name, hkv, length, iters in (("serve_gqa", 8, 208, 200),
                                     ("serve_expanded", 32, 208, 200),
                                     ("long_gqa", 8, 16384, 20)):
        q, k, v, valid = kernel_inputs(dev, 99, b, hq, hkv, length, d,
                                       torch.bfloat16, torch.bfloat16)
        if length > 208:
            valid[:] = True            # a long cache, every position written
        mask = valid[:, None, None, :]
        calls = {
            "kernel": lambda: ops.flash_decode_stats(q, k, v, valid),
            "plain": lambda: ref.decode_stats(q, *ops._expand_gqa(q, k, v),
                                              valid),
            "library": lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True),
        }
        times = {n: call_times(f, iters) for n, f in calls.items()}
        nbytes = sum(t.numel() * t.element_size()
                     for t in (q, k, v, valid)) + b * hq * (d + 2) * 4
        flops = 4 * b * hq * length * d    # q.k and p.v, multiply-add = 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOPS_PER_S * 1e3
        row = {"ms": times["kernel"]["graph_ms"],
               "plain_ms": times["plain"]["graph_ms"],
               "library_ms": times["library"]["graph_ms"],
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "bytes": nbytes,
               "launch_shape": ops.launch_shape(
                   b, hq, hkv, length, d, 2, ops._sm_count(dev.index or 0)),
               "times": times}
        rows[name] = row
        where = ("L2-resident" if nbytes < L2_BYTES else
                 "K/V past the L2")
        log(f"[timing] flash_decode {name}: B={b} Hq={hq} Hkv={hkv} "
            f"L={length} D={d} bf16 ({nbytes} B, {where}), cluster of "
            f"{row['launch_shape'][4]}; time per call; bound "
            f"{row['bound_ms'] * 1e3:.2f} us ({row['bound_by']}), "
            f"{row['bound_ms'] / row['ms']:.3f} of it, "
            f"{row['ms'] / row['library_ms']:.3f}x SDPA:")
        for n, t in times.items():
            log(times_line(n, t))
        del q, k, v, valid, mask
    ops.LAUNCHES = launches            # timing launches are not the path's
    return {**{k: rows["serve_gqa"][k] for k in (
        "ms", "plain_ms", "library_ms", "bound_ms", "bound_by")},
        "rows": rows}


def phase_profile(dev, run) -> dict:
    """Where a full-batch decode step's time goes: host wall per step,
    device busy time per step, and the device's top activities."""
    from repro_torch.kernels.flash_decode import ops

    eng = run.engine
    for s in range(run.plan.max_seqs):
        eng.admit(s)
    tok = [1] * run.plan.max_seqs
    eng.decode(run.params, tok)                 # the profile's warm-up
    launches = ops.LAUNCHES
    wall, by_name, counts = device_activity(
        lambda: eng.decode(run.params, tok), 10, warm=False)
    launched = ops.LAUNCHES - launches
    for s in range(run.plan.max_seqs):
        eng.retire(s)
    if not by_name:
        raise RuntimeError("[profile] no device activity in a decode step")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    seen = port_kernels_seen(counts)
    # the K/V expansion before the kernel (PERF.md section 5): index_select
    select = {n: ms for n, ms in by_name.items() if "indexSelect" in n}
    n_select = sum(c for n, c in counts.items() if "indexSelect" in n) / 10
    log(f"[profile] decode step, {run.plan.max_seqs} live slots: wall "
        f"{wall:.2f} ms, device busy {busy:.3f} ms, idle share "
        f"{1 - busy / wall:.3f}; the profiler recorded {seen} of the "
        f"{launched} flash-decode launches")
    for name, ms in top:
        log(f"[profile]   {ms * 1e3:9.1f} us/step  {name[:90]}")
    log(f"[profile] index_select kernels: {n_select:.1f} per step, "
        f"{sum(select.values()) * 1e3:.1f} us/step")
    return {"step_wall_ms": wall, "step_device_ms": busy,
            "idle_share": 1 - busy / wall,
            "index_select_per_step": n_select,
            "index_select_ms_per_step": sum(select.values()),
            "port_kernels": {"launched": launched, "recorded": seen},
            "top_device_ms_per_step": dict(top)}


TRAIN_ARGS = ["--arch", ARCH, "--dp-mode", "replicated", "--transport",
              "ring_hier", "--use-arena", "--seq", "256", "--batch", "8",
              "--steps", "3", "--device", "cuda", "--seed", "0"]
# two ranks on one 80 GB card: full width, depth cut to 4 layers
RING_ARGS = TRAIN_ARGS + ["--layers", "4"]
INT8_ARGS = ["--wire-codec", "int8"]
# the same run with no --dp-mode: llama3.2-1b's own full-size default,
# zero1, resolves.  Two zero1 ranks fit on the card at the model's full
# depth with this phase's checks (33.4 GiB a rank at the peak on an 80 GB
# H100); the phase runs first, while this process holds nothing there
ZERO1_ARGS = [a for i, a in enumerate(TRAIN_ARGS)
              if "--dp-mode" not in TRAIN_ARGS[max(i - 1, 0):i + 1]]
ZERO1_RING_LAYERS = 16
ZERO1_RING_ARGS = ZERO1_ARGS + ["--layers", str(ZERO1_RING_LAYERS)]
ZERO1_INT8_ARGS = ZERO1_ARGS + ["--layers", "4"] + INT8_ARGS
MANY_BLOCKS = 500_000      # the kernel checks' largest block count


def params_digest(tree) -> list[int]:
    """A 64-bit digest of each leaf's bytes, computed on the card in chunks
    of 2^24 words: equal leaves give equal digests, and two leaves that
    differ give equal ones with a chance of about 2^-64."""
    import torch

    from repro_torch import tree as tree_util

    out = []
    for t in tree_util.leaves(tree):
        words = t.detach().reshape(-1).view(torch.uint8)
        words = words.view(torch.int32) if words.numel() % 4 == 0 else words
        h = 0
        for lo in range(0, words.numel(), 1 << 24):
            w = words[lo:lo + (1 << 24)].long()
            idx = torch.arange(lo, lo + w.numel(), device=w.device)
            h += int(torch.sum((w + 1) * (idx * 2654435761 % 2147483629
                                          + 1)).item())
        out.append(h)
    return out


def kernel_vs_plain_step(step, state, batch, device, *,
                         shared: bool = True) -> dict:
    """One step of ``step`` through the kernels and through the plain
    versions, from the same state.  With ``shared``, from the same local
    gradients too (one backward pass: autograd's scatter-add backward is
    not bitwise reproducible from run to run on the card, which would hide
    what is compared); fsdp's ring gather reduce-scatters inside the
    backward pass, so there each step takes its own (``shared=False``,
    under deterministic algorithms).  The plain step gets a copy of "ef",
    which a step reads and updates in place; the arena it shares (a step
    writes every segment before reading it, and neither step writes its
    padding).  Compares, bitwise, by :func:`params_digest` on the card:
    what the reduction returned (the reduced tree, zero1's shards taken
    before they are clipped, or fsdp's gradient shards), the new parameters
    (fsdp: the new shards), the new "ef" and the gradient norm."""
    import dataclasses

    from repro_torch.runtime.train_step import TrainStep

    key = "groups" if step.fsdp is not None else "params"
    plain = TrainStep(step.model, step.comm.mesh, dataclasses.replace(
        step.cfg, comm=dataclasses.replace(step.cfg.comm,
                                           local_op="plain")),
        device=device)
    plain_state = dict(state, **{k: state[k].clone()
                                 for k in ("ef",) if k in state})
    digests = {"reduced": [], "params": [], "ef": [], "grad_norm": []}
    if shared:
        # one microbatch: each step asks for the local gradients once, and
        # the plain step takes the last reference, so that they are freed
        # as soon as its reduction has packed them
        local = [step._grad_fn(state[key],
                               {k: v.to(device) for k, v in batch.items()})]
        step._grad_fn = lambda params, mb: local[0]
        plain._grad_fn = lambda params, mb: local.pop()

    def keep_reduced(s):
        reduce = s.comm.reduce_scheduled

        def wrapped(*a, **kw):
            loss, out = reduce(*a, **kw)
            digests["reduced"].append(params_digest(out[0]))
            return loss, out
        s.comm.reduce_scheduled = wrapped

    for s in (step, plain):
        keep_reduced(s)
    try:
        for s, st in ((step, state), (plain, plain_state)):
            new, metrics = s(st, batch)
            digests["params"].append(params_digest(new[key]))
            digests["ef"].append(params_digest(new.get("ef", [])))
            digests["grad_norm"].append(float(metrics["grad_norm"]))
            del new
    finally:
        step.__dict__.pop("_grad_fn", None)
        del step.comm.reduce_scheduled
    differ = [k for k, (a, b) in digests.items() if a != b]
    return {"bitwise": not differ, "differ": differ,
            "max_diff": 0.0 if not differ else float("nan")}


def step_profile(trainer, rank: int, world: int, profiled: bool) -> dict:
    """One more step of ``trainer`` (every rank must take it); with
    ``profiled`` its wall time, device busy time and idle share, and how
    many of the step's launches of the port's kernels the profiler
    recorded."""
    from repro_torch.runtime.train_step import shard_batch

    batch = shard_batch(trainer.data.batch_at(trainer.state["step"]), rank,
                        world)

    def one():
        trainer.state, m = trainer.step_fn(trainer.state, batch)
        float(m["loss"])

    if not profiled:
        one()
        return {}
    launches = sum(launch_counters().values())
    wall, by_name, counts = device_activity(one, 1, warm=False)
    launched = sum(launch_counters().values()) - launches
    if not by_name:
        raise RuntimeError("the profiler recorded no device activity in a "
                           "train step")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    return {"step_wall_ms": wall, "step_device_ms": busy,
            "idle_share": 1 - busy / wall,
            "port_kernels": {"launched": launched,
                             "recorded": port_kernels_seen(counts)},
            "top_device_ms": {k[:90]: v for k, v in top}}


def _check_full_width(cfg, layers: int, what: str) -> None:
    a = cfg.attn
    got = (cfg.num_layers, cfg.d_model, a.num_heads, a.num_kv_heads,
           a.head_dim, cfg.d_ff, cfg.vocab_size)
    if got != (layers, 2048, 32, 8, 64, 8192, 128256):
        raise AssertionError(f"[{what}] not llama3.2-1b at full width: {got}")


def phase_kernels_train(dev) -> dict:
    """The ring's add and the arena's copies against their plain versions
    on the card, bitwise, and run to run."""
    import torch

    from repro_torch.kernels.pack import ops as pk
    from repro_torch.kernels.pack import ref as pk_ref
    from repro_torch.kernels.reduce_add import ops as ra
    from repro_torch.kernels.reduce_add import ref as ra_ref

    def gap(x, y) -> float:
        return (x.float() - y.float()).abs().max().item() if x.numel() else 0.0

    gen = torch.Generator(device=dev).manual_seed(7)
    f32, bf16 = torch.float32, torch.bfloat16
    err = {"reduce_add": 0.0, "pack_write": 0.0, "pack_read": 0.0}
    n_add = 0
    # the kernel's tile is 4096 elements (8192 with a bf16 operand): one
    # tile, one tile +- 1, and many tiles with a ragged tail
    tiles = (4095, 4096, 4097, 8191, 8192, 8193, 2**26 + 5)
    for n in (1024, 37 * 1024, 4096 * 1024, 1000, 7) + tiles:
        for at, bt, ot in ((f32, f32, f32), (bf16, f32, f32),
                           (f32, f32, bf16)):
            a = torch.randn(n + 1, generator=gen, device=dev).to(at)
            b = torch.randn(n + 1, generator=gen, device=dev).to(bt)
            for start in (0, 1):              # 1: an unaligned start
                x, y = a[start:start + n], b[start:start + n]
                got = ra.add_accum(x, y, out_dtype=ot)
                again = ra.add_accum(x, y, out_dtype=ot)
                want = ra_ref.add_accum(x, y, out_dtype=ot)
                torch.cuda.synchronize(dev)
                diff = gap(got, want)
                err["reduce_add"] = max(err["reduce_add"], diff)
                if not (torch.equal(got, again) and torch.equal(got, want)):
                    raise AssertionError(
                        f"[kernels] reduce_add n={n} {at}+{bt}->{ot} "
                        f"start={start}: not bitwise (max |diff| "
                        f"{diff:.3e})")
                n_add += 1
    page = 2 * 2**20 // 4                     # fp32 elements per 2 MiB
    stage = pk.bulk_stage_bytes() // 4        # fp32 elements per bulk stage
    n_pack = 0
    start = pack_routes()
    routes = dict(start)
    # (arena dtype, offset, n, source dtype, source shift in elements, the
    # write's route); every read takes the bulk route
    for arena_dt, off, n, src_dt, shift, way in (
            (f32, 0, 3 * page, f32, 0, "bulk"),
            (f32, 2 * page, page + 1000, f32, 0, "bulk"),
            (f32, 4 * page + 13, 1000, f32, 0, "vector"),
            (bf16, page, 2 * page, f32, 0, "vector"),
            (bf16, 3, 777, f32, 0, "vector"),
            (bf16, 2 * page, 5000, bf16, 0, "bulk"),
            # the bulk route around its stage: 1 element, below one stage,
            # one stage, one stage + 1; a head misaligned alike on both
            # sides, every block walking its ring many times to a ragged
            # tail (256 MiB)
            (f32, page, 1, f32, 0, "bulk"),
            (f32, page, stage - 5, f32, 0, "bulk"),
            (f32, page, stage, f32, 0, "bulk"),
            (f32, page, stage + 1, f32, 0, "bulk"),
            (f32, page + 1, 2**26 + 5, f32, 1, "bulk"),
            (bf16, page + 3, 2**25 + 7, bf16, 3, "bulk"),
            # the vector route: same type, addresses not congruent mod 16
            # bytes (source elements 1, 2 and 3 past the destination's
            # 4-element boundaries, a head shorter than that shift, bf16
            # congruent mod 8 only); casts both ways, shifted and not;
            # copies too short for one vector
            (f32, page, 2**25 + 3, f32, 1, "vector"),
            (f32, page, 2**25 + 3, f32, 3, "vector"),
            (f32, page + 2, 2**25 + 5, f32, 0, "vector"),
            (bf16, page + 4, 2**25 + 3, bf16, 0, "vector"),
            (bf16, page + 2, 2**25 + 3, bf16, 1, "vector"),
            (bf16, page + 1, 2**25 + 3, f32, 0, "vector"),
            (f32, page + 2, 2**25 + 3, bf16, 2, "vector"),
            (f32, page + 1, 2**25 + 3, bf16, 0, "vector"),
            (f32, page, 9, f32, 1, "vector"),
            (bf16, page + 1, 7, f32, 0, "vector")):
        arena = torch.randn(max(8 * page, off + n), generator=gen,
                            device=dev).to(arena_dt)
        src = torch.randn(n + shift, generator=gen,
                          device=dev).to(src_dt)[shift:]
        if pk.route(arena[off:off + n], src) != way:
            raise AssertionError(f"[kernels] pack write {arena_dt} <- "
                                 f"{src_dt} at {off}+{n}, source +{shift}: "
                                 f"route {pk.route(arena[off:off + n], src)}"
                                 f", expected {way}")
        before = arena.clone()
        want = pk_ref.write_flat(before.clone(), src, off)
        got = pk.write_flat(arena, src, off)
        again = pk.write_flat(before.clone(), src, off)
        reads = [pk.read_flat(got, off, n), pk.read_flat(got, off, n),
                 pk_ref.read_flat(got, off, n)]
        torch.cuda.synchronize(dev)
        err["pack_write"] = max(err["pack_write"], gap(got, want))
        err["pack_read"] = max(err["pack_read"], gap(reads[0], reads[2]))
        if got.data_ptr() != arena.data_ptr():
            raise AssertionError("[kernels] pack write did not write in "
                                 "place")
        if not (torch.equal(got, want) and torch.equal(got, again)):
            raise AssertionError(f"[kernels] pack write {arena_dt} <- "
                                 f"{src_dt} at {off}+{n} ({way}): not "
                                 f"bitwise")
        if not (torch.equal(reads[0], reads[1])
                and torch.equal(reads[0], reads[2])):
            raise AssertionError(f"[kernels] pack read at {off}+{n}: not "
                                 f"bitwise")
        routes[way] += 2
        routes["bulk"] += 2
        n_pack += 1
        del arena, src, before, want, got, again, reads
    if pack_routes() != routes or any(routes[k] == start[k]
                                      for k in routes):
        raise AssertionError(f"[kernels] pack launches by route "
                             f"{pack_routes()}, expected {routes}, both "
                             f"routes launched")
    log(f"[kernels] reduce_add: {n_add} cases (fp32+fp32->fp32, "
        f"bf16+fp32->fp32, fp32+fp32->bf16; n = 1024*k, 1000, 7, one tile "
        f"and one tile +- 1 (4096 and 8192), 2^26 + 5; aligned and "
        f"unaligned starts) bitwise equal to the plain version and run to "
        f"run")
    log(f"[kernels] pack write/read: {n_pack} cases (2 MiB-aligned and odd "
        f"offsets, fp32 and bf16 arenas, casts both ways, sources shifted "
        f"1-3 elements off, 1 element to 2^26 + 5 around the bulk stage of "
        f"{stage} fp32 elements) bitwise "
        f"equal to the plain versions and run to run; launches by route "
        f"{ {k: routes[k] - start[k] for k in routes} }")
    return {"reduce_add_cases": n_add, "pack_cases": n_pack,
            "pack_routes": {k: routes[k] - start[k] for k in routes},
            "max_abs_err": err}


def phase_train(dev):
    """One rank, full llama3.2-1b through the train CLI's setup: replicated,
    ring_hier, chunks 2, the arena on, 3 steps.  Returns its numbers and
    the arena layout."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(TRAIN_ARGS)
    world = launch_train.init_distributed(args.device)
    run = launch_train.setup(args, world)
    _check_full_width(run.model.cfg, 16, "train")
    trainer = run.trainer
    step = trainer.step_fn
    layout = step.arena.layout
    ptr = trainer.state["arena"].data_ptr()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    hist = trainer.run()["history"]
    counts = launch_counters()
    routes = pack_routes()
    launches = {"write": counts["pack_write"], "read": counts["pack_read"]}
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train] non-finite loss: {losses}")
    if trainer.state["arena"].data_ptr() != ptr:
        raise AssertionError("[train] the arena moved between steps")
    want = layout.n_segments * args.steps
    if counts != dict(dict.fromkeys(counts, 0), pack_write=want,
                      pack_read=want):
        raise AssertionError(f"[train] launches {counts}, expected {want} "
                             f"pack writes and reads ({layout.n_segments} "
                             f"segments x {args.steps} steps) and no other")
    if routes != {"bulk": 2 * want, "vector": 0}:
        raise AssertionError(f"[train] pack launches by route {routes}, "
                             f"expected all {2 * want} on the bulk route")
    peak = torch.cuda.max_memory_allocated(dev)
    prof = step_profile(trainer, 0, 1, profiled=True)
    out = {"losses": losses, "step_s": [h["sec"] for h in hist],
           "launches": launches, "pack_routes": routes,
           "n_segments": layout.n_segments,
           "n_spans": layout.n_spans, "arena_bytes": layout.total_bytes,
           "arena_pages": layout.n_pages,
           "padding_fraction": layout.padding_fraction,
           "max_segment": max(seg.size for seg in layout.segments),
           "peak_bytes": peak, "params": run.model.param_count(),
           "profile": prof}
    log(f"[train] llama3.2-1b 16 layers, 1 rank, arena "
        f"{layout.total_bytes} B ({layout.n_pages} pages, padding "
        f"{layout.padding_fraction:.4f}), {layout.n_segments} segments: "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; step wall "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms; pack "
        f"launches {launches} == {layout.n_segments} x {args.steps}, by "
        f"route {routes}; arena data_ptr stable; peak "
        f"{peak / 2**30:.1f} GiB")
    log(f"[train] profiled step: wall {prof['step_wall_ms']:.1f} ms, device "
        f"busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} pack launches")
    del run, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out, layout


def phase_train_int8(dev, fp32_losses: list[float]) -> dict:
    """The train phase's setup with the int8 wire: one rank, full llama3.2-1b
    (16 layers), the int8 arena with error feedback, 3 steps."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(TRAIN_ARGS + INT8_ARGS)
    world = launch_train.init_distributed(args.device)
    run = launch_train.setup(args, world)
    _check_full_width(run.model.cfg, 16, "train_int8")
    trainer = run.trainer
    step = trainer.step_fn
    layout = step.arena.layout
    ptrs = (trainer.state["arena"].data_ptr(), trainer.state["ef"].data_ptr())
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    hist = trainer.run()["history"]
    launches = launch_counters()
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train_int8] non-finite loss: {losses}")
    if (trainer.state["arena"].data_ptr(),
            trainer.state["ef"].data_ptr()) != ptrs:
        raise AssertionError("[train_int8] the arena or ef moved")
    segs, spans = layout.n_segments, layout.n_spans
    # per step: pack_into encodes each segment, each reduced span is
    # re-encoded; each span is decoded before its collective, each segment
    # by unpack.  One rank makes no ring hop, so the codec never runs.
    want = dict.fromkeys(launches, 0)
    want.update(pack_quant_write=(segs + spans) * args.steps,
                pack_quant_read=(spans + segs) * args.steps)
    if launches != want:
        raise AssertionError(f"[train_int8] launches {launches}, expected "
                             f"{want} ({segs} segments, {spans} spans, "
                             f"{args.steps} steps)")
    if losses[0] != fp32_losses[0]:
        raise AssertionError(f"[train_int8] first loss {losses[0]} != the "
                             f"fp32 train phase's {fp32_losses[0]} (same "
                             f"weights, same batch)")
    dloss = [abs(a - b) for a, b in zip(losses, fp32_losses)]
    peak = torch.cuda.max_memory_allocated(dev)
    prof = step_profile(trainer, 0, 1, profiled=True)
    out = {"losses": losses, "step_s": [h["sec"] for h in hist],
           "launches": launches, "n_segments": segs, "n_spans": spans,
           "arena_bytes": layout.total_bytes, "arena_pages": layout.n_pages,
           "padding_fraction": layout.padding_fraction,
           "payload_elems": layout.payload_elems,
           "scale_region_bytes": layout.scale_region_bytes,
           "ef_bytes": layout.payload_elems * 4,
           "max_segment": max(seg.size for seg in layout.segments),
           "block": layout.block, "dloss_vs_fp32": dloss,
           "peak_bytes": peak, "profile": prof}
    log(f"[train_int8] llama3.2-1b 16 layers, 1 rank, int8 arena "
        f"{layout.total_bytes} B ({layout.n_pages} pages, padding "
        f"{layout.padding_fraction:.4f}, scales "
        f"{layout.scale_region_bytes} B), ef {out['ef_bytes']} B, "
        f"{segs} segments / {spans} spans: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; |loss - fp32 loss| "
        f"{', '.join(f'{x:.2e}' for x in dloss)}; step wall "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms; peak "
        f"{peak / 2**30:.1f} GiB")
    log(f"[train_int8] launches write_quant {launches['pack_quant_write']} "
        f"and read_dequant {launches['pack_quant_read']} == "
        f"({segs} + {spans}) x {args.steps}, quantize 0; arena and ef "
        f"data_ptr stable; first loss == the fp32 phase's")
    log(f"[train_int8] profiled step: wall {prof['step_wall_ms']:.1f} ms, "
        f"device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} write_quant/read_dequant "
        f"launches")
    del run, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _train_run(argv: list[str], what: str,
               step_overrides: dict | None = None):
    """``launch.train``'s setup of one rank from ``argv``, at full width
    and 16 layers."""
    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(argv)
    world = launch_train.init_distributed(args.device)
    run = launch_train.setup(args, world, step_overrides=step_overrides)
    _check_full_width(run.model.cfg, 16, what)
    return args, run


def phase_train_zero1(dev, fp32_losses: list[float]) -> dict:
    """The train phase's run with no ``--dp-mode``: one rank, full
    llama3.2-1b (16 layers), the arch's own default resolving to zero1,
    the arena on, 3 steps; then the kernel step against the plain step and
    one profiled step.

    Its losses are held against a replicated run of the same seed and
    batches made here first, both under ``torch.use_deterministic_
    algorithms``: the backward of the index ops (the GQA gather's
    ``index_add_``, the embedding lookup's) adds with atomics, which moved
    the train phase's third loss by up to 7.5e-4 from one run to the next.
    The first two losses are the train phase's bitwise (the learning rate
    is 0 at step 0, so the weights do not move)."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_step import shard_batch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, run = _train_run(TRAIN_ARGS, "train_zero1")
        ref = run.trainer.run()["history"]
        del run
        gc.collect()
        torch.cuda.empty_cache()
        args, run = _train_run(ZERO1_ARGS, "train_zero1")
        mode = launch_train.resolve_dp_mode(args)
        if mode != "zero1" or args.dp_mode is not None:
            raise AssertionError(f"[train_zero1] --dp-mode {args.dp_mode}, "
                                 f"resolved {mode!r}: expected llama3.2-1b's "
                                 f"default, zero1")
        trainer = run.trainer
        step = trainer.step_fn
        if step.cfg.dp_mode != "zero1":
            raise AssertionError(f"[train_zero1] the step runs "
                                 f"{step.cfg.dp_mode}")
        layout = step.arena.layout
        segs, spans = layout.n_segments, layout.n_spans
        if step.shard_sizes != [sp.size for sp in layout.spans]:
            raise AssertionError("[train_zero1] at one rank every optimizer "
                                 "shard is a whole span")
        ptr = trainer.state["arena"].data_ptr()
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counters()
        hist = trainer.run()["history"]
        counts = launch_counters()
        routes = pack_routes()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        torch.use_deterministic_algorithms(False)
    losses = [h["loss"] for h in hist]
    ref_losses = [h["loss"] for h in ref]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train_zero1] non-finite loss: {losses}")
    dloss = [abs(a - b) for a, b in zip(losses, ref_losses)]
    if max(dloss) > 5e-5:
        raise AssertionError(f"[train_zero1] losses {losses} against the "
                             f"replicated run's {ref_losses}: |difference| "
                             f"{dloss} > 5e-5")
    if losses[:2] != fp32_losses[:2]:
        raise AssertionError(f"[train_zero1] first losses {losses[:2]} != "
                             f"the train phase's {fp32_losses[:2]}")
    dtrain = [abs(a - b) for a, b in zip(losses, fp32_losses)]
    if trainer.state["arena"].data_ptr() != ptr:
        raise AssertionError("[train_zero1] the arena moved between steps")
    # per step: pack_into writes each segment; one rank makes no ring hop,
    # so the reduce-scatter hands the spans to AdamW as they are and the
    # all-gather hands the delta spans back; unpack_spans reads each
    # segment out of them.  Every copy is a bulk copy.
    want = dict.fromkeys(counts, 0)
    want.update(pack_write=segs * args.steps, pack_read=segs * args.steps)
    if counts != want:
        raise AssertionError(f"[train_zero1] launches {counts}, expected "
                             f"{want} ({segs} segments x {args.steps} steps "
                             f"each way, the reads those of the delta "
                             f"spans)")
    if routes != {"bulk": 2 * segs * args.steps, "vector": 0}:
        raise AssertionError(f"[train_zero1] pack launches by route "
                             f"{routes}, expected all "
                             f"{2 * segs * args.steps} bulk")
    batch = shard_batch(trainer.data.batch_at(trainer.state["step"]), 0, 1)
    same = kernel_vs_plain_step(step, trainer.state, batch, dev)
    if not same["bitwise"]:
        raise AssertionError(f"[train_zero1] kernel step and plain step "
                             f"differ: {same['differ']}")
    prof = step_profile(trainer, 0, 1, profiled=True)
    opt_bytes = sum(t.numel() * t.element_size()
                    for k in ("mu", "nu") for t in trainer.state["opt"][k])
    out = {"dp_mode": mode, "losses": losses,
           "replicated_losses": ref_losses, "dloss_vs_replicated": dloss,
           "dloss_vs_train_phase": dtrain,
           "replicated_step_s": [h["sec"] for h in ref],
           "step_s": [h["sec"] for h in hist], "launches": counts,
           "pack_routes": routes, "n_segments": segs, "n_spans": spans,
           "opt_bytes": opt_bytes, "peak_bytes": peak,
           "max_diff": same["max_diff"], "profile": prof}
    log(f"[train_zero1] llama3.2-1b 16 layers, 1 rank, --dp-mode unset -> "
        f"{mode}; {spans} optimizer shards ({opt_bytes} B of moments): "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; |loss - "
        f"replicated loss| {', '.join(f'{x:.2e}' for x in dloss)} (both "
        f"deterministic), |loss - train phase's| "
        f"{', '.join(f'{x:.2e}' for x in dtrain)}; step wall "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms (the "
        f"deterministic replicated run: "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in ref)} ms); peak "
        f"{peak / 2**30:.1f} GiB")
    log(f"[train_zero1] pack launches write {counts['pack_write']} and read "
        f"{counts['pack_read']} == {segs} x {args.steps} each (the reads "
        f"are the delta spans'), by route {routes}; arena data_ptr stable; "
        f"kernel step == plain-version step, shards and params bitwise")
    log(f"[train_zero1] profiled step: wall {prof['step_wall_ms']:.1f} ms, "
        f"device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} pack launches")
    del run, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _deterministic(torch) -> None:
    """Deterministic algorithms for a two-rank worker, without their fill
    of every ``torch.empty`` tensor: the fill writes each staging buffer in
    pinned host memory once more, which multiplies the staging time."""
    torch.use_deterministic_algorithms(True, warn_only=True)
    torch.utils.deterministic.fill_uninitialized_memory = False


def _ring_worker(argv: list[str]) -> dict:
    """One of two ranks of the train_ring phases (a spawned process): the
    fp32 arena, or with ``--wire-codec int8`` the int8 arena, and then,
    under the int8 wire or zero1, one step with the arena off
    (:func:`_bucket_pass`)."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.core.ring import _channel_slices
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_step import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    args = launch_train.parser().parse_args(argv)
    quant = args.wire_codec is not None
    if launch_train.resolve_dp_mode(args) == "zero1":
        # reproducible, so that train_ring_fsdp's losses can be held to
        # these (the index ops' backward adds with atomics otherwise)
        _deterministic(torch)
    world = launch_train.init_distributed(args.device)
    try:
        run = launch_train.setup(args, world)
        _check_full_width(run.model.cfg, args.layers, "train_ring")
        trainer = run.trainer
        step = trainer.step_fn
        comm = step.comm
        zero1 = step.cfg.dp_mode == "zero1"
        layout = step.arena.layout
        p = world.size
        slices = sum(len(_channel_slices(sp.size // p,
                                         comm.transport.ring_cfg))
                     for sp in layout.spans)
        # (no name holds the first state: it would keep its parameters and
        # moments alive through the run)
        kept = [k for k in ("arena", "ef") if k in trainer.state]
        ptrs = [trainer.state[k].data_ptr() for k in kept]
        reset_launch_counters()
        comm.record.reset()
        hist = trainer.run()["history"]
        counts = launch_counters()
        routes = pack_routes()
        record = comm.record.as_dict()
        peak_run = torch.cuda.max_memory_allocated(world.device)
        steps = args.steps
        segs, spans = layout.n_segments, layout.n_spans
        # derived from the code: per step, each span's ring all-reduce runs
        # p - 1 reduce-scatter hops, each adding, and under the int8 codec
        # encoding and decoding, every channel slice, then an all-gather
        # that encodes each slice once and decodes each of the slice's p
        # payloads (its own and p - 1 received) one by one; the fp32 arena
        # packs and unpacks each segment once; the int8 arena encodes each
        # segment (pack, with error feedback) and each reduced span
        # (re-encode) and decodes each span (before its collective) and
        # each segment (unpack).  Zero1 runs the same reduce-scatter hops
        # and an all-gather of the delta shards with the same launches; the
        # shards go to AdamW as they are (no re-encode, no unpack), and
        # the gathered fp32 delta spans are read out segment by segment
        # (unpack_spans: pack reads, under either wire)
        predicted = {"flash_decode": 0, "flash_attn": 0,
                     "reduce_add": slices * (p - 1) * steps,
                     "pack_write": 0 if quant else segs * steps,
                     "pack_read": segs * steps if zero1 or not quant else 0,
                     "quantize": slices * p * steps if quant else 0,
                     "dequantize": slices * (2 * p - 1) * steps if quant
                     else 0,
                     "pack_quant_write": ((segs if zero1 else segs + spans)
                                          * steps if quant else 0),
                     "pack_quant_read": ((spans if zero1 else spans + segs)
                                         * steps if quant else 0)}
        # every pack copy is a bulk copy
        predicted_routes = {"bulk": predicted["pack_write"]
                            + predicted["pack_read"], "vector": 0}
        planned = {"sends": step.plan.arena_messages_per_device * steps,
                   "send_bytes": step.plan.arena_bytes_per_device * steps}
        losses = [h["loss"] for h in hist]
        stable = [trainer.state[k].data_ptr() for k in kept] == ptrs

        digest = params_digest(trainer.state["params"])
        state = trainer.state
        batch = shard_batch(trainer.data.batch_at(state["step"]),
                            world.rank, p)
        same = kernel_vs_plain_step(step, state, batch, world.device)
        bitwise, max_diff = same["bitwise"], same["max_diff"]
        prof = step_profile(trainer, world.rank, p, profiled=world.rank == 0)
        out = {"backend": world.backend, "dp_mode": step.cfg.dp_mode,
               "layers": args.layers, "losses": losses, "digest": digest,
               "step_s": [h["sec"] for h in hist], "counts": counts,
               "record": record, "predicted": predicted, "planned": planned,
               "pack_routes": routes, "predicted_routes": predicted_routes,
               "stable": stable, "bitwise": bitwise,
               "max_diff": max_diff, "differ": same["differ"],
               "n_spans": spans,
               "n_segments": segs, "arena_bytes": layout.total_bytes,
               "arena_pages": layout.n_pages,
               "padding_fraction": layout.padding_fraction,
               "ef_bytes": (layout.payload_elems * 4 if quant else 0),
               "hop_width": max(sp.size for sp in layout.spans) // p
               // (2 * step.cfg.comm.chunks),
               # every reduce-scatter hop's width, one step's worth
               "hop_widths": sorted(
                   w for sp in layout.spans
                   for _, w, _ in _channel_slices(sp.size // p,
                                                  comm.transport.ring_cfg)),
               "params": run.model.param_count(),
               "peak_run_bytes": peak_run,
               "peak_bytes": torch.cuda.max_memory_allocated(world.device),
               "profile": prof, "bucket": None}
        if quant or zero1:
            trainer.state = state = None
            del run, trainer, step, comm, state
            gc.collect()
            torch.cuda.empty_cache()
            out["bucket"] = _bucket_pass(argv, world)
        return out
    finally:
        dist.destroy_process_group()


def _bucket_pass(argv: list[str], world) -> dict:
    """One step with the arena off: every gradient bucket is all-reduced
    (zero1: reduce-scattered, and its delta shard all-gathered) by the
    ring, whose hops run the codec's kernels under the int8 wire.  Returns
    the launches beside the count the code predicts, the record beside the
    plan and the loss."""
    from repro_torch.core.ring import _channel_slices
    from repro_torch.launch import train as launch_train

    argv = [a for a in argv if a != "--use-arena"]
    argv[argv.index("--steps") + 1] = "1"
    args = launch_train.parser().parse_args(argv)
    run = launch_train.setup(args, world)
    comm = run.trainer.step_fn.comm
    p = world.size
    bplan = run.trainer.step_fn.plan.bucket_plan
    # per bucket: p - 1 reduce-scatter hops, each adding (and under the
    # int8 wire encoding and decoding) every channel slice, then an
    # all-gather that encodes each slice once and decodes each of its p
    # payloads; no pack copy
    slices = sum(len(_channel_slices(n // p, comm.transport.ring_cfg))
                 for n in bplan.bucket_sizes)
    quant = args.wire_codec is not None
    predicted = dict.fromkeys(launch_counters(), 0)
    predicted.update(reduce_add=slices * (p - 1),
                     quantize=slices * p if quant else 0,
                     dequantize=slices * (2 * p - 1) if quant else 0)
    reset_launch_counters()
    comm.record.reset()
    hist = run.trainer.run()["history"]
    counts = launch_counters()
    planned = {"sends": run.trainer.step_fn.plan.messages_per_device,
               # the plan counts the used elements; the wire carries the
               # buckets' padding too, at the same rate
               "send_bytes": round(comm.transport.predicted_bytes_per_device(
                   bplan.total_elems, comm.axis_sizes))}
    return {"loss": hist[0]["loss"], "step_s": hist[0]["sec"],
            "counts": counts, "predicted": predicted,
            "record": comm.record.as_dict(), "planned": planned,
            "n_buckets": bplan.n_buckets}


def card_memory() -> dict:
    """What the card holds before two ranks spawn: MiB in use on the whole
    card and its total (``nvidia-smi``), and the bytes this process's
    allocator reserves, after it has given back its cached blocks (0 while
    it has not touched CUDA; reading it then would start a context)."""
    import gc

    import torch

    reserved = 0
    if torch.cuda.is_initialized():
        gc.collect()
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(0)
    out = subprocess.run(["nvidia-smi", "--query-gpu=memory.used,memory.total",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    used, total = (int(x) for x in out.strip().splitlines()[0].split(","))
    return {"card_used_mib": used, "card_total_mib": total,
            "parent_reserved_bytes": reserved}


def phase_train_ring(argv: list[str], tag: str) -> dict:
    """Two ranks on the one card over gloo, full width at ``--layers``."""
    from repro_torch.launch import train as launch_train

    before = card_memory()
    log(f"[{tag}] before the ranks spawn: {before['card_used_mib']} of "
        f"{before['card_total_mib']} MiB of the card in use, this process's "
        f"allocator reserving {before['parent_reserved_bytes']} B")
    ranks = launch_train.spawn(_ring_worker, 2, argv, timeout=900)
    for r, out in enumerate(ranks):
        if out["backend"] != "gloo":
            raise AssertionError(f"[{tag}] rank {r} backend "
                                 f"{out['backend']}, expected gloo")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"[{tag}] rank {r} non-finite loss")
        if not out["stable"]:
            raise AssertionError(f"[{tag}] rank {r}: the arena moved")
        pred, counts, rec = out["predicted"], out["counts"], out["record"]
        if counts != pred:
            raise AssertionError(f"[{tag}] rank {r} launches {counts} != "
                                 f"predicted {pred}")
        if out["pack_routes"] != out["predicted_routes"]:
            raise AssertionError(f"[{tag}] rank {r} pack launches by route "
                                 f"{out['pack_routes']} != predicted "
                                 f"{out['predicted_routes']}")
        for key in ("sends", "send_bytes"):
            if rec[key] != out["planned"][key]:
                raise AssertionError(f"[{tag}] rank {r} recorded {key} "
                                     f"{rec[key]} != plan "
                                     f"{out['planned'][key]}")
        if not out["bitwise"]:
            raise AssertionError(f"[{tag}] rank {r}: kernel step and "
                                 f"plain step differ: {out['differ']}")
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"[{tag}] the ranks disagree on the loss")
    if ranks[0]["digest"] != ranks[1]["digest"]:
        raise AssertionError(f"[{tag}] the ranks' parameters differ after "
                             f"{len(ranks[0]['losses'])} steps")
    if ranks[0]["dp_mode"] == "zero1" and any(o["bucket"] is None
                                              for o in ranks):
        raise AssertionError(f"[{tag}] zero1 ran no bucket pass")
    for r, out in enumerate(ranks):
        bucket = out["bucket"]
        if bucket is None:
            continue
        if not math.isfinite(bucket["loss"]):
            raise AssertionError(f"[{tag}] bucket pass rank {r}: non-finite "
                                 f"loss")
        if bucket["counts"] != bucket["predicted"]:
            raise AssertionError(f"[{tag}] bucket pass rank {r}: launches "
                                 f"{bucket['counts']} != predicted "
                                 f"{bucket['predicted']}")
        for key in ("sends", "send_bytes"):
            if bucket["record"][key] != bucket["planned"][key]:
                raise AssertionError(
                    f"[{tag}] bucket pass rank {r}: recorded {key} "
                    f"{bucket['record'][key]} != plan "
                    f"{bucket['planned'][key]}")
    out = ranks[0]
    staging = [o["record"]["staging_s"] for o in ranks]
    prof = out["profile"]
    log(f"[{tag}] 2 ranks on one card over gloo, {out['dp_mode']}, "
        f"{out['layers']} layers "
        f"({out['params']} params), arena {out['arena_bytes']} B "
        f"({out['arena_pages']} pages, padding "
        f"{out['padding_fraction']:.4f}), ef {out['ef_bytes']} B, "
        f"{out['n_spans']} spans / {out['n_segments']} segments: losses "
        f"{', '.join(f'{x:.4f}' for x in out['losses'])}; step wall "
        f"{', '.join(f'{x * 1e3:.0f}' for x in out['step_s'])} ms; host "
        f"staging {staging[0]:.2f} / {staging[1]:.2f} s over 3 steps; peak "
        f"{out['peak_run_bytes'] / 2**30:.1f} GiB a rank over the 3 steps, "
        f"{out['peak_bytes'] / 2**30:.1f} GiB with the kernel-vs-plain "
        f"check and the profiled step")
    log(f"[{tag}] launches == predicted "
        f"{ {k: v for k, v in out['predicted'].items() if v} }, pack by "
        f"route {out['pack_routes']} on both ranks; recorded sends "
        f"{out['record']['sends']} and bytes "
        f"{out['record']['send_bytes']} == plan; both ranks' parameters "
        f"bitwise equal after {len(out['losses'])} steps")
    log(f"[{tag}] kernel step == plain-version step, grads and params"
        f"{' and ef' if out['ef_bytes'] else ''} bitwise on both ranks; "
        f"profiled step (rank 0): wall {prof['step_wall_ms']:.1f} ms, "
        f"device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} launches of the port's kernels")
    bucket = out["bucket"]
    if bucket is not None:
        log(f"[{tag}] arena off, 1 step over {bucket['n_buckets']} buckets: "
            f"loss {bucket['loss']:.4f}, step wall "
            f"{bucket['step_s'] * 1e3:.0f} ms; launches == predicted "
            f"{ {k: v for k, v in bucket['predicted'].items() if v} }; "
            f"recorded sends {bucket['record']['sends']} and bytes "
            f"{bucket['record']['send_bytes']} == plan")
    return {"ranks": ranks, "staging_s": staging, "card_before": before}


# fsdp (ZeRO-3): the train phase's run with --dp-mode fsdp; two ranks at
# the full 16 layers over the ring gather (set on the step config the CLI
# builds: the reference's CLI has no flag for it), and over the native
# gather with the int8 arena at 4 layers
FSDP_ARGS = ["fsdp" if a == "replicated" else a for a in TRAIN_ARGS]
FSDP_RING_LAYERS = 16
FSDP_RING_ARGS = FSDP_ARGS + ["--layers", str(FSDP_RING_LAYERS)]
FSDP_INT8_ARGS = FSDP_ARGS + ["--layers", "4"] + INT8_ARGS


def fsdp_expected(step, steps: int, p: int) -> tuple[dict, dict]:
    """What ``steps`` fsdp steps of ``step`` launch and put on the wire,
    derived from its plan and the code, for one data axis of ``p`` ranks.

    Per microbatch every group bucket is gathered once in the forward pass
    and, under ``remat="layer"`` (llama3.2-1b's), a block's once more when
    the backward pass recomputes the block; the backward reduce-scatters
    every bucket once.  The ring gather sends each channel slice of the
    ``n / p``-element shard ``p - 1`` times in the gather dtype (bf16); the
    ring reduce-scatter sends the same slices in fp32 and adds each one it
    receives (``reduce_add``, fp32 + bf16 -> fp32).  The native gather is
    one ``all_gather_into_tensor`` of the shard and one
    ``reduce_scatter_tensor`` of the ``n``-element cotangent, bf16.  The
    arena (the accumulation buffer) packs each gradient shard once and
    reads it once a step: ``pack``, or ``pack_quant`` under the int8
    codec."""
    import torch

    from repro_torch.core.ring import _channel_slices

    plan, comm = step.fsdp, step.comm
    runs = step.schedule.microbatches * steps
    remat = step.model.cfg.remat == "layer"
    item = getattr(torch, step.cfg.gather_dtype).itemsize
    counts = dict.fromkeys(launch_counters(), 0)
    wire = dict.fromkeys(("sends", "send_bytes", "all_gathers",
                          "all_gather_bytes", "reduce_scatters",
                          "reduce_scatter_bytes"), 0)
    if step.arena is not None:
        names = (("pack_quant_write", "pack_quant_read")
                 if comm.codec is not None else ("pack_write", "pack_read"))
        for name in names:
            counts[name] = plan.arena_layout.n_segments * steps
    if p == 1:
        return counts, wire
    for name, bplan in plan.plans.items():
        gathers = 2 if remat and name.startswith("blocks.") else 1
        for n in bplan.bucket_sizes:
            shard = n // p
            if plan.gather_impl == "ring":
                slices = len(_channel_slices(shard, comm.transport.ring_cfg))
                counts["reduce_add"] += slices * (p - 1) * runs
                wire["sends"] += (gathers + 1) * slices * (p - 1) * runs
                wire["send_bytes"] += ((gathers * item + 4) * shard
                                       * (p - 1) * runs)
            else:
                wire["all_gathers"] += gathers * runs
                wire["all_gather_bytes"] += gathers * shard * item * runs
                wire["reduce_scatters"] += runs
                wire["reduce_scatter_bytes"] += n * item * runs
    return counts, wire


def _check_counts(tag: str, counts: dict, expected: dict) -> None:
    if counts != expected:
        raise AssertionError(f"[{tag}] launches {counts} != expected "
                             f"{expected}")


def _check_launches(tag: str, counts: dict, expected: dict,
                    routes: dict) -> None:
    """Launches as expected, every pack copy on the bulk route."""
    _check_counts(tag, counts, expected)
    bulk = expected["pack_write"] + expected["pack_read"]
    if routes != {"bulk": bulk, "vector": 0}:
        raise AssertionError(f"[{tag}] pack launches by route {routes}, "
                             f"expected all {bulk} bulk")


def _fsdp_param_tree(plan, groups: dict) -> dict:
    """One rank's fsdp ``{group: [shards]}`` (whole buckets at world 1) as
    the model's parameter tree."""
    if plan.dp_world != 1:
        raise ValueError("whole buckets need world 1")
    tree: dict = {"blocks": []}
    for name in plan.groups:               # the blocks in layer order
        kind, _, key = name.partition(".")
        group = plan.bucketer.debucketize(groups[name], plan.plans[name])
        if kind == "blocks":
            tree["blocks"].append(group)
        else:
            tree[key] = group
    return tree


def phase_train_fsdp(dev, replicated_losses: list[float]) -> dict:
    """The train phase's run with ``--dp-mode fsdp``: one rank, full
    llama3.2-1b (16 layers), the arena on, 3 steps, under
    ``torch.use_deterministic_algorithms``; then the kernel step against
    the plain step and one profiled step.

    Held against the replicated run of the same seed and batches, both
    deterministic: with ``gather_dtype="float32"`` the fsdp gradients of
    the first batch (the gathers, the remat re-gathers and the
    reduce-scatters, the identity at world 1, in the backward pass) are
    the replicated gradients bitwise, leaf by leaf; with the bf16 gathers
    of the main path the first two losses are the replicated run's
    (train_zero1's) bitwise, before an update moves a weight.  The third
    is reported, not held: the gathered norm scales are bf16 where the
    replicated step's are fp32, and at this learning rate the third loss
    moves visibly under last-bit changes of the parameters (another
    summation order of the gradient norm is enough)."""
    import gc

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.runtime.train_step import shard_batch

    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _, rep = _train_run(TRAIN_ARGS, "train_fsdp")
        batch0 = {k: v.to(dev) for k, v in shard_batch(
            rep.trainer.data.batch_at(0), 0, 1).items()}
        want = rep.trainer.step_fn._grad_fn(rep.trainer.state["params"],
                                            batch0)[1]
        del rep
        gc.collect()
        torch.cuda.empty_cache()
        _, run = _train_run(FSDP_ARGS, "train_fsdp",
                            {"gather_dtype": "float32"})
        step = run.trainer.step_fn
        got = _fsdp_param_tree(step.fsdp, step._grad_fn(
            run.trainer.state["groups"], batch0)[1])
        pairs = list(zip(tree_util.leaves(want), tree_util.leaves(got)))
        grads_equal = sum(int(torch.equal(a, b)) for a, b in pairs)
        n_leaves = len(pairs)
        del run, step, want, got, pairs
        gc.collect()
        torch.cuda.empty_cache()
        args, run = _train_run(FSDP_ARGS, "train_fsdp")
        trainer = run.trainer
        step = trainer.step_fn
        if (step.cfg.dp_mode, step.cfg.fsdp_gather, step.cfg.gather_dtype) \
                != ("fsdp", "native", "bfloat16"):
            raise AssertionError(f"[train_fsdp] the step runs {step.cfg}")
        layout = step.arena.layout
        ptr = trainer.state["arena"].data_ptr()
        expected, _ = fsdp_expected(step, args.steps, 1)
        torch.cuda.reset_peak_memory_stats(dev)
        reset_launch_counters()
        hist = trainer.run()["history"]
        counts = launch_counters()
        routes = pack_routes()
        peak = torch.cuda.max_memory_allocated(dev)
    finally:
        torch.use_deterministic_algorithms(False)
    if grads_equal != n_leaves:
        raise AssertionError(f"[train_fsdp] fp32 gathers: only "
                             f"{grads_equal} of {n_leaves} gradient leaves "
                             f"equal the replicated step's")
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train_fsdp] non-finite loss: {losses}")
    dloss = [abs(a - b) for a, b in zip(losses, replicated_losses)]
    if losses[:2] != replicated_losses[:2]:
        raise AssertionError(f"[train_fsdp] first losses {losses[:2]} != "
                             f"the replicated run's {replicated_losses[:2]}")
    if trainer.state["arena"].data_ptr() != ptr:
        raise AssertionError("[train_fsdp] the arena moved between steps")
    _check_launches("train_fsdp", counts, expected, routes)
    batch = shard_batch(trainer.data.batch_at(trainer.state["step"]), 0, 1)
    same = kernel_vs_plain_step(step, trainer.state, batch, dev)
    if not same["bitwise"]:
        raise AssertionError(f"[train_fsdp] kernel step and plain step "
                             f"differ: {same['differ']}")
    prof = step_profile(trainer, 0, 1, profiled=True)
    segs = layout.n_segments
    out = {"losses": losses, "replicated_losses": replicated_losses,
           "dloss_vs_replicated": dloss,
           "fp32_gather_grad_leaves_equal": [grads_equal, n_leaves],
           "step_s": [h["sec"] for h in hist], "launches": counts,
           "pack_routes": routes, "n_segments": segs,
           "arena_bytes": layout.total_bytes, "peak_bytes": peak,
           "max_diff": same["max_diff"], "profile": prof}
    log(f"[train_fsdp] llama3.2-1b 16 layers, 1 rank, fsdp (native "
        f"gather): with fp32 gathers the first batch's gradients == the "
        f"replicated step's bitwise ({grads_equal} of {n_leaves} leaves); "
        f"bf16 gathers, {segs} group buckets, arena {layout.total_bytes} "
        f"B: losses {', '.join(f'{x:.4f}' for x in losses)}; |loss - "
        f"replicated loss| {', '.join(f'{x:.2e}' for x in dloss)} (the "
        f"first two bitwise; deterministic); step wall "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms; peak "
        f"{peak / 2**30:.1f} GiB")
    log(f"[train_fsdp] pack launches write {counts['pack_write']} and read "
        f"{counts['pack_read']} == {segs} x {args.steps} each, by route "
        f"{routes}; arena data_ptr stable; kernel step == plain-version "
        f"step, gradient shards and shards bitwise")
    log(f"[train_fsdp] profiled step: wall {prof['step_wall_ms']:.1f} ms, "
        f"device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} pack launches")
    del run, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _fsdp_ring_worker(argv: list[str], gather: str) -> dict:
    """One of two ranks of the fsdp two-rank phases (a spawned process):
    3 steps with the arena, the kernel step against the plain step, one
    profiled step and, over the ring gather, one step with the arena off.
    Deterministic algorithms throughout (and cuBLAS's reproducible
    workspace): over the ring gather the reduce-scatter runs inside the
    backward pass, so the kernel and plain steps each run their own."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.core.ring import _channel_slices
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_step import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    _deterministic(torch)
    args = launch_train.parser().parse_args(argv)
    world = launch_train.init_distributed(args.device)
    over = {"fsdp_gather": gather}
    try:
        run = launch_train.setup(args, world, step_overrides=over)
        _check_full_width(run.model.cfg, args.layers, "train_ring_fsdp")
        trainer = run.trainer
        step = trainer.step_fn
        comm = step.comm
        p = world.size
        plan = step.fsdp
        layout = step.arena.layout
        kept = [k for k in ("arena", "ef") if k in trainer.state]
        ptrs = [trainer.state[k].data_ptr() for k in kept]
        predicted, wire = fsdp_expected(step, args.steps, p)
        reset_launch_counters()
        comm.record.reset()
        torch.cuda.reset_peak_memory_stats(world.device)
        hist = trainer.run()["history"]
        counts = launch_counters()
        routes = pack_routes()
        record = comm.record.as_dict()
        peak_run = torch.cuda.max_memory_allocated(world.device)
        stable = [trainer.state[k].data_ptr() for k in kept] == ptrs
        state = trainer.state
        batch = shard_batch(trainer.data.batch_at(state["step"]),
                            world.rank, p)
        same = kernel_vs_plain_step(step, state, batch, world.device,
                                    shared=gather != "ring")
        prof = step_profile(trainer, world.rank, p, profiled=world.rank == 0)
        hop_widths = sorted(
            w for bplan in plan.plans.values() for n in bplan.bucket_sizes
            for _, w, _ in _channel_slices(n // p, comm.transport.ring_cfg))
        out = {"backend": world.backend, "gather": gather,
               "layers": args.layers, "losses": [h["loss"] for h in hist],
               "step_s": [h["sec"] for h in hist], "counts": counts,
               "predicted": predicted, "record": record, "wire": wire,
               "pack_routes": routes, "stable": stable,
               "bitwise": same["bitwise"], "differ": same["differ"],
               "max_diff": same["max_diff"],
               "n_buckets": sum(b.n_buckets for b in plan.plans.values()),
               "n_segments": layout.n_segments,
               "arena_bytes": layout.total_bytes,
               "shard_bytes": 4 * sum(n for sizes in plan.shard_sizes.values()
                                      for n in sizes),
               "hop_widths": hop_widths, "params": run.model.param_count(),
               "peak_run_bytes": peak_run,
               "peak_bytes": torch.cuda.max_memory_allocated(world.device),
               "profile": prof, "bucket": None}
        if gather == "ring":
            trainer.state = state = None
            del run, trainer, step, comm, state
            gc.collect()
            torch.cuda.empty_cache()
            argv = [a for a in argv if a != "--use-arena"]
            argv[argv.index("--steps") + 1] = "1"
            args = launch_train.parser().parse_args(argv)
            run = launch_train.setup(args, world, step_overrides=over)
            step = run.trainer.step_fn
            bpred, bwire = fsdp_expected(step, 1, p)
            reset_launch_counters()
            step.comm.record.reset()
            h = run.trainer.run()["history"][0]
            out["bucket"] = {"loss": h["loss"], "step_s": h["sec"],
                             "counts": launch_counters(),
                             "predicted": bpred, "wire": bwire,
                             "record": step.comm.record.as_dict()}
        return out
    finally:
        dist.destroy_process_group()


def _check_wire(tag: str, record: dict, wire: dict) -> None:
    for key, want in wire.items():
        if record[key] != want:
            raise AssertionError(f"[{tag}] recorded {key} {record[key]} != "
                                 f"expected {want}")


def phase_train_ring_fsdp(argv: list[str], tag: str, gather: str,
                          zero1_losses: list[float] | None = None) -> dict:
    """Two fsdp ranks on the one card over gloo (hops and native
    collectives staged through pinned host memory), full width at
    ``--layers``; when ``zero1_losses`` are given (train_ring_zero1's: the
    same seed, batches and depth, both deterministic), the first two
    losses are those bitwise (the bf16 gathers are zero1's bf16 casts
    before the first update moves a weight; see :func:`phase_train_fsdp`
    for the third)."""
    from repro_torch.launch import train as launch_train

    before = card_memory()
    log(f"[{tag}] before the ranks spawn: {before['card_used_mib']} of "
        f"{before['card_total_mib']} MiB of the card in use, this process's "
        f"allocator reserving {before['parent_reserved_bytes']} B")
    ranks = launch_train.spawn(_fsdp_ring_worker, 2, argv, gather,
                               timeout=900)
    for r, out in enumerate(ranks):
        if out["backend"] != "gloo":
            raise AssertionError(f"[{tag}] rank {r} backend "
                                 f"{out['backend']}, expected gloo")
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"[{tag}] rank {r} non-finite loss")
        if not out["stable"]:
            raise AssertionError(f"[{tag}] rank {r}: the arena moved")
        _check_launches(f"{tag} rank {r}", out["counts"], out["predicted"],
                        out["pack_routes"])
        _check_wire(f"{tag} rank {r}", out["record"], out["wire"])
        if not out["bitwise"]:
            raise AssertionError(f"[{tag}] rank {r}: kernel step and "
                                 f"plain step differ: {out['differ']}")
        bucket = out["bucket"]
        if gather == "ring" and bucket is None:
            raise AssertionError(f"[{tag}] rank {r} ran no bucket pass")
        if bucket is not None:
            if not math.isfinite(bucket["loss"]):
                raise AssertionError(f"[{tag}] bucket pass rank {r}: "
                                     f"non-finite loss")
            _check_counts(f"{tag} bucket pass rank {r}", bucket["counts"],
                          bucket["predicted"])
            _check_wire(f"{tag} bucket pass rank {r}", bucket["record"],
                        bucket["wire"])
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"[{tag}] the ranks disagree on the loss")
    out = ranks[0]
    dloss = None
    if zero1_losses is not None:
        dloss = [abs(a - b) for a, b in zip(out["losses"], zero1_losses)]
        if out["losses"][:2] != zero1_losses[:2]:
            raise AssertionError(f"[{tag}] first losses {out['losses'][:2]}"
                                 f" != train_ring_zero1's "
                                 f"{zero1_losses[:2]}")
    staging = [o["record"]["staging_s"] for o in ranks]
    prof = out["profile"]
    log(f"[{tag}] 2 ranks on one card over gloo, fsdp ({gather} gather), "
        f"{out['layers']} layers ({out['params']} params), "
        f"{out['n_buckets']} group buckets, {out['shard_bytes']} B of fp32 "
        f"shards a rank, arena {out['arena_bytes']} B: losses "
        f"{', '.join(f'{x:.4f}' for x in out['losses'])}"
        + ("" if dloss is None else
           f" (|loss - train_ring_zero1's| "
           f"{', '.join(f'{x:.2e}' for x in dloss)}: the first two bitwise)")
        + f"; step wall {', '.join(f'{x * 1e3:.0f}' for x in out['step_s'])}"
        f" ms; host staging {staging[0]:.2f} / {staging[1]:.2f} s over "
        f"{len(out['losses'])} steps; peak "
        f"{out['peak_run_bytes'] / 2**30:.1f} GiB a rank over the steps, "
        f"{out['peak_bytes'] / 2**30:.1f} GiB with the kernel-vs-plain check "
        f"and the profiled step")
    wire = {k: v for k, v in out["wire"].items() if v}
    log(f"[{tag}] launches == expected "
        f"{ {k: v for k, v in out['predicted'].items() if v} }, pack by "
        f"route {out['pack_routes']}; recorded wire == expected {wire} on "
        f"both ranks; kernel step == plain-version step, gradient shards and "
        f"shards bitwise on both ranks ({'each its own backward pass, '
        'deterministic' if gather == 'ring' else 'one backward pass'})")
    log(f"[{tag}] profiled step (rank 0): wall {prof['step_wall_ms']:.1f} "
        f"ms, device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}; the profiler recorded "
        f"{prof['port_kernels']['recorded']} of the "
        f"{prof['port_kernels']['launched']} launches of the port's kernels")
    bucket = out["bucket"]
    if bucket is not None:
        log(f"[{tag}] arena off, 1 step: loss {bucket['loss']:.4f}, step "
            f"wall {bucket['step_s'] * 1e3:.0f} ms; launches == expected "
            f"{ {k: v for k, v in bucket['predicted'].items() if v} }; "
            f"recorded wire == expected "
            f"{ {k: v for k, v in bucket['wire'].items() if v} }")
    return {"ranks": ranks, "staging_s": staging, "card_before": before,
            "dloss_vs_zero1": dloss}


def phase_prefill_gathered(dev) -> dict:
    """``build_prefill`` with ``weight_mode="gathered"`` on llama3.2-1b at
    full width (16 layers), one rank, B=1, S=4096: the parameters as the
    fsdp plan's flat shards, gathered in bf16 at the call.  Launches the
    wgmma flash-attention kernel once per layer and nothing else; its
    logits held against the resident prefill of the same weights and tokens
    within the engine's bf16 tolerance (the gathered norm weights are bf16
    where the resident ones are fp32)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import build_prefill
    from repro_torch.runtime.train_step import (FsdpPlan, TrainStepConfig,
                                                data_mesh)

    model = build_model(get_config(ARCH))
    _check_full_width(model.cfg, 16, "prefill_gathered")
    layers = model.cfg.num_layers
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    groups = FsdpPlan(model, data_mesh(1), TrainStepConfig(
        dp_mode="fsdp")).shard_state(params)
    shape = ShapeConfig("prefill_check", PREFILL_CHECK_SEQ, 1, "prefill")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size,
                                     (1, PREFILL_CHECK_SEQ), generator=gen,
                                     device=dev, dtype=torch.int32)}
    resident = build_prefill(model, shape, device=dev)
    gathered = build_prefill(model, shape, weight_mode="gathered",
                             device=dev)
    want = resident(params, batch)
    gathered({"groups": groups}, batch)              # warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    got = gathered({"groups": groups}, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts, routes = launch_counters(), attn_routes()
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    resident(params, batch)
    torch.cuda.synchronize(dev)
    wall_resident = time.perf_counter() - t0
    if counts != dict(dict.fromkeys(counts, 0), flash_attn=layers) or \
            routes != dict(dict.fromkeys(routes, 0), wgmma=layers):
        raise AssertionError(f"[prefill_gathered] launches {counts}, by "
                             f"route {routes}: expected {layers} wgmma "
                             f"flash_attn and no other")
    if not bool(torch.isfinite(got).all()):
        raise AssertionError("[prefill_gathered] non-finite logits")
    diff = (got.float() - want.float()).abs()
    outside = int((diff > ENGINE_ATOL + ENGINE_RTOL * want.float().abs())
                  .sum())
    err = {"max_abs_diff": diff.max().item(),
           "rel_l2": (diff.norm() / want.float().norm()).item(),
           "outside": outside, "bitwise": bool(torch.equal(got, want))}
    if outside:
        raise AssertionError(f"[prefill_gathered] {outside} logits outside "
                             f"rtol {ENGINE_RTOL} / atol {ENGINE_ATOL} of "
                             f"the resident prefill's")
    log(f"[prefill_gathered] llama3.2-1b 16 layers, B=1 "
        f"S={PREFILL_CHECK_SEQ}, weights as fsdp shards gathered in bf16: "
        f"flash_attn launches {counts['flash_attn']} (wgmma "
        f"{routes['wgmma']}); vs the resident prefill: max |logit diff| "
        f"{err['max_abs_diff']:.4e}, relative L2 {err['rel_l2']:.4e}, "
        f"{outside} outside rtol {ENGINE_RTOL} / atol {ENGINE_ATOL}, "
        f"bitwise {err['bitwise']}; wall {wall * 1e3:.1f} ms (resident "
        f"{wall_resident * 1e3:.1f} ms), peak {peak / 2**30:.2f} GiB")
    del params, groups, want, got, resident, gathered, diff
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": counts["flash_attn"], "launches_by_route": routes,
            "error": err, "wall_ms": wall * 1e3,
            "resident_wall_ms": wall_resident * 1e3, "peak_bytes": peak}


def phase_timing_fsdp(dev, hop_widths: list[int]) -> dict:
    """``reduce_add`` at fsdp's ring mix, fp32 + bf16 -> fp32 (the running
    fp32 sum and the local bf16 cotangent slice), at the largest hop (the
    embedding's) and the median hop (a block's) of train_ring_fsdp, inputs
    rotated past the L2 and checked bitwise, beside its plain version,
    ``torch.add(fp32, bf16)`` and the bound the memory rate sets (10 bytes
    an element: 4 + 2 read, 4 written)."""
    import torch

    from repro_torch.kernels.reduce_add import ops as ra
    from repro_torch.kernels.reduce_add import ref as ra_ref

    gen = torch.Generator(device=dev).manual_seed(13)
    saved = launch_counters()
    out = {}
    for name, n in (("largest", hop_widths[-1]),
                    ("median", hop_widths[len(hop_widths) // 2])):
        k = max(2, math.ceil(4 * L2_BYTES / (10 * n)))
        pairs = [(torch.randn(n, generator=gen, device=dev),
                  torch.randn(n, generator=gen, device=dev).bfloat16())
                 for _ in range(k)]
        for a, b in pairs:
            if not torch.equal(ra.add_accum(a, b), ra_ref.add_accum(a, b)):
                raise AssertionError(f"[timing] reduce_add fp32 + bf16 at "
                                     f"{n} is not bitwise its plain version")
        calls = {"ms": rotating([functools.partial(ra.add_accum, a, b)
                                 for a, b in pairs]),
                 "plain_ms": rotating([functools.partial(ra_ref.add_accum,
                                                         a, b)
                                       for a, b in pairs]),
                 "library_ms": rotating([functools.partial(torch.add, a, b)
                                         for a, b in pairs])}
        times = {key: call_times(f, 10) for key, f in calls.items()}
        row = {key: t["graph_ms"] for key, t in times.items()}
        nbytes = 10 * n
        row.update(bound_ms=nbytes / HBM_BYTES_PER_S * 1e3, bound_by="bytes",
                   elements=n, bytes=nbytes, rotation=k, times=times)
        out[name] = row
        log(f"[timing] reduce_add fp32 + bf16 -> fp32 at the {name} fsdp hop "
            f"({n} elements, {nbytes} B), time per call; bound "
            f"{row['bound_ms'] * 1e3:.2f} us (bytes), "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound, "
            f"{row['ms'] / row['library_ms']:.3f}x torch.add:")
        for key, t in times.items():
            log(times_line(key.removesuffix("_ms"), t))
        del pairs
        torch.cuda.empty_cache()
    set_launch_counters(saved)         # timing launches are not the path's
    return out


# the checkpoint: a zero1 run stopped after CKPT_STOP of CKPT_STEPS steps
# and resumed by a fresh Trainer, against an unbroken run, under
# deterministic algorithms; one rank at full width and CKPT_LAYERS layers
# (the arena on), then two ranks on the card over the int8 wire
CKPT_LAYERS, CKPT_STEPS, CKPT_STOP = 4, 4, 2
# bytes a step directory takes per parameter: params, mu, nu and the fp32
# arena (one rank); params, the global mu and nu, "ef" of both ranks and
# their int8 arenas (about 1 B a parameter each) at two ranks
CKPT_BYTES_PER_PARAM = {1: 16, 2: 22}


def _argv_with(argv: list[str], **flags) -> list[str]:
    """``argv`` with ``--<flag> value`` set (replaced or appended)."""
    out = list(argv)
    for key, value in flags.items():
        flag = "--" + key.replace("_", "-")
        if flag in out:
            out[out.index(flag) + 1] = str(value)
        else:
            out += [flag, str(value)]
    return out


def _ckpt_place(name: str, world: int, what: str) -> tuple[Path, int, dict]:
    """A fresh directory under ``build/`` (ignored by git) for a phase's
    checkpoints, and the depth that fits: the deepest up to CKPT_LAYERS
    whose two step directories (the stop's and the resumed run's final
    save, both kept) take at most 90 % of the free space there."""
    import shutil

    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    root = REPO / "build" / name
    if root.exists():
        shutil.rmtree(root)
    root.mkdir(parents=True)
    free = shutil.disk_usage(root).free
    for layers in range(CKPT_LAYERS, 0, -1):
        params = build_model(get_config(ARCH).with_(
            num_layers=layers)).param_count()
        need = 2 * CKPT_BYTES_PER_PARAM[world] * params
        if need <= 0.9 * free:
            break
    else:
        raise AssertionError(f"[{what}] {free} B free under {root}: not "
                             f"even one layer's two step directories fit")
    disk = {"free_bytes": free, "need_bytes": need, "layers": layers}
    log(f"[{what}] checkpoints under {root}: {free} B ({free / 2**30:.1f} "
        f"GiB) free; two step directories at {layers} layers need about "
        f"{need} B" + ("" if layers == CKPT_LAYERS else
                       f" (depth cut from {CKPT_LAYERS}: "
                       f"{CKPT_LAYERS} layers do not fit)"))
    return root, layers, disk


def _dir_bytes(path: Path) -> int:
    return sum(f.stat().st_size for f in path.rglob("*") if f.is_file())


def _timed_checkpoints(trainer) -> dict:
    """Times every ``save`` (its blocking part: the host copy, and over
    several ranks the gather and the barrier) and ``wait`` (the joined
    write) of ``trainer``'s checkpoint manager."""
    times = {"save_s": [], "wait_s": []}
    mgr = trainer.ckpt
    save, wait = mgr.save, mgr.wait

    def timed(fn, key):
        def call(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                times[key].append(time.perf_counter() - t0)
        return call

    mgr.save, mgr.wait = timed(save, "save_s"), timed(wait, "wait_s")
    return times


def _timed_restore(setup):
    """``setup()`` with every ``CheckpointManager.restore_latest`` timed;
    returns its result and the seconds of each restore (the sha256 verify
    of every file included)."""
    from repro_torch.checkpoint import ckpt as ckpt_mod

    orig = ckpt_mod.CheckpointManager.restore_latest
    seconds = []

    def timed(self, *a, **kw):
        t0 = time.perf_counter()
        try:
            return orig(self, *a, **kw)
        finally:
            seconds.append(time.perf_counter() - t0)

    ckpt_mod.CheckpointManager.restore_latest = timed
    try:
        return setup(), seconds
    finally:
        ckpt_mod.CheckpointManager.restore_latest = orig


def _verify_seconds(step_dir: Path) -> float:
    """Seconds to sha256 every file of a step directory, as restore's
    verify does (on its threads)."""
    from repro_torch.checkpoint import ckpt as ckpt_mod

    t0 = time.perf_counter()
    ckpt_mod._sha256_all([str(f) for f in sorted(step_dir.glob("*.npy"))])
    return time.perf_counter() - t0


def _sharded_leaves(trainer) -> dict:
    """``{path: tensor}`` of the state's rank-sharded leaves (the arena,
    ``"ef"``, zero1's moment shards)."""
    from repro_torch.checkpoint.ckpt import flatten_with_path

    state = trainer.state
    flat, _ = flatten_with_path(state)
    rules = flatten_with_path(trainer.step_fn.state_layout(state))[0]
    return {p: leaf for (p, leaf), (_, rule) in zip(flat, rules)
            if rule == "sharded"}


def _per_step(counts: dict, steps: int, what: str) -> dict:
    bad = {k: v for k, v in counts.items() if v % steps}
    if bad:
        raise AssertionError(f"[{what}] launches {bad} do not split evenly "
                             f"over {steps} steps")
    return {k: v // steps for k, v in counts.items()}


def _fence_covers_device(dev) -> dict:
    """A span fenced on a tensor ends after the device work queued before
    it: 20 fp32 matmuls of 4096 x 4096 (timed by CUDA events) in a
    ``dispatch`` span that only queues them, then a ``wait`` span fenced
    on the result; the stream is idle when ``wait`` closes and ``dispatch``
    plus ``wait`` cover the device time."""
    import torch

    from repro_torch.obs import Tracer

    a = torch.randn(4096, 4096, device=dev) / 64
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(dev)
    tracer = Tracer()
    with tracer.span("dispatch"):
        start.record()
        x = a
        for _ in range(20):
            x = x @ a
        end.record()
    with tracer.span("wait") as sp:
        sp.fence({"x": [x]})
    idle = torch.cuda.current_stream(dev).query()
    device_s = start.elapsed_time(end) / 1e3
    (_, _, dispatch_s, _), (_, _, wait_s, _) = tracer.events
    if not idle or dispatch_s + wait_s < 0.95 * device_s:
        raise AssertionError(f"[train_ckpt] the fenced span does not cover "
                             f"the device work: stream idle {idle}, dispatch "
                             f"{dispatch_s} s + wait {wait_s} s against "
                             f"{device_s} s on the card")
    return {"device_s": device_s, "dispatch_s": dispatch_s, "wait_s": wait_s}


def _trace_spans(trace_path: str, steps: list[int]) -> dict:
    """The trace's spans by name, each step's ``dispatch`` and ``wait``
    within its ``step`` span."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    by_name: dict = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    missing = [n for n in ("data", "step", "dispatch", "wait", "ckpt")
               if n not in by_name]
    if missing:
        raise AssertionError(f"[train_ckpt] trace.json lacks the spans "
                             f"{missing}")
    for s in steps:
        step_e, disp, wait = (next(e for e in by_name[n]
                                   if e["args"].get("step") == s)
                              for n in ("step", "dispatch", "wait"))
        lo, hi = step_e["ts"], step_e["ts"] + step_e["dur"]
        for e in (disp, wait):
            if not (lo <= e["ts"] and e["ts"] + e["dur"] <= hi + 1):
                raise AssertionError(f"[train_ckpt] step {s}: {e['name']} "
                                     f"lies outside its step span")
    return {n: [e["dur"] / 1e6 for e in v] for n, v in by_name.items()}


def phase_train_ckpt(dev) -> dict:
    """One rank, zero1 (llama3.2-1b's default), the arena on, seq 256,
    batch 8, full width at CKPT_LAYERS layers, under deterministic
    algorithms: an unbroken CKPT_STEPS-step run, then a run stopped after
    CKPT_STOP steps (its final save), then a fresh Trainer with ``--obs-dir``
    that resumes at CKPT_STOP and runs to the end.  Losses of the resumed
    steps and every leaf of the final state bitwise the unbroken run's;
    pack launches a step equal in the three runs; the trace holds the five
    spans, ``wait`` fenced on the device."""
    import gc
    import shutil

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.launch import train as launch_train

    root, layers, disk = _ckpt_place("ckpt_smoke", 1, "train_ckpt")
    ckpt_dir, obs_dir = root / "ckpt", root / "obs"
    argv = _argv_with(ZERO1_ARGS, layers=layers, steps=CKPT_STEPS)
    _deterministic(torch)
    try:
        def setup(extra):
            args = launch_train.parser().parse_args(argv + extra)
            world = launch_train.init_distributed(args.device)
            run = launch_train.setup(args, world)
            _check_full_width(run.model.cfg, layers, "train_ckpt")
            return run

        run = setup([])
        if run.trainer.step_fn.cfg.dp_mode != "zero1":
            raise AssertionError("[train_ckpt] the step is not zero1")
        reset_launch_counters()
        full = run.trainer.run()["history"]
        counts_full = launch_counters()
        routes = pack_routes()
        final = {k: v for k, v in run.trainer.state.items() if k != "step"}
        state_bytes = sum(t.numel() * t.element_size()
                          for t in tree_util.leaves(final))
        del run
        gc.collect()

        run = setup(["--ckpt-dir", str(ckpt_dir)])
        run.trainer.tcfg.steps = CKPT_STOP            # the run dies here
        stop_times = _timed_checkpoints(run.trainer)
        reset_launch_counters()
        stopped = run.trainer.run()["history"]
        counts_stop = launch_counters()
        saved = {p: t.clone() for p, t in
                 _sharded_leaves(run.trainer).items()}
        del run
        gc.collect()
        step_dir = ckpt_dir / f"step_{CKPT_STOP:08d}"
        written = _dir_bytes(step_dir)
        verify_s = _verify_seconds(step_dir)

        run, restore_s = _timed_restore(lambda: setup(
            ["--ckpt-dir", str(ckpt_dir), "--obs-dir", str(obs_dir)]))
        trainer = run.trainer
        if trainer.start_step != CKPT_STOP:
            raise AssertionError(f"[train_ckpt] resumed at "
                                 f"{trainer.start_step}, not {CKPT_STOP}")
        restored = _sharded_leaves(trainer)
        same_shards = (restored.keys() == saved.keys() and all(
            torch.equal(restored[p], saved[p]) for p in saved))
        del saved
        res_times = _timed_checkpoints(trainer)
        reset_launch_counters()
        out_res = trainer.run()
        resumed = out_res["history"]
        counts_res = launch_counters()
        differ = [p for p, (a, b) in enumerate(zip(
            tree_util.leaves({k: v for k, v in trainer.state.items()
                              if k != "step"}), tree_util.leaves(final)))
                  if not torch.equal(a, b)]
        n_leaves = len(tree_util.leaves(final))
        step_ok = trainer.state["step"] == CKPT_STEPS
        del run, trainer, final, restored
        gc.collect()
        torch.cuda.empty_cache()
        fence = _fence_covers_device(dev)
    finally:
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
    spans = _trace_spans(out_res["obs"]["trace"],
                         list(range(CKPT_STOP, CKPT_STEPS)))
    losses = [h["loss"] for h in full]
    tail = [h["loss"] for h in resumed]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[train_ckpt] non-finite loss: {losses}")
    if [h["loss"] for h in stopped] != losses[:CKPT_STOP]:
        raise AssertionError(f"[train_ckpt] the stopped run's losses "
                             f"{[h['loss'] for h in stopped]} != the "
                             f"unbroken run's {losses[:CKPT_STOP]}")
    if tail != losses[CKPT_STOP:]:
        raise AssertionError(f"[train_ckpt] resumed losses {tail} != the "
                             f"unbroken run's {losses[CKPT_STOP:]}")
    if differ or not step_ok:
        raise AssertionError(f"[train_ckpt] final state leaves {differ} of "
                             f"{n_leaves} differ from the unbroken run's "
                             f"(step reached: {step_ok})")
    if not same_shards:
        raise AssertionError("[train_ckpt] the restored arena / moment "
                             "shards differ from what was saved")
    per_step = {name: _per_step(c, n, "train_ckpt") for name, c, n in (
        ("unbroken", counts_full, CKPT_STEPS), ("stopped", counts_stop,
                                                CKPT_STOP),
        ("resumed", counts_res, CKPT_STEPS - CKPT_STOP))}
    if not (per_step["unbroken"] == per_step["stopped"] == per_step["resumed"]
            and per_step["unbroken"]["pack_write"] > 0):
        raise AssertionError(f"[train_ckpt] launches a step differ: "
                             f"{per_step}")
    if routes["vector"]:
        raise AssertionError(f"[train_ckpt] pack by route {routes}")
    out = {"layers": layers, "losses": losses, "resumed_losses": tail,
           "step_s": [h["sec"] for h in full],
           "resumed_step_s": [h["sec"] for h in resumed],
           "launches": counts_full, "launches_resumed": counts_res,
           "launches_per_step": per_step["unbroken"], "pack_routes": routes,
           "state_bytes": state_bytes, "written_bytes": written,
           "save_blocking_s": stop_times["save_s"][-1],
           "async_write_s": stop_times["wait_s"][-1],
           "resumed_save_blocking_s": res_times["save_s"][-1],
           "resumed_async_write_s": res_times["wait_s"][-1],
           "restore_s": restore_s[0], "verify_s": verify_s,
           "disk": disk, "spans_s": spans, "fence": fence,
           "n_leaves": n_leaves}
    log(f"[train_ckpt] zero1, 1 rank, {layers} layers, arena on, "
        f"deterministic: losses {', '.join(f'{x:.6f}' for x in losses)}; "
        f"stopped at {CKPT_STOP}, resumed by a fresh Trainer: losses "
        f"{', '.join(f'{x:.6f}' for x in tail)} bitwise, final state "
        f"{n_leaves} of {n_leaves} leaves bitwise, restored arena and "
        f"moment shards bitwise what was saved")
    log(f"[train_ckpt] step directory {written} B ({written / 2**30:.2f} "
        f"GiB; state {state_bytes} B): save blocking (host copy) "
        f"{out['save_blocking_s']:.3f} s, async write {out['async_write_s']:.3f}"
        f" s; restore {out['restore_s']:.3f} s (sha256 of every file "
        f"{verify_s:.3f} s); the resumed run's final save "
        f"{out['resumed_save_blocking_s']:.3f} + "
        f"{out['resumed_async_write_s']:.3f} s; free disk "
        f"{disk['free_bytes']} B before")
    log(f"[train_ckpt] launches a step {per_step['unbroken']} in all three "
        f"runs, pack by route {routes}; step wall unbroken "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in full)} ms, resumed "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in resumed)} ms")
    log(f"[train_ckpt] trace.json spans (s): "
        + "; ".join(f"{n} {', '.join(f'{x:.4f}' for x in v)}"
                    for n, v in spans.items())
        + f"; fence check: {fence['device_s'] * 1e3:.1f} ms on the card "
        f"covered by dispatch {fence['dispatch_s'] * 1e3:.1f} + wait "
        f"{fence['wait_s'] * 1e3:.1f} ms")
    shutil.rmtree(root)
    return out


def _ckpt_ring_worker(argv: list[str], ckpt_dir: str) -> dict:
    """One of the two ranks of train_ring_ckpt: the unbroken run, the run
    stopped at CKPT_STOP (its sharded leaves gathered to rank 0, which
    writes), and the resumed run, each with its launches and per-leaf
    digests."""
    import gc

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    _deterministic(torch)
    world = launch_train.init_distributed(
        launch_train.parser().parse_args(argv).device)

    def setup(extra):
        args = launch_train.parser().parse_args(argv + extra)
        run = launch_train.setup(args, world)
        _check_full_width(run.model.cfg, args.layers, "train_ring_ckpt")
        return run

    def state_digest(trainer):
        return params_digest({k: v for k, v in trainer.state.items()
                              if k != "step"})

    def shard_digests(trainer):
        return {p: params_digest([t])[0]
                for p, t in _sharded_leaves(trainer).items()}

    try:
        run = setup([])
        reset_launch_counters()
        full = run.trainer.run()["history"]
        counts_full = launch_counters()
        full_digest = state_digest(run.trainer)
        del run
        gc.collect()
        run = setup(["--ckpt-dir", ckpt_dir])
        run.trainer.tcfg.steps = CKPT_STOP
        stop_times = _timed_checkpoints(run.trainer)
        reset_launch_counters()
        stopped = run.trainer.run()["history"]
        counts_stop = launch_counters()
        saved = shard_digests(run.trainer)
        del run
        gc.collect()
        run, restore_s = _timed_restore(lambda: setup(["--ckpt-dir",
                                                       ckpt_dir]))
        start = run.trainer.start_step
        restored = shard_digests(run.trainer)
        res_times = _timed_checkpoints(run.trainer)
        reset_launch_counters()
        resumed = run.trainer.run()["history"]
        counts_res = launch_counters()
        res_digest = state_digest(run.trainer)
        record = run.trainer.step_fn.comm.record.as_dict()
        return {"backend": world.backend, "start": start,
                "losses": [h["loss"] for h in full],
                "stopped_losses": [h["loss"] for h in stopped],
                "resumed_losses": [h["loss"] for h in resumed],
                "step_s": [h["sec"] for h in full],
                "resumed_step_s": [h["sec"] for h in resumed],
                "counts": {"unbroken": counts_full, "stopped": counts_stop,
                           "resumed": counts_res},
                "final_same": res_digest == full_digest,
                "n_leaves": len(full_digest),
                "shards_same": saved == restored, "sharded": sorted(saved),
                "save_blocking_s": stop_times["save_s"][-1],
                "async_write_s": stop_times["wait_s"][-1],
                "restore_s": restore_s[0],
                "resumed_save_blocking_s": res_times["save_s"][-1],
                "resumed_async_write_s": res_times["wait_s"][-1],
                "staging_s": record["staging_s"]}
    finally:
        dist.destroy_process_group()


def phase_train_ring_ckpt() -> dict:
    """Two ranks on the card over gloo, zero1 over the int8 wire with the
    int8 arena, full width at CKPT_LAYERS layers, deterministic: the
    stop-and-resume check of train_ckpt, bitwise, with every rank's
    restored arena, ``"ef"`` and moment shards equal to what it saved and
    the launches a step of ``pack``, ``pack_quant``, ``quant`` and
    ``reduce_add`` equal to the unbroken run's."""
    import shutil

    from repro_torch.launch import train as launch_train

    what = "train_ring_ckpt"
    root, layers, disk = _ckpt_place("ckpt_ring_smoke", 2, what)
    before = card_memory()
    log(f"[{what}] before the ranks spawn: {before['card_used_mib']} of "
        f"{before['card_total_mib']} MiB of the card in use")
    argv = _argv_with(ZERO1_INT8_ARGS, layers=layers, steps=CKPT_STEPS)
    ranks = launch_train.spawn(_ckpt_ring_worker, 2, argv, str(root),
                               timeout=900)
    step_dir = root / f"step_{CKPT_STOP:08d}"
    written = _dir_bytes(step_dir)
    verify_s = _verify_seconds(step_dir)
    for r, o in enumerate(ranks):
        if o["backend"] != "gloo" or o["start"] != CKPT_STOP:
            raise AssertionError(f"[{what}] rank {r}: backend "
                                 f"{o['backend']}, resumed at {o['start']}")
        losses = o["losses"]
        if not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"[{what}] rank {r} non-finite loss")
        if o["stopped_losses"] != losses[:CKPT_STOP] or \
                o["resumed_losses"] != losses[CKPT_STOP:]:
            raise AssertionError(f"[{what}] rank {r}: stopped "
                                 f"{o['stopped_losses']} and resumed "
                                 f"{o['resumed_losses']} != unbroken "
                                 f"{losses}")
        if not o["final_same"]:
            raise AssertionError(f"[{what}] rank {r}: the final state differs"
                                 f" from the unbroken run's")
        if not o["shards_same"] or not {"['arena']", "['ef']"} <= set(
                o["sharded"]):
            raise AssertionError(f"[{what}] rank {r}: restored shards "
                                 f"{o['sharded']} differ from what it saved")
        c = o["counts"]
        per = {name: _per_step(c[name], n, what) for name, n in (
            ("unbroken", CKPT_STEPS), ("stopped", CKPT_STOP),
            ("resumed", CKPT_STEPS - CKPT_STOP))}
        if not per["unbroken"] == per["stopped"] == per["resumed"]:
            raise AssertionError(f"[{what}] rank {r}: launches a step "
                                 f"differ: {per}")
        for name in ("pack_read", "pack_quant_write", "pack_quant_read",
                     "quantize", "dequantize", "reduce_add"):
            if not per["unbroken"][name]:
                raise AssertionError(f"[{what}] rank {r}: no {name} launch")
        o["launches_per_step"] = per["unbroken"]
    if ranks[0]["losses"] != ranks[1]["losses"]:
        raise AssertionError(f"[{what}] the ranks disagree on the loss")
    o = ranks[0]
    log(f"[{what}] 2 ranks on one card over gloo, zero1, int8 wire, "
        f"{layers} layers, deterministic: losses "
        f"{', '.join(f'{x:.6f}' for x in o['losses'])}; stopped at "
        f"{CKPT_STOP} and resumed: losses bitwise, final state "
        f"{o['n_leaves']} leaves bitwise (digests) on both ranks, restored "
        f"{', '.join(o['sharded'])} bitwise what each rank saved")
    log(f"[{what}] step directory {written} B ({written / 2**30:.2f} GiB, "
        f"global arrays): save blocking (host copy + gather to rank 0) "
        f"{o['save_blocking_s']:.3f} / {ranks[1]['save_blocking_s']:.3f} s, "
        f"async write {o['async_write_s']:.3f} s (rank 0); restore "
        f"{o['restore_s']:.3f} / {ranks[1]['restore_s']:.3f} s (sha256 of "
        f"every file {verify_s:.3f} s); free disk {disk['free_bytes']} B")
    log(f"[{what}] launches a step {o['launches_per_step']} in all three "
        f"runs on both ranks; step wall unbroken "
        f"{', '.join(f'{x * 1e3:.0f}' for x in o['step_s'])} ms, resumed "
        f"{', '.join(f'{x * 1e3:.0f}' for x in o['resumed_step_s'])} ms")
    shutil.rmtree(root)
    return {"ranks": ranks, "layers": layers, "written_bytes": written,
            "verify_s": verify_s, "disk": disk, "card_before": before}


def rotating(calls):
    """One callable that runs the next of ``calls`` at each call, so that a
    timed run of many calls cycles through their inputs."""
    it = itertools.cycle(calls)
    return lambda: next(it)()


def phase_timing_train(dev, hop_widths: list[int], layout) -> dict:
    """Device time per call of the new kernels at the main path's shapes:
    the ring hop of the largest span and the median hop (train_ring; inputs
    rotated past the L2); the train layout's
    largest segment, its median segment (inputs rotated so that they do
    not sit in the 50 MB L2) and the whole layout (one ``pack_into`` and
    one ``unpack`` of every segment); the vector route at the largest
    segment (a source 4 bytes off, and a cast into a bf16 arena).  Each
    beside the plain version, one PyTorch call (``torch.add``, ``copy_``,
    ``clone``; for the layout ``torch._foreach_copy_`` and the segments'
    ``clone`` calls) and the bound the card's memory rate sets."""
    import torch

    from repro_torch.kernels.pack import ops as pk
    from repro_torch.kernels.pack import ref as pk_ref
    from repro_torch.kernels.reduce_add import ops as ra
    from repro_torch.kernels.reduce_add import ref as ra_ref
    from repro_torch.mem.arena import CommArena

    gen = torch.Generator(device=dev).manual_seed(11)
    hop_width, hop_median = hop_widths[-1], hop_widths[len(hop_widths) // 2]
    a = torch.randn(hop_width, generator=gen, device=dev)
    b = torch.randn(hop_width, generator=gen, device=dev)
    # the median hop: enough input pairs that one pass over them moves 4x
    # the L2
    k_add = max(2, math.ceil(4 * L2_BYTES / (12 * hop_median)))
    adds = [(torch.randn(hop_median, generator=gen, device=dev),
             torch.randn(hop_median, generator=gen, device=dev))
            for _ in range(k_add)]
    page = 2 * 2**20 // 4
    sizes = sorted(seg.size for seg in layout.segments)
    segment, median = sizes[-1], sizes[len(sizes) // 2]
    arena = torch.zeros(segment + 2 * page, device=dev)
    src = torch.randn(segment, generator=gen, device=dev)
    off = page
    # the median segment: enough (source, arena slot) pairs that one pass
    # over them moves 4x the L2; slots on 2 MiB pages, as in the arena
    slot = -(-median // page) * page
    k = max(2, math.ceil(4 * L2_BYTES / (8 * median)))
    arena_m = torch.zeros(k * slot, device=dev)
    srcs_m = [torch.randn(median, generator=gen, device=dev)
              for _ in range(k)]
    offs_m = [i * slot for i in range(k)]
    # the vector route at the largest segment
    src_off = torch.randn(segment + 1, generator=gen, device=dev)[1:]
    arena_bf16 = torch.zeros(segment + 2 * page, dtype=torch.bfloat16,
                             device=dev)
    saved, saved_routes = launch_counters(), pack_routes()

    def m_calls(fn, n=k):
        return rotating([functools.partial(fn, i) for i in range(n)])

    table = {
        "reduce_add": (12 * hop_width, {
            "ms": lambda: ra.add_accum(a, b),
            "plain_ms": lambda: ra_ref.add_accum(a, b),
            "library_ms": lambda: torch.add(a, b)}),
        "reduce_add_median": (12 * hop_median, {
            "ms": m_calls(lambda i: ra.add_accum(*adds[i]), k_add),
            "plain_ms": m_calls(lambda i: ra_ref.add_accum(*adds[i]), k_add),
            "library_ms": m_calls(lambda i: torch.add(*adds[i]), k_add)}),
        "pack_write": (8 * segment, {
            "ms": lambda: pk.write_flat(arena, src, off),
            "plain_ms": lambda: pk_ref.write_flat(arena, src, off),
            "library_ms": lambda: arena[off:off + segment].copy_(src)}),
        "pack_read": (8 * segment, {
            "ms": lambda: pk.read_flat(arena, off, segment),
            "plain_ms": lambda: pk_ref.read_flat(arena, off, segment),
            "library_ms": lambda: arena[off:off + segment].clone()}),
        "pack_write_median": (8 * median, {
            "ms": m_calls(lambda i: pk.write_flat(arena_m, srcs_m[i],
                                                  offs_m[i])),
            "plain_ms": m_calls(lambda i: pk_ref.write_flat(
                arena_m, srcs_m[i], offs_m[i])),
            "library_ms": m_calls(lambda i: arena_m[
                offs_m[i]:offs_m[i] + median].copy_(srcs_m[i]))}),
        "pack_read_median": (8 * median, {
            "ms": m_calls(lambda i: pk.read_flat(arena_m, offs_m[i],
                                                 median)),
            "plain_ms": m_calls(lambda i: pk_ref.read_flat(
                arena_m, offs_m[i], median)),
            "library_ms": m_calls(lambda i: arena_m[
                offs_m[i]:offs_m[i] + median].clone())}),
        "pack_write_vector": (8 * segment, {
            "ms": lambda: pk.write_flat(arena, src_off, off),
            "plain_ms": lambda: pk_ref.write_flat(arena, src_off, off),
            "library_ms": lambda: arena[off:off + segment].copy_(src_off)}),
        "pack_write_cast": (6 * segment, {
            "ms": lambda: pk.write_flat(arena_bf16, src, off),
            "plain_ms": lambda: pk_ref.write_flat(arena_bf16, src, off),
            "library_ms": lambda: arena_bf16[off:off + segment].copy_(src)}),
    }
    routes = {"pack_write": "bulk", "pack_read": "bulk",
              "pack_write_median": "bulk", "pack_read_median": "bulk",
              "pack_write_vector": "vector", "pack_write_cast": "vector"}
    out = {}

    def timed(name, nbytes, calls, iters):
        times = {key: call_times(f, iters) for key, f in calls.items()}
        row = {key: t["graph_ms"] for key, t in times.items()}
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        row["bytes"] = nbytes
        row["times"] = times
        out[name] = row
        log(f"[timing] {name} ({nbytes} B), time per call; bound "
            f"{row['bound_ms'] * 1e3:.2f} us (bytes), i.e. "
            f"{nbytes / row['ms'] / 1e9:.3f} TB/s achieved by the kernel, "
            f"{row['bound_ms'] / row['ms']:.3f} of the bound, "
            f"{row['ms'] / row['library_ms']:.3f}x the library call:")
        for key, t in times.items():
            log(times_line(key.removesuffix("_ms"), t))

    for name, (nbytes, calls) in table.items():
        if name in routes:
            before = pack_routes()
            calls["ms"]()
            way = {w: n - before[w] for w, n in pack_routes().items()}
            if way != {w: int(w == routes[name]) for w in way}:
                raise AssertionError(f"[timing] {name}: launched {way}, "
                                     f"expected the {routes[name]} route")
        timed(name, nbytes, calls, 10)
    for i in range(k_add):             # bitwise at the median hop too
        if not torch.equal(ra.add_accum(*adds[i]),
                           ra_ref.add_accum(*adds[i])):
            raise AssertionError("[timing] reduce_add at the median hop is "
                                 "not bitwise")
    del arena_m, srcs_m, src_off, arena_bf16, adds
    torch.cuda.empty_cache()

    # the whole layout: one pack_into and one unpack of every segment
    kern, plain = CommArena(layout), CommArena(layout, impl="plain")
    buf = kern.zeros(dev)
    bufs = [None] * layout.n_segments
    for seg in layout.segments:
        bufs[seg.bucket] = torch.randn(seg.size, generator=gen, device=dev)
    views = [buf[seg.offset:seg.offset + seg.size] for seg in layout.segments]
    ordered = [bufs[seg.bucket] for seg in layout.segments]
    used = 8 * sum(sizes)
    before = pack_routes()
    kern.pack_into(buf, bufs)
    back = kern.unpack(buf)
    torch.cuda.synchronize(dev)
    way = {w: n - before[w] for w, n in pack_routes().items()}
    if way != {"bulk": 2 * layout.n_segments, "vector": 0}:
        raise AssertionError(f"[timing] layout: launched {way}, expected "
                             f"every copy on the bulk route")
    if not all(torch.equal(x, y) for x, y in zip(back, bufs)):
        raise AssertionError("[timing] layout: unpack(pack_into) is not "
                             "the buckets bit for bit")
    del back
    timed("pack_into_layout", used, {
        "ms": lambda: kern.pack_into(buf, bufs),
        "plain_ms": lambda: plain.pack_into(buf, bufs),
        "library_ms": lambda: torch._foreach_copy_(views, ordered)}, 3)
    timed("unpack_layout", used, {
        "ms": lambda: kern.unpack(buf),
        "plain_ms": lambda: plain.unpack(buf),
        "library_ms": lambda: [v.clone() for v in views]}, 3)
    out["layout"] = {"segments": layout.n_segments, "largest": segment,
                     "median": median, "median_rotation": k}
    out["hops"] = {"largest": hop_width, "median": hop_median,
                   "median_rotation": k_add, "per_step": len(hop_widths)}
    set_launch_counters(saved)         # timing launches are not the path's
    set_pack_routes(saved_routes)
    del buf, bufs, views, ordered
    torch.cuda.empty_cache()
    return out


def phase_kernels_int8(dev) -> dict:
    """The int8 codec's and the int8 arena's kernels against their plain
    versions on the card: bitwise (payload, scale bytes, residual, decode),
    and run to run.  Besides a zero block, the inputs of 7 blocks and more
    hold a NaN in their second block and an inf in their third: the plain
    versions give those blocks a NaN and an inf scale, and the kernels must
    give the same bits."""
    import torch

    from repro_torch.kernels.pack_quant import ops as pq
    from repro_torch.kernels.pack_quant import ref as pq_ref
    from repro_torch.kernels.quant import ops as qt
    from repro_torch.kernels.quant import ref as qt_ref

    def gap(x, y) -> float:
        """Largest |x - y|, equal values (NaN beside NaN, inf beside the
        same inf) counting 0 and a NaN beside a number counting inf."""
        x, y = x.float(), y.float()
        same = (x == y) | (x.isnan() & y.isnan())
        d = torch.where(same, 0.0, (x - y).abs()).nan_to_num(nan=math.inf)
        return d.max().item() if d.numel() else 0.0

    def equal(a, b) -> bool:
        """Bit for bit, NaN included."""
        if a.dtype == torch.float32:
            a, b = a.view(torch.int32), b.view(torch.int32)
        return torch.equal(a, b)

    def nonfinite(x, block) -> None:
        if x.numel() >= 3 * block:
            x[block + 5] = math.nan
            x[2 * block + 3] = -math.inf

    gen = torch.Generator(device=dev).manual_seed(13)
    saved = launch_counters()
    err = dict.fromkeys(("quantize", "dequantize", "pack_quant_write",
                         "pack_quant_read"), 0.0)
    many = MANY_BLOCKS
    n_codec = 0
    for block in (512, 128, 96):
        for n_blocks in (1, 7, many):
            x = torch.randn(block * n_blocks, generator=gen, device=dev) * 3
            x[:block] = 0.0                             # a zero block,
            x[1:block:2] = -0.0                         # -0.0 in it
            nonfinite(x, block)
            got, again = qt.quantize(x, block), qt.quantize(x, block)
            want = qt_ref.quantize(x, block)
            back, back2 = (qt.dequantize(*got, block),
                           qt.dequantize(*got, block))
            wback = qt_ref.dequantize(*want, block)
            torch.cuda.synchronize(dev)
            err["quantize"] = max(err["quantize"], gap(got[0], want[0]),
                                  gap(got[1], want[1]))
            err["dequantize"] = max(err["dequantize"], gap(back, wback))
            if not all(equal(a, b) and equal(a, w)
                       for a, b, w in zip(got, again, want)):
                raise AssertionError(f"[kernels_int8] quantize block={block}"
                                     f" blocks={n_blocks}: not bitwise")
            if not (equal(back, back2) and equal(back, wback)):
                raise AssertionError(f"[kernels_int8] dequantize block="
                                     f"{block} blocks={n_blocks}: not "
                                     f"bitwise")
            n_codec += 1
            del x, got, again, want, back, back2, wback
    page = 2 * 2**20
    n_arena = 0
    for block in (512, 128, 96):
        # a page offset that is also a block multiple (3 pages for 96)
        for offset, n_blocks in ((0, 1), (math.lcm(page, block), 7),
                                 (7 * block, many)):
            n = block * n_blocks
            scale_offset = -(-(offset + n) // page) * page
            arena0 = torch.randint(-127, 128, (scale_offset + page,),
                                   generator=gen, device=dev,
                                   dtype=torch.int8)
            src = torch.randn(n, generator=gen, device=dev) * 2
            src[:block] = 0.0
            src[1:block:2] = -0.0
            nonfinite(src, block)
            ef0 = torch.randn(n, generator=gen, device=dev) * 0.01
            for fused in (False, True):
                want, wef = arena0.clone(), ef0.clone()
                pq_ref.write_quant_flat(want, src, offset, scale_offset,
                                        block, wef if fused else None)
                runs = []
                for _ in range(2):
                    arena, ef = arena0.clone(), ef0.clone()
                    ptr = arena.data_ptr()
                    out = pq.write_quant_flat(arena, src, offset,
                                              scale_offset, block,
                                              ef if fused else None)
                    if out.data_ptr() != ptr:
                        raise AssertionError("[kernels_int8] write_quant "
                                             "did not write in place")
                    runs.append((out, ef))
                reads = [pq.read_dequant_flat(runs[0][0], offset, n,
                                              scale_offset, block)
                         for _ in range(2)]
                wread = pq_ref.read_dequant_flat(want, offset, n,
                                                 scale_offset, block)
                torch.cuda.synchronize(dev)
                err["pack_quant_write"] = max(err["pack_quant_write"],
                                              gap(runs[0][0], want),
                                              gap(runs[0][1], wef))
                err["pack_quant_read"] = max(err["pack_quant_read"],
                                             gap(reads[0], wread))
                for out, ef in runs:
                    if not (equal(out, want) and equal(ef, wef)):
                        raise AssertionError(
                            f"[kernels_int8] write_quant block={block} "
                            f"offset={offset} blocks={n_blocks} ef={fused}:"
                            f" not bitwise")
                if not (equal(reads[0], reads[1])
                        and equal(reads[0], wread)):
                    raise AssertionError(
                        f"[kernels_int8] read_dequant block={block} "
                        f"offset={offset} blocks={n_blocks}: not bitwise")
                n_arena += 1
                del want, wef, runs, reads, wread
            del arena0, src, ef0
    set_launch_counters(saved)         # checks are not the main path's
    torch.cuda.empty_cache()
    log(f"[kernels_int8] quantize/dequantize: {n_codec} cases (blocks 512, "
        f"128, 96 x 1, 7, {many} blocks, a zero block each, a NaN and an "
        f"inf block from 7 blocks up) bitwise equal to the plain versions "
        f"and run to run")
    log(f"[kernels_int8] write_quant/read_dequant: {n_arena} cases (offsets "
        f"0, a 2 MiB page, 7 blocks; 1, 7, {many} blocks; error feedback "
        f"fused and not; in place) payload, scale bytes, residual and "
        f"decode bitwise equal to the plain versions and run to run")
    return {"codec_cases": n_codec, "arena_cases": n_arena,
            "max_abs_err": err}


def phase_timing_int8(dev, hop_width: int, segment: int,
                      block: int) -> dict:
    """Device time per call of the int8 kernels at the main path's largest
    shapes: ``write_quant`` (with error feedback, as the pack runs it) and
    ``read_dequant`` at train_int8's largest segment, ``quantize`` and
    ``dequantize`` at train_ring_int8's largest hop; beside the plain
    version, a PyTorch call where one computes the same function, and the
    bound the card's memory rate sets."""
    import torch

    from repro_torch.kernels.pack_quant import ops as pq
    from repro_torch.kernels.pack_quant import ref as pq_ref
    from repro_torch.kernels.quant import ops as qt
    from repro_torch.kernels.quant import ref as qt_ref

    gen = torch.Generator(device=dev).manual_seed(17)
    page = 2 * 2**20
    x = torch.randn(hop_width, generator=gen, device=dev)
    q, scales = qt.quantize(x, block)
    src = torch.randn(segment, generator=gen, device=dev)
    ef = torch.randn(segment, generator=gen, device=dev) * 0.01
    scale_offset = -(-(page + segment) // page) * page
    arena = torch.zeros(scale_offset + page, dtype=torch.int8, device=dev)
    pq.write_quant_flat(arena, src, page, scale_offset, block)
    lo = scale_offset + page // block * 4
    arena_scales = arena[lo:lo + segment // block * 4].view(torch.float32)
    saved = launch_counters()
    wire = 1 + 4 / block               # bytes per element: int8 + its scale
    table = {
        # reads x, writes q and its scale
        "quantize": (hop_width * (4 + wire), {
            "ms": lambda: qt.quantize(x, block),
            "plain_ms": lambda: qt_ref.quantize(x, block),
            "library_ms": None}),
        # reads q and its scale, writes fp32
        "dequantize": (hop_width * (wire + 4), {
            "ms": lambda: qt.dequantize(q, scales, block),
            "plain_ms": lambda: qt_ref.dequantize(q, scales, block),
            "library_ms": lambda: torch.mul(q.view(-1, block),
                                            scales.view(-1, 1))}),
        # reads src and ef, writes q, its scale and ef
        "pack_quant_write": (segment * (4 + 4 + wire + 4), {
            "ms": lambda: pq.write_quant_flat(arena, src, page,
                                              scale_offset, block, ef),
            "plain_ms": lambda: pq_ref.write_quant_flat(
                arena, src, page, scale_offset, block, ef),
            "library_ms": None}),
        # reads q and its scale, writes fp32
        "pack_quant_read": (segment * (wire + 4), {
            "ms": lambda: pq.read_dequant_flat(arena, page, segment,
                                               scale_offset, block),
            "plain_ms": lambda: pq_ref.read_dequant_flat(
                arena, page, segment, scale_offset, block),
            "library_ms": lambda: torch.mul(
                arena[page:page + segment].view(-1, block),
                arena_scales.view(-1, 1))}),
    }
    out = {}
    for name, (nbytes, calls) in table.items():
        times = {k: call_times(f, 10) for k, f in calls.items()
                 if f is not None}
        row = {k: (times[k]["graph_ms"] if k in times else None)
               for k in calls}
        row["bound_ms"] = nbytes / HBM_BYTES_PER_S * 1e3
        row["bound_by"] = "bytes"
        row["bytes"] = nbytes
        row["times"] = times
        out[name] = row
        no_library = ("" if calls["library_ms"]
                      else "; no single PyTorch call computes it")
        log(f"[timing] {name} ({nbytes:.0f} B), time per call; bound "
            f"{row['bound_ms'] * 1e3:.2f} us (bytes), i.e. "
            f"{nbytes / row['ms'] / 1e9:.3f} TB/s achieved by the kernel"
            f"{no_library}:")
        for k, t in times.items():
            log(times_line(k.removesuffix("_ms"), t))
    set_launch_counters(saved)         # timing launches are not the path's
    return out


# flash attention: the kernel checks' grid and tolerances (the reference's,
# tests/test_kernels.py: fp32 2e-5, bf16 3e-2 absolute)
# S around the wgmma kernel's 128-row q tiles and 128-key (64 at D=128) tiles
ATTN_SEQS = (1, 7, 64, 127, 128, 129, 200, 255, 256, 257, 1000, 4096)
ATTN_HEADS = ((32, 8), (4, 2), (8, 1))
ATTN_DIMS = (16, 32, 64, 128)
ATTN_MASKS = ((True, None), (True, 64), (False, None))
ATTN_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (0.0, 3e-2)}
# at the 32k layer shape the outputs shrink with the row (about
# sqrt(e / (i + 1)) at row i), so atol 3e-2 is of their own size there;
# beside it, the relative L2 of the kernel against the plain version, set
# between the kernel's reading and that of the plain version with p rounded
# once to bf16 (PERF.md section 6), which must fail it
ATTN_32K_REL_L2 = 5e-4
# the flash_attn kernel each dtype launches in the grid's layouts
ATTN_ROUTE = {"float32": "simt", "bfloat16": "wgmma"}
ATTN_UNALIGNED_SEQ = 257     # the bf16 cases in layouts TMA cannot take
PREFILL_CHECK_SEQ = 4096     # kernel prefill vs blockwise prefill
PREFILL_SEQ = 32768          # prefill_32k's length, at batch 1
PREFILL_FP32_TOL = 1e-4      # tests/test_torch_prefill.py's fp32 tolerance
PREFILL_CHECK_SEEDS = tuple(range(10))  # weights and tokens, S=4096 check
# the bf16 kernel prefill's error against the fp32 blockwise prefill, as a
# multiple of the bf16 blockwise prefill's: relative L2 and elementwise
# misses of the engine's tolerance, at most (PERF.md section 6)
PREFILL_BF16_L2_MARGIN, PREFILL_BF16_MISS_MARGIN = 1.05, 1.25
# the H100 SXM's dense bf16 tensor-core peak (NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12


def attn_inputs(dev, seed, b, hq, hkv, s, d, dtype):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def unaligned_bf16_attn_inputs(dev, seed):
    """bf16 q/k/v in layouts TMA cannot take, so ``route`` gives them to the
    SIMT kernel: head views of a (1, S, 4*64 + 4) projection (a sequence
    stride of 260 elements, 520 bytes) and k/v 2 bytes past alignment."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    s = ATTN_UNALIGNED_SEQ
    x = torch.randn((1, s, 4 * 64 + 4), generator=gen,
                    device=dev).to(torch.bfloat16)
    heads = x[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    flat = torch.randn(2 * s * 64 + 1, generator=gen,
                       device=dev).to(torch.bfloat16)
    shifted = flat[1:].view(1, 2, s, 64)
    return {"260-element sequence stride": (heads, heads[:, :2],
                                            heads[:, :2]),
            "k/v 2 bytes past alignment": (heads.contiguous(), shifted,
                                           shifted)}


def phase_kernels_attn(dev) -> dict:
    """The flash-attention kernels against their plain version on card
    inputs: every S x (Hq, Hkv) x D x mask x dtype of the grid above, fp32
    on the SIMT route and bf16 on the wgmma route, then bf16 in layouts TMA
    cannot take on the SIMT route, within the reference's tolerances, and
    run to run bitwise; then the refusals."""
    import itertools

    import torch

    from repro_torch.kernels.flash_attn import ops, ref

    saved, saved_routes = launch_counters(), attn_routes()
    reset_launch_counters()
    err = {"float32": 0.0, "bfloat16": 0.0}
    want_routes = dict.fromkeys(attn_routes(), 0)

    def check(q, k, v, causal, window, way, what):
        dt = str(q.dtype).removeprefix("torch.")
        if ops.route(q, k, v) != way:
            raise AssertionError(f"[kernels_attn] {what}: route "
                                 f"{ops.route(q, k, v)}, expected {way}")
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        again = ops.flash_attention(q, k, v, causal=causal, window=window)
        want_routes[way] += 2
        want = ref.attention(q, k, v, causal=causal, window=window,
                             block_q=1024)
        torch.cuda.synchronize(dev)
        if not torch.equal(got, again):
            raise AssertionError(f"[kernels_attn] {what}: two runs differ")
        rtol, atol = ATTN_TOL[dt]
        torch.testing.assert_close(got.float(), want.float(), rtol=rtol,
                                   atol=atol,
                                   msg=lambda m: f"[kernels_attn] {what}: {m}")
        err[dt] = max(err[dt], (got.float() - want.float()).abs().max().item())

    n = 0
    for i, (s, (hq, hkv), d, (causal, window), dt) in enumerate(
            itertools.product(ATTN_SEQS, ATTN_HEADS, ATTN_DIMS, ATTN_MASKS,
                              ("float32", "bfloat16"))):
        q, k, v = attn_inputs(dev, i, 2, hq, hkv, s, d, getattr(torch, dt))
        check(q, k, v, causal, window, ATTN_ROUTE[dt],
              f"S={s} Hq={hq} Hkv={hkv} D={d} causal={causal} "
              f"window={window} {dt}")
        n += 1
        del q, k, v
    unaligned = unaligned_bf16_attn_inputs(dev, n)
    for what, (q, k, v) in unaligned.items():
        check(q, k, v, True, 64, "simt",
              f"S={ATTN_UNALIGNED_SEQ} bf16, {what}")
    n_unaligned = len(unaligned)
    del unaligned
    q, k, v = attn_inputs(dev, 0, 1, 4, 2, 64, 64, torch.bfloat16)
    refusals = ((ValueError, lambda: ops.flash_attention(q[:, :, :32], k, v)),
                (RuntimeError, lambda: ops.flash_attention(
                    q.clone().requires_grad_(), k, v)))
    for exc, call in refusals:
        try:
            call()
        except exc:
            continue
        raise AssertionError(f"[kernels_attn] no {exc.__name__} raised")
    routes = attn_routes()
    if routes != want_routes:
        raise AssertionError(f"[kernels_attn] launches by route {routes}, "
                             f"expected {want_routes}")
    set_launch_counters(saved)         # checks are not the main path's
    set_attn_routes(saved_routes)
    torch.cuda.empty_cache()
    log(f"[kernels_attn] {n} cases (S {ATTN_SEQS} x (Hq, Hkv) {ATTN_HEADS} "
        f"x D {ATTN_DIMS} x causal / window 64 / non-causal x fp32, bf16; "
        f"B=2) and {n_unaligned} bf16 layouts TMA cannot take (S="
        f"{ATTN_UNALIGNED_SEQ}, Hq=4, Hkv=2, D=64, window 64: a "
        f"260-element sequence stride, k/v 2 bytes past alignment) within "
        f"the reference's tolerances of the plain version and bitwise run "
        f"to run: max |kernel - plain| fp32 {err['float32']:.3e}, bf16 "
        f"{err['bfloat16']:.3e}; launches by route (two per case): simt "
        f"{routes['simt']} (fp32 and the unaligned bf16), wgmma "
        f"{routes['wgmma']} (bf16); Sq != Sk and requires_grad raise")
    return {"cases": n + n_unaligned, "max_abs_err": err,
            "routes": routes}


def phase_prefill(dev) -> dict:
    """``build_prefill`` on llama3.2-1b at full width, 16 layers: at S=4096,
    for each seed of ``PREFILL_CHECK_SEEDS``, the kernel prefill against
    the fp32 blockwise (plain attention) prefill on the same weights and
    tokens, at fp32 and at bf16 compute; at S=32768 one warm, one timed and
    one profiled prefill, each launching the kernel once per layer."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import build_prefill

    cfg = get_config(ARCH)
    model = build_model(cfg)
    _check_full_width(model.cfg, 16, "prefill")
    layers = model.cfg.num_layers

    def tokens(s, seed):
        gen = torch.Generator(device=dev).manual_seed(seed)
        return torch.randint(0, model.cfg.vocab_size, (1, s), generator=gen,
                             device=dev, dtype=torch.int32)

    def kernel_prefill(fn, params, batch, what, route="wgmma"):
        reset_launch_counters()
        logits = fn(params, batch)
        torch.cuda.synchronize(dev)
        counts, routes = launch_counters(), attn_routes()
        if counts != dict(dict.fromkeys(counts, 0), flash_attn=layers):
            raise AssertionError(f"[prefill] {what}: launches {counts}, "
                                 f"expected {layers} flash_attn and no other")
        if routes != dict(dict.fromkeys(routes, 0), **{route: layers}):
            raise AssertionError(f"[prefill] {what}: flash_attn launches by "
                                 f"route {routes}, expected {layers} of "
                                 f"{route} and no other")
        return logits

    def error(got, want, rtol, atol):
        if not bool(torch.isfinite(got).all()):
            raise AssertionError("[prefill] non-finite logits")
        diff = (got.float() - want).abs()
        return {"max_abs_diff": diff.max().item(),
                "rel_l2": (diff.norm() / want.norm()).item(),
                "outside": int((diff > atol + rtol * want.abs()).sum())}

    # Every prefill is held against the fp32 blockwise prefill.  At fp32
    # compute only the order of the sums differs, so the kernel prefill is
    # held elementwise at the CPU prefill test's fp32 tolerance.  At bf16
    # compute (the config's) both prefills round every layer's activations
    # to bf16 and their errors grow through 16 layers (a few logits of
    # either miss the engine's elementwise tolerance), so the kernel
    # prefill's error is held to the blockwise prefill's: its relative L2
    # and its count of elementwise misses at most the margins above times
    # the blockwise prefill's.
    shape = ShapeConfig("prefill_check", PREFILL_CHECK_SEQ, 1, "prefill")
    m32, m16 = (build_model(cfg.with_(dtype=dt))
                for dt in ("float32", "bfloat16"))
    check = {}
    t_check = time.perf_counter()
    for seed in PREFILL_CHECK_SEEDS:
        params = m32.init(torch.Generator(device=dev).manual_seed(seed), dev)
        batch = {"tokens": tokens(PREFILL_CHECK_SEQ, seed + 1)}
        what = f"S={PREFILL_CHECK_SEQ} seed {seed}"
        want = build_prefill(m32, shape, attn_impl="blockwise",
                             device=dev)(params, batch).float()
        row = {"fp32": error(kernel_prefill(build_prefill(m32, shape,
                                                          device=dev),
                                            params, batch, f"{what} fp32",
                                            route="simt"),
                             want, PREFILL_FP32_TOL, PREFILL_FP32_TOL),
               "bf16_kernel": error(kernel_prefill(
                   build_prefill(m16, shape, device=dev), params, batch,
                   f"{what} bf16"), want, ENGINE_RTOL, ENGINE_ATOL),
               "bf16_blockwise": error(build_prefill(
                   m16, shape, attn_impl="blockwise", device=dev)(
                       params, batch), want, ENGINE_RTOL, ENGINE_ATOL)}
        check[f"seed{seed}"] = row
        del params, batch, want
        gc.collect()
        torch.cuda.empty_cache()
        for name, e in row.items():
            tol = ("rtol/atol 1e-4" if name == "fp32"
                   else "rtol 2e-2 / atol 5e-2")
            log(f"[prefill] llama3.2-1b 16 layers, B=1 {what}, {name} vs "
                f"fp32 blockwise: max |logit diff| {e['max_abs_diff']:.4e}, "
                f"relative L2 {e['rel_l2']:.4e}, {e['outside']} logits "
                f"outside {tol}")
        if row["fp32"]["outside"]:
            raise AssertionError(f"[prefill] {what} fp32: kernel prefill "
                                 f"and blockwise prefill differ elementwise")
        for key, margin in (("rel_l2", PREFILL_BF16_L2_MARGIN),
                            ("outside", PREFILL_BF16_MISS_MARGIN)):
            got, base = row["bf16_kernel"][key], row["bf16_blockwise"][key]
            if got > margin * base:
                raise AssertionError(
                    f"[prefill] {what} bf16: the kernel prefill's {key} "
                    f"{got:.4e} is above {margin} x the blockwise "
                    f"prefill's {base:.4e}")
        ratios = {}
        for key in ("rel_l2", "outside"):
            got, base = row["bf16_kernel"][key], row["bf16_blockwise"][key]
            ratios[key] = got / base if base else (math.inf if got else 1.0)
        row["ratios"] = ratios
        log(f"[prefill] {what} bf16_kernel / bf16_blockwise: relative L2 "
            f"{ratios['rel_l2']:.4f} (gate {PREFILL_BF16_L2_MARGIN}), misses "
            f"{ratios['outside']:.4f} (gate {PREFILL_BF16_MISS_MARGIN})")
    log(f"[prefill] flash_attn launches {layers} per kernel prefill: the "
        f"SIMT kernel at fp32, the wgmma kernel at bf16; the "
        f"{len(PREFILL_CHECK_SEEDS)} seeds' check took "
        f"{time.perf_counter() - t_check:.1f} s")

    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    shape = ShapeConfig("prefill_32k_b1", PREFILL_SEQ, 1, "prefill")
    prefill = build_prefill(model, shape, device=dev)
    batch = {"tokens": tokens(PREFILL_SEQ, 1)}
    kernel_prefill(prefill, params, batch, "warm-up")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    logits = kernel_prefill(prefill, params, batch, "timed")
    wall = time.perf_counter() - t0
    timed_launches = attn_routes()      # kernel_prefill held them to 16 / 0
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(logits.shape) != (1, PREFILL_SEQ, model.cfg.vocab_size):
        raise AssertionError(f"[prefill] logits {tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[prefill] S=32768: non-finite logits")
    del logits
    gc.collect()
    reset_launch_counters()
    prof_wall, by_name, counts = device_activity(
        lambda: prefill(params, batch), 1, warm=False)
    counts_prof, routes_prof = launch_counters(), attn_routes()
    if (counts_prof != dict(dict.fromkeys(counts_prof, 0), flash_attn=layers)
            or routes_prof != dict(dict.fromkeys(routes_prof, 0),
                                   wgmma=layers)):
        raise AssertionError(f"[prefill] profiled: launches {counts_prof}, "
                             f"by route {routes_prof}, expected {layers} "
                             f"wgmma and no other")
    launched = routes_prof["wgmma"]
    if not by_name:
        raise RuntimeError("[prefill] no device activity in a prefill")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    seen = port_kernels_seen(counts)
    log(f"[prefill] B=1 S={PREFILL_SEQ}: wall {wall * 1e3:.1f} ms "
        f"({PREFILL_SEQ / wall:.0f} tokens/s), peak "
        f"{peak / 2**30:.2f} GiB, logits finite; flash_attn launches in "
        f"the timed prefill: wgmma {timed_launches['wgmma']}, simt "
        f"{timed_launches['simt']} ({layers} each in the warm, timed and "
        f"profiled ones)")
    log(f"[prefill] profiled prefill: wall {prof_wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}; the profiler "
        f"recorded {seen} of the {launched} flash_attn launches")
    for name, ms in top:
        log(f"[prefill]   {ms:9.2f} ms/prefill  {name[:90]}")
    del params, batch, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return {"check": check, "launches": timed_launches["wgmma"],
            "launches_by_route": timed_launches, "wall_ms": wall * 1e3,
            "peak_bytes": peak, "tokens_per_s": PREFILL_SEQ / wall,
            "profile": {"wall_ms": prof_wall, "device_ms": busy,
                        "idle_share": 1 - busy / prof_wall,
                        "port_kernels": {"launched": launched,
                                         "recorded": seen},
                        "top_device_ms": {k[:90]: v for k, v in top}}}


def phase_serve_contiguous(dev) -> dict:
    """``launch.serve`` without ``--paged``: the contiguous-cache loop on
    llama3.2-1b at full width with the reference's defaults (batch 4, cache
    512, 16 tokens).  It decodes with plain attention, as the reference's
    ``decode_attention``, so it launches no kernel."""
    import gc

    import torch

    from repro_torch.launch import serve

    args = serve.parser().parse_args(["--arch", ARCH, "--device", "cuda",
                                      "--seed", "0"])
    reset_launch_counters()
    out = serve.run_contiguous(args)
    counts = launch_counters()
    logits = out.pop("logits")
    if tuple(logits.shape) != (args.batch, 128256):
        raise AssertionError(f"[serve_contiguous] logits "
                             f"{tuple(logits.shape)}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[serve_contiguous] non-finite logits")
    if any(counts.values()):
        raise AssertionError(f"[serve_contiguous] launches {counts}: the "
                             f"contiguous decode runs no kernel")
    log(f"[serve_contiguous] llama3.2-1b 16 layers, batch {args.batch}, "
        f"cache {args.cache}, {args.tokens} tokens: "
        f"{out['tokens_per_s']:.1f} tok/s ({out['wall_s'] * 1e3:.0f} ms, "
        f"first step included), logits finite, no kernel launched")
    del logits
    gc.collect()
    torch.cuda.empty_cache()
    return {**out, "batch": args.batch, "cache": args.cache,
            "tokens": args.tokens}


def wgmma_executed_flops(b: int, hq: int, s: int, d: int) -> int:
    """The tensor-core flops the wgmma kernel executes, causal without a
    window: every key tile it runs, masked entries included, at 2*D flops
    per (query, key) for Q.K^T and twice that for P.V (P split into two
    bf16 halves).  Its tiles are those of flash_attn_wgmma.cu: 128 query
    rows (kBQ) by 128 keys up to D=64, 64 at D=128 (Cfg<D>::BK)."""
    bq, bk = 128, (128 if d <= 64 else 64)
    nk = -(-s // bk)
    tiles = sum(min(nk, (q0 + bq - 1) // bk + 1) for q0 in range(0, s, bq))
    return b * hq * tiles * bq * bk * 6 * d


def attention_p_rounded_once(q, k, v, block_q: int):
    """The plain causal attention with one change: p = exp(s - max) enters
    P.V rounded once to bf16, while l sums the fp32 p; what a kernel that
    rounds p once computes.  The control of the 32k relative L2 check."""
    import torch

    from repro_torch.kernels.flash_attn import ref

    s_len, d = q.shape[2], q.shape[3]
    k = k.repeat_interleave(q.shape[1] // k.shape[1], dim=1).float()
    v = v.repeat_interleave(q.shape[1] // v.shape[1], dim=1).float()
    k_pos = torch.arange(s_len, device=q.device)
    outs = []
    for q0 in range(0, s_len, block_q):
        q1 = min(q0 + block_q, s_len)
        sc = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].float(), k)
        sc.mul_(1.0 / math.sqrt(d))
        q_pos = torch.arange(q0, q1, device=q.device)[:, None]
        sc.masked_fill_(k_pos[None, :] > q_pos, ref.NEG_INF)
        p = sc.sub_(sc.amax(-1, keepdim=True)).exp_()
        l = p.sum(-1, keepdim=True)
        o = torch.einsum("bhqk,bhkd->bhqd", p.bfloat16().float(), v)
        outs.append((o / l).to(q.dtype))
        del sc, p
    return torch.cat(outs, dim=2)


def relative_l2(got, want) -> float:
    """||got - want|| / ||want||, summed in fp64."""
    return ((got.double() - want.double()).norm()
            / want.double().norm()).item()


def phase_timing_attn(dev) -> dict:
    """Time per call of the wgmma flash-attention kernel at one prefill
    layer's shape (q (1, 32, 32768, 64), k/v (1, 8, 32768, 64), bf16,
    causal), beside its plain version (query blocks of 1024, so that each
    block's fp32 scores take 4.3 GB), PyTorch's fused
    ``scaled_dot_product_attention`` (yardstick only: its flash backend
    rounds P to bf16, the kernel keeps it at about 2^-17) and the bound
    the card's bf16 rate sets for the function's work; the kernel's output
    is first held against the plain version's there.  Both are also timed
    at S=4096, and the fp32 route (the SIMT kernel), its plain version and
    SDPA at fp32, S=4096."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn import ops, ref

    b, hq, hkv, d = 1, 32, 8, 64
    q, k, v = attn_inputs(dev, 21, b, hq, hkv, PREFILL_SEQ, d, torch.bfloat16)
    short = [t[:, :, :PREFILL_CHECK_SEQ].contiguous() for t in (q, k, v)]
    short32 = [t.float() for t in short]
    # the fused backends only: the math backend would build the whole
    # (1, 32, 32768, 32768) score matrix at once
    fused = [SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
             SDPBackend.CUDNN_ATTENTION]

    def library():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)

    # at fp32 only the memory-efficient backend runs; kv heads repeated
    # beforehand, outside the timed call
    rep32 = [short32[0]] + [t.repeat_interleave(hq // hkv, dim=1)
                            for t in short32[1:]]

    def library_fp32():
        with sdpa_kernel(fused):
            return F.scaled_dot_product_attention(*rep32, is_causal=True)

    for args, way in (((q, k, v), "wgmma"), (short, "wgmma"),
                      (short32, "simt")):
        if ops.route(*args) != way:
            raise AssertionError(f"[timing] flash_attn at q "
                                 f"{tuple(args[0].shape)} "
                                 f"{args[0].dtype}: route "
                                 f"{ops.route(*args)}, expected {way}")
    saved, saved_routes = launch_counters(), attn_routes()
    got = ops.flash_attention(q, k, v).float()
    want = ref.attention(q, k, v, block_q=1024).float()
    rtol, atol = ATTN_TOL["bfloat16"]
    torch.testing.assert_close(
        got, want, rtol=rtol, atol=atol,
        msg=lambda m: f"[timing] flash_attn at S={PREFILL_SEQ}: {m}")
    err = (got - want).abs().max().item()
    # the check that scales with the outputs; the control must fail it
    rel = {"kernel": relative_l2(got, want)}
    del got
    ctrl = attention_p_rounded_once(q, k, v, block_q=1024)
    rel["p_rounded_once"] = relative_l2(ctrl, want)
    del ctrl, want
    log(f"[timing] flash_attn at S={PREFILL_SEQ}: relative L2 against the "
        f"plain version {rel['kernel']:.4e} (limit {ATTN_32K_REL_L2:.0e}); "
        f"the plain version with p rounded once to bf16 "
        f"{rel['p_rounded_once']:.4e}")
    if not rel["kernel"] <= ATTN_32K_REL_L2:
        raise AssertionError(f"[timing] flash_attn at S={PREFILL_SEQ}: "
                             f"relative L2 {rel['kernel']:.4e} > "
                             f"{ATTN_32K_REL_L2:.0e}")
    if rel["p_rounded_once"] <= ATTN_32K_REL_L2:
        raise AssertionError(f"[timing] flash_attn at S={PREFILL_SEQ}: the "
                             f"control (p rounded once) passes the relative "
                             f"L2 check ({rel['p_rounded_once']:.4e}): it "
                             f"cannot tell split P from one rounding")
    torch.cuda.empty_cache()
    # 10 calls of ~13 ms per window (the plain version: 3 of ~0.6 s): the
    # profiler keeps only some of the activities of long back-to-back calls
    # (PERF.md section 6)
    times = {"kernel": call_times(lambda: ops.flash_attention(q, k, v), 10),
             "plain": call_times(
                 lambda: ref.attention(q, k, v, block_q=1024), 3),
             "library": call_times(library, 10),
             "kernel_4096": call_times(
                 lambda: ops.flash_attention(*short), 10),
             "plain_4096": call_times(
                 lambda: ref.attention(*short, block_q=1024), 10),
             "simt_fp32_4096": call_times(
                 lambda: ops.flash_attention(*short32), 10),
             "plain_fp32_4096": call_times(
                 lambda: ref.attention(*short32, block_q=1024), 10),
             "library_fp32_4096": call_times(library_fp32, 10)}
    set_launch_counters(saved)         # timing launches are not the path's
    set_attn_routes(saved_routes)
    s = PREFILL_SEQ
    # the bound counts the function's work, never what a kernel adds to it
    flops = ops.attention_flops(b, hq, s, d, causal=True)
    executed = wgmma_executed_flops(b, hq, s, d)
    nbytes = 2 * (2 * b * hq * s * d + 2 * b * hkv * s * d)   # q, o, k, v
    t_ops = flops / BF16_FLOPS_PER_S * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    # the fp32 route at S=4096: its own bound at the CUDA cores' fp32 rate
    flops_4096 = ops.attention_flops(b, hq, PREFILL_CHECK_SEQ, d, causal=True)
    out = {"ms": times["kernel"]["graph_ms"],
           "plain_ms": times["plain"]["graph_ms"],
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": times["library"]["graph_ms"],
           "max_abs_err": err, "rel_l2": rel,
           "kernel_4096_ms": times["kernel_4096"]["graph_ms"],
           "plain_4096_ms": times["plain_4096"]["graph_ms"],
           "simt_fp32_4096_ms": times["simt_fp32_4096"]["graph_ms"],
           "plain_fp32_4096_ms": times["plain_fp32_4096"]["graph_ms"],
           "library_fp32_4096_ms": times["library_fp32_4096"]["graph_ms"],
           "simt_fp32_4096_bound_ms": flops_4096 / FP32_FLOPS_PER_S * 1e3,
           "flops": flops, "executed_flops": executed, "bytes": nbytes,
           "times": times}
    log(f"[timing] flash_attn q (1, 32, {s}, 64), k/v (1, 8, {s}, 64) bf16 "
        f"causal: max |kernel - plain| {err:.3e} (atol {atol}); bound "
        f"{out['bound_ms']:.3f} ms ({out['bound_by']}: {flops:.4e} FLOP of "
        f"attention at 989 TFLOP/s bf16 dense; {nbytes} B at 3.35 TB/s); "
        f"wgmma kernel {out['ms']:.3f} ms, {flops / out['ms'] / 1e9:.1f} "
        f"TFLOP/s of attention, {out['bound_ms'] / out['ms']:.3f} of the "
        f"bound; it executes {executed:.4e} FLOP on the tensor cores (P "
        f"split, masked halves of diagonal tiles), "
        f"{executed / out['ms'] / 1e9:.1f} TFLOP/s executed; SDPA "
        f"{out['library_ms']:.3f} ms (rounds P to bf16), kernel / SDPA "
        f"{out['ms'] / out['library_ms']:.3f}; SIMT kernel at fp32, S=4096: "
        f"{out['simt_fp32_4096_ms']:.3f} ms against "
        f"{out['simt_fp32_4096_bound_ms']:.3f} ms at 67 TFLOP/s fp32, SDPA "
        f"at fp32 {out['library_fp32_4096_ms']:.3f} ms; time per call:")
    for name, t in times.items():
        log(times_line(name, t))
    del q, k, v, short, short32, rep32
    torch.cuda.empty_cache()
    return out


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
    phase_s: dict[str, float] = {}

    def run_phase(name, fn, *a, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*a, **kw)
        finally:
            phase_s[name] = time.perf_counter() - t0
            log(f"[phase] {name}: {phase_s[name]:.1f} s")

    run_phase("build", phase_build)
    # first, while this process holds nothing on the card: the two ranks
    # of the deepest phases get the whole of it
    train_ring_zero1 = run_phase("train_ring_zero1", phase_train_ring,
                                 ZERO1_RING_ARGS, "train_ring_zero1")
    train_ring_fsdp = run_phase(
        "train_ring_fsdp", phase_train_ring_fsdp, FSDP_RING_ARGS,
        "train_ring_fsdp", "ring", train_ring_zero1["ranks"][0]["losses"])
    kernel_err = run_phase("kernel", phase_kernel, dev)
    kernels_train = run_phase("kernels_train", phase_kernels_train, dev)
    serve, run = run_phase("serve", phase_serve, dev)
    profile = run_phase("profile", phase_profile, dev, run)
    engine_err = run_phase("engines", phase_engines, dev, run)
    del run
    timing = run_phase("timing", phase_timing, dev)
    fd_times = timing.pop("rows")
    torch.cuda.empty_cache()
    kernels_attn = run_phase("kernels_attn", phase_kernels_attn, dev)
    prefill = run_phase("prefill", phase_prefill, dev)
    serve_contiguous = run_phase("serve_contiguous", phase_serve_contiguous,
                                 dev)
    timing_attn = run_phase("timing_attn", phase_timing_attn, dev)
    train, train_layout = run_phase("train", phase_train, dev)
    train_ring = run_phase("train_ring", phase_train_ring, RING_ARGS,
                           "train_ring")
    ring0 = train_ring["ranks"][0]
    timing_train = run_phase("timing_train", phase_timing_train, dev,
                             ring0["hop_widths"], train_layout)
    kernels_int8 = run_phase("kernels_int8", phase_kernels_int8, dev)
    train_int8 = run_phase("train_int8", phase_train_int8, dev,
                           train["losses"])
    train_ring_int8 = run_phase("train_ring_int8", phase_train_ring,
                                RING_ARGS + INT8_ARGS, "train_ring_int8")
    ring8 = train_ring_int8["ranks"][0]
    log(f"[train_ring_int8] host staging through pinned memory over 3 "
        f"steps, rank 0 / rank 1: int8 wire "
        f"{train_ring_int8['staging_s'][0]:.3f} / "
        f"{train_ring_int8['staging_s'][1]:.3f} s, fp32 wire (train_ring) "
        f"{train_ring['staging_s'][0]:.3f} / "
        f"{train_ring['staging_s'][1]:.3f} s; step wall int8 "
        f"{', '.join(f'{x * 1e3:.0f}' for x in ring8['step_s'])} ms, fp32 "
        f"{', '.join(f'{x * 1e3:.0f}' for x in ring0['step_s'])} ms")
    timing_int8 = run_phase("timing_int8", phase_timing_int8, dev,
                            ring8["hop_width"], train_int8["max_segment"],
                            train_int8["block"])
    train_zero1 = run_phase("train_zero1", phase_train_zero1, dev,
                            train["losses"])
    train_ring_zero1_int8 = run_phase("train_ring_zero1_int8",
                                      phase_train_ring, ZERO1_INT8_ARGS,
                                      "train_ring_zero1_int8")
    train_fsdp = run_phase("train_fsdp", phase_train_fsdp, dev,
                           train_zero1["replicated_losses"])
    train_ring_fsdp_int8 = run_phase(
        "train_ring_fsdp_int8", phase_train_ring_fsdp, FSDP_INT8_ARGS,
        "train_ring_fsdp_int8", "native")
    prefill_gathered = run_phase("prefill_gathered", phase_prefill_gathered,
                                 dev)
    fsdp0 = train_ring_fsdp["ranks"][0]
    timing_fsdp = run_phase("timing_fsdp", phase_timing_fsdp, dev,
                            fsdp0["hop_widths"])
    train_ckpt = run_phase("train_ckpt", phase_train_ckpt, dev)
    train_ring_ckpt = run_phase("train_ring_ckpt", phase_train_ring_ckpt)
    z1, z8 = (train_ring_zero1["ranks"][0],
              train_ring_zero1_int8["ranks"][0])
    f8 = train_ring_fsdp_int8["ranks"][0]
    gpu = gpu_line()
    src = "src/repro_torch/kernels"
    launches = {"reduce_add": ring0["counts"]["reduce_add"],
                "pack_write": train["launches"]["write"],
                "pack_read": train["launches"]["read"],
                "quantize": ring8["counts"]["quantize"],
                "dequantize": ring8["counts"]["dequantize"],
                "pack_quant_write": train_int8["launches"]["pack_quant_write"],
                "pack_quant_read": train_int8["launches"]["pack_quant_read"]}
    # the kernel-vs-plain checks, and for the ring's kernels also the
    # two-rank phases' kernel step against the plain step (reduced
    # gradients, new parameters and, under the int8 wire, new "ef")
    errs = {**kernels_train["max_abs_err"], **kernels_int8["max_abs_err"]}
    errs["reduce_add"] = max(errs["reduce_add"],
                             *(o["max_diff"] for o in train_ring["ranks"]))
    int8_step = max(o["max_diff"] for o in train_ring_int8["ranks"]
                    + train_ring_zero1_int8["ranks"])
    for name in ("quantize", "dequantize", "pack_quant_write",
                 "pack_quant_read", "reduce_add"):
        errs[name] = max(errs[name], int8_step)
    zero1_step = max(train_zero1["max_diff"],
                     *(o["max_diff"] for o in train_ring_zero1["ranks"]))
    fsdp_step = max(train_fsdp["max_diff"],
                    *(o["max_diff"] for o in train_ring_fsdp["ranks"]))
    for name in ("reduce_add", "pack_write", "pack_read"):
        errs[name] = max(errs[name], zero1_step, fsdp_step)
    for name in ("pack_quant_write", "pack_quant_read"):
        errs[name] = max(errs[name], *(o["max_diff"] for o in
                                       train_ring_fsdp_int8["ranks"]))
    # each kernel's launches on the zero1 paths: one rank (train_zero1),
    # two ranks (train_ring_zero1) and two ranks over the int8 wire
    # (train_ring_zero1_int8), 3 steps each
    zero1_launches = {name: {"train_zero1": train_zero1["launches"][name],
                             "train_ring_zero1": z1["counts"][name],
                             "train_ring_zero1_int8": z8["counts"][name]}
                      for name in launches}
    # and on the fsdp paths: one rank (train_fsdp), two ranks over the ring
    # gather (train_ring_fsdp) and the native gather with the int8 arena
    # (train_ring_fsdp_int8), 3 steps each, and the gathered prefill
    # and on the resumed paths: each kernel's launches a step, equal in the
    # unbroken, the stopped and the resumed run (train_ckpt: one rank,
    # zero1; train_ring_ckpt: two ranks, zero1 over the int8 wire)
    ckpt_launches = {name: {
        "train_ckpt": train_ckpt["launches_per_step"][name],
        "train_ring_ckpt": train_ring_ckpt["ranks"][0][
            "launches_per_step"][name]}
        for name in list(launches) + ["flash_attn", "flash_decode"]}
    fsdp_launches = {name: {"train_fsdp": train_fsdp["launches"][name],
                            "train_ring_fsdp": fsdp0["counts"][name],
                            "train_ring_fsdp_int8": f8["counts"][name],
                            "prefill_gathered": (prefill_gathered["launches"]
                                                 if name == "flash_attn"
                                                 else 0)}
                     for name in list(launches) + ["flash_attn",
                                                   "flash_decode"]}
    rows = [{
        "name": "flash_decode", "route": "cuda",
        "source": f"{src}/flash_decode/csrc/flash_decode.cu",
        "replaces": "src/repro/kernels/flash_decode/flash_decode.py:91",
        "launches": serve["launches"],
        "launches_fsdp": fsdp_launches["flash_decode"],
        "launches_ckpt": ckpt_launches["flash_decode"],
        "max_abs_err": kernel_err, **timing}]
    for name, replaces in (
            ("reduce_add", "src/repro/kernels/reduce_add/reduce_add.py:46"),
            ("pack_write", "src/repro/kernels/pack/pack.py:64"),
            ("pack_read", "src/repro/kernels/pack/pack.py:89")):
        t = timing_train[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": (f"{src}/reduce_add/csrc/reduce_add.cu"
                       if name == "reduce_add" else f"{src}/pack/csrc/pack.cu"),
            "replaces": replaces, "launches": launches[name],
            "launches_zero1": zero1_launches[name],
            "launches_fsdp": fsdp_launches[name],
            "launches_ckpt": ckpt_launches[name],
            "max_abs_err": errs[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
        if name == "reduce_add":       # fsdp's ring mix, fp32 + bf16
            rows[-1]["fsdp_mix"] = {
                hop: {k: timing_fsdp[hop][k] for k in (
                    "elements", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms")} for hop in ("largest", "median")}
    for name, source, replaces in (
            ("quantize", "quant/csrc/quant.cu",
             "src/repro/kernels/quant/quant.py:56"),
            ("dequantize", "quant/csrc/quant.cu",
             "src/repro/kernels/quant/quant.py:77"),
            ("pack_quant_write", "pack_quant/csrc/pack_quant.cu",
             "src/repro/kernels/pack_quant/pack_quant.py:73"),
            ("pack_quant_read", "pack_quant/csrc/pack_quant.cu",
             "src/repro/kernels/pack_quant/pack_quant.py:108")):
        t = timing_int8[name]
        rows.append({
            "name": name, "route": "cuda", "source": f"{src}/{source}",
            "replaces": replaces, "launches": launches[name],
            "launches_zero1": zero1_launches[name],
            "launches_fsdp": fsdp_launches[name],
            "launches_ckpt": ckpt_launches[name],
            "max_abs_err": errs[name],
            **{k: t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                 "library_ms")}})
    rows.append({
        "name": "flash_attn", "route": "cuda",
        "source": f"{src}/flash_attn/csrc/flash_attn_wgmma.cu",
        "fp32_source": f"{src}/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:102",
        "launches": prefill["launches"],
        "launches_fsdp": fsdp_launches["flash_attn"],
        "launches_ckpt": ckpt_launches["flash_attn"],
        "max_abs_err": max(*kernels_attn["max_abs_err"].values(),
                           timing_attn["max_abs_err"]),
        **{k: timing_attn[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    kernels = {"kernels": rows, "gpu": gpu}
    if args.out is not None:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(
            {**kernels, "serve": serve, "engine_max_abs_err": engine_err,
             "flash_decode_times": fd_times, "profile": profile,
             "kernels_train": kernels_train, "train": train,
             "train_ring": train_ring, "timing_train": timing_train,
             "kernels_int8": kernels_int8, "train_int8": train_int8,
             "train_ring_int8": train_ring_int8, "timing_int8": timing_int8,
             "kernels_attn": kernels_attn, "prefill": prefill,
             "serve_contiguous": serve_contiguous, "timing_attn": timing_attn,
             "train_zero1": train_zero1, "train_ring_zero1": train_ring_zero1,
             "train_ring_zero1_int8": train_ring_zero1_int8,
             "train_fsdp": train_fsdp, "train_ring_fsdp": train_ring_fsdp,
             "train_ring_fsdp_int8": train_ring_fsdp_int8,
             "prefill_gathered": prefill_gathered,
             "timing_fsdp": timing_fsdp, "train_ckpt": train_ckpt,
             "train_ring_ckpt": train_ring_ckpt, "phase_s": phase_s,
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
