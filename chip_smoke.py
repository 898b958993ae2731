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
              64, 128} x causal, window 64 and non-causal x fp32 (the TF32
              mma kernel, 3xTF32) and bf16 (the wgmma kernel), then bf16 in
              two layouts TMA cannot take (a 260-element sequence stride,
              k/v 2 bytes past alignment) on the mma route, each case's
              route asserted and each route's launches counted (the
              reference's tolerances: rtol/atol 2e-5 at fp32, atol 3e-2 at
              bf16), run-to-run bitwise; the control, plain TF32 (one term,
              ``ref.attention_tf32_split``) at one fp32 grid case, must miss
              the fp32 tolerance; Sq != Sk and requires_grad raise;
9. prefill  — ``build_prefill`` on llama3.2-1b at full width (16 layers,
              seeded random weights): at B=1, S=4096, for ten seeds of
              weights and tokens, the kernel prefill against the fp32
              blockwise (plain attention) prefill: at fp32 compute every
              logit within rtol/atol 1e-4; at bf16 compute the kernel
              prefill's relative L2 error at most 1.05 times the bf16
              blockwise prefill's and its count of logits outside rtol
              2e-2 / atol 5e-2 at most 1.25 times; every fp32 prefill
              launches the mma kernel and every bf16 one the wgmma kernel,
              once per layer; at B=1, S=32768 (prefill_32k's length)
              one warm, one timed and one profiled prefill, every one
              launching the wgmma kernel once per layer (16), the mma
              kernel and every other kernel never, logits finite; wall,
              peak memory, device busy and idle share;
9b. dryrun — ``launch.dryrun`` on the card's host, on fake CUDA tensors:
              the dry-run of the full-width prefill at B=1, S=32768, world
              1, against the card's run of it: each kernel's fake-route
              calls == its launches, by route; the bytes the call
              asked the allocator for at its peak (``requested_bytes``)
              == predicted, exactly; the measured
              ``max_memory_allocated`` over the call within [predicted,
              predicted + the caching allocator's rounding: 511 B a
              storage alive at once, 1 MiB more a large one]; then
              llama3.2-1b ``train_4k`` as rank 0 of the 16 x 16 mesh over
              the fake process group, and its paged serve cell at R = 1,
              each record's seconds, peak, fit and roofline terms printed;
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
              timed there too, and both at S=4096; the mma kernel (fp32
              route; its relative L2 against fp64 at most 2x the plain
              version's), the plain version and SDPA at fp32, S=4096, beside
              the SIMT kernel's 5.222 ms and both bounds: the fp32 work
              at the CUDA cores' 67 TFLOP/s and three times it at 495
              TFLOP/s dense TF32;
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
              width at ``ZERO1_RING_LAYERS`` = 2 layers (16 until the
              tensor-parallel phases joined the script, 4 until the dryrun
              phase did);
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
23. train_ring_fsdp — two fsdp ranks at 2 layers over the ring
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
              seq 256, batch 8, full width at 2 layers (cut further, with
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
              to the unbroken run's; its resumed run writes no step
              directory of its own (the fifth job of the ``ring_ranks``
              spawn, below);
29. halo    — the paper's first workload: two ranks on the card over
              gloo, mesh (2, 1, 1, 1) over the axes x, y, z, t, a 32^4
              lattice of 24 fp32 a site (a Wilson spinor) a rank: for each
              of the four halo schedules (chunks 2, channels 2) the
              received faces bitwise the faces a ``torch.roll`` of the
              seeded global lattice gives, sends and bytes == the
              HaloPlan's units on the x axis (y, z, t wrap locally), the
              median exchange time, its GB/s and staging time (gloo
              through pinned host memory);
30. stencil — one rank: ``StencilOp.apply`` and ``EvenOddOp.apply`` on
              the card bitwise the port's CPU apply of the same field,
              one apply timed with CUDA events beside its bound (x read
              once, y written once), the device activities an apply makes;
31. stencil_cg — the CG family (cg, pipelined, s-step x none, even-odd;
              s 4, tol 1e-5, overlap, chunks 2, channels 2): on one rank
              every solve converges with a true residual below 1e-4
              through the global ``apply_reference``; on two ranks over
              gloo on psum and on ring_hier, each solution bitwise across
              the transports, the four schedules and the plain local add,
              ``reduce_add`` launches == the ring's adds an all-reduce x
              the all-reduces, the unrolled ladder (8 iterations) 17 / 8 /
              2 all-reduces and 2 x ``predicted_halo_exchanges`` sends;
              iterations, ms, all-reduces, the peak and one profiled
              solve's idle share on one and on two ranks;
32. train_tp — tensor parallelism: two ranks on the card over gloo on a
              (1, 2) ``("data", "model")`` mesh (``launch.train``
              ``--model-parallel 2``), full width, 8 layers (16 until
              the MoE phases joined the script), seq 256,
              batch 8, bf16 over fp32 masters, the arena on, 3 steps
              replicated then 3 zero1: losses finite and equal on both
              ranks, the leaves replicated over the model axis bitwise
              equal on both, pack writes and reads == segments x steps (all
              bulk), no ``reduce_add`` and nothing on the data axis of 1,
              the model axis's all-reduces the same on both ranks; a
              profiled step a mode; then the gate: 4 layers at fp32
              compute, losses within 5e-5 and gradient norms within rtol
              1e-4 of the one-rank replicated run (rank 0, a (1, 1) mesh);
33. prefill_tp — the resident prefill on the (1, 2) mesh, B=1, S=4096,
              bf16, weights model-sharded: 16 wgmma flash-attention
              launches a rank and no other; the vocab shards gathered, its
              relative L2 error against the fp32 blockwise one-rank prefill
              at most 1.25 times the one-rank bf16 kernel prefill's;
34. serve_contiguous_tp — ``launch.serve --model-parallel 2`` (the
              contiguous loop, batch 4, cache 512, 16 tokens; no kernel),
              its last logits within the engine's tolerance of the
              one-rank loop fed the same tokens (rows whose greedy token
              differs counted); one fp32 decode at position
              8000 against an 8192-slot cache of seeded random K/V,
              sequence-sharded (4096 slots a rank), within 2e-2 of the
              unsharded one-rank decode (the reference's SERVE_SCRIPT
              bound);
35. serve_tp — the paged engine at R = 2 (page-parallel decode, weights
              replicated) on the serve phase's trace, continuous policy:
              16 ``flash_decode`` launches a step a rank and no other
              kernel's (every counter read), K/V unexpanded,
              32 all-reduces and ``predicted_wire_bytes_per_token`` bytes
              a token (``CommRecord``); every live logit within the
              engine's tolerance of the R = 1 engine on the same step
              inputs (the scheduler's token stream), rows whose greedy
              token differs counted;
36. train_tp_fsdp — four ranks on the card over gloo on a (2, 2)
              ``("data", "model")`` mesh, one spawn, in turn: (a) fsdp
              (``launch.train --dp-mode fsdp --model-parallel 2``), full
              width, 4 layers, native bf16 gathers, the arena on, 3 steps,
              deterministic: losses finite and equal on all four ranks,
              pack writes and reads == group buckets x steps (all bulk),
              native gathers, reduce-scatters and their bytes ==
              :func:`fsdp_expected` (the model-local buckets), the model
              axis's all-reduces the same on every rank and ==
              :func:`tp_fsdp_model_all_reduces`; a profiled step; one step
              over the ring gather: ``reduce_add`` (fp32 + bf16) launches
              == the reduce-scatter's hops, sends == expected, its kernel
              step == its plain step bitwise (each its own backward pass);
              (b) the fp32 gate: 4 layers, fp32 compute and gathers,
              losses within 5e-5 and gradient norms within rtol 1e-4 of
              the one-rank replicated run; (c) the checkpoint: zero1 (the
              arch's default) with the arena at CKPT_LAYERS layers,
              train_ckpt's stop-and-resume check bitwise on all four ranks,
              the parameters laid out as model blocks (global arrays on
              disk), the flat leaves gathered in rank order, the bytes,
              the save's blocking part and the restore; (d) the gathered
              prefill: ``build_prefill(weight_mode="gathered")`` on (2, 2),
              16 layers, B=2, S=4096, bf16: 16 wgmma flash-attention
              launches a rank and no other kernel's, this rank's logits
              within the engine's bf16 tolerance of the resident prefill
              on the same mesh with the same weights.
37. moe_serve — mixtral-8x7b at full width (d_model 4096, 32 q / 8 kv
              heads of 128, a 4096 window, 8 experts top-2 of 14336,
              capacity factor 1.25, vocab 32000, untied head), 2 layers,
              one rank: ``build_prefill`` at B=1, S=8192 (the window
              masks; 2560 slots an expert): 2 flash_attn launches, both
              wgmma, and no other kernel's; the logits against the same
              prefill on the plain (blockwise) attention: on every token
              the router sends to the same experts in both, within the
              engine tolerance (the tokens a bf16 near-tie reroutes are
              counted and reported); the prefill's ``moe_drop_fraction``;
              then the contiguous decode loop at the serve CLI's defaults
              (batch 4, 512 slots, 16 tokens; no kernel launched) with
              tokens/s and a profiled step's wall and idle share;
38. moe_train — ``launch.train`` on mixtral at full width, 1 layer, one
              rank, the arch's settings (fsdp, 4 microbatches,
              ``ring_hier`` over 2 channels), the arena on, 3 steps:
              losses finite, ``moe_drop_fraction`` a step, pack writes
              and reads == :func:`fsdp_expected` (a write a segment a
              microbatch, a read a step; all bulk), the peak, a profiled
              step;
39. moe_ep  — two ranks on the card over gloo on (1, 2), mixtral at full
              width, 1 layer, its 8 experts sharded 4 a rank
              (``parallelism="ep"`` through ``launch.train.setup``'s
              ``model_overrides``), the arch's settings and its EP
              communicator (``a2a`` over 2 rails), 3 steps: every step's
              ``all_to_all_single`` calls and bytes and the model axis's
              all-gathers == :func:`moe_ep_expected` (from the code and
              ``A2APlan``), the model-axis all-reduces and the EP staging
              printed, pack == :func:`fsdp_expected`, losses and drop
              fractions equal on both ranks, a profiled step; one MoE
              layer at full width forward and backward through ``ring``
              and ``psum``: output and gradients equal the ``a2a`` run's;
              the fp32 gate: EP losses within 5e-5 of one rank.
40. ssm_serve — falcon-mamba-7b at full width and depth (64 Mamba-1
              blocks, d_inner 8192, state 16, dt_rank 256, vocab 65024),
              one rank: at fp32 compute 64 decode steps from an empty state
              against the prefill's logits at the same positions (rtol /
              atol 1e-3, the reference's decode-vs-scan tolerance); at bf16
              the prefill at B=2, S=2048 (wall, peak, a profiled prefill
              with CUDA events around every ``selective_scan``: the scan's
              share), 16 contiguous decode tokens (tok/s, a profiled
              step's idle share); no kernel launched (the scan is plain
              PyTorch, as the reference's is plain ``jnp``);
41. hybrid_serve — hymba-1.5b at full width and depth (32 layers of
              attention, 25 q / 5 kv heads of 64, 3 global and 29 windowed
              at 1024, beside Mamba heads): the prefill at B=1, S=4096,
              exactly 32 wgmma ``flash_attn`` launches and no other
              kernel's, held against the fp32 and the bf16 blockwise
              prefills as the prefill phase holds llama's; wall, peak, a
              profiled prefill; 16 decode tokens at positions 1016-1031,
              across the wrap of the 1024-slot rolling caches;
42. encdec_serve — whisper-base at full size (6 + 6 layers, 1500 frames):
              the decode state of B=4 (the encoder, 6 non-causal wgmma
              ``flash_attn`` launches, then the cross k/v), the encoder's
              output held against the fp32 and the bf16 blockwise
              encoders; 32 decode tokens against the cross caches, tok/s;
43. vlm_prefill — llava-next-34b at full width, 2 layers: the prefill at
              B=1, S=4096 (576 patch embeddings and 3520 tokens), 2 wgmma
              ``flash_attn`` launches, held against the blockwise
              prefills;
44. families_train — ``launch.train`` on hymba-1.5b at full width, 4
              layers, one rank, its settings (zero1, 2 microbatches) with
              the arena on, 3 steps: finite losses, pack writes == segments
              x microbatches x steps and reads == segments x steps (all
              bulk), the peak, a profiled step.
45. tune_probe — the measured auto-tuner (``tune.probe.probe_rank``) on
              two ranks over gloo: ``allreduce`` (``all_reduce_tree``) and
              ``arena`` over ring_hier and psum, channels 1 and 2, pages
              4096 and 2 MiB, 2^14, 2^18 and 2^22 elements, then one small
              ``halo`` (ring_hier) and one small ``cg`` (psum) group: every
              cell's predicted messages and bytes == what its recorded
              call put on the wire (``comm.plan.record_wire`` of its
              ``CommRecord``), ``reduce_add`` launches == hops x reduced
              buffers on ring_hier and 0 on psum, ``pack`` writes and reads
              == the arena's segments; rank 0 fits every group, writes the
              DB under ``build/tune_smoke/``, loads it again, and
              ``resolve_settings`` picks one of its records; each group's
              α, bandwidth and mean/max relative error printed;
46. tuned_train — the train CLI's setup on the same two ranks with
              ``--tuned`` (that DB) and ``--obs-predict``: llama3.2-1b at
              full width, 4 layers, zero1, the arena on, the data ring
              (``--model-parallel 1``), 3 steps: the ``tuned:`` line names
              a record of the probe, a ``prediction`` event with source
              ``tuned`` and no ``predict_failed``, a drift sample and a
              ``model_error`` gauge every step, every step's wire (all its
              records) == the predicted messages and bytes, the predicted
              step against the measured ones.
47. rails   — the same two ranks: llama3.2-1b's gradient tree at full
              width and 4 layers (the model's fp32 parameter shapes, random
              from a seed a rank) over ring_hier with the train CLI's 32 MiB
              buckets, on one rail and on two, where each rail's
              collectives run on a host thread and a CUDA stream of their
              own: ``all_reduce_tree`` and one fp32-arena
              ``reduce_scheduled`` step, two rails bitwise one, every rank
              the same tree, sends and bytes == ``CommPlan``, ``reduce_add``
              and ``pack`` launches as the code predicts (all bulk); one
              two-rail ``all_reduce_tree`` under ``torch.profiler`` between
              marker kernels on the caller's stream: ``reduce_add`` on one
              stream a rail with that rail's launches, the pinned staging
              copies on the same streams, none on the caller's; the walls
              of one and two rails, and of the per-tensor baseline and the
              default ``GradientReducer`` (each bitwise a ``Communicator``
              of its config) with their ratio, printed beside the card's
              name and power limit.

The phases before train_tp run data-only (``--model-parallel 1``).  The
two-rank train phases share two spawns, each running its phases' workers
in turn on one process group (:func:`spawn_in_turn`), right after the
build: ``ring_ranks_deterministic`` (train_ring_zero1, train_ring_fsdp)
and ``ring_ranks`` (train_ring, train_ring_int8, train_ring_zero1_int8,
train_ring_fsdp_int8, train_ring_ckpt, tune_probe, tuned_train, rails);
so do
the later two-rank phases, in ``stencil_tp_ranks`` (halo, stencil_cg's two ranks, train_tp,
prefill_tp, serve_contiguous_tp, serve_tp, moe_ep).  Until train_tp_fsdp joined
the script each paid a spawn of its own: two ranks' start-up (the
interpreters, the CUDA contexts, the kernels' loads, the full-width model
built) took about 30 s of each phase's 35-106 s.  Every check of every
phase holds as before: each worker runs as it did, its results checked by
the same code; between two workers the peak statistics are reset, the
card's cache emptied and deterministic algorithms switched off.
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
import shutil
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
    """flash_attn's launches by route: "wgmma" (bf16) and "mma" (fp32)."""
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


# --model-parallel 1: the data-only host mesh (the CLI's default puts two
# ranks on a model axis; the tensor-parallel phases come last)
TRAIN_ARGS = ["--arch", ARCH, "--dp-mode", "replicated", "--transport",
              "ring_hier", "--use-arena", "--seq", "256", "--batch", "8",
              "--steps", "3", "--device", "cuda", "--seed", "0",
              "--model-parallel", "1"]
# two ranks on one 80 GB card: full width, depth cut to 4 layers
RING_ARGS = TRAIN_ARGS + ["--layers", "4"]
INT8_ARGS = ["--wire-codec", "int8"]
# the same run with no --dp-mode: llama3.2-1b's own full-size default,
# zero1, resolves.  Two zero1 ranks fit on the card at the model's full
# depth with this phase's checks (33.4 GiB a rank at the peak on an 80 GB
# H100); the two-rank zero1 and fsdp phases run at 2 layers since the
# dryrun phase joined the script (4 since the tensor-parallel phases did,
# 16 before), to keep the script well inside its time limit; the phase
# runs first, while this process holds nothing there
ZERO1_ARGS = [a for i, a in enumerate(TRAIN_ARGS)
              if "--dp-mode" not in TRAIN_ARGS[max(i - 1, 0):i + 1]]
ZERO1_RING_LAYERS = 2
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
        step.cfg, comm=dataclasses.replace(
            step.cfg.comm_config(("pod", "data")), local_op="plain")),
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
    """One of two ranks of the train_ring phases (run by
    :func:`_workers_in_turn`): the fp32 arena, or with ``--wire-codec
    int8`` the int8 arena, and then, under the int8 wire or zero1, one step
    with the arena off (:func:`_bucket_pass`)."""
    import gc

    import torch

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
           // (2 * step.cfg.comm_config(("pod", "data")).chunks),
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


def _workers_in_turn(jobs: list) -> list[dict]:
    """In one spawned rank: each ``(worker, args)`` of ``jobs`` in turn on
    one process group, every worker's result beside its seconds; between
    two workers the peak-memory statistics are reset, the allocator's cache
    emptied and deterministic algorithms switched off; the group is
    destroyed at the end.  cuBLAS's reproducible workspace is set before
    the first CUDA call: the fsdp ring gather's kernel and plain steps each
    run their own backward pass."""
    import os

    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import gc

    import torch
    import torch.distributed as dist

    out = []
    try:
        for worker, args in jobs:
            if torch.cuda.is_initialized():
                torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            result = worker(*args)
            out.append({"result": result,
                        "seconds": time.perf_counter() - t0})
            del result
            gc.collect()
            torch.cuda.empty_cache()
            torch.use_deterministic_algorithms(False)
            torch.utils.deterministic.fill_uninitialized_memory = True
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    return out


def spawn_in_turn(tag: str, nproc: int, jobs: list) -> tuple[list, list]:
    """``jobs`` (``(worker, args)`` pairs) run in turn on ``nproc`` ranks
    spawned once on the card (:func:`_workers_in_turn`): a spawn and the
    ranks' start-up paid once for all of them.  Logs what the card holds
    before; returns, per job, the ranks' results and rank 0's seconds."""
    from repro_torch.launch import train as launch_train

    before = card_memory()
    log(f"[{tag}] before the ranks spawn: {before['card_used_mib']} of "
        f"{before['card_total_mib']} MiB of the card in use, this process's "
        f"allocator reserving {before['parent_reserved_bytes']} B")
    ranks = launch_train.spawn(_workers_in_turn, nproc, jobs, timeout=1000)
    results = [[r[i]["result"] for r in ranks] for i in range(len(jobs))]
    return results, [ranks[0][i]["seconds"] for i in range(len(jobs))]


def check_train_ring(ranks: list, tag: str) -> dict:
    """The checks of a two-rank train_ring phase (:func:`_ring_worker`'s
    results, full width at ``--layers``, two ranks on the one card over
    gloo)."""
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
    return {"ranks": ranks, "staging_s": staging}


# fsdp (ZeRO-3): the train phase's run with --dp-mode fsdp; two ranks at
# ZERO1_RING_LAYERS (their first two losses are train_ring_zero1's) over
# the ring gather (set on the step config the CLI builds: the reference's
# CLI has no flag for it), and over the native gather with the int8 arena
# at 4 layers
FSDP_ARGS = ["fsdp" if a == "replicated" else a for a in TRAIN_ARGS]
FSDP_RING_LAYERS = ZERO1_RING_LAYERS
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
    arena (the accumulation buffer) packs each gradient shard once a
    microbatch and reads it once a step (``pack``); the int8 arena, which
    cannot accumulate, packs once a step (``pack_quant``)."""
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
        segs = plan.arena_layout.n_segments
        if comm.codec is not None:
            counts.update(pack_quant_write=segs * steps,
                          pack_quant_read=segs * steps)
        else:
            counts.update(pack_write=segs * runs, pack_read=segs * steps)
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
    workspace, :func:`_workers_in_turn`): over the ring gather the
    reduce-scatter runs inside the backward pass, so the kernel and plain
    steps each run their own."""
    import gc

    import torch

    from repro_torch.core.ring import _channel_slices
    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_step import shard_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    _deterministic(torch)
    args = launch_train.parser().parse_args(argv)
    world = launch_train.init_distributed(args.device)
    over = {"fsdp_gather": gather}
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


def _check_wire(tag: str, record: dict, wire: dict) -> None:
    for key, want in wire.items():
        if record[key] != want:
            raise AssertionError(f"[{tag}] recorded {key} {record[key]} != "
                                 f"expected {want}")


def check_train_ring_fsdp(ranks: list, tag: str, gather: str,
                          zero1_losses: list[float] | None = None) -> dict:
    """The checks of a two-rank fsdp phase (:func:`_fsdp_ring_worker`'s
    results: two ranks on the one card over gloo, hops and native
    collectives staged through pinned host memory, full width at
    ``--layers``); when ``zero1_losses`` are given (train_ring_zero1's: the
    same seed, batches and depth, both deterministic), the first two
    losses are those bitwise (the bf16 gathers are zero1's bf16 casts
    before the first update moves a weight; see :func:`phase_train_fsdp`
    for the third)."""
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
    return {"ranks": ranks, "staging_s": staging, "dloss_vs_zero1": dloss}


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
# (the arena on), two ranks on the card over the int8 wire, and four ranks
# on a (2, 2) mesh (inside train_tp_fsdp); 2 layers since the
# tensor-parallel phases joined the script (4 until then)
CKPT_LAYERS, CKPT_STEPS, CKPT_STOP = 2, 4, 2
# bytes a step directory takes per parameter: params, mu, nu and the fp32
# arena (one rank); params, the global mu and nu, "ef" of both ranks and
# their int8 arenas (about 1 B a parameter each) at two ranks; params, the
# global mu and nu and the four ranks' fp32 arenas (each its model block,
# about half the parameters) on (2, 2)
CKPT_BYTES_PER_PARAM = {1: 16, 2: 22, 4: 20}


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
    whose two step directories (the stop's and, in train_ckpt, the resumed
    run's final save; counted for every phase) take at most 90 % of the
    free space there."""
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


def _ckpt_runs(argv: list[str], ckpt_dir: str, world, what: str) -> dict:
    """One rank's part of a several-rank checkpoint check (every rank runs
    it together, deterministic): the unbroken run, the run stopped at
    CKPT_STOP (its flat leaves gathered to rank 0 and, on a model axis, its
    model-sharded parameters assembled there; rank 0 writes), and the
    resumed run (which saves nothing), each with its launches and per-leaf
    digests."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    _deterministic(torch)

    def setup(extra):
        args = launch_train.parser().parse_args(argv + extra)
        run = launch_train.setup(args, world)
        _check_full_width(run.model.cfg, args.layers, what)
        return run

    def state_digest(trainer):
        return params_digest({k: v for k, v in trainer.state.items()
                              if k != "step"})

    def shard_digests(trainer):
        return {p: params_digest([t])[0]
                for p, t in _sharded_leaves(trainer).items()}

    run = setup([])
    mesh = run.trainer.step_fn.mesh.sizes()
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
    layout = run.trainer.step_fn.state_layout(run.trainer.state)
    rules = sorted({type(r).__name__ if not isinstance(r, str) else r
                    for r in _layout_rules(layout)})
    del run
    gc.collect()
    run, restore_s = _timed_restore(lambda: setup(["--ckpt-dir", ckpt_dir]))
    start = run.trainer.start_step
    restored = shard_digests(run.trainer)
    # the resumed run writes no step directory of its own: what this check
    # holds is the stop's save and its restore (train_ckpt times a resumed
    # run's save)
    run.trainer.ckpt = None
    reset_launch_counters()
    resumed = run.trainer.run()["history"]
    counts_res = launch_counters()
    res_digest = state_digest(run.trainer)
    record = run.trainer.step_fn.comm.record.as_dict()
    return {"backend": world.backend, "start": start, "mesh": mesh,
            "losses": [h["loss"] for h in full],
            "stopped_losses": [h["loss"] for h in stopped],
            "resumed_losses": [h["loss"] for h in resumed],
            "step_s": [h["sec"] for h in full],
            "resumed_step_s": [h["sec"] for h in resumed],
            "counts": {"unbroken": counts_full, "stopped": counts_stop,
                       "resumed": counts_res},
            "final_same": res_digest == full_digest,
            "n_leaves": len(full_digest), "rules": rules,
            "shards_same": saved == restored, "sharded": sorted(saved),
            "save_blocking_s": stop_times["save_s"][-1],
            "async_write_s": stop_times["wait_s"][-1],
            "restore_s": restore_s[0],
            "staging_s": record["staging_s"]}


def _layout_rules(layout) -> list:
    from repro_torch.checkpoint.ckpt import flatten_with_path

    return [rule for _, rule in flatten_with_path(layout)[0]]


def _ckpt_ring_worker(argv: list[str], ckpt_dir: str) -> dict:
    """One of the two ranks of train_ring_ckpt (:func:`_ckpt_runs`)."""
    import torch

    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    world = launch_train.init_distributed(
        launch_train.parser().parse_args(argv).device)
    return _ckpt_runs(argv, ckpt_dir, world, "train_ring_ckpt")


def check_ckpt_ranks(ranks: list, what: str, root: Path, layers: int,
                     disk: dict, int8: bool) -> dict:
    """The checks of :func:`_ckpt_runs` over its ranks: zero1 (``int8``:
    over the int8 wire with the int8 arena), full width at ``layers``
    layers, deterministic: the stop-and-resume check of train_ckpt,
    bitwise, with every rank's restored arena, ``"ef"`` and moment shards
    equal to what it saved and the launches a step of ``pack``,
    ``reduce_add`` and under the int8 wire ``pack_quant`` and ``quant``
    equal to the unbroken run's (on a model axis, the parameters laid out
    as model blocks); the step directory's bytes and times, then the
    directory deleted."""
    import shutil

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
        flat = {"['arena']", "['ef']"} if int8 else {"['arena']"}
        if not o["shards_same"] or not flat <= set(o["sharded"]):
            raise AssertionError(f"[{what}] rank {r}: restored shards "
                                 f"{o['sharded']} differ from what it saved")
        model_axis = o["mesh"].get("model", 1) > 1
        if model_axis and "Blocks" not in o["rules"]:
            raise AssertionError(f"[{what}] rank {r}: no model-sharded leaf "
                                 f"in the layout {o['rules']}")
        c = o["counts"]
        per = {name: _per_step(c[name], n, what) for name, n in (
            ("unbroken", CKPT_STEPS), ("stopped", CKPT_STOP),
            ("resumed", CKPT_STEPS - CKPT_STOP))}
        if not per["unbroken"] == per["stopped"] == per["resumed"]:
            raise AssertionError(f"[{what}] rank {r}: launches a step "
                                 f"differ: {per}")
        for name in (("pack_read", "pack_quant_write", "pack_quant_read",
                      "quantize", "dequantize", "reduce_add") if int8 else
                     ("pack_write", "pack_read", "reduce_add")):
            if not per["unbroken"][name]:
                raise AssertionError(f"[{what}] rank {r}: no {name} launch")
        o["launches_per_step"] = per["unbroken"]
    if any(o["losses"] != ranks[0]["losses"] for o in ranks):
        raise AssertionError(f"[{what}] the ranks disagree on the loss")
    o = ranks[0]
    log(f"[{what}] {len(ranks)} ranks on one card over gloo, mesh "
        f"{o['mesh']}, zero1, {'int8' if int8 else 'fp32'} wire, {layers} "
        f"layers, deterministic: "
        f"losses {', '.join(f'{x:.6f}' for x in o['losses'])}; stopped at "
        f"{CKPT_STOP} and resumed: losses bitwise, final state "
        f"{o['n_leaves']} leaves bitwise (digests) on every rank, restored "
        f"{', '.join(o['sharded'])} bitwise what each rank saved; layout "
        f"rules {o['rules']}")
    log(f"[{what}] step directory {written} B ({written / 2**30:.2f} GiB, "
        f"global arrays): save blocking (host copy + gather to rank 0) "
        f"{', '.join(f'{x['save_blocking_s']:.3f}' for x in ranks)} s, "
        f"async write {o['async_write_s']:.3f} s (rank 0); restore "
        f"{', '.join(f'{x['restore_s']:.3f}' for x in ranks)} s (sha256 of "
        f"every file {verify_s:.3f} s); free disk {disk['free_bytes']} B")
    log(f"[{what}] launches a step {o['launches_per_step']} in all three "
        f"runs on every rank; step wall unbroken "
        f"{', '.join(f'{x * 1e3:.0f}' for x in o['step_s'])} ms, resumed "
        f"{', '.join(f'{x * 1e3:.0f}' for x in o['resumed_step_s'])} ms")
    shutil.rmtree(root)
    return {"ranks": ranks, "layers": layers, "written_bytes": written,
            "verify_s": verify_s, "disk": disk}


# the paper's first workload: a QCD-sized local lattice, 32^4 sites of a
# Wilson spinor (4 spins x 3 colours x complex = 24 fp32) a rank, the
# stencil on all four dims over the mesh axes x, y, z, t, the reference
# example's mass; the two-rank phases split x over the ranks
STENCIL_LOCAL = (32, 32, 32, 32, 24)
STENCIL_AXES = ("x", "y", "z", "t")
STENCIL_MESH2 = (2, 1, 1, 1)
STENCIL_MASS = 0.2
STENCIL_CG = dict(s=4, tol=1e-5, maxiter=300, schedule="overlap", chunks=2,
                  channels=2)
HALO_SCHEDULES = ("sequential", "concurrent", "chunked", "overlap")
HALO_REPEATS = 10
LADDER = {"cg": 17, "pipelined": 8, "sstep": 2}   # all-reduces at 8 iters


def stencil_op():
    from repro_torch.core.halo import HaloSpec
    from repro_torch.stencil import StencilOp

    return StencilOp(specs=tuple(HaloSpec(a, d, 1)
                                 for d, a in enumerate(STENCIL_AXES)),
                     mass=STENCIL_MASS)


def stencil_field(dev, seed: int, shape):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn(shape, generator=gen, device=dev)


def stencil_comm(transport: str, local_op: str = "kernel"):
    """A communicator of the two-rank mesh (2, 1, 1, 1), channels 2."""
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.core.topology import RankMesh

    return Communicator(RankMesh(STENCIL_AXES, STENCIL_MESH2),
                        CommConfig(transport=transport,
                                   data_axes=STENCIL_AXES, channels=2,
                                   local_op=local_op))


def _own_block(xg, rank: int):
    n = STENCIL_LOCAL[0]
    return xg.narrow(0, rank * n, n)


def _halo_worker() -> dict:
    """One of two ranks of the halo phase: every schedule's received faces
    against a ``torch.roll`` of the seeded global lattice, bitwise; sends
    and bytes against the HaloPlan; the median exchange time."""
    import statistics

    import torch
    import torch.distributed as dist

    from repro_torch.launch import train as launch_train

    world = launch_train.init_distributed("cuda")
    dev, rank = world.device, world.rank
    comm = stencil_comm("psum")
    specs = stencil_op().specs
    n = STENCIL_LOCAL[0]
    xg = stencil_field(dev, 25, (2 * n,) + STENCIL_LOCAL[1:])
    x = _own_block(xg, rank).contiguous()
    want = {}
    for s in specs:
        w = STENCIL_LOCAL[s.dim]
        want[(s.axis, "-")] = _own_block(
            torch.roll(xg, 1, dims=s.dim), rank).narrow(s.dim, 0, 1)
        want[(s.axis, "+")] = _own_block(
            torch.roll(xg, -1, dims=s.dim), rank).narrow(s.dim, w - 1, 1)
    out = {"backend": world.backend, "schedules": {}}
    for sched in HALO_SCHEDULES:
        comm.record.reset()
        got = comm.halo_exchange(x, specs, schedule=sched)
        torch.cuda.synchronize(dev)
        rec = comm.record.as_dict()
        same = all(torch.equal(got[k], v) for k, v in want.items())
        plan = comm.halo_plan(STENCIL_LOCAL, specs, schedule=sched)
        sizes = dict(zip(plan.axes, plan.axis_sizes))
        wire = [b for k, b in zip(plan.unit_keys, plan.unit_bytes)
                if sizes[k.rstrip("+-#0123456789")] > 1]
        times = []
        comm.record.reset()
        for _ in range(HALO_REPEATS):
            dist.barrier()
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            comm.halo_exchange(x, specs, schedule=sched)
            torch.cuda.synchronize(dev)
            times.append(time.perf_counter() - t0)
        out["schedules"][sched] = {
            "bitwise": same, "sends": rec["sends"],
            "send_bytes": rec["send_bytes"], "plan_sends": len(wire),
            "plan_bytes": sum(wire), "plan_units": plan.n_units,
            "median_s": statistics.median(times),
            "staging_s": comm.record.staging_s / HALO_REPEATS}
    return out


def check_halo(ranks: list) -> dict:
    """The checks of the halo phase (:func:`_halo_worker`'s results: two
    ranks on the one card over gloo, mesh (2, 1, 1, 1), a 32^4 x 24 fp32
    block a rank, the four halo schedules at chunks 2, channels 2)."""
    for r, o in enumerate(ranks):
        if o["backend"] != "gloo":
            raise AssertionError(f"[halo] rank {r} backend {o['backend']}")
        for sched, s in o["schedules"].items():
            if not s["bitwise"]:
                raise AssertionError(f"[halo] rank {r} {sched}: a received "
                                     f"face differs from the rolled lattice")
            if (s["sends"], s["send_bytes"]) != (s["plan_sends"],
                                                 s["plan_bytes"]):
                raise AssertionError(
                    f"[halo] rank {r} {sched}: recorded {s['sends']} sends "
                    f"/ {s['send_bytes']} B != the plan's units on axes of "
                    f"more than one rank, {s['plan_sends']} / "
                    f"{s['plan_bytes']} B")
    log(f"[halo] 2 ranks on one card over gloo (faces staged through pinned "
        f"host memory: these times are gloo on the host, not the card's "
        f"links), local {'x'.join(map(str, STENCIL_LOCAL))} fp32, mesh "
        f"{STENCIL_MESH2}: every face of every schedule bitwise a "
        f"torch.roll of the global lattice on both ranks; sends and bytes "
        f"== the HaloPlan's units on the x axis (y, z, t wrap locally)")
    for sched, s in ranks[0]["schedules"].items():
        gbs = s["send_bytes"] / s["median_s"] / 1e9
        log(f"[halo]   {sched:10s} {s['sends']} sends, {s['send_bytes']} B "
            f"a rank: median {s['median_s'] * 1e3:.3f} ms over "
            f"{HALO_REPEATS} (rank 1 "
            f"{ranks[1]['schedules'][sched]['median_s'] * 1e3:.3f}), "
            f"{gbs:.3f} GB/s a rank, staging {s['staging_s'] * 1e3:.3f} ms "
            f"an exchange")
    return {"ranks": ranks}


def phase_stencil(dev) -> dict:
    """One rank: ``StencilOp.apply`` and ``EvenOddOp.apply`` on the card
    bitwise the port's CPU apply of the same field, and one apply timed
    beside its bound (x read once, y written once)."""
    import torch

    from repro_torch.stencil import EvenOddOp

    op = stencil_op()
    eo = EvenOddOp(op, distributed=False)
    x = stencil_field(dev, 26, STENCIL_LOCAL)
    xe = x * eo.parity_mask(x.shape, True, device=dev)
    out = {}
    for name, fn, arg in (("apply", op.apply, x), ("schur", eo.apply, xe)):
        got = fn(arg).cpu()
        want = fn(arg.cpu())
        if not torch.equal(got, want):
            raise AssertionError(f"[stencil] {name}: the card's apply is not "
                                 f"the CPU's bitwise (max |diff| "
                                 f"{(got - want).abs().max().item():.3e})")
        out[f"{name}_max_abs_err"] = 0.0
    ref = op.apply_reference(x)
    if not torch.equal(op.apply(x), ref):
        raise AssertionError("[stencil] apply != apply_reference on the card")
    nbytes = 2 * x.numel() * x.element_size()
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    ms = events_ms(lambda: op.apply(x), 20)
    schur_ms = events_ms(lambda: eo.apply(xe), 10)
    wall, by_name, counts = device_activity(lambda: op.apply(x), 5)
    launches = sum(counts.values()) / 5
    log(f"[stencil] 1 rank, {'x'.join(map(str, STENCIL_LOCAL))} fp32 "
        f"({x.numel() * 4} B a field): StencilOp.apply and EvenOddOp.apply "
        f"on the card bitwise the CPU's, apply bitwise apply_reference")
    log(f"[stencil] apply {ms:.4f} ms (CUDA events, 20 eager calls) vs bound "
        f"{bound:.4f} ms ({nbytes} B at 3.35 TB/s): {ms / bound:.1f}x the "
        f"bound; {launches:.0f} device activities an apply (profiler); "
        f"Schur apply {schur_ms:.4f} ms")
    return {"ms": ms, "bound_ms": bound, "ratio": ms / bound,
            "schur_ms": schur_ms, "activities_per_apply": launches,
            "profiler_wall_ms": wall, "bytes": nbytes, **out}


def _solve_timed(dev, fn):
    import torch

    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    res = fn()
    torch.cuda.synchronize(dev)
    return res, (time.perf_counter() - t0) * 1e3


def _true_rel(op, x, b, comm=None) -> float:
    """``‖b − A x‖ / ‖b‖`` with the operator itself: the global reference
    form on one rank, the distributed apply and global sums on two."""
    import torch

    from repro_torch.stencil import global_sums

    if comm is None:
        r = b - op.apply_reference(x)
        return float(torch.linalg.vector_norm(r) /
                     torch.linalg.vector_norm(b))
    r = (b - op.apply(x, comm, schedule="overlap", chunks=2,
                      channels=2)).reshape(-1)
    rr, bb = global_sums(comm, torch.dot(r, r),
                         torch.dot(b.reshape(-1), b.reshape(-1)))
    return float(torch.sqrt(rr / bb))


def _stencil_cg_worker() -> dict:
    """One of two ranks of stencil_cg: the six solves on psum and on
    ring_hier (``reduce_add`` launches counted), on psum under the other
    schedules and on ring_hier with the plain local add (bitwise), the
    unrolled ladder, and one profiled solve on rank 0."""
    import torch

    from repro_torch.core.ring import _channel_slices
    from repro_torch.launch import train as launch_train
    from repro_torch.stencil import (PRECONDS, SOLVERS,
                                     predicted_halo_exchanges,
                                     predicted_reduction_collectives, solve)

    world = launch_train.init_distributed("cuda")
    dev, rank = world.device, world.rank
    op = stencil_op()
    comms = {t: stencil_comm(t.removesuffix("_plain"),
                             "plain" if t.endswith("_plain") else
                             "kernel")
             for t in ("psum", "ring_hier", "ring_hier_plain")}
    n = STENCIL_LOCAL[0]
    b = _own_block(stencil_field(dev, 28, (2 * n,) + STENCIL_LOCAL[1:]),
                   rank).contiguous()
    ring = comms["ring_hier"]
    flat = ring.transport.flat_divisor(ring.axis_sizes)
    adds = len(_channel_slices(flat // 2, ring.transport.ring_cfg))
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"backend": world.backend, "solves": {}, "ladder": {},
           "adds_per_all_reduce": adds}
    for solver in SOLVERS:
        for precond in PRECONDS:
            kw = dict(solver=solver, precond=precond, **STENCIL_CG)
            row = {}
            sols = {}
            for t in ("psum", "ring_hier"):
                solve(op, b, comms[t], **kw)         # warm, untimed
                reset_launch_counters()
                comms[t].record.reset()
                res, ms = _solve_timed(
                    dev, lambda: solve(op, b, comms[t], **kw))
                row[t] = {"iters": res.iters, "ms": ms,
                          "rel": float(res.rel_residual),
                          "launches": launch_counters(),
                          "record": comms[t].record.as_dict()}
                sols[t] = res.x
            row["true_rel"] = _true_rel(op, sols["psum"], b,
                                        comms["psum"])
            same = {"ring_hier": torch.equal(sols["ring_hier"],
                                             sols["psum"])}
            for sched in ("sequential", "concurrent", "chunked"):
                res = solve(op, b, comms["psum"],
                            **{**kw, "schedule": sched})
                same[sched] = torch.equal(res.x, sols["psum"])
            res = solve(op, b, comms["ring_hier_plain"], **kw)
            same["ring_hier_plain"] = torch.equal(res.x,
                                                  sols["ring_hier"])
            row["bitwise"] = same
            row["predicted_all_reduces"] = \
                predicted_reduction_collectives(
                    solver, row["ring_hier"]["iters"], s=4)
            out["solves"][f"{solver}/{precond}"] = row
            comm = comms["psum"]
            comm.record.reset()
            solve(op, b, comm, **{**kw, "tol": None, "maxiter": 8})
            rec = comm.record.as_dict()
            out["ladder"][f"{solver}/{precond}"] = {
                "all_reduces": rec["all_reduces"], "sends": rec["sends"],
                "predicted_sends": 2 * predicted_halo_exchanges(
                    solver, precond, 8, s=4)}
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)

    def one():
        solve(op, b, comms["ring_hier"], solver="cg", precond="none",
              **STENCIL_CG)

    if rank == 0:
        wall, by_name, _ = device_activity(one, 1, warm=False)
        busy = sum(by_name.values())
        out["profile"] = {"wall_ms": wall, "busy_ms": busy,
                          "idle_share": 1 - busy / wall}
    else:
        one()
    return out


def phase_stencil_cg(dev, ranks: list) -> dict:
    """The CG family on one rank (global true residual through
    ``apply_reference``), and the checks of its two ranks over gloo
    (:func:`_stencil_cg_worker`'s results ``ranks``: psum and ring_hier,
    every schedule, ``reduce_add`` launches, the ladder)."""
    import torch

    from repro_torch.kernels.reduce_add import ops as ra
    from repro_torch.kernels.reduce_add import ref as ra_ref
    from repro_torch.stencil import (PRECONDS, SOLVERS,
                                     predicted_reduction_collectives, solve)

    op = stencil_op()
    b = stencil_field(dev, 27, STENCIL_LOCAL)
    one_rank = {}
    for solver in SOLVERS:
        for precond in PRECONDS:
            kw = dict(solver=solver, precond=precond, **STENCIL_CG)
            # a warm solve first: the first of a kind starts library
            # handles (cuBLAS, cuSOLVER) and fills the allocator's cache
            solve(op, b, None, **kw)
            torch.cuda.reset_peak_memory_stats(dev)
            res, ms = _solve_timed(dev, lambda: solve(op, b, None, **kw))
            true_rel = _true_rel(op, res.x, b)
            rel = float(res.rel_residual)
            if not (rel <= 1e-5 and res.iters < STENCIL_CG["maxiter"]
                    and true_rel < 1e-4):
                raise AssertionError(f"[stencil_cg] 1 rank {solver}/{precond}"
                                     f": iters {res.iters}, rel {rel:.3e}, "
                                     f"true {true_rel:.3e}")
            one_rank[f"{solver}/{precond}"] = {
                "iters": res.iters, "ms": ms, "rel": rel,
                "true_rel": true_rel,
                "reductions": predicted_reduction_collectives(
                    solver, res.iters, s=4),
                "peak_bytes": torch.cuda.max_memory_allocated(dev)}
    wall, by_name, _ = device_activity(
        lambda: solve(op, b, None, solver="cg", precond="none", **STENCIL_CG),
        1, warm=False)
    busy = sum(by_name.values())
    prof1 = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall}
    del b
    # reduce_add at the CG path's hop: a 64-element slice of the padded
    # 512-element buffer of partial dots (not the main path's launches)
    saved = launch_counters()
    gen = torch.Generator(device=dev).manual_seed(29)
    x, y = (torch.randn(64, generator=gen, device=dev) for _ in range(2))
    got = ra.add_accum(x, y)
    err = (got - ra_ref.add_accum(x, y)).abs().max().item()
    if not torch.equal(got, ra_ref.add_accum(x, y)):
        raise AssertionError(f"[stencil_cg] reduce_add at the CG hop: not "
                             f"bitwise (max |diff| {err:.3e})")
    set_launch_counters(saved)
    torch.cuda.empty_cache()

    launched = 0
    for r, o in enumerate(ranks):
        if o["backend"] != "gloo":
            raise AssertionError(f"[stencil_cg] rank {r} backend "
                                 f"{o['backend']}")
        for key, row in o["solves"].items():
            for t in ("psum", "ring_hier"):
                if not (row[t]["rel"] <= 1e-5
                        and row[t]["iters"] < STENCIL_CG["maxiter"]):
                    raise AssertionError(f"[stencil_cg] rank {r} {key} {t}: "
                                         f"{row[t]}")
            if row["true_rel"] >= 1e-4:
                raise AssertionError(f"[stencil_cg] rank {r} {key}: true "
                                     f"residual {row['true_rel']:.3e}")
            if not all(row["bitwise"].values()):
                raise AssertionError(f"[stencil_cg] rank {r} {key}: not "
                                     f"bitwise {row['bitwise']}")
            want = {name: 0 for name in row["ring_hier"]["launches"]}
            want["reduce_add"] = (o["adds_per_all_reduce"]
                                  * row["predicted_all_reduces"])
            if row["ring_hier"]["launches"] != want:
                raise AssertionError(f"[stencil_cg] rank {r} {key}: launches "
                                     f"{row['ring_hier']['launches']} != "
                                     f"{want}")
            if row["psum"]["record"]["all_reduces"] != \
                    predicted_reduction_collectives(
                        key.split("/")[0], row["psum"]["iters"], s=4):
                raise AssertionError(f"[stencil_cg] rank {r} {key}: psum "
                                     f"all-reduces {row['psum']['record']}")
            if r == 0:
                launched += want["reduce_add"]
        for key, lad in o["ladder"].items():
            if lad["all_reduces"] != LADDER[key.split("/")[0]] or \
                    lad["sends"] != lad["predicted_sends"]:
                raise AssertionError(f"[stencil_cg] rank {r} ladder {key}: "
                                     f"{lad}")
    if launched == 0:
        raise AssertionError("[stencil_cg] the ring made no reduce_add "
                             "launch")
    log(f"[stencil_cg] 1 rank, {'x'.join(map(str, STENCIL_LOCAL))} fp32, "
        f"mass {STENCIL_MASS}, overlap, s 4, tol 1e-5: every solve "
        f"converged, true ‖b - Ax‖/‖b‖ < 1e-4 through apply_reference")
    for key, row in one_rank.items():
        log(f"[stencil_cg]   {key:14s} iters {row['iters']:3d}, reductions "
            f"{row['reductions']:3d}, {row['ms']:8.1f} ms, rel "
            f"{row['rel']:.2e}, true {row['true_rel']:.2e}, peak "
            f"{row['peak_bytes'] / 2**30:.2f} GiB")
    log(f"[stencil_cg] 1 rank, profiled cg/none: wall "
        f"{prof1['wall_ms']:.1f} ms, device busy {prof1['busy_ms']:.1f} ms, "
        f"idle share {prof1['idle_share']:.3f}")
    o = ranks[0]
    log(f"[stencil_cg] 2 ranks over gloo, mesh {STENCIL_MESH2}: each "
        f"solution bitwise across psum and ring_hier, across the four "
        f"schedules and with the plain local add, on both ranks; "
        f"reduce_add launches == {o['adds_per_all_reduce']} a ring "
        f"all-reduce x the all-reduces; psum all-reduces == "
        f"predicted; ladder at 8 iterations "
        f"{ {k: v['all_reduces'] for k, v in o['ladder'].items()} }, halo "
        f"sends == 2 x predicted_halo_exchanges")
    for key, row in o["solves"].items():
        log(f"[stencil_cg]   {key:14s} iters {row['psum']['iters']:3d}, "
            f"all-reduces {row['psum']['record']['all_reduces']:3d}: psum "
            f"{row['psum']['ms']:8.1f} ms, ring_hier "
            f"{row['ring_hier']['ms']:8.1f} ms "
            f"({row['ring_hier']['launches']['reduce_add']} reduce_add), "
            f"true {row['true_rel']:.2e}")
    log(f"[stencil_cg] 2 ranks, profiled cg/none on ring_hier (rank 0): wall "
        f"{o['profile']['wall_ms']:.1f} ms, device busy "
        f"{o['profile']['busy_ms']:.1f} ms, idle share "
        f"{o['profile']['idle_share']:.3f}; peak "
        f"{o['peak_bytes'] / 2**30:.2f} / "
        f"{ranks[1]['peak_bytes'] / 2**30:.2f} GiB a rank")
    return {"one_rank": one_rank, "profile_one_rank": prof1, "ranks": ranks,
            "reduce_add_launches": launched, "reduce_add_max_abs_err": err}


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
# the fp32 route at S=4096: its relative L2 against fp64 at most this times
# the plain version's (a kernel that chains the tensor cores' truncating
# sums through every key of a row is biased; PERF.md section 6)
ATTN_FP32_FP64_RATIO = 2.0
# the flash_attn kernel each dtype launches in the grid's layouts
ATTN_ROUTE = {"float32": "mma", "bfloat16": "wgmma"}
# the fp32 grid case (S, (Hq, Hkv), D, (causal, window)) at which plain TF32
# (one term of split operands) must miss ATTN_TOL["float32"]: the control
# that shows the tolerance tells 3xTF32 from one TF32 product
ATTN_CONTROL_CASE = (256, (4, 2), 64, (True, None))
ATTN_UNALIGNED_SEQ = 257     # the cases whose k/v rows are off 16 bytes
PREFILL_CHECK_SEQ = 4096     # kernel prefill vs blockwise prefill
PREFILL_SEQ = 32768          # prefill_32k's length, at batch 1
PREFILL_FP32_TOL = 1e-4      # tests/test_torch_prefill.py's fp32 tolerance
PREFILL_CHECK_SEEDS = tuple(range(10))  # weights and tokens, S=4096 check
# the bf16 kernel prefill's error against the fp32 blockwise prefill, as a
# multiple of the bf16 blockwise prefill's: relative L2 and elementwise
# misses of the engine's tolerance, at most (PERF.md section 6)
PREFILL_BF16_L2_MARGIN, PREFILL_BF16_MISS_MARGIN = 1.05, 1.25
# the H100 SXM's dense bf16 and TF32 tensor-core peaks (NVIDIA's data sheet)
BF16_FLOPS_PER_S = 989e12
TF32_FLOPS_PER_S = 495e12
# the SIMT kernel (fp32 FMAs) this route replaced, at q (1, 32, 4096, 64)
# fp32 causal, as this script timed it on an NVIDIA H100 80GB HBM3 at 700 W
# (PERF.md section 6, row 9b)
SIMT_FP32_4096_MS = 5.222


def attn_inputs(dev, seed, b, hq, hkv, s, d, dtype):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    return q, k, v


def unaligned_attn_inputs(dev, seed, dtype):
    """q/k/v whose k/v rows are not all 16-byte aligned, so that the mma
    kernel moves K/V without 16-byte copies (bf16: plain loads, and layouts
    TMA cannot take; fp32: 4-byte copies): head views of a (1, S, 4*64 + e)
    projection (a sequence stride of 260 bf16 elements, 520 bytes, or 257
    fp32 elements, 1028 bytes) and k/v one element (2 or 4 bytes) past
    alignment."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    s, extra = ATTN_UNALIGNED_SEQ, 4 if dtype == torch.bfloat16 else 1
    x = torch.randn((1, s, 4 * 64 + extra), generator=gen,
                    device=dev).to(dtype)
    heads = x[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    flat = torch.randn(2 * s * 64 + 1, generator=gen, device=dev).to(dtype)
    shifted = flat[1:].view(1, 2, s, 64)
    size = heads.element_size()
    return {f"{heads.stride(2)}-element sequence stride": (
                heads, heads[:, :2], heads[:, :2]),
            f"k/v {size} bytes past alignment": (heads.contiguous(), shifted,
                                                 shifted)}


def phase_kernels_attn(dev) -> dict:
    """The flash-attention kernels against their plain version on card
    inputs: every S x (Hq, Hkv) x D x mask x dtype of the grid above, fp32
    on the mma route and bf16 on the wgmma route, then bf16 and fp32 with
    k/v rows off 16-byte alignment on the mma route (bf16 in layouts TMA
    cannot take), within the reference's tolerances, and run to run
    bitwise; plain TF32 at ``ATTN_CONTROL_CASE`` outside the
    fp32 tolerance; then the refusals."""
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

    n, control_err = 0, None
    for i, (s, (hq, hkv), d, (causal, window), dt) in enumerate(
            itertools.product(ATTN_SEQS, ATTN_HEADS, ATTN_DIMS, ATTN_MASKS,
                              ("float32", "bfloat16"))):
        q, k, v = attn_inputs(dev, i, 2, hq, hkv, s, d, getattr(torch, dt))
        check(q, k, v, causal, window, ATTN_ROUTE[dt],
              f"S={s} Hq={hq} Hkv={hkv} D={d} causal={causal} "
              f"window={window} {dt}")
        if (s, (hq, hkv), d, (causal, window)) == ATTN_CONTROL_CASE \
                and dt == "float32":
            want = ref.attention(q, k, v, causal=causal, window=window)
            ctrl = ref.attention_tf32_split(q, k, v, causal=causal,
                                            window=window, terms=1)
            control_err = (ctrl - want).abs().max().item()
            if torch.allclose(ctrl, want, *ATTN_TOL["float32"]):
                raise AssertionError(
                    f"[kernels_attn] the control (one TF32 term) at "
                    f"{ATTN_CONTROL_CASE} is within the fp32 tolerance "
                    f"(max |diff| {control_err:.3e}): it cannot tell "
                    f"3xTF32 from plain TF32")
            del want, ctrl
        n += 1
        del q, k, v
    if control_err is None:
        raise AssertionError(f"[kernels_attn] the control case "
                             f"{ATTN_CONTROL_CASE} is not in the grid")
    n_unaligned = 0
    for dt in ("bfloat16", "float32"):
        unaligned = unaligned_attn_inputs(dev, n + n_unaligned,
                                          getattr(torch, dt))
        for what, (q, k, v) in unaligned.items():
            what = f"S={ATTN_UNALIGNED_SEQ} {dt}, {what}"
            if ops._rows_aligned16(k) or ops._rows_aligned16(v):
                raise AssertionError(f"[kernels_attn] {what}: k/v rows "
                                     f"16-byte aligned")
            check(q, k, v, True, 64, "mma", what)
            n_unaligned += 1
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
        f"B=2) and {n_unaligned} with k/v rows off 16-byte alignment (S="
        f"{ATTN_UNALIGNED_SEQ}, Hq=4, Hkv=2, D=64, window 64; bf16, layouts "
        f"TMA cannot take: a 260-element sequence stride, k/v 2 bytes past "
        f"alignment; fp32: a 257-element sequence stride, k/v 4 bytes past "
        f"alignment) within "
        f"the reference's tolerances of the plain version and bitwise run "
        f"to run: max |kernel - plain| fp32 {err['float32']:.3e}, bf16 "
        f"{err['bfloat16']:.3e}; launches by route (two per case): mma "
        f"{routes['mma']} (fp32, the unaligned bf16), wgmma "
        f"{routes['wgmma']} (bf16); the control (one TF32 term) at "
        f"{ATTN_CONTROL_CASE} fp32: max |control - plain| "
        f"{control_err:.3e}, outside rtol/atol "
        f"{ATTN_TOL['float32'][0]:.0e}; Sq != Sk and requires_grad raise")
    return {"cases": n + n_unaligned, "max_abs_err": err,
            "control_max_abs_err": control_err, "routes": routes}


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
    check, check_launches = {}, 0
    t_check = time.perf_counter()
    for seed in PREFILL_CHECK_SEEDS:
        params = m32.init(torch.Generator(device=dev).manual_seed(seed), dev)
        batch = {"tokens": tokens(PREFILL_CHECK_SEQ, seed + 1)}
        what = f"S={PREFILL_CHECK_SEQ} seed {seed}"
        want = build_prefill(m32, shape, attn_impl="blockwise",
                             device=dev)(params, batch).float()
        logits32 = kernel_prefill(build_prefill(m32, shape, device=dev),
                                  params, batch, f"{what} fp32", route="mma")
        check_launches += attn_routes()["mma"]   # zeroed just before it
        row = {"fp32": error(logits32, want, PREFILL_FP32_TOL,
                             PREFILL_FP32_TOL),
               "bf16_kernel": error(kernel_prefill(
                   build_prefill(m16, shape, device=dev), params, batch,
                   f"{what} bf16"), want, ENGINE_RTOL, ENGINE_ATOL),
               "bf16_blockwise": error(build_prefill(
                   m16, shape, attn_impl="blockwise", device=dev)(
                       params, batch), want, ENGINE_RTOL, ENGINE_ATOL)}
        check[f"seed{seed}"] = row
        del params, batch, want, logits32
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
        f"mma kernel at fp32, the wgmma kernel at bf16; the "
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
        f"the timed prefill: wgmma {timed_launches['wgmma']}, mma "
        f"{timed_launches['mma']} ({layers} each in the warm, timed and "
        f"profiled ones)")
    log(f"[prefill] profiled prefill: wall {prof_wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}; the profiler "
        f"recorded {seen} of the {launched} flash_attn launches")
    for name, ms in top:
        log(f"[prefill]   {ms:9.2f} ms/prefill  {name[:90]}")
    del params, batch, prefill
    gc.collect()
    torch.cuda.empty_cache()
    return {"check": check, "check_launches_mma": check_launches,
            "launches": timed_launches["wgmma"],
            "launches_by_route": timed_launches, "wall_ms": wall * 1e3,
            "peak_bytes": peak, "tokens_per_s": PREFILL_SEQ / wall,
            "profile": {"wall_ms": prof_wall, "device_ms": busy,
                        "idle_share": 1 - busy / prof_wall,
                        "port_kernels": {"launched": launched,
                                         "recorded": seen},
                        "top_device_ms": {k[:90]: v for k, v in top}}}


DRYRUN_SERVE_PAGE_TOKENS = 16      # the serve suite's cell at R = 1


def phase_dryrun(dev) -> dict:
    """``repro_torch.launch.dryrun`` on the card's host.  First the dry-run
    held against the card where one card runs the same program:
    llama3.2-1b's full-width prefill at the prefill phase's timed shape
    (B=1, S=32768), world 1, run on the card (one warm call first, then
    ``reset_peak_memory_stats()``) and then traced on fake CUDA tensors.
    The trace's peak of live storage less what was alive before it is held
    to what the call asked the allocator for, exactly: the peak of
    ``requested_bytes.all`` less its value before the call.  Second, and
    printed beside it, ``max_memory_allocated()`` less
    ``memory_allocated()`` before the call: the caching allocator rounds
    every block up to 512 bytes and may hand out a large-pool block (above
    1 MiB) with up to 1 MiB unsplit, so those bytes lie in [predicted,
    predicted + 511 B x the most storages alive at once + 1 MiB x the most
    large ones] (``dryrun.allocator_slack``).  Each kernel's fake-route
    calls equal the real call's launches, by route, exactly.  Then two
    full-width
    cells traced as rank 0 of the 16 x 16 mesh over the fake process
    group: llama3.2-1b ``train_4k`` and its paged serve cell at R = 1;
    each record's seconds, peak, fit and three roofline terms printed."""
    import gc

    import torch

    from repro_torch import fake
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import build_prefill
    from repro_torch.runtime.train_step import data_mesh

    # the card's run of the prefill
    shape = ShapeConfig("prefill_32k_b1", PREFILL_SEQ, 1, "prefill")
    model = build_model(get_config(ARCH))
    _check_full_width(model.cfg, 16, "dryrun")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    prefill = build_prefill(model, shape, device=dev)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size,
                                     (1, PREFILL_SEQ), device=dev,
                                     dtype=torch.int32)}
    prefill(params, batch)                     # warm: the kernels, cuBLAS
    torch.cuda.synchronize(dev)
    gc.collect()
    reset_launch_counters()
    torch.cuda.reset_peak_memory_stats(dev)
    alloc0 = torch.cuda.memory_allocated(dev)
    asked0 = torch.cuda.memory_stats(dev)["requested_bytes.all.current"]
    logits = prefill(params, batch)
    torch.cuda.synchronize(dev)
    measured = torch.cuda.max_memory_allocated(dev) - alloc0
    requested = (torch.cuda.memory_stats(dev)["requested_bytes.all.peak"]
                 - asked0)
    launched, routes = launch_counters(), attn_routes()
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[dryrun] the measured prefill's logits are "
                             "not finite")
    del logits, params, batch, prefill
    gc.collect()
    torch.cuda.empty_cache()
    # ... and its dry-run at world 1
    t0 = time.perf_counter()
    with dryrun.fake_mode():
        traced = dryrun.trace_serve(build_model(get_config(ARCH)), shape,
                                    data_mesh(1), "resident",
                                    torch.device("cuda"))
    trace_s = time.perf_counter() - t0
    counts = traced["counts"]
    predicted = (counts["peak_bytes"] - traced["state_bytes"]
                 - traced["batch_bytes"])
    slack = dryrun.allocator_slack(counts["max_storages"],
                                   counts["max_large"])
    fake_calls = {k.replace(".", "_"): v
                  for k, v in counts["kernels"].items()}
    real_calls = {k: v for k, v in launched.items() if v}
    fake_routes = {k.split("/")[1]: v for k, v in counts["routes"].items()
                   if k.startswith("flash_attn/")}
    real_routes = {k: v for k, v in routes.items() if v}
    log(f"[dryrun] {ARCH} prefill B=1 S={PREFILL_SEQ} at world 1: "
        f"predicted peak {counts['peak_bytes']} B, of it {predicted} B "
        f"during the call; requested of the allocator at most {requested} "
        f"B (requested - predicted = {requested - predicted} B, held to "
        f"0); max_memory_allocated - memory_allocated before: {measured} "
        f"B (measured - predicted = {measured - predicted} B; the "
        f"allocator's bound {slack} B: {counts['max_storages']} storages "
        f"alive at most, {counts['max_large']} of them above 1 MiB; "
        f"{gpu_line()}); traced in {trace_s:.1f} s")
    log(f"[dryrun] fake-route calls {fake_calls} by route {fake_routes}; "
        f"the card's launches {real_calls} by route {real_routes}")
    if fake_calls != real_calls or fake_routes != real_routes:
        raise AssertionError(f"[dryrun] fake-route calls {fake_calls} "
                             f"{fake_routes} != launches {real_calls} "
                             f"{real_routes}")
    if requested != predicted:
        raise AssertionError(f"[dryrun] requested {requested} B != "
                             f"predicted {predicted} B")
    if not predicted <= measured <= predicted + slack:
        raise AssertionError(f"[dryrun] measured {measured} B outside "
                             f"[{predicted}, {predicted + slack}] B")
    out = {"prefill_world1": {
        "predicted_peak_bytes": counts["peak_bytes"],
        "predicted_call_bytes": predicted,
        "requested_call_bytes": requested, "measured_call_bytes": measured,
        "allocator_slack_bytes": slack,
        "max_storages": counts["max_storages"],
        "max_large": counts["max_large"], "trace_s": trace_s,
        "fake_calls": fake_calls, "launches": real_calls,
        "routes": real_routes}}

    # two full-width cells at the 16 x 16 mesh
    for what, fn in (
            ("train_4k", lambda: dryrun.run_cell(ARCH, "train_4k", False)),
            ("serve_r1", lambda: dryrun.run_serve_cell(
                ARCH, DRYRUN_SERVE_PAGE_TOKENS, 1, reduced=False))):
        rec = fn()
        r, m = rec["roofline"], rec["memory"]
        log(f"[dryrun] {ARCH} {what} on {rec['mesh']} ({rec['devices']} "
            f"ranks, rank 0 traced on {dryrun.trace_device()}): "
            f"{rec['trace_s']:.1f} s, peak {m['peak_gb']:.3f} GiB, fits "
            f"{m['fits']} ({m['card_gb']:.2f} GiB card); T_compute "
            f"{r['t_compute_s']:.6f} s, T_memory {r['t_memory_s']:.6f} s, "
            f"T_collective {r['t_collective_s']:.6f} s; fake kernel calls "
            f"{rec['kernels']}")
        if not m["fits"] or not rec["kernels"]:
            raise AssertionError(f"[dryrun] {what}: fits {m['fits']}, "
                                 f"kernel calls {rec['kernels']}")
        out[what] = {"trace_s": rec["trace_s"], "memory": m,
                     "roofline": {k: r[k] for k in (
                         "t_compute_s", "t_memory_s", "t_collective_s")},
                     "kernels": rec["kernels"]}
    fake.reset_fake_counts()
    return out


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
    at S=4096, and the fp32 route (the TF32 mma kernel, held first against
    the plain version at the fp32 tolerance), its plain version and SDPA at
    fp32, S=4096, beside the SIMT kernel it replaced and the fp32 route's two
    bounds: the function's work at the CUDA cores' fp32 rate, and three
    times it (3xTF32) at the dense TF32 rate."""
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
                      (short32, "mma")):
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
    got32 = ops.flash_attention(*short32)
    want32 = ref.attention(*short32, block_q=1024)
    torch.testing.assert_close(
        got32, want32, rtol=ATTN_TOL["float32"][0],
        atol=ATTN_TOL["float32"][1],
        msg=lambda m: f"[timing] flash_attn fp32 at S={PREFILL_CHECK_SEQ}: "
                      f"{m}")
    err32 = (got32 - want32).abs().max().item()
    # the tensor cores' fp32 sums truncate: chained through a long row they
    # bias the output by more than the elementwise tolerance shows at these
    # magnitudes, so the kernel's distance from fp64 is held to a multiple
    # of the plain version's (PERF.md section 6)
    want64 = ref.attention(*(t.double() for t in short32), block_q=512)
    rel32 = {"kernel": relative_l2(got32, want64),
             "plain": relative_l2(want32, want64)}
    del got32, want32, want64
    if not rel32["kernel"] <= ATTN_FP32_FP64_RATIO * rel32["plain"]:
        raise AssertionError(
            f"[timing] flash_attn fp32 at S={PREFILL_CHECK_SEQ}: relative L2 "
            f"against fp64 {rel32['kernel']:.4e}, above "
            f"{ATTN_FP32_FP64_RATIO} x the plain version's "
            f"{rel32['plain']:.4e}")
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
             "mma_fp32_4096": call_times(
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
    # the fp32 route at S=4096: the least time of the function's work on the
    # CUDA cores (fp32) and of its three products a product on the TF32
    # tensor cores; the row's bound is the lesser
    flops_4096 = ops.attention_flops(b, hq, PREFILL_CHECK_SEQ, d, causal=True)
    bound32 = {"fp32_cores": flops_4096 / FP32_FLOPS_PER_S * 1e3,
               "3xtf32": 3 * flops_4096 / TF32_FLOPS_PER_S * 1e3}
    t32 = times["mma_fp32_4096"]["graph_ms"]
    out = {"ms": times["kernel"]["graph_ms"],
           "plain_ms": times["plain"]["graph_ms"],
           "bound_ms": max(t_ops, t_bytes),
           "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "library_ms": times["library"]["graph_ms"],
           "max_abs_err": err, "rel_l2": rel,
           "kernel_4096_ms": times["kernel_4096"]["graph_ms"],
           "plain_4096_ms": times["plain_4096"]["graph_ms"],
           "mma_fp32_4096_ms": t32,
           "plain_fp32_4096_ms": times["plain_fp32_4096"]["graph_ms"],
           "library_fp32_4096_ms": times["library_fp32_4096"]["graph_ms"],
           "mma_fp32_4096_bound_ms": min(bound32.values()),
           "mma_fp32_4096_bounds_ms": bound32,
           "mma_fp32_4096_max_abs_err": err32,
           "mma_fp32_4096_rel_l2_fp64": rel32,
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
        f"{out['ms'] / out['library_ms']:.3f}")
    lib32, plain32 = out["library_fp32_4096_ms"], out["plain_fp32_4096_ms"]
    log(f"[timing] flash_attn fp32 q (1, 32, {PREFILL_CHECK_SEQ}, 64), k/v "
        f"(1, 8, {PREFILL_CHECK_SEQ}, 64) causal: max |kernel - plain| "
        f"{err32:.3e} (rtol/atol {ATTN_TOL['float32'][0]:.0e}); relative L2 "
        f"against fp64 {rel32['kernel']:.4e}, the plain version's "
        f"{rel32['plain']:.4e} (limit {ATTN_FP32_FP64_RATIO} x); mma kernel "
        f"(3xTF32) {t32:.4f} ms against the SIMT kernel's "
        f"{SIMT_FP32_4096_MS} ms ({SIMT_FP32_4096_MS / t32:.2f}x); SDPA at "
        f"fp32 {lib32:.4f} ms (kernel / SDPA {t32 / lib32:.3f}); plain "
        f"{plain32:.4f} ms; bounds {bound32['fp32_cores']:.4f} ms "
        f"({flops_4096:.4e} FLOP at 67 TFLOP/s fp32, kernel at "
        f"{bound32['fp32_cores'] / t32:.3f} of it) and "
        f"{bound32['3xtf32']:.4f} ms (3 x the work at 495 TFLOP/s dense "
        f"TF32, kernel at {bound32['3xtf32'] / t32:.3f} of it); time per "
        f"call:")
    for name, t in times.items():
        log(times_line(name, t))
    del q, k, v, short, short32, rep32
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# tensor parallelism: two ranks on the one card over gloo, a (1, 2)
# ("data", "model") mesh, llama3.2-1b at full width
# ---------------------------------------------------------------------------

TP_TRAIN_ARGS = ["--arch", ARCH, "--transport", "ring_hier", "--use-arena",
                 "--seq", "256", "--batch", "8", "--steps", "3", "--device",
                 "cuda", "--seed", "0", "--model-parallel", "2", "--layers",
                 "8"]       # 16 until the MoE phases joined the script
TP_GATE_LAYERS = 4          # the fp32 gate's depth
TP_GATE_ATOL = 5e-5         # the CPU tests' loss bound (test_torch_tp_train)
TP_PREFILL_L2 = 1.25        # prefill_tp: relative L2 error at most this
                            # times the one-rank bf16 kernel prefill's
TP_SEQ_CACHE = 8192         # serve_contiguous_tp's sequence-sharded cache
TP_SEQ_POS = 8000           # its decode position: both ranks' slots valid
TP_SEQ_ATOL = 2e-2          # tests/test_distributed.py::SERVE_SCRIPT
TP_SERVE_LONG_LEN = 64      # serve_tp's long requests (the serve phase's
                            # 192 until train_tp_fsdp joined the script:
                            # 210 decode steps, now 82)


def _tp_mesh():
    from repro_torch.core.topology import RankMesh

    return RankMesh(("data", "model"), (1, 2))


def _leaf_count(tree) -> int:
    from repro_torch import tree as tree_util

    return sum(t.numel() for t in tree_util.leaves(tree))


def _replicated_digest(step, params) -> list[int]:
    """Digests of the leaves replicated over the model axis (equal on every
    model rank after every step)."""
    from repro_torch import tree as tree_util
    from repro_torch.sharding.rules import is_model_sharded, spec_leaves

    leaves = tree_util.leaves(params)
    return params_digest([t for t, sp in zip(leaves, spec_leaves(step.specs))
                          if not is_model_sharded(sp)])


def _tp_train_run(args, world) -> dict:
    """One ``launch.train`` run on the TP mesh: 3 steps, then one more,
    profiled on rank 0; launches, records, peak and state size."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.launch import train as launch_train

    torch.cuda.reset_peak_memory_stats(world.device)
    run = launch_train.setup(args, world)
    _check_full_width(run.model.cfg, args.layers, "train_tp")
    trainer = run.trainer
    step = trainer.step_fn
    if (step.model_size, step.data_world, step.cfg.dp_mode) != (
            2, 1, args.dp_mode):
        raise AssertionError(f"[train_tp] mesh {step.mesh}, dp_mode "
                             f"{step.cfg.dp_mode}")
    state_bytes = sum(t.numel() * t.element_size() for k in ("params", "opt")
                      for t in tree_util.leaves(trainer.state[k]))
    reset_launch_counters()
    step.comm.record.reset()
    step.model_record.reset()
    hist = trainer.run()["history"]
    counts = launch_counters()
    routes = pack_routes()
    model_rec = step.model_record.as_dict()
    comm_rec = step.comm.record.as_dict()
    peak_run = torch.cuda.max_memory_allocated(world.device)
    prof = step_profile(trainer, step.data_index, step.data_world,
                        profiled=world.rank == 0)
    segs = step.arena.layout.n_segments
    steps = args.steps
    # the data axis is 1: no hop; the arena packs and unpacks each of its
    # segments once a step (zero1: the delta spans read out segment by
    # segment), all on the bulk route
    predicted = dict.fromkeys(counts, 0)
    predicted.update(pack_write=segs * steps, pack_read=segs * steps)
    out = {"losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["sec"] for h in hist], "counts": counts,
           "predicted": predicted, "pack_routes": routes,
           "model_record": model_rec, "comm_record": comm_rec,
           "local_params": _leaf_count(trainer.state["params"]),
           "full_params": run.model.param_count(),
           "state_bytes": state_bytes, "peak_run_bytes": peak_run,
           "peak_bytes": torch.cuda.max_memory_allocated(world.device),
           "replicated_digest": _replicated_digest(step,
                                                   trainer.state["params"]),
           "profile": prof, "segments": segs,
           "layers": run.model.cfg.num_layers}
    return out


def _tp_gate(world) -> dict:
    """The TP step at ``TP_GATE_LAYERS`` layers with fp32 compute against
    the one-rank replicated run (rank 0 alone, a (1, 1) mesh): the same
    seed, batches and step config, 3 steps."""
    import gc

    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.configs import get_config
    from repro_torch.core.topology import RankMesh
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    model = build_model(get_config(ARCH).with_(num_layers=TP_GATE_LAYERS,
                                               dtype="float32"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=256, global_batch=8))
    step_cfg = TrainStepConfig(
        dp_mode="replicated", comm=CommConfig(transport="ring_hier",
                                              chunks=2),
        optim=OptimConfig(base_lr=3e-4, warmup=1, total_steps=3))

    def hist(mesh):
        tr = Trainer(model, mesh, step_cfg, data,
                     TrainerConfig(steps=3, seed=0), device=world.device,
                     rank=world.rank, log=lambda msg: None)
        h = tr.run()["history"]
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return [x["loss"] for x in h], [x["grad_norm"] for x in h]

    tp = hist(_tp_mesh())
    one = hist(RankMesh(("data", "model"), (1, 1))) if world.rank == 0 \
        else None
    return {"tp": tp, "one": one}


def _tp_train_worker(argv: list[str]) -> dict:
    """One of the two ranks of train_tp: replicated and zero1 at full
    width, then the fp32 gate."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    world = launch_train.init_distributed("cuda")
    out = {"backend": world.backend}
    for mode in ("replicated", "zero1"):
        args = launch_train.parser().parse_args(argv + ["--dp-mode", mode])
        out[mode] = _tp_train_run(args, world)
        gc.collect()
        torch.cuda.empty_cache()
    out["gate"] = _tp_gate(world)
    return out


def check_train_tp(ranks: list) -> dict:
    """The checks of train_tp (:func:`_tp_train_worker`'s results: two
    ranks on the one card over gloo on a (1, 2) mesh, Megatron-style TP
    training at full width, replicated then zero1, and the fp32 gate)."""
    for r, out in enumerate(ranks):
        if out["backend"] != "gloo":
            raise AssertionError(f"[train_tp] rank {r} backend "
                                 f"{out['backend']}")
        for mode in ("replicated", "zero1"):
            o = out[mode]
            if not all(math.isfinite(x) for x in o["losses"]):
                raise AssertionError(f"[train_tp] {mode} rank {r}: "
                                     f"non-finite loss")
            if o["counts"] != o["predicted"]:
                raise AssertionError(f"[train_tp] {mode} rank {r} launches "
                                     f"{o['counts']} != {o['predicted']}")
            if o["pack_routes"]["vector"]:
                raise AssertionError(f"[train_tp] {mode} rank {r}: pack on "
                                     f"the vector route {o['pack_routes']}")
            if o["comm_record"]["sends"] or o["comm_record"]["all_reduces"]:
                raise AssertionError(f"[train_tp] {mode} rank {r}: the data "
                                     f"axis of 1 moved data "
                                     f"{o['comm_record']}")
    for mode in ("replicated", "zero1"):
        a, b = ranks[0][mode], ranks[1][mode]
        if a["losses"] != b["losses"]:
            raise AssertionError(f"[train_tp] {mode}: the ranks disagree on "
                                 f"the loss")
        if a["replicated_digest"] != b["replicated_digest"]:
            raise AssertionError(f"[train_tp] {mode}: the leaves replicated "
                                 f"over the model axis differ")
        if [{k: v for k, v in o["model_record"].items() if k != "staging_s"}
                for o in (a, b)] != [{k: v for k, v in a["model_record"]
                                      .items() if k != "staging_s"}] * 2:
            raise AssertionError(f"[train_tp] {mode}: the ranks' model-axis "
                                 f"collectives differ: {a['model_record']}, "
                                 f"{b['model_record']}")
    gate = ranks[0]["gate"]
    (tp_l, tp_n), (one_l, one_n) = gate["tp"], gate["one"]
    loss_err = max(abs(x - y) for x, y in zip(tp_l, one_l))
    norm_err = max(abs(x - y) / y for x, y in zip(tp_n, one_n))
    if loss_err > TP_GATE_ATOL or norm_err > 1e-4:
        raise AssertionError(f"[train_tp] fp32 gate at {TP_GATE_LAYERS} "
                             f"layers: losses {tp_l} vs one rank {one_l} "
                             f"({loss_err:.3e}), norms {tp_n} vs {one_n}")
    if ranks[1]["gate"]["tp"] != gate["tp"]:
        raise AssertionError("[train_tp] the ranks' gate runs disagree")
    for mode in ("replicated", "zero1"):
        o = ranks[0][mode]
        rec, prof = o["model_record"], o["profile"]
        n = len(o["losses"])
        log(f"[train_tp] {mode}, 2 ranks on (1, 2), {o['layers']} layers, "
            f"{o['local_params']} of {o['full_params']} parameters a rank, "
            f"fp32 params + AdamW {o['state_bytes'] / 2**30:.2f} GiB a rank: "
            f"losses {', '.join(f'{x:.4f}' for x in o['losses'])}; step "
            f"wall {', '.join(f'{x * 1e3:.0f}' for x in o['step_s'])} ms; "
            f"model-axis all-reduces {rec['all_reduces'] / n:.0f} a step, "
            f"{rec['all_reduce_bytes'] / n / 2**20:.1f} MiB a step, staging "
            f"{rec['staging_s'] / n:.3f} s a step; peak "
            f"{o['peak_run_bytes'] / 2**30:.2f} GiB a rank "
            f"({o['peak_bytes'] / 2**30:.2f} with the profiled step); "
            f"launches {({k: v for k, v in o['counts'].items() if v})} == "
            f"predicted; profiled step (rank 0): wall "
            f"{prof['step_wall_ms']:.1f} ms, busy "
            f"{prof['step_device_ms']:.1f} ms, idle "
            f"{prof['idle_share']:.3f}")
    log(f"[train_tp] gate, {TP_GATE_LAYERS} layers fp32: TP losses "
        f"{', '.join(f'{x:.6f}' for x in tp_l)} vs one rank "
        f"{', '.join(f'{x:.6f}' for x in one_l)}: max |diff| "
        f"{loss_err:.3e} (<= {TP_GATE_ATOL}), gradient norms within "
        f"{norm_err:.3e} relative; replicated leaves bitwise equal on both "
        f"ranks")
    return {"ranks": ranks, "gate_loss_err": loss_err,
            "gate_norm_err": norm_err}


def _prefill_errors(got, ref) -> dict:
    diff = (got.float() - ref).abs()
    return {"rel_l2": (diff.norm() / ref.norm()).item(),
            "max_abs": diff.max().item(),
            "outside": int((diff > ENGINE_ATOL + ENGINE_RTOL * ref.abs())
                           .sum())}


def _tp_prefill(model, full, world) -> dict:
    """prefill_tp on one rank of the (1, 2) mesh: the resident TP prefill
    at B=1, S=4096, bf16; rank 0 also the one-rank bf16 kernel prefill and
    the fp32 blockwise one (the gate's reference)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import (build_prefill, gather_vocab,
                                                resident_params)

    dev, mesh = world.device, _tp_mesh()
    params = resident_params(model, full, mesh)
    shape = ShapeConfig("prefill_tp", PREFILL_CHECK_SEQ, 1, "prefill")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size,
                                     (1, PREFILL_CHECK_SEQ), generator=gen,
                                     device=dev, dtype=torch.int32)}
    pre = build_prefill(model, shape, device=dev, mesh=mesh)
    pre(params, batch)                                   # warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    local = pre(params, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts, routes = launch_counters(), attn_routes()
    peak = torch.cuda.max_memory_allocated(dev)
    finite = bool(torch.isfinite(local).all())
    got = gather_vocab(pre.ctx, local)
    del local
    out = {"wall_ms": wall * 1e3, "counts": counts, "routes": routes,
           "peak_bytes": peak, "finite": finite,
           "layers": model.cfg.num_layers}
    if world.rank == 0:
        one = build_prefill(model, shape, device=dev)
        one(full, batch)                                 # warm
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        want = one(full, batch)
        torch.cuda.synchronize(dev)
        out["one_rank_wall_ms"] = (time.perf_counter() - t0) * 1e3
        model32 = build_model(model.cfg.with_(dtype="float32"))
        ref = build_prefill(model32, shape, attn_impl="blockwise",
                            device=dev)(full, batch).float()
        out["tp_err"] = _prefill_errors(got, ref)
        out["one_err"] = _prefill_errors(want, ref)
        diff = (got.float() - want.float()).abs()
        out["tp_vs_one_max_abs"] = diff.max().item()
        del ref, want, diff
    del got
    torch.cuda.empty_cache()
    return out


def _tp_contiguous(model, full, world) -> dict:
    """serve_contiguous_tp on one rank: the contiguous loop at R = 2 (and
    at R = 1 on rank 0), then one fp32 decode at a sequence-sharded cache
    of ``TP_SEQ_CACHE`` slots, random K/V in every slot, at position
    ``TP_SEQ_POS`` (slots on both ranks valid), against the unsharded
    one-rank decode of the same cache (rank 0)."""
    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import serve
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                gather_vocab,
                                                resident_params)

    dev, mesh = world.device, _tp_mesh()
    args = serve.parser().parse_args(["--arch", ARCH, "--device", "cuda",
                                      "--seed", "0", "--model-parallel",
                                      "2"])
    built = serve.build_decode_step
    fed, diverged = [], []         # the R = 2 loop's input tokens, a step

    def recording(*a, **kw):
        step = built(*a, **kw)

        def run(params, token, state, pos):
            fed.append(token.clone())
            return step(params, token, state, pos)

        run.ctx, run.fsdp = step.ctx, step.fsdp
        return run

    def forced(*a, **kw):
        """The R = 1 step on the R = 2 loop's inputs, counting the rows
        whose greedy token differs from the one R = 2 fed next."""
        step = built(*a, **kw)

        def run(params, token, state, pos):
            logits, state = step(params, fed[pos], state, pos)
            if pos + 1 < len(fed):
                diverged.append((logits.argmax(-1).to(torch.int32)
                                 != fed[pos + 1]).sum())
            return logits, state

        run.ctx, run.fsdp = step.ctx, step.fsdp
        return run

    serve.build_decode_step = recording
    try:
        reset_launch_counters()
        loop = serve.run_contiguous(args, dev)
        counts = launch_counters()
    finally:
        serve.build_decode_step = built
    logits = loop.pop("logits")
    out = {"loop": loop, "counts": counts,
           "loop_finite": bool(torch.isfinite(logits).all()),
           "loop_shape": tuple(logits.shape),
           "want_shape": (args.batch, model.cfg.vocab_size)}
    if world.rank == 0:
        # the R = 1 loop on the same step inputs: its last logits are the
        # unsharded step's on what the R = 2 loop's last step saw
        args1 = serve.parser().parse_args(["--arch", ARCH, "--device",
                                           "cuda", "--seed", "0"])
        serve.build_decode_step = forced
        try:
            one = serve.run_contiguous(args1, dev)
        finally:
            serve.build_decode_step = built
        want = one.pop("logits").float()
        d = (logits.float() - want).abs()
        out.update(loop_one=one, loop_max_abs=d.max().item(),
                   loop_outside=int((d > ENGINE_ATOL + ENGINE_RTOL
                                     * want.abs()).sum()),
                   loop_diverged=int(sum(x.item() for x in diverged)),
                   loop_rows=len(diverged) * args.batch)
    # the sequence-sharded branch, fp32 (the reference's SERVE_SCRIPT runs
    # its reduced config in fp32)
    model32 = build_model(model.cfg.with_(dtype="float32"))
    b, r = 4, mesh.coords(world.rank)[1]
    shape = ShapeConfig("serve_seq", TP_SEQ_CACHE, b, "decode")
    c_local = TP_SEQ_CACHE // 2
    gen = torch.Generator(device=dev).manual_seed(3)
    a = model.cfg.attn
    cache_shape = (b, a.num_kv_heads, TP_SEQ_CACHE, a.head_dim)
    caches = [{"kv": {n: torch.randn(cache_shape, generator=gen, device=dev)
                      for n in ("k", "v")}}
              for _ in range(model.cfg.num_layers)]
    sharded = [{"kv": {n: layer["kv"][n][:, :, r * c_local:
                                         (r + 1) * c_local].clone()
                       for n in ("k", "v")}} for layer in caches]
    token = torch.randint(0, model.cfg.vocab_size, (b,), generator=gen,
                          device=dev, dtype=torch.int32)
    step = build_decode_step(model32, shape, device=dev, mesh=mesh)
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    local, _ = step(resident_params(model32, full, mesh), token, sharded,
                    TP_SEQ_POS)
    torch.cuda.synchronize(dev)
    out["seq_wall_ms"] = (time.perf_counter() - t0) * 1e3
    got = gather_vocab(step.ctx, local)
    out["seq_finite"] = bool(torch.isfinite(got).all())
    del sharded
    if world.rank == 0:
        one = build_decode_step(model32, shape, device=dev)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        want, _ = one(full, token, caches, TP_SEQ_POS)
        torch.cuda.synchronize(dev)
        out["seq_one_wall_ms"] = (time.perf_counter() - t0) * 1e3
        out["seq_max_abs"] = (got - want).abs().max().item()
        out["seq_tokens_equal"] = bool(torch.equal(got.argmax(-1),
                                                   want.argmax(-1)))
    del caches
    torch.cuda.empty_cache()
    return out


def _tp_paged(world) -> dict:
    """serve_tp on one rank: the paged engine at R = 2 over the serve
    phase's trace (continuous policy), every step's logits kept; rank 0
    then serves the same trace at R = 1 (same seed, the scheduler's
    deterministic token stream: the same step inputs) and compares the
    live rows step by step."""
    import torch

    from repro_torch.kernels.flash_decode import ops
    from repro_torch.launch import serve
    from repro_torch.models.attention import padded_heads
    from repro_torch.serve import PagedDecodeEngine, ServeScheduler
    from repro_torch.serve.engine import (gqa_is_uniform,
                                          predicted_collectives_per_token,
                                          predicted_wire_bytes_per_token)
    from repro_torch.serve.kv import plan_kv_arena

    dev = world.device
    kv_heads = set()
    wrapper = ops.flash_decode_stats

    def seen(q, k, v, valid):
        kv_heads.add((q.shape[1], k.shape[1], v.shape[1]))
        return wrapper(q, k, v, valid)

    args = serve.parser().parse_args(_argv_with(
        [a if a != "both" else "continuous" for a in SERVE_ARGS],
        long_len=TP_SERVE_LONG_LEN, model_parallel=2))
    ops.flash_decode_stats = seen
    try:
        run = serve.setup_paged(args, dev)
    finally:
        ops.flash_decode_stats = wrapper
    cfg, plan, eng = run.model.cfg, run.plan, run.engine
    eng.admit(0)                          # warm-up step
    eng.decode(run.params, [1, 0, 0, 0])
    eng.retire(0)
    torch.cuda.synchronize(dev)
    kept, live_rows = [], []
    step = eng.decode

    def keep(params, token):
        live_rows.append(eng.slot_valid.copy())
        logits = step(params, token)
        kept.append(logits)
        return logits

    eng.decode = keep
    reset_launch_counters()
    eng.comm.record.reset()
    res = serve.serve_policies(run, ["continuous"])["continuous"]
    counts = launch_counters()
    rec = eng.comm.record.as_dict()
    eng.decode = step
    a = cfg.attn
    hq = padded_heads(a.num_heads)
    # K/V unexpanded where the model's GQA map is the kernel's (llama3.2-1b:
    # 32 q heads read 8 kv heads)
    hkv = a.num_kv_heads if gqa_is_uniform(
        hq, a.num_kv_heads, max(a.num_heads // a.num_kv_heads, 1)) else hq
    out = {"steps": res["steps"], "tokens_per_s": res["tokens_per_s"],
           "wall_s": res["wall_s"], "counts": counts, "record": rec,
           "kv_heads": sorted(kv_heads), "want_kv_heads": [(hq, hkv, hkv)],
           "layers": cfg.num_layers,
           "predicted_collectives": predicted_collectives_per_token(plan),
           "predicted_bytes": predicted_wire_bytes_per_token(
               plan, cfg, plan.max_seqs),
           "blocks_per_rank": plan.blocks_per_rank,
           "finite": all(bool(torch.isfinite(x).all()) for x in kept)}
    if world.rank == 0:
        plan1 = plan_kv_arena(cfg, page_tokens=args.page_tokens,
                              max_seqs=args.slots,
                              max_seq_len=args.prompt_len + max(
                                  args.long_len, args.short_len))
        eng1 = PagedDecodeEngine(run.model, plan1, device=dev)
        worst, outside, diverged, live_total = 0.0, 0, 0, 0
        step1, i = eng1.decode, 0

        def compare(params, token):
            nonlocal worst, outside, diverged, live_total, i
            want = step1(params, token)
            rows = torch.from_numpy(live_rows[i]).to(dev)
            got, w = kept[i][rows].float(), want[rows].float()
            d = (got - w).abs()
            worst = max(worst, d.max().item())
            outside += int((d > ENGINE_ATOL + ENGINE_RTOL * w.abs()).sum())
            diverged += int((got.argmax(-1) != w.argmax(-1)).sum())
            live_total += int(rows.sum())
            i += 1
            return want

        eng1.decode = compare
        t0 = time.perf_counter()
        res1 = ServeScheduler(eng1, "continuous").run(run.params,
                                                      list(run.trace))
        torch.cuda.synchronize(dev)
        wall1 = time.perf_counter() - t0
        out.update(one_steps=res1["steps"], one_wall_s=wall1,
                   one_tokens_per_s=res1["generated_tokens"] / wall1,
                   max_abs=worst, outside=outside, diverged_rows=diverged,
                   live_rows=live_total)
        del eng1
    del kept, run, eng
    torch.cuda.empty_cache()
    return out


def _tp_serve_worker() -> dict:
    """One of the two ranks of the TP serving phases: prefill_tp,
    serve_contiguous_tp and serve_tp, each timed."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    world = launch_train.init_distributed("cuda")
    model = build_model(get_config(ARCH))
    _check_full_width(model.cfg, 16, "prefill_tp")
    full = model.init(torch.Generator(device=world.device).manual_seed(0),
                      world.device)
    out, seconds = {"backend": world.backend}, {}
    for name, fn in (("prefill_tp", lambda: _tp_prefill(model, full,
                                                        world)),
                     ("serve_contiguous_tp",
                      lambda: _tp_contiguous(model, full, world))):
        t0 = time.perf_counter()
        out[name] = fn()
        seconds[name] = time.perf_counter() - t0
    del full
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["serve_tp"] = _tp_paged(world)
    seconds["serve_tp"] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def check_serve_tp(ranks: list) -> dict:
    """The checks of prefill_tp, serve_contiguous_tp and serve_tp
    (:func:`_tp_serve_worker`'s results: two ranks on the one card over
    gloo on a (1, 2) mesh), with their gates."""
    r0 = ranks[0]
    for r, out in enumerate(ranks):
        p = out["prefill_tp"]
        layers = p["layers"]
        if p["counts"] != dict(dict.fromkeys(p["counts"], 0),
                               flash_attn=layers) or \
                p["routes"] != dict(dict.fromkeys(p["routes"], 0),
                                    wgmma=layers):
            raise AssertionError(f"[prefill_tp] rank {r} launches "
                                 f"{p['counts']}, by route {p['routes']}: "
                                 f"expected {layers} wgmma flash_attn")
        if not p["finite"]:
            raise AssertionError(f"[prefill_tp] rank {r} non-finite logits")
        c = out["serve_contiguous_tp"]
        if any(c["counts"].values()) or not c["loop_finite"] or \
                c["loop_shape"] != c["want_shape"] or not c["seq_finite"]:
            raise AssertionError(f"[serve_contiguous_tp] rank {r}: "
                                 f"launches {c['counts']}, finite "
                                 f"{c['loop_finite']} / {c['seq_finite']}, "
                                 f"logits {c['loop_shape']}")
        s = out["serve_tp"]
        n = s["steps"]
        if s["counts"] != dict(dict.fromkeys(s["counts"], 0),
                               flash_decode=n * layers):
            raise AssertionError(f"[serve_tp] rank {r} launches "
                                 f"{s['counts']} for {n} steps: expected "
                                 f"{n * layers} flash_decode and nothing "
                                 f"else")
        if s["kv_heads"] != s["want_kv_heads"]:
            raise AssertionError(f"[serve_tp] rank {r}: K/V heads "
                                 f"{s['kv_heads']}")
        rec = s["record"]
        if rec["all_reduces"] != n * s["predicted_collectives"] or \
                rec["all_reduce_bytes"] != n * s["predicted_bytes"]:
            raise AssertionError(f"[serve_tp] rank {r}: {rec} for {n} steps, "
                                 f"predicted {s['predicted_collectives']} "
                                 f"collectives and {s['predicted_bytes']} B "
                                 f"a token")
        if not s["finite"]:
            raise AssertionError(f"[serve_tp] rank {r}: non-finite logits")
    p = r0["prefill_tp"]
    if p["tp_err"]["rel_l2"] > TP_PREFILL_L2 * p["one_err"]["rel_l2"]:
        raise AssertionError(f"[prefill_tp] relative L2 error "
                             f"{p['tp_err']} against the one-rank bf16 "
                             f"prefill's {p['one_err']}")
    c = r0["serve_contiguous_tp"]
    if c["loop_outside"]:
        raise AssertionError(f"[serve_contiguous_tp] {c['loop_outside']} "
                             f"last logits of the R = 2 loop outside rtol "
                             f"{ENGINE_RTOL} / atol {ENGINE_ATOL} of the "
                             f"R = 1 step on the same inputs (max |diff| "
                             f"{c['loop_max_abs']:.3e})")
    if c["seq_max_abs"] > TP_SEQ_ATOL:
        raise AssertionError(f"[serve_contiguous_tp] sequence-sharded decode "
                             f"{c['seq_max_abs']:.3e} from the unsharded "
                             f"one")
    s = r0["serve_tp"]
    if s["outside"] or s["one_steps"] != s["steps"]:
        raise AssertionError(f"[serve_tp] {s['outside']} live logits outside "
                             f"rtol {ENGINE_RTOL} / atol {ENGINE_ATOL} of "
                             f"the R = 1 engine ({s['one_steps']} vs "
                             f"{s['steps']} steps)")
    walls = [o["prefill_tp"]["wall_ms"] for o in ranks]
    log(f"[prefill_tp] B=1 S={PREFILL_CHECK_SEQ}, weights sharded over 2 "
        f"ranks, bf16: flash_attn {p['counts']['flash_attn']} launches a "
        f"rank, all wgmma; wall {max(walls):.1f} ms (ranks "
        f"{', '.join(f'{w:.1f}' for w in walls)}) vs one rank "
        f"{p['one_rank_wall_ms']:.1f} ms; against the fp32 blockwise "
        f"one-rank prefill: relative L2 {p['tp_err']['rel_l2']:.4e} (one "
        f"rank bf16 {p['one_err']['rel_l2']:.4e}, gate "
        f"{TP_PREFILL_L2}x), {p['tp_err']['outside']} logits outside rtol "
        f"{ENGINE_RTOL} / atol {ENGINE_ATOL} (one rank "
        f"{p['one_err']['outside']}); max |TP - one rank| "
        f"{p['tp_vs_one_max_abs']:.3e}; peak {p['peak_bytes'] / 2**30:.2f} "
        f"GiB a rank")
    loop, one = c["loop"], c["loop_one"]
    log(f"[serve_contiguous_tp] batch 4, cache 512, 16 tokens: R=2 "
        f"{loop['tokens_per_s']:.1f} tok/s ({loop['wall_s'] * 1e3:.0f} ms) "
        f"vs R=1 {one['tokens_per_s']:.1f} tok/s ({one['wall_s'] * 1e3:.0f} "
        f"ms); last logits vs R=1 on the same step inputs: max |diff| "
        f"{c['loop_max_abs']:.3e}, {c['loop_outside']} outside rtol "
        f"{ENGINE_RTOL} / atol {ENGINE_ATOL}; greedy tokens differ in "
        f"{c['loop_diverged']} of {c['loop_rows']} (step, row); fp32 "
        f"decode at {TP_SEQ_CACHE} slots (4096 a rank), position "
        f"{TP_SEQ_POS}: max |diff| {c['seq_max_abs']:.3e} from the unsharded "
        f"one-rank decode (<= {TP_SEQ_ATOL}), tokens equal "
        f"{c['seq_tokens_equal']}; wall {c['seq_wall_ms']:.1f} ms vs "
        f"{c['seq_one_wall_ms']:.1f} ms")
    log(f"[serve_tp] paged engine at R=2, {s['steps']} steps (continuous): "
        f"{s['tokens_per_s']:.1f} tok/s ({s['wall_s']:.2f} s) vs R=1 "
        f"{s['one_tokens_per_s']:.1f} tok/s ({s['one_wall_s']:.2f} s); "
        f"flash_decode {s['counts']['flash_decode']} launches a rank == "
        f"{s['steps']} x {s['layers']} ({s['blocks_per_rank']} blocks a "
        f"rank), nothing else, K/V heads "
        f"{s['kv_heads']}; all-reduces "
        f"{s['record']['all_reduces'] / s['steps']:.0f} a token == "
        f"predicted {s['predicted_collectives']}, "
        f"{s['record']['all_reduce_bytes'] / s['steps']:.0f} B a token == "
        f"predicted {s['predicted_bytes']:.0f}; vs R=1 on the same step "
        f"inputs: max |logit diff| {s['max_abs']:.3e} over "
        f"{s['live_rows']} live rows, {s['outside']} outside rtol "
        f"{ENGINE_RTOL} / atol {ENGINE_ATOL}, greedy tokens differ in "
        f"{s['diverged_rows']} rows")
    return {"ranks": ranks, "seconds": r0["seconds"]}


# four ranks on a (2, 2) ("data", "model") mesh: fsdp, its fp32 gate, the
# checkpoint and the gathered prefill, in one spawn
TP_FSDP_ARGS = ["--arch", ARCH, "--dp-mode", "fsdp", "--transport",
                "ring_hier", "--use-arena", "--seq", "256", "--batch", "8",
                "--steps", "3", "--device", "cuda", "--seed", "0",
                "--model-parallel", "2", "--layers", "4"]
TP_FSDP_PREFILL_BATCH = 2    # the gathered prefill's B (one row a data rank)


def tp_fsdp_model_all_reduces(layers: int, microbatches: int, steps: int
                              ) -> int:
    """The model axis's all-reduces of ``steps`` steps of the TP model
    under ``remat="layer"``, from the code: per microbatch the forward's
    embedding psum, two row-parallel psums a layer (``wo``, ``w_down``) and
    the cross entropy's three (max, exp-sum, gold); the backward's two
    fan-outs a layer (``ln1``, ``ln2``), the kv weights' two sums a layer
    and the final norm's fan-out; the recomputed forward's ``wo`` psum a
    layer (the recomputation stops once the last saved activation, the
    ``w_down`` product's input, is made again, before the ``w_down``
    psum); and a step's gradient norm (the same count whether the
    parameters are resident or gathered fsdp shards: the gathers run on
    the data axes)."""
    per_mb = (1 + 2 * layers + 3) + (4 * layers + 1) + layers
    return steps * (microbatches * per_mb + 1)


def _tp_fsdp_train(world) -> dict:
    """fsdp on the (2, 2) mesh, full width at 4 layers, native bf16
    gathers, the arena on, 3 steps, deterministic; a profiled step; then
    one step over the ring gather and its kernel step against its plain
    step (each its own backward pass)."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train
    from repro_torch.runtime.train_step import shard_batch

    _deterministic(torch)
    args = launch_train.parser().parse_args(TP_FSDP_ARGS)
    run = launch_train.setup(args, world)
    _check_full_width(run.model.cfg, args.layers, "train_tp_fsdp")
    trainer = run.trainer
    step = trainer.step_fn
    if (step.model_size, step.data_world, step.cfg.dp_mode) != (2, 2,
                                                                "fsdp"):
        raise AssertionError(f"[train_tp_fsdp] mesh {step.mesh}, dp_mode "
                             f"{step.cfg.dp_mode}")
    plan = step.fsdp
    predicted, wire = fsdp_expected(step, args.steps, step.data_world)
    reset_launch_counters()
    step.comm.record.reset()
    step.model_record.reset()
    hist = trainer.run()["history"]
    counts, routes = launch_counters(), pack_routes()
    record, model_rec = (step.comm.record.as_dict(),
                         step.model_record.as_dict())
    peak_run = torch.cuda.max_memory_allocated(world.device)
    model_pred = tp_fsdp_model_all_reduces(
        args.layers, step.schedule.microbatches, args.steps)
    prof = step_profile(trainer, step.data_index, step.data_world,
                        profiled=world.rank == 0)
    out = {"losses": [h["loss"] for h in hist],
           "grad_norms": [h["grad_norm"] for h in hist],
           "step_s": [h["sec"] for h in hist], "counts": counts,
           "predicted": predicted, "pack_routes": routes, "record": record,
           "wire": wire, "model_record": model_rec,
           "model_predicted": model_pred,
           "n_buckets": sum(b.n_buckets for b in plan.plans.values()),
           "shard_bytes": 4 * sum(n for sizes in plan.shard_sizes.values()
                                  for n in sizes),
           "local_params": sum(f.size for b in plan.plans.values()
                               for f in b.fields),
           "params": run.model.param_count(),
           "peak_run_bytes": peak_run,
           "peak_bytes": torch.cuda.max_memory_allocated(world.device),
           "profile": prof}
    trainer.state = None
    del run, trainer, step, plan
    gc.collect()
    torch.cuda.empty_cache()
    args = launch_train.parser().parse_args(_argv_with(TP_FSDP_ARGS,
                                                       steps=1))
    run = launch_train.setup(args, world,
                             step_overrides={"fsdp_gather": "ring"})
    trainer, step = run.trainer, run.trainer.step_fn
    rpred, rwire = fsdp_expected(step, 1, step.data_world)
    reset_launch_counters()
    step.comm.record.reset()
    h = trainer.run()["history"][0]
    out["ring"] = {"loss": h["loss"], "step_s": h["sec"],
                   "counts": launch_counters(), "predicted": rpred,
                   "wire": rwire, "record": step.comm.record.as_dict()}
    state = trainer.state
    batch = shard_batch(trainer.data.batch_at(state["step"]),
                        step.data_index, step.data_world)
    same = kernel_vs_plain_step(step, state, batch, world.device,
                                shared=False)
    out["ring"].update(bitwise=same["bitwise"], differ=same["differ"])
    return out


def _tp_fsdp_gate(world) -> dict:
    """fsdp on the (2, 2) mesh at TP_GATE_LAYERS layers, fp32 compute and
    fp32 gathers, against the one-rank replicated run (rank 0 alone, a
    (1, 1) mesh): the same seed, batches and optimizer, 3 steps."""
    import gc

    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.configs import get_config
    from repro_torch.core.topology import RankMesh
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    model = build_model(get_config(ARCH).with_(num_layers=TP_GATE_LAYERS,
                                               dtype="float32"))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=256, global_batch=8))
    comm = CommConfig(transport="ring_hier", chunks=2)
    optim = OptimConfig(base_lr=3e-4, warmup=1, total_steps=3)

    def hist(mesh, cfg):
        tr = Trainer(model, mesh, cfg, data, TrainerConfig(steps=3, seed=0),
                     device=world.device, rank=world.rank,
                     log=lambda msg: None)
        h = tr.run()["history"]
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return [x["loss"] for x in h], [x["grad_norm"] for x in h]

    fsdp = hist(RankMesh(("data", "model"), (2, 2)), TrainStepConfig(
        dp_mode="fsdp", comm=comm, optim=optim, gather_dtype="float32"))
    one = hist(RankMesh(("data", "model"), (1, 1)), TrainStepConfig(
        dp_mode="replicated", comm=comm, optim=optim)) \
        if world.rank == 0 else None
    return {"fsdp": fsdp, "one": one}


def _tp_gathered_prefill(world) -> dict:
    """``build_prefill(weight_mode="gathered")`` on the (2, 2) mesh, full
    width, 16 layers, B=2, S=4096, bf16 (this rank's data shards of its
    model block, gathered at the call) against the resident prefill of the
    same weights on the same mesh: this rank's rows and vocab shard."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.core.topology import RankMesh
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import build_prefill, serve_params

    dev = world.device
    mesh = RankMesh(("data", "model"), (2, 2))
    model = build_model(get_config(ARCH))
    _check_full_width(model.cfg, 16, "train_tp_fsdp")
    layers = model.cfg.num_layers
    b, seq = TP_FSDP_PREFILL_BATCH, PREFILL_CHECK_SEQ
    shape = ShapeConfig("prefill_gathered_tp", seq, b, "prefill")
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": torch.randint(0, model.cfg.vocab_size, (b, seq),
                                     generator=gen, device=dev,
                                     dtype=torch.int32)}
    resident = build_prefill(model, shape, device=dev, mesh=mesh)
    gathered = build_prefill(model, shape, weight_mode="gathered",
                             device=dev, mesh=mesh)
    full = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    params = serve_params(resident, model, full, mesh)
    groups = serve_params(gathered, model, full, mesh)
    del full
    gc.collect()
    torch.cuda.empty_cache()
    want = resident(params, batch)
    gathered(groups, batch)                               # warm
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    got = gathered(groups, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    counts, routes = launch_counters(), attn_routes()
    peak = torch.cuda.max_memory_allocated(dev)
    t0 = time.perf_counter()
    resident(params, batch)
    torch.cuda.synchronize(dev)
    wall_resident = time.perf_counter() - t0
    diff = (got.float() - want.float()).abs()
    out = {"layers": layers, "shape": tuple(got.shape), "counts": counts,
           "routes": routes, "finite": bool(torch.isfinite(got).all()),
           "max_abs_diff": diff.max().item(),
           "rel_l2": (diff.norm() / want.float().norm()).item(),
           "outside": int((diff > ENGINE_ATOL + ENGINE_RTOL
                           * want.float().abs()).sum()),
           "wall_ms": wall * 1e3, "resident_wall_ms": wall_resident * 1e3,
           "peak_bytes": peak,
           "shard_bytes": sum(t.numel() * t.element_size()
                              for v in groups["groups"].values()
                              for t in v)}
    del params, groups, want, got, diff, resident, gathered
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _tp_fsdp_ckpt(world, root: str, layers: int) -> dict:
    """The checkpoint on the (2, 2) mesh: :func:`_ckpt_runs` of zero1 (the
    arch's default) with the fp32 arena at ``layers`` layers."""
    argv = _argv_with(ZERO1_ARGS, layers=layers, steps=CKPT_STEPS,
                      model_parallel=2)
    return _ckpt_runs(argv, root, world, "train_tp_fsdp")


def _tp_fsdp_worker(root: str, ckpt_layers: int) -> dict:
    """One of the four ranks of train_tp_fsdp: the fsdp run, the fp32 gate,
    the checkpoint and the gathered prefill, each part's seconds beside
    its result (the card's cache emptied between the parts)."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    world = launch_train.init_distributed("cuda")
    out = {"backend": world.backend, "seconds": {}}
    for name, fn, args in (
            ("fsdp", _tp_fsdp_train, ()), ("gate", _tp_fsdp_gate, ()),
            ("ckpt", _tp_fsdp_ckpt, (root, ckpt_layers)),
            ("prefill", _tp_gathered_prefill, ())):
        torch.cuda.reset_peak_memory_stats(world.device)
        t0 = time.perf_counter()
        out[name] = fn(world, *args)
        out["seconds"][name] = time.perf_counter() - t0
        torch.use_deterministic_algorithms(False)
        torch.utils.deterministic.fill_uninitialized_memory = True
        gc.collect()
        torch.cuda.empty_cache()
    return out


def phase_train_tp_fsdp() -> dict:
    """Four ranks on the one card over gloo on a (2, 2) ``("data",
    "model")`` mesh: fsdp at full width, its fp32 gate, the checkpoint of
    model-sharded state and the gathered prefill (one spawn)."""
    what = "train_tp_fsdp"
    root, layers, disk = _ckpt_place("ckpt_tp_smoke", 4, what)
    ranks, seconds = spawn_in_turn(what, 4, [(_tp_fsdp_worker,
                                              (str(root), layers))])
    ranks = ranks[0]
    for r, o in enumerate(ranks):
        if o["backend"] != "gloo":
            raise AssertionError(f"[{what}] rank {r} backend {o['backend']}")
        f = o["fsdp"]
        if not all(math.isfinite(x) for x in f["losses"]):
            raise AssertionError(f"[{what}] rank {r}: non-finite loss")
        _check_launches(f"{what} rank {r}", f["counts"], f["predicted"],
                        f["pack_routes"])
        _check_wire(f"{what} rank {r}", f["record"], f["wire"])
        if f["model_record"]["all_reduces"] != f["model_predicted"]:
            raise AssertionError(
                f"[{what}] rank {r}: {f['model_record']['all_reduces']} "
                f"model-axis all-reduces, the code gives "
                f"{f['model_predicted']}")
        g = f["ring"]
        _check_counts(f"{what} ring gather rank {r}", g["counts"],
                      g["predicted"])
        _check_wire(f"{what} ring gather rank {r}", g["record"], g["wire"])
        if not g["counts"]["reduce_add"]:
            raise AssertionError(f"[{what}] rank {r}: no reduce_add launch "
                                 f"over the ring gather")
        if not g["bitwise"]:
            raise AssertionError(f"[{what}] rank {r}: ring gather kernel "
                                 f"step and plain step differ: "
                                 f"{g['differ']}")
        p = o["prefill"]
        layers16 = p["layers"]
        if p["counts"] != dict(dict.fromkeys(p["counts"], 0),
                               flash_attn=layers16) or \
                p["routes"] != dict(dict.fromkeys(p["routes"], 0),
                                    wgmma=layers16):
            raise AssertionError(f"[{what}] rank {r}: gathered prefill "
                                 f"launches {p['counts']}, by route "
                                 f"{p['routes']}: expected {layers16} wgmma "
                                 f"flash_attn and no other")
        if not p["finite"] or p["outside"]:
            raise AssertionError(f"[{what}] rank {r}: gathered prefill "
                                 f"finite {p['finite']}, {p['outside']} "
                                 f"logits outside rtol {ENGINE_RTOL} / atol "
                                 f"{ENGINE_ATOL} of the resident prefill's")

    def no_staging(rec):
        return {k: v for k, v in rec.items() if k != "staging_s"}

    f0 = ranks[0]["fsdp"]
    for o in ranks[1:]:
        if o["fsdp"]["losses"] != f0["losses"]:
            raise AssertionError(f"[{what}] the ranks disagree on the loss")
        if no_staging(o["fsdp"]["model_record"]) != \
                no_staging(f0["model_record"]):
            raise AssertionError(f"[{what}] the ranks' model-axis "
                                 f"collectives differ")
    gate = ranks[0]["gate"]
    (fl, fn), (ol, on) = gate["fsdp"], gate["one"]
    loss_err = max(abs(x - y) for x, y in zip(fl, ol))
    norm_err = max(abs(x - y) / y for x, y in zip(fn, on))
    if loss_err > TP_GATE_ATOL or norm_err > 1e-4:
        raise AssertionError(f"[{what}] fp32 gate at {TP_GATE_LAYERS} "
                             f"layers: losses {fl} vs one rank {ol} "
                             f"({loss_err:.3e}), norms {fn} vs {on}")
    if any(o["gate"]["fsdp"] != gate["fsdp"] for o in ranks[1:]):
        raise AssertionError(f"[{what}] the ranks' gate runs disagree")
    ckpt = check_ckpt_ranks([o["ckpt"] for o in ranks], what, root, layers,
                            disk, int8=False)
    n = len(f0["losses"])
    rec, mrec, prof = f0["record"], f0["model_record"], f0["profile"]
    log(f"[{what}] fsdp on (2, 2), 4 layers, native bf16 gathers, arena "
        f"on, deterministic: {f0['local_params']} parameters a model block "
        f"({f0['params']} in all), {f0['n_buckets']} group buckets, "
        f"{f0['shard_bytes']} B of fp32 shards a rank: losses "
        f"{', '.join(f'{x:.4f}' for x in f0['losses'])} on all four ranks; "
        f"step wall {', '.join(f'{x * 1e3:.0f}' for x in f0['step_s'])} ms; "
        f"peak {f0['peak_run_bytes'] / 2**30:.2f} GiB a rank "
        f"({f0['peak_bytes'] / 2**30:.2f} with the profiled step)")
    log(f"[{what}] a step: model-axis all-reduces {mrec['all_reduces'] / n:.0f}"
        f" ({mrec['all_reduce_bytes'] / n / 2**20:.1f} MiB, staging "
        f"{mrec['staging_s'] / n:.3f} s; == the code's "
        f"{f0['model_predicted'] / n:.0f}, the same on every rank); data "
        f"axis: gathers {rec['all_gathers'] / n:.0f} "
        f"({rec['all_gather_bytes'] / n / 2**20:.1f} MiB), reduce-scatters "
        f"{rec['reduce_scatters'] / n:.0f} "
        f"({rec['reduce_scatter_bytes'] / n / 2**20:.1f} MiB), all-reduces "
        f"{rec['all_reduces'] / n:.0f}, staging {rec['staging_s'] / n:.3f} "
        f"s; launches {({k: v for k, v in f0['counts'].items() if v})} == "
        f"expected, pack by route {f0['pack_routes']}")
    log(f"[{what}] profiled fsdp step (rank 0): wall "
        f"{prof['step_wall_ms']:.1f} ms, device busy "
        f"{prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    g = f0["ring"]
    log(f"[{what}] ring gather, 1 step: loss {g['loss']:.4f}, wall "
        f"{g['step_s'] * 1e3:.0f} ms; launches "
        f"{({k: v for k, v in g['counts'].items() if v})} == expected (the "
        f"reduce-scatter's hops, fp32 + bf16); sends {g['record']['sends']}"
        f" == expected; kernel step == plain step bitwise on all four "
        f"ranks")
    log(f"[{what}] gate, {TP_GATE_LAYERS} layers fp32, fp32 gathers: fsdp "
        f"on (2, 2) {', '.join(f'{x:.6f}' for x in fl)} vs one replicated "
        f"rank {', '.join(f'{x:.6f}' for x in ol)}: max |diff| "
        f"{loss_err:.3e} (<= {TP_GATE_ATOL}), gradient norms within "
        f"{norm_err:.3e} relative")
    p0 = ranks[0]["prefill"]
    log(f"[{what}] gathered prefill on (2, 2), 16 layers, B="
        f"{TP_FSDP_PREFILL_BATCH} S={PREFILL_CHECK_SEQ}, bf16: local logits "
        f"{p0['shape']} a rank, flash_attn {p0['counts']['flash_attn']} "
        f"launches a rank (wgmma {p0['routes']['wgmma']}), no other kernel; "
        f"vs the resident prefill on (2, 2): max |diff| "
        f"{max(o['prefill']['max_abs_diff'] for o in ranks):.4e}, relative "
        f"L2 {max(o['prefill']['rel_l2'] for o in ranks):.4e}, 0 outside "
        f"rtol {ENGINE_RTOL} / atol {ENGINE_ATOL}; wall "
        f"{p0['wall_ms']:.1f} ms (resident {p0['resident_wall_ms']:.1f} ms)"
        f", peak {p0['peak_bytes'] / 2**30:.2f} GiB, shards "
        f"{p0['shard_bytes']} B a rank")
    parts = ranks[0]["seconds"]
    log(f"[{what}] seconds (rank 0): " + ", ".join(
        f"{k} {v:.1f}" for k, v in parts.items()))
    return {"ranks": ranks, "gate_loss_err": loss_err,
            "gate_norm_err": norm_err, "ckpt": ckpt, "seconds": parts,
            "spawn_s": seconds[0]}


# ---------------------------------------------------------------------------
# MoE and expert parallelism (mixtral-8x7b at full width, depth cut)
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x7b"
MOE_SERVE_LAYERS = 2        # moe_serve's depth: 3.165e9 fp32 parameters
MOE_PREFILL_SEQ = 8192      # past the 4096 window, which then masks
MOE_TRAIN_ARGS = ["--arch", MOE_ARCH, "--layers", "1", "--use-arena",
                  "--seq", "256", "--batch", "8", "--steps", "3",
                  "--device", "cuda", "--seed", "0", "--model-parallel", "1"]
# moe_ep: two ranks on (1, 2), the experts sharded over the model axis
MOE_EP_ARGS = MOE_TRAIN_ARGS[:-1] + ["2"]
MOE_GATE_ATOL = 5e-5        # tests/test_torch_moe_train.py's loss bound


def _check_moe_width(cfg, layers: int, what: str) -> None:
    a, m = cfg.attn, cfg.moe
    got = (cfg.num_layers, cfg.d_model, a.num_heads, a.num_kv_heads,
           a.head_dim, a.window, m.num_experts, m.top_k, m.expert_ff,
           m.capacity_factor, cfg.vocab_size, cfg.tie_embeddings)
    if got != (layers, 4096, 32, 8, 128, 4096, 8, 2, 14336, 1.25, 32000,
               False):
        raise AssertionError(f"[{what}] not mixtral-8x7b at full width: "
                             f"{got}")


def _moe_ep_overrides() -> dict:
    """mixtral's experts sharded over the model axis (it publishes
    ``parallelism="tp"``, which never reaches the all-to-all)."""
    import dataclasses

    from repro_torch.configs import get_config

    return {"moe": dataclasses.replace(get_config(MOE_ARCH).moe,
                                       parallelism="ep")}


class _RouteSpy:
    """Wraps the transformer's ``moe_apply``: records each call's routing
    (the router's top-k, recomputed from the same inputs by the same
    operations) and passes the call through.  ``routes`` holds one
    ``(ids, keep)`` a call: the top-k experts of each token sorted, and
    whether each of those pairs fits its expert's capacity (its place among
    the row's pairs for that expert, in pair order, below the capacity: the
    stable sort of the dispatch)."""

    def __init__(self):
        from repro_torch.models import transformer

        self.mod, self.real = transformer, transformer.moe_apply
        self.routes: list = []

    def __enter__(self):
        def spy(p, x, cfg, act, *, ctx, compute_dtype):
            import torch
            import torch.nn.functional as F

            from repro_torch.models.moe import capacity

            b, s, _ = x.shape
            logits = (x.to(compute_dtype)
                      @ p["router"]["w"].to(compute_dtype)).float()
            ids = torch.topk(logits, cfg.top_k, dim=-1).indices
            flat = ids.reshape(b, -1)
            place = (F.one_hot(flat, cfg.num_experts).cumsum(1) - 1).gather(
                2, flat[..., None])[..., 0]
            keep = (place < capacity(s, cfg)).reshape(ids.shape)
            ids, order = torch.sort(ids, dim=-1)
            self.routes.append((ids, torch.gather(keep, -1, order)))
            return self.real(p, x, cfg, act, ctx=ctx,
                             compute_dtype=compute_dtype)

        self.mod.moe_apply = spy
        return self

    def __exit__(self, *exc):
        self.mod.moe_apply = self.real


class _StepMetrics:
    """A train step that keeps every call's metrics (the Trainer's history
    holds no ``moe_drop_fraction``) and, with ``records``, calls it before
    each step (which resets the records) and after it, keeping what it
    returns then in :attr:`records`; attributes pass through."""

    def __init__(self, step, records=None):
        self._step, self._records = step, records
        self.metrics: list[dict] = []
        self.records: list = []

    def __call__(self, state, batch):
        if self._records is not None:
            self._records()
        state, m = self._step(state, batch)
        self.metrics.append({k: float(v) for k, v in m.items()})
        if self._records is not None:
            self.records.append(self._records())
        return state, m

    def __getattr__(self, name):
        return getattr(self._step, name)


def phase_moe_serve(dev) -> dict:
    """mixtral-8x7b at full width, 2 layers, one rank: the prefill at B=1,
    S=8192 (``build_prefill``, ``flash_attn`` on the wgmma route on both
    windowed layers) against the same prefill on the plain (blockwise)
    attention, with the prefill's ``moe_drop_fraction``; then the
    contiguous decode loop at the serve CLI's defaults (batch 4, 512 slots,
    16 tokens) and one profiled decode step."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.models.moe import capacity, dropped_fraction
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill,
                                                init_decode_state)

    model = build_model(get_config(MOE_ARCH).with_(
        num_layers=MOE_SERVE_LAYERS))
    cfg = model.cfg
    _check_moe_width(cfg, MOE_SERVE_LAYERS, "moe_serve")
    layers, e = cfg.num_layers, cfg.moe.num_experts
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.reset_peak_memory_stats(dev)
    n_params = model.param_count()
    shape = ShapeConfig("moe_prefill", MOE_PREFILL_SEQ, 1, "prefill")
    tokens = torch.randint(0, cfg.vocab_size, (1, MOE_PREFILL_SEQ),
                           generator=torch.Generator(device=dev)
                           .manual_seed(1), device=dev, dtype=torch.int32)
    batch = {"tokens": tokens}
    prefill = build_prefill(model, shape, device=dev)
    plain = build_prefill(model, shape, attn_impl="blockwise", device=dev)

    def kernel_prefill(what):
        reset_launch_counters()
        with _RouteSpy() as spy:
            logits = prefill(params, batch)
        torch.cuda.synchronize(dev)
        counts, routes = launch_counters(), attn_routes()
        if counts != dict(dict.fromkeys(counts, 0), flash_attn=layers) or \
                routes != dict(dict.fromkeys(routes, 0), wgmma=layers):
            raise AssertionError(f"[moe_serve] {what} prefill: launches "
                                 f"{counts}, by route {routes}, expected "
                                 f"{layers} wgmma flash_attn and no other")
        return logits, spy.routes, routes

    kernel_prefill("warm-up")
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    got, routes_k, timed_routes = kernel_prefill("timed")
    wall = time.perf_counter() - t0
    with _RouteSpy() as spy:
        want = plain(params, batch)
    torch.cuda.synchronize(dev)
    if tuple(got.shape) != (1, MOE_PREFILL_SEQ, cfg.vocab_size):
        raise AssertionError(f"[moe_serve] logits {tuple(got.shape)}")
    if not (bool(torch.isfinite(got).all())
            and bool(torch.isfinite(want).all())):
        raise AssertionError("[moe_serve] non-finite prefill logits")
    diff = (got.float() - want.float()).abs()
    outside = diff > ENGINE_ATOL + ENGINE_RTOL * want.float().abs()
    # a token is routed alike when every layer sends it to the same
    # experts and keeps or drops each of its pairs alike
    same_set = torch.ones(MOE_PREFILL_SEQ, dtype=torch.bool, device=dev)
    same_route = same_set.clone()
    for (ids_k, keep_k), (ids_p, keep_p) in zip(routes_k, spy.routes):
        sets = (ids_k == ids_p).all(dim=-1)[0]
        same_set &= sets
        same_route &= sets & (keep_k == keep_p).all(dim=-1)[0]
    check = {"max_abs_diff": diff.max().item(),
             "rel_l2": (diff.norm() / want.float().norm()).item(),
             "outside": int(outside.sum()),
             "tokens_outside": int(outside[0].any(dim=-1).sum()),
             "tokens_rerouted": int((~same_set).sum()),
             "tokens_redropped": int((same_set & ~same_route).sum()),
             "max_abs_diff_same_route": diff[0][same_route].max().item(),
             "outside_same_route": int(outside[0][same_route].sum())}
    cap = capacity(MOE_PREFILL_SEQ, cfg.moe)
    drop = sum(float(dropped_fraction(ids, e, cap)) for ids, _ in routes_k
               ) / layers
    del got, want, diff, outside, spy, routes_k
    gc.collect()
    log(f"[moe_serve] mixtral-8x7b at full width, {layers} layers, "
        f"{n_params / 1e9:.3f}e9 fp32 parameters; prefill B=1 "
        f"S={MOE_PREFILL_SEQ} (window {cfg.attn.window}, capacity {cap} "
        f"slots an expert): wall {wall * 1e3:.1f} ms "
        f"({MOE_PREFILL_SEQ / wall:.0f} tokens/s), flash_attn launches "
        f"{timed_routes}; moe_drop_fraction {drop:.6f}")
    log(f"[moe_serve] kernel prefill vs plain-attention prefill (both "
        f"bf16): max |diff| {check['max_abs_diff']:.4e}, relative L2 "
        f"{check['rel_l2']:.4e}, {check['outside']} logits of "
        f"{check['tokens_outside']} tokens outside rtol 2e-2 / atol 5e-2; "
        f"of {MOE_PREFILL_SEQ} tokens {check['tokens_rerouted']} routed to "
        f"another expert set and {check['tokens_redropped']} kept or dropped "
        f"otherwise in some layer (a bf16 near-tie of the router, a "
        f"capacity slot that moved); the tokens routed alike: max |diff| "
        f"{check['max_abs_diff_same_route']:.4e}, "
        f"{check['outside_same_route']} logits outside")
    if check["outside_same_route"]:
        raise AssertionError(f"[moe_serve] the kernel prefill differs from "
                             f"the plain-attention prefill beyond the "
                             f"engine tolerance on tokens routed alike: "
                             f"{check}")

    # the contiguous decode loop, as launch.serve.run_contiguous runs it
    dshape = ShapeConfig("serve", 512, 4, "decode")
    step = build_decode_step(model, dshape, device=dev)
    state = init_decode_state(model, dshape, device=dev)
    token = torch.zeros((4,), dtype=torch.int32, device=dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    for pos in range(16):
        logits, state = step(params, token, state, pos)
        token = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize(dev)
    dwall = time.perf_counter() - t0
    if any(launch_counters().values()):
        raise AssertionError(f"[moe_serve] decode launches "
                             f"{launch_counters()}: the contiguous decode "
                             f"runs no kernel")
    if tuple(logits.shape) != (4, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("[moe_serve] decode logits")
    prof_wall, by_name, _ = device_activity(
        lambda: step(params, token, state, 16), 1, warm=False)
    if not by_name:
        raise RuntimeError("[moe_serve] no device activity in a decode step")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    peak = torch.cuda.max_memory_allocated(dev)
    log(f"[moe_serve] contiguous decode, batch 4, cache 512, 16 tokens: "
        f"{64 / dwall:.1f} tok/s ({dwall * 1e3:.0f} ms, first step "
        f"included), logits finite, no kernel launched; profiled step: wall "
        f"{prof_wall:.1f} ms, device busy {busy:.1f} ms, idle share "
        f"{1 - busy / prof_wall:.3f}; peak {peak / 2**30:.2f} GiB")
    for name, ms in top:
        log(f"[moe_serve]   {ms:9.2f} ms/step  {name[:90]}")
    del params, state, step, prefill, plain, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "prefill_wall_ms": wall * 1e3,
            "prefill_tokens_per_s": MOE_PREFILL_SEQ / wall,
            "launches": timed_routes["wgmma"],
            "launches_by_route": timed_routes, "check": check,
            "moe_drop_fraction": drop, "capacity": cap,
            "decode_tokens_per_s": 64 / dwall, "decode_wall_s": dwall,
            "decode_profile": {"wall_ms": prof_wall, "device_ms": busy,
                               "idle_share": 1 - busy / prof_wall,
                               "top_device_ms": {k[:90]: v
                                                 for k, v in top}},
            "peak_bytes": peak}


def phase_moe_train(dev) -> dict:
    """``launch.train`` on mixtral-8x7b at full width, 1 layer, one rank,
    the arch's settings (fsdp, 4 microbatches, ``ring_hier`` over 2
    channels) with the arena on: 3 steps, their losses and
    ``moe_drop_fraction``, pack's launches against ``fsdp_expected``, the
    peak, one profiled step."""
    import gc

    import torch

    from repro_torch import tree as tree_util
    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(MOE_TRAIN_ARGS)
    world = launch_train.init_distributed(args.device)
    run = launch_train.setup(args, world)
    _check_moe_width(run.model.cfg, 1, "moe_train")
    trainer = run.trainer
    step = trainer.step_fn
    if (step.cfg.dp_mode, step.schedule.microbatches, step.moe_comm) != (
            "fsdp", 4, None):
        raise AssertionError(f"[moe_train] the step runs {step.cfg} on "
                             f"{step.mesh}")
    state_bytes = sum(t.numel() * t.element_size() for k, v in
                      trainer.state.items() if k != "step"
                      for t in tree_util.leaves(v))
    expected, _ = fsdp_expected(step, args.steps, 1)
    recorder = _StepMetrics(step)
    trainer.step_fn = recorder
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    hist = trainer.run()["history"]
    counts, routes = launch_counters(), pack_routes()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    drops = [m["moe_drop_fraction"] for m in recorder.metrics]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[moe_train] non-finite loss: {losses}")
    _check_launches("moe_train", counts, expected, routes)
    prof = step_profile(trainer, 0, 1, profiled=True)
    log(f"[moe_train] mixtral-8x7b at full width, 1 layer, "
        f"{run.model.param_count() / 1e9:.3f}e9 parameters "
        f"({run.model.active_param_count() / 1e9:.3f}e9 active a token), "
        f"1 rank, fsdp, "
        f"4 microbatches, arena on: state {state_bytes / 2**30:.2f} GiB; "
        f"losses {', '.join(f'{x:.4f}' for x in losses)}; "
        f"moe_drop_fraction {', '.join(f'{x:.6f}' for x in drops)}; step "
        f"wall {', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms; peak "
        f"{peak / 2**30:.2f} GiB; launches "
        f"{({k: v for k, v in counts.items() if v})} == fsdp_expected, "
        f"pack by route {routes}")
    log(f"[moe_train] profiled step: wall {prof['step_wall_ms']:.1f} ms, "
        f"device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    for name, ms in prof["top_device_ms"].items():
        log(f"[moe_train]   {ms:9.2f} ms/step  {name}")
    out = {"losses": losses, "moe_drop_fraction": drops,
           "step_s": [h["sec"] for h in hist], "launches": counts,
           "expected": expected, "pack_routes": routes,
           "state_bytes": state_bytes, "peak_bytes": peak,
           "params": run.model.param_count(), "profile": prof}
    del run, trainer, step, recorder
    gc.collect()
    torch.cuda.empty_cache()
    return out


def moe_ep_expected(step, steps: int, batch: int, seq: int) -> dict:
    """What ``steps`` steps of ``step`` put on the EP communicator and
    the model axis's gathers, derived from the code.  Per MoE layer and
    microbatch the forward exchanges the capacity buffer twice (dispatch,
    combine), the backward twice more (their transposes) and, under
    ``remat="layer"``, the backward's recomputation of the block twice
    again; each exchange runs on ``a2a_rails`` rails, one
    ``all_to_all_single`` a rail sending ``(p-1)/p`` of its stripe
    (``A2APlan``).  The combined output is gathered over the model axis once
    (``gather_replicated``): the recomputation stops at the last tensor the
    backward needs (``torch.utils.checkpoint``'s early stop), which comes
    before the gather, and the gather's backward is a slice."""
    import torch

    from repro_torch.models.moe import capacity
    from repro_torch.models.transformer import moe_layer_count

    cfg, comm = step.model.cfg, step.moe_comm
    p = comm.axis_sizes[0]
    m = step.schedule.microbatches
    rows = batch // m // p
    shape = (rows, cfg.moe.num_experts, capacity(seq, cfg.moe), cfg.d_model)
    plan = comm.a2a_plan(shape, getattr(torch, cfg.dtype))
    n_moe = moe_layer_count(cfg)
    pairs = (3 if cfg.remat == "layer" else 2) * n_moe * m * steps
    gathers = n_moe * m * steps
    return {"all_to_alls": pairs * plan.n_units,
            "all_to_all_bytes": int(pairs * plan.bytes_per_device),
            "all_gathers": gathers,
            "all_gather_bytes": gathers * rows * seq * cfg.d_model
            * getattr(torch, cfg.dtype).itemsize,
            "shape": shape, "rails": comm.a2a_rails(shape)}


def _moe_layer_transports(world, cfg) -> dict:
    """One MoE layer at full width, forward and backward at bf16 compute on
    the same inputs, through the ``a2a``, ``ring`` and ``psum`` transports
    (a communicator each, built in one order on both ranks): whether the
    output and every gradient equal the ``a2a`` run's, and each
    transport's record."""
    import torch

    from repro_torch import tree as tree_util
    from repro_torch.models.moe import moe_apply, moe_init
    from repro_torch.models.parallel import make_ctx
    from repro_torch.runtime.train_step import (TrainStepConfig,
                                                build_moe_comm)

    dev = world.device
    mesh = _tp_mesh()
    r = world.rank
    full = moe_init(torch.Generator(device=dev).manual_seed(5), cfg.moe,
                    cfg.d_model, device=dev)
    el = cfg.moe.num_experts // world.size
    local = {"router": full["router"],
             **{n: full[n][r * el:(r + 1) * el].clone()
                for n in ("w_gate", "w_up", "w_down")}}
    del full
    gen = torch.Generator(device=dev).manual_seed(6)
    x = torch.randn((2, 256, cfg.d_model), generator=gen, device=dev)
    w = torch.randn(x.shape, generator=gen, device=dev)
    out, ref = {}, None
    for t in ("a2a", "ring", "psum"):
        comm = build_moe_comm(mesh, TrainStepConfig(moe_transport=t,
                                                    moe_channels=2))
        ctx = make_ctx(mesh, moe_comm=comm)
        leaves, treedef = tree_util.flatten(local)
        leaves = [l.detach().requires_grad_(True) for l in leaves]
        xx = x.clone().requires_grad_(True)
        y, aux, _ = moe_apply(treedef.unflatten(leaves), xx, cfg.moe,
                              cfg.act, ctx=ctx, compute_dtype=torch.bfloat16)
        grads = torch.autograd.grad(torch.sum(y.float() * w) + aux,
                                    leaves + [xx])
        res = [y.detach()] + [g.detach() for g in grads]
        if ref is None:
            ref = res
        out[t] = {"equal": all(torch.equal(a, b) for a, b in zip(res, ref)),
                  "record": comm.record.as_dict()}
        del comm, ctx, leaves, xx, y, grads, res
    return out


def _moe_ep_gate(world) -> dict:
    """EP on (1, 2) at fp32 compute, 1 layer at full width, against one
    rank (rank 0 alone, a (1, 1) mesh): the same seed, batches and step
    config, ``replicated``, 3 steps."""
    import gc

    import torch

    from repro_torch.comm import CommConfig
    from repro_torch.configs import get_config
    from repro_torch.core.topology import RankMesh
    from repro_torch.data import DataConfig, SyntheticTokens
    from repro_torch.models import build_model
    from repro_torch.optim import OptimConfig
    from repro_torch.runtime.train_loop import Trainer, TrainerConfig
    from repro_torch.runtime.train_step import TrainStepConfig

    model = build_model(get_config(MOE_ARCH).with_(
        num_layers=1, dtype="float32", **_moe_ep_overrides()))
    data = SyntheticTokens(DataConfig(vocab_size=model.cfg.vocab_size,
                                      seq_len=256, global_batch=8))
    step_cfg = TrainStepConfig(
        dp_mode="replicated", comm=CommConfig(transport="ring_hier",
                                              chunks=2),
        optim=OptimConfig(base_lr=3e-4, warmup=1, total_steps=3),
        moe_transport="a2a", moe_channels=2)

    def hist(mesh):
        tr = Trainer(model, mesh, step_cfg, data,
                     TrainerConfig(steps=3, seed=0), device=world.device,
                     rank=world.rank, log=lambda msg: None)
        h = tr.run()["history"]
        del tr
        gc.collect()
        torch.cuda.empty_cache()
        return [x["loss"] for x in h], [x["grad_norm"] for x in h]

    ep = hist(_tp_mesh())
    one = hist(RankMesh(("data", "model"), (1, 1))) if world.rank == 0 \
        else None
    return {"ep": ep, "one": one}


def _moe_ep_worker(argv: list[str]) -> dict:
    """One of the two ranks of moe_ep: mixtral at full width, 1 layer, its
    experts sharded over the model axis of (1, 2), the arch's settings
    (fsdp, 4 microbatches, the ``a2a`` transport over 2 rails): 3 steps
    with each step's EP and model-axis records, one profiled step; then
    one MoE layer through the three transports and the fp32 gate."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    torch.backends.cuda.matmul.allow_tf32 = False
    world = launch_train.init_distributed("cuda")
    args = launch_train.parser().parse_args(argv)
    torch.cuda.reset_peak_memory_stats(world.device)
    run = launch_train.setup(args, world,
                             model_overrides=_moe_ep_overrides())
    _check_moe_width(run.model.cfg, 1, "moe_ep")
    trainer = run.trainer
    step = trainer.step_fn
    comm = step.moe_comm
    if (step.model_size, step.data_world, step.cfg.dp_mode,
            comm.cfg.transport, comm.cfg.channels) != (2, 1, "fsdp", "a2a",
                                                       2):
        raise AssertionError(f"[moe_ep] the step runs {step.cfg} on "
                             f"{step.mesh}")
    expected = moe_ep_expected(step, 1, args.batch, args.seq)
    launches, _ = fsdp_expected(step, args.steps, 1)

    def records():
        """The step's EP and model-axis records; resets both."""
        out = (comm.record.as_dict(), step.model_record.as_dict())
        comm.record.reset()
        step.model_record.reset()
        return out

    recorder = _StepMetrics(step, records)
    trainer.step_fn = recorder
    reset_launch_counters()
    hist = trainer.run()["history"]
    counts, routes = launch_counters(), pack_routes()
    peak = torch.cuda.max_memory_allocated(world.device)
    trainer.step_fn = step
    prof = step_profile(trainer, step.data_index, step.data_world,
                        profiled=world.rank == 0)
    out = {"losses": [h["loss"] for h in hist],
           "drops": [m["moe_drop_fraction"] for m in recorder.metrics],
           "step_s": [h["sec"] for h in hist],
           "records": recorder.records, "expected": expected,
           "counts": counts,
           "launches_expected": launches, "pack_routes": routes,
           "local_params": _leaf_count(trainer.state["groups"]),
           "peak_bytes": peak, "profile": prof}
    cfg = run.model.cfg
    del run, trainer, step, recorder, records, comm
    gc.collect()
    torch.cuda.empty_cache()
    out["transports"] = _moe_layer_transports(world, cfg)
    gc.collect()
    torch.cuda.empty_cache()
    out["gate"] = _moe_ep_gate(world)
    return out


def check_moe_ep(ranks: list) -> dict:
    """The checks of moe_ep (:func:`_moe_ep_worker`'s results)."""
    for r, out in enumerate(ranks):
        if not all(math.isfinite(x) for x in out["losses"]):
            raise AssertionError(f"[moe_ep] rank {r}: non-finite loss")
        _check_launches(f"moe_ep rank {r}", out["counts"],
                        out["launches_expected"], out["pack_routes"])
        exp = out["expected"]
        for i, (moe, model) in enumerate(out["records"]):
            got = {"all_to_alls": moe["all_to_alls"],
                   "all_to_all_bytes": moe["all_to_all_bytes"],
                   "all_gathers": model["all_gathers"],
                   "all_gather_bytes": model["all_gather_bytes"]}
            if got != {k: exp[k] for k in got}:
                raise AssertionError(f"[moe_ep] rank {r} step {i}: {got} != "
                                     f"expected {exp}")
            if moe["sends"] or moe["all_reduces"]:
                raise AssertionError(f"[moe_ep] rank {r} step {i}: the EP "
                                     f"communicator moved {moe}")
        if len(out["records"]) != len(out["losses"]):
            raise AssertionError(f"[moe_ep] rank {r}: {len(out['records'])} "
                                 f"step records")
        for t, res in out["transports"].items():
            if not res["equal"]:
                raise AssertionError(f"[moe_ep] rank {r}: the MoE layer "
                                     f"through {t} differs from a2a")
    a, b = ranks
    if a["losses"] != b["losses"] or a["drops"] != b["drops"]:
        raise AssertionError(f"[moe_ep] the ranks disagree: losses "
                             f"{a['losses']} / {b['losses']}, drops "
                             f"{a['drops']} / {b['drops']}")
    gate = a["gate"]
    (ep_l, ep_n), (one_l, one_n) = gate["ep"], gate["one"]
    loss_err = max(abs(x - y) for x, y in zip(ep_l, one_l))
    norm_err = max(abs(x - y) / y for x, y in zip(ep_n, one_n))
    if loss_err > MOE_GATE_ATOL:
        raise AssertionError(f"[moe_ep] fp32 gate: losses {ep_l} vs one "
                             f"rank {one_l} ({loss_err:.3e})")
    if b["gate"]["ep"] != gate["ep"]:
        raise AssertionError("[moe_ep] the ranks' gate runs disagree")
    exp, prof = a["expected"], a["profile"]
    moe0, model0 = a["records"][0]
    n = len(a["losses"])
    staging = sum(m["staging_s"] for m, _ in a["records"]) / n
    log(f"[moe_ep] mixtral-8x7b at full width, 1 layer, experts over "
        f"(1, 2), {a['local_params'] / 1e9:.3f}e9 parameters a rank, fsdp, "
        f"a2a over {exp['rails']} rails: losses "
        f"{', '.join(f'{x:.4f}' for x in a['losses'])}; moe_drop_fraction "
        f"{', '.join(f'{x:.6f}' for x in a['drops'])} (equal on both "
        f"ranks); step wall {', '.join(f'{x * 1e3:.0f}' for x in a['step_s'])}"
        f" ms; peak {a['peak_bytes'] / 2**30:.2f} GiB a rank")
    log(f"[moe_ep] a step: {moe0['all_to_alls']} all-to-alls, "
        f"{moe0['all_to_all_bytes']} B (expected {exp['all_to_alls']}, "
        f"{exp['all_to_all_bytes']} B: buffer {exp['shape']} bf16), "
        f"{model0['all_gathers']} model-axis all-gathers "
        f"({exp['all_gathers']} expected), {model0['all_reduces']} model-axis"
        f" all-reduces ({model0['all_reduce_bytes']} B), EP staging "
        f"{staging:.3f} s a step; profiled step (rank 0): wall "
        f"{prof['step_wall_ms']:.1f} ms, busy {prof['step_device_ms']:.1f} "
        f"ms, idle {prof['idle_share']:.3f}")
    log(f"[moe_ep] one MoE layer through ring and psum == through a2a "
        f"(output and gradients), records "
        f"{ {t: {k: v for k, v in res['record'].items() if v and k != 'staging_s'} for t, res in a['transports'].items()} }")
    log(f"[moe_ep] fp32 gate, 1 layer: EP losses "
        f"{', '.join(f'{x:.6f}' for x in ep_l)} vs one rank "
        f"{', '.join(f'{x:.6f}' for x in one_l)}: max |diff| {loss_err:.3e} "
        f"(<= {MOE_GATE_ATOL}); gradient norms within {norm_err:.3e}")
    return {"ranks": ranks, "gate_loss_err": loss_err,
            "gate_norm_err": norm_err}


# ---------------------------------------------------------------------------
# the remaining families: SSM, hybrid, encoder-decoder, vision stub
# ---------------------------------------------------------------------------

SSM_ARCH, HYBRID_ARCH = "falcon-mamba-7b", "hymba-1.5b"
ENCDEC_ARCH, VLM_ARCH = "whisper-base", "llava-next-34b"
SSM_PREFILL = (2, 2048)      # ssm_serve's timed prefill: batch, length
SSM_CHECK_TOKENS = 64        # decode steps held against the prefill
# tests/test_models.py::test_ssm_decode_matches_full_scan's rtol and atol
SSM_CHECK_TOL = 1e-3
SSM_DECODE_TOKENS = 16
HYBRID_PREFILL_SEQ = 4096
# 16 decode positions across the wrap of the 1024-slot rolling caches
HYBRID_DECODE_FROM, HYBRID_DECODE_TOKENS = 1016, 16
ENCDEC_BATCH, ENCDEC_TOKENS, ENCDEC_CACHE = 4, 32, 448
VLM_LAYERS, VLM_SEQ = 2, 4096
FAMILIES_TRAIN_ARGS = ["--arch", HYBRID_ARCH, "--layers", "4", "--use-arena",
                       "--steps", "3", "--device", "cuda", "--seed", "0",
                       "--model-parallel", "1"]
# each arch's published widths (the vocab padded to 128), which its phase
# must run at
FAMILY_WIDTHS = {
    SSM_ARCH: dict(d_model=4096, d_ff=0, vocab_size=65024, attn=None,
                   ssm=(16, 4, 2, 0)),
    HYBRID_ARCH: dict(d_model=1600, d_ff=5504, vocab_size=32128,
                      attn=(25, 5, 64, 1024, (0, 15, 31)), ssm=(16, 4, 2, 0)),
    ENCDEC_ARCH: dict(d_model=512, d_ff=2048, vocab_size=51968,
                      attn=(8, 8, 64, None, ()), ssm=None, enc_layers=6,
                      enc_seq=1500),
    VLM_ARCH: dict(d_model=7168, d_ff=20480, vocab_size=64000,
                   attn=(56, 8, 128, None, ()), ssm=None, frontend_seq=576)}


def _check_family_width(cfg, arch: str, layers: int, what: str) -> None:
    want = dict(FAMILY_WIDTHS[arch], num_layers=layers)
    a, s = cfg.attn, cfg.ssm
    got = {k: getattr(cfg, k) for k in want if k not in ("attn", "ssm")}
    got["attn"] = None if a is None else (a.num_heads, a.num_kv_heads,
                                          a.head_dim, a.window,
                                          a.global_layers)
    got["ssm"] = None if s is None else (s.state_dim, s.conv_width,
                                         s.expand, s.dt_rank)
    if got != want:
        raise AssertionError(f"[{what}] not {arch} at full width: {got}")


def _no_launches(what: str) -> None:
    if any(launch_counters().values()):
        raise AssertionError(f"[{what}] launches {launch_counters()}: this "
                             f"path runs no kernel")


def _prefill_check(got, plain, want, what: str) -> dict:
    """The bf16 kernel route's output ``got`` and the bf16 blockwise
    route's ``plain``, each against the fp32 blockwise route's ``want``,
    held as the prefill phase holds llama's: the kernel's relative L2 and
    its count of misses of the engine's tolerance at most
    ``PREFILL_BF16_L2_MARGIN`` and ``PREFILL_BF16_MISS_MARGIN`` times the
    blockwise route's."""
    import torch

    def error(x):
        if not bool(torch.isfinite(x).all()):
            raise AssertionError(f"[{what}] non-finite output")
        diff = (x.float() - want).abs()
        return {"max_abs_diff": diff.max().item(),
                "rel_l2": (diff.norm() / want.norm()).item(),
                "outside": int((diff > ENGINE_ATOL + ENGINE_RTOL
                                * want.abs()).sum())}

    row = {"bf16_kernel": error(got), "bf16_blockwise": error(plain)}
    for key, margin in (("rel_l2", PREFILL_BF16_L2_MARGIN),
                        ("outside", PREFILL_BF16_MISS_MARGIN)):
        k, b = row["bf16_kernel"][key], row["bf16_blockwise"][key]
        if k > margin * b:
            raise AssertionError(f"[{what}] the kernel route's {key} {k:.4e} "
                                 f"is above {margin} x the blockwise "
                                 f"route's {b:.4e}")
    for name, e in row.items():
        log(f"[{what}] {name} vs fp32 blockwise: max |diff| "
            f"{e['max_abs_diff']:.4e}, relative L2 {e['rel_l2']:.4e}, "
            f"{e['outside']} outside rtol 2e-2 / atol 5e-2")
    return row


def _attn_launches(fn, n: int, what: str):
    """``fn()`` with the counters reset: exactly ``n`` flash_attn launches,
    all on the wgmma route, and no other kernel's."""
    import torch

    reset_launch_counters()
    out = fn()
    torch.cuda.synchronize()
    counts, routes = launch_counters(), attn_routes()
    if counts != dict(dict.fromkeys(counts, 0), flash_attn=n) or \
            routes != dict(dict.fromkeys(routes, 0), wgmma=n):
        raise AssertionError(f"[{what}] launches {counts}, by route "
                             f"{routes}, expected {n} wgmma flash_attn and "
                             f"no other")
    return out


def _decode_profile(step, params, token, state, pos, what: str) -> dict:
    """One profiled decode step: wall, device busy, idle share."""
    wall, by_name, _ = device_activity(
        lambda: step(params, token, state, pos), 1, warm=False)
    if not by_name:
        raise RuntimeError(f"[{what}] no device activity in a decode step")
    busy = sum(by_name.values())
    return {"wall_ms": wall, "device_ms": busy, "idle_share": 1 - busy / wall}


def _tokens(dev, b: int, s: int, vocab: int, seed: int):
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=gen, device=dev,
                         dtype=torch.int32)


def phase_ssm_serve(dev) -> dict:
    """falcon-mamba-7b at full width and depth (64 Mamba-1 blocks, d_inner
    8192, state 16, dt_rank 256), one rank, seeded random weights: at fp32
    compute, 64 decode steps from an empty state against the prefill's
    logits at the same 64 positions (the reference's decode-vs-scan
    tolerance); at bf16 compute the prefill at B=2, S=2048 (warm, timed,
    profiled with CUDA events around every ``selective_scan``) and a
    contiguous decode of 16 tokens with a profiled step.  No kernel runs on
    this path (the reference's scan is plain ``jnp``)."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill,
                                                init_decode_state)

    model = build_model(get_config(SSM_ARCH))
    cfg = model.cfg
    layers = cfg.num_layers
    _check_family_width(cfg, SSM_ARCH, 64, "ssm_serve")
    t0 = time.perf_counter()
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    torch.cuda.synchronize(dev)
    init_s = time.perf_counter() - t0
    n_params = model.param_count()

    # the decode against the scan, at fp32 compute on the same weights
    m32 = build_model(cfg.with_(dtype="float32"))
    n = SSM_CHECK_TOKENS
    toks = _tokens(dev, 1, n, cfg.vocab_size, 1)
    reset_launch_counters()
    want = build_prefill(m32, ShapeConfig("ssm_check", n, 1, "prefill"),
                         device=dev)(params, {"tokens": toks})[0]
    cshape = ShapeConfig("ssm_check", n, 1, "decode")
    step32 = build_decode_step(m32, cshape, device=dev)
    state = init_decode_state(m32, cshape, device=dev)
    got = []
    for pos in range(n):
        logits, state = step32(params, toks[:, pos], state, pos)
        got.append(logits[0])
    got = torch.stack(got)
    torch.cuda.synchronize(dev)
    _no_launches("ssm_serve")
    diff = (got - want).abs()
    outside = int((diff > SSM_CHECK_TOL + SSM_CHECK_TOL * want.abs()).sum())
    check = {"max_abs_diff": diff.max().item(),
             "max_abs_logit": want.abs().max().item(), "outside": outside}
    log(f"[ssm_serve] fp32: {n} decode steps from an empty state vs the "
        f"prefill's logits at the same positions, {layers} layers: max "
        f"|diff| {check['max_abs_diff']:.4e} (logits up to "
        f"{check['max_abs_logit']:.3f}), {outside} outside rtol / atol "
        f"{SSM_CHECK_TOL}")
    if outside or not bool(torch.isfinite(got).all()):
        raise AssertionError(f"[ssm_serve] decode vs prefill: {check}")
    del want, got, state, step32, logits, diff
    gc.collect()

    b, s = SSM_PREFILL
    shape = ShapeConfig("ssm_prefill", s, b, "prefill")
    prefill = build_prefill(model, shape, device=dev)
    batch = {"tokens": _tokens(dev, b, s, cfg.vocab_size, 2)}
    prefill(params, batch)
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    logits = prefill(params, batch)
    torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    _no_launches("ssm_serve")
    if tuple(logits.shape) != (b, s, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"[ssm_serve] prefill logits "
                             f"{tuple(logits.shape)}")
    del logits
    gc.collect()
    # the scan's share: CUDA events around each selective_scan call of a
    # profiled prefill
    spans: list = []
    real = ssm_mod.selective_scan
    inside = []              # the scan recurses through the module's name

    def timed_scan(abar, bx):
        if inside:
            return real(abar, bx)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        inside.append(True)
        e0.record()
        try:
            out = real(abar, bx)
        finally:
            inside.pop()
        e1.record()
        spans.append((e0, e1))
        return out

    ssm_mod.selective_scan = timed_scan
    try:
        prof_wall, by_name, _ = device_activity(
            lambda: prefill(params, batch), 1, warm=False)
    finally:
        ssm_mod.selective_scan = real
    if len(spans) != layers or not by_name:
        raise AssertionError(f"[ssm_serve] {len(spans)} scans timed, "
                             f"{len(by_name)} device activities")
    scan_ms = sum(e0.elapsed_time(e1) for e0, e1 in spans)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[ssm_serve] falcon-mamba-7b at full width, {layers} layers, "
        f"{n_params / 1e9:.3f}e9 fp32 parameters (made in {init_s:.1f} s); "
        f"bf16 prefill B={b} S={s}: wall {wall * 1e3:.1f} ms "
        f"({b * s / wall:.0f} tokens/s), peak {peak / 2**30:.2f} GiB, "
        f"logits finite, no kernel launched")
    log(f"[ssm_serve] profiled prefill: wall {prof_wall:.1f} ms, device busy "
        f"{busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}; "
        f"selective_scan {scan_ms:.1f} ms over {layers} calls "
        f"({scan_ms / layers:.2f} ms a layer at (B, S, Din, N) = ({b}, {s}, "
        f"8192, 16), CUDA events), {scan_ms / busy:.3f} of the device "
        f"busy time")
    for name, ms in top:
        log(f"[ssm_serve]   {ms:9.2f} ms/prefill  {name[:90]}")
    del prefill, batch, spans
    gc.collect()
    torch.cuda.empty_cache()

    dshape = ShapeConfig("serve", s, b, "decode")
    step = build_decode_step(model, dshape, device=dev)
    state = init_decode_state(model, dshape, device=dev)
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    for pos in range(SSM_DECODE_TOKENS):
        logits, state = step(params, token, state, pos)
        token = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize(dev)
    dwall = time.perf_counter() - t0
    _no_launches("ssm_serve")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[ssm_serve] decode logits")
    dprof = _decode_profile(step, params, token, state, SSM_DECODE_TOKENS,
                            "ssm_serve")
    tok_s = b * SSM_DECODE_TOKENS / dwall
    log(f"[ssm_serve] contiguous decode, batch {b}, {SSM_DECODE_TOKENS} "
        f"tokens: {tok_s:.1f} tok/s ({dwall * 1e3:.0f} ms, first step "
        f"included), logits finite; profiled step: wall "
        f"{dprof['wall_ms']:.1f} ms, device busy {dprof['device_ms']:.1f} "
        f"ms, idle share {dprof['idle_share']:.3f}")
    del params, state, step, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": n_params, "init_s": init_s, "check": check,
            "prefill_wall_ms": wall * 1e3, "prefill_peak_bytes": peak,
            "prefill_tokens_per_s": b * s / wall,
            "prefill_profile": {"wall_ms": prof_wall, "device_ms": busy,
                                "idle_share": 1 - busy / prof_wall,
                                "top_device_ms": {k[:90]: v
                                                  for k, v in top}},
            "scan_ms": scan_ms, "scan_ms_per_layer": scan_ms / layers,
            "scan_share": scan_ms / busy,
            "decode_tokens_per_s": tok_s, "decode_wall_s": dwall,
            "decode_profile": dprof}


def phase_hybrid_serve(dev) -> dict:
    """hymba-1.5b at full width and depth (32 layers of parallel attention,
    25 q / 5 kv heads, and Mamba heads; 3 global layers, 29 windowed at
    1024), one rank: the prefill at B=1, S=4096 through ``flash_attn``
    (exactly 32 wgmma launches and no other kernel's) against the fp32 and
    the bf16 blockwise prefills, timed and profiled; then 16 contiguous
    decode tokens across the wrap of the windowed layers' 1024-slot
    rolling caches, with a profiled step."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill,
                                                init_decode_state)

    model = build_model(get_config(HYBRID_ARCH))
    cfg, a = model.cfg, model.cfg.attn
    layers = cfg.num_layers
    _check_family_width(cfg, HYBRID_ARCH, 32, "hybrid_serve")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    s = HYBRID_PREFILL_SEQ
    shape = ShapeConfig("hybrid_prefill", s, 1, "prefill")
    batch = {"tokens": _tokens(dev, 1, s, cfg.vocab_size, 1)}
    m32 = build_model(cfg.with_(dtype="float32"))
    reset_launch_counters()
    want = build_prefill(m32, shape, attn_impl="blockwise", device=dev)(
        params, batch).float()
    plain = build_prefill(model, shape, attn_impl="blockwise", device=dev)(
        params, batch)
    _no_launches("hybrid_serve")
    prefill = build_prefill(model, shape, device=dev)
    _attn_launches(lambda: prefill(params, batch), layers, "hybrid_serve")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = _attn_launches(lambda: prefill(params, batch), layers,
                         "hybrid_serve")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(got.shape) != (1, s, cfg.vocab_size):
        raise AssertionError(f"[hybrid_serve] logits {tuple(got.shape)}")
    check = _prefill_check(got, plain, want, "hybrid_serve")
    del got, plain, want
    gc.collect()
    reset_launch_counters()
    prof_wall, by_name, counts = device_activity(
        lambda: prefill(params, batch), 1, warm=False)
    if attn_routes()["wgmma"] != layers or not by_name:
        raise AssertionError(f"[hybrid_serve] profiled prefill: "
                             f"{attn_routes()}")
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log(f"[hybrid_serve] hymba-1.5b at full width, {layers} layers, "
        f"{model.param_count() / 1e9:.3f}e9 fp32 parameters; bf16 prefill "
        f"B=1 S={s}: wall {wall * 1e3:.1f} ms ({s / wall:.0f} tokens/s), "
        f"peak {peak / 2**30:.2f} GiB, flash_attn {layers} wgmma launches "
        f"({a.num_heads} q heads over {a.num_kv_heads} kv heads; "
        f"{len(a.global_layers)} global layers, "
        f"{layers - len(a.global_layers)} windowed at {a.window}) and no "
        f"other kernel's")
    log(f"[hybrid_serve] profiled prefill: wall {prof_wall:.1f} ms, device "
        f"busy {busy:.1f} ms, idle share {1 - busy / prof_wall:.3f}; the "
        f"profiler recorded {port_kernels_seen(counts)} of the {layers} "
        f"flash_attn launches")
    for name, ms in top:
        log(f"[hybrid_serve]   {ms:9.2f} ms/prefill  {name[:90]}")
    del prefill, batch
    gc.collect()
    torch.cuda.empty_cache()

    dshape = ShapeConfig("serve", s, 1, "decode")
    step = build_decode_step(model, dshape, device=dev)
    state = init_decode_state(model, dshape, device=dev)
    slots = [st["kv"]["k"].shape[2] for st in state]
    if sorted(set(slots)) != [cfg.attn.window, s] or \
            slots.count(s) != len(cfg.attn.global_layers):
        raise AssertionError(f"[hybrid_serve] cache slots by layer {slots}")
    token = torch.zeros((1,), dtype=torch.int32, device=dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    for pos in range(HYBRID_DECODE_FROM,
                     HYBRID_DECODE_FROM + HYBRID_DECODE_TOKENS):
        logits, state = step(params, token, state, pos)
        token = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize(dev)
    dwall = time.perf_counter() - t0
    _no_launches("hybrid_serve")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("[hybrid_serve] decode logits")
    dprof = _decode_profile(step, params, token, state,
                            HYBRID_DECODE_FROM + HYBRID_DECODE_TOKENS,
                            "hybrid_serve")
    tok_s = HYBRID_DECODE_TOKENS / dwall
    log(f"[hybrid_serve] contiguous decode, batch 1, positions "
        f"{HYBRID_DECODE_FROM}..{HYBRID_DECODE_FROM + HYBRID_DECODE_TOKENS - 1}"
        f" (the 1024-slot rolling caches wrap at 1024; caches filled by the "
        f"decode alone): {tok_s:.1f} tok/s, logits finite, no kernel "
        f"launched; profiled step: wall {dprof['wall_ms']:.1f} ms, idle "
        f"share {dprof['idle_share']:.3f}")
    del params, state, step, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": model.param_count(), "launches": layers,
            "check": check, "prefill_wall_ms": wall * 1e3,
            "prefill_peak_bytes": peak,
            "prefill_profile": {"wall_ms": prof_wall, "device_ms": busy,
                                "idle_share": 1 - busy / prof_wall,
                                "top_device_ms": {k[:90]: v
                                                  for k, v in top}},
            "decode_tokens_per_s": tok_s, "decode_profile": dprof}


def phase_encdec_serve(dev) -> dict:
    """whisper-base at full size (6 encoder and 6 decoder layers, 1500
    frames), one rank: the decode state of B=4 (the encoder once over the
    frames, its self-attention through ``flash_attn``: 6 non-causal wgmma
    launches and no other kernel's, then the cross k/v cached), the
    encoder's output against the fp32 and the bf16 blockwise encoders;
    then 32 decode tokens against the cross caches, with a profiled
    step."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model, encdec
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                init_decode_state)

    model = build_model(get_config(ENCDEC_ARCH))
    cfg = model.cfg
    _check_family_width(cfg, ENCDEC_ARCH, 6, "encdec_serve")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    b, n_enc = ENCDEC_BATCH, cfg.enc_layers
    gen = torch.Generator(device=dev).manual_seed(1)
    frames = (torch.randn((b, cfg.enc_seq, cfg.d_model), generator=gen,
                          device=dev) * 0.02).to(torch.bfloat16)
    shape = ShapeConfig("serve", ENCDEC_CACHE, b, "decode")
    _attn_launches(lambda: init_decode_state(
        model, shape, params=params, frames=frames, device=dev), n_enc,
        "encdec_serve")
    t0 = time.perf_counter()
    state = _attn_launches(lambda: init_decode_state(
        model, shape, params=params, frames=frames, device=dev), n_enc,
        "encdec_serve")
    enc_wall = time.perf_counter() - t0
    if tuple(state[0]["cross_k"].shape) != (b, cfg.attn.num_kv_heads,
                                            cfg.enc_seq, cfg.attn.head_dim):
        raise AssertionError(f"[encdec_serve] cross k "
                             f"{tuple(state[0]['cross_k'].shape)}")
    with torch.no_grad():
        got = _attn_launches(lambda: encdec.encode(
            params, frames, cfg, attn_impl="kernel"), n_enc, "encdec_serve")
        reset_launch_counters()
        plain = encdec.encode(params, frames, cfg)
        want = encdec.encode(params, frames, cfg.with_(dtype="float32"))
    _no_launches("encdec_serve")
    check = _prefill_check(got, plain, want, "encdec_serve")
    del got, plain, want
    gc.collect()
    step = build_decode_step(model, shape, device=dev)
    token = torch.zeros((b,), dtype=torch.int32, device=dev)
    reset_launch_counters()
    t0 = time.perf_counter()
    for pos in range(ENCDEC_TOKENS):
        logits, state = step(params, token, state, pos)
        token = torch.argmax(logits, -1).to(torch.int32)
    torch.cuda.synchronize(dev)
    dwall = time.perf_counter() - t0
    _no_launches("encdec_serve")
    if tuple(logits.shape) != (b, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError("[encdec_serve] decode logits")
    dprof = _decode_profile(step, params, token, state, ENCDEC_TOKENS,
                            "encdec_serve")
    tok_s = b * ENCDEC_TOKENS / dwall
    log(f"[encdec_serve] whisper-base at full size ({n_enc} + "
        f"{cfg.num_layers} layers, {cfg.enc_seq} frames, "
        f"{model.param_count() / 1e6:.1f}e6 fp32 parameters): encoder + "
        f"cross caches for B={b} in {enc_wall * 1e3:.1f} ms, {n_enc} "
        f"non-causal wgmma flash_attn launches and no other kernel's; "
        f"decode of {ENCDEC_TOKENS} tokens against the cross caches: "
        f"{tok_s:.1f} tok/s ({dwall * 1e3:.0f} ms), logits finite; "
        f"profiled step: wall {dprof['wall_ms']:.1f} ms, idle share "
        f"{dprof['idle_share']:.3f}")
    del params, state, step, frames, logits
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": model.param_count(), "launches": n_enc,
            "check": check, "encode_wall_ms": enc_wall * 1e3,
            "decode_tokens_per_s": tok_s, "decode_wall_s": dwall,
            "decode_profile": dprof}


def phase_vlm_prefill(dev) -> dict:
    """llava-next-34b at full width (d_model 7168, 56 q / 8 kv heads of
    128, d_ff 20480), 2 layers, one rank: the prefill at B=1, S=4096 (576
    patch embeddings ahead of 3520 tokens) through ``flash_attn`` (2 wgmma
    launches and no other kernel's) against the fp32 and the bf16 blockwise
    prefills, timed."""
    import gc

    import torch

    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.models import build_model
    from repro_torch.runtime.serve_step import build_prefill

    model = build_model(get_config(VLM_ARCH).with_(num_layers=VLM_LAYERS))
    cfg = model.cfg
    _check_family_width(cfg, VLM_ARCH, VLM_LAYERS, "vlm_prefill")
    params = model.init(torch.Generator(device=dev).manual_seed(0), dev)
    p, s = cfg.frontend_seq, VLM_SEQ
    gen = torch.Generator(device=dev).manual_seed(1)
    batch = {"tokens": _tokens(dev, 1, s - p, cfg.vocab_size, 2),
             "extra_embeds": (torch.randn((1, p, cfg.d_model), generator=gen,
                                          device=dev) * 0.02).to(
                                              torch.bfloat16)}
    shape = ShapeConfig("vlm_prefill", s, 1, "prefill")
    reset_launch_counters()
    want = build_prefill(build_model(cfg.with_(dtype="float32")), shape,
                         attn_impl="blockwise", device=dev)(
                             params, batch).float()
    plain = build_prefill(model, shape, attn_impl="blockwise", device=dev)(
        params, batch)
    _no_launches("vlm_prefill")
    prefill = build_prefill(model, shape, device=dev)
    _attn_launches(lambda: prefill(params, batch), VLM_LAYERS, "vlm_prefill")
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    got = _attn_launches(lambda: prefill(params, batch), VLM_LAYERS,
                         "vlm_prefill")
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    if tuple(got.shape) != (1, s, cfg.vocab_size):
        raise AssertionError(f"[vlm_prefill] logits {tuple(got.shape)}")
    check = _prefill_check(got, plain, want, "vlm_prefill")
    log(f"[vlm_prefill] llava-next-34b at full width, {VLM_LAYERS} layers, "
        f"{model.param_count() / 1e9:.3f}e9 fp32 parameters; bf16 prefill "
        f"B=1 S={s} ({p} patch embeddings + {s - p} tokens): wall "
        f"{wall * 1e3:.1f} ms, peak {peak / 2**30:.2f} GiB, {VLM_LAYERS} "
        f"wgmma flash_attn launches ({cfg.attn.num_heads} real q heads "
        f"over {cfg.attn.num_kv_heads} kv heads) and no other kernel's")
    del params, batch, prefill, got, plain, want
    gc.collect()
    torch.cuda.empty_cache()
    return {"params": model.param_count(), "launches": VLM_LAYERS,
            "check": check, "prefill_wall_ms": wall * 1e3,
            "prefill_peak_bytes": peak}


def phase_families_train(dev) -> dict:
    """``launch.train`` on hymba-1.5b at full width, 4 layers, one rank,
    the arch's settings (zero1, 2 microbatches, ``ring_hier``) with the
    arena on: 3 steps, finite losses, pack's launches as the code makes
    them (each microbatch packs every segment, each step reads every
    segment of the delta spans back; all bulk), the peak, a profiled
    step."""
    import gc

    import torch

    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(FAMILIES_TRAIN_ARGS)
    world = launch_train.init_distributed(args.device)
    run = launch_train.setup(args, world)
    _check_family_width(run.model.cfg, HYBRID_ARCH, 4, "families_train")
    trainer = run.trainer
    step = trainer.step_fn
    m = step.schedule.microbatches
    if (step.cfg.dp_mode, m, step.arena is None) != ("zero1", 2, False):
        raise AssertionError(f"[families_train] the step runs {step.cfg}")
    segs = step.arena.layout.n_segments
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launch_counters()
    hist = trainer.run()["history"]
    counts, routes = launch_counters(), pack_routes()
    peak = torch.cuda.max_memory_allocated(dev)
    losses = [h["loss"] for h in hist]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[families_train] non-finite loss: {losses}")
    expected = dict(dict.fromkeys(counts, 0),
                    pack_write=segs * m * args.steps,
                    pack_read=segs * args.steps)
    _check_launches("families_train", counts, expected, routes)
    prof = step_profile(trainer, 0, 1, profiled=True)
    log(f"[families_train] hymba-1.5b at full width, 4 layers, "
        f"{run.model.param_count() / 1e9:.3f}e9 parameters, 1 rank, zero1, "
        f"{m} microbatches, arena on ({segs} segments): losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step wall "
        f"{', '.join(f'{h['sec'] * 1e3:.0f}' for h in hist)} ms; peak "
        f"{peak / 2**30:.2f} GiB; pack writes {counts['pack_write']} == "
        f"{segs} x {m} x {args.steps}, reads {counts['pack_read']} == "
        f"{segs} x {args.steps}, by route {routes}")
    log(f"[families_train] profiled step: wall {prof['step_wall_ms']:.1f} "
        f"ms, device busy {prof['step_device_ms']:.1f} ms, idle share "
        f"{prof['idle_share']:.3f}")
    out = {"losses": losses, "step_s": [h["sec"] for h in hist],
           "launches": counts, "expected": expected, "pack_routes": routes,
           "n_segments": segs, "microbatches": m, "peak_bytes": peak,
           "params": run.model.param_count(), "profile": prof}
    del run, trainer, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


TUNE_DIR = REPO / "build" / "tune_smoke"   # the probe's DB, tuned_train's
TUNE_DB = TUNE_DIR / "tuning.json"          # run directory (gitignored)
TUNE_MATRIX = dict(benches=("allreduce", "arena"),
                   transports=("ring_hier", "psum"), channels=(1, 2),
                   pages=(4096, 2 * 2**20), sizes=(1 << 14, 1 << 18, 1 << 22),
                   mesh=(2,), warmup=1, iters=5)
# one small group each, on sizes of their own (local lattices of 6^3 to
# 16^3 x 16 fp32, mesh 2x1x1): the halo on ring_hier, the solve on psum, one
# rail, recorded under the arch "stencil" (the QCD workload), so that a
# model's resolution ranks the gradient path's records
TUNE_HALO = dict(benches=("halo",), transports=("ring_hier",), channels=(1,),
                 pages=(4096,), sizes=(1 << 12, 1 << 14, 1 << 16), mesh=(2,),
                 warmup=1, iters=5, arch="stencil")
TUNE_CG = dict(TUNE_HALO, benches=("cg",), transports=("psum",), cg_iters=8)
# tuned_train: llama3.2-1b at full width, 4 layers, its own settings (zero1
# at full size, ring_hier, channels 0: the tuner's soft sentinel, which
# --tuned resolves from the probe's DB), the data ring of two ranks
TUNED_TRAIN_ARGS = ["--arch", ARCH, "--layers", "4", "--use-arena", "--seq",
                    "256", "--batch", "8", "--steps", "3", "--device", "cuda",
                    "--seed", "0", "--model-parallel", "1", "--tuned",
                    str(TUNE_DB), "--obs-predict", "--obs-dir",
                    str(TUNE_DIR / "obs")]


def _tune_expected(cell: dict, check: dict, ring_cfg_of) -> dict:
    """The kernels one call of a probe cell launches, from the code: on a
    ring transport every reduced length runs ``p - 1`` reduce-scatter hops,
    each adding every channel slice (``reduce_add``); psum adds nothing;
    the arena packs and unpacks each segment once (``pack``)."""
    from repro_torch.core.ring import _channel_slices

    p = 2
    adds = 0
    if cell["transport"] != "psum":
        ring_cfg = ring_cfg_of(cell)
        adds = sum(len(_channel_slices(n // p, ring_cfg)) * (p - 1)
                   for n in check["reduced"])
    return {"reduce_add": adds, "pack_write": check["segments"],
            "pack_read": check["segments"]}


def _tune_probe_worker(db_path: str) -> dict:
    """One of two ranks of tune_probe: the measured probe on the card
    (``tune.probe.probe_rank``: :data:`TUNE_MATRIX`, then one small halo
    and one small cg group), each cell's wire and launches beside what the
    plan and the code give; rank 0 fits every group, writes the DB, loads
    it again and resolves llama3.2-1b's settings from it."""
    import torch
    import torch.distributed as dist

    from repro_torch.comm import CommConfig
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.settings import ArchSettings, settings_for
    from repro_torch.tune import TuningDB, probe
    from repro_torch.tune.resolve import resolve_settings

    world = launch_train.init_distributed("cuda")

    def ring_cfg_of(cell):
        return CommConfig(transport=cell["transport"], chunks=2,
                          channels=cell["channels"]).ring_config()

    reset_launch_counters()
    t0 = time.perf_counter()
    parts = {name: probe.probe_rank(probe.probe_config(**m), world.device)
             for name, m in (("matrix", TUNE_MATRIX), ("halo", TUNE_HALO),
                             ("cg", TUNE_CG))}
    probe_s = time.perf_counter() - t0
    counts = launch_counters()
    rows = []
    for name, part in parts.items():
        for cell, check in zip(part["cells"], part["checks"]):
            rows.append({"part": name, "cell": cell, "check": check,
                         "expected": _tune_expected(cell, check,
                                                    ring_cfg_of)})
    out = {"backend": world.backend, "rows": rows, "counts": counts,
           "probe_s": probe_s}
    if world.rank == 0:
        db = TuningDB()
        fits = {}
        for part in parts.values():
            cells = [probe.ProbeCell.from_dict(c) for c in part["cells"]]
            fits.update({k: f.as_dict() for k, f in
                         probe.fit_and_store(cells, db).items()})
        db.save(db_path)
        again = TuningDB.load(db_path)
        resolved, info = resolve_settings(settings_for(ARCH), ARCH,
                                          mesh_label="2x1", db=again)
        auto, auto_info = resolve_settings(
            ArchSettings("zero1", 1, "resident", transport="auto",
                         page_bytes="auto"), ARCH, mesh_label="2x1",
            db=again)
        out.update(fits=fits, keys=sorted(again.records),
                   resolved={"info": info, "channels": resolved.channels,
                             "transport": resolved.transport,
                             "page_bytes": resolved.page_bytes},
                   auto={"info": auto_info, "transport": auto.transport,
                         "channels": auto.channels,
                         "page_bytes": auto.page_bytes})
    dist.barrier()        # tuned_train reads the DB on both ranks
    torch.cuda.synchronize(world.device)
    return out


def check_tune_probe(ranks: list) -> dict:
    """tune_probe's checks: every cell's predicted messages and bytes equal
    what its recorded call put on the wire, its launches the code's count;
    the DB loads again with every group and resolution picks one of its
    records."""
    for r, out in enumerate(ranks):
        for row in out["rows"]:
            cell, check = row["cell"], row["check"]
            what = (f"[tune_probe] rank {r} {cell['bench']} "
                    f"{cell['transport']} ch{cell['channels']} "
                    f"p{cell['page_bytes']} {cell['elems']}")
            if (cell["messages"], cell["nbytes"]) != (check["messages"],
                                                      check["nbytes"]):
                raise AssertionError(
                    f"{what}: plan {cell['messages']} messages, "
                    f"{cell['nbytes']} B; recorded {check['messages']}, "
                    f"{check['nbytes']} B")
            if check["launches"] != row["expected"]:
                raise AssertionError(f"{what}: launches {check['launches']}"
                                     f" != {row['expected']}")
            if not cell["seconds"] > 0:
                raise AssertionError(f"{what}: no time")
    o = ranks[0]
    if sorted(o["fits"]) != o["keys"]:
        raise AssertionError(f"[tune_probe] the DB holds {o['keys']}, the "
                             f"fit wrote {sorted(o['fits'])}")
    for res in (o["resolved"], o["auto"]):
        if res["info"]["source"] != "db" or \
                res["info"]["key"] not in o["keys"]:
            raise AssertionError(f"[tune_probe] resolution {res} picked no "
                                 f"record of the DB")
    for key, fit in sorted(o["fits"].items()):
        log(f"[tune_probe] {key}: alpha {fit['alpha_s'] * 1e6:.3f} us, "
            f"bandwidth {fit['bandwidth'] / 1e9:.4f} GB/s, relative error "
            f"mean {fit['mean_rel_err']:.4f} max {fit['max_rel_err']:.4f} "
            f"({fit['n_cells']} cells)")
    log(f"[tune_probe] {len(o['rows'])} cells a rank in "
        f"{o['probe_s']:.1f} s; launches on rank 0 {o['counts']}; "
        f"llama3.2-1b on 2x1 resolves to {o['resolved']}; all-auto "
        f"settings to {o['auto']}")
    return {"ranks": ranks, "fits": o["fits"], "launches": o["counts"]}


class _WireSteps:
    """A TrainStep whose every call also notes what it put on the wire, in
    the prediction's units (``obs.predict.step_wire``)."""

    def __init__(self, step):
        self._step = step
        self.wire: list = []

    def __getattr__(self, name):
        return getattr(self._step, name)

    def __call__(self, state, batch):
        from repro_torch.obs import predict

        before = predict.record_snapshot(self._step)
        out = self._step(state, batch)
        self.wire.append(predict.step_wire(self._step, before))
        return out


def _tuned_train_worker(argv: list[str]) -> dict:
    """One of two ranks of tuned_train: the train CLI's setup with
    ``--tuned`` (the probe's DB) and ``--obs-predict``, 3 steps; the
    ``tuned:`` line, the prediction, the drift samples, each step's wire
    against the predicted wire, the launches."""
    import contextlib
    import io

    import torch

    from repro_torch.launch import train as launch_train

    args = launch_train.parser().parse_args(argv)
    world = launch_train.init_distributed(args.device)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run = launch_train.setup(args, world)
    printed = buf.getvalue()
    print(printed, end="", flush=True)
    _check_full_width(run.model.cfg, args.layers, "tuned_train")
    trainer = run.trainer
    drift = trainer.drift
    wired = _WireSteps(trainer.step_fn)
    trainer.step_fn = wired
    reset_launch_counters()
    out_run = trainer.run()
    counts = launch_counters()
    step = wired._step
    trainer.step_fn = step
    hist = out_run["history"]
    events, gauges = [], []
    if world.rank == 0:
        with open(out_run["obs"]["events"]) as f:
            recs = [json.loads(line) for line in f]
        events = [{"name": r["name"], **r["fields"]} for r in recs
                  if r["kind"] == "event"]
        gauges = [r["value"] for r in recs if r["kind"] == "gauge"
                  and r["name"] == "model_error"]
    import numpy as np

    from repro_torch.launch.roofline import model_flops_estimate

    rows = args.batch // world.size
    return {"backend": world.backend, "printed": printed,
            "tuned": [ln for ln in printed.splitlines()
                      if ln.startswith("tuned: ")],
            "drift_source": drift.source if drift is not None else None,
            "predicted_s": drift.predicted_s if drift is not None else None,
            "events": events, "model_error": gauges,
            "wire": wired.wire, "losses": [h["loss"] for h in hist],
            "step_s": [h["sec"] for h in hist], "counts": counts,
            "transport": step.comm.cfg.transport,
            "channels": step.comm.cfg.channels,
            "page_bytes": step.comm.cfg.page_bytes,
            "model_flops": model_flops_estimate(
                run.model.param_count(), rows * args.seq, "train"),
            "peak_bytes": torch.cuda.max_memory_allocated(world.device),
            "finite": bool(np.isfinite([h["loss"] for h in hist]).all())}


def check_tuned_train(ranks: list, probe_keys: list) -> dict:
    """tuned_train's checks: the ``tuned:`` line names a record of the
    probe's DB; a ``prediction`` event with ``source == "tuned"`` and no
    ``predict_failed``; a drift sample for every step; every step's wire
    (messages and bytes, all records) equal to the prediction's; finite
    losses."""
    o = ranks[0]
    names = [e.get("name") for e in o["events"]]
    if "predict_failed" in names:
        bad = [e for e in o["events"] if e.get("name") == "predict_failed"]
        raise AssertionError(f"[tuned_train] predict_failed: {bad}")
    preds = [e for e in o["events"] if e.get("name") == "prediction"]
    if len(preds) != 1 or preds[0].get("source") != "tuned":
        raise AssertionError(f"[tuned_train] prediction events {preds}")
    pred = preds[0]
    if not any(e.get("name") == "tuned_record" for e in o["events"]):
        raise AssertionError("[tuned_train] no tuned_record event")
    samples = sorted(e["step"] for e in o["events"]
                     if e.get("name") == "drift_sample")
    steps = list(range(len(o["losses"])))
    if samples != steps or len(o["model_error"]) != len(steps):
        raise AssertionError(f"[tuned_train] drift samples at steps "
                             f"{samples} and {len(o['model_error'])} "
                             f"model_error gauges, expected every step")
    if len(o["tuned"]) != 1 or not any(
            o["tuned"][0].startswith(f"tuned: {k} ") for k in probe_keys):
        raise AssertionError(f"[tuned_train] the tuned line {o['tuned']} "
                             f"names no record of the probe's DB")
    for r, out in enumerate(ranks):
        if out["drift_source"] != "tuned" or not out["finite"]:
            raise AssertionError(f"[tuned_train] rank {r}: drift source "
                                 f"{out['drift_source']}, finite losses "
                                 f"{out['finite']}")
    for r, out in enumerate(ranks):
        for s, (m, b) in enumerate(out["wire"]):
            if r == 0 and (m, b) != (pred["messages_per_device"],
                                     pred["wire_bytes_per_device"]):
                raise AssertionError(
                    f"[tuned_train] step {s}: {m} messages, {b} B on the "
                    f"wire; predicted {pred['messages_per_device']}, "
                    f"{pred['wire_bytes_per_device']}")
        if out["wire"] != ranks[0]["wire"]:
            raise AssertionError(f"[tuned_train] rank {r} wire "
                                 f"{out['wire']} != rank 0's")
    measured = sorted(o["step_s"])[len(o["step_s"]) // 2]
    log(f"[tuned_train] {o['tuned'][0]}")
    log(f"[tuned_train] predicted step {pred['t_step_s'] * 1e3:.3f} ms "
        f"({pred['bottleneck']}-bound: compute "
        f"{pred['t_compute_s'] * 1e3:.3f}, memory "
        f"{pred['t_memory_s'] * 1e3:.3f}, collective "
        f"{pred['t_collective_s'] * 1e3:.3f} ms at alpha "
        f"{pred['alpha_s'] * 1e6:.3f} us, bandwidth "
        f"{pred['link_bandwidth'] / 1e9:.4f} GB/s, overlap "
        f"{pred['overlap_fraction']:.3f}) against measured steps "
        f"{', '.join(f'{x * 1e3:.1f}' for x in o['step_s'])} ms (median "
        f"{measured * 1e3:.1f}); {pred['messages_per_device']:.0f} messages,"
        f" {pred['wire_bytes_per_device']:.0f} B a step as predicted; "
        f"FLOPs {pred['flops_per_device']:.4e} counted against 6ND "
        f"{o['model_flops']:.4e}; memory bytes "
        f"{pred['hbm_bytes_per_device']:.4e}; launches {o['counts']}; "
        f"peak {o['peak_bytes'] / 2**30:.2f} GiB; model_error "
        f"{', '.join(f'{x:.3f}' for x in o['model_error'])}")
    return {"ranks": ranks, "prediction": pred, "measured_median_s": measured,
            "launches": o["counts"]}


# the rails (Queue 1 #5): llama3.2-1b's gradient tree at full width and
# RAILS_LAYERS layers (the train_ring phases' depth), fp32, reduced over the
# data ring of two ranks on one rail and on two, where each rail's
# collectives run on a host thread and a CUDA stream of their own
# (repro_torch.comm.rails); the paper's per-tensor baseline beside the
# default GradientReducer, printed only
RAILS_LAYERS = 4
RAILS_BUCKET_BYTES = 32 * 2**20          # the train CLI's buckets
RAILS_TRACE = REPO / "build" / "rails_smoke" / "profile.json"


def _rails_config(channels: int):
    """The train CLI's communicator config for llama3.2-1b over
    ``ring_hier`` at ``channels`` rails."""
    import dataclasses

    from repro_torch.launch.settings import settings_for

    return dataclasses.replace(
        settings_for(ARCH).comm_config(bucket_bytes=RAILS_BUCKET_BYTES),
        transport="ring_hier", channels=channels)


def _synced(fn):
    """``fn()`` and its wall time, the card idle at both ends."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _same_tree(a, b) -> bool:
    import torch

    from repro_torch import tree as tree_util

    la, lb = tree_util.leaves(a), tree_util.leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _rail_hops(comm, sizes, p: int) -> list[int]:
    """``reduce_add`` launches of one all-reduce of flat buffers of
    ``sizes`` on each rail of ``comm``: every buffer's p - 1 reduce-scatter
    hops add each channel slice once."""
    from repro_torch.core.ring import _channel_slices

    per = [0] * max(comm.cfg.channels, 1)
    for a in comm.stripe(list(sizes)):
        per[a.channel] += sum(len(_channel_slices(sizes[b] // p,
                                                  comm.transport.ring_cfg))
                              for b in a.buckets) * (p - 1)
    return per


def _stream_counts(trace: Path) -> dict:
    """From a profiler trace: on which CUDA streams (CUPTI's ids) the
    ``reduce_add`` kernels, the pinned staging copies (device to host and
    back) and the caller's marker kernel (``torch.cuda._sleep``'s
    ``spin_kernel``) ran, with the count on each."""
    with open(trace) as f:
        events = json.load(f)["traceEvents"]
    out: dict = {"reduce_add": {}, "staging": {}, "marker": {}}
    for e in events:
        # a device event's thread is its stream, which its args repeat
        stream = (e.get("args") or {}).get("stream", e.get("tid"))
        cat, name = e.get("cat", ""), e.get("name", "")
        if stream is None:
            continue
        if cat == "kernel" and "reduce_add_kernel" in name:
            key = "reduce_add"
        elif cat == "kernel" and "spin_kernel" in name:
            key = "marker"
        elif cat == "gpu_memcpy" and ("DtoH" in name or "HtoD" in name):
            key = "staging"
        else:
            continue
        out[key][str(stream)] = out[key].get(str(stream), 0) + 1
    return out


def _rails_worker() -> dict:
    """One of two ranks of the rails job: llama3.2-1b's gradient tree (the
    model's fp32 parameter shapes, random from a seed a rank) through
    ``all_reduce_tree`` and one fp32-arena ``reduce_scheduled`` step on one
    rail and on two, each with its wall, record, launches and the count the
    code predicts; one profiled two-rail ``all_reduce_tree`` (rank 0
    traces); the per-tensor baseline and the default ``GradientReducer``,
    each timed and held against a ``Communicator`` of its config."""
    import contextlib
    import gc
    import warnings

    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tree as tree_util
    from repro_torch.comm import Communicator
    from repro_torch.configs import get_config
    from repro_torch.core.reducer import (GradientReducer, ReduceConfig,
                                          per_tensor_reducer)
    from repro_torch.launch import train as launch_train
    from repro_torch.models import build_model
    from repro_torch.runtime.train_step import data_mesh

    world = launch_train.init_distributed("cuda")
    dev, p = world.device, world.size
    cfg = get_config(ARCH).with_(num_layers=RAILS_LAYERS)
    _check_full_width(cfg, RAILS_LAYERS, "rails")
    model = build_model(cfg)
    gen = torch.Generator(device=dev).manual_seed(100 + world.rank)
    grads = tree_util.tree_map(
        lambda t: torch.randn(t.shape, generator=gen, device=dev,
                              dtype=torch.float32), model.abstract_params())
    mesh = data_mesh(p)
    comms = {c: Communicator(mesh, _rails_config(c)) for c in (1, 2)}
    out = {"backend": world.backend, "params": model.param_count()}
    reduced = {}
    for c, comm in comms.items():
        plan = comm.plan(grads)
        sizes = plan.bucket_plan.bucket_sizes
        comm.record.reset()
        reset_launch_counters()
        reduced[c], wall = _synced(lambda: comm.all_reduce_tree(grads)[0])
        out[f"tree_ch{c}"] = {
            "wall_s": wall, "record": comm.record.as_dict(),
            "counts": launch_counters(), "n_buckets": len(sizes),
            "rail_hops": _rail_hops(comm, sizes, p),
            # the plan counts the used elements; the wire carries the
            # buckets' padding too, at the same rate
            "planned": {"sends": plan.messages_per_device,
                        "send_bytes": round(
                            comm.transport.predicted_bytes_per_device(
                                plan.bucket_plan.total_elems,
                                comm.axis_sizes))}}
    out["tree_bitwise"] = _same_tree(reduced[1], reduced[2])
    out["tree_digest"] = params_digest(reduced[2])
    reduced.clear()
    zero = torch.zeros((), device=dev)
    for c, comm in comms.items():
        arena = comm.arena(grads)
        layout = arena.layout
        sched = comm.arena_schedule(grads, "accumulate_then_reduce", 1)
        plan = comm.plan(grads)
        buf = arena.zeros(dev)
        comm.record.reset()
        reset_launch_counters()
        (_, (reduced[c], _)), wall = _synced(lambda: comm.reduce_scheduled(
            lambda params, mb: (zero, grads), grads, {}, sched,
            arena=arena, arena_buf=buf))
        out[f"arena_ch{c}"] = {
            "wall_s": wall, "record": comm.record.as_dict(),
            "counts": launch_counters(), "routes": pack_routes(),
            "n_spans": layout.n_spans, "n_segments": layout.n_segments,
            "rail_hops": _rail_hops(comm, [sp.size for sp in layout.spans],
                                    p),
            "planned": {"sends": plan.arena_messages_per_device,
                        "send_bytes": plan.arena_bytes_per_device}}
        del buf
    out["arena_bitwise"] = _same_tree(reduced[1], reduced[2])
    reduced.clear()
    gc.collect()
    # one two-rail reduce traced (rank 0): marker kernels on the caller's
    # stream before and after it, so that its stream is known in the trace
    # (a trace has been seen to miss the kernel launched first in it)
    traced = world.rank == 0
    ctx = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
           if traced else contextlib.nullcontext())
    torch.cuda.synchronize()
    reset_launch_counters()
    with ctx as prof:
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        comms[2].all_reduce_tree(grads)
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    out["profiled_counts"] = launch_counters()
    if traced:
        RAILS_TRACE.parent.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(RAILS_TRACE))
        out["streams"] = _stream_counts(RAILS_TRACE)
    del comms
    gc.collect()
    # the paper's before/after: one bucket a tensor against the default
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        reducers = {"per_tensor": per_tensor_reducer(mesh, ReduceConfig()),
                    "default": GradientReducer(mesh, ReduceConfig())}
    for name, red in reducers.items():
        own = Communicator(mesh, red.cfg.comm_config())
        red.comm.record.reset()
        got, wall = _synced(lambda: red.reduce(grads)[0])
        want = own.all_reduce_tree(grads)[0]
        out[name] = {"wall_s": wall, "bitwise": _same_tree(got, want),
                     "n_buckets": red.comm.plan(grads).bucket_plan.n_buckets,
                     "sends": red.comm.record.sends}
        del got, want, own
        gc.collect()
    return out


def _check_rail_streams(streams: dict, rail_hops: list[int]) -> dict:
    """The profiled two-rail reduce's streams: ``reduce_add`` on one stream
    a rail, with that rail's launches; the staging copies on the same
    streams; the caller's markers (one or both recorded) on a stream of
    their own."""
    adds, staging, marker = (streams[k] for k in ("reduce_add", "staging",
                                                   "marker"))
    if len(marker) != 1:
        raise AssertionError(f"[rails] the caller's marker kernels on "
                             f"streams {marker}, expected one stream "
                             f"(reduce_add by stream {adds}, staging copies "
                             f"{staging})")
    (caller,) = marker
    if len(adds) < 2 or sorted(adds.values()) != sorted(rail_hops):
        raise AssertionError(f"[rails] reduce_add by stream {adds}, "
                             f"expected one stream a rail with {rail_hops}")
    if caller in adds or caller in staging:
        raise AssertionError(f"[rails] a rail's kernel or copy ran on the "
                             f"caller's stream {caller}: reduce_add "
                             f"{adds}, staging {staging}")
    if set(staging) != set(adds):
        raise AssertionError(f"[rails] staging copies on streams "
                             f"{staging}, the rails' are {sorted(adds)}")
    return {"caller": caller, "reduce_add": adds, "staging": staging}


def check_rails(ranks: list) -> dict:
    """The rails job's checks: on one rail and on two the reduced tree and
    the arena step bitwise, every rank the same tree, sends and bytes
    equal to the plan's, ``reduce_add`` and ``pack`` launches as the code
    predicts (all bulk), and the traced two-rail reduce on one stream a
    rail (:func:`_check_rail_streams`); the per-tensor baseline and the
    default reducer bitwise their communicators.  Logs the walls beside the
    card's name and power limit."""
    gpu = gpu_line()
    for r, o in enumerate(ranks):
        if o["backend"] != "gloo" or not (o["tree_bitwise"]
                                          and o["arena_bitwise"]):
            raise AssertionError(f"[rails] rank {r}: backend {o['backend']},"
                                 f" two rails bitwise one: tree "
                                 f"{o['tree_bitwise']}, arena step "
                                 f"{o['arena_bitwise']}")
        if o["tree_digest"] != ranks[0]["tree_digest"]:
            raise AssertionError(f"[rails] rank {r}'s reduced tree differs "
                                 f"from rank 0's")
        for c in (1, 2):
            for what in ("tree", "arena"):
                run = o[f"{what}_ch{c}"]
                rec, plan = run["record"], run["planned"]
                if (rec["sends"], rec["send_bytes"]) != (
                        plan["sends"], plan["send_bytes"]):
                    raise AssertionError(
                        f"[rails] rank {r} {what} at {c} rail(s): "
                        f"{rec['sends']} sends, {rec['send_bytes']} B; "
                        f"planned {plan}")
                want = dict.fromkeys(launch_counters(), 0)
                want["reduce_add"] = sum(run["rail_hops"])
                if what == "arena":
                    want.update(pack_write=run["n_segments"],
                                pack_read=run["n_segments"])
                    if run["routes"]["vector"]:
                        raise AssertionError(f"[rails] pack by route "
                                             f"{run['routes']}")
                _check_counts(f"rails {what} ch{c} rank {r}", run["counts"],
                              want)
        if o["profiled_counts"]["reduce_add"] != sum(o["tree_ch2"][
                "rail_hops"]):
            raise AssertionError(f"[rails] rank {r}: the profiled reduce "
                                 f"launched {o['profiled_counts']}")
        for name in ("per_tensor", "default"):
            if not o[name]["bitwise"]:
                raise AssertionError(f"[rails] rank {r}: the {name} reducer "
                                     f"differs from its Communicator")
    o = ranks[0]
    streams = _check_rail_streams(o["streams"], o["tree_ch2"]["rail_hops"])
    t1, t2 = o["tree_ch1"], o["tree_ch2"]
    a1, a2 = o["arena_ch1"], o["arena_ch2"]
    base, default = o["per_tensor"], o["default"]
    log(f"[rails] {gpu}: llama3.2-1b's gradient tree ({o['params']} fp32 "
        f"parameters, {RAILS_LAYERS} layers) on 2 ranks over gloo, "
        f"ring_hier, {t1['n_buckets']} buckets of up to "
        f"{RAILS_BUCKET_BYTES} B: all_reduce_tree {t1['wall_s']:.3f} s on "
        f"one rail, {t2['wall_s']:.3f} s on two; the arena step "
        f"({a1['n_spans']} and {a2['n_spans']} spans) {a1['wall_s']:.3f} / "
        f"{a2['wall_s']:.3f} s; bitwise, {t2['record']['sends']} sends and "
        f"{t2['record']['send_bytes']} B as planned; staging "
        f"{t1['record']['staging_s']:.3f} / {t2['record']['staging_s']:.3f} "
        f"s (summed over the rails)")
    log(f"[rails] profiled two-rail reduce: reduce_add by stream "
        f"{streams['reduce_add']}, staging copies by stream "
        f"{streams['staging']}, the caller's stream {streams['caller']}")
    log(f"[rails] {gpu}: the per-tensor baseline ({base['n_buckets']} "
        f"buckets, {base['sends']} sends) {base['wall_s']:.3f} s, the "
        f"default GradientReducer ({default['n_buckets']} buckets, "
        f"{default['sends']} sends) {default['wall_s']:.3f} s: ratio "
        f"{base['wall_s'] / default['wall_s']:.3f}; each bitwise its "
        f"Communicator")
    return {"ranks": ranks, "streams": streams, "gpu": gpu,
            "launches": {k: t2["counts"][k] + a2["counts"][k]
                         for k in t2["counts"]}}


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

    def in_turn(name: str, jobs: list) -> list:
        """The two-rank train phases ``jobs`` ((phase, worker, args)) in
        one spawn; each phase's seconds are rank 0's inside it."""
        results, secs = run_phase(name, spawn_in_turn, name, 2,
                                  [(w, a) for _, w, a in jobs])
        for (phase, _, _), sec in zip(jobs, secs):
            phase_s[phase] = sec
            log(f"[phase] {phase}: {sec:.1f} s (rank 0, inside {name})")
        return results

    run_phase("build", phase_build)
    # first, while this process holds nothing on the card: the two-rank
    # train phases, zero1's and fsdp's (deterministic both) in one spawn,
    # then the replicated and int8 ones in another
    zero1_ranks, fsdp_ranks = in_turn("ring_ranks_deterministic", [
        ("train_ring_zero1", _ring_worker, (ZERO1_RING_ARGS,)),
        ("train_ring_fsdp", _fsdp_ring_worker, (FSDP_RING_ARGS, "ring"))])
    train_ring_zero1 = check_train_ring(zero1_ranks, "train_ring_zero1")
    train_ring_fsdp = check_train_ring_fsdp(
        fsdp_ranks, "train_ring_fsdp", "ring",
        train_ring_zero1["ranks"][0]["losses"])
    ckpt_root, ckpt_layers, ckpt_disk = _ckpt_place(
        "ckpt_ring_smoke", 2, "train_ring_ckpt")
    ckpt_argv = _argv_with(ZERO1_INT8_ARGS, layers=ckpt_layers,
                           steps=CKPT_STEPS)
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    TUNE_DIR.mkdir(parents=True, exist_ok=True)
    ring_ranks, int8_ranks, zero1_int8_ranks, fsdp_int8_ranks, \
        ckpt_ranks, tune_ranks, tuned_ranks, rails_ranks = in_turn(
            "ring_ranks", [
            ("train_ring", _ring_worker, (RING_ARGS,)),
            ("train_ring_int8", _ring_worker, (RING_ARGS + INT8_ARGS,)),
            ("train_ring_zero1_int8", _ring_worker, (ZERO1_INT8_ARGS,)),
            ("train_ring_fsdp_int8", _fsdp_ring_worker, (FSDP_INT8_ARGS,
                                                         "native")),
            ("train_ring_ckpt", _ckpt_ring_worker, (ckpt_argv,
                                                    str(ckpt_root))),
            ("tune_probe", _tune_probe_worker, (str(TUNE_DB),)),
            ("tuned_train", _tuned_train_worker, (TUNED_TRAIN_ARGS,)),
            ("rails", _rails_worker, ())])
    train_ring = check_train_ring(ring_ranks, "train_ring")
    train_ring_int8 = check_train_ring(int8_ranks, "train_ring_int8")
    train_ring_zero1_int8 = check_train_ring(zero1_int8_ranks,
                                             "train_ring_zero1_int8")
    train_ring_fsdp_int8 = check_train_ring_fsdp(
        fsdp_int8_ranks, "train_ring_fsdp_int8", "native")
    train_ring_ckpt = check_ckpt_ranks(ckpt_ranks, "train_ring_ckpt",
                                       ckpt_root, ckpt_layers, ckpt_disk,
                                       int8=True)
    tune_probe = check_tune_probe(tune_ranks)
    tuned_train = check_tuned_train(tuned_ranks, sorted(tune_probe["fits"]))
    rails = check_rails(rails_ranks)
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
    dryrun = run_phase("dryrun", phase_dryrun, dev)
    serve_contiguous = run_phase("serve_contiguous", phase_serve_contiguous,
                                 dev)
    timing_attn = run_phase("timing_attn", phase_timing_attn, dev)
    train, train_layout = run_phase("train", phase_train, dev)
    ring0 = train_ring["ranks"][0]
    timing_train = run_phase("timing_train", phase_timing_train, dev,
                             ring0["hop_widths"], train_layout)
    kernels_int8 = run_phase("kernels_int8", phase_kernels_int8, dev)
    train_int8 = run_phase("train_int8", phase_train_int8, dev,
                           train["losses"])
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
    train_fsdp = run_phase("train_fsdp", phase_train_fsdp, dev,
                           train_zero1["replicated_losses"])
    prefill_gathered = run_phase("prefill_gathered", phase_prefill_gathered,
                                 dev)
    fsdp0 = train_ring_fsdp["ranks"][0]
    timing_fsdp = run_phase("timing_fsdp", phase_timing_fsdp, dev,
                            fsdp0["hop_widths"])
    train_ckpt = run_phase("train_ckpt", phase_train_ckpt, dev)
    torch.cuda.empty_cache()
    moe_serve = run_phase("moe_serve", phase_moe_serve, dev)
    moe_train = run_phase("moe_train", phase_moe_train, dev)
    torch.cuda.empty_cache()
    ssm_serve = run_phase("ssm_serve", phase_ssm_serve, dev)
    hybrid_serve = run_phase("hybrid_serve", phase_hybrid_serve, dev)
    encdec_serve = run_phase("encdec_serve", phase_encdec_serve, dev)
    vlm_prefill = run_phase("vlm_prefill", phase_vlm_prefill, dev)
    families_train = run_phase("families_train", phase_families_train, dev)
    torch.cuda.empty_cache()
    # the halo phase, stencil_cg's two ranks, train_tp, the TP serving
    # phases and moe_ep share one spawn of two ranks
    halo_ranks, cg_ranks, train_tp_ranks, serve_tp_ranks, moe_ep_ranks = \
        in_turn("stencil_tp_ranks", [
            ("halo", _halo_worker, ()),
            ("stencil_cg_ranks", _stencil_cg_worker, ()),
            ("train_tp", _tp_train_worker, (TP_TRAIN_ARGS,)),
            ("serve_tp_ranks", _tp_serve_worker, ()),
            ("moe_ep", _moe_ep_worker, (MOE_EP_ARGS,))])
    moe_ep = check_moe_ep(moe_ep_ranks)
    halo = check_halo(halo_ranks)
    stencil = run_phase("stencil", phase_stencil, dev)
    stencil_cg = run_phase("stencil_cg", phase_stencil_cg, dev, cg_ranks)
    torch.cuda.empty_cache()
    train_tp = check_train_tp(train_tp_ranks)
    serve_tp = check_serve_tp(serve_tp_ranks)
    for name, sec in serve_tp["seconds"].items():
        phase_s[name] = sec
        log(f"[phase] {name}: {sec:.1f} s (rank 0, inside "
            f"stencil_tp_ranks)")
    torch.cuda.empty_cache()
    train_tp_fsdp = run_phase("train_tp_fsdp", phase_train_tp_fsdp)
    for name, sec in train_tp_fsdp["seconds"].items():
        phase_s[f"train_tp_fsdp.{name}"] = sec
    tp0, stp0 = train_tp["ranks"][0], serve_tp["ranks"][0]
    tf0 = train_tp_fsdp["ranks"][0]
    # each kernel's launches a rank on the tensor-parallel paths: 3 steps of
    # train_tp in each mode, one prefill_tp, the whole serve_tp trace
    tp_launches = {name: {
        "train_tp_replicated": tp0["replicated"]["counts"][name],
        "train_tp_zero1": tp0["zero1"]["counts"][name],
        "prefill_tp": stp0["prefill_tp"]["counts"][name],
        "serve_contiguous_tp": stp0["serve_contiguous_tp"]["counts"][name],
        "serve_tp": stp0["serve_tp"]["counts"][name],
        "train_tp_fsdp": tf0["fsdp"]["counts"][name],
        "train_tp_fsdp_ring_step": tf0["fsdp"]["ring"]["counts"][name],
        "prefill_gathered_tp": tf0["prefill"]["counts"][name]}
        for name in launch_counters()}
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
    errs["reduce_add"] = max(errs["reduce_add"],
                             stencil_cg["reduce_add_max_abs_err"])
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
            "launches_per_step"][name],
        "train_tp_fsdp_ckpt": train_tp_fsdp["ckpt"]["ranks"][0][
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
            # and the CG family's inner products on the ring (stencil_cg:
            # rank 0's launches over the six two-rank ring_hier solves)
            rows[-1]["launches_stencil_cg"] = stencil_cg[
                "reduce_add_launches"]
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
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:102",
        "launches": prefill["launches"],
        "launches_fsdp": fsdp_launches["flash_attn"],
        "launches_ckpt": ckpt_launches["flash_attn"],
        "max_abs_err": max(*kernels_attn["max_abs_err"].values(),
                           timing_attn["max_abs_err"]),
        **{k: timing_attn[k] for k in ("ms", "plain_ms", "bound_ms",
                                       "bound_by", "library_ms")}})
    # and on the MoE paths (mixtral-8x7b): the timed S=8192 prefill
    # (moe_serve; its decode loop launches nothing), 3 fsdp steps on one
    # rank (moe_train) and 3 EP steps a rank (moe_ep)
    ep0 = moe_ep["ranks"][0]
    for row in rows:
        row["launches_tp"] = tp_launches[row["name"]]
        name = row["name"]
        row["launches_moe"] = {
            "moe_serve": moe_serve["launches"] if name == "flash_attn" else 0,
            "moe_train": moe_train["launches"][name],
            "moe_ep": ep0["counts"][name]}
        # and on the remaining families' paths: the timed prefills (hymba,
        # llava), the encoder of whisper's decode state (its decode loop,
        # like falcon-mamba's whole path, launches nothing) and 3 zero1
        # steps of hymba
        attn = name == "flash_attn"
        row["launches_families"] = {
            "ssm_serve": 0,
            "hybrid_serve": hybrid_serve["launches"] if attn else 0,
            "encdec_serve": encdec_serve["launches"] if attn else 0,
            "vlm_prefill": vlm_prefill["launches"] if attn else 0,
            "families_train": families_train["launches"][name]}
        # and on the tooling's paths (rank 0): the measured probe's cells
        # (reduce_add on every ring_hier hop, pack in the arena cells) and
        # the 3 steps of tuned_train
        if name in ("reduce_add", "pack_write", "pack_read"):
            row["launches_tune"] = {
                "tune_probe": tune_probe["launches"][name],
                "tuned_train": tuned_train["launches"][name]}
            # and on the rails' path (rank 0): the two-rail all_reduce_tree
            # and arena step, each rail's on its own stream
            row["launches_rails"] = rails["launches"][name]
    # flash_attn's fp32 route (the TF32 mma kernel) on its path, the ten
    # fp32 check prefills at S=4096, timed at one of their layers' shape
    rows.append({
        "name": "flash_attn_fp32", "route": "cuda",
        "source": f"{src}/flash_attn/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:102",
        "launches": prefill["check_launches_mma"],
        "max_abs_err": max(kernels_attn["max_abs_err"]["float32"],
                           timing_attn["mma_fp32_4096_max_abs_err"]),
        "ms": timing_attn["mma_fp32_4096_ms"],
        "plain_ms": timing_attn["plain_fp32_4096_ms"],
        "bound_ms": timing_attn["mma_fp32_4096_bound_ms"],
        "bound_by": "operations",
        "library_ms": timing_attn["library_fp32_4096_ms"]})
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
             "dryrun": dryrun,
             "serve_contiguous": serve_contiguous, "timing_attn": timing_attn,
             "train_zero1": train_zero1, "train_ring_zero1": train_ring_zero1,
             "train_ring_zero1_int8": train_ring_zero1_int8,
             "train_fsdp": train_fsdp, "train_ring_fsdp": train_ring_fsdp,
             "train_ring_fsdp_int8": train_ring_fsdp_int8,
             "prefill_gathered": prefill_gathered,
             "timing_fsdp": timing_fsdp, "train_ckpt": train_ckpt,
             "train_ring_ckpt": train_ring_ckpt, "halo": halo,
             "stencil": stencil, "stencil_cg": stencil_cg,
             "train_tp": train_tp, "serve_tp": serve_tp,
             "train_tp_fsdp": train_tp_fsdp, "moe_serve": moe_serve,
             "moe_train": moe_train, "moe_ep": moe_ep,
             "ssm_serve": ssm_serve, "hybrid_serve": hybrid_serve,
             "encdec_serve": encdec_serve, "vlm_prefill": vlm_prefill,
             "families_train": families_train, "tune_probe": tune_probe,
             "tuned_train": tuned_train, "rails": rails,
             "phase_s": phase_s,
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
