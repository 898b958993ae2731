"""Dry-run of the port at the production meshes (port of
``repro.launch.dryrun``'s ``train``, ``mem`` and ``serve`` suites).

The reference AOT-lowers each cell for 256 or 512 fake host devices and
reads XLA's memory analysis, cost analysis and the collectives of the HLO.
The port traces one rank instead (rank 0, :data:`TRACED_RANK`) of
``make_production_mesh(multi_pod=...)``:

* over PyTorch's ``"fake"`` c10d backend at world size 256 or 512, so the
  mesh's process groups are made through ``new_group`` as on the card and
  every collective returns at once;
* under ``FakeTensorMode``: every parameter, state tensor and batch is a
  fake tensor with a shape, a dtype and strides and no data, on device
  ``"cuda"`` (:func:`trace_device`; a PyTorch built without CUDA cannot
  index or differentiate a fake CUDA tensor, so there the trace runs on
  the ``"meta"`` device through the same code).  The kernel wrappers take
  their fake routes (:mod:`repro_torch.fake`): nothing is launched or
  built.

So ``python -m repro_torch.launch.dryrun`` needs no card and allocates
nothing.  Per cell it records:

* ``memory``: the bytes of the train (or serving) state and of the batch,
  ``peak_gb``, the most bytes of storage alive at once during the step
  (:class:`LiveBytes`; the counterpart of XLA's argument + temp - alias),
  and ``fits`` against the card's memory (:func:`card_memory`);
* ``roofline``: FLOPs from ``FlopCounterMode`` plus each hand-written
  kernel's own count (``flash_attn``'s ``attention_flops``,
  ``flash_decode``'s ``decode_flops``), memory bytes from
  :class:`~repro_torch.obs.predict.ByteCounter` plus each kernel's reads
  and writes, the wire from the step's recorded collectives
  (:func:`~repro_torch.comm.plan.record_wire`);
* ``collectives``: counts and bytes by op, from the
  :class:`~repro_torch.core.p2p.CommRecord` of the calls made on the fake
  group (the reference parses them from the HLO);
* ``kernels``: the fake routes' calls by kernel and route;
* ``params``, ``active_params``, ``comm_plan``, ``schedule`` and, with
  ``--tuned``, the measured pricing, as the reference's.

``--suite mem`` and ``--suite serve`` hold the arena's and the paged KV
arena's predictions to the recorded program at zero tolerance.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --mesh both
    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite mem
    PYTHONPATH=src python -m repro_torch.launch.dryrun --suite serve \\
        --arch llama3.2-1b
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import threading
import time
import traceback
import weakref
from dataclasses import replace

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import fake
from repro_torch import tree as tree_util
from repro_torch.comm.plan import record_wire
from repro_torch.comm.schedule import SCHEDULE_POLICIES
from repro_torch.configs import (SHAPES, applicable_shapes, get_config,
                                 list_archs)
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.p2p import CommRecord
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import Roofline, model_flops_estimate
from repro_torch.launch.settings import settings_for
from repro_torch.models import build_model
from repro_torch.obs.predict import ByteCounter, step_records
from repro_torch.refusal import Refusal
from repro_torch.runtime.train_step import (TrainStep, TrainStepConfig,
                                            init_train_state)
from repro_torch.tune.db import overrides_fingerprint

# The card the port plans for: NVIDIA H100 80GB HBM3 at a 700.00 W power
# limit, whose torch.cuda.get_device_properties(0).total_memory a chip run
# printed as 85017493504 bytes.  Read from the card where there is one.
CARD_NAME = "NVIDIA H100 80GB HBM3"
CARD_MEMORY = 85017493504
TRACED_RANK = 0
MESH_LABELS = {False: "16x16", True: "2x16x16"}
# the "fake" backend for every device type a traced tensor may have
FAKE_BACKEND = "cpu:fake,cuda:fake,meta:fake"


# ---------------------------------------------------------------------------
# the tracing environment
# ---------------------------------------------------------------------------


def trace_device() -> torch.device:
    """``cuda`` on a PyTorch built with CUDA (a card or none), else
    ``meta``: a build without CUDA has no CUDA device guard, so indexing a
    fake CUDA tensor raises there, and no accelerator, so autograd over one
    raises too."""
    return torch.device("cuda" if torch.backends.cuda.is_built() else "meta")


def card_memory() -> int:
    """The card's memory in bytes: read from the card where there is one,
    else :data:`CARD_MEMORY`."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_properties(0).total_memory
    return CARD_MEMORY


@contextlib.contextmanager
def fake_world(world: int, rank: int = TRACED_RANK):
    """This process as rank ``rank`` of ``world`` over the ``"fake"`` c10d
    backend (no process group at ``world == 1``)."""
    if world > 1:
        import torch.testing._internal.distributed.fake_pg  # noqa: F401
        from torch.testing._internal.distributed.fake_pg import FakeStore

        if dist.is_initialized():
            raise RuntimeError("the dry-run needs a process with no process "
                               "group")
        dist.init_process_group(FAKE_BACKEND, store=FakeStore(), rank=rank,
                                world_size=world)
    try:
        yield
    finally:
        if world > 1:
            dist.destroy_process_group()


def fake_mode():
    """The dry-run's ``FakeTensorMode``: real constants made inside it
    (host-side plans) are taken as they are."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    return FakeTensorMode(allow_non_fake_inputs=True)


class LiveBytes(TorchDispatchMode):
    """The bytes of storage alive at once: every op's output storage is
    counted when it first appears and released when it is freed (a weak
    finalizer on the storage), a view's storage once.  :meth:`track` adds
    what was alive before the mode (the state, the batch).  :attr:`peak` is
    the most bytes alive at any point; :attr:`max_storages` the most
    storages alive at once and :attr:`max_large` the most of more than
    :data:`SMALL_ALLOC` bytes, which bound what the card's caching
    allocator adds to them (:func:`allocator_slack`)."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.max_storages = 0
        self.max_large = 0
        self._seen: set = set()
        self._large = 0
        self._lock = threading.Lock()

    def _release(self, key, nbytes: int) -> None:
        with self._lock:
            self._seen.discard(key)
            self.live -= nbytes
            self._large -= nbytes > SMALL_ALLOC

    def _add(self, t: torch.Tensor) -> None:
        storage = t.untyped_storage()
        key = storage._cdata
        with self._lock:
            if key in self._seen:
                return
            self._seen.add(key)
            nbytes = storage.nbytes()
            self.live += nbytes
            self._large += nbytes > SMALL_ALLOC
            self.peak = max(self.peak, self.live)
            self.max_storages = max(self.max_storages, len(self._seen))
            self.max_large = max(self.max_large, self._large)
        weakref.finalize(storage, self._release, key, nbytes)

    def track(self, tree) -> None:
        for t in tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                self._add(t)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.track(out)
        return out


# PyTorch's CUDA caching allocator rounds every block up to 512 bytes and
# hands out a block of the large pool (requests above 1 MiB) without
# splitting off a remainder of up to 1 MiB
ALLOC_ROUND = 512
SMALL_ALLOC = 2**20


def allocator_slack(max_storages: int, max_large: int) -> int:
    """The most bytes the card's caching allocator can count beyond the
    storages' own: ``ALLOC_ROUND - 1`` for each storage alive at once, and
    ``SMALL_ALLOC`` more for each large one."""
    return (ALLOC_ROUND - 1) * max_storages + SMALL_ALLOC * max_large


def storage_bytes(tree) -> int:
    """Bytes of the distinct storages under ``tree``."""
    seen = {}
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            s = t.untyped_storage()
            seen[s._cdata] = s.nbytes()
    return sum(seen.values())


def _fake_like(abstract, device):
    return tree_util.tree_map(
        lambda a: torch.empty(a.shape, dtype=a.dtype, device=device),
        abstract)


def _collectives(records) -> tuple[dict, float, float]:
    """``(collectives, messages, wire_bytes)`` of ``(record, axis size)``
    pairs: counts and bytes by op under the reference's HLO op names, and
    the wire in the plans' units."""
    counts, nbytes = {}, {}
    messages = wire = 0.0
    names = {"sends": ("collective-permute", "send_bytes"),
             "all_reduces": ("all-reduce", "all_reduce_bytes"),
             "all_gathers": ("all-gather", "all_gather_bytes"),
             "reduce_scatters": ("reduce-scatter", "reduce_scatter_bytes"),
             "all_to_alls": ("all-to-all", "all_to_all_bytes")}
    for rec, size in records:
        d = rec.as_dict()
        for field, (op, bfield) in names.items():
            if d[field]:
                counts[op] = counts.get(op, 0) + d[field]
                nbytes[op] = nbytes.get(op, 0) + d[bfield]
        m, w = record_wire(d, size)
        messages += m
        wire += w
    return {"counts": counts, "bytes": nbytes}, messages, wire


class _Counters:
    """FLOPs, bytes and live storage of one traced call, with the fake
    routes' tallies."""

    def __init__(self, alive_before):
        self.flops = FlopCounterMode(display=False)
        self.bytes = ByteCounter()
        self.live = LiveBytes()
        self.live.track(alive_before)

    def __enter__(self):
        fake.reset_fake_counts()
        self.flops.__enter__()
        self.bytes.__enter__()
        self.live.__enter__()
        return self

    def __exit__(self, *exc):
        self.live.__exit__(*exc)
        self.bytes.__exit__(*exc)
        self.flops.__exit__(*exc)
        return False

    def summary(self) -> dict:
        return {"flops": float(self.flops.get_total_flops())
                + sum(fake.FAKE_FLOPS.values()),
                "hbm_bytes": float(self.bytes.bytes)
                + sum(fake.FAKE_BYTES.values()),
                "peak_bytes": self.live.peak,
                "max_storages": self.live.max_storages,
                "max_large": self.live.max_large,
                "kernels": {name: n for name, n in
                            sorted(fake.FAKE_CALLS.items())},
                "routes": {f"{name}/{route}": n for (name, route), n in
                           sorted(fake.FAKE_ROUTES.items())}}


# ---------------------------------------------------------------------------
# cell identity and configs (the reference's)
# ---------------------------------------------------------------------------


def cell_key(tag: str, arch: str, shape: str, mesh_label: str,
             overrides: dict | None = None) -> str:
    """Cache key of one dry-run cell in the output JSON."""
    base = f"{tag}|{arch}|{shape}|{mesh_label}"
    fp = overrides_fingerprint(overrides)
    return f"{base}|ov[{fp}]" if fp else base


def make_step_config(arch: str, overrides: dict | None = None
                     ) -> TrainStepConfig:
    """Per-arch step config with override plumbing: ``comm_<field>`` keys
    set :class:`~repro_torch.comm.CommConfig` fields, every other key a
    :class:`TrainStepConfig` field; the legacy ``accum_microbatches`` /
    ``accum_policy`` spellings map onto ``microbatches`` / ``schedule``
    (the new key wins); ``reduce_*`` keys are refused, as in the
    reference."""
    st = settings_for(arch)
    ccfg = st.comm_config()
    kw = dict(dp_mode=st.dp_mode, microbatches=st.microbatches,
              schedule="accumulate_then_reduce", causal_skip=False,
              moe_transport=st.moe_transport, moe_channels=st.moe_channels)
    if overrides:
        stale = [k for k in overrides if k.startswith("reduce_")]
        if stale:
            raise ValueError(
                f"reduce_* overrides were removed with the string-policy "
                f"shim; use comm_<field> (e.g. comm_transport, "
                f"comm_wire_dtype) — got {stale}")
        comm_over = {k[5:]: v for k, v in overrides.items()
                     if k.startswith("comm_")}
        rest = {k: v for k, v in overrides.items()
                if not k.startswith("comm_")}
        rest.setdefault("microbatches", rest.pop("accum_microbatches", None))
        rest.setdefault("schedule", rest.pop("accum_policy", None))
        rest = {k: v for k, v in rest.items() if v is not None}
        if comm_over:
            ccfg = replace(ccfg, **comm_over)
        kw.update(rest)
    return TrainStepConfig(comm=ccfg, **kw)


def comm_plan_summary(step: TrainStep) -> dict:
    """The gradient reduction's plan the step executes, as JSON: the
    :class:`~repro_torch.comm.plan.CommPlan`'s ``describe()``, or under
    fsdp the sums over its groups' plans (the reference's
    ``comm_plan_summary``)."""
    if step.fsdp is not None:
        fplan = step.fsdp
        plans = [fplan.comm.plan(tree) for tree in fplan.groups.values()]
        head = plans[0].describe()
        return {
            "transport": head["transport"],
            "axes": head["axes"], "axis_sizes": head["axis_sizes"],
            "world": head["world"],
            "n_groups": len(plans),
            "n_buckets": sum(p.n_buckets for p in plans),
            "total_elems": sum(p.total_elems for p in plans),
            "n_channels": head["n_channels"],
            "bytes_per_device": sum(p.bytes_per_device for p in plans),
            "grad_bytes": sum(
                p.predicted_collective_bytes()["grad_bytes"] for p in plans),
            "channel_imbalance": max(p.channel_imbalance for p in plans),
        }
    return step.plan.describe()


def _tuned_pricing(db, *, arch: str, mesh_label: str, transport: str,
                   channels: int | None = None,
                   page_bytes: int | None = None) -> dict | None:
    """Measured pricing for one cell from a tuning DB (``None`` when no
    record matches the cell's transport)."""
    from repro_torch.comm.plan import LatencyModel
    from repro_torch.tune.db import model_error_summary

    hit = db.lookup(transport=transport, arch=arch, mesh=mesh_label,
                    channels=channels, page_bytes=page_bytes)
    if hit is None:
        return None
    key, rec = hit
    model = LatencyModel.from_record(rec)
    return {"model": model, "key": key,
            "alpha_s": model.alpha_s, "bandwidth": model.bandwidth,
            "model_error": model_error_summary(rec)}


def batch_shapes(cfg, shape: ShapeConfig, rows: int) -> dict:
    """``{name: (shape, dtype)}`` of ``rows`` rows of a train or prefill
    batch: the reference's ``Model.input_specs``."""
    text = shape.seq_len
    out = {}
    if cfg.family == "encdec" or cfg.frontend == "audio_stub":
        out["frames"] = ((rows, cfg.enc_seq, cfg.d_model), torch.bfloat16)
    if cfg.frontend == "vision_stub" and cfg.frontend_seq:
        text -= cfg.frontend_seq
        out["extra_embeds"] = ((rows, cfg.frontend_seq, cfg.d_model),
                               torch.bfloat16)
    out["tokens"] = ((rows, text), torch.int32)
    if shape.kind == "train":
        out["labels"] = ((rows, text), torch.int32)
    return out


def _fake_batch(cfg, shape, rows, device) -> dict:
    return {k: torch.zeros(s, dtype=dt, device=device)
            for k, (s, dt) in batch_shapes(cfg, shape, rows).items()}


# ---------------------------------------------------------------------------
# the train suite
# ---------------------------------------------------------------------------


def _memory(state_bytes: int, batch_bytes: int, peak: int) -> dict:
    cap = card_memory()
    return {"state_gb": state_bytes / 2**30, "batch_gb": batch_bytes / 2**30,
            "peak_gb": peak / 2**30, "card_gb": cap / 2**30,
            "fits": bool(peak <= cap)}


def _roofline(counts: dict, wire: float, messages: float, model_flops: float,
              overlap: float, n_dev: int, latency=None) -> dict:
    kw = dict(flops_per_device=counts["flops"],
              hbm_bytes_per_device=counts["hbm_bytes"],
              wire_bytes_per_device=wire, model_flops=model_flops,
              overlap_fraction=overlap, messages_per_device=messages)
    roof = (Roofline.from_latency(latency, **kw) if latency is not None
            else Roofline(**kw))
    return roof.as_dict(n_dev)


def trace_train_step(model, mesh, tcfg: TrainStepConfig, shape: ShapeConfig,
                     device) -> dict:
    """One train step of this rank of ``mesh`` under the fake mode: the
    step, its counters and its records."""
    step = TrainStep(model, mesh, tcfg, device=device)
    params = _fake_like(model.abstract_params(), device)
    state = init_train_state(model, step, params=params)
    del params
    rows = max(shape.global_batch // step.comm.world, 1)
    batch = _fake_batch(model.cfg, shape, rows, device)
    state_bytes, batch_bytes = storage_bytes(state), storage_bytes(batch)
    with _Counters((state, batch)) as c:
        state, _ = step(state, batch)
    return {"step": step, "counts": c.summary(),
            "records": step_records(step),
            "state_bytes": state_bytes, "batch_bytes": batch_bytes}


def trace_serve(model, shape: ShapeConfig, mesh, weight_mode: str,
                device) -> dict:
    """One prefill or decode step (``shape.kind``) of this rank of ``mesh``
    under the fake mode, on the port's serving entry points."""
    from repro_torch.runtime.serve_step import (build_decode_step,
                                                build_prefill,
                                                init_decode_state,
                                                serve_params)

    if shape.kind == "prefill":
        fn = build_prefill(model, shape, weight_mode=weight_mode,
                           device=device, mesh=mesh)
    else:
        fn = build_decode_step(model, shape, weight_mode=weight_mode,
                               device=device, mesh=mesh)
    full = _fake_like(model.abstract_params(), device)
    params = serve_params(fn, model, full, mesh)
    if fn.fsdp is None:
        # this rank's blocks own their storage, as a launcher's copy does
        params = tree_util.tree_map(lambda t: t.clone(), params)
    del full
    if shape.kind == "prefill":
        inputs = _fake_batch(model.cfg, shape, shape.global_batch, device)
        alive = (params, inputs)
        state_bytes = storage_bytes(params)
    else:
        frames = None
        if model.is_encdec:
            frames = torch.zeros((shape.global_batch, model.cfg.enc_seq,
                                  model.cfg.d_model), dtype=torch.bfloat16,
                                 device=device)
        dstate = init_decode_state(model, shape, mesh, params=params,
                                   frames=frames, ctx=fn.ctx, device=device)
        del frames
        token = torch.zeros((shape.global_batch,), dtype=torch.int32,
                            device=device)
        inputs = {"token": token}
        alive = (params, dstate, inputs)
        state_bytes = storage_bytes((params, dstate))
    batch_bytes = storage_bytes(inputs)
    with _Counters(alive) as c:
        if shape.kind == "prefill":
            fn(params, inputs)
        else:
            fn(params, inputs["token"], dstate, shape.seq_len - 1)
    recs = []
    if fn.ctx.model is not None:
        recs.append((fn.ctx.model.record, fn.ctx.model.size))
    if fn.fsdp is not None:
        recs.append((fn.fsdp.comm.record, fn.fsdp.comm.world))
    return {"fn": fn, "counts": c.summary(), "records": recs,
            "state_bytes": state_bytes, "batch_bytes": batch_bytes}


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             overrides: dict | None = None, tuned_db=None) -> dict:
    """One (arch, shape, mesh) cell: this rank of the production mesh
    traced on fake tensors over the fake process group."""
    t0 = time.time()
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_dev = mesh.size
    mesh_label = MESH_LABELS[multi_pod]
    st = settings_for(arch)
    device = trace_device()
    out: dict = {}
    with fake_world(n_dev), fake_mode():
        model = build_model(cfg)
        if shape.kind == "train":
            tcfg = make_step_config(arch, overrides)
            got = trace_train_step(model, mesh, tcfg, shape, device)
            step = got["step"]
            overlap = step.schedule.overlap_fraction
            out["comm_plan"] = comm_plan_summary(step)
            out["schedule"] = step.schedule.describe()
            transport, channels = tcfg.comm.transport, tcfg.comm.channels
        else:
            wm = (overrides or {}).get("serve_weights", st.serve_weights)
            got = trace_serve(model, shape, mesh, wm, device)
            overlap = 0.0
            transport, channels = st.transport, st.channels
        collectives, messages, wire = _collectives(got["records"])
    pricing = None
    if tuned_db is not None:
        pricing = _tuned_pricing(tuned_db, arch=arch, mesh_label=mesh_label,
                                 transport=transport, channels=channels)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                   else 1)
    n_active = model.active_param_count()
    counts = got["counts"]
    out.update({
        "trace_s": time.time() - t0,
        "memory": _memory(got["state_bytes"], got["batch_bytes"],
                          counts["peak_bytes"]),
        "roofline": _roofline(counts, wire, messages,
                              model_flops_estimate(n_active, tokens,
                                                   shape.kind),
                              overlap, n_dev,
                              pricing["model"] if pricing else None),
        "collectives": collectives,
        "kernels": counts["kernels"], "kernel_routes": counts["routes"],
        "params": model.param_count(), "active_params": n_active,
        "arch": arch, "shape": shape_name, "mesh": mesh_label,
        "devices": n_dev, "rank": TRACED_RANK, "device": str(device),
    })
    if pricing:
        out["tuned"] = {"key": pricing["key"], "alpha_s": pricing["alpha_s"],
                        "bandwidth": pricing["bandwidth"]}
        out["model_error"] = pricing["model_error"]
    return out


# ---------------------------------------------------------------------------
# the mem suite: the arena's predictions at zero tolerance
# ---------------------------------------------------------------------------

MEM_DEFAULT_ARCHS = ["whisper-base", "llama3.2-1b"]


def run_mem_cell(arch: str, page_bytes: int, bucket_mb: float, *,
                 channels: int = 2, transport: str = "psum",
                 tuned_db=None) -> dict:
    """One ``--suite mem`` cell: pack -> reduce -> unpack over the arch's
    (reduced) gradient tree with the arena, on rank 0 of a (4, 1) mesh, and
    the per-bucket baseline, holding the :mod:`repro_torch.mem` prediction
    layer to the recorded program with zero tolerance:

    * bytes/pages: the arena tensor is exactly ``ArenaLayout.total_elems``
      fp32 elements, and its pages are its bytes over ``page_bytes``;
    * counts: the arena path issues exactly ``n_spans`` all-reduces, the
      baseline exactly ``n_buckets``, strictly more whenever fusing merges
      anything;
    * wire bytes: the recorded all-reduces carry exactly
      ``CommPlan.arena_bytes_per_device``.
    """
    from repro_torch.comm import CommConfig, Communicator
    from repro_torch.configs import reduced_config
    from repro_torch.core.topology import RankMesh

    t0 = time.time()
    n_dev = 4
    mesh = RankMesh(("data", "model"), (n_dev, 1))
    device = trace_device()
    with fake_world(n_dev), fake_mode():
        model = build_model(reduced_config(arch))
        comm = Communicator(mesh, CommConfig(
            transport=transport, channels=channels, data_axes=("data",),
            bucket_bytes=int(bucket_mb * 2**20), page_bytes=int(page_bytes)))
        local = model.abstract_params()
        cplan = comm.plan(local)
        layout = cplan.arena_layout
        arena = comm.arena(local)
        sched_bucket = comm.schedule(local, "scheduled", 1)
        sched_arena = comm.arena_schedule(local, "scheduled", 1)
        grads = _fake_like(local, device)
        batch = {"x": torch.zeros((1,), device=device)}
        buf = arena.zeros(device)

        def grad_like(p, mb):
            return torch.zeros((), device=device), p

        comm.record.reset()
        fake.reset_fake_counts()
        comm.reduce_scheduled(grad_like, grads, batch, sched_arena,
                              op="all_reduce", arena=arena, arena_buf=buf)
        rec_arena = comm.record.as_dict()
        kernels = dict(fake.FAKE_CALLS)
        comm.record.reset()
        comm.reduce_scheduled(grad_like, grads, batch, sched_bucket,
                              op="all_reduce")
        rec_bucket = comm.record.as_dict()
        arena_bytes = buf.numel() * buf.element_size()
    n_ar_arena, n_ar_bucket = rec_arena["all_reduces"], rec_bucket[
        "all_reduces"]
    _, measured = record_wire(rec_arena, n_dev)
    predicted = cplan.arena_bytes_per_device

    # --- the zero-tolerance prediction checks -----------------------------
    if buf.numel() != layout.total_elems or arena_bytes != layout.total_bytes:
        raise AssertionError(
            f"arena tensor is {buf.numel()} elements ({arena_bytes} B), "
            f"predicted {layout.total_elems} ({layout.total_bytes} B)")
    if arena_bytes // int(page_bytes) != layout.n_pages \
            or arena_bytes % int(page_bytes):
        raise AssertionError(
            f"arena of {arena_bytes} B is not {layout.n_pages} pages of "
            f"{page_bytes} B")
    if n_ar_arena != layout.n_spans:
        raise AssertionError(f"arena path issued {n_ar_arena} all-reduces, "
                             f"predicted {layout.n_spans} fused spans")
    if n_ar_bucket != cplan.n_buckets:
        raise AssertionError(f"bucket baseline issued {n_ar_bucket} "
                             f"all-reduces, predicted {cplan.n_buckets}")
    if layout.n_spans < cplan.n_buckets and not n_ar_arena < n_ar_bucket:
        raise AssertionError(f"fused spans did not reduce the collective "
                             f"count: {n_ar_arena} vs {n_ar_bucket}")
    if measured != predicted:
        raise AssertionError(f"arena wire bytes: predicted {predicted}, "
                             f"recorded {measured}")

    pricing = None
    if tuned_db is not None:
        pricing = _tuned_pricing(tuned_db, arch=arch, mesh_label="4x1",
                                 transport=transport, channels=channels,
                                 page_bytes=int(page_bytes))
    padding_wire = predicted * layout.padding_fraction
    roof_kw = dict(flops_per_device=0.0, hbm_bytes_per_device=0.0,
                   wire_bytes_per_device=predicted - padding_wire,
                   padding_wire_bytes_per_device=padding_wire,
                   messages_per_device=cplan.arena_messages_per_device,
                   overlap_fraction=sched_arena.overlap_fraction)
    roof = (Roofline.from_latency(pricing["model"], **roof_kw)
            if pricing else Roofline(**roof_kw))
    tuned_extra = ({"tuned": {"key": pricing["key"],
                              "alpha_s": pricing["alpha_s"],
                              "bandwidth": pricing["bandwidth"]},
                    "model_error": pricing["model_error"]}
                   if pricing else {})
    return tuned_extra | {
        "arch": arch, "suite": "mem", "page_bytes": int(page_bytes),
        "bucket_mb": bucket_mb, "channels": channels,
        "transport": transport, "mesh": "4x1", "devices": n_dev,
        "trace_s": time.time() - t0,
        "predicted_arena_bytes": layout.total_bytes,
        "predicted_arena_pages": layout.n_pages,
        "arena_elems": buf.numel(),
        "arena_bytes_match": buf.numel() == layout.total_elems,
        "padding_fraction": layout.padding_fraction,
        "segment_waste": [s.waste for s in layout.segments],
        "n_buckets": cplan.n_buckets, "n_spans": layout.n_spans,
        "recorded_allreduce_arena": n_ar_arena,
        "recorded_allreduce_bucket": n_ar_bucket,
        "predicted_wire_bytes": predicted,
        "recorded_wire_bytes": measured,
        "padding_wire_bytes": padding_wire,
        "kernels": kernels,
        "roofline": roof.as_dict(n_dev),
        "arena": layout.describe() | {"segments": None, "spans": None},
        "comm_plan": cplan.describe() | {"arena": None, "channels": None},
    }


# ---------------------------------------------------------------------------
# the serve suite: the paged KV arena's predictions at zero tolerance
# ---------------------------------------------------------------------------

SERVE_DEFAULT_ARCHS = ["llama3.2-1b", "qwen2-7b"]


def run_serve_cell(arch: str, page_tokens: int, model_parallel: int, *,
                   page_bytes: int = 4096, max_seqs: int = 4,
                   max_seq_len: int = 64, reduced: bool = True) -> dict:
    """One ``--suite serve`` cell: one paged decode step
    (:class:`~repro_torch.serve.engine.PagedDecodeEngine`, the
    ``flash_decode`` kernel's fake route) of the arch's reduced config
    (its full width with ``reduced=False``) on rank 0 of a ``(1, R)``
    mesh, every slot live, holding the serving prediction layer to the
    recorded program with zero tolerance:

    * bytes/pages: the page arena is exactly ``KVArenaPlan.total_elems``
      elements of the cache dtype, ``n_arena_pages`` pages of
      ``page_bytes``;
    * counts: the step issues exactly
      ``predicted_collectives_per_token(plan)`` all-reduces (a max and one
      fused stats reduce per layer; none at R = 1);
    * wire bytes: they carry exactly ``predicted_wire_bytes_per_token``.
    """
    from repro_torch.configs import reduced_config
    from repro_torch.core.topology import RankMesh
    from repro_torch.serve.engine import (PagedDecodeEngine,
                                          predicted_collectives_per_token,
                                          predicted_wire_bytes_per_token)
    from repro_torch.serve.kv import plan_kv_arena

    t0 = time.time()
    r = int(model_parallel)
    mesh = RankMesh(("data", "model"), (1, r))
    device = trace_device()
    with fake_world(r), fake_mode():
        model = build_model(reduced_config(arch) if reduced
                            else get_config(arch))
        plan = plan_kv_arena(model.cfg, model_parallel=r,
                             page_tokens=page_tokens, page_bytes=page_bytes,
                             max_seqs=max_seqs, max_seq_len=max_seq_len)
        engine = PagedDecodeEngine(model, plan, attn_impl="kernel",
                                   device=device, mesh=mesh)
        params = _fake_like(model.abstract_params(), device)
        for slot in range(plan.max_seqs):
            engine.admit(slot)
        if engine.comm is not None:
            engine.comm.record.reset()
        state_bytes = storage_bytes((params, engine.pages))
        with _Counters((params, engine.pages)) as c:
            engine.decode(params, [0] * plan.max_seqs)
        counts = c.summary()
        rec = (engine.comm.record if engine.comm is not None
               else CommRecord()).as_dict()
        pages = engine.pages
        arena_elems = pages.numel()
        arena_bytes = arena_elems * pages.element_size()
    n_ar = rec["all_reduces"]
    messages, measured = record_wire(rec, r)
    pred_count = predicted_collectives_per_token(plan)
    predicted = predicted_wire_bytes_per_token(plan, model.cfg,
                                               plan.max_seqs)

    # --- the zero-tolerance prediction checks -----------------------------
    if arena_elems != plan.total_elems or arena_bytes != plan.total_bytes:
        raise AssertionError(
            f"page arena is {arena_elems} elements ({arena_bytes} B), "
            f"predicted {plan.total_elems} ({plan.total_bytes} B, "
            f"{plan.n_arena_pages} pages)")
    if arena_bytes != plan.n_arena_pages * page_bytes:
        raise AssertionError(f"page arena of {arena_bytes} B is not "
                             f"{plan.n_arena_pages} pages of {page_bytes} B")
    if n_ar != pred_count:
        raise AssertionError(f"decode step issued {n_ar} all-reduces per "
                             f"token, predicted {pred_count}")
    if measured != predicted:
        raise AssertionError(f"per-token all-reduce wire bytes: predicted "
                             f"{predicted}, recorded {measured}")
    return {
        "arch": arch, "suite": "serve", "page_tokens": page_tokens,
        "page_bytes": int(page_bytes), "mesh": f"1x{r}", "devices": r,
        "batch_slots": plan.max_seqs, "max_seq_len": max_seq_len,
        "trace_s": time.time() - t0,
        "predicted_kv_bytes": plan.total_bytes,
        "predicted_kv_pages": plan.n_arena_pages,
        "arena_elems": arena_elems,
        "kv_bytes_match": arena_elems == plan.total_elems,
        "padding_fraction": plan.padding_fraction,
        "predicted_collectives_per_token": pred_count,
        "recorded_allreduce_per_token": n_ar,
        "predicted_wire_bytes_per_token": predicted,
        "recorded_wire_bytes_per_token": measured,
        "recorded_messages": messages,
        "memory": _memory(state_bytes, 0, counts["peak_bytes"]),
        "kernels": counts["kernels"], "kernel_routes": counts["routes"],
        "roofline": _roofline(counts, predicted, messages, 0.0, 0.0, r),
        "kv_plan": plan.describe(),
        "reduced": reduced,
    }


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------


def _run_grid(args, cache: dict, cells) -> None:
    """Runs ``(key, fn, describe, ident)`` cells not yet in ``cache`` (all
    with ``--force``), writing ``args.out`` after each.  A cell the port
    refuses (:class:`~repro_torch.refusal.Refusal`: a configuration it does
    not run, by design) is kept as ``{"refused": reason}``; any other
    exception (a ``NotImplementedError`` of an op with no meta or fake
    kernel among them) as ``{"error": ...}``, which fails the run."""
    for key, fn, describe, ident in cells:
        if key in cache and not args.force:
            print(f"[cached] {key}")
            continue
        print(f"[trace] {key} ...", flush=True)
        t0 = time.time()
        try:
            rec = fn()
            rec["tag"] = args.tag
            cache[key] = rec
            print(f"  ok in {time.time() - t0:.1f}s: {describe(rec)}",
                  flush=True)
        except Refusal as e:
            cache[key] = {"refused": str(e), "tag": args.tag, **ident}
            print(f"  refused: {e}")
        except Exception as e:
            cache[key] = {"error": f"{type(e).__name__}: {e}",
                          "tag": args.tag, **ident}
            print(f"  FAILED: {e}")
            traceback.print_exc()
        with open(args.out, "w") as f:
            json.dump(cache, f, indent=1)


def _describe_cell(rec: dict) -> str:
    r, m = rec["roofline"], rec["memory"]
    return (f"bottleneck={r['bottleneck']} Tc={r['t_compute_s']:.4f}s "
            f"Tm={r['t_memory_s']:.4f}s Tx={r['t_collective_s']:.4f}s "
            f"Tx_exposed={r['t_exposed_collective_s']:.4f}s "
            f"overlap={r['overlap_fraction']:.2f} "
            f"peak={m['peak_gb']:.2f}GB fits={m['fits']}")


def train_cells(args, tuned_db=None):
    archs = list_archs() if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    for arch in archs:
        cfg = get_config(arch)
        shapes = (applicable_shapes(cfg) if args.shape == "all"
                  else args.shape.split(","))
        for shape_name in shapes:
            if shape_name not in applicable_shapes(cfg):
                print(f"[skip] {arch} x {shape_name}: inapplicable "
                      f"(sub-quadratic rule)")
                continue
            for multi in meshes:
                overrides = {"accum_microbatches": args.microbatches,
                             "accum_policy": args.accum_policy}
                key_over = dict(overrides)
                if tuned_db is not None:
                    key_over["tuned"] = os.path.basename(args.tuned)
                key = cell_key(args.tag, arch, shape_name,
                               "multi" if multi else "single", key_over)
                yield (key,
                       lambda a=arch, s=shape_name, m=multi, o=overrides:
                       run_cell(a, s, m, overrides=o, tuned_db=tuned_db),
                       _describe_cell, {"arch": arch, "shape": shape_name})


def mem_cells(args, tuned_db=None):
    archs = (MEM_DEFAULT_ARCHS if args.arch == "all"
             else args.arch.split(","))
    for arch in archs:
        for pb in (int(s) for s in str(args.page_bytes).split(",")):
            for bmb in (float(s) for s in str(args.bucket_mb).split(",")):
                grid = {"page_bytes": pb, "bucket_mb": bmb,
                        "channels": args.channels}
                if tuned_db is not None:
                    grid["tuned"] = os.path.basename(args.tuned)
                yield (cell_key(args.tag, arch, "mem", f"p{pb}", grid),
                       lambda a=arch, p=pb, b=bmb: run_mem_cell(
                           a, p, b, channels=args.channels,
                           tuned_db=tuned_db),
                       lambda rec: (
                           f"arena={rec['predicted_arena_bytes']}B "
                           f"pages={rec['predicted_arena_pages']} "
                           f"pad={rec['padding_fraction']:.2%} collectives "
                           f"{rec['recorded_allreduce_arena']}(fused)/"
                           f"{rec['recorded_allreduce_bucket']}(bucket)"),
                       {"arch": arch, "shape": "mem"})


def serve_cells(args):
    archs = (SERVE_DEFAULT_ARCHS if args.arch == "all"
             else args.arch.split(","))
    for arch in archs:
        for pt in (int(s) for s in str(args.page_tokens).split(",")):
            for r in (int(s) for s in str(args.serve_mp).split(",")):
                grid = {"page_tokens": pt, "model_parallel": r}
                yield (cell_key(args.tag, arch, "serve", f"r{r}", grid),
                       lambda a=arch, p=pt, m=r: run_serve_cell(a, p, m),
                       lambda rec: (
                           f"kv={rec['predicted_kv_bytes']}B "
                           f"pages={rec['predicted_kv_pages']} "
                           f"pad={rec['padding_fraction']:.2%} "
                           f"collectives/token="
                           f"{rec['recorded_allreduce_per_token']} "
                           f"wire/token="
                           f"{rec['recorded_wire_bytes_per_token']:.0f}B"),
                       {"arch": arch, "shape": "serve"})


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--tuned", default=None, metavar="DB",
                    help="tuning DB (repro_torch.tune.probe output): price "
                         "each train/mem cell's collective term with the "
                         "measured alpha/bandwidth of the closest record")
    ap.add_argument("--microbatches", type=int, default=1,
                    help="grad-accumulation slices for train cells (the "
                         "reference's dry-run default)")
    ap.add_argument("--accum-policy", default="accumulate_then_reduce",
                    choices=SCHEDULE_POLICIES)
    ap.add_argument("--suite", default="train",
                    choices=["train", "mem", "serve"],
                    help="train: the arch x shape x mesh grid; mem: the "
                         "arena grid (page_bytes x bucket_mb x arch) held "
                         "to its predictions at zero tolerance; serve: the "
                         "paged decode grid (arch x page_tokens x model "
                         "parallel) held to its predictions at zero "
                         "tolerance")
    ap.add_argument("--page-bytes", default="4096,2097152")
    ap.add_argument("--bucket-mb", default="1")
    ap.add_argument("--channels", type=int, default=2)
    ap.add_argument("--page-tokens", default="8,16")
    ap.add_argument("--serve-mp", default="1,2")
    args = ap.parse_args(argv)

    tuned_db = None
    if args.tuned:
        from repro_torch.tune.db import TuningDB

        tuned_db = TuningDB.load(args.tuned)
        print(f"[tuned] {args.tuned}: {len(tuned_db)} fitted record(s)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    cache: dict = {}
    if os.path.exists(args.out):
        with open(args.out) as f:
            cache = json.load(f)
    cells = {"train": lambda: train_cells(args, tuned_db),
             "mem": lambda: mem_cells(args, tuned_db),
             "serve": lambda: serve_cells(args)}[args.suite]()
    _run_grid(args, cache, cells)
    n_err = sum(1 for v in cache.values() if "error" in v)
    n_ref = sum(1 for v in cache.values() if "refused" in v)
    print(f"done: {len(cache) - n_err - n_ref} ok, {n_ref} refused, "
          f"{n_err} failed -> {args.out}")
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
