"""The probe runner: drive the benches as a calibration matrix.

Port of ``repro.tune.probe``.  Measured mode runs cut-down versions of the
benches on ranks the port spawns itself (``launch.train.spawn``, one
process group for the whole matrix): ``allreduce`` (a gradient tree
all-reduced through :meth:`Communicator.all_reduce_tree`), ``arena`` (the
fused arena path, :meth:`Communicator.reduce_scheduled` over a
page-quantized :class:`~repro_torch.mem.arena.CommArena`, where the page
size moves bytes), ``halo`` (the Cartesian exchange) and ``cg`` (a whole
solve: reductions and exchanges), over the requested transport ×
channels × page_bytes × message-size grid.  Every cell carries the
model's predicted message count and wire bytes (from ``comm.plan`` and
``comm.halo_plan``) next to the measured seconds and their dispersion;
the fitter then recovers the measured α and bandwidth per (transport,
channels, page_bytes) group.

Where the reference runs each bench on a fixed mesh of host devices, the
port runs all four on the probe's mesh of ranks (``--mesh``, labelled by
its sizes, e.g. ``"2"`` for two ranks): the all-reduce over ``("pod",
"data")`` (one or two axes), the arena over one ``"data"`` axis of all
ranks, the halo and the solve over the same sizes on ``("x", "y", "z")``,
padded with axes of one rank (labelled so, e.g. ``"2x1x1"``), with a
stencil direction along each axis of more than one rank only, so that
every exchange unit crosses the wire.  The arena bench sweeps every
transport (the reference's takes the first).

Each measured cell also reports, for one untimed call, what the rank put
on the wire (:func:`~repro_torch.comm.plan.record_wire` of its
``CommRecord``) and the kernels it launched, so that a run can be held
against its plan (``chip_smoke.py`` does).

``--dry`` needs no ranks: cells are synthesized from the transports' own
``predicted_messages/bytes_per_device`` and a planted
:class:`~repro_torch.comm.plan.LatencyModel`, cell for cell the
reference's.

CLI::

    python -m repro_torch.tune.probe --out experiments/tuning.json \\
        --benches allreduce arena --transports ring_hier psum \\
        --channels 1 2 --page-bytes 4096 2097152 \\
        --sizes 16384 262144 4194304                 # two ranks on cuda
    python -m repro_torch.tune.probe --dry --out /tmp/tuning.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
from dataclasses import asdict, dataclass
from typing import Iterable, Mapping, Sequence

from repro_torch.tune.db import GENERIC_ARCH, TuningDB
from repro_torch.tune.fit import FitResult, fit_cells

BENCHES = ("allreduce", "arena", "halo", "cg")


@dataclass(frozen=True)
class ProbeCell:
    """One timed (or synthesized) probe point.

    ``messages``/``nbytes`` are the model's per-device predictions for this
    cell; ``seconds`` is the measured median with ``t_min``/``t_max`` the
    min/max over the timed calls, the dispersion the fitter weights by."""

    bench: str
    arch: str
    mesh: str                   # mesh label, e.g. "2" or "2x4"
    transport: str
    channels: int
    page_bytes: int
    elems: int                  # payload elements (fp32 words)
    messages: float             # predicted discrete sends / device
    nbytes: float               # predicted wire bytes / device
    seconds: float              # measured median seconds per call
    t_min: float
    t_max: float

    @property
    def spread(self) -> float:
        return float(self.t_max) - float(self.t_min)

    def as_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, d: Mapping) -> "ProbeCell":
        return cls(**{f: d[f] for f in cls.__dataclass_fields__})


def group_cells(cells: Iterable[ProbeCell]
                ) -> dict[tuple[str, int, int], list[ProbeCell]]:
    """Fit groups: one (transport, channels, page_bytes) per DB record."""
    groups: dict[tuple[str, int, int], list[ProbeCell]] = {}
    for c in cells:
        groups.setdefault((c.transport, c.channels, c.page_bytes),
                          []).append(c)
    return groups


def parse_cells(output: str) -> list[ProbeCell]:
    """Collect the ``CELL {json}`` lines of a probe's output."""
    cells = []
    for line in output.splitlines():
        if line.startswith("CELL "):
            cells.append(ProbeCell.from_dict(json.loads(line[5:])))
    return cells


def _page_padded_elems(elems: int, page_bytes: int) -> int:
    """fp32 payload elements after page-granular arena padding."""
    nbytes = max(int(elems), 1) * 4
    page = max(int(page_bytes), 4)
    return (nbytes + page - 1) // page * page // 4


def mesh_label(shape: Sequence[int]) -> str:
    return "x".join(str(int(d)) for d in shape)


# ---------------------------------------------------------------------------
# dry mode: synthesis with planted constants
# ---------------------------------------------------------------------------


def synthesize_cells(*, transports: Sequence[str] = ("psum",),
                     channels: Sequence[int] = (2,),
                     pages: Sequence[int] = (4096,),
                     sizes: Sequence[int] = (1 << 12, 1 << 16),
                     mesh: Sequence[int] = (2, 4),
                     axes: Sequence[str] = ("pod", "data"),
                     arch: str = GENERIC_ARCH,
                     alpha_s: float | None = None,
                     bandwidth: float | None = None) -> list[ProbeCell]:
    """Synthetic probe matrix: message and byte predictions from the
    transport classes, timings from a planted α/bandwidth model.  Needs no
    ranks (the transports' ``predicted_*`` methods are plain Python)."""
    from repro_torch.comm.plan import ALPHA_S, LINK_BANDWIDTH, LatencyModel
    from repro_torch.comm.registry import get_transport
    from repro_torch.core.ring import RingConfig

    model = LatencyModel(alpha_s=ALPHA_S if alpha_s is None else alpha_s,
                         bandwidth=(LINK_BANDWIDTH if bandwidth is None
                                    else bandwidth))
    axis_sizes = tuple(int(d) for d in mesh)
    label = mesh_label(axis_sizes)
    cells = []
    for tname in transports:
        _, cls = get_transport(tname)
        tr = cls(tuple(axes)[:len(axis_sizes)] or ("data",),
                 RingConfig(chunks=2))
        for ch in channels:
            for page in pages:
                for elems in sizes:
                    padded = _page_padded_elems(elems, page)
                    msgs = tr.predicted_messages_per_device(axis_sizes)
                    nb = tr.predicted_bytes_per_device(padded, axis_sizes)
                    sec = model.collective_seconds(msgs, nb)
                    cells.append(ProbeCell(
                        bench="synthetic", arch=arch, mesh=label,
                        transport=tname, channels=int(ch),
                        page_bytes=int(page), elems=int(elems),
                        messages=float(msgs), nbytes=float(nb),
                        seconds=float(sec), t_min=float(sec),
                        t_max=float(sec)))
    return cells


# ---------------------------------------------------------------------------
# measured mode: the four benches on this rank
# ---------------------------------------------------------------------------


def _launches() -> dict:
    """The launch counts of the kernels the benches reach."""
    from repro_torch.kernels.pack import ops as pack_ops
    from repro_torch.kernels.reduce_add import ops as add_ops

    return {"reduce_add": add_ops.LAUNCHES,
            "pack_write": pack_ops.LAUNCHES["write"],
            "pack_read": pack_ops.LAUNCHES["read"]}


def _over_groups_of(comm, mesh, **changes):
    """A communicator with other bucket and page sizes over ``comm``'s
    process groups: building groups is collective and each holds sockets,
    while the bucketer, the plans and the arena need none of them."""
    from repro_torch.comm import Communicator

    c = Communicator(mesh, dataclasses.replace(comm.cfg, **changes),
                     connect=False)
    c.transport, c.record, c.rank = comm.transport, comm.record, comm.rank
    return c


class _Bench:
    """One rank's side of a measured probe: every cell of the matrix as a
    :class:`ProbeCell` dict plus what one untimed call of it sent and
    launched."""

    def __init__(self, cfg: Mapping, device):
        import torch
        import torch.distributed as dist

        from repro_torch.core.topology import RankMesh

        self.cfg = cfg
        self.rank = dist.get_rank() if dist.is_initialized() else 0
        self.device = torch.device(device)
        self.shape = tuple(int(d) for d in cfg["mesh"])
        self.world = math.prod(self.shape)
        self.label = mesh_label(self.shape)
        self.data_axes = (("pod", "data")[-len(self.shape):]
                          if len(self.shape) <= 2 else
                          tuple(f"d{i}" for i in range(len(self.shape))))
        self.data_mesh = RankMesh(self.data_axes, self.shape)
        self.flat_mesh = RankMesh(("data",), (self.world,))
        if len(self.shape) > 3:
            raise ValueError("the halo and cg benches take at most 3 mesh "
                             f"axes, got {self.shape}")
        # the lattice's mesh: the probe's sizes on ("x", "y", "z"), padded
        # with axes of one rank; the stencil runs along the axes of more
        # than one rank (every rank's own lattice wraps onto itself along
        # the rest), so that every exchange unit crosses the wire
        grid = self.shape + (1,) * (3 - len(self.shape))
        self.grid_mesh = RankMesh(("x", "y", "z"), grid)
        self.grid_label = mesh_label(grid)
        self.grid_axes = self.grid_mesh.axis_names
        self.stencil_axes = tuple(a for a, n in zip(self.grid_axes, grid)
                                  if n > 1) or self.grid_axes
        self.cells: list[dict] = []
        self.checks: list[dict] = []

    def _sync(self) -> None:
        import torch

        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _cell(self, comm, fn, *, bench: str, transport: str, channels: int,
              mesh: str | None = None,
              page_bytes: int, elems: int, messages: float,
              nbytes: float, p: int, reduced: Sequence[int] = (),
              segments: int = 0) -> None:
        """One warm-up call, one recorded call, then the timed calls.
        ``reduced``: the flat lengths one call reduces (buckets, spans or
        the solve's reduction buffers), ``segments``: the arena segments
        it packs, for the launch counts a caller derives."""
        from repro_torch.comm.plan import record_wire
        from repro_torch.tune.timing import time_call

        cfg = self.cfg
        fn()
        self._sync()
        comm.record.reset()
        before = _launches()
        fn()
        self._sync()
        after = _launches()
        rec = comm.record.as_dict()
        sent_msgs, sent_bytes = record_wire(rec, p)
        t = time_call(fn, warmup=max(int(cfg["warmup"]) - 1, 0),
                      iters=int(cfg["iters"]), device=self.device)
        self.cells.append(ProbeCell(
            bench=bench, arch=cfg["arch"], mesh=mesh or self.label,
            transport=transport, channels=int(channels),
            page_bytes=int(page_bytes), elems=int(elems),
            messages=float(messages), nbytes=float(nbytes),
            seconds=float(t), t_min=t.t_min, t_max=t.t_max).as_dict())
        self.checks.append({
            "record": rec, "messages": sent_msgs, "nbytes": sent_bytes,
            "launches": {k: after[k] - before[k] for k in after},
            "reduced": [int(n) for n in reduced],
            "segments": int(segments)})

    # -- the benches ---------------------------------------------------------

    def allreduce(self) -> None:
        import numpy as np
        import torch

        from repro_torch.comm import CommConfig, Communicator

        cfg = self.cfg
        rng = np.random.RandomState(0)

        def workload(total):
            k = int(min(16, max(1, total // 4096)))
            sizes = np.full(k, total // k)
            sizes[0] += total - sizes.sum()
            return {f"g{i}": torch.from_numpy(
                rng.randn(int(s)).astype(np.float32)).to(self.device)
                for i, s in enumerate(sizes)}

        for transport in cfg["transports"]:
            for ch in cfg["channels"]:
                comm = Communicator(self.data_mesh, CommConfig(
                    transport=transport, chunks=2, channels=ch,
                    bucket_bytes=cfg["bucket_bytes"],
                    page_bytes=cfg["pages"][0], data_axes=self.data_axes))
                for total in cfg["sizes"]:
                    tree = workload(total)
                    plan = comm.plan(tree)
                    self._cell(comm, lambda: comm.all_reduce_tree(tree),
                               bench="allreduce", transport=transport,
                               channels=ch, page_bytes=cfg["pages"][0],
                               elems=int(total),
                               messages=plan.messages_per_device,
                               nbytes=plan.bytes_per_device, p=comm.world,
                               reduced=plan.bucket_plan.bucket_sizes)

    def arena(self) -> None:
        import numpy as np
        import torch

        from repro_torch.comm import CommConfig, Communicator

        cfg = self.cfg
        rng = np.random.RandomState(0)
        batch = {"x": torch.from_numpy(
            rng.randn(16 * self.world, 8).astype(np.float32)).to(
                self.device)}

        def grad_fn(p, mb):
            # the gradient of sum(p) * 1e-3 + mean(x) * 0, without autograd
            loss = sum(v.sum() for v in p.values()) * 1e-3 \
                + mb["x"].mean() * 0.0
            return loss, {k: torch.full_like(v, 1e-3) for k, v in p.items()}

        for transport in cfg["transports"]:
            for ch in cfg["channels"]:
                base = Communicator(self.flat_mesh, CommConfig(
                    transport=transport, chunks=2, channels=ch,
                    data_axes=("data",)))
                for page_bytes in cfg["pages"]:
                    for total in cfg["sizes"]:
                        k = max(4, min(16, total // 4096))
                        leaf = max(total // k, 64)
                        params = {f"g{i}": torch.from_numpy(
                            rng.randn(leaf).astype(np.float32)).to(
                                self.device) for i in range(k)}
                        comm = _over_groups_of(base, self.flat_mesh,
                                               bucket_bytes=4 * leaf,
                                               page_bytes=page_bytes)
                        plan = comm.plan(params)
                        asched = comm.arena_schedule(params, "scheduled", 1)
                        arena = comm.arena(params)
                        state = {"buf": arena.zeros(self.device)}

                        def call(comm=comm, params=params, asched=asched,
                                 arena=arena, state=state):
                            loss, (_, buf) = comm.reduce_scheduled(
                                grad_fn, params, batch, asched,
                                op="all_reduce", arena=arena,
                                arena_buf=state["buf"])
                            state["buf"] = buf
                            return loss

                        self._cell(comm, call, bench="arena",
                                   transport=transport, channels=ch,
                                   page_bytes=page_bytes,
                                   elems=int(k * leaf),
                                   messages=plan.arena_messages_per_device,
                                   nbytes=plan.arena_bytes_per_device,
                                   p=comm.world,
                                   reduced=[sp.size for sp in
                                            arena.layout.spans],
                                   segments=arena.layout.n_segments)

    def _grid(self, total: int) -> tuple[int, int, int, int]:
        L = max(4, int(round((total / 16) ** (1.0 / 3.0))))
        return (L, L, L, 16)

    def _specs(self):
        from repro_torch.core.halo import HaloSpec

        return tuple(HaloSpec(a, d) for d, a in enumerate(self.grid_axes)
                     if a in self.stencil_axes)

    def halo(self) -> None:
        import torch

        from repro_torch.comm import CommConfig, Communicator

        cfg = self.cfg
        transport = cfg["transports"][0]
        specs = self._specs()
        for ch in cfg["channels"]:
            comm = Communicator(self.grid_mesh, CommConfig(
                transport=transport, data_axes=self.grid_axes, channels=ch))
            for total in cfg["sizes"]:
                local = self._grid(total)
                x = torch.ones(local, device=self.device)
                plan = comm.halo_plan(local, specs, schedule="concurrent")

                def call(comm=comm, x=x):
                    h = comm.halo_exchange(x, specs, schedule="concurrent")
                    return sum(v.sum() for v in h.values())

                self._cell(comm, call, bench="halo", transport=transport,
                           mesh=self.grid_label,
                           channels=ch, page_bytes=cfg["pages"][0],
                           elems=math.prod(local),
                           messages=plan.messages_per_device,
                           nbytes=plan.bytes_per_device, p=comm.world)

    def cg(self) -> None:
        import torch

        from repro_torch.comm import CommConfig, Communicator
        from repro_torch.core.topology import padded_size
        from repro_torch.stencil import (StencilOp, predicted_halo_exchanges,
                                         predicted_reduction_collectives,
                                         solve)

        cfg = self.cfg
        transport = cfg["transports"][0]
        specs = self._specs()
        op = StencilOp(specs=specs, mass=0.5)
        gen = torch.Generator().manual_seed(self.rank)
        for ch in cfg["channels"]:
            comm = Communicator(self.grid_mesh, CommConfig(
                transport=transport, data_axes=self.grid_axes, channels=ch))
            tr, sizes = comm.transport, comm.axis_sizes
            # one reduction: the partial dots in one flat fp32 buffer
            # padded to the transport's divisor (stencil.cg.global_sums)
            red_elems = padded_size(2, tr.flat_divisor(sizes))
            for total in cfg["sizes"]:
                local = self._grid(total)
                b = torch.randn(local, generator=gen).to(self.device)
                kw = dict(solver="cg", precond="none", tol=1e-5,
                          maxiter=int(cfg["cg_iters"]),
                          schedule="concurrent", chunks=comm.halo_chunks,
                          channels=ch)
                iters = int(solve(op, b, comm, **kw).iters)
                hplan = comm.halo_plan(local, specs, schedule="concurrent")
                reds = predicted_reduction_collectives("cg", iters)
                exch = predicted_halo_exchanges("cg", "none", iters)
                msgs = (reds * tr.predicted_messages_per_device(sizes)
                        + exch * hplan.messages_per_device)
                nb = (reds * tr.predicted_bytes_per_device(red_elems, sizes)
                      + exch * hplan.bytes_per_device)

                def call(comm=comm, b=b, kw=kw):
                    return solve(op, b, comm, **kw).x

                self._cell(comm, call, bench="cg", transport=transport,
                           mesh=self.grid_label,
                           channels=ch, page_bytes=cfg["pages"][0],
                           elems=math.prod(local), messages=msgs, nbytes=nb,
                           p=comm.world, reduced=[red_elems] * reds)


def probe_rank(cfg: Mapping, device="cuda") -> dict:
    """This rank's share of a measured probe, run in an initialised
    process group of ``prod(cfg["mesh"])`` ranks (every rank calls it with
    the same ``cfg``): ``{"cells": [ProbeCell dicts], "checks": [{"record",
    "messages", "nbytes", "launches"} of one untimed call per cell]}``."""
    import torch.distributed as dist

    bench = _Bench(cfg, device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != bench.world:
        raise ValueError(f"the probe's mesh {bench.label} needs "
                         f"{bench.world} ranks, this world has {world}")
    for name in cfg["benches"]:
        if name not in BENCHES:
            raise ValueError(f"unknown bench {name!r}; one of {BENCHES}")
        getattr(bench, name)()
    return {"cells": bench.cells, "checks": bench.checks}


def _spawned_rank(cfg: Mapping, device: str) -> dict:
    from repro_torch.launch.train import init_distributed

    import torch.distributed as dist

    world = init_distributed(device)
    try:
        return probe_rank(cfg, world.device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def probe_config(*, benches: Sequence[str] = ("allreduce",),
                 transports: Sequence[str] = ("ring_hier", "psum"),
                 channels: Sequence[int] = (1, 2),
                 pages: Sequence[int] = (4096, 2 * 2**20),
                 sizes: Sequence[int] = (1 << 14, 1 << 18),
                 mesh: Sequence[int] = (2,),
                 arch: str = GENERIC_ARCH,
                 bucket_bytes: int = 1 << 20,
                 warmup: int = 1, iters: int = 5,
                 cg_iters: int = 8) -> dict:
    """The matrix :func:`probe_rank` runs, as plain data."""
    return {"benches": list(benches), "transports": list(transports),
            "channels": [int(c) for c in channels],
            "pages": [int(p) for p in pages],
            "sizes": [int(s) for s in sizes],
            "mesh": [int(d) for d in mesh], "arch": arch,
            "bucket_bytes": int(bucket_bytes), "warmup": int(warmup),
            "iters": int(iters), "cg_iters": int(cg_iters)}


def run_probe(*, device: str = "cuda", **matrix) -> list[ProbeCell]:
    """Measured calibration matrix (:func:`probe_config`'s arguments): the
    ranks of the probe's mesh spawned once, every cell of rank 0 parsed
    back as a :class:`ProbeCell`."""
    from repro_torch.launch.train import spawn

    cfg = probe_config(**matrix)
    out = spawn(_spawned_rank, math.prod(cfg["mesh"]), cfg, device)
    return [ProbeCell.from_dict(d) for d in out[0]["cells"]]


# ---------------------------------------------------------------------------
# fit + persist
# ---------------------------------------------------------------------------


def fit_and_store(cells: Sequence[ProbeCell], db: TuningDB
                  ) -> dict[str, FitResult]:
    """Fit every (transport, channels, page_bytes) group and store the
    records under each group's (arch, mesh); returns key -> fit."""
    fits: dict[str, FitResult] = {}
    for (transport, ch, page), group in sorted(group_cells(cells).items()):
        fit = fit_cells(group)
        key = db.put_fit(arch=group[0].arch, mesh=group[0].mesh,
                         transport=transport, channels=ch, page_bytes=page,
                         fit=fit, cells=group)
        fits[key] = fit
    return fits


def main(argv: Sequence[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="probe the comm substrate and fit measured α/bandwidth")
    ap.add_argument("--dry", action="store_true",
                    help="synthesize cells (no ranks; plants "
                    "--plant-alpha/--plant-bandwidth)")
    ap.add_argument("--out", default=None,
                    help="tuning DB path to merge fits into")
    ap.add_argument("--benches", nargs="+", default=["allreduce"],
                    choices=list(BENCHES))
    ap.add_argument("--transports", nargs="+",
                    default=None, help="default: psum (dry) / ring_hier+psum")
    ap.add_argument("--channels", nargs="+", type=int, default=[2])
    ap.add_argument("--page-bytes", nargs="+", type=int, default=[4096])
    ap.add_argument("--sizes", nargs="+", type=int,
                    default=[1 << 12, 1 << 16])
    ap.add_argument("--mesh", default=None,
                    help="probe mesh, e.g. 2 (ranks spawned: their product; "
                    "default 2, and 2x4 with --dry as in the reference)")
    ap.add_argument("--arch", default=GENERIC_ARCH)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the measured ranks (default cuda)")
    ap.add_argument("--plant-alpha", type=float, default=None,
                    help="--dry only: planted α seconds")
    ap.add_argument("--plant-bandwidth", type=float, default=None,
                    help="--dry only: planted bandwidth B/s")
    args = ap.parse_args(argv)

    label = args.mesh or ("2x4" if args.dry else "2")
    mesh = tuple(int(d) for d in label.lower().split("x"))
    if args.dry:
        cells = synthesize_cells(
            transports=tuple(args.transports or ("psum",)),
            channels=tuple(args.channels), pages=tuple(args.page_bytes),
            sizes=tuple(args.sizes), mesh=mesh, arch=args.arch,
            alpha_s=args.plant_alpha, bandwidth=args.plant_bandwidth)
    else:
        cells = run_probe(
            device=args.device, benches=tuple(args.benches),
            transports=tuple(args.transports or ("ring_hier", "psum")),
            channels=tuple(args.channels), pages=tuple(args.page_bytes),
            sizes=tuple(args.sizes), mesh=mesh, arch=args.arch,
            warmup=args.warmup, iters=args.iters)

    db = TuningDB.load(args.out) if args.out else TuningDB()
    fits = fit_and_store(cells, db)
    print(f"probed {len(cells)} cells -> {len(fits)} fit group(s)")
    for key, fit in sorted(fits.items()):
        print(f"  {key}: alpha={fit.alpha_s*1e6:.2f}us "
              f"bw={fit.bandwidth/1e9:.2f}GB/s "
              f"mean_rel_err={fit.mean_rel_err:.3%} "
              f"max_rel_err={fit.max_rel_err:.3%} "
              f"(n={fit.n_cells})")
    if args.out:
        db.save(args.out)
        print(f"wrote {args.out} ({len(db)} record(s))")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
