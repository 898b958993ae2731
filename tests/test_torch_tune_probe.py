"""The port's measured probe on two gloo ranks (one spawn): all four
benches at tiny sizes, every cell's predicted messages and bytes equal to
the reference's plan of the same configuration and to what the cell's
recorded call put on the wire; then probe -> fit -> DB -> the train CLI's
``--tuned`` resolution, in sequence, beside the reference's resolution
of the same DB."""

import math
import types

import numpy as np
import pytest

import torch_tune_jobs as jobs
from torch_dist_util import run_ranks

from repro.comm import CommConfig as RefCommConfig
from repro.comm import Communicator as RefCommunicator
from repro.comm import halo_units as ref_halo_units
from repro.comm.registry import get_transport as ref_get_transport
from repro.core.halo import HaloSpec as RefSpec
from repro.core.ring import RingConfig as RefRingConfig
from repro.launch.settings import settings_for as ref_settings_for
from repro.stencil import (predicted_halo_exchanges as ref_exchanges,
                           predicted_reduction_collectives as ref_reductions)
from repro.tune import db as ref_db
from repro.tune import resolve as ref_resolve
from repro_torch.core.topology import RankMesh, padded_size
from repro_torch.launch import train as launch_train
from repro_torch.tune import TuningDB, probe

WORLD = 2


@pytest.fixture(scope="module")
def ranks():
    return run_ranks(jobs.probe_job, WORLD, timeout=240)


class _Leaf:
    def __init__(self, n):
        self.shape, self.dtype = (int(n),), np.dtype("float32")


def _ref_comm(**kw):
    fake = types.SimpleNamespace(axis_names=("data",),
                                 devices=np.empty((WORLD,)))
    return RefCommunicator(fake, RefCommConfig(data_axes=("data",), **kw))


def _ref_prediction(cell: dict) -> tuple[float, float]:
    """The reference's plan of the cell's configuration."""
    m = jobs.PROBE_MATRIX
    total, t, ch = cell["elems"], cell["transport"], cell["channels"]
    if cell["bench"] == "allreduce":
        k = int(min(16, max(1, total // 4096)))
        sizes = np.full(k, total // k)
        sizes[0] += total - sizes.sum()
        plan = _ref_comm(transport=t, chunks=2, channels=ch,
                         bucket_bytes=1 << 20,
                         page_bytes=cell["page_bytes"]).plan(
            {f"g{i}": _Leaf(s) for i, s in enumerate(sizes)})
        return plan.messages_per_device, plan.bytes_per_device
    if cell["bench"] == "arena":
        k = max(4, min(16, total // 4096))
        leaf = total // k
        plan = _ref_comm(transport=t, chunks=2, channels=ch,
                         bucket_bytes=4 * leaf,
                         page_bytes=cell["page_bytes"]).plan(
            {f"g{i}": _Leaf(leaf) for i in range(k)})
        return plan.arena_messages_per_device, plan.arena_bytes_per_device
    # halo and cg: the lattice (L, L, L, 16) on mesh (2, 1, 1), the stencil
    # along x; one exchange's units from the reference's halo_units
    L = int(round((total / 16) ** (1 / 3)))
    local = (L, L, L, 16)
    assert math.prod(local) == total
    sizes = {"x": WORLD, "y": 1, "z": 1}
    _, unit_bytes = ref_halo_units([RefSpec("x", 0)], local,
                                   schedule="concurrent", chunks=ch,
                                   itemsize=4, axis_sizes=sizes)
    units, unit_b = float(len(unit_bytes)), float(sum(unit_bytes))
    if cell["bench"] == "halo":
        return units, unit_b
    _, cls = ref_get_transport(t)
    tr = cls(("x", "y", "z"), RefRingConfig(chunks=2))
    axis = (WORLD, 1, 1)
    red = tr.predicted_messages_per_device(axis)
    # the solve's iterations, from the cell's own count
    iters = (cell["messages"] - red) / (2 * red + units)
    assert iters == int(iters) and 1 <= iters <= m["cg_iters"]
    iters = int(iters)
    # one reduction: the partial dots padded to the transport's divisor
    n = padded_size(2, RefRingConfig(chunks=2).flat_divisor(axis))
    reds, exch = ref_reductions("cg", iters), ref_exchanges("cg", "none",
                                                            iters)
    return (reds * red + exch * units,
            reds * tr.predicted_bytes_per_device(n, axis) + exch * unit_b)


def test_every_cell_is_the_plan_and_the_wire(ranks):
    m = jobs.PROBE_MATRIX
    cells = ranks[0]["cells"]
    n_grid = len(m["transports"]) * len(m["channels"]) * len(m["sizes"])
    assert len(cells) == n_grid * (1 + len(m["pages"])) \
        + 2 * len(m["channels"]) * len(m["sizes"])
    assert {c["bench"] for c in cells} == set(m["benches"])
    for r, out in enumerate(ranks):
        assert [c["messages"] for c in out["cells"]] == \
            [c["messages"] for c in cells]
        for cell, check in zip(out["cells"], out["checks"]):
            what = (r, cell["bench"], cell["transport"], cell["channels"],
                    cell["page_bytes"], cell["elems"])
            assert (cell["messages"], cell["nbytes"]) == (
                check["messages"], check["nbytes"]), what
            assert (cell["messages"], cell["nbytes"]) == \
                _ref_prediction(cell), what
            assert cell["seconds"] > 0 and cell["t_min"] <= cell["t_max"]
            assert cell["mesh"] == ("2" if cell["bench"] in
                                    ("allreduce", "arena") else "2x1x1")
            # no kernel launches on the CPU (the plain versions run)
            assert set(check["launches"].values()) == {0}
            if cell["bench"] == "arena":
                assert check["segments"] > 0
            if cell["transport"] == "psum":
                assert check["record"]["sends"] == 0


def test_probe_fit_db_then_tuned_resolution(ranks, tmp_path, capsys):
    cells = [probe.ProbeCell.from_dict(c) for c in ranks[0]["cells"]]
    path = str(tmp_path / "tuning.json")
    d = TuningDB()
    fits = probe.fit_and_store(cells, d)
    d.save(path)
    assert len(fits) == len(probe.group_cells(cells)) == 8
    for f in fits.values():
        assert f.alpha_s >= 0 and f.bandwidth > 0 and f.n_cells >= 3
    # the train CLI's resolution of llama3.2-1b (channels 0: the soft
    # sentinel) on the data ring of two ranks, labelled 2x1
    args = launch_train.parser().parse_args(
        ["--arch", "llama3.2-1b", "--tuned", path, "--device", "cpu"])
    mesh = launch_train.launch_mesh(args, WORLD)
    assert mesh == RankMesh(("data", "model"), (1, 2))
    args.model_parallel = 1
    mesh = launch_train.launch_mesh(args, WORLD)
    lines = []
    st = launch_train.tuned_settings(args, mesh, lines.append)
    want, info = ref_resolve.resolve_settings(
        ref_settings_for("llama3.2-1b"), "llama3.2-1b", mesh_label="2x1",
        db=ref_db.TuningDB.load(path))
    assert info["source"] == "db" and info["key"] in fits
    assert (st.transport, st.channels, st.page_bytes) == (
        want.transport, want.channels, want.page_bytes)
    assert st.channels in (1, 2) and st.transport == "ring_hier"
    assert len(lines) == 1 and lines[0].startswith(f"tuned: {info['key']} ")
