"""repro_torch's dry-run (``launch/dryrun.py``) against the JAX reference's.

One reference subprocess (512 host devices, as the reference's dry-run
sets them; nothing is lowered) gives the reference's planning values:

* ``make_step_config`` field by field for every arch under several
  override sets, and the ``reduce_*`` refusal;
* ``cell_key`` on the cases of ``tests/test_dryrun_cache.py``;
* ``comm_plan_summary`` at the 16 x 16 production mesh (full width:
  llama3.2-1b zero1, qwen2-7b and mixtral-8x7b fsdp);
* ``params``, ``active_params`` and ``model_flops_estimate`` of all ten
  archs at every shape;
* the ``mem`` suite's arena plan (``ArenaLayout`` bytes, pages, spans,
  buckets, ``CommPlan.arena_bytes_per_device``) and the ``serve`` suite's
  KV arena plan (``KVArenaPlan`` bytes and pages, the per-token
  collectives and wire bytes), on the reduced configs.

The port computes the same values (the comm plan traced as rank 0 of the
fake 256-rank world), and its ``mem`` and ``serve`` cells, which record the
program's own arena tensor and collectives, equal its predictions at zero
tolerance (each cell raises otherwise).
"""

import dataclasses
import json

import pytest

from conftest import run_distributed
from repro_torch.configs import SHAPES, applicable_shapes, get_config, \
    list_archs
from repro_torch.core.reducer import LOCAL_OP_OF_REFERENCE
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.roofline import model_flops_estimate
from repro_torch.models import build_model
from repro_torch.runtime.train_step import TrainStep

OVERRIDES = [None,
             {"accum_microbatches": 1, "accum_policy": "accumulate_then_reduce"},
             {"microbatches": 3, "accum_microbatches": 1,
              "schedule": "stream", "comm_transport": "psum"},
             {"comm_page_bytes": 4096, "use_arena": True,
              "comm_channels": 1, "fsdp_gather": "ring"}]
PLAN_ARCHS = ["llama3.2-1b", "qwen2-7b", "mixtral-8x7b"]
MEM_CELLS = [(a, pb) for a in dryrun.MEM_DEFAULT_ARCHS
             for pb in (4096, 2 * 2**20)]
SERVE_CELLS = [(a, pt, r) for a in ("llama3.2-1b",) for pt in (8, 16)
               for r in (1, 2)]
KEY_CASES = [
    ("t", "arch", "shape", "single", None),
    ("t", "arch", "shape", "single", {}),
    ("t", "arch", "shape", "single",
     {"accum_policy": "accumulate_then_reduce", "accum_microbatches": 1}),
    ("t", "arch", "shape", "single",
     {"accum_policy": "scheduled", "accum_microbatches": 1}),
    ("t", "arch", "shape", "single",
     {"accum_policy": "accumulate_then_reduce", "accum_microbatches": 4}),
    ("t", "stencil", "L8h1", "single",
     {"solver": "sstep", "precond": "eo", "sstep_s": 4}),
    ("t", "m", "s", "multi", {"x": 1, "y": "z", "nested": {"b": 2, "a": 1}}),
    ("t", "m", "s", "multi", {"nested": {"a": 1, "b": 2}, "y": "z", "x": 1}),
    ("t", "m", "s", "multi", {"p": "ab"}),
    ("t", "m", "s", "multi", {"p": "a"}),
]

JAX_SCRIPT = r"""
import dataclasses, json
from repro.launch import dryrun as D
import jax
from repro import compat
from repro.comm import CommConfig
from repro.configs import SHAPES, applicable_shapes, get_config, list_archs
from repro.configs import reduced_config
from repro.launch.mesh import make_production_mesh
from repro.launch.roofline import model_flops_estimate
from repro.models import build_model
from repro.runtime.train_step import TrainStepConfig, _local_shapes, build_comm
from repro.serve.engine import (predicted_collectives_per_token,
                                predicted_wire_bytes_per_token)
from repro.serve.kv import plan_kv_arena

overrides, plan_archs = {overrides!r}, {plan_archs!r}
mem_cells, serve_cells, key_cases = {mem!r}, {serve!r}, {keys!r}
out = {{"step_config": {{}}, "keys": [], "plans": {{}}, "models": {{}},
        "mem": [], "serve": []}}


def fields(c):
    d = dataclasses.asdict(c)
    d.pop("reduce", None)
    d.pop("optim", None)
    return d


for arch in list_archs():
    rows = []
    for ov in overrides:
        rows.append(fields(D.make_step_config(arch, ov)))
    try:
        D.make_step_config(arch, {{"reduce_policy": "x"}})
        rows.append("accepted")
    except ValueError as e:
        rows.append("refused")
    out["step_config"][arch] = rows
    model = build_model(get_config(arch))
    n = model.active_param_count()
    out["models"][arch] = {{
        "params": model.param_count(), "active": n,
        "flops": {{s: model_flops_estimate(
            n, SHAPES[s].global_batch * (SHAPES[s].seq_len
                                         if SHAPES[s].kind != "decode"
                                         else 1), SHAPES[s].kind)
            for s in applicable_shapes(model.cfg)}}}}
for case in key_cases:
    out["keys"].append(D.cell_key(*case))
mesh = make_production_mesh(multi_pod=False)
with mesh:
    for arch in plan_archs:
        model = build_model(get_config(arch))
        out["plans"][arch] = D.comm_plan_summary(
            model, mesh, D.make_step_config(arch, overrides[1]))
for arch, pb in mem_cells:
    m4 = compat.make_mesh((4, 1), ("data", "model"),
                          devices=jax.devices()[:4])
    model = build_model(reduced_config(arch))
    tcfg = TrainStepConfig(dp_mode="replicated", comm=CommConfig(
        transport="psum", channels=2, bucket_bytes=2**20, page_bytes=pb),
        schedule="scheduled", use_arena=True)
    with m4:
        comm = build_comm(m4, tcfg)
        local = _local_shapes(model.abstract_params(),
                              model.param_specs(m4), m4)
        cplan = comm.plan(local)
        lay = cplan.arena_layout
    out["mem"].append({{"arena_bytes": lay.total_bytes,
                       "arena_pages": lay.n_pages, "n_spans": lay.n_spans,
                       "n_buckets": cplan.n_buckets,
                       "wire": cplan.arena_bytes_per_device,
                       "padding": lay.padding_fraction}})
for arch, pt, r in serve_cells:
    m1r = compat.make_mesh((1, r), ("data", "model"),
                           devices=jax.devices()[:r])
    model = build_model(reduced_config(arch))
    plan = plan_kv_arena(model.cfg, m1r, page_tokens=pt, page_bytes=4096,
                         max_seqs=4, max_seq_len=64)
    out["serve"].append({{
        "kv_bytes": plan.total_bytes, "kv_pages": plan.n_arena_pages,
        "elems": plan.total_elems,
        "collectives": predicted_collectives_per_token(plan),
        "wire": predicted_wire_bytes_per_token(plan, model.cfg,
                                               plan.max_seqs)}})
print("DRYRUN_REF " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def reference():
    out = run_distributed(JAX_SCRIPT.format(
        overrides=OVERRIDES, plan_archs=PLAN_ARCHS, mem=MEM_CELLS,
        serve=SERVE_CELLS, keys=KEY_CASES), n_devices=512)
    line = next(l for l in out.splitlines() if l.startswith("DRYRUN_REF "))
    return json.loads(line[len("DRYRUN_REF "):])


def _port_fields(cfg) -> dict:
    d = dataclasses.asdict(cfg)
    d.pop("reduce", None)
    d.pop("optim", None)
    return d


@pytest.mark.parametrize("arch", list_archs())
def test_make_step_config_field_by_field(reference, arch):
    want = reference["step_config"][arch]
    for ov, ref in zip(OVERRIDES, want):
        got = _port_fields(dryrun.make_step_config(arch, ov))
        ref_comm, got_comm = ref.pop("comm"), got.pop("comm")
        assert got == ref, (arch, ov)
        ref_comm["data_axes"] = tuple(ref_comm["data_axes"])
        # the port's communicator defaults to its kernels, the reference's
        # to its plain ops (ROADMAP: local_op names)
        assert LOCAL_OP_OF_REFERENCE[ref_comm["local_op"]] == "plain"
        assert got_comm == dict(ref_comm, local_op="kernel"), (arch, ov)
    assert want[-1] == "refused"
    with pytest.raises(ValueError, match="reduce_"):
        dryrun.make_step_config(arch, {"reduce_policy": "x"})


def test_cell_key_equals_the_reference(reference):
    got = [dryrun.cell_key(*case) for case in KEY_CASES]
    assert got == reference["keys"]
    assert got[0] == got[1] == "t|arch|shape|single"
    assert len(set(got[2:6])) == 4 and got[6] == got[7] != got[8] != got[9]


@pytest.mark.parametrize("arch", list_archs())
def test_params_and_model_flops_equal_the_reference(reference, arch):
    want = reference["models"][arch]
    model = build_model(get_config(arch))
    n = model.active_param_count()
    assert model.param_count() == want["params"]
    assert n == want["active"]
    for s in applicable_shapes(model.cfg):
        shape = SHAPES[s]
        tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode"
                                       else 1)
        assert model_flops_estimate(n, tokens, shape.kind) == \
            want["flops"][s], s


@pytest.mark.parametrize("arch", PLAN_ARCHS)
def test_comm_plan_summary_at_the_production_mesh(reference, arch):
    """The plan of the step traced as rank 0 of the 256-rank world."""
    mesh = make_production_mesh(multi_pod=False)
    with dryrun.fake_world(mesh.size), dryrun.fake_mode():
        model = build_model(get_config(arch))
        step = TrainStep(model, mesh,
                         dryrun.make_step_config(arch, OVERRIDES[1]),
                         device=dryrun.trace_device())
        got = json.loads(json.dumps(dryrun.comm_plan_summary(step)))
    assert got == reference["plans"][arch]


@pytest.mark.parametrize("i", range(len(MEM_CELLS)))
def test_mem_cell_equals_the_reference_and_its_record(reference, i):
    arch, pb = MEM_CELLS[i]
    want = reference["mem"][i]
    rec = dryrun.run_mem_cell(arch, pb, 1.0)
    assert rec["predicted_arena_bytes"] == want["arena_bytes"]
    assert rec["predicted_arena_pages"] == want["arena_pages"]
    assert rec["n_spans"] == want["n_spans"]
    assert rec["n_buckets"] == want["n_buckets"]
    assert rec["predicted_wire_bytes"] == want["wire"]
    assert rec["padding_fraction"] == want["padding"]
    # what the program did, at zero tolerance
    assert rec["arena_elems"] * 4 == rec["predicted_arena_bytes"]
    assert rec["predicted_arena_bytes"] // pb == rec["predicted_arena_pages"]
    assert rec["recorded_allreduce_arena"] == rec["n_spans"]
    assert rec["recorded_allreduce_bucket"] == rec["n_buckets"]
    assert rec["recorded_wire_bytes"] == rec["predicted_wire_bytes"]
    n_seg = len(rec["segment_waste"])
    assert rec["kernels"] == {"pack.write": n_seg, "pack.read": n_seg}


@pytest.mark.parametrize("i", range(len(SERVE_CELLS)))
def test_serve_cell_equals_the_reference_and_its_record(reference, i):
    arch, pt, r = SERVE_CELLS[i]
    want = reference["serve"][i]
    rec = dryrun.run_serve_cell(arch, pt, r)
    assert rec["predicted_kv_bytes"] == want["kv_bytes"]
    assert rec["predicted_kv_pages"] == want["kv_pages"]
    assert rec["arena_elems"] == want["elems"]
    assert rec["predicted_collectives_per_token"] == want["collectives"]
    assert rec["predicted_wire_bytes_per_token"] == want["wire"]
    assert rec["recorded_allreduce_per_token"] == want["collectives"]
    assert rec["recorded_wire_bytes_per_token"] == want["wire"]
    assert rec["kernels"] == {"flash_decode": rec["kv_plan"]["n_layers"]}
