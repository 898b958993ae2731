"""The dry-run's machinery (``repro_torch.fake``, ``launch.dryrun``), no JAX.

* Each kernel wrapper's fake route launches nothing and builds nothing
  (``_build.load`` raises if called), counts the call on its own tally,
  and returns the shape, dtype and strides of the plain version's output;
  a pack write leaves the arena it writes into as it is, and returns it.
* ``route()`` names the same route for fake tensors as for real ones of
  the same dtypes, shapes, strides and offsets (pack: bulk or vector;
  flash_attn: wgmma or mma).
* :class:`~repro_torch.launch.dryrun.LiveBytes` gives a reduced train step
  the same peak on fake CPU tensors as on real ones.
* The run-based gradient-norm ranges (the step's, fake or real) equal the
  ranges of the weight vectors, for zero1 (with and without the arena) and
  fsdp.
* The ``"fake"`` c10d backend registers, so a PyTorch change that drops
  it fails here, and :func:`~repro_torch.launch.dryrun.fake_world`
  leaves no process group behind.
* The grid records a by-design refusal as refused and any other exception
  as an error, which fails the command.
"""

import pytest
import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch import fake
from repro_torch import tree as tree_util
from repro_torch.comm import CommConfig, Communicator
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.p2p import RingAxis
from repro_torch.core.topology import RankMesh
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ops as fa
from repro_torch.kernels.flash_attn import ref as fa_ref
from repro_torch.kernels.flash_decode import ops as fd
from repro_torch.kernels.pack import ops as pk
from repro_torch.kernels.reduce_add import ops as ra
from repro_torch.launch import dryrun
from repro_torch.models import build_model
from repro_torch.runtime.train_step import (FsdpPlan, TrainStep,
                                            TrainStepConfig, _slice_like_shard,
                                            abstract_params,
                                            build_norm_weights,
                                            build_span_norm_weights,
                                            data_mesh, init_train_state,
                                            norm_ranges_from_runs,
                                            norm_weight_runs,
                                            span_norm_weight_runs)
from repro_torch.sharding.rules import local_shapes, map_specs, spec_leaves


def _launches():
    return (ra.LAUNCHES, dict(pk.LAUNCHES), dict(pk.LAUNCHES_BY_ROUTE),
            fa.LAUNCHES, dict(fa.LAUNCHES_BY_ROUTE), fd.LAUNCHES)


@pytest.fixture
def no_build(monkeypatch):
    """Any kernel build or load raises; the launch counters must not
    move; the fake tallies start at zero."""
    def refuse(*a, **k):
        raise AssertionError("a fake route built or loaded a kernel")

    monkeypatch.setattr(_build, "load", refuse)
    fake.reset_fake_counts()
    before = _launches()
    yield
    assert _launches() == before
    fake.reset_fake_counts()


def _meta(shape, dtype, device="meta"):
    return torch.empty(shape, dtype=dtype, device=device)


def _same_layout(a: torch.Tensor, b: torch.Tensor):
    assert (a.shape, a.dtype, a.stride()) == (b.shape, b.dtype, b.stride())


@pytest.mark.parametrize("dtypes", [(torch.float32, torch.float32,
                                     torch.float32),
                                    (torch.bfloat16, torch.float32,
                                     torch.float32),
                                    (torch.float32, torch.float32,
                                     torch.bfloat16)])
def test_reduce_add_fake_route(no_build, dtypes):
    da, db, do = dtypes
    want = ra.ref.add_accum(torch.zeros(1000, dtype=da),
                            torch.zeros(1000, dtype=db), out_dtype=do)
    with FakeTensorMode():
        out = ra.add_accum(_meta(1000, da), _meta(1000, db), out_dtype=do)
    _same_layout(out, want)
    assert fake.FAKE_CALLS == {"reduce_add": 1}
    assert fake.FAKE_FLOPS["reduce_add"] == 1000


@pytest.mark.parametrize("offset,size", [(0, 4096), (3, 1000), (4100, 7)])
def test_pack_fake_routes(no_build, offset, size):
    want = pk.ref.read_flat(torch.zeros(8192), offset, size)
    with FakeTensorMode():
        arena = _meta(8192, torch.float32)
        src = _meta(size, torch.float32)
        assert pk.write_flat(arena, src, offset) is arena
        out = pk.read_flat(arena, offset, size)
    _same_layout(out, want)
    assert fake.FAKE_CALLS == {"pack.write": 1, "pack.read": 1}
    # the read's output is congruent to the segment, as on the card: bulk
    assert fake.FAKE_ROUTES["pack.read", "bulk"] == 1
    assert (out.storage_offset() - offset) % 4 == 0


@pytest.mark.parametrize("hq,hkv,s,d,dtype", [
    (8, 2, 128, 64, torch.bfloat16), (4, 4, 37, 32, torch.float32)])
def test_flash_attn_fake_route(no_build, hq, hkv, s, d, dtype):
    shapes = [(2, hq, s, d), (2, hkv, s, d), (2, hkv, s, d)]
    want = fa_ref.attention(*[torch.zeros(x, dtype=dtype) for x in shapes],
                            causal=True, window=None)
    with FakeTensorMode():
        out = fa.flash_attention(*[_meta(x, dtype) for x in shapes])
    _same_layout(out, want)
    route = "wgmma" if dtype == torch.bfloat16 else "mma"
    assert fake.FAKE_ROUTES == {("flash_attn", route): 1}
    assert fake.FAKE_FLOPS["flash_attn"] == fa.attention_flops(2, hq, s, d)


@pytest.mark.parametrize("kv_dtype", [torch.bfloat16, torch.float32])
def test_flash_decode_fake_route(no_build, kv_dtype):
    b, hq, hkv, length, d = 3, 8, 2, 40, 64
    q = torch.zeros(b, hq, 1, d, dtype=torch.bfloat16)
    k = torch.zeros(b, hkv, length, d, dtype=kv_dtype)
    valid = torch.ones(b, length, dtype=torch.bool)
    want = fd.flash_decode_stats(q, k, k, valid)        # the plain version
    with FakeTensorMode():
        got = fd.flash_decode_stats(
            _meta(q.shape, q.dtype), _meta(k.shape, kv_dtype),
            _meta(k.shape, kv_dtype), _meta(valid.shape, torch.bool))
    for g, w in zip(got, want):
        _same_layout(g, w)
    # the kernel's three outputs are views of one fp32 allocation
    assert got[0].untyped_storage().nbytes() == b * hq * (d + 2) * 4
    route = "mma" if kv_dtype == torch.bfloat16 else "simt"
    assert fake.FAKE_ROUTES == {("flash_decode", route): 1}
    assert fake.FAKE_FLOPS["flash_decode"] == fd.decode_flops(b, hq, length,
                                                              d)


@pytest.mark.parametrize("arena_off,src_off,dtype", [
    (0, 0, torch.float32), (3, 0, torch.float32), (4, 0, torch.float32),
    (8, 4, torch.float32), (0, 0, torch.bfloat16), (5, 1, torch.float32)])
def test_pack_route_is_the_same_for_fake_metadata(arena_off, src_off, dtype):
    """CPU tensors are 64-byte aligned, so their addresses modulo 16 are
    their offsets, as a fake tensor's are."""
    arena = torch.zeros(256)
    src = torch.zeros(64 + src_off, dtype=dtype)[src_off:]
    want = pk.route(arena[arena_off:arena_off + 64], src)
    with FakeTensorMode() as mode:
        farena = mode.from_tensor(arena)
        fsrc = mode.from_tensor(src)
        got = pk.route(farena[arena_off:arena_off + 64], fsrc)
    assert got == want


@pytest.mark.parametrize("layout", ["contiguous", "strided", "offset"])
def test_flash_attn_route_is_the_same_for_fake_metadata(layout):
    def qkv():
        if layout == "contiguous":
            return [torch.zeros(1, 4, 64, 64, dtype=torch.bfloat16)
                    for _ in range(3)]
        if layout == "strided":          # a 65-element sequence stride
            base = torch.zeros(1, 4, 64, 65, dtype=torch.bfloat16)
            return [base[..., :64]] * 3
        flat = torch.zeros(1 + 4 * 64 * 64, dtype=torch.bfloat16)
        return [flat[1:].view(1, 4, 64, 64)] * 3
    real = qkv()
    want = fa.route(*real)
    with FakeTensorMode() as mode:
        got = fa.route(*[mode.from_tensor(t) for t in real])
    assert got == want
    assert want == ("wgmma" if layout == "contiguous" else "mma")


def _train_step_peak() -> tuple[int, int]:
    torch.manual_seed(0)
    model = build_model(reduced_config("llama3.2-1b"))
    step = TrainStep(model, data_mesh(1), TrainStepConfig(),
                     device=torch.device("cpu"))
    params = tree_util.tree_map(
        lambda a: torch.zeros(a.shape, dtype=a.dtype),
        model.abstract_params())
    state = init_train_state(model, step, params=params)
    del params
    shape = ShapeConfig("t", 32, 4, "train")
    batch = {k: torch.zeros(s, dtype=dt) for k, (s, dt) in
             dryrun.batch_shapes(model.cfg, shape, 4).items()}
    live = dryrun.LiveBytes()
    live.track((state, batch))
    with live:
        state, _ = step(state, batch)
    return live.peak, live.max_storages


def test_live_bytes_peak_is_the_same_on_fake_and_real_tensors():
    real = _train_step_peak()
    with dryrun.fake_mode():
        faked = _train_step_peak()
    assert faked == real
    assert real[0] > 0


def _ranges_of_vectors(weights, rings):
    """The norm ranges read off weight vectors: each cut to the shard, the
    runs of one value, those of 0 left out."""
    all_ranges, all_values = [], []
    for w in weights:
        s = _slice_like_shard(w, rings)
        cuts = (torch.nonzero(s[1:] != s[:-1]).flatten() + 1).tolist()
        bounds = [0, *cuts, s.numel()]
        runs = [(a, z, s[a].item()) for a, z in zip(bounds, bounds[1:])
                if a < z and s[a] != 0]
        all_ranges.append([(a, z) for a, z, _ in runs])
        all_values.append([v for _, _, v in runs])
    return all_ranges, all_values


@pytest.mark.parametrize("case", ["zero1", "zero1_arena", "fsdp"])
def test_norm_ranges_from_runs_equal_the_weight_vectors(case):
    """The step's ranges (from the plan's fields) and those the weight
    vectors give, on a (2, 2) mesh, every rank's: maximal runs, equal."""
    model = build_model(reduced_config("llama3.2-1b").with_(num_layers=3))
    mesh = RankMesh(("data", "model"), (2, 2))
    cfg = TrainStepConfig(dp_mode="fsdp" if case == "fsdp" else "zero1",
                          use_arena=case == "zero1_arena",
                          comm=CommConfig(bucket_bytes=64 * 1024,
                                          page_bytes=4096),
                          fsdp_bucket_bytes=64 * 1024)
    plan = FsdpPlan(model, mesh, cfg, connect=False) if case == "fsdp" \
        else None
    for index in range(2):
        rings = (RingAxis((0, 1), index, None, None),)
        if plan is not None:
            weights = [w for name in sorted(plan.groups)
                       for w in plan.norm_weights[name]]
            runs = [r for name in sorted(plan.groups)
                    for r in plan.norm_runs[name]]
        else:
            specs = model.param_specs(mesh)
            full = abstract_params(model)
            local = map_specs(lambda leaf, shape: torch.empty(
                shape, dtype=leaf.dtype, device="meta"), full,
                local_shapes(full, specs, mesh))
            comm = Communicator(mesh, cfg.comm_config(("data",)),
                                connect=False)
            bplan = comm.plan(local).bucket_plan
            weights = build_norm_weights(bplan, spec_leaves(specs), 2)
            runs = norm_weight_runs(bplan, spec_leaves(specs), 2)
            if cfg.use_arena:
                lay = comm.arena_layout(local)
                weights = build_span_norm_weights(lay, weights)
                runs = span_norm_weight_runs(lay, runs)
        assert norm_ranges_from_runs(runs, rings) == \
            _ranges_of_vectors(weights, rings)


def test_host_values_is_real_inside_a_fake_mode():
    with FakeTensorMode():
        with fake.host_values():
            t = torch.arange(4)
            assert int(t[-1]) == 3 and not fake.is_fake(t)
        assert fake.is_fake(torch.arange(4)) and fake.fake_mode_active()
    assert not fake.fake_mode_active()


def test_the_fake_backend_registers_and_fake_world_cleans_up():
    import torch.testing._internal.distributed.fake_pg  # noqa: F401

    assert "fake" in dist.Backend.backend_list
    assert not dist.is_initialized()
    with dryrun.fake_world(512, rank=3):
        assert dist.get_world_size() == 512 and dist.get_rank() == 3
        group = dist.new_group(list(range(16)))
        x = torch.ones(4)
        dist.all_reduce(x, group=group)
        req = dist.irecv(torch.empty(4), src=2)
        req.wait()
        assert torch.equal(x, torch.ones(4))   # the backend moves nothing
    assert not dist.is_initialized()


def test_local_params_of_fake_tensors_own_their_storage():
    """On a model axis a rank's fake blocks are copies, as real ones are,
    so the full tree's storage is not counted as the rank's state (an
    abstract ``meta`` tree stays views)."""
    model = build_model(reduced_config("llama3.2-1b"))
    mesh = RankMesh(("data", "model"), (1, 2))
    with dryrun.fake_world(2), dryrun.fake_mode():
        step = TrainStep(model, mesh, TrainStepConfig(),
                         device=dryrun.trace_device())
        full = tree_util.tree_map(
            lambda a: torch.empty(a.shape, dtype=a.dtype,
                                  device=dryrun.trace_device()),
            model.abstract_params())
        local = step.local_params(full)
        leaves = tree_util.flatten(local)[0]
        own = sum(t.numel() * t.element_size() for t in leaves)
        assert dryrun.storage_bytes(local) == own
        assert own < dryrun.storage_bytes(full)
    views = step.local_params(model.abstract_params())
    assert all(t.device.type == "meta" for t in tree_util.flatten(views)[0])


def test_run_grid_records_refusals_and_fails_on_other_errors(tmp_path):
    """A cell the port refuses by design (:class:`Refusal`; here
    whisper-base's sequence-sharded decode cache) is recorded as refused;
    any other exception, a ``NotImplementedError`` of an op with no meta
    kernel among them, is an error, and the command exits 1."""
    import json
    from types import SimpleNamespace

    from repro_torch.refusal import Refusal

    def no_meta_kernel():
        raise NotImplementedError("Could not run 'aten::x' with arguments "
                                  "from the 'Meta' backend")

    def refused():
        raise Refusal("by design")

    out = tmp_path / "dr.json"
    args = SimpleNamespace(out=str(out), force=False, tag="t",
                           arch="whisper-base", shape="decode_32k",
                           mesh="single", microbatches=1,
                           accum_policy="accumulate_then_reduce", tuned=None)
    cells = [*dryrun.train_cells(args),
             ("refused", refused, str, {"arch": "a", "shape": "s"}),
             ("no_meta", no_meta_kernel, str, {"arch": "a", "shape": "s"})]
    cache: dict = {}
    dryrun._run_grid(args, cache, cells)
    assert json.loads(out.read_text()) == cache
    whisper = cache[cells[0][0]]
    assert "sequence-sharded" in whisper["refused"]
    assert cache["refused"]["refused"] == "by design"
    assert "refused" not in cache["no_meta"]
    assert cache["no_meta"]["error"].startswith("NotImplementedError: ")
    with pytest.raises(SystemExit) as e:
        dryrun.main(["--out", str(out), "--arch", "whisper-base",
                     "--shape", "decode_32k", "--mesh", "single"])
    assert e.value.code == 1
