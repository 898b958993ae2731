"""repro_torch paged serving against the JAX reference, end to end on CPU.

Reduced llama3.2-1b (and, for the engine against the contiguous decode,
qwen2-7b, phi3-medium-14b and minicpm-2b), params made by the reference's
``Model.init`` and bridged: the port's paged engine (``device="cpu"``, so the flash-decode
wrapper runs its plain version) against the reference model's contiguous
``decode_step``, token for token across a page boundary — the oracle the
reference's own paged-engine test uses; the scheduler's statistics under
both policies; the device rule of the entry points.

Why not the reference's paged engine as the oracle: on this install (jax
0.9.0, CPU) its step-0 logits differ from process to process, with either
attention implementation (off by up to 0.48 from its own contiguous decode
in some processes, exact in others), while the port and the contiguous
decode agree to 1.2e-7 in every process.  Its Pallas kernel is held against
the port in ``test_torch_flash_decode.py``, where it is stable.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
from repro.serve import PagedDecodeEngine as JaxEngine
from repro.serve import ServeScheduler as JaxScheduler
from repro.serve import mixed_trace as jax_mixed_trace
from repro.serve import plan_kv_arena as jax_plan_kv_arena
from repro.serve.engine import _gather_local_kv as jax_gather
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.core.topology import RankMesh
from repro_torch.kernels.flash_decode import ops
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.runtime.serve_step import build_decode_step, build_prefill
from repro_torch.serve import (PagedDecodeEngine, ServeScheduler,
                               mixed_trace, plan_kv_arena)
from repro_torch.serve.engine import _gather_local_kv

ARCH = "llama3.2-1b"
DENSE_ARCHS = (ARCH, "qwen2-7b", "phi3-medium-14b", "minicpm-2b")
PLAN_KW = dict(page_tokens=8, page_bytes=4096, max_seqs=4, max_seq_len=64)


@functools.cache
def _models(arch):
    """(jax model, jax params, port model, port params) — one init, bridged."""
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, jparams)
    model = build_model(reduced_config(arch))
    return jmodel, jparams, model, bridge.params_from_numpy(np_params, "cpu")


@pytest.fixture(scope="module")
def models():
    return _models(ARCH)


def _jax_engine(jmodel, attn_impl, cache_dtype):
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    plan = jax_plan_kv_arena(jmodel.cfg, mesh, cache_dtype=cache_dtype,
                             **PLAN_KW)
    return JaxEngine(jmodel, mesh, plan, attn_impl=attn_impl, interpret=True)


def _port_engine(model, attn_impl, cache_dtype):
    plan = plan_kv_arena(model.cfg, cache_dtype=cache_dtype, **PLAN_KW)
    return PagedDecodeEngine(model, plan, attn_impl=attn_impl, device="cpu")


@pytest.mark.parametrize("arch", DENSE_ARCHS)
@pytest.mark.parametrize("cache,rtol,atol", [
    # fp32 cache and fp32 compute: only the summation order differs
    ("float32", 1e-4, 1e-4),
    # bf16 cache: a 1-ulp fp32 difference can flip one bf16 rounding of K/V;
    # the reference's own paged-vs-contiguous tolerance
    ("bfloat16", 2e-2, 2e-3)])
def test_engine_matches_jax_decode(arch, cache, rtol, atol):
    jmodel, jparams, model, params = _models(arch)
    eng = _port_engine(model, "kernel", getattr(torch, cache))
    live = [0, 1, 3]                         # slot 2 stays free
    for s in live:
        eng.admit(s)
    state = jax_init_decode_state(jmodel.cfg, 4, 32,
                                  cache_dtype=getattr(jnp, cache))
    rng = np.random.RandomState(1)
    launches = ops.LAUNCHES
    for t in range(10):                      # crosses the 8-token page
        tok = rng.randint(0, model.cfg.vocab_size, (4,)).astype(np.int32)
        want, state = jmodel.decode_step(jparams, jnp.asarray(tok), state, t,
                                         seq_len=32)
        got = eng.decode(params, tok).float().numpy()
        np.testing.assert_allclose(got[live],
                                   np.asarray(want, np.float32)[live],
                                   rtol=rtol, atol=atol,
                                   err_msg=f"step {t} ({cache})")
    assert ops.LAUNCHES == launches          # CPU: plain version, no launch
    assert eng.slot_len.tolist() == [10, 10, 0, 10]


def test_paged_gather_matches_jax(models):
    """The arena view + page gather is the reference's 5-D flat take."""
    model = models[2]
    plan = plan_kv_arena(model.cfg, cache_dtype=torch.float32, **PLAN_KW)
    jplan = jax_plan_kv_arena(models[0].cfg, cache_dtype=jnp.float32,
                              **PLAN_KW)
    rng = np.random.RandomState(2)
    arena = rng.randn(plan.total_elems).astype(np.float32)
    table = rng.randint(-1, plan.n_kv_pages,
                        (plan.max_seqs, plan.max_blocks, plan.n_layers)
                        ).astype(np.int32)
    for layer in range(plan.n_layers):
        k, v, tab = _gather_local_kv(torch.from_numpy(arena), plan, layer,
                                     torch.from_numpy(table))
        jk, jv, jtab = jax_gather(jnp.asarray(arena), jplan, layer,
                                  jnp.asarray(table), 0)
        np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(tab.numpy(), np.asarray(jtab))


def test_scheduler_stats_match_jax(models):
    jmodel, jparams, model, params = models
    jeng = _jax_engine(jmodel, "ref", jnp.bfloat16)
    eng = _port_engine(model, "ref", torch.bfloat16)
    trace_kw = dict(groups=2, slots=4, long_len=12, short_len=3)
    assert mixed_trace(**trace_kw) == [
        type(mixed_trace()[0])(r.rid, r.prompt_len, r.decode_len)
        for r in jax_mixed_trace(**trace_kw)]
    for policy in ("continuous", "static"):
        want = JaxScheduler(jeng, policy).run(jparams,
                                              jax_mixed_trace(**trace_kw))
        got = ServeScheduler(eng, policy).run(params, mixed_trace(**trace_kw))
        for key in ("steps", "generated_tokens", "prefill_steps",
                    "tokens_per_step", "mean_live_slots", "n_requests"):
            assert got[key] == want[key], (policy, key)
    assert eng.allocator.n_free == eng.allocator.n_total


def test_model_tree_matches_jax(models):
    """Port init gives the reference's tree: keys, shapes, dtypes, count."""
    jmodel, jparams, model, _ = models
    gen = torch.Generator().manual_seed(0)
    mine = bridge.params_to_numpy(model.init(gen, "cpu"))
    flat_mine = jax.tree_util.tree_flatten_with_path(mine)[0]
    flat_ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    assert [p for p, _ in flat_mine] == [p for p, _ in flat_ref]
    for (path, a), (_, b) in zip(flat_mine, flat_ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert model.param_count() == jmodel.param_count()
    # padded q heads (4 -> 16) have zero wo rows, as in the reference
    hd = model.cfg.attn.head_dim
    wo = mine["blocks"][0]["attn"]["wo"]["w"]
    assert not wo[model.cfg.attn.num_heads * hd:].any()
    # std-scaled truncation at ±2σ: |w| <= 2/sqrt(d_in)
    wq = mine["blocks"][0]["attn"]["wq"]["w"]
    assert np.abs(wq).max() <= 2.0 / np.sqrt(wq.shape[0]) + 1e-7


def test_entry_points_need_cuda_unless_cpu_is_asked(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model = models[2]
    plan = plan_kv_arena(model.cfg, **PLAN_KW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        PagedDecodeEngine(model, plan)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init(torch.Generator())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params_from_numpy({"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", ARCH, "--reduced", "--paged"])
    shape = ShapeConfig("serve", 16, 2, "decode")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_prefill(model, shape)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        build_decode_step(model, shape)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        model.init_decode_state(2, 16)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", ARCH, "--reduced"])
    with pytest.raises(ValueError, match="generator lives on"):
        model.init(torch.Generator(), "meta")


def test_engine_refuses_what_is_not_ported(models):
    """Since page-parallel decode was ported, a plan whose model_parallel
    differs from the mesh's model axis is refused (the reference's own
    check); a model_parallel=2 plan runs on a (1, 2) mesh
    (test_torch_tp_serve.py)."""
    model = models[2]
    with pytest.raises(ValueError, match="re-plan with this mesh"):
        PagedDecodeEngine(model, plan_kv_arena(model.cfg, model_parallel=2,
                                               **PLAN_KW), device="cpu")
    with pytest.raises(ValueError, match="mesh model axis is 2"):
        PagedDecodeEngine(model, plan_kv_arena(model.cfg, **PLAN_KW),
                          device="cpu",
                          mesh=RankMesh(("data", "model"), (1, 2)))
    with pytest.raises(ValueError):
        PagedDecodeEngine(model, plan_kv_arena(model.cfg, **PLAN_KW),
                          attn_impl="pallas", device="cpu")


def test_launch_serve_paged_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--paged", "--device",
                       "cpu", "--policy", "both", "--groups", "1",
                       "--long-len", "6", "--short-len", "2",
                       "--page-tokens", "4"])
    out = capsys.readouterr().out
    assert "continuous / static throughput" in out
