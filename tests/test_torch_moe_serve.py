"""MoE serving in repro_torch against the JAX reference, on the CPU.

Reduced mixtral-8x7b (2 MoE layers, top-2 of 4 experts, a 32-token
sliding window) and llama4-maverick-400b-a17b at 4 layers (top-1 MoE on
layers 1 and 3 with a shared expert, chunked-local attention of 32 on
layers 0-2, global on 3), parameters made by the reference's
``Model.init`` and bridged.

* The prefill at S = 64 (the window and the chunks mask) against the
  reference's ``build_prefill``: logits within 1e-4 at fp32 compute, as
  ``test_torch_prefill.py``.
* The contiguous decode against the reference's ``Model.decode_step``: 12
  tokens into an 8-slot cache, logits within 1e-4 and the greedy tokens
  equal, as ``test_torch_contiguous.py``.
* The prefill's attention routes, counted by spies on the two functions:
  mixtral's windowed layers both call ``flash_attention``; llama4's
  chunked-local layers run ``blockwise_attention`` (the kernel has no
  chunk mask; the route is fixed by the layer's kind) and only its global
  layer calls the kernel.
* The paged engine on reduced mixtral with ``window=None`` (the page table
  refuses windowed layers, in both packages) against the port's own
  contiguous decode, the engine tests' oracle: within 1e-4 on the live
  slots at an fp32 cache.  At ``model_parallel = 2`` on two gloo ranks the
  weights are whole on both, every rank runs every expert, the logits
  equal the one-rank engine's within 1e-5 and the communicator records no
  all-to-all: only the attention merge's 2 collectives a layer a token.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_moe_jobs as jobs
from torch_dist_util import run_ranks
from repro import compat
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import build_model as jax_build_model
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
from repro.runtime.serve_step import build_prefill as jax_build_prefill
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.models import attention, build_model
from repro_torch.models.transformer import init_decode_state
from repro_torch.runtime.serve_step import build_decode_step, build_prefill
from repro_torch.serve import PagedDecodeEngine, plan_kv_arena
from repro_torch.serve.engine import predicted_collectives_per_token

LAYERS = {"mixtral-8x7b": 2, "llama4-maverick-400b-a17b": 4}
BATCH, SEQ, CACHE, TOKENS = 2, 64, 8, 12
PLAN_KW = dict(page_tokens=8, page_bytes=4096, max_seqs=4, max_seq_len=64)


@pytest.fixture(scope="module", params=sorted(LAYERS))
def models(request):
    arch = request.param
    jmodel = jax_build_model(jax_reduced_config(arch).with_(
        num_layers=LAYERS[arch]))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(arch).with_(num_layers=LAYERS[arch]))
    return arch, jmodel, jparams, model, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def test_prefill_matches_reference(models):
    _, jmodel, jparams, model, params = models
    tokens = np.random.RandomState(1).randint(
        0, 500, (BATCH, SEQ)).astype(np.int32)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jfn, _ = jax_build_prefill(jmodel, mesh, JaxShapeConfig(
        "prefill_test", SEQ, BATCH, "prefill"))
    want = np.asarray(jfn(jparams, {"tokens": jnp.asarray(tokens)}))
    prefill = build_prefill(model, ShapeConfig("prefill_test", SEQ, BATCH,
                                               "prefill"), device="cpu")
    got = prefill(params, {"tokens": torch.from_numpy(tokens)})
    assert got.shape == (BATCH, SEQ, model.cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_prefill_routes_follow_the_layer_kinds(models, monkeypatch):
    arch, _, _, model, params = models
    calls = {"kernel": 0, "blockwise": 0}
    for name, key in (("flash_attention", "kernel"),
                      ("blockwise_attention", "blockwise")):
        real = getattr(attention, name)

        def spy(*a, _real=real, _key=key, **kw):
            calls[_key] += 1
            return _real(*a, **kw)

        monkeypatch.setattr(attention, name, spy)
    prefill = build_prefill(model, ShapeConfig("prefill_test", SEQ, BATCH,
                                               "prefill"), device="cpu")
    prefill(params, {"tokens": torch.zeros((BATCH, SEQ), dtype=torch.int32)})
    cfg = model.cfg
    kinds = [cfg.layer_kind(i).get("attn_global") for i in
             range(cfg.num_layers)]
    if arch == "mixtral-8x7b":
        assert kinds == [False, False] and cfg.attn.window == 32
        assert calls == {"kernel": 2, "blockwise": 0}
    else:
        assert kinds == [False, False, False, True] and cfg.attn.chunk == 32
        assert calls == {"kernel": 1, "blockwise": 3}


def test_contiguous_decode_matches_reference(models):
    _, jmodel, jparams, model, params = models
    jstate = jax_init_decode_state(jmodel.cfg, BATCH, CACHE,
                                   cache_dtype=jnp.float32)
    state = init_decode_state(model.cfg, BATCH, CACHE,
                              cache_dtype=torch.float32, device="cpu")
    step = build_decode_step(model, ShapeConfig("serve", CACHE, BATCH,
                                                "decode"), device="cpu")
    tok = np.random.RandomState(3).randint(
        0, model.cfg.vocab_size, (BATCH,)).astype(np.int32)
    for pos in range(TOKENS):
        want, jstate = jmodel.decode_step(jparams, jnp.asarray(tok), jstate,
                                          jnp.asarray(pos), seq_len=CACHE)
        got, state = step(params, torch.from_numpy(tok), state, pos)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4,
                                   err_msg=f"position {pos}")
        nxt = got.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(nxt, want.argmax(-1), f"position {pos}")
        tok = nxt


def test_paged_engine_matches_contiguous_decode():
    model = build_model(jobs.serve_moe_config())
    params = model.init(torch.Generator().manual_seed(4), "cpu")
    plan = plan_kv_arena(model.cfg, cache_dtype=torch.float32, **PLAN_KW)
    eng = PagedDecodeEngine(model, plan, device="cpu")
    live = [0, 1, 3]                         # slot 2 stays free
    for s in live:
        eng.admit(s)
    b = PLAN_KW["max_seqs"]
    state = init_decode_state(model.cfg, b, 32, cache_dtype=torch.float32,
                              device="cpu")
    step = build_decode_step(model, ShapeConfig("serve", 32, b, "decode"),
                             device="cpu")
    tokens = np.random.RandomState(5).randint(
        0, model.cfg.vocab_size, (10, b)).astype(np.int32)
    one = []
    for t, tok in enumerate(tokens):         # crosses the 8-token page
        want, state = step(params, torch.from_numpy(tok), state, t)
        got = eng.decode(params, tok)
        np.testing.assert_allclose(got.numpy()[live], want.numpy()[live],
                                   rtol=1e-4, atol=1e-4, err_msg=f"step {t}")
        one.append(got.numpy())
    ranks = run_ranks(jobs.paged_moe_job, 2, bridge.params_to_numpy(params),
                      PLAN_KW, tokens, live)
    n_tok = len(tokens)
    for out in ranks:
        np.testing.assert_allclose(out["logits"][:, live],
                                   np.stack(one)[:, live], rtol=1e-5,
                                   atol=1e-5)
        rec = out["record"]
        assert rec["all_to_alls"] == 0 and rec["sends"] == 0
        plan2 = plan_kv_arena(model.cfg, model_parallel=2,
                              cache_dtype=torch.float32, **PLAN_KW)
        # the pmax and the fused merge, both recorded in the engine's record
        assert rec["all_reduces"] == \
            predicted_collectives_per_token(plan2) * n_tok
