"""repro_torch paged engine: the K/V it hands the flash-decode kernel.

Where the model's GQA map is the kernel's uniform ``h // (Hq/Hkv)`` (no
padded query heads), the kernel engine passes the gathered ``(B, Hkv, L,
D)`` K/V unexpanded, so the kernel reads each row once for its group of
query heads; with padded query heads (they clip to the last KV head) it
expands K/V per query head, as the reference does, and so does the
plain-attention (``"ref"``) engine.  Either way the logits are the
reference's: reduced llama3.2-1b, params made by the reference's
``Model.init`` and bridged, against the reference model's contiguous
``decode_step`` (the oracle ``test_torch_engine.py`` uses, for the reason
its docstring gives), on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.kernels.flash_decode import ops, ref
from repro_torch.models import build_model
from repro_torch.models.attention import padded_heads
from repro_torch.serve import PagedDecodeEngine, plan_kv_arena
from repro_torch.serve.engine import gqa_is_uniform

ARCH = "llama3.2-1b"
PLAN_KW = dict(page_tokens=8, page_bytes=4096, max_seqs=4, max_seq_len=64)
# (q heads, kv heads) in reduced llama3.2-1b: "uniform" keeps the full-size
# ratio of 4 q heads per kv head with a head count that needs no padding
# (16 tiles the pad of 16); "padded" has 24 q heads padded to 32 over 8 kv
# heads (3 per group; the padded heads clip to kv head 7)
HEADS = {"uniform": (16, 4), "padded": (24, 8)}


@pytest.mark.parametrize("n_hq,n_kv,true_group,want", [
    (32, 8, 4, True),      # llama3.2-1b at full size
    (16, 4, 4, True),      # the "uniform" reduced config
    (8, 8, 1, True),       # no GQA
    (32, 8, 3, False),     # 24 q heads padded to 32 over 8
    (16, 2, 2, False),     # the stock reduced config: 4 padded to 16 over 2
    (12, 8, 1, False)])    # Hq not a multiple of Hkv
def test_gqa_is_uniform(n_hq, n_kv, true_group, want):
    assert gqa_is_uniform(n_hq, n_kv, true_group) is want


@pytest.fixture(scope="module", params=sorted(HEADS))
def models(request):
    """(kind, jax model, jax params, port model, port params), one init."""
    hq, hkv = HEADS[request.param]
    jcfg, cfg = jax_reduced_config(ARCH), reduced_config(ARCH)
    jmodel = jax_build_model(jcfg.with_(attn=dataclasses.replace(
        jcfg.attn, num_heads=hq, num_kv_heads=hkv)))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(cfg.with_(attn=dataclasses.replace(
        cfg.attn, num_heads=hq, num_kv_heads=hkv)))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    return request.param, jmodel, jparams, model, params


@pytest.mark.parametrize("attn_impl", ["kernel", "ref"])
def test_engine_hands_the_kernel_what_its_gqa_map_allows(models, attn_impl,
                                                         monkeypatch):
    kind, jmodel, jparams, model, params = models
    a = model.cfg.attn
    n_hq, hkv = padded_heads(a.num_heads), a.num_kv_heads
    seen = []

    def spy(fn):
        def wrapped(q, k, v, valid):
            seen.append((q.shape[1], k.shape[1], v.shape[1]))
            return fn(q, k, v, valid)
        return wrapped

    # the engine looks its attention function up when the step is built
    if attn_impl == "kernel":
        monkeypatch.setattr(ops, "flash_decode_stats",
                            spy(ops.flash_decode_stats))
    else:
        monkeypatch.setattr(ref, "decode_stats", spy(ref.decode_stats))
    plan = plan_kv_arena(model.cfg, cache_dtype=torch.float32, **PLAN_KW)
    eng = PagedDecodeEngine(model, plan, attn_impl=attn_impl, device="cpu")
    live = [0, 1, 3]                         # slot 2 stays free
    for s in live:
        eng.admit(s)
    state = jax_init_decode_state(jmodel.cfg, 4, 32,
                                  cache_dtype=jnp.float32)
    rng = np.random.RandomState(3)
    for t in range(10):                      # crosses the 8-token page
        tok = rng.randint(0, model.cfg.vocab_size, (4,)).astype(np.int32)
        want, state = jmodel.decode_step(jparams, jnp.asarray(tok), state, t,
                                         seq_len=32)
        got = eng.decode(params, tok).float().numpy()
        # fp32 cache and compute: only the summation order differs
        np.testing.assert_allclose(got[live],
                                   np.asarray(want, np.float32)[live],
                                   rtol=1e-4, atol=1e-4,
                                   err_msg=f"step {t} ({kind}, {attn_impl})")
    unexpanded = kind == "uniform" and attn_impl == "kernel"
    kv = hkv if unexpanded else n_hq
    # one call per layer and step, every one with the same head counts
    assert seen == [(n_hq, kv, kv)] * (10 * model.cfg.num_layers)
    assert unexpanded == (n_hq != kv)


def test_engine_hands_the_kernel_contiguous_kv_with_one_block(models,
                                                              monkeypatch):
    """With one page block per slot the gathered K/V is a strided view of
    the arena; the kernel takes only contiguous K/V."""
    kind, _, _, model, params = models
    seen = []
    wrapper = ops.flash_decode_stats

    def spy(q, k, v, valid):
        seen.append(k.is_contiguous() and v.is_contiguous())
        return wrapper(q, k, v, valid)

    monkeypatch.setattr(ops, "flash_decode_stats", spy)
    plan = plan_kv_arena(model.cfg, cache_dtype=torch.float32,
                         **dict(PLAN_KW, max_seq_len=PLAN_KW["page_tokens"]))
    assert plan.blocks_per_rank == 1
    eng = PagedDecodeEngine(model, plan, attn_impl="kernel", device="cpu")
    eng.admit(0)
    for t in range(3):
        eng.decode(params, np.full((4,), t, np.int32))
    assert seen and all(seen), kind
