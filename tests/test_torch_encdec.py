"""repro_torch's encoder-decoder (whisper-base) and the modality stubs'
inputs against the JAX reference, on the CPU at fp32.

* Reduced whisper-base from the reference's ``Model.init`` parameters,
  bridged: ``encode``, ``forward`` and the loss within rtol / atol 1e-5;
  ``init_decode_state``'s cross k/v (fp32 caches) within 1e-5 and
  ``decode_step`` stepped over 10 tokens within 1e-5 of the reference's,
  the self-attention caches included.
* Cross-attention (``attn_apply(cross_kv=...)``) within 1e-5 of the
  reference's: k and v from the frames, no RoPE, non-causal, GQA gathered
  as for self-attention; it never reaches the ``flash_attn`` kernel, under
  either ``attn_impl``.  The encoder under ``attn_impl="kernel"`` runs the
  kernel once a layer, non-causal, and equals the blockwise encoder.
* ``runtime.serve_step``: the prefill with ``frames`` and the decode state
  built from ``params`` and ``frames``, against the reference.
* ``SyntheticTokens(cfg, model_cfg)``: llava-next-34b's and whisper-base's
  batches bitwise the reference's, the bf16 bits of ``extra_embeds`` and
  ``frames`` included; the parameter counts of both archs at full size
  equal the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.parallel import SINGLE as JAX_SINGLE
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.models import attention, build_model, encdec
from repro_torch.runtime.serve_step import (build_decode_step, build_prefill,
                                            init_decode_state)

ARCH = "whisper-base"
B, S = 2, 12


@pytest.fixture(scope="module")
def models():
    jmodel = jax_build_model(jax_reduced_config(ARCH))
    jparams = jmodel.init(jax.random.PRNGKey(4))
    model = build_model(reduced_config(ARCH))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    rng = np.random.RandomState(5)
    frames = (rng.randn(B, model.cfg.enc_seq, model.cfg.d_model) * 0.5
              ).astype(np.float32)
    tokens = rng.randint(0, model.cfg.vocab_size, (B, S)).astype(np.int32)
    return jmodel, jparams, model, params, frames, tokens


class _FlashSpy:
    """Counts ``flash_attention`` calls from the attention module."""

    def __init__(self, monkeypatch):
        self.calls = []
        real = attention.flash_attention

        def spy(q, k, v, **kw):
            self.calls.append((tuple(q.shape), tuple(k.shape), kw))
            return real(q, k, v, **kw)

        monkeypatch.setattr(attention, "flash_attention", spy)


def test_model_tree_matches_reference(models):
    jmodel, jparams, model, params, _, _ = models
    mine = jax.tree_util.tree_flatten_with_path(bridge.params_to_numpy(
        model.init(torch.Generator().manual_seed(0), "cpu")))[0]
    ref = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(np.asarray, jparams))[0]
    assert [p for p, _ in mine] == [p for p, _ in ref]
    for (path, a), (_, b) in zip(mine, ref):
        assert a.shape == b.shape and a.dtype == b.dtype, path
    assert model.param_count() == jmodel.param_count()


def test_encode_forward_and_loss_match_reference(models):
    jmodel, jparams, model, params, frames, tokens = models
    cfg, jcfg = model.cfg, jmodel.cfg
    want = jax.jit(lambda p, f: jax_encdec.encode(p, f, jcfg, JAX_SINGLE))(
        jparams, jnp.asarray(frames))
    got = encdec.encode(params, torch.from_numpy(frames), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    batch = {"frames": frames, "tokens": tokens,
             "labels": np.roll(tokens, -1, axis=1)}
    want = jax.jit(lambda p: jmodel.forward(p, batch))(jparams)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    got = model.forward(params, tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    jloss = jax.jit(lambda p: jmodel.loss_fn(p, batch))(jparams)
    stats: list = []
    loss = model.loss_fn(params, tb, stats_out=stats)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=1e-5)
    assert float(stats[0]["moe_drop_fraction"]) == 0.0


def test_decode_step_matches_reference(models):
    jmodel, jparams, model, params, frames, _ = models
    cfg, jcfg = model.cfg, jmodel.cfg
    cache = 16
    jstate = jax_encdec.init_decode_state(jparams, jnp.asarray(frames), jcfg,
                                          B, cache, cache_dtype=jnp.float32)
    state = model.init_decode_state(B, cache, params=params,
                                    frames=torch.from_numpy(frames),
                                    cache_dtype=torch.float32)
    for st, jst in zip(state, jstate):
        for k in ("cross_k", "cross_v"):
            assert st[k].dtype == torch.float32
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       rtol=1e-5, atol=1e-5)
    jstep = jax.jit(lambda p, t, s, pos: jmodel.decode_step(p, t, s, pos))
    tok = np.array([3, 7], np.int32)
    for pos in range(10):
        want, jstate = jstep(jparams, jnp.asarray(tok), jstate,
                             jnp.asarray(pos))
        got, state = model.decode_step(params, torch.from_numpy(tok), state,
                                       pos)
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"position {pos}")
        tok = want.argmax(-1).astype(np.int32)
    for st, jst in zip(state, jstate):
        for k in ("k", "v"):
            np.testing.assert_allclose(st["kv"][k].numpy(),
                                       np.asarray(jst["kv"][k]), rtol=1e-5,
                                       atol=1e-5)
    with pytest.raises(ValueError, match="needs params and frames"):
        model.init_decode_state(B, cache, device="cpu")


@pytest.mark.parametrize("kv_heads", [2, 4])
def test_cross_attention_matches_reference(monkeypatch, kv_heads):
    import dataclasses

    from repro.configs.base import AttnConfig as JaxAttnConfig

    acfg = dataclasses.replace(reduced_config(ARCH).attn,
                               num_kv_heads=kv_heads)
    jcfg = JaxAttnConfig(**dataclasses.asdict(acfg))
    jp = jax_attn.attn_init(jax.random.key(6), jcfg, 64)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.RandomState(7)
    x = rng.randn(2, 5, 64).astype(np.float32)
    enc = rng.randn(2, 9, 64).astype(np.float32)
    want = jax.jit(lambda p, x, e: jax_attn.attn_apply(
        p, x, jcfg, is_global=True, ctx=JAX_SINGLE,
        compute_dtype=jnp.float32, causal=False, cross_kv=e))(
        jp, jnp.asarray(x), jnp.asarray(enc))
    spy = _FlashSpy(monkeypatch)
    for impl in ("kernel", "blockwise"):
        with torch.no_grad():
            got = attention.attn_apply(
                p, torch.from_numpy(x), acfg, is_global=True,
                compute_dtype=torch.float32, causal=True, attn_impl=impl,
                cross_kv=torch.from_numpy(enc))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=impl)
    assert spy.calls == []          # Sq != Sk: the blockwise loop, always


def test_encoder_kernel_route_is_non_causal_flash_attention(models,
                                                            monkeypatch):
    _, _, model, params, frames, _ = models
    spy = _FlashSpy(monkeypatch)
    with torch.no_grad():
        got = encdec.encode(params, torch.from_numpy(frames), model.cfg,
                            attn_impl="kernel")
    want = encdec.encode(params, torch.from_numpy(frames), model.cfg)
    f, h = model.cfg.enc_seq, model.cfg.attn.num_heads
    assert spy.calls == [((B, h, f, 16), (B, 2, f, 16),
                          dict(causal=False, window=None, chunk=None))] * 2
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-5)


def test_serve_step_prefill_and_decode_state(models, monkeypatch):
    """The prefill takes ``frames`` beside the tokens (the encoder's and
    the decoder's self-attention on the kernel route, 2 + 2 calls); the
    decode state runs the encoder from ``params`` and ``frames``; the
    decode step built on it equals the reference's first steps."""
    jmodel, jparams, model, params, frames, tokens = models
    batch = {"frames": frames, "tokens": tokens}
    want = jax.jit(lambda p: jmodel.forward(p, batch))(jparams)
    spy = _FlashSpy(monkeypatch)
    got = build_prefill(model, ShapeConfig("p", S, B, "prefill"),
                        device="cpu")(params, batch)
    assert [kw["causal"] for _, _, kw in spy.calls] == [False] * 2 + \
        [True] * 2
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    shape = ShapeConfig("serve", 16, B, "decode")
    with pytest.raises(ValueError, match="pass params and frames"):
        init_decode_state(model, shape, device="cpu")
    state = init_decode_state(model, shape, params=params, frames=frames,
                              cache_dtype=torch.float32, device="cpu")
    jstate = jax_encdec.init_decode_state(jparams, jnp.asarray(frames),
                                          jmodel.cfg, B, 16,
                                          cache_dtype=jnp.float32)
    step = build_decode_step(model, shape, device="cpu")
    tok = np.array([1, 2], np.int32)
    for pos in range(3):
        want, jstate = jmodel.decode_step(jparams, jnp.asarray(tok), jstate,
                                          jnp.asarray(pos))
        got, state = step(params, tok, state, pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base"])
def test_stub_batches_are_bitwise_the_references(arch):
    """The stubs are drawn first (vision, then audio), then the tokens of
    the shortened text; bf16 by round-to-nearest-even, bit for bit."""
    mcfg = reduced_config(arch)
    kw = dict(vocab_size=512, seq_len=24, global_batch=3, seed=2,
              mean_doc_len=8)
    port = SyntheticTokens(DataConfig(**kw), mcfg)
    ref = JaxSyntheticTokens(JaxDataConfig(**kw), jax_reduced_config(arch))
    stub = "extra_embeds" if arch.startswith("llava") else "frames"
    for step in (0, 5):
        got, want = port.batch_at(step), ref.batch_at(step)
        assert sorted(got) == sorted(want) == sorted(["tokens", "labels",
                                                      stub])
        text = 24 - (mcfg.frontend_seq if stub == "extra_embeds" else 0)
        for k in ("tokens", "labels"):
            assert tuple(got[k].shape) == (3, text)
            np.testing.assert_array_equal(got[k].numpy(),
                                          np.asarray(want[k]))
        assert got[stub].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[stub].view(torch.int16).numpy(),
            np.asarray(want[stub]).view(np.int16))
    # without the model's config: tokens only, as before
    plain = SyntheticTokens(DataConfig(**kw)).batch_at(0)
    assert sorted(plain) == ["labels", "tokens"]


def test_bf16_rounding_is_to_nearest_even():
    """The float32 -> bfloat16 cast the stubs take, on the halfway cases
    and around them, against the reference's ``jnp.asarray``."""
    bits = np.array([0x3F808000, 0x3F818000, 0x3F807FFF, 0x3F808001,
                     0xBF808000, 0x7F7FFFFF, 0x00008000, 0x00018000],
                    np.uint32)
    x = bits.view(np.float32)
    got = torch.from_numpy(x).to(torch.bfloat16).view(torch.int16).numpy()
    want = np.asarray(jnp.asarray(x, jnp.bfloat16)).view(np.int16)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["llava-next-34b", "whisper-base"])
def test_full_size_param_counts_match_reference(arch):
    model = build_model(get_config(arch))
    jmodel = jax_build_model(jax_get_config(arch))
    assert model.param_count() == jmodel.param_count()
    assert model.active_param_count() == jmodel.active_param_count()
