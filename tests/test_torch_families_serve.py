"""Serving the new families in repro_torch against the JAX reference, on
the CPU at fp32.

* Contiguous decode through ``runtime.serve_step`` (``init_decode_state``
  and ``build_decode_step``) of reduced falcon-mamba-7b, hymba-1.5b and
  whisper-base: 12 tokens into an 8-slot cache (the rolling KV write wraps;
  the SSM state runs on), logits within rtol / atol 1e-5 of the
  reference's ``decode_step`` and the greedy tokens equal; whisper's state
  made from its frames (fp32 cross caches).
* The resident prefill (``build_prefill``) of the four new families on
  the kernel route (``flash_attention``'s plain version on the CPU) and on
  the blockwise route, against the reference's ``Model.forward`` on the
  same batch (the stub inputs included) within 1e-5, with the kernel's
  calls by layer: one a hybrid layer (windowed, but the global one), one
  a llava layer, one per encoder (non-causal) and decoder self-attention
  layer of whisper, none for the pure SSM stack.
* The serve CLI's contiguous loop runs falcon-mamba-7b, hymba-1.5b and
  llava-next-34b, and exits for whisper-base as the reference's does.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import SyntheticTokens as JaxSyntheticTokens
from repro.models import build_model as jax_build_model
from repro.models import encdec as jax_encdec
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.data import DataConfig, SyntheticTokens
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention, build_model
from repro_torch.runtime.serve_step import (build_decode_step, build_prefill,
                                            init_decode_state)

BATCH, CACHE, TOKENS = 2, 8, 12


def _models(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(arch))
    return jmodel, jparams, model, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "whisper-base"])
def test_decode_matches_reference_through_a_cache_wrap(arch):
    jmodel, jparams, model, params = _models(arch)
    rng = np.random.RandomState(3)
    shape = ShapeConfig("serve", CACHE, BATCH, "decode")
    frames = None
    if model.is_encdec:
        frames = (rng.randn(BATCH, model.cfg.enc_seq, model.cfg.d_model)
                  * 0.5).astype(np.float32)
        jstate = jax_encdec.init_decode_state(
            jparams, jnp.asarray(frames), jmodel.cfg, BATCH, CACHE,
            cache_dtype=jnp.float32)
    else:
        jstate = jax_init_decode_state(jmodel.cfg, BATCH, CACHE,
                                       cache_dtype=jnp.float32)
    state = init_decode_state(model, shape, params=params, frames=frames,
                              cache_dtype=torch.float32, device="cpu")
    if model.cfg.family in ("ssm", "hybrid"):
        assert all(st["ssm"]["h"].dtype == torch.float32 for st in state)
    step = build_decode_step(model, shape, device="cpu")
    jstep = jax.jit(lambda p, t, s, pos: jmodel.decode_step(
        p, t, s, pos, seq_len=CACHE))
    tok = rng.randint(0, model.cfg.vocab_size, (BATCH,)).astype(np.int32)
    for pos in range(TOKENS):
        want, jstate = jstep(jparams, jnp.asarray(tok), jstate,
                             jnp.asarray(pos))
        got, state = step(params, torch.from_numpy(tok), state, pos)
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"position {pos}")
        nxt = got.argmax(-1).to(torch.int32).numpy()
        np.testing.assert_array_equal(nxt, want.argmax(-1))
        tok = nxt


@pytest.mark.parametrize("arch,calls", [
    ("falcon-mamba-7b", []),
    ("hymba-1.5b", [(True, None), (True, 32)]),
    ("llava-next-34b", [(True, None)] * 2),
    ("whisper-base", [(False, None)] * 2 + [(True, None)] * 2)])
def test_prefill_routes_match_reference(arch, calls, monkeypatch):
    jmodel, jparams, model, params = _models(arch)
    s = 40                   # past the reduced window of 32 (hymba)
    kw = dict(vocab_size=model.cfg.vocab_size, seq_len=s,
              global_batch=BATCH, seed=1)
    jbatch = JaxSyntheticTokens(JaxDataConfig(**kw), jmodel.cfg).batch_at(0)
    batch = SyntheticTokens(DataConfig(**kw), model.cfg).batch_at(0)
    want = np.asarray(jax.jit(lambda p: jmodel.forward(p, jbatch))(jparams),
                      np.float32)
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((kw["causal"], kw["window"]))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    shape = ShapeConfig("prefill", s, BATCH, "prefill")
    for impl in ("kernel", "blockwise"):
        seen.clear()
        got = build_prefill(model, shape, attn_impl=impl, device="cpu")(
            params, batch)
        assert tuple(got.shape) == want.shape == (BATCH, s,
                                                  model.cfg.vocab_size)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5,
                                   err_msg=impl)
        assert seen == (calls if impl == "kernel" else [])


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b",
                                  "llava-next-34b"])
def test_launch_serve_contiguous_runs_the_new_families(arch, capsys):
    launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu",
                       "--batch", "2", "--cache", "16", "--tokens", "3"])
    assert "tok/s (batch 2, cache 16)" in capsys.readouterr().out


def test_launch_serve_contiguous_exits_for_encoder_decoders():
    with pytest.raises(SystemExit, match="enc-dec serving"):
        launch_serve.main(["--arch", "whisper-base", "--reduced", "--device",
                           "cpu", "--tokens", "2"])
