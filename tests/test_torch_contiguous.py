"""repro_torch contiguous-cache decode against the JAX reference, on the
CPU.

Reduced llama3.2-1b, qwen2-7b, phi3-medium-14b and minicpm-2b, parameters
made by the reference's ``Model.init`` and bridged.  The port's
``build_decode_step`` against the reference's ``Model.decode_step``: 12
tokens into an 8-slot cache, so the rolling
write wraps and the oldest positions leave the softmax; the logits within
1e-4 at an fp32 cache and fp32 compute (only the order of the sums
differs), and the greedy next tokens equal.  Then the serve CLI's
contiguous loop on the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models.transformer import (init_decode_state as
                                     jax_init_decode_state)
import torch_tp_jobs as tp_jobs
from torch_dist_util import run_ranks
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import serve as launch_serve
from repro_torch.models import build_model
from repro_torch.models.transformer import init_decode_state
from repro_torch.runtime.serve_step import build_decode_step

ARCH = "llama3.2-1b"
DENSE_ARCHS = (ARCH, "qwen2-7b", "phi3-medium-14b", "minicpm-2b")
BATCH, CACHE, TOKENS = 3, 8, 12


@pytest.mark.parametrize("arch", DENSE_ARCHS)
def test_decode_step_matches_reference_through_a_cache_wrap(arch):
    jmodel = jax_build_model(jax_reduced_config(arch))
    jparams = jmodel.init(jax.random.PRNGKey(0))
    model = build_model(reduced_config(arch))
    params = bridge.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      "cpu")
    jstate = jax_init_decode_state(jmodel.cfg, BATCH, CACHE,
                                   cache_dtype=jnp.float32)
    state = init_decode_state(model.cfg, BATCH, CACHE,
                              cache_dtype=torch.float32, device="cpu")
    step = build_decode_step(model, ShapeConfig("serve", CACHE, BATCH,
                                                "decode"), device="cpu")
    rng = np.random.RandomState(3)
    tok = rng.randint(0, model.cfg.vocab_size, (BATCH,)).astype(np.int32)
    ptrs = [layer["kv"][n].data_ptr() for layer in state for n in "kv"]
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
    # the caches were written in place, and hold the reference's rows
    assert [layer["kv"][n].data_ptr() for layer in state for n in "kv"] \
        == ptrs
    for layer, jlayer in zip(state, jstate):
        for name in ("k", "v"):
            np.testing.assert_allclose(layer["kv"][name].numpy(),
                                       np.asarray(jlayer["kv"][name]),
                                       rtol=1e-4, atol=1e-4)


def test_decode_refuses_what_is_not_ported():
    """Since tensor parallelism was ported, a cache shorter than the
    sequence is sequence-sharded over the model axis: on a (1, 2) mesh of
    two gloo ranks, each holding CACHE // 2 slots of every layer, the
    decode through a cache wrap (rank 1 holding real query heads: 16 of
    16) within 2e-2 of the unsharded one-rank decode (the reference's
    tolerance, ``tests/test_distributed.py::SERVE_SCRIPT``).  Without a
    model axis a short cache is refused; gathered weights build (fsdp,
    test_torch_fsdp.py runs them), and since ROADMAP Queue 1 #6b was ported
    on a model axis too: the gathered decode step on a (1, 2) mesh decodes
    a token into finite logits of this rank's vocab shard
    (test_torch_tp_gathered.py holds it to the reference)."""
    model = build_model(reduced_config(ARCH))
    shape = ShapeConfig("serve", CACHE, BATCH, "decode")
    assert callable(build_decode_step(model, shape, weight_mode="gathered",
                                      device="cpu"))
    for out in run_ranks(tp_jobs.model_axis_builds_job, 2, "decode"):
        assert out == {"logits": (2, model.cfg.vocab_size // 2),
                       "finite": True}
    params = model.init(torch.Generator().manual_seed(0), "cpu")
    short = model.init_decode_state(BATCH, CACHE // 2, device="cpu")
    with pytest.raises(ValueError, match="not one of"):
        build_decode_step(model, shape, device="cpu")(
            params, torch.zeros(BATCH, dtype=torch.int32), short, 0)
    sharded, whole = run_ranks(tp_jobs.seq_sharded_job, 2, BATCH, CACHE,
                               TOKENS)[0]
    np.testing.assert_allclose(sharded, whole, rtol=0, atol=2e-2)
    assert np.max(np.abs(sharded - whole)) < 1e-4    # fp32: far inside


def test_launch_serve_contiguous_on_cpu(capsys):
    launch_serve.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                       "--batch", "2", "--cache", "16", "--tokens", "3"])
    out = capsys.readouterr().out
    assert "tok/s (batch 2, cache 16)" in out
