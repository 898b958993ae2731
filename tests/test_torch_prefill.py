"""repro_torch serving prefill against the JAX reference, on the CPU.

Reduced llama3.2-1b (2 layers, d_model 64, 4 query heads padded to 16 over
2 kv heads, head_dim 16), parameters made by the reference's ``Model.init``
and bridged, tokens from a numpy seed.  The port's ``build_prefill`` runs
every layer's attention through ``flash_attention`` on the real query
heads (on the CPU its plain version); the reference's ``build_prefill``
runs its blockwise jnp loop over all 16 padded heads.  The logits agree:
within 1e-4 at fp32 compute (the reduced config's own dtype; only the
order of the sums differs) and within the engine's bf16 tolerance (rtol
2e-2, atol 5e-2) at bf16 compute, where one rounding of an activation can
flip between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import compat
from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import ShapeConfig as JaxShapeConfig
from repro.models import build_model as jax_build_model
from repro.runtime.serve_step import build_prefill as jax_build_prefill
from repro_torch import bridge
from repro_torch.configs import reduced_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels.flash_attn import ops
from repro_torch.models import build_model
from repro_torch.runtime.serve_step import build_prefill

ARCH = "llama3.2-1b"
BATCH = 2
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}


@pytest.fixture(scope="module")
def params():
    """The reference's parameters, as JAX arrays and bridged to the port."""
    jparams = jax_build_model(jax_reduced_config(ARCH)).init(
        jax.random.PRNGKey(0))
    return jparams, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


def _tokens(seq):
    rng = np.random.RandomState(seq)
    return rng.randint(0, 500, (BATCH, seq)).astype(np.int32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 40])
@pytest.mark.parametrize("causal_skip", [True, False])
def test_prefill_matches_reference(params, dtype, seq, causal_skip):
    jparams, tparams = params
    jmodel = jax_build_model(jax_reduced_config(ARCH).with_(dtype=dtype))
    model = build_model(reduced_config(ARCH).with_(dtype=dtype))
    assert model.cfg.attn.num_heads < tparams["blocks"][0]["attn"]["wq"][
        "w"].shape[1] // model.cfg.attn.head_dim      # padded query heads
    tokens = _tokens(seq)
    mesh = compat.make_mesh((1, 1), ("data", "model"))
    jfn, _ = jax_build_prefill(
        jmodel, mesh, JaxShapeConfig("prefill_test", seq, BATCH, "prefill"),
        causal_skip=causal_skip)
    want = np.asarray(jfn(jparams, {"tokens": jnp.asarray(tokens)}),
                      np.float32)
    prefill = build_prefill(
        model, ShapeConfig("prefill_test", seq, BATCH, "prefill"),
        causal_skip=causal_skip, device="cpu")
    launches = ops.LAUNCHES
    got = prefill(tparams, {"tokens": torch.from_numpy(tokens)})
    assert ops.LAUNCHES == launches          # CPU: plain version, no launch
    assert got.shape == (BATCH, seq, model.cfg.vocab_size)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), want, **TOL[dtype])


def test_prefill_kernel_path_equals_blockwise_path(params):
    """The kernel path (real heads only, padded heads zero) and the
    training path (all padded heads, kv gathered by the true group) give
    the same logits from the same port parameters."""
    _, tparams = params
    model = build_model(reduced_config(ARCH))
    shape = ShapeConfig("prefill_test", 40, BATCH, "prefill")
    batch = {"tokens": torch.from_numpy(_tokens(40))}
    got = build_prefill(model, shape, device="cpu")(tparams, batch)
    want = build_prefill(model, shape, attn_impl="blockwise",
                         device="cpu")(tparams, batch)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_prefill_refuses_what_is_not_ported(params):
    model = build_model(reduced_config(ARCH))
    shape = ShapeConfig("prefill_test", 16, BATCH, "prefill")
    # gathered builds since fsdp was ported (test_torch_fsdp.py runs it)
    assert callable(build_prefill(model, shape, weight_mode="gathered",
                                  device="cpu"))
    with pytest.raises(ValueError, match="weight_mode"):
        build_prefill(model, shape, weight_mode="sharded", device="cpu")
    prefill = build_prefill(model, shape, device="cpu")
    with pytest.raises(ValueError, match="built for tokens"):
        prefill(params[1], {"tokens": torch.zeros((BATCH, 8),
                                                  dtype=torch.int32)})
    with pytest.raises(ValueError, match="attn_impl"):
        build_prefill(model, shape, attn_impl="pallas", device="cpu")(
            params[1], {"tokens": torch.zeros((BATCH, 16),
                                              dtype=torch.int32)})
