"""repro_torch's Mamba-1 block and hybrid layer against the JAX reference,
on the CPU at fp32.

* ``selective_scan`` is ``jax.lax.associative_scan``'s recursion: bitwise
  the reference's eager scan (op by op, no FMA contraction) at lengths
  that cover the odd-length branch.  The other reference calls are
  jitted (XLA may contract a multiply and an add into an FMA there,
  within the tolerances below).
* ``ssm_apply`` from the reference's ``ssm_init`` parameters within rtol
  1e-5 at S in {1, 2, 7, 33, 64}; ``ssm_decode`` stepped over S tokens
  within 1e-5 of the reference's, state included; ``_causal_conv`` with a
  tail; the decode against the full scan at the reference's own tolerance
  (``tests/test_models.py``).
* The hybrid block (reduced hymba-1.5b, its global and its windowed layer,
  S past the window) within 1e-5, its ``beta`` mix in the compute dtype.
* hymba's attention at its published head layout (25 query heads padded
  to 32, 5 kv heads): the kernel route hands ``flash_attention`` the 25
  real heads and kv heads in groups of 5, and equals the blockwise route
  and the reference's ``attn_apply`` within 1e-5.
* The SSM decode state under ``decode_state_specs`` and the SSM leaves'
  specs and FSDP buckets on a model axis.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.configs.base import SSMConfig as JaxSSMConfig
from repro.models import attention as jax_attn
from repro.models import build_model as jax_build_model
from repro.models import ssm as jax_ssm
from repro.models import transformer as jax_transformer
from repro.models.parallel import SINGLE as JAX_SINGLE
from repro_torch import bridge
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import SSMConfig
from repro_torch.core.topology import RankMesh
from repro_torch.models import attention, build_model, ssm, transformer
from repro_torch.runtime.train_step import FsdpPlan, TrainStepConfig
from repro_torch.sharding.rules import (decode_state_specs, local_shapes,
                                        map_with_path)

D = 32
JCFG = JaxSSMConfig(state_dim=4, conv_width=4, expand=2, dt_rank=8)
CFG = SSMConfig(state_dim=4, conv_width=4, expand=2, dt_rank=8)


@pytest.fixture(scope="module")
def block():
    p = jax_ssm.ssm_init(jax.random.key(1), JCFG, D)
    return p, bridge.params_from_numpy(jax.tree.map(np.asarray, p), "cpu")


def _x(s: int, seed: int = 0) -> np.ndarray:
    return (np.random.RandomState(seed).randn(2, s, D) * 0.3).astype(
        np.float32)


def _combine(e1, e2):
    a1, b1 = e1
    a2, b2 = e2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("s", [1, 2, 3, 7, 33, 64])
def test_selective_scan_is_the_references_recursion(s):
    rng = np.random.RandomState(s)
    a = rng.uniform(0.5, 1.0, (2, s, 6, 4)).astype(np.float32)
    b = rng.randn(2, s, 6, 4).astype(np.float32)
    _, want = jax.lax.associative_scan(_combine, (jnp.asarray(a),
                                                  jnp.asarray(b)), axis=1)
    got = ssm.selective_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


_jax_apply = jax.jit(lambda p, x: jax_ssm.ssm_apply(
    p, x, JCFG, ctx=JAX_SINGLE, compute_dtype=jnp.float32, d_model=D))
_jax_decode = jax.jit(lambda p, x, st: jax_ssm.ssm_decode(
    p, x, JCFG, st, ctx=JAX_SINGLE, compute_dtype=jnp.float32, d_model=D))


@pytest.mark.parametrize("s", [1, 2, 7, 33, 64])
def test_ssm_apply_matches_reference(block, s):
    jp, p = block
    x = _x(s, s)
    want = _jax_apply(jp, jnp.asarray(x))
    got = ssm.ssm_apply(p, torch.from_numpy(x), CFG,
                        compute_dtype=torch.float32, d_model=D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


def test_ssm_decode_matches_reference_step_by_step(block):
    jp, p = block
    s = 16
    x = _x(s, 5)
    jstate = jax_ssm.init_ssm_state(JCFG, D, 2)
    state = ssm.init_ssm_state(CFG, D, 2)
    assert state["h"].shape == (2, 2 * D, 4) and state["h"].dtype == \
        torch.float32 and state["conv"].shape == (2, 3, 2 * D)
    outs = []
    for t in range(s):
        want, jstate = _jax_decode(jp, jnp.asarray(x[:, t:t + 1]), jstate)
        got, state = ssm.ssm_decode(p, torch.from_numpy(x[:, t:t + 1]), CFG,
                                    state, compute_dtype=torch.float32,
                                    d_model=D)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-7, err_msg=f"token {t}")
        outs.append(got)
    for k in ("h", "conv"):
        np.testing.assert_allclose(state[k].numpy(), np.asarray(jstate[k]),
                                   rtol=1e-5, atol=1e-7)
    # the decode against the scan: the reference's own tolerance
    full = ssm.ssm_apply(p, torch.from_numpy(x), CFG,
                         compute_dtype=torch.float32, d_model=D)
    np.testing.assert_allclose(torch.cat(outs, 1).numpy(), full.numpy(),
                               rtol=1e-3, atol=1e-3)


def test_causal_conv_taps_and_tail():
    rng = np.random.RandomState(4)
    x, w, b, tail = (rng.randn(2, 5, 6), rng.randn(4, 6), rng.randn(6),
                     rng.randn(2, 3, 6))
    x, w, b, tail = (a.astype(np.float32) for a in (x, w, b, tail))
    want = jax_ssm._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                jnp.asarray(b), jnp.asarray(tail))
    got = ssm._causal_conv(*(torch.from_numpy(a) for a in (x, w, b, tail)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_softplus_is_logaddexp():
    x = torch.tensor([-50.0, -1.0, 0.0, 19.0, 21.0, 40.0, 90.0])
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.numpy())))
    np.testing.assert_array_equal(ssm._softplus(x).numpy(), want)


@pytest.fixture(scope="module")
def hymba():
    jmodel = jax_build_model(jax_reduced_config("hymba-1.5b"))
    jparams = jmodel.init(jax.random.PRNGKey(2))
    model = build_model(reduced_config("hymba-1.5b"))
    return jmodel, jparams, model, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")


@pytest.mark.parametrize("layer", [0, 1])
def test_hybrid_block_matches_reference(hymba, layer):
    """Layer 0 is global, layer 1 windowed (32 positions at reduced size);
    48 positions so that the window masks."""
    jmodel, jparams, model, params = hymba
    cfg = model.cfg
    assert cfg.layer_kind(layer)["mixer"] == "hybrid"
    assert cfg.layer_kind(layer)["attn_global"] == (layer == 0)
    assert set(params["blocks"][layer]) == {"ln1", "ln2", "attn", "ssm",
                                            "beta", "mlp"}
    x = (np.random.RandomState(layer).randn(2, 48, cfg.d_model) * 0.5
         ).astype(np.float32)
    pos = np.arange(48)
    want, _, _ = jax.jit(lambda p, x: jax_transformer.block_apply(
        p, x, jmodel.cfg, layer, ctx=JAX_SINGLE, positions=jnp.asarray(pos),
        causal_skip=False))(jparams["blocks"][layer], jnp.asarray(x))
    got, aux, drop = transformer.block_apply(
        params["blocks"][layer], torch.from_numpy(x), cfg, layer,
        positions=torch.from_numpy(pos), causal_skip=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)
    assert float(aux) == float(drop) == 0.0


def test_hybrid_mix_in_the_compute_dtype():
    a = torch.randn(2, 3, 4, dtype=torch.bfloat16)
    s = torch.randn(2, 3, 4, dtype=torch.bfloat16)
    beta = torch.tensor([0.3, 1.7])
    got = transformer._hybrid_mix(beta, a, s, torch.bfloat16)
    jb = jnp.asarray(beta.numpy()).astype(jnp.bfloat16)
    ja = jnp.asarray(a.float().numpy()).astype(jnp.bfloat16)
    js = jnp.asarray(s.float().numpy()).astype(jnp.bfloat16)
    want = 0.5 * (ja * jb[0] + js * jb[1])
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))


def test_hymba_kernel_heads_take_the_real_heads_in_groups_of_five(
        monkeypatch):
    acfg = get_config("hymba-1.5b").attn      # tried at d_model 128
    assert (acfg.num_heads, acfg.num_kv_heads,
            attention.padded_heads(acfg.num_heads)) == (25, 5, 32)
    from repro.configs.base import AttnConfig as JaxAttnConfig
    import dataclasses

    jcfg = JaxAttnConfig(**dataclasses.asdict(acfg))
    d, s = 128, 40
    jp = jax_attn.attn_init(jax.random.key(3), jcfg, d)
    p = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    x = (np.random.RandomState(6).randn(2, s, d) * 0.5).astype(np.float32)
    seen = []
    real = attention.flash_attention

    def spy(q, k, v, **kw):
        seen.append((tuple(q.shape), tuple(k.shape), tuple(v.shape), kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attention, "flash_attention", spy)
    want = jax.jit(lambda p, x: jax_attn.attn_apply(
        p, x, jcfg, is_global=False, ctx=JAX_SINGLE,
        compute_dtype=jnp.float32))(jp, jnp.asarray(x))
    outs = {}
    for impl in ("kernel", "blockwise"):
        with torch.no_grad():
            outs[impl] = attention.attn_apply(
                p, torch.from_numpy(x), acfg, is_global=False,
                compute_dtype=torch.float32, attn_impl=impl).numpy()
    assert seen == [((2, 25, s, 64), (2, 5, s, 64), (2, 5, s, 64),
                     dict(causal=True, window=1024, chunk=None))]
    heads = attention._kernel_heads(
        torch.zeros(1, 32, 4, 64), torch.arange(5.0).view(1, 5, 1, 1)
        .expand(1, 5, 4, 64), torch.zeros(1, 5, 4, 64), acfg,
        transformer.SINGLE)
    assert heads[1][0, :, 0, 0].tolist() == [0.0, 1.0, 2.0, 3.0, 4.0]
    for impl, got in outs.items():
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                   atol=1e-6, err_msg=impl)


def test_ssm_decode_state_and_specs_on_a_model_axis():
    """falcon-mamba-7b's full decode state: ``h`` and ``conv`` split over
    the model axis on ``d_inner``, the batch over data; every leaf's local
    shape divides."""
    model = build_model(get_config("falcon-mamba-7b"))
    state = transformer.init_decode_state(model.cfg, 4, 1024,
                                          device=torch.device("meta"))
    assert set(state[0]) == {"ssm"}
    mesh = RankMesh(("data", "model"), (2, 2))
    specs = decode_state_specs(state, model.cfg, mesh, 4)
    assert specs[0]["ssm"] == {"h": ("data", "model", None),
                               "conv": ("data", None, "model")}
    shapes = local_shapes(state, specs, mesh)
    assert shapes[0]["ssm"] == {"h": (2, 4096, 16), "conv": (2, 3, 4096)}


def test_fsdp_plan_buckets_the_ssm_leaves():
    """Reduced falcon-mamba-7b under fsdp on a (2, 2) stand-in mesh: every
    SSM leaf of a block lands in the block's buckets at its model-local
    size (``d_inner`` split over the model axis)."""
    model = build_model(reduced_config("falcon-mamba-7b").with_(
        sharding="fsdp"))
    mesh = RankMesh(("data", "model"), (2, 2))
    plan = FsdpPlan(model, mesh, TrainStepConfig(dp_mode="fsdp"),
                    connect=False)
    blk = plan.groups["blocks.0"]
    names = sorted(blk["ssm"])
    assert names == ["a_log", "conv_b", "conv_w", "d_skip", "dt_proj",
                     "in_proj_x", "in_proj_z", "out_proj", "x_proj"]
    sizes = map_with_path(lambda path, leaf: leaf.numel(), blk)
    total = sum(v for v in _leaves(sizes))
    assert sum(plan.plans["blocks.0"].bucket_sizes) >= total
    assert blk["ssm"]["in_proj_x"]["w"].shape == (64, 64)   # 128 / 2
    assert blk["ssm"]["a_log"].shape == (64, 4)
    assert blk["ssm"]["x_proj"]["w"].shape == (64, 16)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree
