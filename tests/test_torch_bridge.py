"""repro_torch parameter bridge, model building blocks against the JAX
reference, and the rule that the port imports nothing of JAX or ``repro``."""

import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import reduced_config as jax_reduced_config
from repro.models import build_model as jax_build_model
from repro.models import common as jax_common
from repro.models.attention import _merge_heads as jax_merge
from repro.models.attention import _split_heads as jax_split
from repro_torch import bridge
from repro_torch.models import common
from repro_torch.models.attention import _merge_heads, _split_heads

REPO = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|repro)\b", re.M)
# the checkpoint and obs packages also run where neither msgpack nor
# ml_dtypes is installed (the card's machine)
FORBIDDEN_HOST = re.compile(
    r"^\s*(import|from)\s+(jax|repro|msgpack|ml_dtypes)\b", re.M)


def test_round_trip_of_reduced_llama_params_is_bitwise():
    params = jax_build_model(jax_reduced_config("llama3.2-1b")).init(
        jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, params)
    back = bridge.params_to_numpy(bridge.params_from_numpy(np_params, "cpu"))
    ref_leaves, ref_def = jax.tree.flatten(np_params)
    got_leaves, got_def = jax.tree.flatten(back)
    assert got_def == ref_def
    for a, b in zip(got_leaves, ref_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint8), b.view(np.uint8))


def test_bf16_and_int_leaves_keep_their_dtype():
    tree = {"a": [np.asarray(jnp.arange(5, dtype=jnp.bfloat16) / 3),
                  np.arange(4, dtype=np.int32)],
            "b": (np.float32(2.5) * np.ones((2, 3), np.float32),)}
    t = bridge.params_from_numpy(tree, "cpu")
    assert t["a"][0].dtype == torch.bfloat16 and t["a"][1].dtype == torch.int32
    assert isinstance(t["b"], tuple)
    back = bridge.params_to_numpy(t)
    assert back["a"][0].dtype == tree["a"][0].dtype
    assert np.array_equal(back["a"][0].view(np.uint16),
                          tree["a"][0].view(np.uint16))
    assert np.array_equal(back["b"][0], tree["b"][0])


def _rand(rng, *shape):
    return rng.randn(*shape).astype(np.float32)


def test_building_blocks_match_jax():
    """dense, rmsnorm, RoPE, GLU MLP, embed/unembed and the head split on
    the same fp32 inputs (only op order differs: rtol 1e-5)."""
    rng = np.random.RandomState(0)
    x = _rand(rng, 3, 1, 64)
    dense_p = {"w": _rand(rng, 64, 32), "b": _rand(rng, 32)}
    norm_p = {"scale": _rand(rng, 64)}
    mlp_p = {"w_gate": {"w": _rand(rng, 64, 128)},
             "w_up": {"w": _rand(rng, 64, 128)},
             "w_down": {"w": _rand(rng, 128, 64)}}
    emb_p = {"table": _rand(rng, 512, 64)}
    heads = _rand(rng, 3, 4, 1, 16)
    pos = np.array([[0], [7], [190]], np.int32)
    tokens = np.array([[3], [500], [0]], np.int32)
    t = lambda tree: bridge.params_from_numpy(tree, "cpu")  # noqa: E731
    j = lambda tree: jax.tree.map(jnp.asarray, tree)         # noqa: E731
    f32 = torch.float32
    pairs = [
        (common.dense(t(dense_p), t(x), f32),
         jax_common.dense(j(dense_p), jnp.asarray(x), jnp.float32)),
        (common.rmsnorm(t(norm_p), t(x), 1e-5),
         jax_common.rmsnorm(j(norm_p), jnp.asarray(x), 1e-5)),
        (common.apply_rope(t(heads), t(pos), 500_000.0),
         jax_common.apply_rope(jnp.asarray(heads), jnp.asarray(pos),
                               500_000.0)),
        (common.glu_mlp(t(mlp_p), t(x), "silu", f32),
         jax_common.glu_mlp(j(mlp_p), jnp.asarray(x), "silu", jnp.float32)),
        (common.glu_mlp(t(mlp_p), t(x), "gelu", f32),
         jax_common.glu_mlp(j(mlp_p), jnp.asarray(x), "gelu", jnp.float32)),
        (common.embed(t(emb_p), t(tokens), f32),
         jax_common.embed(j(emb_p), jnp.asarray(tokens), jnp.float32, None,
                          512)),
        (common.unembed(t(emb_p), t(x), f32),
         jax_common.unembed(j(emb_p), jnp.asarray(x), jnp.float32)),
    ]
    for i, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5, err_msg=f"pair {i}")
    y = _rand(rng, 3, 1, 64)
    np.testing.assert_array_equal(_split_heads(t(y), 4).numpy(),
                                  np.asarray(jax_split(jnp.asarray(y), 4)))
    np.testing.assert_array_equal(_merge_heads(t(heads)).numpy(),
                                  np.asarray(jax_merge(jnp.asarray(heads))))


def test_trunc_normal_is_a_scaled_standard_truncation():
    gen = torch.Generator().manual_seed(0)
    w = common.trunc_normal(gen, (200_000,), 0.5)
    assert w.abs().max() <= 1.0 + 1e-6                # ±2 std
    assert abs(w.mean().item()) < 5e-3
    # variance of N(0,1) truncated at ±2 is 0.774; times std^2 = 0.25
    assert abs(w.var().item() - 0.774 * 0.25) < 5e-3
    again = common.trunc_normal(torch.Generator().manual_seed(0), (200_000,),
                                0.5)
    assert torch.equal(w, again)


def _port_sources():
    return sorted((REPO / "src" / "repro_torch").rglob("*.py")) \
        + [REPO / "chip_smoke.py"]


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_port_imports_nothing_of_jax_or_repro(path):
    hits = [m.group(0).strip() for m in FORBIDDEN.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


def _host_only_sources():
    root = REPO / "src" / "repro_torch"
    return sorted((root / "checkpoint").rglob("*.py")) \
        + sorted((root / "obs").rglob("*.py"))


@pytest.mark.parametrize("path", _host_only_sources(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_checkpoint_and_obs_import_no_msgpack_or_ml_dtypes(path):
    hits = [m.group(0).strip()
            for m in FORBIDDEN_HOST.finditer(path.read_text())]
    assert not hits, f"{path}: {hits}"


def test_import_scan_pattern():
    assert FORBIDDEN_HOST.search("import msgpack\n")
    assert FORBIDDEN_HOST.search("  from ml_dtypes import bfloat16\n")
    assert not FORBIDDEN_HOST.search("from repro_torch.checkpoint import "
                                     "_msgpack\n")
    assert FORBIDDEN.search("import jax\n")
    assert FORBIDDEN.search("    from repro.serve import x\n")
    assert not FORBIDDEN.search("from repro_torch.serve import x\n")
    assert not FORBIDDEN.search("x = 1  # import jax\n")
