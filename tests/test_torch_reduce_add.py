"""repro_torch reduce_add (the ring hop's local add) against the JAX
reference: the port's plain version (what the wrapper runs for CPU tensors)
against ``repro.kernels.reduce_add.ref`` and against the Pallas kernel in
interpret mode, on the same numpy inputs, at aligned and ragged lengths.
An fp32 add is one IEEE operation either way: bitwise."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.reduce_add import ops as jax_ops
from repro.kernels.reduce_add import ref as jax_ref
from repro.kernels.reduce_add.reduce_add import add_accum_2d
from repro_torch import bridge
from repro_torch.kernels.reduce_add import ops, ref

BF16 = np.dtype(ml_dtypes.bfloat16)
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32),
          "bfloat16": (BF16, torch.bfloat16, jnp.bfloat16)}
COMBOS = [("float32", "float32", "float32"),     # fp32 wire
          ("bfloat16", "float32", "float32"),    # bf16 wire into fp32
          ("float32", "float32", "bfloat16"),    # narrow out
          ("bfloat16", "bfloat16", "bfloat16")]


def _inputs(n, a_dt, b_dt, seed):
    rng = np.random.RandomState(seed)
    a = (rng.randn(n) * 3).astype(np.float32).astype(DTYPES[a_dt][0])
    b = rng.randn(n).astype(np.float32).astype(DTYPES[b_dt][0])
    return a, b


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("n", [1024, 3 * 1024, 1000, 7])
@pytest.mark.parametrize("combo", COMBOS, ids="-".join)
def test_plain_version_matches_reference_oracle(n, combo):
    a_dt, b_dt, o_dt = combo
    a, b = _inputs(n, a_dt, b_dt, n)
    before = ops.LAUNCHES
    got = ops.add_accum(bridge.params_from_numpy(a, "cpu"),
                        bridge.params_from_numpy(b, "cpu"),
                        out_dtype=DTYPES[o_dt][1])
    assert ops.LAUNCHES == before          # CPU tensors: no kernel launch
    want = jax_ref.add_accum(jnp.asarray(a), jnp.asarray(b),
                             out_dtype=DTYPES[o_dt][2])
    assert got.dtype == DTYPES[o_dt][1]
    np.testing.assert_array_equal(_bits(bridge.params_to_numpy(got)),
                                  _bits(want))


@pytest.mark.parametrize("rows", [8, 24])
@pytest.mark.parametrize("combo", COMBOS[:3], ids="-".join)
def test_plain_version_matches_pallas_kernel_in_interpret_mode(rows, combo):
    a_dt, b_dt, o_dt = combo
    a, b = _inputs(rows * 128, a_dt, b_dt, rows)
    want = add_accum_2d(jnp.asarray(a).reshape(rows, 128),
                        jnp.asarray(b).reshape(rows, 128),
                        out_dtype=DTYPES[o_dt][2], interpret=True)
    got = ref.add_accum(bridge.params_from_numpy(a, "cpu"),
                        bridge.params_from_numpy(b, "cpu"),
                        out_dtype=DTYPES[o_dt][1])
    np.testing.assert_array_equal(_bits(bridge.params_to_numpy(got)),
                                  _bits(want).reshape(-1))
    # the reference wrapper (kernel at 8*128-aligned lengths) agrees too
    np.testing.assert_array_equal(
        _bits(jax_ops.add_accum(jnp.asarray(a), jnp.asarray(b),
                                out_dtype=DTYPES[o_dt][2],
                                interpret=True)),
        _bits(want).reshape(-1))


def test_wrapper_refuses_mismatched_inputs():
    a = torch.zeros(8)
    with pytest.raises(ValueError, match="shape"):
        ops.add_accum(a, torch.zeros(9))
    with pytest.raises(ValueError, match="runs on cuda or cpu"):
        ops.add_accum(a.to("meta"), torch.zeros(8, device="meta"))
