"""repro_torch arena pack/unpack against the JAX reference: the port's
plain write/read (what the wrappers run for CPU tensors) against
``repro.kernels.pack.ref`` and the Pallas kernels in interpret mode, at
page-aligned and unaligned offsets and sizes and with an fp32 source into
a bf16 arena; the port's ``CommArena`` against the reference's on the same
layout.  Copies are exact: bitwise."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.pack import ops as jax_ops
from repro.kernels.pack import ref as jax_ref
from repro.mem.arena import CommArena as JaxArena
from repro.mem.layout import plan_arena as jax_plan_arena
from repro_torch import bridge
from repro_torch.kernels.pack import ops, ref
from repro_torch.mem.arena import CommArena
from repro_torch.mem.layout import plan_arena

BF16 = np.dtype(ml_dtypes.bfloat16)
TOTAL = 16 * 1024


def _bits(x):
    x = np.asarray(x)
    return x.view(np.uint16 if x.dtype.itemsize == 2 else np.uint32)


def _t(a):
    return bridge.params_from_numpy(a, "cpu")


@pytest.mark.parametrize("offset,size", [(0, 4096), (8192, 2048),
                                         (4096, 8 * 1024), (13, 1000),
                                         (1024, 7)])
@pytest.mark.parametrize("arena_dt,src_dt", [(np.float32, np.float32),
                                             (BF16, BF16),
                                             (BF16, np.float32)])
def test_write_and_read_match_reference(offset, size, arena_dt, src_dt):
    rng = np.random.RandomState(offset + size)
    arena = rng.randn(TOTAL).astype(np.float32).astype(arena_dt)
    src = (rng.randn(size) * 5).astype(np.float32).astype(src_dt)
    t_arena = _t(arena)
    ptr = t_arena.data_ptr()
    before = dict(ops.LAUNCHES)
    out = ops.write_flat(t_arena, _t(src), offset)
    assert out is t_arena and out.data_ptr() == ptr      # in place
    want = jax_ref.write_flat(jnp.asarray(arena), jnp.asarray(src), offset)
    np.testing.assert_array_equal(_bits(bridge.params_to_numpy(out)),
                                  _bits(want))
    # the reference wrapper: the Pallas kernel where it tiles, else oracle
    np.testing.assert_array_equal(
        _bits(jax_ops.write_flat(jnp.asarray(arena), jnp.asarray(src),
                                 offset, interpret=True)), _bits(want))
    got = ops.read_flat(out, offset, size)
    assert got.data_ptr() != out.data_ptr()              # a fresh copy
    np.testing.assert_array_equal(
        _bits(bridge.params_to_numpy(got)),
        _bits(jax_ops.read_flat(want, offset, size, interpret=True)))
    assert ops.LAUNCHES == before           # CPU tensors: no kernel launch


def test_plain_read_does_not_alias_the_arena():
    arena = torch.arange(16, dtype=torch.float32)
    got = ref.read_flat(arena, 4, 4)
    ref.write_flat(arena, torch.zeros(4), 4)
    assert got.tolist() == [4.0, 5.0, 6.0, 7.0]


def test_wrappers_refuse_out_of_range_copies():
    arena = torch.zeros(16)
    with pytest.raises(ValueError, match="outside"):
        ops.write_flat(arena, torch.zeros(8), 12)
    with pytest.raises(ValueError, match="outside"):
        ops.read_flat(arena, 10, 8)


@pytest.mark.parametrize("impl", ["kernel", "plain"])
def test_comm_arena_matches_reference_arena(impl):
    sizes = [3000, 128, 70000, 1024]
    kw = dict(page_bytes=4096, channel_of=[0, 1, 0, 1], pad_multiple=128)
    jlay = jax_plan_arena(sizes, dtype=jnp.float32, **kw)
    lay = plan_arena(sizes, dtype=torch.float32, **kw)
    assert lay.describe() == jlay.describe()
    rng = np.random.RandomState(0)
    bufs = [rng.randn(n).astype(np.float32) for n in sizes]
    jarena = JaxArena(jlay, impl="pallas")
    want_buf = jarena.pack([jnp.asarray(b) for b in bufs])
    arena = CommArena(lay, impl=impl)
    buf = arena.zeros("cpu")
    ptr = buf.data_ptr()
    got_buf = arena.pack_into(buf, [_t(b) for b in bufs])
    assert got_buf.data_ptr() == ptr
    np.testing.assert_array_equal(got_buf.numpy(), np.asarray(want_buf))
    for got, want in zip(arena.unpack(got_buf), jarena.unpack(want_buf)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    spans = [got_buf[sp.offset:sp.offset + sp.size] for sp in lay.spans]
    for got, want in zip(arena.unpack_spans(spans), bufs):
        np.testing.assert_array_equal(got.numpy(), want)
