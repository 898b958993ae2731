"""repro_torch flash-decode: the plain PyTorch version and the wrapper
against the JAX reference (Pallas kernel in interpret mode and its oracle).

The same seeded numpy inputs go through both packages; fp32 throughout,
so only the summation order differs (rtol 1e-5 / atol 1e-6).  The CUDA
kernel itself runs only on the card (``test_torch_kernels_cuda.py``); here
the wrapper must take the plain version for CPU tensors and never touch the
kernel build.
"""

import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_decode import flash_decode_stats as jax_stats
from repro.kernels.flash_decode import flash_decode as jax_flash_decode
from repro.kernels.flash_decode import ref as jax_ref
from repro.kernels.flash_decode.flash_decode import flash_decode_stats_fwd
from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import ops, ref

RTOL, ATOL = 1e-5, 1e-6


def _inputs(seed, b=2, hq=4, hkv=2, l=256, d=16, valid_p=0.7):
    """q/k/v/valid as numpy; batch row 0 has no valid position at all."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, hq, 1, d).astype(np.float32)
    k = rng.randn(b, hkv, l, d).astype(np.float32)
    v = rng.randn(b, hkv, l, d).astype(np.float32)
    valid = (rng.rand(b, l) < valid_p)
    valid[0] = False
    return q, k, v, valid


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _close(got, want, err=""):
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{name} {err}")


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("length", [64, 256, 200])
def test_wrapper_matches_jax_wrapper(group, length):
    """Port wrapper (CPU: plain version, GQA folded) vs the JAX wrapper —
    the Pallas kernel in interpret mode, or its oracle fallback at L=200."""
    q, k, v, valid = _inputs(group * 100 + length, hq=2 * group, hkv=2,
                             l=length)
    want = jax_stats(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     jnp.asarray(valid.astype(np.int32)), interpret=True)
    got = ops.flash_decode_stats(*_t(q, k, v, valid))
    # one-shot sums against the kernel's per-tile sums: reassociating up to
    # L=256 unit-scale fp32 terms moves the last digits by ~sqrt(L)·eps·|v|
    # (about 3e-6), hence atol 1e-5 on acc and l; the max is order-free
    for g, w, name in zip(got, want, ("acc", "m", "l")):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=ATOL if name == "m" else 1e-5,
                                   err_msg=f"{name} group={group} L={length}")


@pytest.mark.parametrize("group", [1, 2])
@pytest.mark.parametrize("length", [64, 256, 200])
def test_decode_stats_matches_jax_oracle(group, length):
    q, k, v, valid = _inputs(7 + length, hq=2 * group, hkv=2, l=length)
    ke, ve = np.repeat(k, group, 1), np.repeat(v, group, 1)
    want = jax_ref.decode_stats(jnp.asarray(q), jnp.asarray(ke),
                                jnp.asarray(ve), jnp.asarray(valid))
    _close(ref.decode_stats(*_t(q, ke, ve, valid)), want)


@pytest.mark.parametrize("length,block_k", [(128, 128), (256, 128),
                                            (256, 64)])
def test_blockwise_matches_pallas_interpret(length, block_k):
    """The online-softmax loop, tile for tile, against the Pallas kernel."""
    q, k, v, valid = _inputs(3, hq=4, hkv=4, l=length)
    want = flash_decode_stats_fwd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v),
                                  jnp.asarray(valid.astype(np.int32)),
                                  block_k=block_k, interpret=True)
    _close(ref.decode_stats_blockwise(*_t(q, k, v, valid), block_k=block_k),
           want)


def test_all_invalid_row_stays_finite():
    """A row with no valid key scores NEG_INF everywhere: m = -1e30, every
    position weighs 1 — finite garbage, exactly as in the reference."""
    q, k, v, valid = _inputs(11, l=64)
    acc, m, l = ops.flash_decode_stats(*_t(q, k, v, valid))
    assert torch.all(m[0] == ref.NEG_INF)
    assert torch.all(l[0] == 64.0)
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()
    want = jax_ref.decode_stats(jnp.asarray(q), jnp.asarray(np.repeat(k, 2, 1)),
                                jnp.asarray(np.repeat(v, 2, 1)),
                                jnp.asarray(valid))
    _close((acc, m, l), want)


def test_three_way_split_recombines_to_the_full_softmax():
    q, k, v, valid = _inputs(5, l=192)
    qt, kt, vt, validt = _t(q, k, v, valid)
    parts = [ops.flash_decode_stats(qt, kt[:, :, i * 64:(i + 1) * 64],
                                    vt[:, :, i * 64:(i + 1) * 64],
                                    validt[:, i * 64:(i + 1) * 64])
             for i in range(3)]
    jparts = [jax_stats(jnp.asarray(q), jnp.asarray(k[:, :, i * 64:(i + 1) * 64]),
                        jnp.asarray(v[:, :, i * 64:(i + 1) * 64]),
                        jnp.asarray(valid[:, i * 64:(i + 1) * 64]),
                        block_k=64, interpret=True)
              for i in range(3)]
    got = ref.combine(parts)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref.combine(jparts)),
                               rtol=RTOL, atol=ATOL)
    full = jax_ref.decode_attention(jnp.asarray(q),
                                    jnp.asarray(np.repeat(k, 2, 1)),
                                    jnp.asarray(np.repeat(v, 2, 1)),
                                    jnp.asarray(valid), splits=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(full), rtol=2e-5,
                               atol=2e-6)
    port_full = ref.decode_attention(qt, torch.repeat_interleave(kt, 2, 1),
                                     torch.repeat_interleave(vt, 2, 1),
                                     validt, splits=3)
    np.testing.assert_allclose(port_full.numpy(), np.asarray(full),
                               rtol=2e-5, atol=2e-6)


def test_flash_decode_output_matches_jax():
    q, k, v, valid = _inputs(9, l=128)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                            jnp.asarray(valid.astype(np.int32)),
                            interpret=True)
    got = ops.flash_decode(*_t(q, k, v, valid))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-6)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """CPU tensors take the plain version: no build, no launch counted."""
    def no_build(*a, **k):
        raise AssertionError("the CUDA kernel was built for CPU tensors")

    monkeypatch.setattr(_build, "load", no_build)
    before = ops.LAUNCHES
    q, k, v, valid = _inputs(1, l=208, d=64)
    ops.flash_decode_stats(*_t(q, k, v, valid))
    ops.flash_decode(*_t(q, k, v, valid))
    assert ops.LAUNCHES == before


@pytest.mark.parametrize("case", ["q_seq", "kv_shape", "group", "valid"])
def test_wrapper_rejects_bad_shapes(case):
    q, k, v, valid = _t(*_inputs(2, l=64))
    if case == "q_seq":
        q = torch.cat([q, q], dim=2)
    elif case == "kv_shape":
        v = v[:, :, :32]
    elif case == "group":
        q = q[:, :3]
    else:
        valid = valid[:, :32]
    with pytest.raises(ValueError):
        ops.flash_decode_stats(q, k, v, valid)


@pytest.mark.parametrize("args,want", [
    # (B, Hq, Hkv, L, D, K/V itemsize, SMs) -> (route, heads per warp,
    # head warps, head chunks, cluster CTAs); an H100 has 132 SMs
    # the serve path: 4 x 8 (b, kv head) pairs, 4 tiles of 64 bf16 rows
    ((4, 32, 8, 208, 64, 2, 132), ("mma", 4, 1, 1, 4)),
    # long context: 256 tiles, 132 // 32 = 4 CTAs per cluster
    ((4, 32, 8, 16384, 64, 2, 132), ("mma", 4, 1, 1, 4)),
    # the old expanded shape: 128 pairs fill the card, clusters of one
    ((4, 32, 32, 208, 64, 2, 132), ("mma", 1, 1, 1, 1)),
    # one kv head for 32 q heads: two CTAs of 16 (the mma tile's rows)
    ((4, 32, 1, 16384, 64, 2, 132), ("mma", 16, 1, 2, 8)),
    # one key: one tile, a cluster of one
    ((4, 32, 8, 1, 64, 2, 132), ("mma", 4, 1, 1, 1)),
    # groups that do not fit one CTA: 64 and 24 q heads per kv head, and a
    # prime group of 17
    ((2, 64, 1, 4096, 64, 2, 132), ("mma", 16, 1, 4, 8)),
    ((2, 24, 1, 300, 128, 2, 132), ("mma", 12, 1, 2, 8)),
    ((1, 17, 1, 100, 64, 2, 132), ("mma", 1, 1, 17, 2)),
    # fp32 K/V: 8 warps in head groups; 12 = 4 x 3 and an odd group of 3
    ((1, 12, 1, 4096, 128, 4, 132), ("simt", 4, 1, 3, 8)),
    ((2, 6, 2, 100, 16, 4, 132), ("simt", 1, 1, 3, 1)),
    ((4, 32, 1, 208, 64, 4, 132), ("simt", 4, 8, 1, 7)),   # 7 tiles of 32
    # fp32 at D = 128: 16 rows a tile, 9 tiles
    ((4, 8, 2, 131, 128, 4, 132), ("simt", 4, 1, 1, 8)),
    # a card with fewer SMs than pairs: clusters of one
    ((4, 32, 8, 16384, 64, 2, 16), ("mma", 4, 1, 1, 1)),
    ((4, 32, 8, 16384, 64, 2, 24), ("mma", 4, 1, 1, 1))])
def test_launch_shape_is_pinned(args, want):
    assert ops.launch_shape(*args) == want


def test_launch_shape_holds_every_group():
    """Every group splits exactly over its CTAs' heads and chunks, in the
    shapes each route takes; a cluster is 1 to 8 CTAs, no more than the
    key axis has tiles, and its grid stays within one CTA per SM unless
    one CTA per pair already exceeds it."""
    for group, hkv, b, length, d, size in itertools.product(
            range(1, 70), (1, 3, 8), (1, 4), (1, 63, 64, 65, 5000),
            ops.HEAD_DIMS, (2, 4)):
        route, hc, hw, chunks, splits = ops.launch_shape(
            b, group * hkv, hkv, length, d, size, 132)
        if size == 2:
            assert route == "mma" and 1 <= hc <= ops.MMA_HEADS and hw == 1
        else:
            assert route == "simt" and hc in (1, 2, 4)
            assert hw in (1, 2, 4, 8)
        assert hc * hw * chunks == group
        tiles = -(-length // (ops.TILE_BYTES // (d * size)))
        assert 1 <= splits <= min(ops.MAX_CLUSTER, tiles)
        pairs = b * hkv * chunks
        assert pairs * splits <= max(132, pairs)
