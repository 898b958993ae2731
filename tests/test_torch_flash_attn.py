"""repro_torch flash attention's plain version against the JAX reference,
on the CPU.

``flash_attention`` on CPU tensors runs ``ref.attention``; it is held
against the reference's oracle (``repro.kernels.flash_attn.ref``) and its
Pallas kernel in interpret mode, at ``tests/test_kernels.py``'s shapes and
tolerances (2e-5 at fp32, 3e-2 at bf16; GQA, a window, non-causal).  A
ragged S (the Pallas kernel does not tile it) and Sq != Sk (the oracle's
end-aligned positions) are held against the oracle only.  The wrapper's
refusals hold on the CPU as on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ref as jax_ref
from repro.kernels.flash_attn.flash_attn import flash_attention_fwd
from repro_torch.kernels.flash_attn import flash_attention, ops, ref


def _qkv(seed, b, hq, hkv, sq, sk, d, qk_scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, hq, sq, d) * qk_scale).astype(np.float32)
    k = (rng.randn(b, hkv, sk, d) * qk_scale).astype(np.float32)
    v = rng.randn(b, hkv, sk, d).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize("sq,sk,hq,hkv,d", [
    (256, 256, 4, 2, 64), (128, 128, 2, 2, 32), (256, 256, 8, 1, 64),
])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_plain_version_matches_reference_kernel_and_oracle(sq, sk, hq, hkv, d,
                                                           causal, window):
    q, k, v = _qkv(sq + hq, 2, hq, hkv, sq, sk, d)
    launches = ops.LAUNCHES
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window).numpy()
    assert ops.LAUNCHES == launches          # CPU: plain version, no launch
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                                 block_q=128, block_k=128, interpret=True)
    oracle = jax_ref.attention(jq, jk, jv, causal=causal, window=window)
    for want in (pallas, oracle):
        np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5,
                                   atol=2e-5)


def test_plain_version_bf16_matches_reference():
    rng = np.random.RandomState(0)
    q, k, v = (jnp.asarray(rng.randn(1, 2, 128, 64), jnp.bfloat16)
               for _ in range(3))
    got = flash_attention(*(torch.from_numpy(np.asarray(x, np.float32))
                            .to(torch.bfloat16) for x in (q, k, v)))
    assert got.dtype == torch.bfloat16
    for want in (flash_attention_fwd(q, k, v, interpret=True),
                 jax_ref.attention(q, k, v)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=3e-2)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_ragged_length_matches_oracle(causal, window):
    """S = 200 does not tile by 128: the reference's wrapper would fall back
    to its oracle; the port's kernel masks the ragged tile itself."""
    q, k, v = _qkv(200, 2, 4, 2, 200, 200, 64)
    got = flash_attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                          window=window).numpy()
    want = jax_ref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
def test_plain_version_keeps_end_alignment_when_sq_differs(causal, window):
    q, k, v = _qkv(7, 2, 4, 2, 128, 256, 32)
    got = ref.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window, block_q=48).numpy()
    want = jax_ref.attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                             window=window)
    np.testing.assert_allclose(got, np.asarray(want), rtol=2e-5, atol=2e-5)


def test_query_blocks_do_not_change_the_plain_version():
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 8, 2, 100, 100, 16))
    whole = ref.attention(q, k, v, window=30)
    for block_q in (1, 7, 64, 100):
        torch.testing.assert_close(ref.attention(q, k, v, window=30,
                                                 block_q=block_q), whole,
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 30),
                                           (False, None)])
def test_plain_version_computes_fp64_inputs_in_fp64(causal, window):
    """fp64 inputs (the card checks' yardstick) stay fp64 throughout: within
    1e-12 of the softmax written out in numpy fp64, where the fp32 plain
    version is only within 2e-5."""
    q, k, v = (x.astype(np.float64) for x in _qkv(9, 2, 4, 2, 100, 100, 32))
    got = ref.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                        window=window, block_q=48)
    assert got.dtype == torch.float64
    kr, vr = (np.repeat(x, 2, axis=1) for x in (k, v))
    s = np.einsum("bhqd,bhkd->bhqk", q, kr) / np.sqrt(32)
    pos = np.arange(100)
    ok = np.ones((100, 100), bool)
    if causal:
        ok &= pos[None, :] <= pos[:, None]
    if window is not None:
        ok &= pos[None, :] > pos[:, None] - window
    p = np.exp(np.where(ok, s, -np.inf) - s.max(-1, keepdims=True))
    want = np.einsum("bhqk,bhkd->bhqd", p / p.sum(-1, keepdims=True), vr)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-12, atol=1e-12)
    got32 = ref.attention(*(torch.from_numpy(x).float() for x in (q, k, v)),
                          causal=causal, window=window).double().numpy()
    np.testing.assert_allclose(got32, want, rtol=2e-5, atol=2e-5)
    assert np.abs(got32 - want).max() > 1e-12


def test_wrapper_refuses_what_the_kernel_does_not_compute():
    q, k, v = map(torch.from_numpy, _qkv(2, 1, 4, 2, 64, 64, 16))
    with pytest.raises(ValueError, match="Sq == Sk"):
        flash_attention(q[:, :, :32], k, v)
    with pytest.raises(ValueError, match="chunked"):
        flash_attention(q, k, v, chunk=32)
    with pytest.raises(ValueError, match="window"):
        flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(q[:, :3], k, v)
    for i in range(3):
        args = [q.clone(), k.clone(), v.clone()]
        args[i].requires_grad_()
        with pytest.raises(RuntimeError, match="no backward"):
            flash_attention(*args)
    with pytest.raises(ValueError, match="cuda or cpu"):
        flash_attention(q.to("meta"), k.to("meta"), v.to("meta"))
