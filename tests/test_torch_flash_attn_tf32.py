"""The "mma" route's arithmetic, modelled on the CPU, against the JAX
reference.

``csrc/flash_attn.cu`` forms q.k and p.v on TF32 tensor cores from fp32
operands split into big and small TF32 halves (3xTF32).  ``ref.split_tf32``
models ``cvt.rna.tf32.f32`` on hand-picked bit patterns, and
``ref.attention_tf32_split`` the whole scheme: with three terms it is held
within the reference's fp32 tolerance (rtol/atol 2e-5) of the Pallas kernel
in interpret mode and of its oracle, at ``tests/test_torch_flash_attn.py``'s
shapes plus D=128 and a window without the causal mask; with one term
(plain TF32) it misses that tolerance, so the tolerance tells the two
schemes apart.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn import ref as jax_ref
from repro.kernels.flash_attn.flash_attn import flash_attention_fwd
from repro_torch.kernels.flash_attn import ref

TOL = 2e-5     # the reference's fp32 tolerance (tests/test_kernels.py)

SHAPES = [(256, 4, 2, 64), (128, 2, 2, 32), (256, 8, 1, 64),
          (128, 4, 2, 128)]
MASKS = [(True, None), (True, 64), (False, None), (False, 100)]


def _bits(*words):
    return torch.tensor(np.array(words, dtype=np.uint32).view(np.int32))


def _floats(*words):
    return _bits(*words).view(torch.float32)


def _words(x):
    return [w & 0xFFFFFFFF for w in x.view(torch.int32).tolist()]


@pytest.mark.parametrize("word,big,small", [
    (0x3F800000, 0x3F800000, 0x00000000),   # 1.0: exact
    (0x3F801000, 0x3F802000, 0xBA000000),   # 1 + 2^-11: a tie, away
    (0xBF801000, 0xBF802000, 0x3A000000),   # its negative: away from 0
    (0x3F800FFF, 0x3F800000, 0x3A000000),   # just below the tie: down
    (0x3F803000, 0x3F804000, 0xBA000000),   # a tie above an odd tf32
    (0x3FFFFFFF, 0x40000000, 0xB4000000),   # carries into the exponent
    (0x00001000, 0x00002000, 0x80002000),   # a subnormal tie
    (0x00000FFF, 0x00000000, 0x00000000),   # a subnormal rounds to 0
    (0x807FFFFF, 0x80800000, 0x00000000),   # largest subnormal, negative
    (0x7F800000, 0x7F800000, None),         # inf stays (small: inf - inf)
])
def test_split_tf32_on_bit_patterns(word, big, small):
    b, s = ref.split_tf32(_floats(word))
    assert _words(b) == [big]
    if small is not None:
        assert _words(s) == [small]
        # big + small is x to 2^-22 relative where x is normal (below
        # that the small half falls among TF32's subnormals)
        x = float(np.array([word], np.uint32).view(np.float32)[0])
        if abs(x) >= 2.0 ** -126:
            assert abs(x - float(b) - float(s)) <= abs(x) * 2.0 ** -22


def test_split_tf32_keeps_nan():
    b, s = ref.split_tf32(torch.tensor([float("nan"), -float("nan")]))
    assert torch.isnan(b).all() and torch.isnan(s).all()


def test_split_tf32_small_half_of_widened_bf16_is_zero():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(4096).astype(np.float32) * 100)
    widened = x.to(torch.bfloat16).float()
    big, small = ref.split_tf32(widened)
    assert torch.equal(big, widened)
    assert not small.any()
    big, small = ref.split_tf32(x)             # fp32 itself has a small half
    assert small.any()
    assert not (_bits(*_words(big)) & 0x1FFF).any()
    assert not (_bits(*_words(small)) & 0x1FFF).any()
    err = (x.double() - big.double() - small.double()).abs()
    assert (err <= x.double().abs() * 2.0 ** -22).all()


def _qkv(seed, b, hq, hkv, s, d, qk_scale=0.3):
    rng = np.random.RandomState(seed)
    q = (rng.randn(b, hq, s, d) * qk_scale).astype(np.float32)
    k = (rng.randn(b, hkv, s, d) * qk_scale).astype(np.float32)
    v = rng.randn(b, hkv, s, d).astype(np.float32)
    return q, k, v


def _wants(q, k, v, causal, window):
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = flash_attention_fwd(jq, jk, jv, causal=causal, window=window,
                                 block_q=128, block_k=128, interpret=True)
    oracle = jax_ref.attention(jq, jk, jv, causal=causal, window=window)
    return np.asarray(pallas), np.asarray(oracle)


@pytest.mark.parametrize("s,hq,hkv,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_three_tf32_terms_match_reference_kernel_and_oracle(s, hq, hkv, d,
                                                           causal, window):
    q, k, v = _qkv(s + hq + d, 2, hq, hkv, s, d)
    got = ref.attention_tf32_split(*map(torch.from_numpy, (q, k, v)),
                                   causal=causal, window=window,
                                   terms=3).numpy()
    for want in _wants(q, k, v, causal, window):
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_one_tf32_term_misses_the_tolerance():
    """Plain TF32 (every operand rounded once to 10 mantissa bits) is
    outside rtol/atol 2e-5 of the reference on the causal cases of the
    grid above: the tolerance can tell it from the 3xTF32 scheme."""
    misses = []
    for s, hq, hkv, d in SHAPES:
        q, k, v = _qkv(s + hq + d, 2, hq, hkv, s, d)
        got = ref.attention_tf32_split(*map(torch.from_numpy, (q, k, v)),
                                       causal=True, terms=1).numpy()
        _, oracle = _wants(q, k, v, True, None)
        misses.append(not np.allclose(got, oracle, rtol=TOL, atol=TOL))
    assert any(misses), "one TF32 term passed the fp32 tolerance everywhere"


def test_bf16_inputs_lose_nothing_to_the_split():
    """bf16 q/k/v: their small halves are 0 (the kernel drops those
    products at compile time); the output, cast to bf16, agrees with the
    reference's oracle at the bf16 tolerance."""
    rng = np.random.RandomState(1)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 64).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    got = ref.attention_tf32_split(q, k, v)
    assert got.dtype == torch.bfloat16
    for x in (q, k, v):
        assert not ref.split_tf32(x)[1].any()
    want = jax_ref.attention(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                               for x in (q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=3e-2)


def test_terms_other_than_one_or_three_raise():
    q = torch.zeros(1, 1, 8, 16)
    with pytest.raises(ValueError, match="terms"):
        ref.attention_tf32_split(q, q, q, terms=2)
