"""repro_torch flash-attention kernels on the card: each against its plain
PyTorch version on the same card inputs (causal, windowed and non-causal
masks; GQA; ragged S and the bf16 kernel's tile boundaries; fp32 through
the TF32 mma kernel, bf16 through the wgmma kernel, counted by route), run
to run bitwise, bf16 layouts TMA cannot take and fp32 k/v rows off 16-byte
alignment on the mma route, a row that meets a wholly masked key tile
first, the fp32 route's distance from fp64 against the plain version's,
and their refusals.

Marked ``cuda``; without a card every test skips (a CUDA kernel has no CPU
mode).  The file imports no JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_flash_attn_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_attn import ops, ref

# the reference's kernel tolerances (tests/test_kernels.py): fp32 2e-5,
# bf16 3e-2 absolute (one bf16 rounding of an O(1) output)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=0.0, atol=3e-2)}
ROUTE = {torch.float32: "mma", torch.bfloat16: "wgmma"}


@pytest.fixture
def cuda_device():
    """The card; decided at run time, never at collection, so every test
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    return torch.device("cuda")


def _qkv(dev, seed, b, hq, hkv, s, d, dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, s, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, s, d), generator=gen, device=dev).to(dtype)
    return q, k, v


@pytest.mark.cuda
@pytest.mark.parametrize("s,hq,hkv,d", [
    (1, 4, 2, 16), (7, 8, 1, 32), (64, 4, 2, 16), (200, 32, 8, 64),
    (256, 8, 1, 128), (1000, 4, 2, 64)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_matches_plain_version(cuda_device, s, hq, hkv,
                                                      d, causal, window,
                                                      dtype):
    q, k, v = _qkv(cuda_device, s + d, 2, hq, hkv, s, d, dtype)
    route = ROUTE[dtype]
    before, by_route = ops.LAUNCHES, dict(ops.LAUNCHES_BY_ROUTE)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(cuda_device)
    assert ops.LAUNCHES == before + 2
    assert ops.LAUNCHES_BY_ROUTE == {**by_route, route: by_route[route] + 2}
    assert got.dtype == dtype and got.shape == q.shape
    assert torch.equal(got, again)                      # run-to-run bitwise
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("s", [127, 128, 129, 255, 256, 257])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 64),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_kernel_at_tile_boundaries(cuda_device, s, d, causal,
                                                   window, dtype):
    """Around the wgmma kernel's 128-row q tiles and its key tiles (128, or
    64 at D=128), where the ragged, diagonal and window masks meet."""
    q, k, v = _qkv(cuda_device, s * d, 2, 8, 2, s, d, dtype)
    by_route = dict(ops.LAUNCHES_BY_ROUTE)
    got = ops.flash_attention(q, k, v, causal=causal, window=window)
    again = ops.flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize(cuda_device)
    route = ROUTE[dtype]
    assert ops.LAUNCHES_BY_ROUTE == {**by_route, route: by_route[route] + 2}
    assert torch.equal(got, again)
    want = ref.attention(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


@pytest.mark.cuda
def test_flash_attention_kernel_takes_strided_heads(cuda_device):
    """q/k/v as head views of (B, S, H, D) projections, as the model's
    head split gives them: same bits as from contiguous copies."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 130, 12, 64), generator=gen, device=cuda_device)
    q, k, v = (x[:, :, :8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2),
               x[:, :, 10:].transpose(1, 2))
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_wgmma_takes_strided_heads(cuda_device):
    """The same head views in bf16, through the wgmma kernel's TMA maps."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    x = torch.randn((2, 130, 12, 64), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    q, k, v = (x[:, :, :8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2),
               x[:, :, 10:].transpose(1, 2))
    by_route = dict(ops.LAUNCHES_BY_ROUTE)
    got = ops.flash_attention(q, k, v)
    want = ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize(cuda_device)
    assert ops.LAUNCHES_BY_ROUTE["wgmma"] == by_route["wgmma"] + 2
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_flash_attention_takes_unaligned_bf16_on_the_mma_route(cuda_device):
    """bf16 layouts TMA cannot take (a 260-element sequence stride; a base
    2 bytes past alignment) launch the mma kernel, chosen before the
    launch, and agree with the plain version."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    x = torch.randn((1, 200, 4 * 64 + 4), generator=gen,
                    device=cuda_device).to(torch.bfloat16)
    heads = x[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    assert heads.stride(2) == 260
    flat = torch.randn(2 * 200 * 64 + 1, generator=gen,
                       device=cuda_device).to(torch.bfloat16)
    shifted = flat[1:].view(1, 2, 200, 64)         # 2 bytes past alignment
    for q, k, v in ((heads, heads[:, :2], heads[:, :2]),
                    (heads.contiguous(), shifted, shifted)):
        assert ops.route(q, k, v) == "mma"
        by_route = dict(ops.LAUNCHES_BY_ROUTE)
        got = ops.flash_attention(q, k, v, window=64)
        torch.cuda.synchronize(cuda_device)
        assert ops.LAUNCHES_BY_ROUTE == {**by_route,
                                         "mma": by_route["mma"] + 1}
        want = ref.attention(q, k, v, window=64)
        torch.testing.assert_close(got.float(), want.float(),
                                   **TOL[torch.bfloat16])


@pytest.mark.cuda
def test_flash_attention_takes_unaligned_fp32_on_the_mma_route(cuda_device):
    """fp32 k/v whose rows are not all 16-byte aligned (a 257-element
    sequence stride; a base 4 bytes past alignment) move in 4-byte copies:
    the mma route, within the fp32 tolerance, bitwise run to run."""
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    x = torch.randn((1, 200, 4 * 64 + 1), generator=gen, device=cuda_device)
    heads = x[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    flat = torch.randn(2 * 200 * 64 + 1, generator=gen, device=cuda_device)
    shifted = flat[1:].view(1, 2, 200, 64)         # 4 bytes past alignment
    for q, k, v in ((heads, heads[:, :2], heads[:, :2]),
                    (heads.contiguous(), shifted, shifted)):
        assert ops.route(q, k, v) == "mma"
        assert not ops._rows_aligned16(k) and not ops._rows_aligned16(v)
        by_route = dict(ops.LAUNCHES_BY_ROUTE)
        got = ops.flash_attention(q, k, v, window=64)
        again = ops.flash_attention(q, k, v, window=64)
        torch.cuda.synchronize(cuda_device)
        assert ops.LAUNCHES_BY_ROUTE == {**by_route,
                                         "mma": by_route["mma"] + 2}
        assert torch.equal(got, again)
        want = ref.attention(q, k, v, window=64)
        torch.testing.assert_close(got, want, **TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [16, 64, 128])
def test_flash_attention_wgmma_row_meets_a_wholly_masked_key_tile_first(
        cuda_device, d):
    """Causal, window 64, S=257: rows 192-255 of the second 128-row q tile
    find key tile 0 wholly outside their window before their first
    admitted key.  Their running max stays at the masked score -1e30 over
    that tile, and the first admitted key's rescale factor clears what it
    summed: the output is finite and agrees with the plain version."""
    q, k, v = _qkv(cuda_device, 257 + d, 1, 4, 2, 257, d, torch.bfloat16)
    by_route = dict(ops.LAUNCHES_BY_ROUTE)
    got = ops.flash_attention(q, k, v, causal=True, window=64)
    torch.cuda.synchronize(cuda_device)
    assert ops.LAUNCHES_BY_ROUTE["wgmma"] == by_route["wgmma"] + 1
    assert torch.isfinite(got).all()
    want = ref.attention(q, k, v, causal=True, window=64)
    torch.testing.assert_close(got[:, :, 192:256].float(),
                               want[:, :, 192:256].float(),
                               **TOL[torch.bfloat16])
    torch.testing.assert_close(got.float(), want.float(),
                               **TOL[torch.bfloat16])


@pytest.mark.cuda
@pytest.mark.parametrize("d,qk_scale,v_mean", [(64, 1.0, 0.0),
                                               (64, 3.0, 1.0),
                                               (128, 3.0, 1.0)])
def test_flash_attention_fp32_is_no_further_from_fp64_than_fp32(
        cuda_device, d, qk_scale, v_mean):
    """S=4096 causal at fp32: the mma kernel's relative L2 distance from
    fp64 at most twice the plain fp32 version's.  The tensor cores' fp32
    sums truncate; chained through every key of a row they bias the
    output by several times the plain version's error, below what the
    elementwise tolerance sees at these output sizes (peaky scores and a
    mean in v show it most)."""
    gen = torch.Generator(device=cuda_device).manual_seed(d)
    q = torch.randn((1, 32, 4096, d), generator=gen, device=cuda_device)
    k = torch.randn((1, 8, 4096, d), generator=gen, device=cuda_device)
    v = torch.randn((1, 8, 4096, d), generator=gen, device=cuda_device)
    q, k, v = q * qk_scale, k * qk_scale, v + v_mean
    assert ops.route(q, k, v) == "mma"
    want = ref.attention(q.double(), k.double(), v.double(),
                         block_q=512)

    def rel(x):
        return ((x.double() - want).norm() / want.norm()).item()

    got = rel(ops.flash_attention(q, k, v))
    plain = rel(ref.attention(q, k, v, block_q=1024))
    assert got <= 2 * plain, (got, plain)


@pytest.mark.cuda
def test_flash_attention_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v = _qkv(cuda_device, 0, 1, 4, 2, 64, 48, torch.float32)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, 0, 1, 4, 2, 64, 64, torch.float16)
    with pytest.raises(TypeError):
        ops.flash_attention(q, k, v)
    q, k, v = _qkv(cuda_device, 0, 1, 4, 2, 64, 64, torch.bfloat16)
    with pytest.raises(TypeError):
        ops.flash_attention(q.float(), k, v)
    with pytest.raises(ValueError, match="contiguous along D"):
        ops.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3),
                            v)
    with pytest.raises(ValueError, match="Sq == Sk"):
        ops.flash_attention(q[:, :, :32], k, v)
    with pytest.raises(ValueError, match="chunked"):
        ops.flash_attention(q, k, v, chunk=32)
    with pytest.raises(RuntimeError, match="no backward"):
        ops.flash_attention(q.requires_grad_(), k, v)
