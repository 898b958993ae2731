"""repro_torch int8 codec and arena kernels on the card: ``quantize`` /
``dequantize`` and ``write_quant`` / ``read_dequant`` against their plain
PyTorch versions on the same card inputs, bitwise (NaN where the plain
version has NaN: inputs hold a zero block with -0.0 in it, a NaN block and
an inf block), and run to run.

Marked ``cuda``; without a card every test skips (a CUDA kernel has no CPU
mode).  The file imports no JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_quant_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.pack_quant import ops as pq
from repro_torch.kernels.pack_quant import ref as pq_ref
from repro_torch.kernels.quant import ops as q
from repro_torch.kernels.quant import ref as q_ref


def _nonfinite(x, block):
    """A NaN in the second block and an inf in the third, where they
    exist."""
    if x.numel() >= 3 * block:
        x[block + 5] = float("nan")
        x[2 * block + 3] = float("-inf")


def _equal(a, b):
    """Bit for bit, NaN included."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.fixture
def cuda_device():
    """The card; decided at run time, never at collection, so every test
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("block", [512, 128, 96, 1024])
@pytest.mark.parametrize("n_blocks", [1, 7, 4099])
def test_codec_kernels_match_plain_versions_bitwise(cuda_device, block,
                                                     n_blocks):
    gen = torch.Generator(device=cuda_device).manual_seed(block + n_blocks)
    x = torch.randn(block * n_blocks, generator=gen, device=cuda_device) * 3
    x[:block] = 0.0                                    # a zero block,
    x[1:block:2] = -0.0                                # -0.0 in it
    _nonfinite(x, block)
    before = dict(q.LAUNCHES)
    got, again = q.quantize(x, block), q.quantize(x, block)
    back = q.dequantize(*got, block)
    torch.cuda.synchronize(cuda_device)
    assert q.LAUNCHES == {"quantize": before["quantize"] + 2,
                          "dequantize": before["dequantize"] + 1}
    want = q_ref.quantize(x, block)
    for g, a, w in zip(got, again, want):
        assert _equal(g, a) and _equal(g, w)
    assert _equal(back, q_ref.dequantize(*want, block))
    if n_blocks >= 3:
        assert got[1][1].isnan() and got[1][2].isinf()
        assert back[block:3 * block].isnan().all()


@pytest.mark.cuda
@pytest.mark.parametrize("block,offset,n_blocks", [
    (512, 0, 7), (512, 2**21, 4000), (128, 3 * 128, 500), (96, 96 * 5, 33)])
@pytest.mark.parametrize("fused_ef", [False, True])
def test_arena_kernels_match_plain_versions_bitwise(cuda_device, block,
                                                    offset, n_blocks,
                                                    fused_ef):
    gen = torch.Generator(device=cuda_device).manual_seed(offset + block)
    n = block * n_blocks
    scale_offset = 2**22
    arena = torch.randint(-100, 100, (scale_offset + 2**21,), generator=gen,
                          device=cuda_device, dtype=torch.int8)
    src = torch.randn(n, generator=gen, device=cuda_device) * 2
    src[:block] = 0.0
    src[1:block:2] = -0.0
    _nonfinite(src, block)
    ef = torch.randn(n, generator=gen, device=cuda_device) * 0.01
    want_arena, want_ef = arena.clone(), ef.clone()
    pq_ref.write_quant_flat(want_arena, src, offset, scale_offset, block,
                            want_ef if fused_ef else None)
    ptr = arena.data_ptr()
    before = dict(pq.LAUNCHES)
    got = pq.write_quant_flat(arena, src, offset, scale_offset, block,
                              ef if fused_ef else None)
    read = pq.read_dequant_flat(got, offset, n, scale_offset, block)
    torch.cuda.synchronize(cuda_device)
    assert got.data_ptr() == ptr                        # in place
    assert pq.LAUNCHES == {"write": before["write"] + 1,
                           "read": before["read"] + 1}
    assert torch.equal(got, want_arena)
    assert _equal(ef, want_ef)
    assert _equal(read, pq_ref.read_dequant_flat(want_arena, offset, n,
                                                 scale_offset, block))
    if n_blocks >= 3:
        assert read[block:3 * block].isnan().all()


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda_device):
    x = torch.randn(1024, device=cuda_device)
    with pytest.raises(TypeError):
        q.quantize(x.to(torch.bfloat16), 512)
    with pytest.raises(ValueError, match="contiguous"):
        q.quantize(torch.randn(2048, device=cuda_device)[::2], 512)
    arena = torch.zeros(2**22, dtype=torch.int8, device=cuda_device)
    with pytest.raises(ValueError, match="multiple of block"):
        pq.write_quant_flat(arena, x, 256, 2**21, 512)
    n = q.LAUNCHES["quantize"]
    q.quantize(x[:0], 512)                    # empty: no launch
    assert q.LAUNCHES["quantize"] == n
