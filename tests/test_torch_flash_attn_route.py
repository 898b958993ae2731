"""repro_torch flash attention's route and work count, on the CPU.

``ops.route`` chooses the kernel ``flash_attention`` launches for CUDA
tensors from dtype, shape, strides and ``data_ptr()`` alone, so the rule is
held here on CPU-built tensors of each layout: bf16 whose base address and
batch/head/sequence strides TMA takes goes to ``"wgmma"``, everything else
to ``"mma"``; ``ops._rows_aligned16`` decides whether the "mma" kernel
moves K/V tiles in 16-byte copies.  ``ops.attention_flops``, what the
card's bound is counted from, is held against a brute-force count of the
(query, key) pairs the plain version's mask admits.
"""

import pytest
import torch

from repro_torch.kernels.flash_attn import flash_attention, ops, ref

BF16 = torch.bfloat16


def _admitted(s, causal, window):
    """(query, key) pairs the plain version's mask admits, counted one by
    one."""
    i = torch.arange(s)[:, None]
    j = torch.arange(s)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    return int(mask.sum())


@pytest.mark.parametrize("s", [1, 2, 7, 64, 129])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("window", [None, 1, 3, 64, 500])
def test_attention_flops_counts_admitted_pairs(s, causal, window):
    b, hq, d = 2, 3, 16
    assert ops.attention_flops(b, hq, s, d, causal=causal, window=window) \
        == 4 * b * hq * d * _admitted(s, causal, window)


def test_attention_flops_at_the_prefill_layer_shape():
    """q (1, 32, 32768, 64) causal: 4.398e12 FLOP, 4.447 ms at the H100's
    989 TFLOP/s dense bf16."""
    flops = ops.attention_flops(1, 32, 32768, 64, causal=True)
    assert flops == 4 * 32 * 64 * 32768 * 32769 // 2 == 4_398_180_728_832
    assert round(flops / 989e12 * 1e3, 3) == 4.447


def _bf16(*shape):
    return torch.zeros(shape, dtype=BF16)


def test_route_takes_aligned_bf16_to_wgmma():
    q, kv = _bf16(2, 4, 64, 64), _bf16(2, 2, 64, 64)
    assert ops.route(q, kv, kv) == "wgmma"
    # the model's head split: views of (B, S, H, D) projections
    x = _bf16(2, 130, 12, 64)
    q, k, v = (x[:, :, :8].transpose(1, 2), x[:, :, 8:10].transpose(1, 2),
               x[:, :, 10:].transpose(1, 2))
    assert ops.route(q, k, v) == "wgmma"


def test_route_takes_fp32_to_mma():
    q, kv = torch.zeros(2, 4, 64, 64), torch.zeros(2, 2, 64, 64)
    assert ops.route(q, kv, kv) == "mma"


def test_route_takes_a_260_element_sequence_stride_to_mma():
    """A head view of a (B, S, 4*64 + 4) projection: 520 bytes between rows,
    not a multiple of 16."""
    x = _bf16(1, 64, 4 * 64 + 4)
    heads = x[..., :256].unflatten(-1, (4, 64)).transpose(1, 2)
    assert heads.stride(2) == 260
    assert ops.route(heads, heads[:, :2], heads[:, :2]) == "mma"
    aligned = _bf16(1, 2, 64, 64)
    assert ops.route(aligned.repeat(1, 2, 1, 1), aligned, heads[:, :2]) \
        == "mma"


def test_route_takes_a_base_2_bytes_past_alignment_to_mma():
    q = _bf16(1, 2, 64, 64)
    flat = _bf16(64 * 64 + 1)
    k = flat[1:].view(1, 1, 64, 64)
    assert k.data_ptr() % 16 == 2
    assert ops.route(q, k, k.clone()) == "mma"
    assert ops.route(q, k.clone(), k.clone()) == "wgmma"


def test_route_ignores_strides_of_length_1_axes():
    """B = Hkv = 1 and S = 1 with odd strides on those axes: never read, so
    the wgmma route takes them and the kernel is given one row of D."""
    base = _bf16(64 * 64 * 8)
    k = base.as_strided((1, 1, 64, 64), (7, 3, 64, 1))
    q = base.as_strided((1, 4, 64, 64), (5, 64 * 64, 64, 1))
    assert ops.route(q, k, k) == "wgmma"
    assert ops._tma_strides(k) == [64, 64, 64]
    assert ops._tma_strides(q) == [64, 64 * 64, 64]
    one = base.as_strided((2, 4, 1, 64), (4 * 64, 64, 3, 1))
    assert ops.route(one, one[:, :2], one[:, :2]) == "wgmma"
    assert ops._tma_strides(one) == [4 * 64, 64, 64]


def test_route_takes_a_zero_stride_head_axis_to_mma():
    """kv heads broadcast with ``expand`` (stride 0 on an axis of length 2):
    TMA's strides must be positive."""
    q = _bf16(1, 4, 64, 64)
    kv = _bf16(1, 1, 64, 64).expand(1, 2, 64, 64)
    assert ops.route(q, kv, kv) == "mma"


def _rows_cases():
    """(tensor, whether every row starts 16-byte aligned)."""
    proj = torch.zeros(1, 64, 4 * 64 + 4)      # fp32: 1040 bytes a row
    bf_proj = proj.to(BF16)                    # bf16: 520 bytes a row
    flat = torch.zeros(2 * 64 * 64 + 1)
    return [
        (torch.zeros(2, 4, 64, 64), True),
        (_bf16(2, 4, 64, 64), True),
        (proj[..., :256].unflatten(-1, (4, 64)).transpose(1, 2), True),
        (bf_proj[..., :256].unflatten(-1, (4, 64)).transpose(1, 2), False),
        (flat[1:].view(1, 2, 64, 64), False),       # 4 bytes past
        (flat[4:4 + 64 * 64].view(1, 1, 64, 64), True),   # 16 bytes past
        (torch.zeros(1, 1, 64, 64).expand(1, 2, 64, 64), True),  # stride 0
        (torch.zeros(64 * 64 * 8).as_strided((1, 1, 64, 16), (7, 3, 64, 1)),
         True),                                     # odd strides, length 1
        (torch.zeros(64 * 64).as_strided((1, 2, 64, 16), (0, 18, 16, 1)),
         False),                                    # 72 bytes between heads
    ]


@pytest.mark.parametrize("case", range(len(_rows_cases())))
def test_rows_aligned16(case):
    t, want = _rows_cases()[case]
    assert ops._rows_aligned16(t) is want


def test_route_refuses_other_devices():
    q = _bf16(1, 2, 64, 64)
    meta = torch.empty((1, 2, 64, 64), dtype=BF16, device="meta")
    with pytest.raises(ValueError, match="one cuda or cpu device"):
        ops.route(meta, meta, meta)
    with pytest.raises(ValueError, match="one cuda or cpu device"):
        ops.route(q, meta, q)


def test_cpu_tensors_run_the_plain_version_on_no_route():
    """On the CPU ``flash_attention`` is ``ref.attention``, whatever the
    layout would be routed to on the card."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn((1, 4, 96, 64), generator=gen).to(BF16)
    kv = torch.randn((1, 2, 96, 64), generator=gen).to(BF16)
    assert ops.route(q, kv, kv) == "wgmma"
    launches, by_route = ops.LAUNCHES, dict(ops.LAUNCHES_BY_ROUTE)
    got = flash_attention(q, kv, kv, window=32)
    assert (ops.LAUNCHES, ops.LAUNCHES_BY_ROUTE) == (launches, by_route)
    assert torch.equal(got, ref.attention(q, kv, kv, window=32))
