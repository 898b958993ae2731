"""repro_torch CUDA kernels on the card: each kernel (flash-decode,
reduce_add, pack write/read) against its plain PyTorch version on the same
card inputs, and run-to-run bitwise.  flash-decode also at its GQA and
cluster shapes (one kv head or eight for 32 q heads, L from 1 to 16384,
all-invalid key runs across the cluster's splits); reduce_add also around
one block's tile and at 2^26 + 5 elements.

Marked ``cuda``; without a card every test skips (a CUDA kernel has no CPU
mode).  The file imports no JAX, so it runs where the port runs::

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py
"""

import pytest
import torch

from repro_torch.kernels.flash_decode import ops, ref
from repro_torch.kernels.pack import ops as pk
from repro_torch.kernels.pack import ref as pk_ref
from repro_torch.kernels.reduce_add import ops as ra
from repro_torch.kernels.reduce_add import ref as ra_ref


@pytest.fixture
def cuda_device():
    """The card; decided at run time, never at collection, so every test
    worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False   # plain version in fp32
    return torch.device("cuda")


def _inputs(dev, seed, b, hq, hkv, length, d, dtype, q_dtype):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, hq, 1, d), generator=gen, device=dev).to(q_dtype)
    k = torch.randn((b, hkv, length, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, hkv, length, d), generator=gen, device=dev).to(dtype)
    valid = torch.rand((b, length), generator=gen, device=dev) < 0.8
    valid[1] = False                  # a row with no valid position
    return q, k, v, valid


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,q_dtype,hq,hkv,length", [
    (64, torch.bfloat16, torch.bfloat16, 32, 32, 208),   # serve shape
    (64, torch.bfloat16, torch.bfloat16, 32, 8, 208),    # GQA in the kernel
    (64, torch.bfloat16, torch.bfloat16, 32, 32, 80),    # one ragged tile
    (64, torch.float32, torch.float32, 32, 32, 208),     # fp32 cache
    (16, torch.bfloat16, torch.float32, 16, 2, 200),     # reduced config
    (128, torch.float32, torch.bfloat16, 8, 2, 131)])
def test_flash_decode_kernel_matches_plain_version(cuda_device, d, dtype,
                                                    q_dtype, hq, hkv, length):
    q, k, v, valid = _inputs(cuda_device, d + length, 4, hq, hkv, length, d,
                             dtype, q_dtype)
    before = ops.LAUNCHES
    got = ops.flash_decode_stats(q, k, v, valid)
    again = ops.flash_decode_stats(q, k, v, valid)
    torch.cuda.synchronize(cuda_device)
    assert ops.LAUNCHES == before + 2
    group = hq // hkv
    want = ref.decode_stats(q, torch.repeat_interleave(k, group, 1),
                            torch.repeat_interleave(v, group, 1), valid)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                      # run-to-run bitwise
        # fp32 statistics of the same inputs; only the sum order differs
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    assert torch.all(got[1][1] == ref.NEG_INF)


def _check_flash_decode(q, k, v, valid):
    """The kernel against its plain version: one launch per call, bitwise
    run to run, within 1e-4; a row with no valid key keeps m == NEG_INF."""
    before = ops.LAUNCHES
    got = ops.flash_decode_stats(q, k, v, valid)
    again = ops.flash_decode_stats(q, k, v, valid)
    torch.cuda.synchronize(q.device)
    assert ops.LAUNCHES == before + 2
    group = q.shape[1] // k.shape[1]
    want = ref.decode_stats(q, torch.repeat_interleave(k, group, 1),
                            torch.repeat_interleave(v, group, 1), valid)
    for g, a, w in zip(got, again, want):
        assert torch.equal(g, a)                      # run-to-run bitwise
        torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)
    empty = ~valid.bool().any(dim=1)
    assert torch.all(got[1][empty] == ref.NEG_INF)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("hkv,length", [
    (8, 16384),     # long context: the key axis split over a cluster
    (1, 16384),     # one kv head for 32 q heads: 8 warps of 4 heads
    (8, 1),         # one key
    (1, 1),
    (8, 208),       # the serve path's shape, unexpanded
    (1, 208)])
def test_flash_decode_kernel_gqa_and_cluster_cases(cuda_device, hkv, length):
    q, k, v, valid = _inputs(cuda_device, hkv + length, 4, 32, hkv, length,
                             64, torch.bfloat16, torch.bfloat16)
    splits = ops.launch_shape(4, 32, hkv, length, 64, 2,
                              ops._sm_count(cuda_device.index or 0))[4]
    assert splits == 1 if length == 1 else splits > 1
    _check_flash_decode(q, k, v, valid)


@pytest.mark.cuda
def test_flash_decode_kernel_split_inside_an_invalid_run(cuda_device):
    """Key runs with no valid position that cover whole splits of the
    cluster, and others that start or end inside a split: each all-invalid
    split (m = NEG_INF) must be cleared in the merge, as the single pass
    clears such a run."""
    b, hq, hkv, length, d = 4, 32, 8, 16384, 64
    q, k, v, valid = _inputs(cuda_device, 5, b, hq, hkv, length, d,
                             torch.bfloat16, torch.bfloat16)
    splits = ops.launch_shape(b, hq, hkv, length, d, 2,
                              ops._sm_count(cuda_device.index or 0))[4]
    assert splits > 2
    tile = ops.TILE_BYTES // (d * 2)
    tiles = -(-length // tile)
    cut = [tiles * c // splits * tile for c in range(1, splits)]
    valid[:] = True
    valid[0, cut[0] - 100:cut[1] + 100] = False   # split 1 wholly invalid
    valid[1, :cut[-1] + 7] = False                # valid only in the last
    valid[1, cut[-1] + 8:] = False                # ... at one key
    valid[2] = False                              # no valid key at all
    valid[3, cut[0] - 1:cut[0] + 1] = False       # across one boundary
    got = _check_flash_decode(q, k, v, valid)
    assert torch.all(got[1][2] == ref.NEG_INF)
    assert torch.all(got[1][:2] > ref.NEG_INF)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_what_it_does_not_take(cuda_device):
    q, k, v, valid = _inputs(cuda_device, 0, 2, 4, 2, 64, 32, torch.bfloat16,
                             torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_decode_stats(q, k, v, valid)
    q, k, v, valid = _inputs(cuda_device, 0, 2, 4, 2, 64, 64, torch.float16,
                             torch.float16)
    with pytest.raises(TypeError):
        ops.flash_decode_stats(q, k, v, valid)
    q, k, v, valid = _inputs(cuda_device, 0, 2, 4, 2, 64, 64, torch.bfloat16,
                             torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        ops.flash_decode_stats(q, k.transpose(2, 3).contiguous()
                               .transpose(2, 3), v, valid)


@pytest.mark.cuda
def test_flash_decode_kernel_refuses_a_cluster_wider_than_its_tiles(
        cuda_device):
    """The C entry point takes ``splits`` only up to the key axis's tile
    count, measured in its own tile size (one 64-row tile here)."""
    b, hq, hkv, length, d = 2, 4, 2, 64, 64
    q, k, v, valid = _inputs(cuda_device, 0, b, hq, hkv, length, d,
                             torch.bfloat16, torch.bfloat16)
    out = torch.empty((b * hq * (d + 2),), device=cuda_device)
    route, hc, hw, _, splits = ops.launch_shape(b, hq, hkv, length, d, 2, 132)
    assert splits == 1
    stream = torch.cuda.current_stream(cuda_device).cuda_stream
    ptrs = [t.data_ptr() for t in (q, k, v, valid)] + [out.data_ptr()] * 3
    errs = [ops._kernel_fn()(*ptrs, b, hq, hkv, length, d, 1, 1, 0.125,
                             ops.ROUTES[route], hc, hw, s, stream)
            for s in (1, 2)]
    torch.cuda.synchronize(cuda_device)
    assert errs == [0, 1]             # cudaSuccess, cudaErrorInvalidValue

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1024, 37 * 1024, 1000, 7])
@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.bfloat16, torch.float32),     # fsdp's ring hops
    (torch.float32, torch.float32, torch.bfloat16)])
def test_reduce_add_kernel_matches_plain_version_bitwise(cuda_device, n, start,
                                                         dtypes):
    at, bt, ot = dtypes
    gen = torch.Generator(device=cuda_device).manual_seed(n + start)
    a = torch.randn(n + 1, generator=gen, device=cuda_device).to(at)
    b = torch.randn(n + 1, generator=gen, device=cuda_device).to(bt)
    x, y = a[start:start + n], b[start:start + n]    # start 1: unaligned
    before = ra.LAUNCHES
    got = ra.add_accum(x, y, out_dtype=ot)
    again = ra.add_accum(x, y, out_dtype=ot)
    torch.cuda.synchronize(cuda_device)
    assert ra.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, ra_ref.add_accum(x, y, out_dtype=ot))


# one block's tile of the kernel (csrc/reduce_add.cu): 256 threads x 4
# vectors of 4 elements (8 when an operand is bf16)
def _tile_elements(*dtypes):
    return 256 * 4 * (8 if torch.bfloat16 in dtypes else 4)


@pytest.mark.cuda
@pytest.mark.parametrize("size", ["tile", "tile-1", "tile+1", "2^26+5"])
@pytest.mark.parametrize("start", [0, 1])
@pytest.mark.parametrize("dtypes", [
    (torch.float32, torch.float32, torch.float32),
    (torch.bfloat16, torch.float32, torch.float32),
    (torch.float32, torch.float32, torch.bfloat16)])
def test_reduce_add_kernel_tile_edges_bitwise(cuda_device, size, start,
                                              dtypes):
    at, bt, ot = dtypes
    tile = _tile_elements(*dtypes)
    n = {"tile": tile, "tile-1": tile - 1, "tile+1": tile + 1,
         "2^26+5": 2**26 + 5}[size]
    gen = torch.Generator(device=cuda_device).manual_seed(n + start)
    a = torch.randn(n + 1, generator=gen, device=cuda_device).to(at)
    b = torch.randn(n + 1, generator=gen, device=cuda_device).to(bt)
    x, y = a[start:start + n], b[start:start + n]
    before = ra.LAUNCHES
    got = ra.add_accum(x, y, out_dtype=ot)
    again = ra.add_accum(x, y, out_dtype=ot)
    torch.cuda.synchronize(cuda_device)
    assert ra.LAUNCHES == before + 2
    assert torch.equal(got, again)
    assert torch.equal(got, ra_ref.add_accum(x, y, out_dtype=ot))


@pytest.mark.cuda
@pytest.mark.parametrize("arena_dtype,offset,size,src_dtype,src_shift,way", [
    (torch.float32, 0, 3 * 2**19, torch.float32, 0, "bulk"),  # 2 MiB-aligned
    (torch.float32, 2**19 + 13, 1000, torch.float32, 0, "vector"),  # odd
    (torch.bfloat16, 2**19, 5000, torch.float32, 0, "vector"),  # fp32 -> bf16
    (torch.bfloat16, 3, 777, torch.bfloat16, 0, "vector"),
    # bulk route: sizes in the bulk kernel's stages (bytes per stage / 4
    # fp32 elements), a head misaligned alike on both sides, many stages
    # on every block with a ragged tail
    (torch.float32, 2**19, 1, torch.float32, 0, "bulk"),
    (torch.float32, 2**19, (1, -5), torch.float32, 0, "bulk"),
    (torch.float32, 2**19, (1, 0), torch.float32, 0, "bulk"),
    (torch.float32, 2**19, (1, 1), torch.float32, 0, "bulk"),
    (torch.float32, 2**19 + 1, 37 * 2**19 + 5, torch.float32, 1, "bulk"),
    (torch.bfloat16, 2**19 + 3, 2**20 + 7, torch.bfloat16, 3, "bulk"),
    # vector route: same type, addresses not congruent mod 16 (the source
    # 1-3 elements past the destination's 4-element boundaries, a head
    # shorter than that); casts, shifted and not; too short for a vector
    (torch.float32, 2**19, 2**20 + 3, torch.float32, 1, "vector"),
    (torch.float32, 2**19, 2**20 + 3, torch.float32, 3, "vector"),
    (torch.float32, 2**19 + 2, 2**20 + 5, torch.float32, 0, "vector"),
    (torch.bfloat16, 2**19 + 1, 2**20 + 3, torch.bfloat16, 0, "vector"),
    (torch.bfloat16, 2**19 + 2, 2**20 + 3, torch.bfloat16, 1, "vector"),
    (torch.bfloat16, 2**19 + 4, 2**20 + 3, torch.bfloat16, 0, "vector"),
    (torch.float32, 2**19 + 2, 2**20 + 3, torch.bfloat16, 2, "vector"),
    (torch.float32, 2**19 + 1, 2**20 + 3, torch.bfloat16, 0, "vector"),
    (torch.bfloat16, 2**19 + 1, 2**20 + 3, torch.float32, 0, "vector"),
    (torch.float32, 2**19, 9, torch.float32, 1, "vector"),
    (torch.bfloat16, 2**19 + 1, 7, torch.float32, 0, "vector")])
def test_pack_kernels_match_plain_versions_bitwise(cuda_device, arena_dtype,
                                                    offset, size, src_dtype,
                                                    src_shift, way):
    if isinstance(size, tuple):       # (stages, elements) of the kernel's
        size = size[0] * pk.bulk_stage_bytes() // 4 + size[1]
    gen = torch.Generator(device=cuda_device).manual_seed(offset + size)
    arena = torch.randn(max(8 * 2**19, offset + size), generator=gen,
                        device=cuda_device).to(arena_dtype)
    src = torch.randn(size + src_shift, generator=gen,
                      device=cuda_device).to(src_dtype)[src_shift:]
    assert pk.route(arena[offset:offset + size], src) == way
    want = pk_ref.write_flat(arena.clone(), src, offset)
    second = arena.clone()
    before = dict(pk.LAUNCHES)
    routes = dict(pk.LAUNCHES_BY_ROUTE)
    got = pk.write_flat(arena, src, offset)
    pk.write_flat(second, src, offset)
    read = pk.read_flat(got, offset, size)
    again = pk.read_flat(got, offset, size)
    torch.cuda.synchronize(cuda_device)
    assert got.data_ptr() == arena.data_ptr()          # in place
    assert pk.LAUNCHES == {"write": before["write"] + 2,
                           "read": before["read"] + 2}
    # every read is a bulk copy: its output is allocated congruent
    routes[way] += 2
    routes["bulk"] += 2
    assert pk.LAUNCHES_BY_ROUTE == routes
    assert torch.equal(got, want)
    assert torch.equal(second, want)                   # run to run
    assert torch.equal(read, pk_ref.read_flat(want, offset, size))
    assert torch.equal(read, again)
