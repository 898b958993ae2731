"""repro_torch arena pack/unpack: the route rule, on the CPU.

``ops.route`` chooses the kernel ``write_flat`` and ``read_flat`` launch for
CUDA tensors from dtypes and addresses alone, so the rule is held here on
CPU-built tensors: one dtype with addresses congruent mod 16 bytes goes to
``"bulk"`` (Hopper's bulk-copy engine), a cast or addresses that are not
congruent to ``"vector"``, whatever the size.  A read allocates its output
congruent to the arena segment (``ops._empty_congruent``), so every read is
a bulk copy; the train path's writes (fresh buckets into 2 MiB-aligned
segments) are too.  The file imports no JAX and calls only port functions.
"""

import pytest
import torch

from repro_torch.configs import reduced_config
from repro_torch.core.bucketing import GradientBucketer
from repro_torch.kernels.pack import ops
from repro_torch.mem.arena import CommArena
from repro_torch.mem.layout import arena_from_bucket_plan
from repro_torch.models import transformer

F32, BF16 = torch.float32, torch.bfloat16


def _aligned(n, dtype):
    """A (n,) tensor whose address is a multiple of 16 bytes."""
    buf = torch.zeros(n + 16, dtype=dtype)
    item = buf.element_size()
    shift = (-buf.data_ptr()) % 16 // item
    return buf[shift:shift + n]


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("arena_shift,src_shift", [(0, 0), (16, 0), (1, 1),
                                                   (3, 11), (9, 1)])
def test_same_dtype_congruent_addresses_take_bulk(dtype, arena_shift,
                                                  src_shift):
    """Shifts in elements whose byte difference is a multiple of 16 at
    both item sizes, including heads misaligned on both sides alike."""
    item = torch.empty((), dtype=dtype).element_size()
    assert (arena_shift - src_shift) * item % 16 == 0
    arena, src = _aligned(4096, dtype), _aligned(1100, dtype)
    n = 1000
    assert ops.route(arena[arena_shift:arena_shift + n],
                     src[src_shift:src_shift + n]) == "bulk"


@pytest.mark.parametrize("dtype,arena_shift,src_shift", [
    (F32, 1, 0), (F32, 0, 1), (F32, 4 * 512 + 13, 0), (F32, 2, 1),
    (BF16, 3, 0), (BF16, 2, 0), (BF16, 4, 0), (BF16, 0, 6)])
def test_same_dtype_addresses_not_congruent_take_vector(dtype, arena_shift,
                                                        src_shift):
    arena, src = _aligned(4096, dtype), _aligned(1100, dtype)
    n = 1000
    assert ops.route(arena[arena_shift:arena_shift + n],
                     src[src_shift:src_shift + n]) == "vector"


def test_same_dtype_off_by_four_bytes_takes_vector():
    arena, src = _aligned(4096, F32), _aligned(1100, F32)
    dst = arena[1:1001]
    assert dst.data_ptr() - src.data_ptr() == arena.data_ptr() \
        - src.data_ptr() + 4
    assert ops.route(dst, src[:1000]) == "vector"
    assert ops.route(arena[4:1004], src[:1000]) == "bulk"


@pytest.mark.parametrize("arena_dt,src_dt", [(BF16, F32), (F32, BF16)])
@pytest.mark.parametrize("shift", [0, 8])
def test_a_cast_takes_vector(arena_dt, src_dt, shift):
    """Casts go through registers, congruent or not."""
    arena, src = _aligned(4096, arena_dt), _aligned(1100, src_dt)
    assert ops.route(arena[shift:shift + 1000], src[:1000]) == "vector"


@pytest.mark.parametrize("n", [1, 2, 3])
def test_one_element_and_sub_16_byte_copies(n):
    """The rule looks at addresses, not sizes: the bulk kernel copies a
    copy shorter than one 16-byte granule as its head and tail."""
    arena, src = _aligned(64, F32), _aligned(64, F32)
    assert n * 4 < 16
    assert ops.route(arena[4:4 + n], src[:n]) == "bulk"
    assert ops.route(arena[5:5 + n], src[1:1 + n]) == "bulk"
    assert ops.route(arena[5:5 + n], src[:n]) == "vector"
    assert ops.route(arena[4:4 + n].to(BF16), src[:n]) == "vector"


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("offset", range(9))
def test_a_read_output_is_congruent_to_its_segment(dtype, offset):
    arena = _aligned(256, dtype)
    for size in (1, 5, 100):
        segment = arena[offset:offset + size]
        out = ops._empty_congruent(size, segment)
        assert out.shape == (size,) and out.dtype == dtype
        assert out.is_contiguous()
        assert out.untyped_storage().data_ptr() \
            != arena.untyped_storage().data_ptr()
        assert ops.route(out, segment) == "bulk"


def test_the_train_path_routes_every_copy_to_bulk():
    """The arena of a llama3.2-1b layout (reduced widths, 64 KiB buckets,
    2 MiB pages): every bucket written into its segment and every segment
    read back out is a bulk copy."""
    cfg = reduced_config("llama3.2-1b")
    gen = torch.Generator().manual_seed(0)
    params = transformer.init_params(gen, cfg, torch.device("cpu"))
    bucketer = GradientBucketer(bucket_bytes=2**16)
    buckets, plan = bucketer.bucketize(params)
    layout = arena_from_bucket_plan(plan, pad_multiple=bucketer.pad_multiple,
                                    bucket_bytes=2**16, warn_oversized=False)
    assert layout.n_segments > 1
    arena = CommArena(layout).zeros("cpu")
    for seg in layout.segments:
        view = arena[seg.offset:seg.offset + seg.size]
        assert ops.route(view, buckets[seg.bucket].reshape(-1)) == "bulk"
        out = ops._empty_congruent(seg.size, view)
        assert ops.route(out, view) == "bulk"


def test_route_refuses_tensors_on_two_devices():
    with pytest.raises(ValueError, match="one cuda or cpu device"):
        ops.route(torch.zeros(4), torch.zeros(4, device="meta"))
    with pytest.raises(ValueError, match="one cuda or cpu device"):
        ops.route(torch.zeros(4, device="meta"),
                  torch.zeros(4, device="meta"))


def test_launch_counters_keep_their_keys():
    assert set(ops.LAUNCHES) == {"write", "read"}
    assert set(ops.LAUNCHES_BY_ROUTE) == {"bulk", "vector"}
    assert set(ops.ROUTE_CODES) == set(ops.LAUNCHES_BY_ROUTE)


@pytest.mark.parametrize("arena_dt,src_dt", [(F32, F32), (BF16, F32)])
def test_cpu_calls_launch_nothing(arena_dt, src_dt):
    before = (dict(ops.LAUNCHES), dict(ops.LAUNCHES_BY_ROUTE))
    arena = torch.zeros(64, dtype=arena_dt)
    src = torch.arange(10, dtype=src_dt)
    ops.write_flat(arena, src, 4)
    got = ops.read_flat(arena, 4, 10)
    assert torch.equal(got, src.to(arena_dt))
    assert (dict(ops.LAUNCHES), dict(ops.LAUNCHES_BY_ROUTE)) == before
