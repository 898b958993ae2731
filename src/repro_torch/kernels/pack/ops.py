"""Wrappers of the arena pack/unpack kernels.

Port of ``repro.kernels.pack.ops``.  ``write_flat`` and ``read_flat`` move
one bucket into and out of the communication arena
(:class:`repro_torch.mem.arena.CommArena`).  For CUDA tensors they launch
the hand-written kernels (``csrc/pack.cu``) at any offset and size, casting
on the write, or raise for what the kernels do not take; unlike the
reference there is no fallback to the plain version on the device.  Each
copy takes one of two routes, chosen by :func:`route` before the launch:
``"bulk"`` (Hopper's bulk-copy engine) for a same-type copy whose two
addresses are congruent mod 16 bytes, ``"vector"`` otherwise.  A read
allocates its output congruent to the arena segment, so every read is a
bulk copy.  For CPU tensors they run the plain versions in ``ref.py``.
For fake tensors (the dry-run, :mod:`repro_torch.fake`) a write leaves the
arena as it is and a read allocates the kernel's output; both count the
call on its route and launch nothing.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.fake import address, count_fake, is_fake
from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.pack import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
ROUTE_CODES = {"bulk": 0, "vector": 1}
# bulk copies move 16-byte granules between 16-byte-aligned addresses
BULK_ALIGN = 16

# kernel launches by these wrappers (CPU calls are not launches)
LAUNCHES = {"write": 0, "read": 0}
LAUNCHES_BY_ROUTE = {"bulk": 0, "vector": 0}


def count_launch(what: str, way: str) -> None:
    """One ``what`` launch more ("write" or "read"), on route ``way``
    (under the wrappers' shared lock: rails launch from threads of their
    own)."""
    with LAUNCH_LOCK:
        LAUNCHES[what] += 1
        LAUNCHES_BY_ROUTE[way] += 1


@functools.cache
def _kernel_fns():
    """The bound C entry points, built and loaded once per process."""
    lib = _build.load(SOURCE)
    write, read = lib.pack_write, lib.pack_read
    write.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_int, ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int,
                     ctypes.c_void_p]
    write.restype = read.restype = ctypes.c_int
    return write, read


@functools.cache
def bulk_stage_bytes() -> int:
    """Bytes per shared-memory stage of the bulk route (its chunk), read
    from the built kernel."""
    fn = _build.load(SOURCE).pack_bulk_stage_bytes
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def route(dst: torch.Tensor, src: torch.Tensor) -> str:
    """The kernel a copy of ``src`` into ``dst`` (the arena segment's view
    for a write, the output for a read) launches for CUDA tensors:
    ``"bulk"`` when both have one dtype and their addresses
    (``data_ptr()``, a view's offset included) are congruent mod 16 bytes,
    else ``"vector"``.  It reads only dtypes and addresses, so CPU tensors
    are routed as the same layout on the card would be, and fake tensors
    by their offsets in their storages (:func:`repro_torch.fake.address`);
    other devices, or tensors on two devices, raise."""
    devs = {dst.device, src.device}
    if len(devs) != 1 or (dst.device.type not in ("cuda", "cpu")
                          and not is_fake(dst, src)):
        raise ValueError(f"route takes tensors on one cuda or cpu device, "
                         f"got {sorted(map(str, devs))}")
    if dst.dtype == src.dtype \
            and (address(dst) - address(src)) % BULK_ALIGN == 0:
        return "bulk"
    return "vector"


def _empty_congruent(size: int, like: torch.Tensor) -> torch.Tensor:
    """An uninitialised contiguous ``(size,)`` tensor of ``like``'s dtype and
    device whose address is congruent to ``like.data_ptr()`` mod 16 bytes:
    a view into up to 16 bytes more."""
    item = like.element_size()
    buf = torch.empty((size + BULK_ALIGN // item - 1,), dtype=like.dtype,
                      device=like.device)
    shift = (address(like) - address(buf)) % BULK_ALIGN // item
    return buf[shift:shift + size]


def _check_arena(arena: torch.Tensor, offset: int, size: int) -> None:
    if arena.ndim != 1:
        raise ValueError(f"flat arena expected, got {tuple(arena.shape)}")
    if offset < 0 or size < 0 or offset + size > arena.numel():
        raise ValueError(f"[{offset}, {offset + size}) is outside the arena "
                         f"of {arena.numel()} elements")


def _kernel_dtype(t: torch.Tensor, name: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"pack kernels take float32/bfloat16, got {name} "
                        f"{t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"pack kernels need a contiguous {name}")
    return DTYPE_CODES[t.dtype]


def _launched(what: str, way: str, err: int, offset: int, n: int) -> None:
    if err:
        raise RuntimeError(f"pack {what} kernel launch failed on the {way} "
                           f"route: CUDA error {err} at offset {offset}, "
                           f"n={n}")
    count_launch(what, way)


def write_flat(arena: torch.Tensor, src: torch.Tensor,
               offset: int) -> torch.Tensor:
    """Writes ``src`` (cast to the arena dtype) into ``arena`` at element
    ``offset``, in place; returns ``arena``."""
    if src.ndim != 1:
        raise ValueError(f"flat source expected, got {tuple(src.shape)}")
    _check_arena(arena, offset, src.numel())
    if arena.device != src.device:
        raise ValueError(f"arena on {arena.device}, source on {src.device}")
    if is_fake(arena, src):
        _kernel_dtype(arena, "arena")
        _kernel_dtype(src, "source")
        n = src.numel()
        if n:
            count_fake("pack.write", route(arena[offset:offset + n], src),
                       nbytes=n * (arena.element_size()
                                   + src.element_size()))
        return arena
    if arena.device.type == "cpu":
        return ref.write_flat(arena, src, offset)
    if arena.device.type != "cuda":
        raise ValueError(f"write_flat runs on cuda or cpu, got {arena.device}")
    adt, sdt = _kernel_dtype(arena, "arena"), _kernel_dtype(src, "source")
    n = src.numel()
    if n == 0:
        return arena
    way = route(arena[offset:offset + n], src)
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = _kernel_fns()[0](arena.data_ptr(), adt, src.data_ptr(), sdt,
                               offset, n, ROUTE_CODES[way], stream)
    _launched("write", way, err, offset, n)
    return arena


def read_flat(arena: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """A fresh copy of ``arena[offset : offset + size]``."""
    _check_arena(arena, offset, size)
    if is_fake(arena):
        _kernel_dtype(arena, "arena")
        segment = arena[offset:offset + size]
        out = _empty_congruent(size, segment)
        if size:
            count_fake("pack.read", route(out, segment),
                       nbytes=2 * size * arena.element_size())
        return out
    if arena.device.type == "cpu":
        return ref.read_flat(arena, offset, size)
    if arena.device.type != "cuda":
        raise ValueError(f"read_flat runs on cuda or cpu, got {arena.device}")
    dt = _kernel_dtype(arena, "arena")
    segment = arena[offset:offset + size]
    out = _empty_congruent(size, segment)
    if size == 0:
        return out
    way = route(out, segment)
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = _kernel_fns()[1](arena.data_ptr(), dt, offset, size,
                               out.data_ptr(), ROUTE_CODES[way], stream)
    _launched("read", way, err, offset, size)
    return out
