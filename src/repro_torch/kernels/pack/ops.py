"""Wrappers of the arena pack/unpack kernels.

Port of ``repro.kernels.pack.ops``.  ``write_flat`` and ``read_flat`` move
one bucket into and out of the communication arena
(:class:`repro_torch.mem.arena.CommArena`).  For CUDA tensors they launch
the hand-written kernels (``csrc/pack.cu``) at any offset and size, casting
on the write, or raise for what the kernels do not take; unlike the
reference there is no fallback to the plain version on the device.  For
CPU tensors they run the plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.pack import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by these wrappers (CPU calls are not launches)
LAUNCHES = {"write": 0, "read": 0}


@functools.cache
def _kernel_fns():
    """The bound C entry points, built and loaded once per process."""
    lib = _build.load(SOURCE)
    write, read = lib.pack_write, lib.pack_read
    write.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
                      ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                     ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p]
    write.restype = read.restype = ctypes.c_int
    return write, read


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


def write_flat(arena: torch.Tensor, src: torch.Tensor,
               offset: int) -> torch.Tensor:
    """Writes ``src`` (cast to the arena dtype) into ``arena`` at element
    ``offset``, in place; returns ``arena``."""
    if src.ndim != 1:
        raise ValueError(f"flat source expected, got {tuple(src.shape)}")
    _check_arena(arena, offset, src.numel())
    if arena.device != src.device:
        raise ValueError(f"arena on {arena.device}, source on {src.device}")
    if arena.device.type == "cpu":
        return ref.write_flat(arena, src, offset)
    if arena.device.type != "cuda":
        raise ValueError(f"write_flat runs on cuda or cpu, got {arena.device}")
    adt, sdt = _kernel_dtype(arena, "arena"), _kernel_dtype(src, "source")
    if src.numel() == 0:
        return arena
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = _kernel_fns()[0](arena.data_ptr(), adt, src.data_ptr(), sdt,
                               offset, src.numel(), stream)
    if err:
        raise RuntimeError(f"pack write kernel launch failed: CUDA error "
                           f"{err} at offset {offset}, n={src.numel()}")
    LAUNCHES["write"] += 1
    return arena


def read_flat(arena: torch.Tensor, offset: int, size: int) -> torch.Tensor:
    """A fresh copy of ``arena[offset : offset + size]``."""
    _check_arena(arena, offset, size)
    if arena.device.type == "cpu":
        return ref.read_flat(arena, offset, size)
    if arena.device.type != "cuda":
        raise ValueError(f"read_flat runs on cuda or cpu, got {arena.device}")
    dt = _kernel_dtype(arena, "arena")
    out = torch.empty((size,), dtype=arena.dtype, device=arena.device)
    if size == 0:
        return out
    with torch.cuda.device(arena.device):
        stream = torch.cuda.current_stream(arena.device).cuda_stream
        err = _kernel_fns()[1](arena.data_ptr(), dt, offset, size,
                               out.data_ptr(), stream)
    if err:
        raise RuntimeError(f"pack read kernel launch failed: CUDA error "
                           f"{err} at offset {offset}, n={size}")
    LAUNCHES["read"] += 1
    return out
