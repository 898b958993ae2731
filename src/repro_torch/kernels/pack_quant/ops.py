"""Wrappers of the fused pack+quantize and dequant+unpack arena kernels.

Port of ``repro.kernels.pack_quant.ops``.  ``write_quant_flat`` and
``read_dequant_flat`` move one bucket or span into and out of the int8
communication arena (:class:`repro_torch.mem.arena.QuantCommArena`), the
fp32 block scales living in the arena's own trailing scale segment.  For
CUDA tensors they launch the hand-written kernels (``csrc/pack_quant.cu``)
at any block size and any block-aligned offset, or raise for what the
kernels do not take; unlike the reference there is no fallback to the plain
version on the device.  For CPU tensors they run the plain versions in
``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.pack_quant import ref
from repro_torch.kernels.quant.ops import check_block, check_kernel_operand

SOURCE = Path(__file__).resolve().parent / "csrc" / "pack_quant.cu"

# kernel launches by these wrappers (CPU calls and empty extents are not
# launches)
LAUNCHES = {"write": 0, "read": 0}


def count_launch(what: str) -> None:
    """One ``what`` launch more ("write" or "read"; under the wrappers'
    shared lock: rails launch from threads of their own)."""
    with LAUNCH_LOCK:
        LAUNCHES[what] += 1


@functools.cache
def _kernel_fns():
    """The bound C entry points, built and loaded once per process."""
    lib = _build.load(SOURCE)
    write, read = lib.write_quant, lib.read_dequant
    write.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p]
    read.argtypes = [ctypes.c_void_p] + [ctypes.c_longlong] * 3 + [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    write.restype = read.restype = ctypes.c_int
    return write, read


def _check_extent(arena: torch.Tensor, offset: int, size: int,
                  scale_offset: int, block: int) -> int:
    """Validates ``arena[offset : offset + size]`` and its scale bytes;
    returns the byte index of its first scale."""
    if arena.ndim != 1 or arena.dtype != torch.int8:
        raise ValueError(f"flat int8 arena expected, got {arena.dtype} "
                         f"{tuple(arena.shape)}")
    check_block(size, block)
    if offset < 0 or offset % block:
        raise ValueError(f"offset {offset} is not a multiple of block "
                         f"{block}")
    lo = ref.scale_byte_offset(scale_offset, offset, block)
    hi = ref.scale_byte_offset(scale_offset, offset + size, block)
    if offset + size > scale_offset or lo < scale_offset or \
            hi > arena.numel():
        raise ValueError(f"payload [{offset}, {offset + size}) or its scale "
                         f"bytes [{lo}, {hi}) fall outside the arena of "
                         f"{arena.numel()} bytes (scales from "
                         f"{scale_offset})")
    if (arena.data_ptr() + lo) % ref.SCALE_BYTES:
        raise ValueError(f"scale bytes at {lo} are not 4-byte aligned")
    return lo


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def write_quant_flat(arena: torch.Tensor, src: torch.Tensor, offset: int,
                     scale_offset: int, block: int,
                     ef: torch.Tensor | None = None) -> torch.Tensor:
    """Quantizes flat fp32 ``src`` (plus ``ef`` when given) into
    ``arena[offset : offset + n]`` and its scales into the arena's scale
    segment, in place, in one launch; with ``ef`` (the error-feedback slice
    of the same length, updated in place) ``ef`` becomes the residual.
    Returns ``arena``."""
    if src.ndim != 1:
        raise ValueError(f"flat source expected, got {tuple(src.shape)}")
    n = src.shape[0]
    lo = _check_extent(arena, offset, n, scale_offset, block)
    if ef is not None and ef.shape != src.shape:
        raise ValueError(f"ef has shape {tuple(ef.shape)}, source "
                         f"{tuple(src.shape)}")
    if any(t.device != arena.device for t in (src, ef) if t is not None):
        raise ValueError("arena, source and ef must share a device")
    if arena.device.type == "cpu":
        return ref.write_quant_flat(arena, src, offset, scale_offset, block,
                                    ef)
    check_kernel_operand(arena, "arena", torch.int8)
    check_kernel_operand(src, "source", torch.float32)
    if ef is not None:
        check_kernel_operand(ef, "ef", torch.float32)
    if n == 0:
        return arena
    with torch.cuda.device(arena.device):
        err = _kernel_fns()[0](arena.data_ptr(), src.data_ptr(),
                               None if ef is None else ef.data_ptr(), offset,
                               n, lo, block, _stream(arena.device))
    if err:
        raise RuntimeError(f"write_quant kernel launch failed: CUDA error "
                           f"{err} at offset {offset}, n={n}, block={block}")
    count_launch("write")
    return arena


def read_dequant_flat(arena: torch.Tensor, offset: int, size: int,
                      scale_offset: int, block: int) -> torch.Tensor:
    """Fused dequant+unpack: ``arena[offset : offset + size]`` decoded with
    its scales into a fresh flat fp32 tensor."""
    lo = _check_extent(arena, offset, size, scale_offset, block)
    if arena.device.type == "cpu":
        return ref.read_dequant_flat(arena, offset, size, scale_offset,
                                     block)
    check_kernel_operand(arena, "arena", torch.int8)
    out = torch.empty((size,), dtype=torch.float32, device=arena.device)
    if size == 0:
        return out
    with torch.cuda.device(arena.device):
        err = _kernel_fns()[1](arena.data_ptr(), offset, size, lo, block,
                               out.data_ptr(), _stream(arena.device))
    if err:
        raise RuntimeError(f"read_dequant kernel launch failed: CUDA error "
                           f"{err} at offset {offset}, n={size}, "
                           f"block={block}")
    count_launch("read")
    return out
