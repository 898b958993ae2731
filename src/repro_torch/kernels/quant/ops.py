"""Wrappers of the block-absmax int8 codec kernels.

Port of ``repro.kernels.quant.ops``.  ``quantize`` and ``dequantize`` are
the encode and decode of :class:`repro_torch.comm.wire_codec.Int8BlockCodec`,
the payload of every int8 ring hop.  For CUDA tensors they launch the
hand-written kernels (``csrc/quant.cu``) at any block size and block count,
or raise for what the kernels do not take; unlike the reference there is no
fallback to the plain version on the device.  For CPU tensors they run the
plain versions in ``ref.py``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.quant import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "quant.cu"

# kernel launches by these wrappers (CPU calls and empty payloads are not
# launches)
LAUNCHES = {"quantize": 0, "dequantize": 0}


def count_launch(name: str) -> None:
    """One ``name`` launch more ("quantize" or "dequantize"; under the
    wrappers' shared lock: rails launch from threads of their own)."""
    with LAUNCH_LOCK:
        LAUNCHES[name] += 1


@functools.cache
def _kernel_fns():
    """The bound C entry points, built and loaded once per process."""
    lib = _build.load(SOURCE)
    quant, dequant = lib.quantize, lib.dequantize
    quant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                              ctypes.c_int, ctypes.c_void_p]
    dequant.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                                ctypes.c_int, ctypes.c_void_p]
    quant.restype = dequant.restype = ctypes.c_int
    return quant, dequant


def check_block(n: int, block: int) -> None:
    if block <= 0:
        raise ValueError(f"block must be positive, got {block}")
    if n % block:
        raise ValueError(f"size {n} not divisible by block {block}")


def check_kernel_operand(t: torch.Tensor, name: str,
                         dtype: torch.dtype) -> None:
    """What the kernels take: a flat, contiguous tensor of ``dtype`` on a
    CUDA device."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} on {t.device}; the kernel runs on cuda")
    if t.dtype != dtype:
        raise TypeError(f"the kernel takes {dtype} {name}, got {t.dtype}")
    if t.ndim != 1 or not t.is_contiguous():
        raise ValueError(f"the kernel needs a flat contiguous {name}, got "
                         f"shape {tuple(t.shape)}")


def _launch(fn, name: str, device: torch.device, *args) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({args[-2]} blocks of {args[-1]})")
    count_launch(name)


def quantize(x: torch.Tensor, block: int = 512,
             out: tuple[torch.Tensor, torch.Tensor] | None = None
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Flat fp32 (n,) -> (int8 q (n,), fp32 scales (n / block,)), written
    into ``out`` when it is given."""
    n = x.shape[0]
    check_block(n, block)
    if out is not None and (out[0].shape != (n,)
                            or out[1].shape != (n // block,)):
        raise ValueError(f"out of shapes {[tuple(t.shape) for t in out]} "
                         f"for {n} values in blocks of {block}")
    if x.device.type == "cpu":
        return ref.quantize(x, block, out)
    check_kernel_operand(x, "x", torch.float32)
    if out is None:
        out = (torch.empty((n,), dtype=torch.int8, device=x.device),
               torch.empty((n // block,), dtype=torch.float32,
                           device=x.device))
    q, scales = out
    check_kernel_operand(q, "q", torch.int8)
    check_kernel_operand(scales, "scales", torch.float32)
    if q.device != x.device or scales.device != x.device:
        raise ValueError(f"x on {x.device}, out on {q.device} and "
                         f"{scales.device}")
    if n:
        _launch(_kernel_fns()[0], "quantize", x.device, x.data_ptr(),
                q.data_ptr(), scales.data_ptr(), n // block, block)
    return q, scales


def dequantize(q: torch.Tensor, scales: torch.Tensor,
               block: int = 512) -> torch.Tensor:
    """Inverse of :func:`quantize`: flat int8 (n,) and (n / block,) scales
    -> fp32 (n,)."""
    check_block(q.shape[0], block)
    if q.device != scales.device:
        raise ValueError(f"q on {q.device}, scales on {scales.device}")
    if scales.shape != (q.shape[0] // block,):
        raise ValueError(f"{q.shape[0] // block} scales expected, got shape "
                         f"{tuple(scales.shape)}")
    if q.device.type == "cpu":
        return ref.dequantize(q, scales, block)
    check_kernel_operand(q, "q", torch.int8)
    check_kernel_operand(scales, "scales", torch.float32)
    n = q.shape[0]
    out = torch.empty((n,), dtype=torch.float32, device=q.device)
    if n:
        _launch(_kernel_fns()[1], "dequantize", q.device, q.data_ptr(),
                scales.data_ptr(), out.data_ptr(), n // block, block)
    return out
