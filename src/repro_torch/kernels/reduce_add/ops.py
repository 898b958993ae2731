"""Wrapper of the ring-hop accumulate kernel.

Port of ``repro.kernels.reduce_add.ops``.  ``add_accum`` is the local
``acc += recv`` of every reduce-scatter hop in
:mod:`repro_torch.core.ring`.  For CUDA tensors it launches the
hand-written kernel (``csrc/reduce_add.cu``) at any length, or raises for
what the kernel does not take; unlike the reference there is no fallback to
the plain version on the device.  For CPU tensors it runs the plain version,
``ref.add_accum``.  For fake tensors (the dry-run, :mod:`repro_torch.fake`)
it allocates the kernel's output and counts the call, launching nothing.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.fake import count_fake, is_fake
from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.reduce_add import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "reduce_add.cu"
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# kernel launches by this wrapper (CPU calls are not launches)
LAUNCHES = 0


def count_launch() -> None:
    """One launch more in :data:`LAUNCHES` (under the wrappers' shared
    lock: rails launch from threads of their own)."""
    global LAUNCHES
    with LAUNCH_LOCK:
        LAUNCHES += 1


@functools.cache
def _kernel_fn():
    """The bound C entry point, built and loaded once per process."""
    fn = _build.load(SOURCE).reduce_add
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _kernel_checks(a, b, out_dtype) -> None:
    for name, t in (("a", a), ("b", b)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"reduce_add kernel takes float32/bfloat16, got "
                            f"{name} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"reduce_add kernel needs contiguous {name}")
    if out_dtype not in DTYPE_CODES:
        raise TypeError(f"reduce_add kernel writes float32/bfloat16, got "
                        f"{out_dtype}")


def _fake_launch(a, b, out_dtype):
    """The fake route (:mod:`repro_torch.fake`): the kernel's output, and
    nothing launched."""
    _kernel_checks(a, b, out_dtype)
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    if a.numel():
        count_fake("reduce_add", flops=a.numel(),
                   nbytes=a.numel() * (a.element_size() + b.element_size()
                                       + out.element_size()))
    return out


def _launch(a, b, out_dtype):
    _kernel_checks(a, b, out_dtype)
    out = torch.empty(a.shape, dtype=out_dtype, device=a.device)
    if a.numel() == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        err = _kernel_fn()(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           a.numel(), DTYPE_CODES[a.dtype],
                           DTYPE_CODES[b.dtype], DTYPE_CODES[out_dtype],
                           stream)
    if err:
        raise RuntimeError(f"reduce_add kernel launch failed: CUDA error "
                           f"{err} at n={a.numel()} {a.dtype}+{b.dtype}"
                           f"->{out_dtype}")
    count_launch()
    return out


def add_accum(a: torch.Tensor, b: torch.Tensor, *,
              accum_dtype: torch.dtype = torch.float32,
              out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``cast(a) + cast(b)`` in ``accum_dtype``, cast to ``out_dtype``
    (default: the accumulation dtype)."""
    out_dtype = out_dtype or accum_dtype
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    if a.device != b.device:
        raise ValueError(f"a on {a.device}, b on {b.device}")
    if is_fake(a, b):
        if accum_dtype != torch.float32:
            raise TypeError(f"reduce_add kernel accumulates in float32, got "
                            f"{accum_dtype}")
        return _fake_launch(a, b, out_dtype)
    if a.device.type == "cpu":
        return ref.add_accum(a, b, accum_dtype=accum_dtype,
                             out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"add_accum runs on cuda or cpu, got {a.device}")
    if accum_dtype != torch.float32:
        raise TypeError(f"reduce_add kernel accumulates in float32, got "
                        f"{accum_dtype}")
    return _launch(a, b, out_dtype)
