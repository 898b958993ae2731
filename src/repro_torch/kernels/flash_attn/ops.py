"""Wrapper for blockwise (flash) attention forward, the serving prefill's
attention.

Port of ``repro.kernels.flash_attn.ops``.  For CUDA tensors it launches the
hand-written kernel (``csrc/flash_attn.cu``) or raises for what the kernel
does not take; unlike the reference, which falls back to its oracle when S
does not tile or D % 8 != 0, nothing falls back on the device: the kernel
masks a ragged last tile itself.  For CPU tensors it runs the plain
version, ``ref.attention``.

On both devices it refuses what the reference's kernel does not compute:
Sq != Sk (the TPU kernel numbers query and key positions from 0, its oracle
aligns their ends; a prefill always has Sq == Sk, where the two agree), the
chunked-local mask, and inputs that require grad (the kernel, like the
reference's, has no backward; training keeps ``blockwise_attention``).
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attn import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attn.cu"
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches by this wrapper (CPU calls are not launches)
LAUNCHES = 0


@functools.cache
def _kernel_fn():
    """The bound C entry point, built and loaded once per process."""
    fn = _build.load(SOURCE).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, window, chunk) -> None:
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1:
        raise ValueError(f"q/k/v on different devices: {devs}")
    if q.ndim != 4 or k.ndim != 4 or k.shape != v.shape \
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[3]:
        raise ValueError(f"q must be (B, Hq, S, D) and k/v (B, Hkv, S, D), "
                         f"got {tuple(q.shape)} / {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"Hq={q.shape[1]} not a multiple of Hkv={k.shape[1]}")
    if q.shape[2] != k.shape[2]:
        raise ValueError(f"flash_attention takes Sq == Sk (a prefill), got "
                         f"Sq={q.shape[2]}, Sk={k.shape[2]}")
    if chunk is not None:
        raise ValueError("flash_attention has no chunked-local mask (the "
                         "reference's kernel has none)")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise RuntimeError("flash_attention has no backward; run it under "
                           "torch.no_grad() (training uses "
                           "blockwise_attention)")


def _launch(q, k, v, causal, window):
    global LAUNCHES
    b, hq, s, d = q.shape
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention kernel takes head_dim in "
                         f"{HEAD_DIMS}, got {d}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention kernel takes q/k/v of one dtype, "
                        f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention kernel needs {name} "
                             f"contiguous along D")
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    # a window as long as the sequence masks nothing
    win = window if window is not None and window < s else 0
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 b, hq, k.shape[1], s, d, int(q.dtype == torch.bfloat16),
                 *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                 1.0 / (d ** 0.5), int(causal), win, stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}")
    LAUNCHES += 1
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk: int | None = None) -> torch.Tensor:
    """Attention output (B, Hq, S, D) in q's dtype for q (B, Hq, S, D) over
    k/v (B, Hkv, S, D); q head ``h`` reads kv head ``h // (Hq/Hkv)``."""
    _check(q, k, v, window, chunk)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch(q, k, v, causal, window)
