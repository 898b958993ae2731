"""Wrappers for split-KV decode attention.

Port of ``repro.kernels.flash_decode.ops``.  ``flash_decode_stats`` is the
building block the paged engine consumes: partial softmax statistics over
one KV shard, mergeable with :func:`ref.combine`.  For CUDA tensors it
launches the hand-written kernel (``csrc/flash_decode.cu``) or raises for a
shape the kernel does not take; unlike the reference there is no fallback to
the plain version on the device.  For CPU tensors it runs the plain
version, ``ref.decode_stats``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_decode import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
HEAD_DIMS = (16, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)

# kernel launches by this wrapper (CPU calls are not launches)
LAUNCHES = 0


def _expand_gqa(q, k, v):
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return k, v


@functools.cache
def _kernel_fn():
    """The bound C entry point, built and loaded once per process (the
    launch path then does no file-system or library lookups)."""
    fn = _build.load(SOURCE).flash_decode_stats
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(q, k, v, valid) -> None:
    devs = {t.device for t in (q, k, v, valid)}
    if len(devs) != 1:
        raise ValueError(f"q/k/v/valid on different devices: {devs}")
    if q.ndim != 4 or q.shape[2] != 1:
        raise ValueError(f"q must be (B, Hq, 1, D), got {tuple(q.shape)}")
    b, hq, _, d = q.shape
    if k.ndim != 4 or k.shape != v.shape or k.shape[0] != b \
            or k.shape[3] != d:
        raise ValueError(f"k/v must be (B, Hkv, L, D) matching q "
                         f"{tuple(q.shape)}, got {tuple(k.shape)} / "
                         f"{tuple(v.shape)}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq={hq} not a multiple of Hkv={k.shape[1]}")
    if valid.shape != (b, k.shape[2]):
        raise ValueError(f"valid must be (B, L) = {(b, k.shape[2])}, got "
                         f"{tuple(valid.shape)}")


def _launch(q, k, v, valid):
    global LAUNCHES
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_decode kernel takes head_dim in {HEAD_DIMS}, "
                         f"got {d}")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise TypeError(f"flash_decode kernel takes float32/bfloat16, got "
                        f"q {q.dtype}, k {k.dtype}, v {v.dtype}")
    if valid.dtype == torch.bool:
        valid = valid.view(torch.uint8)
    if valid.dtype != torch.uint8:
        raise TypeError(f"valid must be bool or uint8, got {valid.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v), ("valid", valid)):
        if not t.is_contiguous():
            raise ValueError(f"flash_decode kernel needs contiguous {name}")
    if k.data_ptr() % 16 or v.data_ptr() % 16:
        raise ValueError("flash_decode kernel needs 16-byte aligned k/v")
    n = b * hq
    out = torch.empty((n * (d + 2),), dtype=torch.float32, device=q.device)
    acc = out[:n * d].view(b, hq, 1, d)
    m = out[n * d:n * (d + 1)].view(b, hq, 1, 1)
    l = out[n * (d + 1):].view(b, hq, 1, 1)
    fn = _kernel_fn()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, sk,
                 d, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), 1.0 / (d ** 0.5), stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)} {q.dtype}, "
                           f"k {tuple(k.shape)} {k.dtype}")
    LAUNCHES += 1
    return acc, m, l


def flash_decode_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial stats ``(acc, m, l)`` (fp32) for q (B,Hq,1,D) over kv
    (B,Hkv,L,D) with valid (B,L); q head ``h`` reads kv head
    ``h // (Hq/Hkv)``."""
    _check(q, k, v, valid)
    if q.device.type == "cpu":
        ke, ve = _expand_gqa(q, k, v)
        return ref.decode_stats(q, ke, ve, valid)
    if q.device.type != "cuda":
        raise ValueError(f"flash_decode runs on cuda or cpu, got {q.device}")
    return _launch(q, k, v, valid)


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor) -> torch.Tensor:
    """Single-shard decode attention output (B, Hq, 1, D) in q's dtype."""
    return ref.combine([flash_decode_stats(q, k, v, valid)]).to(q.dtype)
