"""Wrapper for blockwise (flash) attention forward, the serving prefill's
attention.

Port of ``repro.kernels.flash_attn.ops``.  For CUDA tensors it launches one
of two hand-written kernels, or raises for what they do not take.
:func:`route` chooses the kernel from dtype and layout before any launch:

* ``"wgmma"``: ``csrc/flash_attn_wgmma.cu``, for bf16 inputs whose base
  addresses and batch, head and sequence strides TMA takes (positive
  multiples of 16 bytes; the stride of an axis of length 1 is never read).
  Tensor cores fed by TMA; p enters P.V as two bf16 halves (about 2^-17
  relative, not the reference's fp32 p).
* ``"mma"``: ``csrc/flash_attn.cu``, TF32 ``mma.sync`` with the 3xTF32
  split (fp32 accuracy; bf16 inputs skip the products of their zero small
  halves), for fp32 inputs and for bf16 layouts TMA cannot take.  K/V tiles
  move in 16-byte copies where :func:`_rows_aligned16` holds for k and v.

Unlike the reference, which falls back to its oracle when S does not tile
or D % 8 != 0, nothing falls back on the device: both kernels mask a ragged
last tile themselves, and no failed build or launch leads to another route.
For CPU tensors it runs the plain version, ``ref.attention``.

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

from repro_torch.fake import address, count_fake, is_fake
from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.flash_attn import ref

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attn.cu"               # the "mma" route
WGMMA_SOURCE = CSRC / "flash_attn_wgmma.cu"   # the "wgmma" route
HEAD_DIMS = (16, 32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_TMA_ALIGN = 16      # bytes: TMA's base address and stride unit

# kernel launches by this wrapper (CPU calls are not launches): the sum, and
# by route
LAUNCHES = 0
LAUNCHES_BY_ROUTE = {"wgmma": 0, "mma": 0}


def count_launch(way: str) -> None:
    """One launch more in :data:`LAUNCHES` and on route ``way`` (under the
    wrappers' shared lock: rails launch from threads of their own)."""
    global LAUNCHES
    with LAUNCH_LOCK:
        LAUNCHES += 1
        LAUNCHES_BY_ROUTE[way] += 1


@functools.cache
def _kernel_fn():
    """The bound C entry point, built and loaded once per process."""
    fn = _build.load(SOURCE).flash_attention_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_fn():
    """The wgmma kernel's bound C entry point, built and loaded once per
    process."""
    fn = _build.load(WGMMA_SOURCE).flash_attention_wgmma_fwd
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 5
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _admitted_pairs(s: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs of one (batch, head) that the mask admits: key
    ``k`` for query ``i`` where ``k <= i`` (causal) and ``k > i - window``."""
    w = s if window is None else min(window, s)
    if causal:      # min(i + 1, w) keys for query i
        return w * (w + 1) // 2 + (s - w) * w
    # s - max(0, i - w + 1) keys for query i
    return s * s - (s - w) * (s - w + 1) // 2


def attention_flops(b: int, hq: int, s: int, d: int, causal: bool = True,
                    window: int | None = None) -> int:
    """The function's work: 4*D flops (q.k and p.v, a multiply and an add
    each) per admitted (query, key) pair, for every batch and query head;
    4*B*Hq*D*S*(S+1)/2 causal without a window.  The card's bound is
    counted from this, never from what a kernel executes beyond it."""
    return 4 * b * hq * d * _admitted_pairs(s, causal, window)


def _rows_aligned16(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` starts 16-byte aligned: its base address
    and its batch, head and sequence strides are multiples of 16 bytes on
    every axis longer than 1 (a zero stride is one)."""
    size = t.element_size()
    return address(t) % _TMA_ALIGN == 0 and all(
        n == 1 or st * size % _TMA_ALIGN == 0
        for n, st in zip(t.shape[:3], t.stride()[:3]))


def _tma_layout(t: torch.Tensor) -> bool:
    """Whether TMA takes ``t``'s base address and its batch, head and
    sequence strides: positive multiples of 16 bytes on every axis longer
    than 1."""
    return _rows_aligned16(t) and all(
        n == 1 or st > 0 for n, st in zip(t.shape[:3], t.stride()[:3]))


def _tma_strides(t: torch.Tensor) -> list[int]:
    """``t``'s batch, head and sequence strides for the wgmma kernel's TMA
    maps; the stride of an axis of length 1 is never read, so it is given
    as one row of D elements, which TMA takes."""
    return [t.shape[3] if n == 1 else st
            for n, st in zip(t.shape[:3], t.stride()[:3])]


def route(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The kernel that :func:`flash_attention` launches for CUDA q/k/v of
    one dtype: ``"wgmma"`` for bf16 whose layouts TMA takes
    (:func:`_tma_layout`), else ``"mma"``.  It reads only dtype, shape,
    strides and ``data_ptr()``, so CPU tensors are routed as the same
    layout on the card would be, and fake tensors by their offsets in their
    storages (:func:`repro_torch.fake.address`); other devices, or q/k/v
    on more than one device, raise."""
    devs = {t.device for t in (q, k, v)}
    if len(devs) != 1 or (next(iter(devs)).type not in ("cuda", "cpu")
                          and not is_fake(q, k, v)):
        raise ValueError(f"route takes q/k/v on one cuda or cpu device, "
                         f"got {sorted(map(str, devs))}")
    if q.dtype == torch.bfloat16 and all(map(_tma_layout, (q, k, v))):
        return "wgmma"
    return "mma"


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


def _kernel_checks(q, k, v) -> None:
    d = q.shape[3]
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


def _fake_launch(q, k, v, causal, window):
    """The fake route (:mod:`repro_torch.fake`): the kernel's output, and
    nothing launched."""
    _kernel_checks(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    count_fake("flash_attn", route(q, k, v),
               flops=attention_flops(b, hq, s, d, causal, window),
               nbytes=sum(t.numel() * t.element_size() for t in (q, k, v,
                                                                 out)))
    return out


def _launch(q, k, v, causal, window):
    _kernel_checks(q, k, v)
    b, hq, s, d = q.shape
    way = route(q, k, v)
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    # a window as long as the sequence masks nothing
    win = window if window is not None and window < s else 0
    scale = 1.0 / (d ** 0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        if way == "wgmma":
            err = _wgmma_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                              out.data_ptr(), b, hq, k.shape[1], s, d,
                              *_tma_strides(q), *_tma_strides(k),
                              *_tma_strides(v), scale, int(causal), win,
                              stream)
        else:
            err = _kernel_fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                               out.data_ptr(), b, hq, k.shape[1], s, d,
                               int(q.dtype == torch.bfloat16),
                               int(_rows_aligned16(k) and _rows_aligned16(v)),
                               *q.stride()[:3], *k.stride()[:3],
                               *v.stride()[:3], scale, int(causal), win,
                               stream)
    if err:
        what = (f"the driver refused a TMA tensor map (CUresult "
                f"{err - 1000})" if way == "wgmma" and err >= 1000
                else f"CUDA error {err}")
        raise RuntimeError(f"flash_attention {way} kernel launch failed: "
                           f"{what} at q {tuple(q.shape)}, k "
                           f"{tuple(k.shape)}, {q.dtype}")
    count_launch(way)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    chunk: int | None = None) -> torch.Tensor:
    """Attention output (B, Hq, S, D) in q's dtype for q (B, Hq, S, D) over
    k/v (B, Hkv, S, D); q head ``h`` reads kv head ``h // (Hq/Hkv)``."""
    _check(q, k, v, window, chunk)
    if is_fake(q, k, v):
        return _fake_launch(q, k, v, causal, window)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got "
                         f"{q.device}")
    return _launch(q, k, v, causal, window)
