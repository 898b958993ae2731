"""Wrappers for split-KV decode attention.

Port of ``repro.kernels.flash_decode.ops``.  ``flash_decode_stats`` is the
building block the paged engine consumes: partial softmax statistics over
one KV shard, mergeable with :func:`ref.combine`.  For CUDA tensors it
launches the hand-written kernel (``csrc/flash_decode.cu``) or raises for a
shape the kernel does not take; unlike the reference there is no fallback to
the plain version on the device.  For CPU tensors it runs the plain
version, ``ref.decode_stats``.

The kernel's launch shape is chosen here, before the launch, by
:func:`launch_shape`: its route (bf16 K/V on the tensor cores, fp32 K/V in
SIMT), how the q heads of a GQA group spread over a CTA, and how many CTAs
of a thread-block cluster split the key axis.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.fake import address, count_fake, is_fake
from repro_torch.kernels import LAUNCH_LOCK, _build
from repro_torch.kernels.flash_decode import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_decode.cu"
HEAD_DIMS = (16, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
# the kernel's shape (csrc/flash_decode.cu, checked against the built
# kernel's flash_decode_shape when it is loaded): bytes of K (and of V) in
# one shared-memory tile, q heads a CTA of the "mma" route scores (an mma
# tile's rows), and the portable cluster size limit; the routes' codes in
# the C call
TILE_BYTES = 8192
MMA_HEADS = 16
MAX_CLUSTER = 8
ROUTES = {"mma": 0, "simt": 1}

# kernel launches by this wrapper (CPU calls are not launches)
LAUNCHES = 0


def count_launch() -> None:
    """One launch more in :data:`LAUNCHES` (under the wrappers' shared
    lock: rails launch from threads of their own)."""
    global LAUNCHES
    with LAUNCH_LOCK:
        LAUNCHES += 1


def _expand_gqa(q, k, v):
    group = q.shape[1] // k.shape[1]
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)
    return k, v


@functools.cache
def _kernel_fn():
    """The bound C entry point, built and loaded once per process (the
    launch path then does no file-system or library lookups).  Raises if
    the kernel's shape is not the one :func:`launch_shape` assumes."""
    lib = _build.load(SOURCE)
    shape = (ctypes.c_int * 3)()
    lib.flash_decode_shape.restype = None
    lib.flash_decode_shape(shape)
    if tuple(shape) != (TILE_BYTES, MMA_HEADS, MAX_CLUSTER):
        raise RuntimeError(f"flash_decode kernel's (tile bytes, mma heads, "
                           f"max cluster) {tuple(shape)} differ from the "
                           f"wrapper's {(TILE_BYTES, MMA_HEADS, MAX_CLUSTER)}")
    fn = lib.flash_decode_stats
    fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 4
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def launch_shape(b: int, hq: int, hkv: int, length: int, d: int,
                 kv_itemsize: int, sms: int
                 ) -> tuple[str, int, int, int, int]:
    """``(route, heads_per_warp, head_warps, head_chunks, splits)`` of one
    launch.

    A CTA scores q heads of one GQA group (``Hq / Hkv`` heads) from one
    read of each K/V row.  On the "mma" route (bf16 K/V) its 4 consumer
    warps score all of its heads on the tensor cores, as the rows of an
    mma tile: up to 16 (``heads_per_warp``; ``head_warps`` is 1).  On the
    "simt" route (fp32 K/V) its 8 warps form ``head_warps`` groups of
    ``heads_per_warp`` (1, 2 or 4) heads.  A group that does not fit one
    CTA is cut into ``head_chunks`` CTAs, each reading the rows.
    ``splits`` CTAs of one cluster (at most 8, and no more than the key
    axis has tiles) share the key axis, as many as keep the grid within
    one CTA per SM (an H100 streamed long K/V faster at one than at two,
    PERF.md)."""
    group = hq // hkv
    if kv_itemsize == 2:
        route, head_warps = "mma", 1
        heads_per_warp = max(h for h in range(1, MMA_HEADS + 1)
                             if group % h == 0)
    else:
        route = "simt"
        heads_per_warp = next(h for h in (4, 2, 1) if group % h == 0)
        head_warps = next(w for w in (8, 4, 2, 1)
                          if (group // heads_per_warp) % w == 0)
    head_chunks = group // (heads_per_warp * head_warps)
    tiles = -(-length // (TILE_BYTES // (d * kv_itemsize)))
    splits = max(1, min(MAX_CLUSTER, tiles,
                        sms // (b * hkv * head_chunks)))
    return route, heads_per_warp, head_warps, head_chunks, splits


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


def decode_flops(b: int, hq: int, length: int, d: int) -> int:
    """The function's work: 4*D flops (q.k and p.v, a multiply and an add
    each) per (batch, q head, key) over all ``length`` keys, the valid and
    the masked alike (the kernel scores every key it reads)."""
    return 4 * b * hq * length * d


def _kernel_checks(q, k, v, valid) -> torch.Tensor:
    """Raises for what the kernel does not take; returns ``valid`` as the
    kernel reads it (uint8)."""
    d = q.shape[3]
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
    if address(k) % 16 or address(v) % 16:
        raise ValueError("flash_decode kernel needs 16-byte aligned k/v")
    return valid


def _outputs(q):
    """``(acc, m, l)``: views of one fp32 allocation, as the kernel writes
    them."""
    b, hq, _, d = q.shape
    n = b * hq
    out = torch.empty((n * (d + 2),), dtype=torch.float32, device=q.device)
    acc = out[:n * d].view(b, hq, 1, d)
    m = out[n * d:n * (d + 1)].view(b, hq, 1, 1)
    l = out[n * (d + 1):].view(b, hq, 1, 1)
    return acc, m, l


def _fake_launch(q, k, v, valid):
    """The fake route (:mod:`repro_torch.fake`): the kernel's outputs, and
    nothing launched or read from the card (its route depends only on the
    K/V dtype, not on the SM count)."""
    valid = _kernel_checks(q, k, v, valid)
    b, hq, _, d = q.shape
    acc, m, l = _outputs(q)
    way = launch_shape(b, hq, k.shape[1], k.shape[2], d, k.element_size(),
                       1)[0]
    count_fake("flash_decode", way,
               flops=decode_flops(b, hq, k.shape[2], d),
               nbytes=sum(t.numel() * t.element_size()
                          for t in (q, k, v, valid))
               + b * hq * (d + 2) * 4)
    return acc, m, l


def _launch(q, k, v, valid):
    b, hq, _, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    valid = _kernel_checks(q, k, v, valid)
    acc, m, l = _outputs(q)
    fn = _kernel_fn()
    route, hc, hw, _, splits = launch_shape(b, hq, hkv, sk, d,
                                            k.element_size(),
                                            _sm_count(q.device.index))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), valid.data_ptr(),
                 acc.data_ptr(), m.data_ptr(), l.data_ptr(), b, hq, hkv, sk,
                 d, int(q.dtype == torch.bfloat16),
                 int(k.dtype == torch.bfloat16), 1.0 / (d ** 0.5),
                 ROUTES[route], hc, hw, splits, stream)
    if err:
        raise RuntimeError(f"flash_decode kernel launch failed: CUDA error "
                           f"{err} at q {tuple(q.shape)} {q.dtype}, "
                           f"k {tuple(k.shape)} {k.dtype}, {route} route, "
                           f"cluster of {splits}")
    count_launch()
    return acc, m, l


def flash_decode_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       valid: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial stats ``(acc, m, l)`` (fp32) for q (B,Hq,1,D) over kv
    (B,Hkv,L,D) with valid (B,L); q head ``h`` reads kv head
    ``h // (Hq/Hkv)``."""
    _check(q, k, v, valid)
    if is_fake(q, k, v, valid):
        return _fake_launch(q, k, v, valid)
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
