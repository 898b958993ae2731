"""Plain PyTorch split-KV decode attention: the CUDA kernel's plain version.

Port of ``repro.kernels.flash_decode.ref``.  Decode attention factors into
**partial softmax statistics** over any partition of the key positions::

    stats(q, K, V) = (acc, m, l)       # unnormalised numerator, running
                                       # max, denominator
    out            = combine(parts) = Σ acc_i·e^{m_i−m} / Σ l_i·e^{m_i−m}

:func:`decode_stats` is the one-shot version the kernel is held against on
the card and the wrapper runs for CPU tensors; :func:`decode_stats_blockwise`
is the online-softmax loop the kernel runs, tile by tile.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30   # finite, so a row with no valid key stays finite


def decode_stats(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 valid: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partial attention statistics over one KV shard.

    q: (B, H, 1, D); k/v: (B, H, L, D); valid: (B, L) bool (or 0/1).
    Returns fp32 ``(acc (B,H,1,D), m (B,H,1,1), l (B,H,1,1))``.
    """
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() / math.sqrt(d), k.float())
    s = torch.where(valid.bool()[:, None, None, :], s, NEG_INF)
    m = torch.amax(s, dim=-1, keepdim=True)
    e = torch.exp(s - m)
    acc = torch.einsum("bhqk,bhkd->bhqd", e, v.float())
    l = torch.sum(e, dim=-1, keepdim=True)
    return acc, m, l


def decode_stats_blockwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           valid: torch.Tensor, *, block_k: int = 128
                           ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Online-softmax loop over key tiles of ``block_k`` (L must tile)."""
    b, h, _, d = q.shape
    sk = k.shape[2]
    if sk % block_k:
        raise ValueError(f"L={sk} must tile by block_k={block_k}")
    scale = 1.0 / (d ** 0.5)
    dev = q.device
    m = torch.full((b, h, 1, 1), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, 1, 1), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, 1, d), dtype=torch.float32, device=dev)
    qf = q.float()
    for j in range(sk // block_k):
        k0 = j * block_k
        kj = k[:, :, k0:k0 + block_k].float()
        vj = v[:, :, k0:k0 + block_k].float()
        s = torch.matmul(qf, kj.transpose(-1, -2)) * scale      # (B,H,1,bk)
        ok = valid[:, None, None, k0:k0 + block_k] != 0
        s = torch.where(ok, s, NEG_INF)
        m_new = torch.maximum(m, torch.amax(s, dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = alpha * l + torch.sum(p, dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p, vj)
        m = m_new
    return acc, m, l


def combine(parts) -> torch.Tensor:
    """Merge split-KV partial stats ``[(acc, m, l), ...]`` into the
    normalised output — identical to the full softmax over the
    concatenated key positions."""
    m = parts[0][1]
    for _, mi, _ in parts[1:]:
        m = torch.maximum(m, mi)
    num = torch.zeros_like(parts[0][0])
    den = torch.zeros_like(parts[0][2])
    for acc, mi, li in parts:
        w = torch.exp(mi - m)
        num = num + acc * w
        den = den + li * w
    return num / torch.clamp(den, min=1e-30)


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     valid: torch.Tensor, *, splits: int = 1) -> torch.Tensor:
    """Full decode attention via ``splits`` KV shards + LSE combine."""
    sk = k.shape[2]
    if sk % splits:
        raise ValueError(f"L={sk} must tile by splits={splits}")
    c = sk // splits
    parts = [decode_stats(q, k[:, :, i * c:(i + 1) * c],
                          v[:, :, i * c:(i + 1) * c],
                          valid[:, i * c:(i + 1) * c])
             for i in range(splits)]
    return combine(parts).to(q.dtype)
