"""Plain PyTorch masked attention: the CUDA kernel's plain version.

Port of ``repro.kernels.flash_attn.ref``: exact (non-online) softmax over
all key positions, GQA by repeating kv heads, fp32 scores and output cast
to q's dtype.  Query and key positions are aligned at their ends
(``q_pos = i + Sk - Sq``), as in the reference's oracle; the kernel's
wrapper only takes Sq == Sk, where that is the plain 0-based numbering.

``block_q`` bounds the memory of the scores by taking the query rows in
blocks; each block's softmax is still exact over every key.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              block_q: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    k = torch.repeat_interleave(k, group, dim=1).float()
    v = torch.repeat_interleave(v, group, dim=1).float()
    scale = 1.0 / math.sqrt(d)
    k_pos = torch.arange(sk, device=q.device)[None, :]
    step = sq if block_q is None else block_q
    outs = []
    for q0 in range(0, sq, step):
        q1 = min(q0 + step, sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].float(), k) * scale
        # align ends (prefill/decode)
        q_pos = torch.arange(q0, q1, device=q.device)[:, None] + (sk - sq)
        mask = torch.ones((q1 - q0, sk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= k_pos <= q_pos
        if window is not None:
            mask &= k_pos > q_pos - window
        s = torch.where(mask, s, NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v))
    return torch.cat(outs, dim=2).to(q.dtype)
