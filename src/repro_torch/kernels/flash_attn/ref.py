"""Plain PyTorch masked attention: the CUDA kernel's plain version.

Port of ``repro.kernels.flash_attn.ref``: exact (non-online) softmax over
all key positions, GQA by repeating kv heads, fp32 scores and output cast
to q's dtype.  Query and key positions are aligned at their ends
(``q_pos = i + Sk - Sq``), as in the reference's oracle; the kernel's
wrapper only takes Sq == Sk, where that is the plain 0-based numbering.

``block_q`` bounds the memory of the scores by taking the query rows in
blocks; each block's softmax is still exact over every key.  Scores, softmax
and P.V are fp32, or fp64 for fp64 inputs: the yardstick against which the
fp32 route's distance is measured (``chip_smoke.py``, the card tests).

:func:`split_tf32` and :func:`attention_tf32_split` model the arithmetic of
the "mma" route's kernel (``csrc/flash_attn.cu``): both products formed on
TF32 operands, three terms of split fp32 operands or one.  Nothing on the
main path calls them; the tests and ``chip_smoke.py`` hold the kernel's
scheme and its one-term control against the reference with them.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(q0: int, q1: int, sq: int, sk: int, causal: bool,
          window: int | None, device) -> torch.Tensor:
    """(q1 - q0, sk) keys admitted for query rows q0 .. q1 - 1, positions
    aligned at their ends (prefill/decode): ``k <= q`` (causal) and
    ``k > q - window``."""
    k_pos = torch.arange(sk, device=device)[None, :]
    q_pos = torch.arange(q0, q1, device=device)[:, None] + (sk - sq)
    mask = torch.ones((q1 - q0, sk), dtype=torch.bool, device=device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    return mask


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window: int | None = None,
              block_q: int | None = None) -> torch.Tensor:
    """q: (B, Hq, Sq, D); k/v: (B, Hkv, Sk, D) -> (B, Hq, Sq, D)."""
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    group = hq // hkv
    acc = torch.promote_types(q.dtype, torch.float32)   # fp32, or fp64
    k = torch.repeat_interleave(k, group, dim=1).to(acc)
    v = torch.repeat_interleave(v, group, dim=1).to(acc)
    scale = 1.0 / math.sqrt(d)
    step = sq if block_q is None else block_q
    outs = []
    for q0 in range(0, sq, step):
        q1 = min(q0 + step, sq)
        s = torch.einsum("bhqd,bhkd->bhqk", q[:, :, q0:q1].to(acc), k) * scale
        s = torch.where(_mask(q0, q1, sq, sk, causal, window, q.device), s,
                        NEG_INF)
        p = torch.softmax(s, dim=-1)
        outs.append(torch.einsum("bhqk,bhkd->bhqd", p, v))
    return torch.cat(outs, dim=2).to(q.dtype)


def _round_tf32(x: torch.Tensor) -> torch.Tensor:
    """fp32 ``x`` rounded to TF32 (10 stored mantissa bits) to nearest, ties
    away from zero, on the bit pattern, as ``cvt.rna.tf32.f32`` does: add
    half of the 13 dropped bits' range to the magnitude, then clear them.
    Subnormals round alike; infinities stay, NaN stays NaN."""
    bits = x.contiguous().view(torch.int32)
    out = ((bits + 0x1000) & ~0x1FFF).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def split_tf32(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 ``x`` as ``(big, small)``, both exact in TF32: ``big`` is x
    rounded to TF32, ``small`` the rounding of ``x - big`` (exact in fp32),
    so ``big + small`` is x to about 2^-22 relative.  A bf16 value widened
    to fp32 has 8 significant bits and its ``small`` is 0."""
    x = x.float()
    big = _round_tf32(x)
    return big, _round_tf32(x - big)


def _tf32_product(eq: str, a: torch.Tensor, b: torch.Tensor,
                  terms: int) -> torch.Tensor:
    """``einsum(eq, a, b)`` on TF32 operands: big.big alone (``terms=1``),
    or big.small + small.big + big.big (``terms=3``), small terms first."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    out = torch.einsum(eq, a_big, b_big)
    if terms == 3:
        out = (torch.einsum(eq, a_big, b_small)
               + torch.einsum(eq, a_small, b_big)) + out
    return out


def attention_tf32_split(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int | None = None,
                         terms: int = 3) -> torch.Tensor:
    """:func:`attention` with both products, q.k and p.v, formed as the
    "mma" kernel forms them: from operands split by :func:`split_tf32`,
    with ``terms=3`` the kernel's 3xTF32 scheme and ``terms=1`` plain TF32
    (one rounding of every operand to 10 mantissa bits).  p is the exact
    softmax numerator ``exp(s - max s)``, split before p.v; the
    denominator is its fp32 sum, as in the kernel."""
    if terms not in (1, 3):
        raise ValueError(f"terms is 1 or 3, got {terms}")
    hq, sq, d = q.shape[1], q.shape[2], q.shape[3]
    hkv, sk = k.shape[1], k.shape[2]
    k = torch.repeat_interleave(k, hq // hkv, dim=1).float()
    v = torch.repeat_interleave(v, hq // hkv, dim=1).float()
    scale = 1.0 / math.sqrt(d)
    s = _tf32_product("bhqd,bhkd->bhqk", q.float(), k, terms) * scale
    s = torch.where(_mask(0, sq, sq, sk, causal, window, q.device), s,
                    NEG_INF)
    p = torch.exp(s - s.amax(dim=-1, keepdim=True))
    out = _tf32_product("bhqk,bhkd->bhqd", p, v, terms)
    return (out / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)).to(q.dtype)
