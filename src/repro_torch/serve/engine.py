"""Paged decode engine: flash-decode attention over the KV page arena.

Port of ``repro.serve.engine``.  One step decodes one token for every slot
against the paged KV cache:

* **One arena tensor.**  The whole KV cache is the flat page arena from
  :func:`repro_torch.serve.kv.plan_kv_arena`, allocated once when the engine
  is built; each step writes the new token's K/V into it in place (the
  PyTorch counterpart of the reference's donated buffer).
* **Attention through the CUDA kernel.**  Each layer gathers the slots'
  pages into dense K/V and scores them with :func:`repro_torch.kernels.
  flash_decode.flash_decode_stats` (``attn_impl="kernel"``) or its plain
  version (``"ref"``).  Where the model's GQA map is the kernel's uniform
  ``h // (Hq/Hkv)`` (:func:`gqa_is_uniform`: no padded query heads), the
  kernel takes the gathered K/V as they are, and reads each K/V row once
  for its whole group of query heads.  Otherwise, and for ``"ref"``, K/V
  are first expanded to one KV head per (padded) query head.
* **Page-parallel decode on the model axis.**  Weights replicate over the
  model axis; at ``model_parallel = R > 1`` (a mesh with a model axis of
  R) each rank gathers and scores its static ``blocks_per_rank`` chunk of
  the page-table columns, then the partial softmax statistics merge over
  the ranks with one ``pmax`` of the running max and ONE fused
  :meth:`Communicator.all_reduce` of ``[acc·w, l·w]`` (transport
  ``psum`` over the model axis): two collectives a layer a token, zero at
  one rank (:func:`predicted_collectives_per_token`).

* **MoE layers** run :func:`~repro_torch.models.moe.moe_apply` on the
  whole expert stacks (every rank holds every weight, so no all-to-all is
  issued at any ``model_parallel``); only all-global-attention configs
  reach the engine (the page table refuses windowed and chunked layers).

Admission, eviction and page recycling are host-side numpy, as in the
reference.  The host's page table and slot vectors travel to the device once
per step, in one copy.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.comm.api import CommConfig, Communicator
from repro_torch.configs.base import ModelConfig
from repro_torch.core.topology import RankMesh
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models.attention import (_merge_heads, _split_heads,
                                          padded_heads)
from repro_torch.models.common import (apply_rope, dense, embed, glu_mlp,
                                       rmsnorm, unembed)
from repro_torch.models.moe import moe_apply
from repro_torch.models.parallel import SINGLE, make_ctx
from repro_torch.obs import NULL_OBS
from repro_torch.serve.kv import KVArenaPlan, KVPageAllocator, PageTable

# ---------------------------------------------------------------------------
# prediction layer
# ---------------------------------------------------------------------------


def predicted_collectives_per_token(plan: KVArenaPlan) -> int:
    """All-reduce ops one decode step issues: a max + one fused LSE stats
    reduce per layer when the block dim is split over ranks, else zero."""
    return 2 * plan.n_layers if plan.model_parallel > 1 else 0


def predicted_wire_bytes_per_token(plan: KVArenaPlan, cfg: ModelConfig,
                                   batch: int) -> float:
    """Per-device all-reduce wire bytes of one decode step (ring lower
    bound, ``2(R-1)/R`` hops): the fp32 running max (B·Hq) plus the fused
    numerator+denominator buffer (B·Hq·(D+1)) per layer."""
    r = plan.model_parallel
    if r <= 1:
        return 0.0
    hq = padded_heads(cfg.attn.num_heads)
    hops = 2.0 * (r - 1) / r
    per_layer = (batch * hq + batch * hq * (plan.head_dim + 1)) * 4
    return plan.n_layers * per_layer * hops


def gqa_is_uniform(n_hq: int, n_kv: int, true_group: int) -> bool:
    """Whether the model's GQA map, ``clamp(h // true_group, 0, n_kv - 1)``
    over its ``n_hq`` (padded) query heads, is the uniform
    ``h // (n_hq / n_kv)`` a kernel folds into its addressing.  Padded
    query heads clip to the last KV head, so a padded head count breaks
    it."""
    if n_hq % n_kv:
        return False
    h = np.arange(n_hq)
    return bool(np.array_equal(np.clip(h // true_group, 0, n_kv - 1),
                               h // (n_hq // n_kv)))


# ---------------------------------------------------------------------------
# paged read/write (device side)
# ---------------------------------------------------------------------------


def _write_token_kv(pages: torch.Tensor, plan: KVArenaPlan, layer: int,
                    table: torch.Tensor, slot_len: torch.Tensor,
                    rows: torch.Tensor, k1: torch.Tensor,
                    v1: torch.Tensor) -> None:
    """Write this step's K/V (B, Hkv, 1, D) into each slot's current page,
    in place.

    ``rows`` are the slots to write: live, with their current block mapped.
    The reference writes every slot and sends the others to an
    out-of-bounds index that its scatter drops; on the card such an index
    is a device-side fault, so only the rows where that test holds are
    written (the host picks them, as it owns the page table)."""
    pt, d, hkv = plan.page_tokens, plan.head_dim, plan.num_kv_heads
    pos = slot_len[rows].long()
    page = table[rows, pos // pt, layer].long()
    base = page * plan.page_stride + (pos % pt) * d                 # (n,)
    dev = pages.device
    idx = (base[:, None, None]
           + (torch.arange(hkv, device=dev) * (pt * d))[None, :, None]
           + torch.arange(d, device=dev)[None, None, :])             # (n,Hkv,D)
    pages[idx] = k1[rows, :, 0, :].to(pages.dtype)
    pages[idx + plan.v_offset] = v1[rows, :, 0, :].to(pages.dtype)


def _gather_local_kv(pages: torch.Tensor, plan: KVArenaPlan, layer: int,
                     table: torch.Tensor, rank: int = 0):
    """This rank's chunk of the paged cache as dense (B, Hkv, L_local, D)
    K/V, plus its page-table slice (for validity).  Unmapped blocks
    (id -1) read page 0; :func:`_local_valid` masks them."""
    bpr, pt, d = plan.blocks_per_rank, plan.page_tokens, plan.head_dim
    hkv = plan.num_kv_heads
    tab = table[:, rank * bpr:(rank + 1) * bpr, layer]              # (B, bpr)
    arena = pages.view(plan.n_kv_pages, plan.page_stride)
    arena = arena[:, :plan.payload_elems].view(plan.n_kv_pages, 2, hkv, pt, d)
    g = arena[tab.clamp(min=0).long()]                    # (B,bpr,2,Hkv,Pt,D)
    b = g.shape[0]
    k = g[:, :, 0].transpose(1, 2).reshape(b, hkv, bpr * pt, d)
    v = g[:, :, 1].transpose(1, 2).reshape(b, hkv, bpr * pt, d)
    return k, v, tab


def _local_valid(plan: KVArenaPlan, tab: torch.Tensor, slot_len: torch.Tensor,
                 slot_valid: torch.Tensor, rank: int = 0) -> torch.Tensor:
    """(B, L_local) mask: position exists (≤ current pos, incl. the token
    just written), its block is mapped, and the slot is live."""
    bpr, pt = plan.blocks_per_rank, plan.page_tokens
    dev = tab.device
    blk = rank * bpr + torch.arange(bpr, device=dev)
    gpos = blk[:, None] * pt + torch.arange(pt, device=dev)[None, :]  # (bpr,Pt)
    ok = gpos[None] <= slot_len[:, None, None]
    ok = ok & (tab >= 0)[:, :, None] & slot_valid[:, None, None]
    return ok.reshape(ok.shape[0], bpr * pt)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def build_paged_decode_step(model, plan: KVArenaPlan, *,
                            attn_impl: str = "kernel",
                            mesh: RankMesh | None = None):
    """Returns ``step(pages, params, table, token, slot_len, slot_valid,
    rows) -> logits (B, vocab)``; ``pages`` is written in place.

    ``params`` is the full tree: every rank holds every weight.
    ``attn_impl``: "kernel" scores pages with the CUDA flash-decode kernel
    (its plain version for CPU tensors), "ref" with the plain version.
    ``mesh`` (a ``("data", "model")`` mesh; one rank without it) must have
    a model axis of ``plan.model_parallel``; over several ranks building
    the step makes process groups, which is collective, and every rank
    calls the step together.  The step's :class:`Communicator` (``None``
    at one rank) records both collectives of each layer
    (``step.comm.record``).
    """
    if attn_impl not in ("kernel", "ref"):
        raise ValueError(f"attn_impl must be kernel|ref, got {attn_impl!r}")
    cfg = model.cfg
    mesh = mesh or RankMesh(("data", "model"), (1, 1))
    r_mesh = mesh.sizes().get("model", 1)
    if r_mesh != plan.model_parallel:
        raise ValueError(
            f"plan was laid out for model_parallel={plan.model_parallel} "
            f"but the mesh model axis is {r_mesh}; re-plan with this mesh")
    r = plan.model_parallel
    comm, ctx = None, SINGLE
    if r > 1:
        comm = Communicator(mesh, CommConfig(transport="psum",
                                             data_axes=("model",),
                                             channels=1))
        ctx = make_ctx(mesh, record=comm.record)
    rank = ctx.model_index()
    cdt = getattr(torch, cfg.dtype)
    hkv, hd = cfg.attn.num_kv_heads, cfg.attn.head_dim
    true_group = max(cfg.attn.num_heads // hkv, 1)
    stats = (fd_ops.flash_decode_stats if attn_impl == "kernel"
             else fd_ref.decode_stats)
    # the plain version takes equal head counts; the kernel takes the
    # gathered K/V as they are where its uniform map is the model's
    grouped = attn_impl == "kernel" and gqa_is_uniform(
        padded_heads(cfg.attn.num_heads), hkv, true_group)

    def attend(q, pages, layer, table, slot_len, slot_valid):
        k, v, tab = _gather_local_kv(pages, plan, layer, table, rank)
        if grouped:
            # one block per slot gathers as a strided view
            k, v = k.contiguous(), v.contiguous()
        else:
            # true-group GQA map (padded q heads clip to the last kv head):
            # expand kv per q head; the uniform h//group map would mis-pair
            # padded head counts
            kv_idx = torch.clamp(torch.arange(q.shape[1], device=q.device)
                                 // true_group, 0, hkv - 1)
            k = k.index_select(1, kv_idx)
            v = v.index_select(1, kv_idx)
        valid = _local_valid(plan, tab, slot_len, slot_valid, rank)
        acc, m, l = stats(q, k, v, valid)
        if r == 1:
            return fd_ref.combine([(acc, m, l)]).to(q.dtype)
        m_g = ctx.pmax(m)
        w = torch.exp(m - m_g)
        n_num = acc.numel()
        buf = torch.cat([(acc * w).reshape(-1), (l * w).reshape(-1)])
        red = comm.all_reduce([buf])[0]
        num = red[:n_num].view(acc.shape)
        den = red[n_num:].view(l.shape)
        return (num / torch.clamp(den, min=1e-30)).to(q.dtype)

    def step(pages, params, table, token, slot_len, slot_valid, rows):
        x = embed(params["embed"], token[:, None], cdt)
        posb = slot_len[:, None]                       # per-slot position
        for i, bp in enumerate(params["blocks"]):
            h = rmsnorm(bp["ln1"], x, cfg.norm_eps)
            pa = bp["attn"]
            n_hq = pa["wq"]["w"].shape[1] // hd
            q = _split_heads(dense(pa["wq"], h, cdt), n_hq)
            k1 = _split_heads(dense(pa["wk"], h, cdt), hkv)
            v1 = _split_heads(dense(pa["wv"], h, cdt), hkv)
            q = apply_rope(q, posb, cfg.attn.rope_theta)
            k1 = apply_rope(k1, posb, cfg.attn.rope_theta)
            _write_token_kv(pages, plan, i, table, slot_len, rows, k1, v1)
            o = attend(q, pages, i, table, slot_len, slot_valid)
            x = x + dense(pa["wo"], _merge_heads(o), cdt).to(x.dtype)
            if "moe" in bp:
                # the weights are whole on every rank (no expert is
                # sharded), so moe_apply takes its one-rank route and
                # issues no collective, at any model_parallel
                h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
                y, _, _ = moe_apply(bp["moe"], h2, cfg.moe, cfg.act, ctx=ctx,
                                    compute_dtype=cdt)
                x = x + y.to(x.dtype)
            elif "mlp" in bp:
                h2 = rmsnorm(bp["ln2"], x, cfg.norm_eps)
                x = x + glu_mlp(bp["mlp"], h2, cfg.act, cdt).to(x.dtype)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        if cfg.tie_embeddings:
            logits = unembed(params["embed"], x, cdt)
        else:
            logits = dense(params["lm_head"], x, cdt)
        return logits[:, 0]

    step.comm = comm
    return step


def _compute_copy(tree, cdt: torch.dtype):
    """The weights ``dense``/``embed``/``unembed`` cast to the compute type,
    cast once.  ``dense`` casts the fp32 master weight on every call; the
    copy holds the same bits, so the step computes the same numbers while
    reading the weights in bf16 once per step instead of fp32 plus a cast
    (about 7.5 GB less traffic per llama3.2-1b step).  The MoE expert
    stacks, which ``moe_apply`` casts on every call too, are cast here as
    well.  Norm scales stay fp32, as the reference reads them."""
    if isinstance(tree, list):
        return [_compute_copy(t, cdt) for t in tree]
    if not isinstance(tree, dict):
        return tree
    out = {}
    for k, v in tree.items():
        if k in ("w", "b", "table", "w_gate", "w_up", "w_down") \
                and isinstance(v, torch.Tensor):
            out[k] = v.to(cdt)
        else:
            out[k] = _compute_copy(v, cdt)
    return out


# ---------------------------------------------------------------------------
# host-side engine: slots, pages
# ---------------------------------------------------------------------------


class PagedDecodeEngine:
    """Slot-indexed decode over the page arena.

    Owns the arena tensor, the free-list allocator and the page table;
    :meth:`decode` runs one step for every slot.  All slot management is
    host numpy with fixed shapes."""

    def __init__(self, model, plan: KVArenaPlan, *, attn_impl: str = "kernel",
                 device: str | torch.device = "cuda", obs=None,
                 mesh: RankMesh | None = None):
        self.model, self.plan = model, plan
        self.device = resolve_device(device)
        self.obs = obs if obs is not None else NULL_OBS
        self.step = build_paged_decode_step(model, plan, attn_impl=attn_impl,
                                            mesh=mesh)
        self.comm = self.step.comm
        self.allocator = KVPageAllocator(plan.n_kv_pages)
        self.table = PageTable(plan.max_seqs, plan.max_blocks, plan.n_layers)
        self.slot_len = np.zeros((plan.max_seqs,), np.int32)
        self.slot_valid = np.zeros((plan.max_seqs,), bool)
        self.pages = plan.zeros(self.device)
        self._cdt = getattr(torch, model.cfg.dtype)
        self._params_src = None
        self._params = None

    # -- slot management (host side) ----------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i in range(self.plan.max_seqs) if not self.slot_valid[i]]

    def pages_for(self, n_tokens: int) -> int:
        """Worst-case pages a sequence of ``n_tokens`` needs (all layers)."""
        return math.ceil(n_tokens / self.plan.page_tokens) * self.plan.n_layers

    def can_admit(self, n_tokens: int) -> bool:
        return (bool(self.free_slots())
                and self.allocator.n_free >= self.pages_for(n_tokens))

    def admit(self, slot: int) -> None:
        if self.slot_valid[slot]:
            raise ValueError(f"slot {slot} is already live")
        self.slot_len[slot] = 0
        self.slot_valid[slot] = True
        self._ensure_block(slot)
        self.obs.counter("admits")
        self.obs.event("admit", slot=slot, pages_free=self.allocator.n_free)
        self._kv_gauges()

    def retire(self, slot: int) -> None:
        tokens = int(self.slot_len[slot])
        self.allocator.free(self.table.clear_slot(slot))
        self.slot_valid[slot] = False
        self.slot_len[slot] = 0
        self.obs.counter("retires")
        self.obs.event("retire", slot=slot, tokens=tokens,
                       pages_free=self.allocator.n_free)
        self._kv_gauges()

    def _kv_gauges(self) -> None:
        """Arena health after a slot transition: page occupancy and waste
        (mapped capacity not yet holding a token)."""
        alloc, plan = self.allocator, self.plan
        used = alloc.n_total - alloc.n_free
        self.obs.gauge("kv_pages_used", used)
        self.obs.gauge("kv_pages_free", alloc.n_free)
        self.obs.gauge("kv_page_occupancy", used / max(alloc.n_total, 1))
        cap_tokens = (used // plan.n_layers) * plan.page_tokens
        held = int(self.slot_len[self.slot_valid].sum())
        waste = 1.0 - held / cap_tokens if cap_tokens else 0.0
        self.obs.gauge("kv_page_waste", waste)
        self.obs.gauge("live_slots", int(self.slot_valid.sum()))

    def _ensure_block(self, slot: int) -> None:
        blk = int(self.slot_len[slot]) // self.plan.page_tokens
        if self.table.table[slot, blk, 0] < 0:
            self.table.map_block(slot, blk,
                                 self.allocator.alloc(self.plan.n_layers))

    def _compute_params(self, params):
        """The compute-type copy of ``params``, rebuilt only when a
        different tree is passed (in-place edits to the same tree are not
        seen: the engine serves fixed weights)."""
        if params is not self._params_src:
            self._params = _compute_copy(params, self._cdt)
            self._params_src = params
        return self._params

    def _device_inputs(self, token):
        """Page table, token, slot vectors and the rows to write, in one
        host-to-device copy."""
        plan, s = self.plan, self.plan.max_seqs
        tab = self.table.table
        blk = np.minimum(self.slot_len // plan.page_tokens, plan.max_blocks - 1)
        mapped = (tab[np.arange(s), blk] >= 0).all(axis=-1)
        rows = np.nonzero(self.slot_valid & mapped)[0]
        parts = [tab.reshape(-1), np.asarray(token, np.int32).reshape(s),
                 self.slot_len, self.slot_valid.astype(np.int32),
                 rows.astype(np.int32)]
        buf = torch.from_numpy(np.concatenate(parts)).to(self.device)
        out, o = [], 0
        for p in parts:
            out.append(buf[o:o + p.size])
            o += p.size
        table, tok, slot_len, valid, rows_d = out
        return (table.view(tab.shape), tok, slot_len, valid.bool(),
                rows_d.long())

    # -- the hot loop --------------------------------------------------------

    def decode(self, params, token) -> torch.Tensor:
        """One decode step: write ``token[slot]`` at each live slot's
        position, attend over its pages, return logits (B, vocab).
        Invalid slots' rows are garbage by contract."""
        for s in np.nonzero(self.slot_valid)[0]:
            self._ensure_block(int(s))
        table, tok, slot_len, slot_valid, rows = self._device_inputs(token)
        logits = self.step(self.pages, self._compute_params(params), table,
                           tok, slot_len, slot_valid, rows)
        self.slot_len[self.slot_valid] += 1
        return logits
