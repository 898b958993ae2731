"""Logical-axis sharding rules: parameter trees -> per-leaf specs.

Port of ``repro.sharding.rules``.  A *spec* is a tuple with one entry per
dimension of its leaf: ``None`` (replicated along that dimension), an axis
name, or a tuple of axis names (the dimension is split over their joint
index, outermost first), the port's stand-in for ``PartitionSpec``.  A
mesh is anything with ``axis_names`` and either ``sizes()`` (a
:class:`~repro_torch.core.topology.RankMesh`) or ``devices.shape``.

Policies:

* ``tp`` — tensor parallelism over ``"model"`` only; parameters
  replicated over the data axes;
* ``fsdp`` — additionally split the non-model dimension of every large
  matrix over ``"data"``.

The rules go by the names on the path of each leaf of the trees the models
emit (nested dicts and lists).  A dimension is split only when the axis
divides it; otherwise it stays replicated (kv heads, whose count does not
tile the model axis, replicate; query heads are padded to tile it).

:func:`local_shard` stands for ``NamedSharding`` placement: this rank's
block of every leaf; :func:`global_from_shards` is its inverse over the
ranks of a mesh.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Sequence

MODEL_AXIS = "model"
DATA_AXIS = "data"
POD_AXIS = "pod"

Spec = tuple


def axis_sizes(mesh) -> dict[str, int]:
    if hasattr(mesh, "sizes"):
        return mesh.sizes()
    return dict(zip(mesh.axis_names, mesh.devices.shape))


def _div(n: int, size: int) -> bool:
    return size > 0 and n % size == 0


def batch_spec(global_batch: int, mesh) -> Spec:
    """The batch split over ``("pod", "data")`` when their product divides
    it, else over ``"data"``, else not at all."""
    sizes = axis_sizes(mesh)
    axes = [a for a in (POD_AXIS, DATA_AXIS) if a in sizes]
    prod = math.prod(sizes[a] for a in axes)
    if axes and _div(global_batch, prod):
        # one axis stands alone, as PartitionSpec normalises it
        return (tuple(axes) if len(axes) > 1 else axes[0],)
    if DATA_AXIS in sizes and _div(global_batch, sizes[DATA_AXIS]):
        return (DATA_AXIS,)
    return ()


# ---------------------------------------------------------------------------
# tree walks: nested dicts and lists; a tuple is a spec, never a node
# ---------------------------------------------------------------------------


def map_with_path(fn: Callable, tree, path: tuple[str, ...] = ()):
    """``fn(path, leaf)`` over every leaf of a tree of dicts and lists;
    ``path`` holds the dict keys and list positions as strings."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_with_path(fn, v, path + (str(i),))
                for i, v in enumerate(tree)]
    return fn(path, tree)


def map_specs(fn: Callable, tree, specs):
    """``fn(leaf, spec)`` over a tree and its congruent spec tree."""
    if isinstance(tree, dict):
        return {k: map_specs(fn, v, specs[k]) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_specs(fn, v, s) for v, s in zip(tree, specs)]
    return fn(tree, specs)


def spec_leaves(specs) -> list[Spec]:
    """The specs in the order :func:`repro_torch.tree.flatten` visits the
    leaves of the congruent tree (sorted dict keys, list positions)."""
    if isinstance(specs, dict):
        return [s for k in sorted(specs) for s in spec_leaves(specs[k])]
    if isinstance(specs, list):
        return [s for v in specs for s in spec_leaves(v)]
    return [specs]


def spec_axes(spec: Spec) -> tuple[str, ...]:
    """Every axis name a spec splits over."""
    out: list[str] = []
    for ax in spec:
        if ax is None:
            continue
        out.extend(ax if isinstance(ax, tuple) else (ax,))
    return tuple(out)


def is_model_sharded(spec: Spec) -> bool:
    return MODEL_AXIS in spec_axes(spec)


# ---------------------------------------------------------------------------
# parameter rules
# ---------------------------------------------------------------------------


def _pad(spec: list, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def _rule(path: tuple[str, ...], shape: tuple[int, ...], cfg,
          sizes: dict[str, int]) -> Spec:
    fsdp = DATA_AXIS if (cfg.sharding == "fsdp" and DATA_AXIS in sizes) \
        else None
    tp = MODEL_AXIS if MODEL_AXIS in sizes else None
    name = path[-1] if path else ""
    joined = "/".join(path)
    nd = len(shape)

    def ok(dim_size, axis):
        return axis is not None and _div(dim_size, sizes.get(axis, 1))

    # kv projections are never model-sharded: each TP rank keeps every kv
    # head and gathers the ones its local q heads read
    is_kv = any(k in joined for k in ("wk/", "wv/")) or name in ("wk", "wv")

    if nd <= 1:
        if not shape:
            return ()
        sharded_vec = (name in ("conv_b", "d_skip")
                       or ("dt_proj" in joined and name == "b")
                       or ("wq" in joined and name == "b"))
        if sharded_vec and not is_kv and ok(shape[0], tp):
            return (tp,)
        return (None,)

    if "embed" in joined and name == "table":            # (V, d)
        return _pad([tp if ok(shape[0], tp) else None,
                     fsdp if ok(shape[1], fsdp) else None], nd)

    if name == "conv_w":                                 # (W, Din)
        return _pad([None, tp if ok(shape[1], tp) else None], nd)
    if name == "a_log":                                  # (Din, N)
        return _pad([tp if ok(shape[0], tp) else None, None], nd)

    # MoE expert stacks: (E, d, f) / (E, f, d)
    if ("moe" in joined and name in ("w_gate", "w_up", "w_down")
            and nd == 3):
        ep = cfg.moe is not None and cfg.moe.parallelism == "ep"
        if ep and ok(shape[0], tp):
            return (tp, fsdp if ok(shape[1], fsdp) else None, None)
        ff_dim = 2 if name in ("w_gate", "w_up") else 1  # tp in the expert
        spec: list = [None, None, None]
        if ok(shape[ff_dim], tp):
            spec[ff_dim] = tp
        other = 2 if ff_dim == 1 else 1
        if ok(shape[other], fsdp):
            spec[other] = fsdp
        return tuple(spec)

    if nd == 2:
        din, dout = shape
        if is_kv or "router" in joined:
            return (fsdp if ok(din, fsdp) else None, None)
        row_parallel = any(k in joined for k in ("wo", "w_down", "out_proj",
                                                 "x_proj"))
        col_parallel = any(k in joined for k in ("wq", "w_gate", "w_up",
                                                 "in_proj", "dt_proj",
                                                 "lm_head"))
        if row_parallel:
            return (tp if ok(din, tp) else None,
                    fsdp if ok(dout, fsdp) else None)
        if col_parallel:
            return (fsdp if ok(din, fsdp) else None,
                    tp if ok(dout, tp) else None)
        return (fsdp if ok(din, fsdp) else None, None)

    return (None,) * nd


def param_specs(params: Any, cfg, mesh):
    """The spec tree congruent with ``params`` (leaves need only
    ``shape``) under ``cfg.sharding``'s policy."""
    sizes = axis_sizes(mesh)
    return map_with_path(
        lambda path, leaf: _rule(path, tuple(leaf.shape), cfg, sizes), params)


# ---------------------------------------------------------------------------
# decode state rules
# ---------------------------------------------------------------------------

# paged serving state is replicated: page parallelism lives inside the
# engine (each model rank scores its slice of the page-table columns), and
# the slot vectors index sequences, not the data batch
_PAGED_STATE = ("pages", "page_table", "slot_len", "slot_valid")


def decode_state_specs(state: Any, cfg, mesh, global_batch: int):
    """KV caches (B, Hkv, C, D), SSM ``h`` (B, Din, N), ``conv`` (B, W-1,
    Din), cross k/v: the batch over :func:`batch_spec`'s axes; a cache of
    8192 slots or more is sequence-sharded over the model axis when it
    divides the cache (kv heads replicate)."""
    sizes = axis_sizes(mesh)
    bspec = batch_spec(global_batch, mesh)
    batch_axes = bspec[0] if bspec else None
    tp = MODEL_AXIS if MODEL_AXIS in sizes else None

    def visit(path, leaf):
        name = path[-1] if path else ""
        shape = tuple(leaf.shape)
        nd = len(shape)
        if name in _PAGED_STATE:
            return (None,) * nd
        if name in ("k", "v", "cross_k", "cross_v") and nd == 4:
            seq_ax = (tp if name in ("k", "v") and tp is not None
                      and shape[2] >= 8192 and _div(shape[2], sizes[tp])
                      else None)
            return (batch_axes, None, seq_ax, None)
        if name == "h" and nd == 3:
            h_ax = tp if _div(shape[1], sizes.get(tp or "", 1)) else None
            return (batch_axes, h_ax, None)
        if name == "conv" and nd == 3:
            h_ax = tp if _div(shape[2], sizes.get(tp or "", 1)) else None
            return (batch_axes, None, h_ax)
        if shape and shape[0] == global_batch:
            return _pad([batch_axes], nd)
        return (None,) * nd

    return map_with_path(visit, state)


# ---------------------------------------------------------------------------
# placement: a rank's block of every leaf, and back
# ---------------------------------------------------------------------------


def _block(spec_entry, sizes: dict[str, int], coords: dict[str, int]
           ) -> tuple[int, int]:
    """``(index, parts)`` of one dimension's split for a rank: its joint
    index over the entry's axes (outermost first) and their product."""
    axes = spec_entry if isinstance(spec_entry, tuple) else (spec_entry,)
    idx, parts = 0, 1
    for a in axes:
        idx = idx * sizes[a] + coords[a]
        parts *= sizes[a]
    return idx, parts


def shard_slices(shape: Sequence[int], spec: Spec, mesh, rank: int
                 ) -> tuple[slice, ...]:
    """The slices of a leaf of ``shape`` that ``rank`` of ``mesh`` holds."""
    sizes = axis_sizes(mesh)
    coords = dict(zip(mesh.axis_names, mesh.coords(rank)))
    out = []
    for d, n in enumerate(shape):
        ax = spec[d] if d < len(spec) else None
        if ax is None:
            out.append(slice(0, n))
            continue
        idx, parts = _block(ax, sizes, coords)
        if n % parts:
            raise ValueError(f"dimension {d} of {tuple(shape)} does not "
                             f"split over {parts} ranks ({ax!r})")
        seg = n // parts
        out.append(slice(idx * seg, (idx + 1) * seg))
    return tuple(out)


def local_shard(tree, specs, mesh, rank: int):
    """This rank's block of every leaf of ``tree`` (a view where slicing
    gives one; ``clone`` it to own the storage)."""
    return map_specs(
        lambda leaf, spec: leaf[shard_slices(leaf.shape, spec, mesh, rank)],
        tree, specs)


def local_shapes(tree, specs, mesh) -> Any:
    """The per-rank shape of every leaf (the same on every rank)."""
    sizes = axis_sizes(mesh)

    def shrink(leaf, spec):
        shape = list(leaf.shape)
        for d, ax in enumerate(spec):
            if ax is not None:
                shape[d] //= math.prod(
                    sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        return tuple(shape)

    return map_specs(shrink, tree, specs)


def global_from_shards(shards: Sequence, specs, mesh):
    """The inverse of :func:`local_shard` over every rank of ``mesh``:
    ``shards[r]`` is rank ``r``'s tree (numpy arrays or tensors); each leaf
    is reassembled from the ranks' blocks (replicated dimensions taken
    from the first rank that holds the block)."""
    import numpy as np

    def one(path_shards, spec):
        first = path_shards[0]
        full_shape = list(first.shape)
        sizes = axis_sizes(mesh)
        for d, ax in enumerate(spec):
            if ax is not None:
                full_shape[d] *= math.prod(
                    sizes[a] for a in (ax if isinstance(ax, tuple) else (ax,)))
        if hasattr(first, "detach"):
            import torch

            out = torch.empty(full_shape, dtype=first.dtype,
                              device=first.device)
        else:
            out = np.empty(full_shape, dtype=first.dtype)
        for r, blk in enumerate(path_shards):
            out[shard_slices(full_shape, spec, mesh, r)] = blk
        return out

    def walk(trees, specs_):
        t0 = trees[0]
        if isinstance(t0, dict):
            return {k: walk([t[k] for t in trees], specs_[k]) for k in t0}
        if isinstance(t0, list):
            return [walk([t[i] for t in trees], specs_[i])
                    for i in range(len(t0))]
        return one(trees, specs_)

    return walk(list(shards), specs)
