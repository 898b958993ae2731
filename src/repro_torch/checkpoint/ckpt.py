"""Checkpointing: atomic step directories, integrity hashes, async writes.

Port of ``repro.checkpoint.ckpt``, in the reference's on-disk format, so
that a checkpoint crosses packages both ways::

    <dir>/step_000123/
        meta.msgpack       # treedef repr, leaf paths/shapes/dtypes, sha256s
        arr_00000.npy ...  # one file per leaf, in JAX's leaf order
        COMMITTED          # written last; restore ignores dirs without it

Leaf paths are JAX's ``keystr`` strings (``['opt']['mu'][0]``) and
``meta["treedef"]`` is JAX's ``str(treedef)`` of the nested dicts and
lists, so the port's step directory of a state equals the reference's byte
for byte.  A Python ``int`` leaf (the port's ``step``) is written as a 0-d
``int32``, the reference's dtype, and restores as an ``int``.  A bf16 leaf
is written with the ``'<V2'`` descr that ``np.save`` gives an ml_dtypes
bfloat16 array and ``"bfloat16"`` in ``meta``, and read back bit for bit.

**Global arrays.**  The reference saves *global* arrays.  In the port each
rank holds its own part of the leaves its :class:`TrainStep` lays out as

* :data:`SHARDED`: a flat 1-D leaf, rank ``r`` of ``p`` holding elements
  ``[r*n, (r+1)*n)`` (the reference's ``P(('data', 'model'))``: the device
  at ``(d, m)`` holds block ``d * model_size + m``, its rank);
  :class:`CheckpointManager` gathers them to rank 0 on the host in rank
  order;
* :class:`Blocks`: a leaf split over the mesh's model axis by its spec (a
  tensor-parallel parameter or moment); rank 0 assembles the global array
  from the blocks of the ranks that share its data coordinates
  (:func:`~repro_torch.sharding.rules.global_from_shards`);
* :data:`REPLICATED`: written from rank 0's copy.

Rank 0 writes, and on restore every rank reads the files and takes its own
part (:func:`~repro_torch.sharding.rules.shard_slices` for a block).

Fault-tolerance contract: a crash mid-write leaves an uncommitted dir that
restore skips; ``keep_n`` GC never deletes the newest committed step.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import _msgpack
from repro_torch.core.topology import RankMesh
from repro_torch.sharding.rules import (MODEL_AXIS, global_from_shards,
                                        shard_slices, spec_axes)

COMMIT_MARK = "COMMITTED"
REPLICATED = "replicated"      # every rank holds the whole leaf
SHARDED = "sharded"            # a 1-D leaf split over the ranks in order
_HASH_CHUNK = 64 * 2**20
_GATHER_CHUNK = 256 * 2**20     # bytes of one gather message
_HASH_THREADS = 8


@dataclass(frozen=True)
class Blocks:
    """The layout rule of a leaf split over the model axis by ``spec`` (a
    spec of :mod:`repro_torch.sharding.rules` naming no other axis): the
    file holds the global array, each rank its block."""

    spec: tuple


@dataclass(frozen=True)
class RankShards:
    """This process's place among the ranks that share one state: rank
    ``rank`` of ``world``, the host-side (gloo) process group the
    checkpoint gathers and agrees over (``None``: the default group), and
    the mesh the ranks form (``None``: data-only, no :class:`Blocks`)."""

    rank: int = 0
    world: int = 1
    group: Any = None
    mesh: Any = None

    def block_holders(self) -> list[int]:
        """The ranks that share rank 0's data coordinates, in model order:
        the ones whose blocks make a :class:`Blocks` leaf's global
        array."""
        return self.mesh.groups((MODEL_AXIS,))[0]


ONE_RANK = RankShards()


# ---------------------------------------------------------------------------
# trees in JAX's order and notation
# ---------------------------------------------------------------------------


def _walk(t, path: str, out: list) -> str:
    """Appends ``(keystr path, leaf)`` pairs in JAX's leaf order and returns
    the subtree's part of JAX's ``str(treedef)``."""
    if isinstance(t, dict):
        parts = [f"{k!r}: {_walk(t[k], f'{path}[{k!r}]', out)}"
                 for k in sorted(t)]
        return "{" + ", ".join(parts) + "}"
    if isinstance(t, (list, tuple)):
        parts = [_walk(v, f"{path}[{i}]", out) for i, v in enumerate(t)]
        if isinstance(t, list):
            return "[" + ", ".join(parts) + "]"
        return "(" + ", ".join(parts) + ("," if len(parts) == 1 else "") + ")"
    if t is None:
        return "None"
    out.append((path, t))
    return "*"


def flatten_with_path(tree) -> tuple[list[tuple[str, Any]], str]:
    """``[(path, leaf)]`` in JAX's leaf order, with JAX's ``keystr`` paths,
    and JAX's ``str(treedef)`` of ``tree`` (dicts, lists and tuples are
    nodes, ``None`` an empty node, everything else a leaf)."""
    out: list = []
    return out, f"PyTreeDef({_walk(tree, '', out)})"


def _rebuild(t, it):
    """``t``'s structure with its leaves taken from ``it`` in JAX order."""
    if isinstance(t, dict):
        built = {k: _rebuild(t[k], it) for k in sorted(t)}
        return {k: built[k] for k in t}
    if isinstance(t, (list, tuple)):
        return type(t)(_rebuild(v, it) for v in t)
    if t is None:
        return None
    return next(it)


# ---------------------------------------------------------------------------
# leaves <-> .npy files
# ---------------------------------------------------------------------------


def _host_array(leaf) -> tuple[np.ndarray, str]:
    """The array a leaf's file holds and the dtype name ``meta`` records.
    bf16 comes back as its int16 bits."""
    if isinstance(leaf, int):
        arr = np.asarray(leaf, np.int32)      # the reference's step dtype
    elif isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu").contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    name = str(arr.dtype)
    if name == "bfloat16":                    # an ml_dtypes array
        return np.ascontiguousarray(arr).view(np.int16), name
    return arr, name


def _write_npy(path: str, arr: np.ndarray, dtype_name: str) -> None:
    if dtype_name != "bfloat16":
        np.save(path, arr)
        return
    # np.save of an ml_dtypes bfloat16 array: the '<V2' descr, then the
    # raw little-endian bits
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": "<V2", "fortran_order": False, "shape": arr.shape})
        f.write(np.ascontiguousarray(arr, dtype="<i2").tobytes())


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(_HASH_CHUNK), b""):
            h.update(chunk)
    return h.hexdigest()


def _sha256_all(paths: list[str]) -> list[str]:
    """The sha256 of each file, on several threads: hashlib lets go of
    the GIL while it hashes, and hashing, not the disk, bounds a step
    directory's write and verify."""
    workers = max(1, min(_HASH_THREADS, len(paths), os.cpu_count() or 1))
    with ThreadPoolExecutor(workers) as pool:
        return list(pool.map(_sha256, paths))


def _shape(leaf) -> tuple:
    if isinstance(leaf, int):
        return ()
    return tuple(leaf.shape)


def _as_template(arr: np.ndarray, dtype_name: str, leaf, device):
    """The file's array (bf16 as its int16 bits) in the template leaf's
    kind and dtype: a tensor on the template's device (``device`` for a
    ``meta`` template), a numpy array, or a Python ``int``."""
    if isinstance(leaf, int):
        return int(arr.item())
    if isinstance(leaf, torch.Tensor):
        t = torch.from_numpy(np.array(arr))
        if dtype_name == "bfloat16":
            t = t.view(torch.bfloat16)
        dev = leaf.device if leaf.device.type != "meta" else (
            device if device is not None else torch.device("cpu"))
        return t.to(device=dev, dtype=leaf.dtype)
    want = np.asarray(leaf).dtype if not isinstance(leaf, np.ndarray) \
        else leaf.dtype
    if dtype_name == "bfloat16" and str(want) == "bfloat16":
        return np.array(arr).view(want)
    if dtype_name == "bfloat16":
        raise ValueError("a bfloat16 leaf restores into a tensor or a "
                         "bfloat16 array only")
    return np.array(arr, dtype=want)


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def save(state: Any, step: int, ckpt_dir: str) -> str:
    """Blocking save of a tree of whole (global) leaves: tensors on any
    device, numpy arrays and Python ``int``s."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)

    flat, treedef = flatten_with_path(state)
    written = []
    for i, (path, leaf) in enumerate(flat):
        arr, dtype_name = _host_array(leaf)
        fname = f"arr_{i:05d}.npy"
        _write_npy(os.path.join(tmp, fname), arr, dtype_name)
        written.append((path, fname, list(arr.shape), dtype_name))
    digests = _sha256_all([os.path.join(tmp, w[1]) for w in written])
    meta = {"step": int(step), "treedef": treedef, "leaves": [
        {"path": path, "file": fname, "shape": shape, "dtype": dtype_name,
         "sha256": digest}
        for (path, fname, shape, dtype_name), digest in zip(written,
                                                            digests)]}
    with open(os.path.join(tmp, "meta.msgpack"), "wb") as f:
        f.write(_msgpack.packb(meta))
    with open(os.path.join(tmp, COMMIT_MARK), "w") as f:
        f.write("ok\n")
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def _committed_steps(ckpt_dir: str) -> list[int]:
    return sorted(
        int(n.split("_")[1]) for n in os.listdir(ckpt_dir)
        if n.startswith("step_") and not n.endswith(".tmp")
        and os.path.exists(os.path.join(ckpt_dir, n, COMMIT_MARK)))


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _committed_steps(ckpt_dir)
    return steps[-1] if steps else None


def read_meta(ckpt_dir: str, step: int) -> dict:
    """A step directory's ``meta.msgpack``."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "meta.msgpack")
    with open(path, "rb") as f:
        return _msgpack.unpackb(f.read())


def restore(like: Any, step: int, ckpt_dir: str, *, verify: bool = True,
            strict: bool = True, layout: Any = None,
            ranks: RankShards = ONE_RANK,
            device: torch.device | str | None = None) -> Any:
    """Restore into the structure of ``like``, whose leaves are tensors
    (on the ``meta`` device for an abstract template, the port's
    ``ShapeDtypeStruct``), numpy arrays or Python ``int``s.

    ``strict=False`` matches leaves **by path** instead of by position:
    leaves present in ``like`` but absent from the checkpoint keep their
    ``like`` value (they must then be concrete), and checkpoint leaves with
    no counterpart in ``like`` are ignored: a run restores across config
    changes that add or drop *scratch* state (the arena, ``"ef"``).  Shape
    checks still apply per matched leaf.

    ``layout`` is a tree like ``like`` of :data:`REPLICATED` /
    :data:`SHARDED` (``None``: all replicated).  A sharded template leaf of
    ``n`` elements expects a global file of ``ranks.world * n`` and takes
    elements ``[rank*n, (rank+1)*n)``.  Restored tensors go to their
    template's device, or to ``device`` (default the CPU) for ``meta``
    templates.
    """
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    meta = read_meta(ckpt_dir, step)
    flat, _ = flatten_with_path(like)
    rules = ([r for _, r in flatten_with_path(layout)[0]] if layout is not None
             else [REPLICATED] * len(flat))
    if len(rules) != len(flat):
        raise ValueError(f"layout has {len(rules)} leaves, the template "
                         f"{len(flat)}")
    if strict and len(flat) != len(meta["leaves"]):
        raise ValueError(
            f"checkpoint has {len(meta['leaves'])} leaves, state expects "
            f"{len(flat)} — incompatible structures (pass strict=False "
            f"to match by path)")
    by_path = {rec["path"]: rec for rec in meta["leaves"]}
    recs = [meta["leaves"][i] if strict else by_path.get(key)
            for i, (key, _) in enumerate(flat)]
    if verify:
        found = [rec for rec in recs if rec is not None]
        digests = _sha256_all([os.path.join(d, rec["file"])
                               for rec in found])
        for rec, digest in zip(found, digests):
            if digest != rec["sha256"]:
                raise IOError(f"checksum mismatch for {rec['path']} in {d}")
    out = []
    for (key, leaf), rule, rec in zip(flat, rules, recs):
        if rec is None:                      # not in ckpt: keep like's value
            if isinstance(leaf, torch.Tensor) and leaf.device.type == "meta":
                raise ValueError(
                    f"leaf {key} is missing from the checkpoint and the "
                    f"template is abstract — nothing to keep")
            out.append(leaf)
            continue
        arr = np.load(os.path.join(d, rec["file"]), mmap_mode="r")
        if rec["dtype"] == "bfloat16":
            arr = arr.view(np.int16)
        shape = _shape(leaf)
        if isinstance(rule, Blocks):
            arr = arr[shard_slices(arr.shape, rule.spec, ranks.mesh,
                                   ranks.rank)]
            if tuple(arr.shape) != shape:
                raise ValueError(
                    f"shape mismatch for {rec['path']}: this rank's block "
                    f"of the ckpt is {arr.shape}, the state's {shape}")
        elif rule == SHARDED and ranks.world > 1:
            if len(shape) != 1:
                raise ValueError(f"sharded leaf {key} must be 1-D, got "
                                 f"{shape}")
            n = shape[0]
            if tuple(arr.shape) != (ranks.world * n,):
                raise ValueError(
                    f"shape mismatch for {rec['path']}: ckpt {arr.shape} vs "
                    f"state {shape} on each of {ranks.world} ranks (global "
                    f"{(ranks.world * n,)})")
            arr = arr[ranks.rank * n:(ranks.rank + 1) * n]
        elif tuple(arr.shape) != shape:
            raise ValueError(
                f"shape mismatch for {rec['path']}: ckpt {arr.shape} vs "
                f"state {shape}")
        out.append(_as_template(arr, rec["dtype"], leaf, device))
        del arr
    return _rebuild(like, iter(out))


# ---------------------------------------------------------------------------
# the host copy and the gather of rank-sharded leaves
# ---------------------------------------------------------------------------


def _host_copy(leaf):
    """A host copy that shares no storage with ``leaf`` (the arena and
    ``"ef"`` are updated in place by the next step)."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True)
    if isinstance(leaf, np.ndarray):
        return leaf.copy()
    return leaf


def _host_global(state: Any, layout: Any = None,
                ranks: RankShards = ONE_RANK):
    """The state as whole host arrays on rank 0 (``None`` on the other
    ranks): replicated leaves copied from rank 0, sharded leaves gathered
    over ``ranks.group`` in rank order.  Collective when ``ranks.world >
    1``: every rank calls it with the same tree."""
    flat, _ = flatten_with_path(state)
    rules = ([r for _, r in flatten_with_path(layout)[0]] if layout is not None
             else [REPLICATED] * len(flat))
    if len(rules) != len(flat):
        raise ValueError(f"layout has {len(rules)} leaves, the state "
                         f"{len(flat)}")
    if ranks.world == 1:
        return _rebuild(state, iter([_host_copy(x) for _, x in flat]))
    import torch.distributed as dist

    out = []
    for (key, leaf), rule in zip(flat, rules):
        if isinstance(rule, Blocks):
            out.append(_host_blocks(key, leaf, rule.spec, ranks))
            continue
        if rule != SHARDED:
            out.append(_host_copy(leaf) if ranks.rank == 0 else None)
            continue
        if not isinstance(leaf, torch.Tensor) or leaf.dim() != 1:
            raise ValueError(f"sharded leaf {key} must be a 1-D tensor")
        local = leaf.detach().to("cpu", copy=True)
        raw = local.view(torch.uint8)
        n = raw.numel()
        full = (torch.empty(ranks.world * n, dtype=torch.uint8)
                if ranks.rank == 0 else None)
        for lo in range(0, n, _GATHER_CHUNK):     # bounded messages
            hi = min(lo + _GATHER_CHUNK, n)
            parts = ([full[r * n + lo:r * n + hi] for r in range(ranks.world)]
                     if ranks.rank == 0 else None)
            dist.gather(raw[lo:hi], parts, dst=0, group=ranks.group)
        out.append(full.view(local.dtype) if ranks.rank == 0 else None)
    if ranks.rank != 0:
        return None
    return _rebuild(state, iter(out))


def _host_blocks(key: str, leaf, spec: tuple, ranks: RankShards):
    """A :class:`Blocks` leaf's global array on rank 0 (``None`` on the
    other ranks): the blocks of :meth:`RankShards.block_holders` sent to
    rank 0 point to point in bounded messages, assembled in model order.
    Collective: every rank calls it."""
    import torch.distributed as dist

    if ranks.mesh is None or set(spec_axes(spec)) - {MODEL_AXIS}:
        raise ValueError(f"leaf {key}: blocks need the ranks' mesh and a "
                         f"spec over the model axis alone, got {spec!r}")
    holders = ranks.block_holders()
    if holders[0] != 0:
        raise ValueError(f"rank 0 is not the first of its model group "
                         f"{holders}")
    if ranks.rank not in holders:
        return None
    local = leaf.detach().to("cpu", copy=True).contiguous()

    def chunks(n: int):
        return [(lo, min(lo + _GATHER_CHUNK, n))
                for lo in range(0, n, _GATHER_CHUNK)]

    raw = local.view(-1).view(torch.uint8)
    if ranks.rank != 0:
        for lo, hi in chunks(raw.numel()):
            dist.send(raw[lo:hi], dst=0, group=ranks.group)
        return None
    blocks = [local]
    for r in holders[1:]:
        blk = torch.empty_like(local)
        buf = blk.view(-1).view(torch.uint8)
        for lo, hi in chunks(buf.numel()):
            dist.recv(buf[lo:hi], src=r, group=ranks.group)
        blocks.append(blk)
    return global_from_shards(blocks, spec,
                              RankMesh((MODEL_AXIS,), (len(holders),)))


class CheckpointManager:
    """Async (thread-offloaded) saves + keep-N garbage collection, over the
    ranks that share one state.

    :meth:`save` copies the state to the host (the sharded leaves gathered
    to rank 0) before the thread starts, so the thread touches no device
    tensor and no later in-place update reaches the files.  Rank 0 writes.
    An error of the thread, on any rank's manager, is raised on every rank
    by the next :meth:`wait` (which :meth:`save` calls first).  With
    ``ranks.world > 1``, ``save``, ``wait`` and ``restore_latest`` are
    collective."""

    def __init__(self, ckpt_dir: str, keep_n: int = 3, async_save: bool = True,
                 *, ranks: RankShards = ONE_RANK):
        self.ckpt_dir = ckpt_dir
        self.keep_n = keep_n
        self.async_save = async_save
        self.ranks = ranks
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def _agree(self, value: int, op: str) -> int:
        """``value`` reduced over the ranks (``"max"``) or rank 0's
        (``"src0"``)."""
        if self.ranks.world == 1:
            return value
        import torch.distributed as dist

        t = torch.tensor([value], dtype=torch.int64)
        if op == "max":
            dist.all_reduce(t, dist.ReduceOp.MAX, group=self.ranks.group)
        else:
            dist.broadcast(t, src=0, group=self.ranks.group)
        return int(t.item())

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        err, self._error = self._error, None
        if self._agree(int(err is not None), "max") and err is None:
            err = RuntimeError("a checkpoint save failed on another rank")
        if err is not None:
            raise err

    def save(self, state: Any, step: int, layout: Any = None):
        self.wait()
        host_state = _host_global(state, layout, self.ranks)
        if self.ranks.world > 1:
            import torch.distributed as dist

            dist.barrier(group=self.ranks.group)
        if host_state is None:               # not the writing rank
            return

        def work():
            try:
                save(host_state, step, self.ckpt_dir)
                self._gc()
            except BaseException as e:  # surfaced on next wait()
                self._error = e

        if self.async_save:
            self._thread = threading.Thread(target=work, daemon=True)
            self._thread.start()
        else:
            work()
            if self._error is not None:
                err, self._error = self._error, None
                raise err

    def _gc(self):
        for s in _committed_steps(self.ckpt_dir)[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.ckpt_dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def restore_latest(self, like: Any, strict: bool = True,
                       layout: Any = None,
                       device: torch.device | str | None = None):
        step = latest_step(self.ckpt_dir)
        agreed = self._agree(-1 if step is None else step, "src0")
        if agreed != (-1 if step is None else step):
            raise RuntimeError(f"rank {self.ranks.rank} sees step {step} in "
                               f"{self.ckpt_dir}, rank 0 step {agreed}: the "
                               f"ranks must share the checkpoint directory")
        if step is None:
            return None, None
        return restore(like, step, self.ckpt_dir, strict=strict,
                       layout=layout, ranks=self.ranks,
                       device=device), step
