"""Gradient bucketing: fused, alignment-guaranteed flat buffers.

Port of ``repro.core.bucketing``.  Leaves pack greedily, in the reference's
tree order (:mod:`repro_torch.tree`), into buckets of at most
``bucket_bytes``, each padded to ``pad_multiple`` elements (at least the
128-element lane multiple, times the transport's and codec's divisors), so
a :class:`BucketPlan` here equals the reference's field for field.  The
plan is computed once per tree signature and cached.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Sequence

import torch

from repro_torch import tree as tree_util
from repro_torch.core.topology import padded_size

LANE_MULTIPLE = 128  # the reference's TPU lane width; kept so plans agree


@dataclass(frozen=True)
class BucketField:
    """Placement of one tree leaf inside a bucket."""

    leaf: int          # index into the flattened tree
    shape: tuple[int, ...]
    dtype: torch.dtype
    bucket: int
    offset: int        # element offset within the bucket
    size: int          # element count


@dataclass(frozen=True)
class BucketPlan:
    treedef: Any
    fields: tuple[BucketField, ...]
    bucket_sizes: tuple[int, ...]   # padded element counts per bucket
    bucket_dtype: torch.dtype
    pad_multiple: int

    @property
    def n_buckets(self) -> int:
        return len(self.bucket_sizes)

    @property
    def total_elems(self) -> int:
        return int(sum(self.bucket_sizes))

    @property
    def used_elems(self) -> int:
        return int(sum(f.size for f in self.fields))

    @property
    def padding_waste(self) -> float:
        t = self.total_elems
        return 0.0 if t == 0 else 1.0 - self.used_elems / t


class GradientBucketer:
    """Greedy size-capped packer with a persistent plan cache.

    **Oversized-leaf invariant** (the reference's): a leaf larger than
    ``bucket_bytes`` is never split; it becomes a bucket of its own, and
    the next leaf starts a fresh bucket.  ``bucket_bytes`` is a target, not
    a bound.  Leaves may be tensors or anything with ``shape`` and
    ``dtype`` (a plan needs no data).
    """

    def __init__(self, bucket_bytes: int = 4 * 2**20,
                 pad_multiple: int = LANE_MULTIPLE,
                 bucket_dtype: torch.dtype = torch.float32):
        if bucket_bytes <= 0:
            raise ValueError("bucket_bytes must be positive")
        self.bucket_bytes = int(bucket_bytes)
        self.pad_multiple = math.lcm(int(pad_multiple), LANE_MULTIPLE)
        self.bucket_dtype = bucket_dtype
        self._plans: dict[Any, BucketPlan] = {}

    def plan(self, tree) -> BucketPlan:
        leaves, treedef = tree_util.flatten(tree)
        sig = (treedef, tuple((tuple(l.shape), l.dtype) for l in leaves))
        cached = self._plans.get(sig)
        if cached is not None:
            return cached

        cap = max(self.bucket_bytes // self.bucket_dtype.itemsize, 1)
        fields: list[BucketField] = []
        bucket_sizes: list[int] = []
        cur_bucket, cur_fill = -1, 0
        for i, leaf in enumerate(leaves):
            n = math.prod(leaf.shape)
            if cur_bucket < 0 or cur_fill + n > cap:
                if cur_bucket >= 0:
                    bucket_sizes[cur_bucket] = padded_size(cur_fill,
                                                           self.pad_multiple)
                bucket_sizes.append(0)
                cur_bucket, cur_fill = len(bucket_sizes) - 1, 0
            fields.append(BucketField(i, tuple(leaf.shape), leaf.dtype,
                                      cur_bucket, cur_fill, n))
            cur_fill += n
        if cur_bucket >= 0:
            bucket_sizes[cur_bucket] = padded_size(cur_fill, self.pad_multiple)

        plan = BucketPlan(treedef, tuple(fields), tuple(bucket_sizes),
                          self.bucket_dtype, self.pad_multiple)
        self._plans[sig] = plan
        return plan

    def bucketize(self, tree, plan: BucketPlan | None = None
                  ) -> tuple[list[torch.Tensor], BucketPlan]:
        """Fresh flat buckets (padding zeroed) holding the tree's leaves."""
        plan = plan or self.plan(tree)
        leaves = tree_util.leaves(tree)
        per_bucket: list[list[torch.Tensor]] = [[] for _ in plan.bucket_sizes]
        fill = [0] * plan.n_buckets
        for f in plan.fields:
            per_bucket[f.bucket].append(
                leaves[f.leaf].reshape(-1).to(plan.bucket_dtype))
            fill[f.bucket] += f.size
        buckets = []
        for b, parts in enumerate(per_bucket):
            pad = plan.bucket_sizes[b] - fill[b]
            if pad:
                parts.append(torch.zeros((pad,), dtype=plan.bucket_dtype,
                                         device=parts[0].device))
            buckets.append(torch.cat(parts) if len(parts) > 1
                           else parts[0].clone())
        return buckets, plan

    def debucketize(self, buckets: Sequence[torch.Tensor], plan: BucketPlan,
                    cast_to: torch.dtype | None = None):
        """The tree back out of ``buckets``; each leaf is a view of its
        bucket unless a cast makes a copy."""
        leaves: list = [None] * len(plan.fields)
        for f in plan.fields:
            flat = buckets[f.bucket][f.offset:f.offset + f.size]
            leaves[f.leaf] = flat.view(f.shape).to(cast_to or f.dtype)
        return plan.treedef.unflatten(leaves)
