"""Flatten and rebuild nested dict/list trees in JAX's leaf order.

The reference walks parameter pytrees with ``jax.tree.flatten``, which
visits dict entries in sorted-key order and lists/tuples in position order.
Bucket layouts, arena segments and optimizer states index leaves by that
order, so the port flattens the same way and its plans equal the
reference's field for field.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable


@dataclass(frozen=True)
class TreeDef:
    """The structure of a tree with its leaves taken out (hashable)."""

    node: Any

    def unflatten(self, leaves):
        it = iter(leaves)
        out = _build(self.node, it)
        if next(it, _END) is not _END:
            raise ValueError("more leaves than the tree has slots")
        return out


_END = object()


def _build(node, it):
    if node is None:
        try:
            return next(it)
        except StopIteration:
            raise ValueError("fewer leaves than the tree has slots") from None
    kind, children = node
    if kind == "dict":
        return {k: _build(c, it) for k, c in children}
    return kind(_build(c, it) for c in children)


def _walk(t, leaves: list):
    if isinstance(t, dict):
        return ("dict", tuple((k, _walk(t[k], leaves)) for k in sorted(t)))
    if isinstance(t, (list, tuple)):
        return (type(t), tuple(_walk(v, leaves) for v in t))
    leaves.append(t)
    return None


def flatten(tree) -> tuple[list, TreeDef]:
    """Leaves in JAX order and the tree's structure.  The walk is a module
    function: a recursive closure would hold ``leaves`` in a reference
    cycle, keeping every leaf (a gradient, a delta) alive until the
    garbage collector ran."""
    leaves: list = []
    return leaves, TreeDef(_walk(tree, leaves))


def leaves(tree) -> list:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over corresponding leaves of ``tree`` and ``rest`` (which
    must share its structure)."""
    flat, tdef = flatten(tree)
    others = [flatten(r) for r in rest]
    for _, d in others:
        if d != tdef:
            raise ValueError("trees differ in structure")
    return tdef.unflatten(fn(*xs) for xs in zip(flat, *(o[0] for o in others)))
