"""Nested dicts and NamedTuples of tensors as trees (what ``jax.tree``
gives the reference).

Leaves are visited in sorted key order, as ``jax.tree`` does, so a tree's
flat order does not depend on the order its dicts were built in (a
restored checkpoint, a copied tree).  ``None`` is an empty subtree.
"""

from __future__ import annotations


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> object:
    """A tree of ``like``'s structure holding ``leaves`` in flat order."""
    it = iter(leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: build(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}  # keep the caller's order
        if _is_namedtuple(node):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (list, tuple)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which share its structure."""
    flat = [tree_leaves(t) for t in (tree, *rest)]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)])
