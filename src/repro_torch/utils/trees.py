"""Nested dicts and NamedTuples of tensors as trees (what ``jax.tree``
gives the reference).

Leaves are visited in sorted key order, as ``jax.tree`` does, so a tree's
flat order does not depend on the order its dicts were built in (a
restored checkpoint, a copied tree).  ``None`` is an empty subtree.
"""

from __future__ import annotations

import numpy as np
import torch


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


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else np.asarray(x).size


def tree_size(tree) -> int:
    """Total number of elements across all leaves (tensors or arrays)."""
    return sum(_numel(x) for x in tree_leaves(tree))


def tree_bytes(tree) -> int:
    """Total bytes across all leaves: numel x element size, per leaf dtype."""
    return sum(x.numel() * x.element_size() if isinstance(x, torch.Tensor)
               else np.asarray(x).nbytes for x in tree_leaves(tree))


def tree_zeros_like(tree):
    return tree_map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else np.zeros_like(x), tree)


def map_with_path(fn, tree):
    """``tree_map`` with a '/'-joined string path as the first argument,
    the reference's strings: a dict key as ``str(key)``, a list or tuple
    index as its number, a NamedTuple field as ``.field``."""
    def walk(node, path):
        if node is None:
            return None
        if isinstance(node, dict):
            out = {k: walk(node[k], path + (str(k),)) for k in sorted(node)}
            return {k: out[k] for k in node}
        if _is_namedtuple(node):
            return type(node)(*(walk(v, path + (f".{f}",))
                                for f, v in zip(node._fields, node)))
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v, path + (str(i),))
                              for i, v in enumerate(node))
        return fn("/".join(path), node)

    return walk(tree, ())


def flatten_dict(d: dict, prefix: str = "") -> dict:
    """Flatten a nested dict into {'a/b/c': leaf}."""
    out = {}
    for k, v in d.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten_dict(v, key))
        else:
            out[key] = v
    return out


def unflatten_dict(flat: dict) -> dict:
    """Inverse of flatten_dict."""
    out: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        cur = out
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = v
    return out
