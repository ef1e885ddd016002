"""Nests of dicts, (named) tuples and lists, flattened in JAX's order.

The reference walks its parameter, optimiser and cache trees with
``jax.tree_util``; the port's trees are the same nests of tensors.  JAX's
order is kept, so leaf ``i`` here is leaf ``i`` there: dict keys sorted,
the fields of a NamedTuple and the items of a tuple or list in order, and
``None`` a subtree without leaves.  A path is a tuple of strings, each what
the reference reads off its keys (``getattr(k, "key", getattr(k, "name",
k))``): a dict key, a field name, or ``"[i]"`` for a sequence item.
"""
from __future__ import annotations


def _children(node):
    """(key, child) pairs of an inner node in JAX's order; None for a leaf."""
    if isinstance(node, dict):
        return [(str(k), node[k]) for k in sorted(node)]
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return [(f"[{i}]", v) for i, v in enumerate(node)]
    return None


def flatten_with_path(tree, prefix: tuple = ()) -> list:
    """[(path, leaf)] of every leaf of ``tree``, in JAX's order."""
    if tree is None:
        return []
    kids = _children(tree)
    if kids is None:
        return [(prefix, tree)]
    return [item for k, v in kids for item in flatten_with_path(v, prefix + (k,))]


def leaves(tree) -> list:
    """The leaves of ``tree`` in JAX's order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def path_str(path: tuple) -> str:
    """A path as the reference's checkpoint manifest writes it:
    ``params/layers/attn/wq``."""
    return "/".join(path)


def unflatten(like, new_leaves) -> object:
    """``like``'s structure with its leaves replaced, in order, by
    ``new_leaves``; ``None`` subtrees stay ``None``."""
    new_leaves = list(new_leaves)
    want = len(leaves(like))
    if len(new_leaves) != want:
        raise ValueError(f"{len(new_leaves)} leaves for a tree of {want}")
    it = iter(new_leaves)

    def build(node):
        if node is None:
            return None
        if isinstance(node, dict):
            built = {k: build(node[k]) for k in sorted(node)}
            return {k: built[k] for k in node}
        if isinstance(node, tuple) and hasattr(node, "_fields"):
            return type(node)(*(build(v) for v in node))
        if isinstance(node, (tuple, list)):
            return type(node)(build(v) for v in node)
        return next(it)

    return build(like)


def map_with_path(fn, tree):
    """``tree`` with each leaf replaced by ``fn(path, leaf)``."""
    return unflatten(tree, [fn(p, x) for p, x in flatten_with_path(tree)])
