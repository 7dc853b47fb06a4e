"""Trees of the training path: nested dicts whose leaves are tensors (or
numpy arrays), walked in ``jax.tree_util``'s order, keys sorted at every
level, so that a leaf list lines up with the reference's."""

from __future__ import annotations

__all__ = ["tree_items", "tree_leaves", "tree_unflatten", "tree_map"]


def tree_items(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """(key path, leaf) pairs in sorted key order at every level."""
    out = []
    for key in sorted(tree):
        if isinstance(tree[key], dict):
            out.extend(tree_items(tree[key], prefix + (key,)))
        else:
            out.append((prefix + (key,), tree[key]))
    return out


def tree_leaves(tree) -> list:
    return [leaf for _, leaf in tree_items(tree)]


def tree_unflatten(items) -> dict:
    """The nested dict of (key path, leaf) pairs."""
    tree: dict = {}
    for path, leaf in items:
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = leaf
    return tree


def tree_map(fn, tree) -> dict:
    return {k: tree_map(fn, v) if isinstance(v, dict) else fn(v) for k, v in tree.items()}
