"""Nested dicts of tensors as the JAX package's pytrees: one flattening
order for the optimizer, the checkpoints and the gradient compression —
``jax.tree_util``'s for dicts, keys sorted, recursively. A checkpoint's
leaves are written in this order, so a checkpoint of one package restores
in the other."""

from __future__ import annotations

__all__ = ["tree_leaves", "tree_map", "tree_unflatten", "treedef_str"]


def tree_leaves(tree) -> list:
    """The leaves of ``tree`` in ``jax.tree_util.tree_leaves``' order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of ``rest``
    (trees of the same structure), in a tree of that structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


def tree_unflatten(template, leaves: list):
    """A tree of ``template``'s structure holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)

    def fill(t):
        if isinstance(t, dict):
            return {k: fill(t[k]) for k in sorted(t)}
        return next(it)

    out = fill(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out


def treedef_str(tree) -> str:
    """``str(jax.tree_util.tree_structure(tree))`` for a tree of dicts."""
    def walk(t):
        if isinstance(t, dict):
            return "{" + ", ".join(f"{k!r}: {walk(t[k])}" for k in sorted(t)) + "}"
        return "*"

    return f"PyTreeDef({walk(tree)})"
