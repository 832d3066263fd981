"""A small pytree flatten for the samplers and checkpoints.

The JAX package flattens with ``jax.tree_util``; the port keeps its own
copy of the part it needs. A tree is a dict (its keys in sorted order, as
``jax.tree_util`` takes them), a list, a tuple or a named tuple of trees;
``None`` is an empty tree; anything else (a tensor, a numpy array, a
number) is a leaf. So a tree's leaves come in the order the JAX package
gives them, and a checkpoint written by either package reads back in the
other.
"""

from __future__ import annotations

__all__ = ["tree_flatten", "tree_unflatten", "tree_flatten_with_path", "tree_leaves"]

from typing import Any

# A tree's structure: ("leaf",), ("none",), ("dict", keys, children),
# ("list", children), ("tuple", type, children).
Spec = tuple


def _is_namedtuple(x: Any) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree: Any) -> tuple[Spec, list[tuple[str, Any]]] | None:
    """The node's kind and its (path key, child) pairs, or None for a leaf;
    the keys are ``jax.tree_util.keystr``'s."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys), [(f"[{k!r}]", tree[k]) for k in keys]
    if _is_namedtuple(tree):
        return ("tuple", type(tree)), [(f".{f}", v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, list | tuple):
        kind = ("list",) if isinstance(tree, list) else ("tuple", tuple)
        return kind, [(f"[{i}]", v) for i, v in enumerate(tree)]
    return None


def tree_flatten_with_path(tree: Any) -> tuple[list[tuple[str, Any]], Spec]:
    """``([(path, leaf), ...], spec)``, the leaves in the JAX package's
    order, each with its path as ``jax.tree_util.keystr`` writes it."""
    if tree is None:
        return [], ("none",)
    node = _children(tree)
    if node is None:
        return [("", tree)], ("leaf",)
    kind, children = node
    leaves, specs = [], []
    for key, child in children:
        sub, spec = tree_flatten_with_path(child)
        leaves += [(key + path, leaf) for path, leaf in sub]
        specs.append(spec)
    return leaves, (*kind, specs)


def tree_flatten(tree: Any) -> tuple[list[Any], Spec]:
    """``(leaves, spec)``; :func:`tree_unflatten` inverts it."""
    leaves, spec = tree_flatten_with_path(tree)
    return [leaf for _, leaf in leaves], spec


def tree_leaves(tree: Any) -> list[Any]:
    return tree_flatten(tree)[0]


def tree_unflatten(spec: Spec, leaves: list[Any]) -> Any:
    """The tree of structure ``spec`` holding ``leaves`` in order."""
    it = iter(leaves)

    def build(spec):
        kind = spec[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(s) for k, s in zip(spec[1], spec[2])}
        if kind == "list":
            return [build(s) for s in spec[1]]
        cls, children = spec[1], [build(s) for s in spec[2]]
        return cls(*children) if cls is not tuple else tuple(children)

    out = build(spec)
    if next(it, None) is not None:
        raise ValueError("more leaves than the structure holds")
    return out
