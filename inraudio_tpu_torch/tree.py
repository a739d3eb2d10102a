"""Parameter trees: nested dicts and lists/tuples with tensor (or array)
leaves.  Flattening follows ``jax.tree_util``'s order (dict keys sorted,
sequences in order), so a payload's leaves line up with the JAX package's."""

from __future__ import annotations

from typing import Any, Callable


def tree_map(fn: Callable[..., Any], tree: Any, *rest: Any,
             is_leaf: Callable[[Any], bool] | None = None) -> Any:
    """``fn`` applied to every leaf (or every subtree ``is_leaf`` accepts);
    the same structure back.  With ``rest`` trees of the same structure,
    ``fn`` takes the corresponding leaf of each."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        items = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
                 for i, v in enumerate(tree)]
        # a NamedTuple takes its fields as arguments
        return type(tree)(*items) if hasattr(tree, "_fields") else \
            type(tree)(items)
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list:
    """Leaves in ``jax.tree_util.tree_flatten`` order."""
    if isinstance(tree, dict):
        return [l for k in sorted(tree) for l in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [l for v in tree for l in tree_leaves(v)]
    return [tree]


def tree_unflatten(template: Any, leaves: list) -> Any:
    """Inverse of ``tree_leaves``: ``template``'s structure, filled in
    order from ``leaves``."""
    it = iter(leaves)
    return _fill(template, it)


def _fill(t, it):
    if isinstance(t, dict):
        return {k: _fill(t[k], it) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        items = [_fill(v, it) for v in t]
        return type(t)(*items) if hasattr(t, "_fields") else type(t)(items)
    return next(it)
