"""Nested NamedTuple / tuple / list / dict containers of tensors: map and
flatten (the port's stand-in for JAX pytrees).

Dict leaves come in sorted-key order, the order jax.tree.leaves gives, so
the tests can pair the two packages' leaves one by one. None is an empty
subtree.
"""

from __future__ import annotations

from typing import Any, Callable, List


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Apply fn to every leaf of `tree` (and the matching leaves of `rest`)."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(
            *(tree_map(fn, a, *(r[i] for r in rest)) for i, a in enumerate(tree))
        )
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, a, *(r[i] for r in rest)) for i, a in enumerate(tree))
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> List[Any]:
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for a in tree for leaf in tree_leaves(a)]
    return [tree]



def tree_unflatten(tree: Any, leaves: List[Any]) -> Any:
    """`tree` with its leaves replaced by `leaves`, taken in tree_leaves'
    order (dicts keep their own key order)."""
    return _rebuild(tree, iter(leaves))


def _rebuild(tree: Any, it) -> Any:
    # a module-level function, not a closure: a recursive closure is a
    # reference cycle that would keep the leaves alive until the next
    # garbage collection
    if tree is None:
        return None
    if isinstance(tree, dict):
        done = {k: _rebuild(tree[k], it) for k in sorted(tree)}
        return {k: done[k] for k in tree}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(a, it) for a in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(a, it) for a in tree)
    return next(it)
