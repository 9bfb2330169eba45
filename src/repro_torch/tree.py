"""Trees of tensors: nested dicts, lists, tuples and named tuples, walked
as ``jax.tree_util`` walks them.

Dict keys are visited in sorted order and ``None`` is an empty subtree,
as in JAX, so a reduction over :func:`leaves` sums in the reference's
order (the global gradient norm depends on it in its last bits) and
:func:`leaves_with_path` names each leaf as ``jax.tree_util.keystr``
does (``.opt.mu['embed']['table']``), the names a checkpoint stores.
"""
from __future__ import annotations

from typing import Any, Callable


def _is_namedtuple(t) -> bool:
    return isinstance(t, tuple) and hasattr(t, "_fields")


def leaves_with_path(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(keystr, leaf)`` for every leaf, in the reference's order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in leaves_with_path(tree[k], f"{prefix}[{k!r}]")]
    if _is_namedtuple(tree):
        return [kv for name, v in zip(tree._fields, tree)
                for kv in leaves_with_path(v, f"{prefix}.{name}")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, v in enumerate(tree)
                for kv in leaves_with_path(v, f"{prefix}[{i}]")]
    return [(prefix, tree)]


def leaves(tree) -> list:
    """The leaves of ``tree`` in the reference's order."""
    return [leaf for _, leaf in leaves_with_path(tree)]


def tree_map(fn: Callable, *trees):
    """``fn`` over the leaves of same-shaped trees (in :func:`leaves`
    order); ``None`` subtrees stay ``None``."""
    t = trees[0]
    if t is None:
        return None
    if isinstance(t, dict):
        return {k: tree_map(fn, *[x[k] for x in trees]) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        parts = [tree_map(fn, *xs) for xs in zip(*trees)]
        return type(t)(*parts) if _is_namedtuple(t) else type(t)(parts)
    return fn(*trees)


def unflatten(template, new_leaves) -> Any:
    """``template``'s structure with its leaves replaced, in order, by
    ``new_leaves`` (the inverse of :func:`leaves`)."""
    it = iter(new_leaves)
    out = tree_map(lambda _: next(it), template)
    if next(it, None) is not None:
        raise ValueError("unflatten: more leaves than the template holds")
    return out
