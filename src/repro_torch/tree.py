"""Trees of tensors: flatten, rebuild and map, in ``jax.tree``'s order.

The port's params, gradients and optimizer state are plain dicts, lists,
tuples and NamedTuples of tensors. :func:`flatten` lists their leaves in
the order ``jax.tree.flatten`` lists the reference's (dict keys sorted,
sequences in order, ``None`` an empty subtree), so leaf ``i`` of a
checkpoint names the same parameter in both packages.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

__all__ = ["flatten", "unflatten", "tree_map", "leaves"]


def _is_namedtuple_type(kind) -> bool:
    return issubclass(kind, tuple) and hasattr(kind, "_fields")


def _walk(t, out: List[Any]):
    """``t``'s structure, its leaves appended to ``out``."""
    if t is None:
        return None
    if isinstance(t, dict):
        keys = sorted(t)
        return (dict, keys, [_walk(t[k], out) for k in keys])
    if isinstance(t, (list, tuple)):
        return (type(t), None, [_walk(v, out) for v in t])
    out.append(t)
    return "leaf"


def _build(s, it):
    if s is None:
        return None
    if s == "leaf":
        return next(it)
    kind, keys, subs = s
    vals = [_build(c, it) for c in subs]
    if kind is dict:
        return dict(zip(keys, vals))
    if _is_namedtuple_type(kind):
        return kind(*vals)
    return kind(vals)


# Module-level recursion, not nested closures: a nested function that
# calls itself holds a reference cycle, which would keep the leaves it saw
# (gigabytes at full width) alive until the garbage collector runs.
def flatten(tree) -> Tuple[List[Any], Any]:
    """``(leaves, spec)``; :func:`unflatten` rebuilds the tree from them."""
    out: List[Any] = []
    spec = _walk(tree, out)
    return out, spec


def unflatten(spec, leaves) -> Any:
    return _build(spec, iter(leaves))


def leaves(tree) -> List[Any]:
    return flatten(tree)[0]


def tree_map(fn: Callable, tree, *rest) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    flat, spec = flatten(tree)
    others = [flatten(r)[0] for r in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(flat, *others)])
