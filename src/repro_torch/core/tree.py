"""Parameter trees: nested dicts (and NamedTuples) of tensors.

The port's stand-in for the parts of ``jax.tree_util`` the training
path uses.  Leaves come in the order a JAX pytree flattens the same
structure in: dict keys sorted, NamedTuple fields in declaration order.
Key paths are spelled as the reference's checkpoint spells them: dict
keys as they are, NamedTuple fields as ``.name``, joined by ``/``.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def items_with_path(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items_with_path(tree[k], f"{prefix}{k}/")
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from items_with_path(getattr(tree, name),
                                       f"{prefix}.{name}/")
    else:
        yield prefix[:-1], tree


def leaves(tree: Any) -> List[Any]:
    return [leaf for _, leaf in items_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """`fn` over the leaves of `tree` and the matching leaves of `rest`
    (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, getattr(tree, n),
                                     *(getattr(r, n) for r in rest))
                            for n in tree._fields))
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "") -> Any:
    """`fn(key path, leaf)` over the leaves of `tree`, paths as in
    `items_with_path`."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}/")
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, n),
                                               f"{prefix}.{n}/")
                            for n in tree._fields))
    return fn(prefix[:-1], tree)


def unflatten(tree_like: Any, flat) -> Any:
    """A tree shaped like `tree_like` whose leaves are `flat`, in
    flattening order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree_like)
