"""Parameter trees: nested dicts (and NamedTuples) of tensors.

The port's stand-in for the parts of ``jax.tree_util`` the training
path uses.  Leaves come in the order a JAX pytree flattens the same
structure in: dict keys sorted, NamedTuple fields in declaration order.
Key paths are spelled as the reference's checkpoint spells them: dict
keys as they are, NamedTuple fields as ``.name``, joined by ``/``.

A ``Sharded`` leaf (sharding/axes.py: one parameter over a mesh) is a
node here whose children are its owner blocks, in block order: the
leaves of a sharded tree are its owner tensors, each element once.
``is_leaf`` stops the walk at a node (the checkpointer stops at
``Sharded`` leaves to save them whole).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

from repro_torch.sharding.axes import Sharded


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _block_key(idx) -> str:
    return "@" + ",".join(map(str, idx))


def items_with_path(tree: Any, prefix: str = "",
                    is_leaf: Optional[Callable[[Any], bool]] = None
                    ) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) pairs in flattening order."""
    if is_leaf is not None and is_leaf(tree):
        yield prefix[:-1], tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from items_with_path(tree[k], f"{prefix}{k}/", is_leaf)
    elif _is_namedtuple(tree):
        for name in tree._fields:
            yield from items_with_path(getattr(tree, name),
                                       f"{prefix}.{name}/", is_leaf)
    elif isinstance(tree, Sharded):
        for idx, b in tree.blocks.items():
            yield f"{prefix}{_block_key(idx)}", b
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
    if isinstance(tree, Sharded):
        return tree.with_blocks([fn(b, *(r.blocks[k] for r in rest))
                                 for k, b in tree.blocks.items()])
    return fn(tree, *rest)


def tree_map_with_path(fn: Callable, tree: Any, prefix: str = "",
                       is_leaf: Optional[Callable[[Any], bool]] = None
                       ) -> Any:
    """`fn(key path, leaf)` over the leaves of `tree`, paths as in
    `items_with_path`."""
    if is_leaf is not None and is_leaf(tree):
        return fn(prefix[:-1], tree)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], f"{prefix}{k}/", is_leaf)
                for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map_with_path(fn, getattr(tree, n),
                                               f"{prefix}.{n}/", is_leaf)
                            for n in tree._fields))
    if isinstance(tree, Sharded):
        return tree.with_blocks([fn(f"{prefix}{_block_key(k)}", b)
                                 for k, b in tree.blocks.items()])
    return fn(prefix[:-1], tree)


def unflatten(tree_like: Any, flat) -> Any:
    """A tree shaped like `tree_like` whose leaves are `flat`, in
    flattening order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), tree_like)
