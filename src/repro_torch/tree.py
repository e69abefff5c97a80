"""Parameter and state trees: nested dicts, lists, tuples and NamedTuples
of tensors, as the JAX package's pytrees (None is an empty subtree).

``leaves`` walks a tree in ``jax.tree_util``'s flattening order (dict keys
sorted) with each leaf's key path -- ``d:<key>`` for a dict key,
``a:<field>`` for a NamedTuple field, ``s:<idx>`` for a list or tuple
index, joined by ``|`` -- the names the checkpoint stores leaves under.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, Tuple

SEP = "|"


def is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key path, leaf) in ``jax.tree_util``'s flattening order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (f"d:{k}",))
    elif is_namedtuple(tree):
        for name in tree._fields:
            yield from leaves(getattr(tree, name), path + (f"a:{name}",))
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            yield from leaves(x, path + (f"s:{i}",))
    elif tree is not None:
        yield SEP.join(path), tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of ``tree``'s structure; ``fn``
    is called in the flattening order of ``leaves``."""
    if isinstance(tree, dict):
        out = {k: tree_map(fn, tree[k], *(r[k] for r in rest))
               for k in sorted(tree)}
        return {k: out[k] for k in tree}
    if is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, *xs) for xs in zip(tree, *rest)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, *xs) for xs in zip(tree, *rest))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_leaves(tree) -> list:
    return [x for _, x in leaves(tree)]


def tree_unflatten(like, flat) -> Any:
    """A tree of ``like``'s structure holding ``flat`` (in the order of
    ``tree_leaves``)."""
    it = iter(flat)
    return tree_map(lambda _: next(it), like)
