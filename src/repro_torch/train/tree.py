"""Dict trees of tensors, walked in the JAX package's leaf order.

``jax.tree`` flattens a dict by its sorted keys and a tuple or list by
position; the functions here do the same, so a tree's leaves, a leaf's
name and a map over several trees line up with the reference's.
"""

from __future__ import annotations

from typing import Callable, Iterator


def items(tree, prefix: tuple = ()) -> Iterator[tuple[tuple, object]]:
    """``(path, leaf)`` pairs in the reference's leaf order."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from items(tree[key], prefix + (key,))
    elif isinstance(tree, (tuple, list)):
        for i, sub in enumerate(tree):
            yield from items(sub, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in items(tree)]


def map_(fn: Callable, tree, *rest):
    """A tree of ``fn(leaf, *leaves of rest at the same path)``, ``fn``
    called in the reference's leaf order."""
    if isinstance(tree, dict):
        return {key: map_(fn, tree[key], *(r[key] for r in rest))
                for key in sorted(tree)}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_(fn, t, *(r[i] for r in rest)) for i, t in enumerate(tree))
    return fn(tree, *rest)


def key(path: tuple) -> str:
    """A leaf's checkpoint name, as the reference's ``_leaf_key`` spells
    it: the path's keys and indices joined by ``/`` (``1/m/layers/wq``)."""
    return "/".join(str(p) for p in path)


def unflatten(like, flat):
    """A tree shaped like ``like`` holding ``flat`` (its leaves, in order)."""
    it = iter(flat)
    return map_(lambda _: next(it), like)


def named(tree) -> dict:
    """``{checkpoint name: leaf}`` in the reference's leaf order: the
    arrays ``CheckpointManager.save`` writes under the names the JAX
    package's checkpoints use (``0/embed``, ``1/m/layers/wq``, ``1/step``
    for a ``(params, opt_state)`` pair)."""
    return {key(path): leaf for path, leaf in items(tree)}
