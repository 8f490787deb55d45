"""The leaf order of the training state: nested dicts (keys sorted), tuples
and lists (in order) down to tensors, the order in which ``jax.tree``
flattens the JAX package's state.  The optimizer sums the gradient norm
over leaves in it, and checkpoints store leaves in it, so a checkpoint of
either package restores in the other."""
from __future__ import annotations

from typing import Any, List


def leaves(tree) -> List[Any]:
    """The leaves of ``tree`` in the reference's flatten order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in leaves(t)]
    return [tree]


def unflatten(like, flat: List[Any]):
    """A tree of ``like``'s structure holding ``flat`` in leaf order."""
    it = iter(flat)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out


def leaf_names(tree, prefix: str = "") -> List[str]:
    """Dotted names of the leaves in ``leaves`` order: dict keys, and the
    positions of tuple and list items (``"1.m.blocks.wq.q"``)."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (tuple, list)):
        return [n for i, t in enumerate(tree)
                for n in leaf_names(t, f"{prefix}{i}.")]
    return [prefix[:-1]]
