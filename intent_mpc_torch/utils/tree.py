"""Trees of nested tuples and NamedTuples, the shape of the engine's carry
and of a cycle's arguments: `flatten` lists the leaves in field order and
skips None; `unflatten` puts leaves back into a template of the same
structure (engine/checkpoint's file round trip, engine/graph's static
inputs and outputs)."""

from __future__ import annotations

from typing import Sequence


def flatten(tree) -> list:
    """The leaves of nested tuples and NamedTuples (tensors, or any other
    value), in field order; None fields contribute nothing."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in flatten(sub)]
    return [tree]


def unflatten(template, leaves: Sequence):
    """Nested tuples and NamedTuples shaped like `template` holding
    `leaves` (in `flatten` order); a None field of the template stays
    None."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, tuple):
            kids = [build(sub) for sub in t]
            return type(t)(*kids) if hasattr(t, "_fields") else tuple(kids)
        return next(it)
    out = build(template)
    if next(it, None) is not None:
        raise ValueError("more leaves than the template holds")
    return out
