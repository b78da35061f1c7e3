"""Trees of parameters: dicts and lists of tensors, walked in one fixed
order, which the harness, the checks and every network share."""

from __future__ import annotations


def flatten(tree, prefix: str = "") -> list[tuple[str, object]]:
    """``(path, leaf)`` of a tree of dicts and lists, dict keys in sorted
    order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in flatten(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [kv for i, t in enumerate(tree) for kv in flatten(t, f"{prefix}{i}.")]
    return [(prefix[:-1], tree)]


def unflatten(tree, leaves):
    """``tree``'s structure around ``leaves`` (in `flatten` order)."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, (list, tuple)):
            return [build(x) for x in t]
        return next(it)

    return build(tree)
