"""The port's param trees: dicts and lists of per-layer dicts of
tensors."""

from __future__ import annotations


def tree_map(fn, *trees):
    """``fn`` over the leaves of trees of one structure (dicts and lists;
    anything else is a leaf)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: tree_map(fn, *(x[k] for x in trees)) for k in t}
    if isinstance(t, list):
        return [tree_map(fn, *xs) for xs in zip(*trees)]
    return fn(*trees)
