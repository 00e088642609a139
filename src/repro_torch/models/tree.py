"""The port's trees: param trees (dicts and lists of per-layer dicts of
tensors) and train states (dicts holding an ``AdamWState`` NamedTuple
whose ``step`` is a host int)."""

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


class TreeDef:
    """The structure :func:`tree_flatten` walked; :meth:`unflatten`
    rebuilds it around a list of leaves, and ``str`` spells it with ``*``
    for each leaf."""

    def __init__(self, kind, children=(), keys=()):
        self.kind = kind                 # None for a leaf, else a type
        self.children = list(children)
        self.keys = tuple(keys)          # a dict's keys, sorted
        self.n_leaves = 1 if kind is None else sum(
            c.n_leaves for c in self.children)

    def unflatten(self, leaves: list):
        if len(leaves) != self.n_leaves:
            raise ValueError(f"{len(leaves)} leaves for a tree of "
                             f"{self.n_leaves}: {self}")
        it = iter(leaves)
        return self._build(it)

    def _build(self, it):
        if self.kind is None:
            return next(it)
        kids = [c._build(it) for c in self.children]
        if self.kind is dict:
            return dict(zip(self.keys, kids))
        if self.kind in (list, tuple):
            return self.kind(kids)
        return self.kind(*kids)          # a NamedTuple

    def __str__(self) -> str:
        if self.kind is None:
            return "*"
        kids = [str(c) for c in self.children]
        if self.kind is dict:
            return "{" + ", ".join(f"{k!r}: {c}"
                                   for k, c in zip(self.keys, kids)) + "}"
        if self.kind is list:
            return "[" + ", ".join(kids) + "]"
        if self.kind is tuple:
            return "(" + ", ".join(kids) + ")"
        return f"{self.kind.__name__}(" + ", ".join(
            f"{f}={c}" for f, c in zip(self.kind._fields, kids)) + ")"


def tree_flatten(tree) -> tuple[list, TreeDef]:
    """``(leaves, treedef)`` in ``jax.tree_util``'s order: a dict's values
    by sorted key, a list's, tuple's or NamedTuple's items in order;
    anything else (a tensor, a host int or float) is a leaf."""
    leaves: list = []

    def walk(t) -> TreeDef:
        if isinstance(t, dict):
            keys = sorted(t)
            return TreeDef(dict, [walk(t[k]) for k in keys], keys)
        if isinstance(t, (list, tuple)):
            return TreeDef(type(t), [walk(x) for x in t])
        leaves.append(t)
        return TreeDef(None)

    treedef = walk(tree)
    return leaves, treedef
