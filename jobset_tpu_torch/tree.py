"""Parameter trees: nested dicts of tensors (the port's stand-in for JAX
pytrees), walked in sorted key order as JAX walks a dict, so two trees of
one structure line up leaf for leaf whatever order their keys went in."""

from __future__ import annotations


def leaves(tree: dict) -> list:
    """Every leaf of a nested dict, depth first, in sorted key order."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        out.extend(leaves(value) if isinstance(value, dict) else [value])
    return out


def rebuild(tree: dict, new_leaves) -> dict:
    """A tree of `tree`'s structure holding `new_leaves` (in `leaves` order)."""
    it = iter(new_leaves)

    def walk(node):
        return {k: walk(node[k]) if isinstance(node[k], dict) else next(it)
                for k in sorted(node)}

    return walk(tree)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """fn over the leaves of trees of one structure."""
    return rebuild(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])
