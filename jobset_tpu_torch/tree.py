"""Parameter trees: nested dicts of tensors (the port's stand-in for JAX
pytrees), walked in sorted key order as JAX walks a dict, so two trees of
one structure line up leaf for leaf whatever order their keys went in. A
`QuantizedTensor` is a node of two leaves, `q` then `scale`, as in JAX."""

from __future__ import annotations

from .models.quant import QuantizedTensor


def leaves(tree: dict) -> list:
    """Every leaf of a nested dict, depth first, in sorted key order."""
    out = []
    for key in sorted(tree):
        value = tree[key]
        if isinstance(value, dict):
            out.extend(leaves(value))
        elif isinstance(value, QuantizedTensor):
            out.extend([value.q, value.scale])
        else:
            out.append(value)
    return out


def rebuild(tree: dict, new_leaves) -> dict:
    """A tree of `tree`'s structure holding `new_leaves` (in `leaves` order)."""
    it = iter(new_leaves)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(node[k]) for k in sorted(node)}
        if isinstance(node, QuantizedTensor):
            return QuantizedTensor(next(it), next(it))
        return next(it)

    return walk(tree)


def tree_map(fn, tree: dict, *rest: dict) -> dict:
    """fn over the leaves of trees of one structure."""
    return rebuild(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])
