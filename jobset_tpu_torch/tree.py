"""Parameter trees: nested dicts and lists of tensors (the port's stand-in
for JAX pytrees), walked as `jax.tree.leaves` walks them: a dict in sorted
key order, a list in index order, depth first. So two trees of one
structure line up leaf for leaf whatever order their keys went in. A
`QuantizedTensor` is a node of two leaves, `q` then `scale`, as in JAX."""

from __future__ import annotations

import torch

from .models.quant import QuantizedTensor


def leaves(tree) -> list:
    """Every leaf of a nested dict/list, depth first: dict keys sorted, list
    items in order."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree) for leaf in leaves(tree[key])]
    if isinstance(tree, list):
        return [leaf for item in tree for leaf in leaves(item)]
    if isinstance(tree, QuantizedTensor):
        return [tree.q, tree.scale]
    return [tree]


def _rebuild(node, it):
    if isinstance(node, dict):
        return {k: _rebuild(node[k], it) for k in sorted(node)}
    if isinstance(node, list):
        return [_rebuild(item, it) for item in node]
    if isinstance(node, QuantizedTensor):
        return QuantizedTensor(next(it), next(it))
    return next(it)


def rebuild(tree, new_leaves):
    """A tree of `tree`'s structure holding `new_leaves` (in `leaves` order).
    No closure: a recursive inner function would make a reference cycle
    that keeps `new_leaves` (a step's gradients, say) alive until the
    garbage collector runs."""
    return _rebuild(tree, iter(new_leaves))


def tree_map(fn, tree, *rest):
    """fn over the leaves of trees of one structure."""
    return rebuild(tree, [fn(*xs) for xs in zip(leaves(tree), *map(leaves, rest))])


def value_and_grad(loss_fn, params, *args):
    """(loss, gradient tree) of loss_fn(params, *args) with respect to every
    leaf of `params`, which is left as it was."""
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    loss = loss_fn(live, *args)
    return loss.detach(), rebuild(params, torch.autograd.grad(loss, leaves(live)))


def apply_updates(params, updates):
    """optax.apply_updates: (p + u) in p's dtype, leaf by leaf."""
    return tree_map(lambda p, u: (p + u).to(p.dtype), params, updates)
