"""ZeRO-1: the optimizer state split over dp (counterpart of
`jobset_tpu/parallel/zero.py`).

The parameters stay replicated over dp, and by default so does the
optimizer state (Adam's mu and nu are twice the parameters' bytes). ZeRO-1
splits each parameter-shaped state leaf over dp along one dim the
parameter's spec leaves unsplit. The reference makes that a placement of
the state and lets XLA partition the update; the port places the state
(`shard_state`) and runs the update on each rank's slice itself
(`runtime.optim.zero1`).

`widen_spec` is the reference's `_widen_spec`: dp goes onto the first dim
whose spec names no axis and whose size divides by dp. It goes by names,
not sizes, so a stacked layer leaf ("pp", None, None, "tp") takes dp on
its layer axis and `embed` ("tp", None) on its model dim, at tp = 1 too.
`zero1_plan` widens only the state leaves shaped like their
parameter (Adam's mu and nu, a momentum trace, adafactor's unfactored v);
adafactor's factored accumulators, its (1,)-shaped placeholders and the
count stay as they were.
"""

from __future__ import annotations

import torch

from .. import tree


def widen_spec(spec, shape, dp: int) -> tuple:
    """`spec` (padded with None to the leaf's rank) with "dp" on the first
    dim that names no axis and whose size divides by dp (and is > 0)."""
    parts = list(spec) if spec is not None else []
    parts += [None] * (len(shape) - len(parts))
    if dp > 1:
        for i, (part, dim) in enumerate(zip(parts, shape)):
            if part is None and dim % dp == 0 and dim > 0:
                parts[i] = "dp"
                break
    return tuple(parts)


def _structure(node):
    """A node's nesting of dicts and lists, leaves as None."""
    if isinstance(node, dict):
        return tuple((k, _structure(node[k])) for k in sorted(node))
    if isinstance(node, list):
        return ("list", tuple(_structure(v) for v in node))
    return None


def zero1_plan(state, params, state_specs, param_specs, dp: int) -> tuple:
    """(the state's specs with dp where ZeRO-1 splits a leaf, and for each
    parameter leaf the dim it splits, or None). `state_specs` are as
    `Optimizer.state_specs` gives them. In each subtree of `state` shaped
    as the `params` tree, each leaf of its parameter's shape takes the
    parameter's spec widened (`widen_spec`); every other leaf keeps its
    spec. Shapes are local (a tp shard's): the dims `widen_spec` may take
    are unsplit, so their sizes are the global ones."""
    widened = [widen_spec(s, p.shape, dp)
               for s, p in zip(tree.leaves(param_specs), tree.leaves(params))]
    pdef, split = _structure(params), [False] * len(widened)

    def walk(node, specs):
        if isinstance(node, dict) and node and _structure(node) == pdef:
            out = []
            for i, (leaf, p, spec) in enumerate(zip(tree.leaves(node), tree.leaves(params),
                                                    tree.leaves(specs))):
                shaped = torch.is_tensor(leaf) and leaf.shape == p.shape
                split[i] |= shaped
                out.append(widened[i] if shaped else spec)
            return tree.rebuild(params, out)
        if isinstance(node, dict):
            return {k: walk(v, specs.get(k) if isinstance(specs, dict) else None)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, specs[i] if isinstance(specs, list) else None)
                    for i, v in enumerate(node)]
        return specs

    specs = walk(state, state_specs)
    return specs, [wide.index("dp") if shaped and "dp" in wide else None
                   for shaped, wide in zip(split, widened)]


def shard_state(state, specs, mesh):
    """Each state leaf whose spec names dp cut to this rank's slice along
    that dim, in memory of its own (contiguous). `convert.gather_tree`
    over dp puts it back together."""
    from ..convert import shard_tree

    return shard_tree(state, specs, mesh, axes=("dp",))
