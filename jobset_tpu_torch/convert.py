"""Convert a JAX parameter tree, given as nested dicts and lists of numpy
arrays, into the port's tensors. The caller does the `np.asarray` on the JAX side;
this module imports no JAX. A node with `q` and `scale` (the JAX
package's `QuantizedTensor`, after `jax.tree.map(np.asarray, ...)`)
becomes the port's `QuantizedTensor`.

`shard_params` cuts a full tree to one rank's tp and ep shards of its pp
stage by the transformer's `param_specs` (an int8 serving tree by
`quantize_specs`: its `q` and `scale` each cut as contiguous shards),
and `gather_params` puts a gang's shards back together; `shard_tree` and
`gather_tree` do the same for any tree with a tree of specs (a training
state, for a checkpoint of global tensors), over every mesh axis a spec
names (tp, ep, pp, and dp for a ZeRO-1 optimizer state), or over the
axes the caller names.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.quant import QuantizedTensor, quantize_specs
from .parallel.collectives import gather
from .parallel.mesh import AXIS_NAMES


def _leaf(a) -> torch.Tensor:
    a = np.array(a, copy=True)  # own, writable, contiguous memory
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy rejects: move the bits.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _node(v, device):
    if isinstance(v, dict):
        return params_from_jax(v, device)
    if isinstance(v, (list, tuple)):
        return [_node(item, device) for item in v]
    if hasattr(v, "q") and hasattr(v, "scale"):
        return QuantizedTensor(_leaf(v.q).to(device), _leaf(v.scale).to(device))
    return _leaf(v).to(device)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Same names and shapes as the JAX tree, as torch tensors on `device`."""
    return {name: _node(v, device) for name, v in tree.items()}


def _split_dims(spec, mesh, axes):
    """[(dim, axis), ...] for the dims `spec` splits over an axis of `axes`
    that has more than one rank on `mesh`."""
    if spec is None:
        return []
    return [(dim, axis) for dim, axis in enumerate(spec)
            if axis in axes and mesh.size(axis) > 1]


def _walk(fn, tree, specs, mesh, axes):
    """fn(tensor, dim, axis) on each tensor, for each dim its spec splits
    over one of `axes`; a node the specs do not reach (None, or a key they
    lack) is whole. A QuantizedTensor's q and scale go by the fields of a
    QuantizedTensor of specs (`quantize_specs`)."""
    if isinstance(tree, QuantizedTensor):
        if not isinstance(specs, QuantizedTensor):
            return tree
        return QuantizedTensor(_walk(fn, tree.q, specs.q, mesh, axes),
                               _walk(fn, tree.scale, specs.scale, mesh, axes))
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs.get(k) if isinstance(specs, dict) else None, mesh, axes)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, specs[i] if isinstance(specs, list) else None, mesh, axes)
                for i, v in enumerate(tree)]
    if torch.is_tensor(tree):
        for dim, axis in _split_dims(specs, mesh, axes):
            tree = fn(tree, dim, axis)
    return tree


def shard_tree(full, specs, mesh, axes=AXIS_NAMES):
    """Each tensor of `full` cut to `mesh`'s rank's shard along each dim its
    spec splits over one of `axes` (an own copy, so the full tree can be
    freed); other leaves as they are. `mesh` is a `parallel.mesh.Mesh`
    (groups not needed: `Mesh.at(config, rank)` will do)."""
    return _walk(lambda t, dim, axis: t.chunk(mesh.size(axis), dim)[mesh.index(axis)].clone(
        memory_format=torch.contiguous_format), full, specs, mesh, axes)


def gather_tree(local, specs, mesh, axes=AXIS_NAMES):
    """The global tree from a gang's shards: every tensor split over one of
    `axes` gathered along its dim over that axis's group (every rank of the
    group takes part, and each gets the whole tree)."""
    return _walk(lambda t, dim, axis: gather(t, dim, mesh.group(axis)), local, specs, mesh,
                 axes)


def _specs_of(tree, cfg):
    """`param_specs(cfg)`, through `quantize_specs` for a tree that holds
    int8 weights."""
    from .models.transformer import param_specs

    specs = param_specs(cfg)
    quantized = any(isinstance(v, QuantizedTensor)
                    for d in (tree, tree["layers"]) for v in d.values())
    return quantize_specs(specs) if quantized else specs


def shard_params(full, cfg, mesh):
    """A full transformer tree (as `params_from_jax` gives it, its layer
    leaves stacked [pp, n_layers / pp, ...] for the mesh's pp) cut to this
    rank's shards by `param_specs(cfg)`. An int8 tree is cut by
    `quantize_specs`: quantize the full tree, then cut it (the scales of
    the row-parallel weights span every rank's rows)."""
    stages = {a.shape[0] for a in full["layers"].values()}
    if stages != {mesh.size("pp")}:
        raise ValueError(f"layer leaves stacked over {sorted(stages)} stages, the mesh has pp "
                         f"{mesh.size('pp')}: stack them [pp, n_layers / pp, ...] "
                         "(init_params(..., mesh_config=...))")
    return shard_tree(full, _specs_of(full, cfg), mesh)


def gather_params(local, cfg, mesh):
    """The full transformer tree from the gang's shards (all-gathered over
    tp, ep and pp), int8 trees too."""
    return gather_tree(local, _specs_of(local, cfg), mesh)
