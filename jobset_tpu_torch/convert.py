"""Convert a JAX parameter tree, given as nested dicts and lists of numpy
arrays, into the port's tensors. The caller does the `np.asarray` on the JAX side;
this module imports no JAX. A node with `q` and `scale` (the JAX
package's `QuantizedTensor`, after `jax.tree.map(np.asarray, ...)`)
becomes the port's `QuantizedTensor`.

`shard_params` cuts a full tree to one rank's tp shards by the
transformer's `param_specs`, and `gather_params` puts a gang's shards back
together; `shard_tree` and `gather_tree` do the same for any tree with a
tree of specs (a training state, for a checkpoint of global tensors).
"""

from __future__ import annotations

import numpy as np
import torch

from .models.quant import QuantizedTensor
from .parallel.collectives import gather


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


def _tp_dim(spec):
    return spec.index("tp") if spec is not None and "tp" in spec else None


def _walk(fn, tree, specs):
    """fn(tensor, dim) on each tensor whose spec splits a dim over tp; a
    node the specs do not reach (None, or a key they lack) is whole."""
    if isinstance(tree, dict):
        return {k: _walk(fn, v, specs.get(k) if isinstance(specs, dict) else None)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_walk(fn, v, specs[i] if isinstance(specs, list) else None)
                for i, v in enumerate(tree)]
    if torch.is_tensor(tree):
        dim = _tp_dim(specs)
        return tree if dim is None else fn(tree, dim)
    return tree


def shard_tree(full, specs, mesh):
    """Each tensor of `full` cut to `mesh`'s rank's tp shard along the dim
    its spec splits over tp (an own copy, so the full tree can be freed);
    other leaves as they are. `mesh` is a `parallel.mesh.Mesh` (groups not
    needed: `Mesh.at(config, rank)` will do)."""
    tp, index = mesh.size("tp"), mesh.index("tp")
    if tp == 1:
        return full
    return _walk(lambda t, dim: t.chunk(tp, dim)[index].clone(
        memory_format=torch.contiguous_format), full, specs)


def gather_tree(local, specs, mesh):
    """The global tree from a gang's tp shards: every tensor split over tp
    gathered along its dim over `mesh`'s tp group (every rank of the group
    takes part, and each gets the whole tree)."""
    if mesh.size("tp") == 1:
        return local
    return _walk(lambda t, dim: gather(t, dim, mesh.group("tp")), local, specs)


def shard_params(full, cfg, mesh):
    """A full transformer tree (as `params_from_jax` gives it) cut to this
    rank's shards by `param_specs(cfg)`."""
    from .models.transformer import param_specs

    return shard_tree(full, param_specs(cfg), mesh)


def gather_params(local, cfg, mesh):
    """The full transformer tree from the gang's shards (all-gathered over
    tp)."""
    from .models.transformer import param_specs

    return gather_tree(local, param_specs(cfg), mesh)
