"""Convert a JAX parameter tree, given as nested dicts and lists of numpy
arrays, into the port's tensors. The caller does the `np.asarray` on the JAX side;
this module imports no JAX. A node with `q` and `scale` (the JAX
package's `QuantizedTensor`, after `jax.tree.map(np.asarray, ...)`)
becomes the port's `QuantizedTensor`.
"""

from __future__ import annotations

import numpy as np
import torch

from .models.quant import QuantizedTensor


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
