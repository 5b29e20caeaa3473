"""Convert a JAX parameter tree, given as nested dicts of numpy arrays,
into the port's tensors. The caller does the `np.asarray` on the JAX side;
this module imports no JAX.
"""

from __future__ import annotations

import numpy as np
import torch


def _leaf(a) -> torch.Tensor:
    a = np.array(a, copy=True)  # own, writable, contiguous memory
    if a.dtype.name == "bfloat16":
        # ml_dtypes.bfloat16, which torch.from_numpy rejects: move the bits.
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def params_from_jax(tree: dict, device="cpu") -> dict:
    """Same names and shapes as the JAX tree, as torch tensors on `device`."""
    return {
        name: params_from_jax(v, device) if isinstance(v, dict) else _leaf(v).to(device)
        for name, v in tree.items()
    }
