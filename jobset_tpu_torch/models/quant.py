"""Matmul-site weight fetch for the port (counterpart of
`jobset_tpu/models/quant.py`).

Only the plain-cast branch is ported: `QuantizedTensor` and int8 weights
and KV cache come with a later slice.
"""

from __future__ import annotations

import torch


def weight_cast(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Cast a float weight to the compute dtype at its matmul site."""
    return w.to(dtype)
