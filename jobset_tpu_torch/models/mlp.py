"""Small MLP regression model: the port of `jobset_tpu/models/mlp.py`, on
one device or data-parallel over a gang's dp axis.

The tree keeps the JAX names and shapes ({"layer_i": {"w": [d_i, d_i+1],
"b": [d_i+1]}}), so a JAX tree converts leaf for leaf. Compute is f32: a
ReLU between layers, none after the last. The loss is the squared error
summed over every output column and divided by the row count, as the
reference's psum(sum) / psum(rows): with d_out > 1 it is not
`F.mse_loss`, which would also divide by d_out. Over a gang (`mesh`) each
rank holds its dp rows of the batch; the sum and the row count are the
global ones (reduced over dp) and the gradients are summed over dp.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from .. import tree
from ..device import resolve_device
from ..parallel.collectives import all_reduce_, reduce


@dataclass(frozen=True)
class MLPConfig:
    d_in: int = 32
    d_hidden: int = 128
    d_out: int = 1
    n_layers: int = 2


def init_params(config: MLPConfig, generator: torch.Generator, device=None) -> dict:
    """normal / sqrt(fan_in) weights and zero biases, drawn on the
    generator's device and placed on `device` (the card unless the caller
    names another). The numbers differ from the JAX `init_params`."""
    device = resolve_device(device)
    cfg = config
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.d_out]
    params = {}
    for i in range(len(dims) - 1):
        w = torch.randn((dims[i], dims[i + 1]), generator=generator, device=generator.device)
        params[f"layer_{i}"] = {"w": (w / math.sqrt(dims[i])).to(device),
                                "b": torch.zeros(dims[i + 1], device=device)}
    return params


def forward(params: dict, x: torch.Tensor) -> torch.Tensor:
    n = len(params)
    for i in range(n):
        layer = params[f"layer_{i}"]
        x = x @ layer["w"] + layer["b"]
        if i < n - 1:
            x = torch.relu(x)
    return x


def loss_fn(params: dict, x: torch.Tensor, y: torch.Tensor, dp=None) -> torch.Tensor:
    """sum((pred - y)^2) / rows, both over the dp group's rows (its ranks
    hold equal shares)."""
    local = torch.sum((forward(params, x) - y) ** 2)
    if dp is None:
        return local / x.shape[0]
    return reduce(local, dp) / (x.shape[0] * torch.distributed.get_world_size(dp))


def build_train_step(config: MLPConfig, optimizer, device=None, mesh=None):
    """train_step(params, opt_state, {"x", "y"}) -> (params, opt_state,
    loss) on `device` (the card unless the caller names another), with an
    optimizer from `runtime.optim` applied as p + u; over `mesh` the batch
    is the rank's dp rows and the loss the global batch's. The step returns
    new tensors and leaves its arguments as they were."""
    del config  # the shapes come with the params
    device = resolve_device(device)
    dp = mesh.group("dp") if mesh is not None else None

    def train_step(params, opt_state, batch):
        x, y = (torch.as_tensor(batch[k]).to(device) for k in ("x", "y"))
        loss, grads = tree.value_and_grad(loss_fn, params, x, y, dp)
        all_reduce_(tree.leaves(grads), dp)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        return tree.apply_updates(params, updates), opt_state, loss

    return train_step
