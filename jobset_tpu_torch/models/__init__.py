"""The flagship transformer's forward (one device, or every axis of a
gang's mesh), serving path (greedy or sampled, bf16 or int8; one device,
or dp and tp over a mesh, an int8 tree cut by `quantize_specs`) and
training step (one device, or every axis of a mesh; `param_specs` names
each leaf's split, `global_shapes` the whole tree's shapes for a mesh) in
PyTorch; the `mlp` and `cnn` workload kinds' models in
`models.mlp` and `models.cnn`."""

from .decode import build_generate
from .quant import quantize_params_for_serving, quantize_specs
from .transformer import (
    TransformerConfig,
    build_eval_step,
    build_forward,
    build_train_step,
    global_shapes,
    init_params,
    param_specs,
)

__all__ = [
    "TransformerConfig",
    "build_eval_step",
    "build_forward",
    "build_generate",
    "build_train_step",
    "global_shapes",
    "init_params",
    "param_specs",
    "quantize_params_for_serving",
    "quantize_specs",
]
