"""The flagship transformer's forward, serving path (greedy or sampled,
bf16 or int8) and training step (one device, or dp, pp, sp and tp over a
gang's mesh; `param_specs` names each leaf's split, `global_shapes` the
whole tree's shapes for a mesh) in PyTorch; the `mlp` and `cnn` workload kinds' models in
`models.mlp` and `models.cnn`."""

from .decode import build_generate
from .quant import quantize_params_for_serving
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
]
