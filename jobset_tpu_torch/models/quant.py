"""Weight-only int8 quantization for the serving path (counterpart of
`jobset_tpu/models/quant.py`).

Decode streams the whole parameter set every step, so its time is set by
weight bytes. The scheme is the reference's:

* per-output-channel symmetric int8: for every matmul weight the
  contraction axis is the second-to-last, so the scale is the abs-max
  over axis -2 divided by 127, kept rank-preserved ([..., 1, d_out]; an
  expert stack [.., E, d_in, d_out] gets one per expert and column);
* dequantization happens at the matmul site (`weight_cast`): in f32,
  rounded once to the compute dtype. On the card a decode-step product
  goes to `ops.int8_matmul`, whose kernel does that per element while it
  streams the int8 bytes, so the weight never crosses device memory in
  the compute dtype;
* norms and the embedding table stay in full precision.

The int8 KV cache (`models/decode.py`) uses the same recipe with one
scale per cached vector (axis -1).

Over a mesh, a quantized tree is cut by `quantize_specs`: each `q` as its
weight, each scale with the contraction axis unsplit. Quantize the full
tree first, then cut it (`convert.shard_params`): the row-parallel
weights (wo, w2, we2) split their contraction axis over tp, so a scale
taken from one rank's rows would not be the reference's.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops.int8_matmul import dequantize, int8_matmul, int8_matmul_experts, int8_matmul_group

# Weight names quantized for serving; all contract over axis -2.
QUANTIZED_WEIGHTS = frozenset(
    {"wq", "wk", "wv", "wo", "w1", "w2", "we1", "we2", "unembed"}
)


@dataclass
class QuantizedTensor:
    """int8 values and rank-preserved f32 scales (size 1 on the reduced
    axis). Indexing cuts `q` and `scale` together along the leading axes,
    so a stacked [pp, layers, K, N] weight gives its layer's [K, N] pair
    (`transformer.layer_params`) and a [layers, B, T, H, D] cache its
    layer's [B, T, H, D] pair, as views."""

    q: torch.Tensor  # int8, the original tensor's shape
    scale: torch.Tensor  # f32, that shape with 1 at the reduced axis

    @property
    def shape(self) -> torch.Size:
        return self.q.shape

    def __getitem__(self, index) -> "QuantizedTensor":
        return QuantizedTensor(self.q[index], self.scale[index])

    def to(self, device) -> "QuantizedTensor":
        """Both tensors on `device`, their dtypes kept."""
        return QuantizedTensor(self.q.to(device), self.scale.to(device))

    @staticmethod
    def cat(parts) -> "QuantizedTensor":
        """Weights joined along their output (last) axis, each column with
        its own scale: the forward's fused QKV product."""
        return QuantizedTensor(torch.cat([p.q for p in parts], dim=-1),
                               torch.cat([p.scale for p in parts], dim=-1))


def quantize_int8(w: torch.Tensor, axis: int = -2) -> QuantizedTensor:
    """Symmetric per-channel int8: one scale per slice along `axis`
    (weights reduce the contraction axis -2; the KV cache the vector axis
    -1). Scale floor 1e-12, rounding half to even, range [-127, 127], all
    in f32, as the reference does."""
    w32 = w.to(torch.float32)
    absmax = torch.amax(torch.abs(w32), dim=axis, keepdim=True)
    # A tensor divisor on the tensor's device: PyTorch's CUDA division by
    # a Python scalar multiplies by its reciprocal, which rounds otherwise.
    scale = torch.clamp(absmax, min=1e-12) / torch.full((), 127.0, device=w.device)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return QuantizedTensor(q=q, scale=scale)


def weight_cast(w, dtype: torch.dtype) -> torch.Tensor:
    """Matmul-site weight fetch: a plain cast for a tensor; for a
    QuantizedTensor, dequantization in f32 rounded once to `dtype` (a scale
    rounded to bf16 first would add its own error to every weight)."""
    if isinstance(w, QuantizedTensor):
        return dequantize(w.q, w.scale, dtype)
    return w.to(dtype)


def matmul(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """A matmul site: `x @ weight_cast(w)` in `dtype`. A QuantizedTensor
    goes to `ops.int8_matmul` (the kernel on the card at decode shapes); a
    float weight stays the plain `x @ w` that training's "dots" remat
    policy saves."""
    if isinstance(w, QuantizedTensor):
        return int8_matmul(x, w, dtype)
    return x.to(dtype) @ w.to(dtype)


def matmul_group(x: torch.Tensor, ws, dtype: torch.dtype) -> list[torch.Tensor]:
    """Matmul sites that share x: `[matmul(x, w, dtype) for w in ws]`. When
    every weight is a QuantizedTensor they go to `ops.int8_matmul_group`:
    one kernel launch on the card at decode shapes, the same bits as the
    separate products."""
    if all(isinstance(w, QuantizedTensor) for w in ws):
        return int8_matmul_group(x, ws, dtype)
    return [matmul(x, w, dtype) for w in ws]


def matmul_experts(x: torch.Tensor, w, dtype: torch.dtype) -> torch.Tensor:
    """Every expert's product: x [E or 1, R, K] (1: shared by all experts)
    @ weight_cast(w) [E, K, N] -> [E, R, N] in `dtype`. An int8 stack goes
    to `ops.int8_matmul_experts`: one kernel launch on the card at decode
    shapes, each expert's slice the bits of a 2-D launch on its weight."""
    if isinstance(w, QuantizedTensor):
        return int8_matmul_experts(x, w, dtype)
    return torch.matmul(x.to(dtype), w.to(dtype))


def quantize_params_for_serving(params: dict) -> dict:
    """Every serving matmul weight (QUANTIZED_WEIGHTS, by name) of a
    transformer parameter tree quantized; everything else passed through.
    Walks nested dicts (the layers sub-tree)."""
    return {
        name: quantize_params_for_serving(value) if isinstance(value, dict)
        else quantize_int8(value) if name in QUANTIZED_WEIGHTS
        else value
        for name, value in params.items()
    }


def quantize_specs(specs: dict) -> dict:
    """`quantize_params_for_serving` on a spec tree (`param_specs`): each
    quantized weight's spec becomes QuantizedTensor(q=its spec, scale=its
    spec with the contraction axis -2 unsplit, where the scale has size 1).
    Walks nested dicts."""
    def scale_spec(spec):
        entries = list(spec)
        entries[-2] = None
        return tuple(entries)

    return {
        name: quantize_specs(value) if isinstance(value, dict)
        else QuantizedTensor(q=value, scale=scale_spec(value)) if name in QUANTIZED_WEIGHTS
        else value
        for name, value in specs.items()
    }
