"""Weight-only int8 product of the decode step: `x @ weight_cast(qt)`.

    int8_matmul(x [..., K], qt, dtype) -> y [..., N] in dtype

computes `x.to(dtype) @ T(f32(qt.q) * qt.scale)` for an int8 weight
`qt.q` [K, N] with per-column f32 scales `qt.scale` [1, N] (a
`models.quant.QuantizedTensor`; only its `q` and `scale` are read), T =
dtype. `int8_matmul_plain` is that expression in PyTorch.

Dispatch, by device and shape:
- CPU tensors go to `int8_matmul_plain`.
- On the card, up to `ROW_CUT` rows of x (the decode step's batch)
  launch the hand-written kernel in `csrc/int8_matmul.cu`, which reads
  the int8 bytes once and dequantizes each weight as `weight_cast` does;
  a failed launch raises. Dequantizing in eager PyTorch first would write
  and read the weight again in the compute dtype (and in f32 on the way),
  about ten times the bytes of the int8 weight.
- More rows than that (the prefill's B * Tp) are a compute-bound GEMM:
  the weight is dequantized once and the product goes to `torch.matmul`.

`INT8_LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

# Launches of the int8 kernel, counted by the wrapper where it launches.
INT8_LAUNCHES = 0

# Largest row count (x's rows after flattening) that goes to the kernel;
# above it the product is a GEMM. The decode step has B rows (8 at the
# flagship), the prefill's last-position unembedding too.
ROW_CUT = 16

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values times their f32 scales, in f32, rounded once to dtype:
    the one definition of the serving dequantization (`weight_cast`)."""
    return (q * scale).to(dtype)  # int8 * f32 promotes to f32: one kernel, exact


def int8_matmul_plain(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """The product in PyTorch: dequantize, then matmul."""
    return x.to(dtype) @ dequantize(qt.q, qt.scale, dtype)


@functools.cache
def _library():
    lib = cuda_build.load("int8_matmul")
    lib.int8_matmul_launch.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    )
    lib.int8_matmul_launch.restype = ctypes.c_int
    return lib


def _int8_matmul_cuda(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """Check the operands and launch the kernel on x's device's current
    stream. The checks are few on purpose: this runs 49 times a decode
    step, and the step's time is host time."""
    global INT8_LAUNCHES
    q, scale = qt.q, qt.scale
    code = _DTYPE_CODES.get(dtype)
    k_dim, n_dim = q.shape if q.dim() == 2 else (0, 0)
    if (code is None or q.dtype != torch.int8 or scale.dtype != torch.float32
            or x.shape[-1] != k_dim or scale.numel() != n_dim
            or not (q.is_contiguous() and scale.is_contiguous())
            or q.device != x.device or scale.device != x.device):
        raise ValueError(
            f"int8_matmul: x {tuple(x.shape)} on {x.device}, q {tuple(q.shape)} {q.dtype} on "
            f"{q.device}, scale {tuple(scale.shape)} {scale.dtype} on {scale.device}, compute "
            f"dtype {dtype}: the kernel takes x [..., K], a contiguous int8 q [K, N] and "
            "contiguous f32 scales [1, N] on one device, float32 or bfloat16"
        )
    if x.dtype != dtype or not x.is_contiguous():
        x = x.to(dtype).contiguous()
    rows = x.numel() // k_dim if k_dim else 0
    if not 1 <= rows <= ROW_CUT:
        raise ValueError(f"int8_matmul: {rows} rows; the kernel takes 1..{ROW_CUT}")
    y = torch.empty((*x.shape[:-1], n_dim), dtype=dtype, device=x.device)
    index = x.device.index
    err = _library().int8_matmul_launch(
        code, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(), rows, k_dim, n_dim,
        index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    INT8_LAUNCHES += 1
    return y


def int8_matmul(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ the dequantized qt [K, N], in dtype (module docstring)."""
    if x.device.type == "cpu":
        return int8_matmul_plain(x, qt, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no implementation on device {x.device}")
    rows = x.numel() // max(x.shape[-1], 1)
    if rows > ROW_CUT:
        return int8_matmul_plain(x, qt, dtype)  # a GEMM: dequantize once, torch.matmul
    return _int8_matmul_cuda(x, qt, dtype)
