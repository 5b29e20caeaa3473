"""The grouped (ragged) product of a mixture-of-experts layer:

    grouped_matmul(xs [M, K], w [E, K, N], group_sizes [E] int32) -> y [M, N]

computes y[r] = xs[r] @ w[g(r)] for rows sorted by expert (group e is the
next group_sizes[e] rows; rows past the last group are 0), in xs's dtype
(bfloat16 or float32) after f32 sums: `lax.ragged_dot` with
preferred_element_type = the compute dtype, as
`jobset_tpu/models/transformer.py::sorted_ragged_expert_ffn` calls it.
`grouped_matmul_plain` is that in PyTorch, a loop over the groups.

Dispatch, by device: CPU tensors go to the plain version; CUDA tensors
launch the hand-written kernel in `csrc/grouped_matmul.cu` once, or raise.
The group sizes stay on the card: the grid is sized from their static
bound (`row_slots`), each block finds its expert and rows from them, and
blocks past the last tile exit, so no size is read back to the host (a
loop of torch.matmul over the groups would read every size, twice in each
MoE layer).

`GROUPED_LAUNCHES` counts the kernel's launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

# Launches of the grouped kernel, counted by the wrapper where it launches.
GROUPED_LAUNCHES = 0

# The kernel's tiles: rows and columns of an output tile, threads a block,
# the bf16 kernel's K step and ring depth, the f32 kernel's K step.
BM, BN, THREADS, BK, STAGES, FK = 128, 128, 256, 64, 3, 8

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def layout() -> tuple:
    """The constants in the order `grouped_matmul_layout` in the kernel's
    source writes them."""
    return (BM, BN, THREADS, BK, STAGES, FK)


def row_slots(m: int, experts: int) -> int:
    """Row tiles the grid provides: group e takes ceil(size_e / BM) and the
    rows past the last group ceil(rest / BM), at most ceil(M / BM) + E + 1
    together whatever the sizes."""
    return -(-m // BM) + experts + 1


def grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The product in PyTorch: one torch.matmul a non-empty group (the
    sizes read on the host), zeros past the last group."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=xs.dtype, device=xs.device)
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size > 0:
            out[start:start + size] = torch.matmul(xs[start:start + size], w[e])
        start += max(size, 0)
    return out


@functools.cache
def _library():
    lib = cuda_build.load("grouped_matmul")
    lib.grouped_matmul_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.c_void_p]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.grouped_matmul_layout.restype = ctypes.c_int
    return lib


def kernel_layout() -> tuple:
    """The constants the built kernel reports (to compare with `layout()`
    on the card)."""
    out = (ctypes.c_int * 16)()
    count = _library().grouped_matmul_layout(ctypes.addressof(out), 16)
    return tuple(out[:count])


def _grouped_matmul_cuda(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    global GROUPED_LAUNCHES
    device = xs.device
    if (xs.dtype not in _DTYPE_CODES or w.dtype != xs.dtype or xs.dim() != 2 or w.dim() != 3
            or w.shape[1] != xs.shape[1] or group_sizes.dtype != torch.int32
            or tuple(group_sizes.shape) != (w.shape[0],)
            or not (xs.is_contiguous() and w.is_contiguous() and group_sizes.is_contiguous())
            or w.device != device or group_sizes.device != device):
        raise ValueError(
            f"grouped_matmul: xs {tuple(xs.shape)} {xs.dtype} on {device}, w {tuple(w.shape)} "
            f"{w.dtype} on {w.device}, group_sizes {tuple(group_sizes.shape)} {group_sizes.dtype} "
            f"on {group_sizes.device}: the kernel takes xs [M, K] and w [E, K, N] of one dtype "
            "(float32 or bfloat16) and group_sizes [E] int32, contiguous, on one device"
        )
    (m, k_dim), (experts, _, n) = xs.shape, w.shape
    y = torch.empty((m, n), dtype=xs.dtype, device=device)
    if m == 0 or n == 0:
        return y
    index = device.index
    err = _library().grouped_matmul_launch(
        _DTYPE_CODES[xs.dtype], xs.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
        m, k_dim, n, experts, -(-n // BN), row_slots(m, experts), index,
        torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed: CUDA error {err}")
    GROUPED_LAUNCHES += 1
    return y


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """y [M, N] = xs [M, K] @ w[g(r)] row by row (module docstring)."""
    if xs.device.type == "cpu":
        return grouped_matmul_plain(xs, w, group_sizes)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no implementation on device {xs.device}")
    return _grouped_matmul_cuda(xs, w, group_sizes)
