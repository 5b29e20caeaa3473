"""The grouped (ragged) product of a mixture-of-experts layer:

    grouped_matmul(xs [M, K], w [E, K, N], group_sizes [E] int32) -> y [M, N]

computes y[r] = xs[r] @ w[g(r)] for rows sorted by expert (group e is the
next group_sizes[e] rows; rows past the last group are 0), in xs's dtype
(bfloat16 or float32) after f32 sums: `lax.ragged_dot` with
preferred_element_type = the compute dtype, as
`jobset_tpu/models/transformer.py::sorted_ragged_expert_ffn` calls it.
`grouped_matmul_plain` is that in PyTorch, a loop over the groups.

Dispatch, by device: CPU tensors go to the plain version; CUDA tensors
launch one of the hand-written kernels in `csrc/grouped_matmul.cu` once,
or raise. Which one depends on dtype, shape and alignment alone
(`variant`): f32 runs 3xTF32 on `mma.sync`; bf16 runs `wgmma` fed by TMA
where K and N are multiples of 8 and the operands 16-byte aligned, and
`mma.sync` on operands read element by element elsewhere. The group
sizes stay on the card: the work is sized from their static bound
(`row_slots`), each block finds its expert and rows from them, and slots
past the last tile are idle, so no size is read back to the host (a loop
of torch.matmul over the groups would read every size, twice in each MoE
layer).

`GROUPED_LAUNCHES` counts every launch of the kernels;
`GROUPED_TMA_LAUNCHES` those of the bf16 TMA/wgmma kernel and
`GROUPED_F32_LAUNCHES` those of the f32 one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

# Launches of the grouped kernels, counted by the wrapper where it launches:
# all of them, the bf16 TMA/wgmma kernel's, the f32 kernel's.
GROUPED_LAUNCHES = 0
GROUPED_TMA_LAUNCHES = 0
GROUPED_F32_LAUNCHES = 0

# Rows of an output tile (every kernel).
BM = 128
# bf16 on mma.sync: tile columns, threads a block, K step, ring depth.
BN, THREADS, BK, STAGES = 128, 256, 64, 3
# bf16 on TMA and wgmma: tile columns, K step, ring depth, threads a block
# (a producer and two consumer warpgroups), the registers setmaxnreg gives
# the producer and each consumer warpgroup, the pitch of the staged output
# rows (bytes), dynamic shared memory (alignment slack, the ring, the
# staged output tile, two barriers a stage).
TMA_BN, TMA_BK, TMA_STAGES, TMA_THREADS = 256, 64, 3, 384
PRODUCER_REGS, CONSUMER_REGS = 40, 232
TMA_OUT_PITCH = 2 * TMA_BN + 16
TMA_SMEM = (1024 + TMA_STAGES * (BM * TMA_BK * 2 + TMA_BK * TMA_BN * 2) + BM * TMA_OUT_PITCH
            + 2 * TMA_STAGES * 8)
# f32 on 3xTF32 (BM x BN tiles of THREADS threads, one block an SM): K
# step, ring depth, A and B row pitches (floats), dynamic shared memory.
F_BK, F_STAGES = 32, 4
F_AP, F_BP = F_BK + 8, BN + 4
SMEM_F32 = F_STAGES * (BM * F_AP + F_BK * F_BP) * 4

_VARIANT_CODES = {"f32": 0, "tma": 1, "mma": 2}


def layout() -> tuple:
    """The constants in the order `grouped_matmul_layout` in the kernel's
    source writes them."""
    return (BM, BN, THREADS, BK, STAGES, TMA_BN, TMA_BK, TMA_STAGES, TMA_THREADS, PRODUCER_REGS,
            CONSUMER_REGS, TMA_SMEM, F_BK, F_STAGES, F_AP, F_BP, SMEM_F32)


def variant(xs: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel a launch takes, from dtype, shape and alignment alone:
    "f32", "tma" (bf16; TMA needs 16-byte strides and aligned bases) or
    "mma" (bf16 otherwise)."""
    if xs.dtype == torch.float32:
        return "f32"
    k, n = xs.shape[1], w.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (xs, w, y))
    return "tma" if k > 0 and k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def row_slots(m: int, experts: int) -> int:
    """Row slots the kernels walk: group e takes ceil(size_e / BM) and the
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
    lib.grouped_matmul_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.grouped_matmul_layout.restype = ctypes.c_int
    return lib


def kernel_layout() -> tuple:
    """The constants the built kernel reports (to compare with `layout()`
    on the card)."""
    out = (ctypes.c_int * 32)()
    count = _library().grouped_matmul_layout(ctypes.addressof(out), 32)
    return tuple(out[:count])


def _grouped_matmul_cuda(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    global GROUPED_LAUNCHES, GROUPED_TMA_LAUNCHES, GROUPED_F32_LAUNCHES
    device = xs.device
    if (xs.dtype not in (torch.float32, torch.bfloat16) or w.dtype != xs.dtype or xs.dim() != 2
            or w.dim() != 3 or w.shape[1] != xs.shape[1] or group_sizes.dtype != torch.int32
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
    kind, index = variant(xs, w, y), device.index
    err = _library().grouped_matmul_launch(
        _VARIANT_CODES[kind], xs.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
        m, k_dim, n, experts, index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"grouped_matmul kernel launch failed ({kind}): CUDA error {err}")
    GROUPED_LAUNCHES += 1
    GROUPED_TMA_LAUNCHES += kind == "tma"
    GROUPED_F32_LAUNCHES += kind == "f32"
    return y


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """y [M, N] = xs [M, K] @ w[g(r)] row by row (module docstring)."""
    if xs.device.type == "cpu":
        return grouped_matmul_plain(xs, w, group_sizes)
    if xs.device.type != "cuda":
        raise ValueError(f"grouped_matmul: no implementation on device {xs.device}")
    return _grouped_matmul_cuda(xs, w, group_sizes)
