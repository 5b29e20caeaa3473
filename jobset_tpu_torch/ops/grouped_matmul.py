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

The product is differentiable (`_GroupedMatmul`, an autograd Function)
while gradients are recorded and an operand needs one; otherwise a call
goes straight to the forward, as serving's do. The backward is the VJP
of `lax.ragged_dot`, two more grouped products with the compute dtype's
result after f32 sums:

    grouped_matmul_dgrad(dy [M, N], w [E, K, N], group_sizes) -> dxs [M, K]
    grouped_matmul_wgrad(xs [M, K], dy [M, N], group_sizes) -> dw [E, K, N]

dgrad is the forward's function with B transposed: on the card the TMA
kernel reads w K-major as it lies (its `BKMajor` instantiation), and the
other kernels run on a copy of w transposed to [E, N, K]. wgrad is ragged
on the contraction, dw[e] = xs[seg_e]^T @ dy[seg_e] (zeros for an empty
group), and has kernels of its own in the same source, chosen by
`wgrad_variant` from dtype, shape and alignment alone: where TMA takes
the operands, bf16 on `wgmma` fed by TMA (each tile's output staged in
shared memory and stored by TMA while the next tile's products run) and
f32 as 3xTF32 on tf32 `wgmma` fed by TMA (xs^T from registers, dy split
and transposed into K-major tiles in shared memory by the consumer warps
a step ahead); elsewhere `mma.sync`.
Their plain versions (`grouped_matmul_dgrad_plain`,
`grouped_matmul_wgrad_plain`) run one torch.matmul a group, for CPU
tensors.

`GROUPED_LAUNCHES` counts every launch of the forward's kernels;
`GROUPED_TMA_LAUNCHES` those of the bf16 TMA/wgmma kernel and
`GROUPED_F32_LAUNCHES` those of the f32 one. `GROUPED_DGRAD_LAUNCHES`
and `GROUPED_WGRAD_LAUNCHES` count the backward's launches,
`GROUPED_DGRAD_F32_LAUNCHES` and `GROUPED_WGRAD_F32_LAUNCHES` those in
f32, `GROUPED_WGRAD_TMA_LAUNCHES` and `GROUPED_WGRAD_F32_TMA_LAUNCHES`
those of the bf16 and the f32 wgrad kernel on TMA and `wgmma`.
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
# The backward's launches: dgrad's (the forward's kernels on the transposed
# weights) and wgrad's, all and those in f32; wgrad's on TMA and wgmma,
# bf16 and f32.
GROUPED_DGRAD_LAUNCHES = 0
GROUPED_DGRAD_F32_LAUNCHES = 0
GROUPED_WGRAD_LAUNCHES = 0
GROUPED_WGRAD_F32_LAUNCHES = 0
GROUPED_WGRAD_TMA_LAUNCHES = 0
GROUPED_WGRAD_F32_TMA_LAUNCHES = 0

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
# wgrad (BN x BN tiles of dw[e], THREADS threads): bf16 rows a step, ring
# depth and shared memory (xs and dy rows of a step a stage); f32 rows a
# step, ring depth, row pitch (floats) and shared memory.
W_BR, W_STAGES = 64, 3
SMEM_W_BF16 = W_STAGES * 2 * W_BR * BN * 2
WF_BR, WF_STAGES, WF_P = 32, 4, BN + 8
SMEM_W_F32 = WF_STAGES * 2 * WF_BR * WF_P * 4
# f32 wgrad on TMA and tf32 wgmma (BM x WT_BN tiles, TMA_THREADS threads,
# persistent): tile columns, rows a step, ring depth, rows a promotion
# interval; dynamic shared memory (alignment slack, the ring of xs's and
# dy's four 32 x 32 f32 boxes a stage, two buffers of B's big and small
# [WT_BN][WT_BR] tiles, two barriers a stage and a buffer).
WT_BN, WT_BR, WT_STAGES, WT_PROMOTE = 128, 32, 4, 64
WT_SMEM = 1024 + WT_STAGES * 2 * 4 * WT_BR * 32 * 4 + 2 * 2 * WT_BN * WT_BR * 4 + 2 * (WT_STAGES + 2) * 8

# The launcher's variant codes; 3 is the TMA kernel with w as [E, N, K]
# (dgrad).
_VARIANT_CODES = {"f32": 0, "tma": 1, "mma": 2}
_TMA_B_TRANSPOSED = 3


def layout() -> tuple:
    """The constants in the order `grouped_matmul_layout` in the kernel's
    source writes them."""
    return (BM, BN, THREADS, BK, STAGES, TMA_BN, TMA_BK, TMA_STAGES, TMA_THREADS, PRODUCER_REGS,
            CONSUMER_REGS, TMA_SMEM, F_BK, F_STAGES, F_AP, F_BP, SMEM_F32, W_BR, W_STAGES,
            SMEM_W_BF16, WF_BR, WF_STAGES, WF_P, SMEM_W_F32, WT_BN, WT_BR, WT_STAGES, WT_PROMOTE,
            WT_SMEM)


def variant(xs: torch.Tensor, w: torch.Tensor, y: torch.Tensor) -> str:
    """The kernel a launch takes, from dtype, shape and alignment alone:
    "f32", "tma" (bf16; TMA needs 16-byte strides and aligned bases) or
    "mma" (bf16 otherwise)."""
    if xs.dtype == torch.float32:
        return "f32"
    k, n = xs.shape[1], w.shape[-1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (xs, w, y))
    return "tma" if k > 0 and k % 8 == 0 and n % 8 == 0 and aligned else "mma"


def wgrad_variant(xs: torch.Tensor, dy: torch.Tensor, dw: torch.Tensor) -> str:
    """The wgrad kernel a launch takes, as the launcher picks it: "tma"
    (bf16) or "f32_tma" where TMA takes the operands (K and N multiples of
    8 in bf16, of 4 in f32, 16-byte aligned bases), else "mma" (bf16) or
    "f32" (4-byte copies)."""
    f32 = xs.dtype == torch.float32
    width = 4 if f32 else 8
    k, n = xs.shape[1], dy.shape[1]
    aligned = all(t.data_ptr() % 16 == 0 for t in (xs, dy, dw))
    tma = k % width == 0 and n % width == 0 and aligned
    return ("f32_tma" if tma else "f32") if f32 else ("tma" if tma else "mma")


def row_slots(m: int, experts: int) -> int:
    """Row slots the kernels walk: group e takes ceil(size_e / BM) and the
    rows past the last group ceil(rest / BM), at most ceil(M / BM) + E + 1
    together whatever the sizes."""
    return -(-m // BM) + experts + 1


def _segments(group_sizes: torch.Tensor):
    """(expert, first row, rows) of each non-empty group, the sizes read on
    the host."""
    start = 0
    for e, size in enumerate(group_sizes.tolist()):
        if size > 0:
            yield e, start, size
        start += max(size, 0)


def grouped_matmul_plain(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """The product in PyTorch: one torch.matmul a non-empty group (the
    sizes read on the host), zeros past the last group."""
    out = torch.zeros((xs.shape[0], w.shape[-1]), dtype=xs.dtype, device=xs.device)
    for e, start, size in _segments(group_sizes):
        out[start:start + size] = torch.matmul(xs[start:start + size], w[e])
    return out


def grouped_matmul_dgrad_plain(dy: torch.Tensor, w: torch.Tensor,
                               group_sizes: torch.Tensor) -> torch.Tensor:
    """dxs [M, K] = dy [M, N] @ w[g(r)]^T row by row in PyTorch: one
    torch.matmul a non-empty group, zeros past the last group."""
    return grouped_matmul_plain(dy, w.transpose(1, 2), group_sizes)


def grouped_matmul_wgrad_plain(xs: torch.Tensor, dy: torch.Tensor,
                               group_sizes: torch.Tensor) -> torch.Tensor:
    """dw [E, K, N], dw[e] = xs[seg_e]^T @ dy[seg_e], in PyTorch: one
    torch.matmul a non-empty group, zeros for an empty one."""
    dw = torch.zeros((group_sizes.shape[0], xs.shape[1], dy.shape[1]), dtype=xs.dtype,
                     device=xs.device)
    for e, start, size in _segments(group_sizes):
        dw[e] = torch.matmul(xs[start:start + size].T, dy[start:start + size])
    return dw


@functools.cache
def _library():
    lib = cuda_build.load("grouped_matmul")
    lib.grouped_matmul_launch.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    lib.grouped_matmul_launch.restype = ctypes.c_int
    lib.grouped_matmul_wgrad_launch.argtypes = lib.grouped_matmul_launch.argtypes
    lib.grouped_matmul_wgrad_launch.restype = ctypes.c_int
    lib.grouped_matmul_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.grouped_matmul_layout.restype = ctypes.c_int
    return lib


def kernel_layout() -> tuple:
    """The constants the built kernel reports (to compare with `layout()`
    on the card)."""
    out = (ctypes.c_int * 32)()
    count = _library().grouped_matmul_layout(ctypes.addressof(out), 32)
    return tuple(out[:count])


def _check(name: str, a: torch.Tensor, b: torch.Tensor, group_sizes: torch.Tensor, b_dim: int,
           shared: int, takes: str) -> None:
    """Raise unless a [M, *] and b (b_dim dims) share a dtype (float32 or
    bfloat16), b's dim `shared` matches a's columns (or rows, for wgrad),
    group_sizes is [E] int32, and all are contiguous on one device."""
    device = a.device
    a_dim = 0 if b_dim == 2 else 1
    if (a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype or a.dim() != 2
            or b.dim() != b_dim or b.shape[shared] != a.shape[a_dim]
            or group_sizes.dtype != torch.int32 or group_sizes.dim() != 1
            or (b_dim == 3 and group_sizes.shape[0] != b.shape[0])
            or not (a.is_contiguous() and b.is_contiguous() and group_sizes.is_contiguous())
            or b.device != device or group_sizes.device != device):
        raise ValueError(
            f"{name}: operands {tuple(a.shape)} {a.dtype} on {device} and {tuple(b.shape)} "
            f"{b.dtype} on {b.device}, group_sizes {tuple(group_sizes.shape)} "
            f"{group_sizes.dtype} on {group_sizes.device}: the kernel takes {takes} of one "
            "dtype (float32 or bfloat16) and group_sizes [E] int32, contiguous, on one device"
        )


def _launch(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor, name: str,
            b_transposed: bool = False):
    """One launch of the forward's kernels: (y, the variant launched or None
    where there was nothing to compute). b_transposed: w is [E, N, K] and
    y[r] = xs[r] @ w[g(r)]^T; the TMA kernel reads it so, the others take a
    copy transposed to [E, K, N]."""
    device = xs.device
    m, k_dim = xs.shape
    experts, n = w.shape[0], w.shape[1] if b_transposed else w.shape[2]
    y = torch.empty((m, n), dtype=xs.dtype, device=device)
    if m == 0 or n == 0:
        return y, None
    kind, index = variant(xs, w.transpose(1, 2) if b_transposed else w, y), device.index
    code = _VARIANT_CODES[kind]
    if b_transposed and kind == "tma":
        code = _TMA_B_TRANSPOSED
    elif b_transposed:
        w = w.transpose(1, 2).contiguous()
    err = _library().grouped_matmul_launch(
        code, xs.data_ptr(), w.data_ptr(), group_sizes.data_ptr(), y.data_ptr(),
        m, k_dim, n, experts, index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"{name} kernel launch failed ({kind}): CUDA error {err}")
    return y, kind


def _grouped_matmul_cuda(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    global GROUPED_LAUNCHES, GROUPED_TMA_LAUNCHES, GROUPED_F32_LAUNCHES
    _check("grouped_matmul", xs, w, group_sizes, 3, 1, "xs [M, K] and w [E, K, N]")
    y, kind = _launch(xs, w, group_sizes, "grouped_matmul")
    if kind is not None:
        GROUPED_LAUNCHES += 1
        GROUPED_TMA_LAUNCHES += kind == "tma"
        GROUPED_F32_LAUNCHES += kind == "f32"
    return y


def _on_card(name: str, t: torch.Tensor) -> bool:
    """False for a CPU tensor (the plain version), True for a CUDA one;
    raise for any other device."""
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no implementation on device {t.device}")
    return True


def _forward(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    if not _on_card("grouped_matmul", xs):
        return grouped_matmul_plain(xs, w, group_sizes)
    return _grouped_matmul_cuda(xs, w, group_sizes)


def grouped_matmul_dgrad(dy: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """dxs [M, K] = dy [M, N] @ w[g(r)]^T row by row (zeros past the last
    group): on the card, one launch of the forward's kernels, the TMA one
    reading w as it lies (K-major), the others a copy of w transposed to
    [E, N, K]."""
    global GROUPED_DGRAD_LAUNCHES, GROUPED_DGRAD_F32_LAUNCHES
    if not _on_card("grouped_matmul_dgrad", dy):
        return grouped_matmul_dgrad_plain(dy, w, group_sizes)
    _check("grouped_matmul_dgrad", dy, w, group_sizes, 3, 2, "dy [M, N] and w [E, K, N]")
    dxs, kind = _launch(dy, w, group_sizes, "grouped_matmul_dgrad", b_transposed=True)
    if kind is not None:
        GROUPED_DGRAD_LAUNCHES += 1
        GROUPED_DGRAD_F32_LAUNCHES += kind == "f32"
    return dxs


def grouped_matmul_wgrad(xs: torch.Tensor, dy: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """dw [E, K, N], dw[e] = xs[seg_e]^T @ dy[seg_e] (zeros for an empty
    group): on the card, one launch of the wgrad kernel `wgrad_variant`
    names (on TMA and wgmma where TMA takes the operands, on mma.sync
    elsewhere; f32 as 3xTF32)."""
    global GROUPED_WGRAD_LAUNCHES, GROUPED_WGRAD_F32_LAUNCHES, GROUPED_WGRAD_TMA_LAUNCHES
    global GROUPED_WGRAD_F32_TMA_LAUNCHES
    if not _on_card("grouped_matmul_wgrad", xs):
        return grouped_matmul_wgrad_plain(xs, dy, group_sizes)
    _check("grouped_matmul_wgrad", xs, dy, group_sizes, 2, 0, "xs [M, K] and dy [M, N]")
    (m, k_dim), n, experts = xs.shape, dy.shape[1], group_sizes.shape[0]
    dw = torch.empty((experts, k_dim, n), dtype=xs.dtype, device=xs.device)
    if k_dim == 0 or n == 0 or experts == 0:
        return dw
    index = xs.device.index
    f32 = xs.dtype == torch.float32
    kind = wgrad_variant(xs, dy, dw)
    err = _library().grouped_matmul_wgrad_launch(
        int(f32), xs.data_ptr(), dy.data_ptr(), group_sizes.data_ptr(), dw.data_ptr(), m, k_dim, n,
        experts, index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"grouped_matmul_wgrad kernel launch failed ({kind}): CUDA error {err}")
    GROUPED_WGRAD_LAUNCHES += 1
    GROUPED_WGRAD_F32_LAUNCHES += f32
    GROUPED_WGRAD_TMA_LAUNCHES += kind == "tma"
    GROUPED_WGRAD_F32_TMA_LAUNCHES += kind == "f32_tma"
    return dw


class _GroupedMatmul(torch.autograd.Function):
    """The grouped product with the VJP of `lax.ragged_dot`: dxs by dgrad,
    dw by wgrad, each only where its operand needs it."""

    @staticmethod
    def forward(ctx, xs, w, group_sizes):
        ctx.save_for_backward(xs, w, group_sizes)
        return _forward(xs, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        xs, w, group_sizes = ctx.saved_tensors
        dy = dy.contiguous()
        dxs = grouped_matmul_dgrad(dy, w, group_sizes) if ctx.needs_input_grad[0] else None
        dw = grouped_matmul_wgrad(xs, dy, group_sizes) if ctx.needs_input_grad[1] else None
        return dxs, dw, None


def grouped_matmul(xs: torch.Tensor, w: torch.Tensor, group_sizes: torch.Tensor) -> torch.Tensor:
    """y [M, N] = xs [M, K] @ w[g(r)] row by row (module docstring)."""
    if torch.is_grad_enabled() and (xs.requires_grad or w.requires_grad):
        return _GroupedMatmul.apply(xs, w, group_sizes)
    return _forward(xs, w, group_sizes)
