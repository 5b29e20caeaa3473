"""Weight-only int8 products of the decode step: `x @ weight_cast(qt)`.

    int8_matmul(x [..., K], qt, dtype) -> y [..., N] in dtype
    int8_matmul_group(x [..., K], [qt, ...], dtype) -> [y, ...]
    int8_matmul_experts(x [E or 1, R, K], qt, dtype) -> y [E, R, N]

computes `x.to(dtype) @ T(f32(qt.q) * qt.scale)` for an int8 weight
`qt.q` [K, N] with per-column f32 scales `qt.scale` [1, N] (a
`models.quant.QuantizedTensor`; only its `q` and `scale` are read), T =
dtype; the group does so for up to `MAX_MEMBERS` weights that share x
(a layer's Q, K and V, each with its own N and scales); the expert form
does so for every expert e of a stack, q [E, K, N] with scales [E, 1, N],
against x[e] (or x[0], shared by every expert: an MoE layer's first
product). `int8_matmul_plain`, `int8_matmul_group_plain` and
`int8_matmul_experts_plain` are those expressions in PyTorch.

Dispatch, by device and shape:
- CPU tensors go to the plain versions.
- On the card, up to `ROW_CUT` rows of x (the decode step's batch)
  launch the hand-written kernel in `csrc/int8_matmul.cu` once, for every
  member of a group, which reads the int8 bytes once and dequantizes each
  weight as `weight_cast` does; a failed launch raises. Dequantizing in
  eager PyTorch first would write and read the weight again in the
  compute dtype (and in f32 on the way), about ten times the bytes of the
  int8 weight.
- More rows than that (the prefill's B * Tp) are a compute-bound GEMM:
  each weight is dequantized once and the product goes to `torch.matmul`.

The kernel's schedule is decided here (`split_for`, `block_for`): a
column's sum order is a function of K alone, so a group equals its
members' separate launches bit for bit, and each expert's slice of an
expert launch equals a 2-D launch on that expert's weight (no tile or
cluster spans two experts). The constants and layout tables below are
the kernel's own (`int8_matmul_layout` in the source returns them);
`tests/test_torch_int8_layout.py` models the kernel with them.

`INT8_LAUNCHES` counts the kernel's launches (a group's or an expert
stack's launch once).
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

# The kernel's constants: columns a warp owns and a tile (four warps side
# by side); rows of q a k16 step and a ring stage; weights a launch;
# blocks a cluster; rank lanes (four warps each) a block; ranks of K; the
# rows a rank aims at.
WARP_COLS, TILE_COLS, STEP_ROWS, STAGE_ROWS = 32, 128, 16, 32
MAX_MEMBERS, MAX_CLUSTER, MAX_RANK_LANES, MAX_RANKS = 3, 8, 2, 64
RANK_ROWS = 128
# Layout tables. A stage holds rows of 128 bytes; a lane (g = lane // 4,
# c = lane % 4) of warp w reads 4-byte words of physical rows 4c .. 4c + 3
# of a step, columns 32 w + 4g .. + 3.
# CHUNK_SWIZZLE[r]: a step's row r keeps its 16-byte chunk j at j ^ this.
CHUNK_SWIZZLE = tuple(2 * (r // 4) for r in range(STEP_ROWS))
# FRAG_K[k]: the physical row of the mma's logical k (A's column, B's row).
FRAG_K = tuple(4 * ((k % 8) // 2) + 2 * (k // 8) + k % 2 for k in range(STEP_ROWS))
# TILE_COL[t][h]: the byte of a lane's word (column 4g + byte) that is A's
# row g (h = 0) or g + 8 (h = 1) of m16 tile t.
TILE_COL = ((0, 1), (2, 3))

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_NO_MEMBER = (None, None, None, 0)  # q, scale, y, n of an unused member slot


def layout() -> tuple:
    """The constants and tables in the order `int8_matmul_layout` in the
    kernel's source writes them."""
    return (WARP_COLS, TILE_COLS, STEP_ROWS, STAGE_ROWS, ROW_CUT, MAX_MEMBERS, MAX_CLUSTER,
            MAX_RANK_LANES, MAX_RANKS, *CHUNK_SWIZZLE, *FRAG_K, *TILE_COL[0], *TILE_COL[1])


def split_for(k: int) -> tuple[int, int]:
    """(ranks, rank_rows): K cut into `ranks` slices of `rank_rows` rows (a
    multiple of STAGE_ROWS; the last slice ragged, or empty). A function of
    K alone: each slice is one chain in k order, and the slices are added
    in rank order, so this fixes every column's sum order."""
    ranks = 1
    while ranks * 2 <= min(MAX_RANKS, k // RANK_ROWS):
        ranks *= 2
    return ranks, STAGE_ROWS * -(-k // (STAGE_ROWS * ranks))


def block_for(ranks: int, ns, sms: int) -> tuple[int, int, int]:
    """(rank_lanes, ranks_per_warp, cluster): where the ranks of a
    128-column tile live. Where the tiles alone give every SM one, a block
    holds a whole tile: two rank lanes, each warp summing half the ranks in
    turn. Otherwise the ranks spread over the fewest blocks (a
    thread-block cluster above 1) that still give every SM a block, a warp
    a rank where they are that many, in turn where they outnumber the
    cluster's warps (an expert stack's tiles: more clusters, fewer blocks
    each). Moves no bit: the ranks and their order are split_for's."""
    tiles = sum(-(-n // TILE_COLS) for n in ns)
    if tiles >= sms:
        lanes = min(2, ranks)
        return lanes, ranks // lanes, 1
    cluster = 1
    while cluster < min(MAX_CLUSTER, ranks) and tiles * cluster < sms:
        cluster *= 2
    lanes = min(MAX_RANK_LANES, ranks // cluster)
    return lanes, ranks // (cluster * lanes), cluster


def dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """int8 values times their f32 scales, in f32, rounded once to dtype:
    the one definition of the serving dequantization (`weight_cast`)."""
    return (q * scale).to(dtype)  # int8 * f32 promotes to f32: one kernel, exact


def int8_matmul_plain(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """The product in PyTorch: dequantize, then matmul."""
    return x.to(dtype) @ dequantize(qt.q, qt.scale, dtype)


def int8_matmul_group_plain(x: torch.Tensor, qts, dtype: torch.dtype) -> list[torch.Tensor]:
    """The group in PyTorch: the members' plain products, one by one."""
    return [int8_matmul_plain(x, qt, dtype) for qt in qts]


def int8_matmul_experts_plain(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """The expert form in PyTorch: the stack dequantized, then a batched
    matmul ([1, R, K] broadcasts over the experts)."""
    return torch.matmul(x.to(dtype), dequantize(qt.q, qt.scale, dtype))


@functools.cache
def _library():
    lib = cuda_build.load("int8_matmul")
    member = [ctypes.c_void_p] * 3 + [ctypes.c_int]
    lib.int8_matmul_launch.argtypes = (
        [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 9 + member * MAX_MEMBERS
        + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    )
    lib.int8_matmul_launch.restype = ctypes.c_int
    lib.int8_matmul_layout.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.int8_matmul_layout.restype = ctypes.c_int
    lib.int8_matmul_smem.argtypes = [ctypes.c_int] * 8
    lib.int8_matmul_smem.restype = ctypes.c_int
    return lib


def kernel_layout() -> tuple:
    """The constants and tables the built kernel reports (to compare with
    `layout()` on the card)."""
    out = (ctypes.c_int * 64)()
    count = _library().int8_matmul_layout(ctypes.addressof(out), 64)
    return tuple(out[:count])


def dynamic_smem(rows: int, k_dim: int, ns, dtype: torch.dtype) -> int:
    """Bytes of shared memory a block of the launch for x [rows, K] and the
    widths `ns` takes on the current card (what the kernel reports)."""
    plan = _plan(k_dim, tuple(ns), torch.cuda.current_device())
    return _library().int8_matmul_smem(_DTYPE_CODES[dtype], rows, k_dim, *plan)


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _plan(k_dim: int, ns: tuple, index: int) -> tuple:
    ranks, rank_rows = split_for(k_dim)
    return (ranks, rank_rows, *block_for(ranks, ns, _sm_count(index)))


def _operand_error(x, q, scale, dtype, want: str) -> ValueError:
    return ValueError(
        f"int8_matmul: x {tuple(x.shape)} on {x.device}, q {tuple(q.shape)} {q.dtype} "
        f"on {q.device}, scale {tuple(scale.shape)} {scale.dtype} on {scale.device}, "
        f"compute dtype {dtype}: the kernel takes {want}, contiguous, on one device, "
        "float32 or bfloat16"
    )


def _launch(x, rows, k_dim, ns, members, out, dtype, experts=1, x_stride=0) -> None:
    """One launch of the kernel on x's device's current stream; `members`
    the (q, scale, y, n) pointers of each member, `experts` > 1 the stack
    of one member (x[e] x_stride elements apart, 0 = shared)."""
    global INT8_LAUNCHES
    index = x.device.index
    members = list(members) + list(_NO_MEMBER * (MAX_MEMBERS - len(ns)))
    err = _library().int8_matmul_launch(
        _DTYPE_CODES[dtype], x.data_ptr(), rows, k_dim, out.shape[-1],
        *_plan(k_dim, tuple(ns) * experts, index), len(ns), *members,
        experts, x_stride, index, torch._C._cuda_getCurrentRawStream(index),
    )
    if err:
        raise RuntimeError(f"int8_matmul kernel launch failed: CUDA error {err}")
    INT8_LAUNCHES += 1


def _int8_matmul_cuda(x: torch.Tensor, qts, dtype: torch.dtype) -> list[torch.Tensor]:
    """Check the operands and launch the kernel once for every member, on
    x's device's current stream. The outputs are column slices of one
    buffer. The checks are few on purpose: this runs 33 times a decode
    step, and the step's time is host time."""
    k_dim, device = x.shape[-1], x.device
    ns = []
    for qt in qts:
        q, scale = qt.q, qt.scale
        if (dtype not in _DTYPE_CODES or q.dtype != torch.int8 or q.dim() != 2
                or q.shape[0] != k_dim or scale.dtype != torch.float32
                or scale.numel() != q.shape[1]
                or not (q.is_contiguous() and scale.is_contiguous())
                or q.device != device or scale.device != device):
            raise _operand_error(x, q, scale, dtype,
                                 "x [..., K], an int8 q [K, N] and f32 scales [1, N]")
        ns.append(q.shape[1])
    if x.dtype != dtype or not x.is_contiguous():
        x = x.to(dtype).contiguous()
    rows = x.numel() // k_dim if k_dim else 0
    if not 1 <= rows <= ROW_CUT:
        raise ValueError(f"int8_matmul: {rows} rows; the kernel takes 1..{ROW_CUT}")
    out = torch.empty((*x.shape[:-1], sum(ns)), dtype=dtype, device=device)
    members, at, size = [], out.data_ptr(), out.element_size()
    for qt, n in zip(qts, ns):
        members += (qt.q.data_ptr(), qt.scale.data_ptr(), at, n)
        at += n * size
    _launch(x, rows, k_dim, ns, members, out, dtype)
    return list(out.split(ns, dim=-1)) if len(ns) > 1 else [out]


def _int8_matmul_experts_cuda(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """One launch for a whole expert stack: x [E or 1, R, K] against q [E,
    K, N] with scales [E, 1, N] -> y [E, R, N]."""
    q, scale = qt.q, qt.scale
    experts, k_dim, n = q.shape if q.dim() == 3 else (0, 0, 0)
    if (dtype not in _DTYPE_CODES or q.dtype != torch.int8 or q.dim() != 3 or x.dim() != 3
            or x.shape[0] not in (1, experts) or x.shape[2] != k_dim
            or scale.dtype != torch.float32 or tuple(scale.shape) != (experts, 1, n)
            or not (q.is_contiguous() and scale.is_contiguous())
            or q.device != x.device or scale.device != x.device):
        raise _operand_error(x, q, scale, dtype,
                             "x [E or 1, R, K], an int8 q [E, K, N] and f32 scales [E, 1, N]")
    if x.dtype != dtype or not x.is_contiguous():
        x = x.to(dtype).contiguous()
    rows = x.shape[1]
    if not 1 <= rows <= ROW_CUT:
        raise ValueError(f"int8_matmul: {rows} rows; the kernel takes 1..{ROW_CUT}")
    out = torch.empty((experts, rows, n), dtype=dtype, device=x.device)
    if experts:
        x_stride = rows * k_dim if x.shape[0] > 1 else 0
        _launch(x, rows, k_dim, [n], (q.data_ptr(), scale.data_ptr(), out.data_ptr(), n), out,
                dtype, experts, x_stride)
    return out


def int8_matmul_group(x: torch.Tensor, qts, dtype: torch.dtype) -> list[torch.Tensor]:
    """x [..., K] @ each dequantized qt [K, N_i], in dtype (module
    docstring): one kernel launch on the card at decode shapes."""
    if not 1 <= len(qts) <= MAX_MEMBERS:
        raise ValueError(f"int8_matmul_group: {len(qts)} weights; it takes 1..{MAX_MEMBERS}")
    if x.device.type == "cpu":
        return int8_matmul_group_plain(x, qts, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no implementation on device {x.device}")
    rows = x.numel() // max(x.shape[-1], 1)
    if rows > ROW_CUT:
        return int8_matmul_group_plain(x, qts, dtype)  # GEMMs: dequantize once, torch.matmul
    return _int8_matmul_cuda(x, qts, dtype)


def int8_matmul(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """x [..., K] @ the dequantized qt [K, N], in dtype (module docstring)."""
    return int8_matmul_group(x, [qt], dtype)[0]


def int8_matmul_experts(x: torch.Tensor, qt, dtype: torch.dtype) -> torch.Tensor:
    """x [E or 1, R, K] @ each expert's dequantized qt [E, K, N] -> [E, R,
    N] in dtype (module docstring): one kernel launch on the card for R <=
    ROW_CUT rows; above it the stack is dequantized once for a batched
    torch.matmul."""
    if x.device.type == "cpu":
        return int8_matmul_experts_plain(x, qt, dtype)
    if x.device.type != "cuda":
        raise ValueError(f"int8_matmul: no implementation on device {x.device}")
    if x.dim() == 3 and x.shape[1] > ROW_CUT:
        return int8_matmul_experts_plain(x, qt, dtype)  # GEMMs: dequantize once, torch.matmul
    return _int8_matmul_experts_cuda(x, qt, dtype)
