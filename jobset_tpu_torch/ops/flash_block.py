"""Flash-attention block step: PyTorch, with a CUDA kernel on the card.

Counterpart of `jobset_tpu/ops/flash_block.py`. One (q-block, kv-block)
step of the online-softmax recurrence that `parallel.ring_attention` and
`blockwise_causal_attention` fold:

    block_attention(q, k, v, bias) ->
        (block_max [B,H,Tq] f32, block_sum [B,H,Tq] f32,
         weighted [B,Tq,H,D] f32)

with *unnormalized* statistics, so a caller can fold many blocks into one
accumulator and divide once at the end.

Dispatch: a CUDA tensor goes to the hand-written kernels in
`csrc/flash_block.cu` (built with nvcc at first use) and a CPU tensor to
the plain version, `block_attention_reference`. There is no switch between
them: on the card a kernel launches or the call raises. On the card a call
is two launches: the tile-class pre-pass over the bias (`tile_classes`,
plain version `tile_classes_reference`), then the block kernel, which
skips fully masked 64x64 tiles and reads no bias where a tile's bias is
all zero. The block kernel has one variant per dtype: bf16 runs on the
tensor cores, f32 on the FMA pipes (true f32, no TF32).

k and v may also be given as the 5-D GQA view that `_repeat_heads` returns,
[B, Tk, H_kv, group, D] with a stride-0 group axis; both paths take it as
[B, Tk, H_kv*group, D], and the kernels read it without a copy. The bf16
kernel loads its tiles with TMA (the Tensor Memory Accelerator), so a bf16
view on the card needs unit stride on D, a 16-byte aligned base and
strides that are multiples of 16 bytes; the wrapper raises on any other
view rather than copy it.

`block_attention` is differentiable: its backward is the JAX package's
`_bwd` in torch code. It recomputes the block's probabilities from the
saved q, k, v and bias (they are never stored) and forms the backward
products from operands in the compute dtype with f32 results. No
cotangent flows through `block_max`: the (max, sum, weighted) triple is a
gauge that every consumer (merge and normalization) is invariant to, so
the end-to-end gradient does not depend on it. The backward is torch code
on the card too (a hand-written backward kernel is later work).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import cuda_build

NEG_INF = -1.0e30

# Launches counted by the wrapper where it launches: the block kernel (all
# variants), each variant of it, and the tile-class pre-pass.
KERNEL_LAUNCHES = 0
TENSOR_CORE_LAUNCHES = 0
FMA_LAUNCHES = 0
TILE_CLASS_LAUNCHES = 0

# dtype -> (kernel variant, dtype code of the C interface)
_VARIANTS = {torch.bfloat16: ("tensor_core", 1), torch.float32: ("fma", 0)}
MAX_HEAD_DIM = 128  # the kernels keep a [64, D] f32 accumulator in registers
TILE = 64  # q rows and kv rows of one tile class (and of the kernels' tiles)
MASKED, ZERO_BIAS, BIAS = 0, 1, 2  # tile classes


def _flat_heads(x):
    """[B, T, H_kv, group, D] -> [B, T, H, D] (a copy for an expand view;
    plain version only). 4-D input passes through."""
    return x.flatten(2, 3) if x.dim() == 5 else x


def _bmm_f32(a, b):
    """[N, m, k] x [N, k, n] -> [N, m, n] f32 from two operands of one
    dtype, accumulated in f32: the JAX version's preferred_element_type=f32.
    A bf16 pair on the card runs on the tensor cores with an f32 result
    (`out_dtype`, an overload CUDA has and the CPU lacks); otherwise the
    operands are upcast, which is exact for bf16, so both give the same
    products. The overload has no derivative, so where autograd records
    the product (the plain version differentiated directly) the operands
    are upcast too."""
    recorded = torch.is_grad_enabled() and (a.requires_grad or b.requires_grad)
    if a.is_cuda and a.dtype == torch.bfloat16 and not recorded:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _heads_first(x):
    """[B, T, H, D] (or the 5-D GQA view) -> [B*H, T, D]."""
    x = _flat_heads(x)
    b, t, h, d = x.shape
    return x.transpose(1, 2).reshape(b * h, t, d)


def _block_probs(q, k, bias):
    """Logits -> masked unnormalized probabilities, the softmax numerator.

    The products take the operands in their input dtype with f32 results
    (`_bmm_f32`); statistics are f32. Fully masked rows are zeroed.
    Returns (block_max [B,H,Tq] f32, probs [B,H,Tq,Tk] f32)."""
    batch, tq, heads, dim = q.shape
    logits = _bmm_f32(_heads_first(q), _heads_first(k).transpose(1, 2))
    logits = logits.view(batch, heads, tq, -1) * dim ** -0.5 + bias.float()[None, None]
    block_max = logits.amax(dim=-1)
    probs = torch.exp(logits - block_max[..., None])
    # exp(NEG_INF - NEG_INF) = 1 would count masked entries; zero them.
    valid = block_max > NEG_INF / 2
    return block_max, torch.where(valid[..., None], probs, 0.0)


def block_attention_reference(q, k, v, bias):
    """One flash step in plain PyTorch.

    q: [B, Tq, H, D], k/v: [B, Tk, H, D] (or the 5-D GQA view), bias:
    [Tq, Tk] additive mask. The probabilities are cast to v's dtype before
    the PV product, as in the JAX version: bf16 parity depends on it."""
    block_max, probs = _block_probs(q, k, bias)
    v = _flat_heads(v)
    weighted = torch.einsum(
        "bhqk,bkhd->bqhd", probs.to(v.dtype).float(), v.float()
    )
    return block_max, probs.sum(dim=-1), weighted


def tile_classes_reference(bias):
    """The class of each 64x64 tile of a [Tq, Tk] bias, as uint8
    [ceil(Tq/64), ceil(Tk/64)]: MASKED (0) where every entry is <= NEG_INF/2,
    ZERO_BIAS (1) where every entry is exactly 0.0, BIAS (2) otherwise.
    Entries past a ragged edge do not count. A MASKED tile adds p = 0 to
    every row and cannot raise a max above NEG_INF/2, so the kernels skip
    it; a ZERO_BIAS tile adds nothing, so they do not read it."""
    bias = bias.float()
    tq, tk = bias.shape
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    pad = (0, nk * TILE - tk, 0, nq * TILE - tq)

    def every(flags):
        padded = torch.nn.functional.pad(flags.float(), pad, value=1.0)
        return padded.reshape(nq, TILE, nk, TILE).amin(dim=(1, 3)) > 0

    zero = torch.where(every(bias == 0), ZERO_BIAS, BIAS)
    return torch.where(every(bias <= NEG_INF / 2), MASKED, zero).to(torch.uint8)


@functools.cache
def _library():
    lib = cuda_build.load("flash_block")
    lib.flash_block_forward.argtypes = (
        [ctypes.c_int]
        + [ctypes.c_void_p] * 8
        + [ctypes.POINTER(ctypes.c_longlong)] * 2
        + [ctypes.c_void_p]
    )
    lib.flash_block_tile_classes.argtypes = (
        [ctypes.c_void_p] * 2 + [ctypes.c_longlong] * 4 + [ctypes.c_void_p]
    )
    for fn in (lib.flash_block_forward, lib.flash_block_tile_classes):
        fn.restype = ctypes.c_int
    return lib


def _stream(device):
    return torch.cuda.current_stream(device).cuda_stream


def _tile_classes_cuda(bias):
    """Launch the tile-class pre-pass on the current stream."""
    global TILE_CLASS_LAUNCHES
    tq, tk = bias.shape
    classes = torch.empty((-(-tq // TILE), -(-tk // TILE)), dtype=torch.uint8,
                          device=bias.device)
    with torch.cuda.device(bias.device):
        err = _library().flash_block_tile_classes(
            bias.data_ptr(), classes.data_ptr(), tq, tk, *bias.stride(),
            _stream(bias.device),
        )
    if err:
        raise RuntimeError(f"flash_block tile-class kernel launch failed: CUDA error {err}")
    TILE_CLASS_LAUNCHES += 1
    return classes


def tile_classes(bias):
    """Tile classes of an f32 [Tq, Tk] bias: the pre-pass kernel on the
    card, `tile_classes_reference` on the CPU."""
    if bias.device.type == "cuda":
        return _tile_classes_cuda(bias.float())
    if bias.device.type == "cpu":
        return tile_classes_reference(bias)
    raise ValueError(f"tile_classes: no implementation on device {bias.device}")


def _check_rows(name, t):
    """A bf16 operand of the tensor-core kernel, whose TMA tensor maps take
    unit stride on D, a 16-byte aligned base, and non-zero strides that are
    multiples of 8 elements (a dim of size 1 is exempt: its stride is never
    used; so is the stride-0 group axis of a GQA view)."""
    strides = [s for i, (s, n) in enumerate(zip(t.stride()[:-1], t.shape[:-1]))
               if n > 1 and not (i == 3 and s == 0)]
    if (t.shape[-1] > 1 and t.stride(-1) != 1) or t.data_ptr() % 16 or any(
        s % 8 or s == 0 for s in strides
    ):
        raise ValueError(
            f"block_attention: bf16 {name} view (strides {t.stride()}, base "
            f"offset {t.data_ptr() % 16} mod 16 bytes) does not give 16-byte "
            "aligned rows with unit stride on D; the tensor-core kernel does "
            "not copy it to a contiguous tensor"
        )


def _used_strides(t):
    """Element strides as the kernels use them: 0 on dims of size 1."""
    return [0 if n == 1 else s for s, n in zip(t.stride(), t.shape)]


def _kernel_args(q, k, v, bias):
    """Check the operands against what the kernels take, raising ValueError
    on anything else, before any library is built. Returns (variant, dtype
    code, k5, v5, dims, strides) for the C interface."""
    k5 = k.unsqueeze(3) if k.dim() == 4 else k
    v5 = v.unsqueeze(3) if v.dim() == 4 else v
    if q.dim() != 4 or k5.dim() != 5 or v5.shape != k5.shape:
        raise ValueError(
            f"block_attention: q {tuple(q.shape)}, k {tuple(k.shape)}, "
            f"v {tuple(v.shape)} are not [B,T,H,D] (or matching GQA views)"
        )
    batch, tq, heads, dim = q.shape
    _, tk, kv_heads, group, kdim = k5.shape
    if k5.shape[0] != batch or kv_heads * group != heads or kdim != dim:
        raise ValueError(
            f"block_attention: k/v {tuple(k.shape)} do not match q {tuple(q.shape)}"
        )
    if tuple(bias.shape) != (tq, tk) or bias.dtype != torch.float32:
        raise ValueError(
            f"block_attention: bias {tuple(bias.shape)} {bias.dtype} is not f32 [{tq}, {tk}]"
        )
    if not 1 <= dim <= MAX_HEAD_DIM:
        raise ValueError(f"block_attention: head dim {dim} outside 1..{MAX_HEAD_DIM}")
    if q.dtype not in _VARIANTS or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(
            f"block_attention: dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}; "
            "the kernels take float32 or bfloat16, all alike"
        )
    if any(t.device != q.device for t in (k, v, bias)):
        raise ValueError("block_attention: q, k, v and bias must share one device")
    if tq == 0 or tk == 0 or batch * heads == 0 or batch * heads > 65535:
        raise ValueError(f"block_attention: unsupported shape {tuple(q.shape)}, Tk={tk}")
    variant, code = _VARIANTS[q.dtype]
    if variant == "tensor_core" and group > 1 and (k5.stride(3) or v5.stride(3)):
        # The kernel reads kv head h // group of a compact [B, T, H_kv, D];
        # a 5-D k/v with a group axis of its own is read as H heads.
        try:
            k5, v5 = (t.view(batch, tk, heads, 1, dim) for t in (k5, v5))
        except RuntimeError as err:
            raise ValueError(
                f"block_attention: bf16 k/v {tuple(k.shape)} with strides {k.stride()} "
                "are neither a stride-0 GQA view nor viewable as [B, T, H, D]"
            ) from err
        group = 1
    strides = [_used_strides(t) for t in (q, k5, v5)]
    if variant == "tensor_core":
        for name, t in (("q", q), ("k", k5), ("v", v5)):
            _check_rows(name, t)
        for s in strides:
            s[-1] = 1
    dims = (batch, heads, tq, tk, dim, group)
    return variant, code, k5, v5, dims, [x for s in strides for x in s] + list(bias.stride())


def _block_attention_cuda(q, k, v, bias, classes=None):
    """Check the operands, launch the tile-class pre-pass (unless `classes`
    is given) and the block kernel's variant for q's dtype on the current
    stream, and raise if a launch failed."""
    global KERNEL_LAUNCHES, TENSOR_CORE_LAUNCHES, FMA_LAUNCHES
    variant, code, k5, v5, dims, strides = _kernel_args(q, k, v, bias)
    batch, heads, tq, _, dim, _ = dims
    if classes is None:
        classes = _tile_classes_cuda(bias)
    out_max = torch.empty((batch, heads, tq), dtype=torch.float32, device=q.device)
    out_sum = torch.empty_like(out_max)
    weighted = torch.empty((batch, tq, heads, dim), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        err = _library().flash_block_forward(
            code, q.data_ptr(), k5.data_ptr(), v5.data_ptr(), bias.data_ptr(),
            classes.data_ptr(), out_max.data_ptr(), out_sum.data_ptr(),
            weighted.data_ptr(), (ctypes.c_longlong * 6)(*dims),
            (ctypes.c_longlong * 16)(*strides), _stream(q.device),
        )
    if err:
        raise RuntimeError(f"flash_block {variant} kernel launch failed: CUDA error {err}")
    KERNEL_LAUNCHES += 1
    if variant == "tensor_core":
        TENSOR_CORE_LAUNCHES += 1
    else:
        FMA_LAUNCHES += 1
    return out_max, out_sum, weighted


def _block_attention_bwd(q, k, v, bias, dsum, dweighted, needs):
    """The JAX package's `_bwd`: gradients of (block_sum, weighted) with
    respect to (q, k, v, bias), each in its input's dtype and shape (a GQA
    view's gradient keeps the view's shape; autograd sums its group axis).
    `needs` is ctx.needs_input_grad; an input that needs none gets None."""
    compute = q.dtype
    batch, tq, heads, dim = q.shape
    scale = dim ** -0.5
    # Recompute the probabilities: the same `_block_probs` the plain
    # forward runs, so forward and backward cannot drift.
    _, probs = _block_probs(q, k, bias)
    tk = probs.shape[-1]

    # d(probs) from block_sum (broadcast) and from weighted = probs @ v;
    # with unnormalized probs d(logits) = probs * d(probs), and the
    # softmax Jacobian's subtraction arrives through dsum.
    dw_c = _heads_first(dweighted.to(compute))
    dlogits = _bmm_f32(dw_c, _heads_first(v).transpose(1, 2)).view(batch, heads, tq, tk)
    dlogits.add_(dsum[..., None]).mul_(probs)
    probs_c = probs.to(compute).view(batch * heads, tq, tk)
    del probs
    dl_c = dlogits.to(compute).view(batch * heads, tq, tk)

    def back(g, like):  # [B*H, T, D] f32 -> like's shape and dtype
        g = g.view(batch, heads, -1, dim).transpose(1, 2)
        return g.reshape(like.shape).to(like.dtype)

    dq = back(_bmm_f32(dl_c, _heads_first(k)) * scale, q) if needs[0] else None
    dk = back(_bmm_f32(dl_c.transpose(1, 2), _heads_first(q)) * scale, k) if needs[1] else None
    dv = back(_bmm_f32(probs_c.transpose(1, 2), dw_c), v) if needs[2] else None
    dbias = dlogits.sum(dim=(0, 1)).to(bias.dtype) if needs[3] else None
    return dq, dk, dv, dbias


def _block_attention_forward(q, k, v, bias):
    """The kernel on the card, the plain version on the CPU."""
    if q.device.type == "cuda":
        return _block_attention_cuda(q, k, v, bias)
    if q.device.type == "cpu":
        return block_attention_reference(q, k, v, bias)
    raise ValueError(f"block_attention: no implementation on device {q.device}")


class _BlockAttention(torch.autograd.Function):
    """The block step with the recompute backward (`jax.custom_vjp` of the
    JAX version): the forward saves its inputs only."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        ctx.save_for_backward(q, k, v, bias)
        return _block_attention_forward(q, k, v, bias)

    @staticmethod
    def backward(ctx, dmax, dsum, dweighted):
        del dmax  # the gauge direction: no flow through the block max
        return _block_attention_bwd(*ctx.saved_tensors, dsum, dweighted,
                                    ctx.needs_input_grad)


def block_attention(q, k, v, bias):
    """The flash block step; see the module docstring for the contract.
    q/k/v stay in their dtype (f32 or bf16); bias and every output are f32.
    Differentiable in q, k, v and bias. A call that autograd does not
    record (grad disabled, as in serving, or no input that requires grad)
    goes straight to the forward, without the autograd.Function's cost."""
    bias = bias.float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v, bias)):
        return _BlockAttention.apply(q, k, v, bias)
    return _block_attention_forward(q, k, v, bias)


def _repeat_heads(x, group: int):
    """GQA broadcast of [B, T, H_kv, D]: an expand view [B, T, H_kv, group,
    D] (stride 0 on the group axis, no copy), which block_attention takes
    as [B, T, H_kv*group, D]. group == 1 returns x."""
    if group == 1:
        return x
    b, t, hkv, d = x.shape
    return x[:, :, :, None, :].expand(b, t, hkv, group, d)


def causal_bias(n: int, device) -> torch.Tensor:
    """[n, n] f32 lower-triangular additive mask: 0 on and below the
    diagonal, NEG_INF above."""
    idx = torch.arange(n, device=device)
    rel = idx[:, None] - idx[None, :]
    return torch.where(rel >= 0, 0.0, NEG_INF).to(torch.float32)


def merge_block_stats(acc, blk):
    """Online-softmax merge of two unnormalized (max, sum, weighted)
    triples; max/sum are [B, H, Tq], weighted is [B, Tq, H, D]."""
    acc_max, acc_sum, acc_out = acc
    blk_max, blk_sum, blk_out = blk
    new_max = torch.maximum(acc_max, blk_max)
    old_scale = torch.exp(acc_max - new_max)
    blk_scale = torch.exp(blk_max - new_max)
    new_sum = acc_sum * old_scale + blk_sum * blk_scale
    new_out = (
        acc_out * old_scale.transpose(1, 2)[..., None]
        + blk_out * blk_scale.transpose(1, 2)[..., None]
    )
    return new_max, new_sum, new_out


def normalize_block_stats(acc_sum, acc_out):
    """Final division of the folded accumulator; clamped so fully-masked
    rows yield 0 instead of NaN."""
    denom = torch.clamp(acc_sum, min=1e-20).transpose(1, 2)[..., None]
    return acc_out / denom


def blockwise_causal_attention(q, k, v, chunk: int = 512, causal: bool = True):
    """Exact attention over positions 0..T-1, folded chunk by chunk so no
    [T, T] bias or probability matrix materializes: a [c, c] triangle on
    the diagonal, zeros below it, and (with `causal`) strictly-future
    chunk pairs skipped. The chunk is floored at T/16.

    q/k/v: [B, T, H, D]; k/v may carry fewer heads than q (GQA), broadcast
    per block as a view. Returns [B, T, H, D] f32."""
    t_total = q.shape[1]
    batch, _, heads, dim = q.shape
    group = heads // k.shape[2]
    chunk = max(chunk, -(-t_total // 16))
    starts = list(range(0, t_total, chunk))

    out_chunks = []
    for i, qs in enumerate(starts):
        q_len = min(chunk, t_total - qs)
        q_i = q[:, qs:qs + q_len]
        acc = (
            torch.full((batch, heads, q_len), NEG_INF, dtype=torch.float32, device=q.device),
            torch.zeros((batch, heads, q_len), dtype=torch.float32, device=q.device),
            torch.zeros((batch, q_len, heads, dim), dtype=torch.float32, device=q.device),
        )
        kv_starts = starts[: i + 1] if causal else starts
        for j, ks in enumerate(kv_starts):
            k_len = min(chunk, t_total - ks)
            if causal and j == i:
                bias = causal_bias(q_len, q.device)
            else:
                bias = torch.zeros((q_len, k_len), dtype=torch.float32, device=q.device)
            blk = block_attention(
                q_i,
                _repeat_heads(k[:, ks:ks + k_len], group),
                _repeat_heads(v[:, ks:ks + k_len], group),
                bias,
            )
            acc = merge_block_stats(acc, blk)
        out_chunks.append(normalize_block_stats(acc[1], acc[2]))
    return torch.cat(out_chunks, dim=1)
