"""Card-only tests of the port: the CUDA kernels against their plain
versions, the serving path and the train step on the card against the same
paths on the CPU, the block backward kernel against its plain version
(bit for bit twice, zeros where no tile is live) and on the card against
the CPU's, the
kernel launches per train step under each remat setting, the auction
kernel and the solver surface on the card against the CPU, the control
plane's device programs (admission scorer, gang-readiness aggregate,
policy MLP and trainer) against the port's CPU path and plain versions,
the serving path's int8 kernel, launch counts, int8 decoding and
sampling on the card, and the MoE path: the grouped expert kernel against
its plain version, the int8 kernel's expert axis against 2-D launches,
MoE serving and forward against the CPU, with no host sync; the grouped
product's backward kernels (dgrad, wgrad) against their plain versions,
the f32 wgrad kernel taken where TMA can take the operands and held to
the tolerance over a 16384-row segment, and the MoE train step against
the CPU's, with no host sync in a MoE layer's forward and backward; the
workload kinds: the CNN's "SAME" convolutions and train step (f32 and
bf16, cuDNN's TF32 off), adafactor's updates and the mlp workload's
losses against the CPU's; gangs on the card: a small f32 config at tp = 2
(two ranks sharing the card on gloo with CUDA tensors) against one
process, and NCCL at world 1 against gloo bit for bit.

They skip without a CUDA device. This file imports no JAX, so it also runs
on a machine that has none: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the repo's conftest imports JAX).

Tolerances: f32 1e-4 (the kernel's 3xTF32 products, errors near 2^-22 of
each product, in another order than cuBLAS/CPU sums; TF32 off for the
plain version);
bf16 2e-2 relative to the tensor's largest value on sums and weighted
values (p is rounded to bf16 against the running max in the kernel and
against the block max in the plain version). The auction: none; its
assignments, prices and iteration counts are identical. The scorer and
the aggregate: none (bit for bit, exact counts); the MLP and the trainer:
as stated in their tests. The int8 kernel, per element: bf16
|got - want| <= 2^-7 |want| + 1e-4 max|want| (one rounding of the output
to bf16, which two f32 sums in another order may put one ulp apart; an
ulp is at most 2^-7 of the value), f32 1e-5 max|want| (f32 sums in
another order); the grouped expert kernel the same, for the same reasons
(its f32 kernel's 3xTF32 products err by about 2^-22 of each product,
and its sums add each K step's to the output in f32, rounded to
nearest).
"""

import numpy as np
import pytest
import torch

from dataclasses import replace

from jobset_tpu_torch import tree
from jobset_tpu_torch.models import decode, quant, transformer
from jobset_tpu_torch.ops import auction as auction_ops
from jobset_tpu_torch.ops import flash_block as fb
from jobset_tpu_torch.ops import grouped_matmul as gm
from jobset_tpu_torch.ops import int8_matmul as i8
from jobset_tpu_torch.placement import solver as S
from jobset_tpu_torch.runtime import optim


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = prev


def _within(got, want, rtol, atol):
    err = (got.float() - want.float()).abs().max().item()
    return err <= atol + rtol * want.float().abs().max().item()


def _bias(kind, tq, tk, device):
    """The [Tq, Tk] f32 bias kinds that chip_smoke.py also runs."""
    rel = (torch.arange(tq, device=device)[:, None]
           - torch.arange(tk, device=device)[None]).float()
    cols = torch.arange(tk, device=device)[None].expand(tq, tk)
    masked = {
        "triangle": rel < 0,
        "reverse_triangle": rel > 0,
        "band": (cols >= tk // 3) & (cols < 2 * tk // 3),
        "zero": torch.zeros_like(rel, dtype=torch.bool),
        "all_masked": torch.ones_like(rel, dtype=torch.bool),
        "alibi": torch.zeros_like(rel, dtype=torch.bool),
    }[kind]
    values = -0.05 * rel.abs() if kind == "alibi" else torch.zeros_like(rel)
    return torch.where(masked, fb.NEG_INF, values)


BIAS_KINDS = ["triangle", "zero", "all_masked", "band", "reverse_triangle", "alibi"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias_kind", BIAS_KINDS)
def test_kernel_matches_plain_version(cuda, dtype, bias_kind):
    gen = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((2, 100, 4, 32), generator=gen, device=cuda).to(dtype)
    k_c, v_c = (torch.randn((2, 77, 2, 32), generator=gen, device=cuda).to(dtype)
                for _ in range(2))
    k, v = fb._repeat_heads(k_c, 2), fb._repeat_heads(v_c, 2)
    bias = _bias(bias_kind, 100, 77, cuda)
    counter = "TENSOR_CORE_LAUNCHES" if dtype == torch.bfloat16 else "F32_LAUNCHES"
    before, before_variant = fb.KERNEL_LAUNCHES, getattr(fb, counter)
    got = fb.block_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fb.KERNEL_LAUNCHES == before + 1 and getattr(fb, counter) == before_variant + 1
    want = fb.block_attention_reference(q, k, v, bias)
    rtol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    assert _within(got[0], want[0], 1e-5, 1e-4)
    assert _within(got[1], want[1], rtol, 1e-5)
    assert _within(got[2], want[2], rtol, 1e-5)
    if bias_kind == "all_masked":
        assert torch.all(got[1] == 0) and torch.all(got[2] == 0)


def _f32_operands(view, device, tq=130, tk=200, heads=4, dim=64, q_scale=1.0):
    """q [B, Tq, H, D], k and v as the f32 kernel gets them in one kind of
    view: "aligned" (16-byte copies), "unaligned_base" (base 4 bytes past a
    16-byte boundary), "d_stride" (stride 2 on D), "d5" (D=5 rows, 20 bytes
    apart) take the 4-byte copies; "gqa" (stride-0 group axis) and
    "fused_qkv" (split views of one [B, T, (H + 2 H_kv) D] buffer) the
    16-byte ones."""
    gen = torch.Generator(device=device).manual_seed(11)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=device)

    if view == "d5":
        dim = 5
    if view == "fused_qkv":
        qkv = randn(2, tq, 3 * heads * dim)
        q, k, v = (t.reshape(2, tq, heads, dim) for t in qkv.split(heads * dim, dim=-1))
    elif view == "gqa":
        q = randn(2, tq, heads, dim)
        k, v = (fb._repeat_heads(randn(2, tk, heads // 2, dim), 2) for _ in range(2))
    elif view == "unaligned_base":
        q, k, v = (randn(2 * t * heads * dim + 1)[1:].view(2, t, heads, dim)
                   for t in (tq, tk, tk))
    elif view == "d_stride":
        q, k, v = (randn(2, t, heads, 2 * dim)[..., ::2] for t in (tq, tk, tk))
    else:
        q, k, v = (randn(2, t, heads, dim) for t in (tq, tk, tk))
    return q * q_scale if q_scale != 1.0 else q, k, v


F32_VIEWS = ["aligned", "unaligned_base", "d_stride", "d5", "gqa", "fused_qkv"]


@pytest.mark.cuda
@pytest.mark.parametrize("bias_kind", ["triangle", "alibi"])
@pytest.mark.parametrize("view", F32_VIEWS)
def test_f32_kernel_takes_every_view(cuda, view, bias_kind):
    # Both loaders of the f32 kernel (16-byte and 4-byte copies), at the
    # f32 tolerances.
    q, k, v = _f32_operands(view, cuda, tq=130 if view != "fused_qkv" else 200)
    bias = _bias(bias_kind, q.shape[1], k.shape[1], cuda)
    before = fb.F32_LAUNCHES
    got = fb.block_attention(q, k, v, bias)
    torch.cuda.synchronize()
    assert fb.F32_LAUNCHES == before + 1
    want = fb.block_attention_reference(q, k, v, bias)
    assert _within(got[0], want[0], 1e-5, 1e-4)
    assert _within(got[1], want[1], 1e-4, 1e-5)
    assert _within(got[2], want[2], 1e-4, 1e-5)


@pytest.mark.cuda
def test_f32_kernel_loaders_agree_bit_for_bit(cuda):
    # The same values through the 16-byte and the 4-byte copies: only the
    # loader differs, so the outputs are identical.
    q, k, v = _f32_operands("aligned", cuda)
    shifted = [torch.empty(t.numel() + 1, device=cuda)[1:].view(t.shape) for t in (q, k, v)]
    for dst, src in zip(shifted, (q, k, v)):
        dst.copy_(src)
    bias = _bias("band", q.shape[1], k.shape[1], cuda)
    for a, b in zip(fb.block_attention(q, k, v, bias), fb.block_attention(*shifted, bias)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_f32_kernel_holds_large_logits(cuda):
    # |q.k| about 1e3: single-pass TF32 (10 mantissa bits) would miss the
    # f32 tolerance here by far (tests/test_torch_f32_split.py); the 3xTF32
    # split holds it.
    q, k, v = _f32_operands("aligned", cuda, q_scale=125.0)
    assert 300 < torch.einsum("bqhd,bkhd->bhqk", q, k).std().item() < 3000
    bias = _bias("triangle", q.shape[1], k.shape[1], cuda)
    got = fb.block_attention(q, k, v, bias)
    want = fb.block_attention_reference(q, k, v, bias)
    assert _within(got[0], want[0], 1e-5, 1e-4)
    assert _within(got[1], want[1], 1e-4, 1e-5)
    assert _within(got[2], want[2], 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dim,tq,tk", [(8, 33, 65), (64, 130, 200), (128, 130, 200)])
def test_tensor_core_kernel_pads_head_dim_and_ragged_edges(cuda, dim, tq, tk):
    gen = torch.Generator(device=cuda).manual_seed(8)
    q, k, v = (torch.randn((2, t, 2, dim), generator=gen, device=cuda).bfloat16()
               for t in (tq, tk, tk))
    bias = _bias("triangle", tq, tk, cuda)
    got = fb.block_attention(q, k, v, bias)
    want = fb.block_attention_reference(q, k, v, bias)
    assert _within(got[0], want[0], 1e-5, 1e-4)
    assert _within(got[1], want[1], 2e-2, 1e-5)
    assert _within(got[2], want[2], 2e-2, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(512, 512), (65, 63), (130, 200), (1, 1)])
@pytest.mark.parametrize("bias_kind", BIAS_KINDS)
def test_tile_class_kernel_matches_plain_version(cuda, bias_kind, shape):
    bias = _bias(bias_kind, *shape, cuda)
    before = fb.TILE_CLASS_LAUNCHES
    got = fb.tile_classes(bias)
    assert fb.TILE_CLASS_LAUNCHES == before + 1
    assert torch.equal(got, fb.tile_classes_reference(bias))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("bias_kind", BIAS_KINDS)
def test_pdl_call_equals_the_given_classes_call(cuda, dtype, bias_kind):
    # The call without classes launches the pass and then the kernel under
    # programmatic dependent launch; q and the bias are written by the
    # kernels just ahead of it on the stream.
    gen = torch.Generator(device=cuda).manual_seed(11)
    q_src = torch.randn((2, 200, 4, 64), generator=gen, device=cuda)
    k_c, v_c = (torch.randn((2, 200, 2, 64), generator=gen, device=cuda).to(dtype)
                for _ in range(2))
    k, v = fb._repeat_heads(k_c, 2), fb._repeat_heads(v_c, 2)
    q = (q_src * 2.0).to(dtype)
    bias = _bias(bias_kind, 200, 200, cuda)
    before = fb.TILE_CLASS_LAUNCHES
    pdl = fb.block_attention(q, k, v, bias)
    assert fb.TILE_CLASS_LAUNCHES == before + 1
    given = fb.block_attention(q, k, v, bias, classes=fb.tile_classes_reference(bias))
    assert fb.TILE_CLASS_LAUNCHES == before + 1
    torch.cuda.synchronize()
    for a, b in zip(pdl, given):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_constant_mask_on_card(cuda):
    fb.constant_mask.cache_clear()
    device = torch.ones(1, device=cuda).device  # as a tensor's .device names it
    before = fb.TILE_CLASS_LAUNCHES
    bias, classes = fb.constant_mask("causal", 512, 512, device)
    again = fb.constant_mask("causal", 512, 512, device)
    assert fb.TILE_CLASS_LAUNCHES == before + 1
    assert again[0] is bias and again[1] is classes and bias.is_cuda and classes.is_cuda
    on_cpu = fb.constant_mask("causal", 512, 512, torch.device("cpu"))
    assert on_cpu[0] is not bias and on_cpu[0].device.type == "cpu"
    assert torch.equal(bias.cpu(), on_cpu[0]) and torch.equal(classes.cpu(), on_cpu[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_ring_block_on_card_is_skipped(cuda, dtype):
    """The ring's fully masked block: its classes all MASKED from the pass
    kernel; the block kernel skips every tile (max ~NEG_INF, sum and
    weighted 0), so merged into an accumulator it changes nothing."""
    fb.constant_mask.cache_clear()
    device = torch.ones(1, device=cuda).device
    bias, classes = fb.constant_mask("masked", 512, 512, device)
    assert bool((classes == fb.MASKED).all())
    gen = torch.Generator(device=device).manual_seed(0)
    q, k, v, k0, v0 = (torch.randn((2, 512, 4, 64), generator=gen, device=device).to(dtype)
                       for _ in range(5))
    blk = fb.block_attention(q, k, v, bias, classes=classes)
    assert bool((blk[1] == 0).all() and (blk[2] == 0).all() and (blk[0] <= fb.NEG_INF / 2).all())
    diag, diag_classes = fb.constant_mask("causal", 512, 512, device)
    acc = fb.block_attention(q, k0, v0, diag, classes=diag_classes)
    merged = fb.merge_block_stats(acc, blk)
    assert torch.equal(fb.normalize_block_stats(merged[1], merged[2]),
                       fb.normalize_block_stats(acc[1], acc[2]))


@pytest.mark.cuda
def test_second_generate_at_one_shape_launches_no_class_pass(cuda):
    cfg = transformer.TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                                        d_ff=128, n_layers=2, dtype=torch.bfloat16)
    params = tree.tree_map(lambda t: t.to(cuda),
                           transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    prompt = torch.randint(0, 128, (2, 600), generator=torch.Generator().manual_seed(1))
    generate = decode.build_generate(cfg, 2)
    fb.constant_mask.cache_clear()
    counts = []
    for _ in range(2):
        before = fb.TILE_CLASS_LAUNCHES, fb.KERNEL_LAUNCHES
        generate(params, prompt)
        counts.append((fb.TILE_CLASS_LAUNCHES - before[0], fb.KERNEL_LAUNCHES - before[1]))
    # Chunks of 512 and 88: triangles of both sizes and the [88, 512] zero
    # bias, classified in the first run only; 3 block launches a layer.
    assert counts == [(3, 3 * cfg.n_layers), (0, 3 * cfg.n_layers)]


@pytest.mark.cuda
def test_generate_on_card_matches_cpu_at_f32(cuda):
    cfg = transformer.TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                                        d_ff=128, n_layers=2, dtype=torch.float32)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    want = decode.build_generate(cfg, 6, "cpu")(params, prompt)
    on_card = {k: ({n: a.to(cuda) for n, a in v.items()} if isinstance(v, dict) else v.to(cuda))
               for k, v in params.items()}
    before = fb.KERNEL_LAUNCHES
    got = decode.build_generate(cfg, 6)(on_card, prompt)
    assert fb.KERNEL_LAUNCHES - before == cfg.n_layers  # one chunk at T=40
    assert torch.equal(got.cpu(), want)

    logits = transformer.build_forward(cfg)(on_card, prompt)
    want_logits = transformer.build_forward(cfg, "cpu")(params, prompt)
    assert _within(logits.cpu(), want_logits, 1e-4, 1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_block_backward_on_card_matches_cpu(cuda, dtype):
    # The card's forward and backward are the kernels; the CPU's the plain
    # versions. bf16: 2e-2 relative to the tensor's largest value.
    gen = torch.Generator().manual_seed(9)
    q = torch.randn((2, 96, 4, 32), generator=gen).to(dtype)
    k_c, v_c = (torch.randn((2, 96, 2, 32), generator=gen).to(dtype) for _ in range(2))
    bias = _bias("triangle", 96, 96, "cpu")
    cot = [torch.randn(s, generator=gen) for s in ((2, 4, 96), (2, 4, 96), (2, 96, 4, 32))]

    def grads(device):
        xs = [t.to(device).requires_grad_() for t in (q, k_c, v_c, bias)]
        outs = fb.block_attention(xs[0], fb._repeat_heads(xs[1], 2), fb._repeat_heads(xs[2], 2),
                                  xs[3])
        return torch.autograd.grad(outs, xs, grad_outputs=[c.to(device) for c in cot])

    before, before_bwd = fb.KERNEL_LAUNCHES, fb.BACKWARD_LAUNCHES
    got = grads(cuda)
    assert fb.KERNEL_LAUNCHES == before + 1 and fb.BACKWARD_LAUNCHES == before_bwd + 1
    rtol = 2e-2 if dtype == torch.bfloat16 else 1e-4
    for g, w in zip(got, grads("cpu")):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert _within(g.cpu(), w, rtol, 1e-5)


# The backward kernel's cases (chip_smoke.py's phase 3 runs the same kinds):
# (Tq, Tk, H, H_kv, D, bias kind, fused QKV views). "band_row" is the band
# with row 3 masked whole.
BACKWARD_CASES = {
    "mha_triangle": (256, 256, 4, 4, 64, "triangle", False),
    "gqa_zero": (256, 256, 8, 2, 64, "zero", False),
    "fused_gqa_triangle": (192, 192, 8, 2, 64, "triangle", True),
    "ragged_band_row_d32": (100, 77, 4, 2, 32, "band_row", False),
    "ragged_alibi_d32": (100, 77, 4, 4, 32, "alibi", False),
    "d128_triangle": (130, 200, 4, 4, 128, "triangle", False),
    "d128_reverse_triangle": (130, 200, 4, 4, 128, "reverse_triangle", False),
    "d128_gqa_ragged_band": (130, 200, 8, 2, 128, "band", False),
    "all_masked": (200, 200, 4, 4, 64, "all_masked", False),
}


def _backward_operands(case, dtype, device, seed=0):
    """(q, k, v, bias, block_max, classes, dsum, dweighted) on the card: k
    and v GQA expand views (or views of one fused QKV buffer), block_max the
    forward kernel's."""
    tq, tk, heads, kv_heads, dim, kind, fused = BACKWARD_CASES[case]
    gen = torch.Generator(device=device).manual_seed(seed)
    if fused:
        qkv = torch.randn((2, tq, (heads + 2 * kv_heads) * dim), generator=gen,
                          device=device).to(dtype)
        q, k_c, v_c = torch.split(qkv, [heads * dim, kv_heads * dim, kv_heads * dim], dim=-1)
        q = q.reshape(2, tq, heads, dim)
        k_c, v_c = (t.reshape(2, tk, kv_heads, dim) for t in (k_c, v_c))
    else:
        q = torch.randn((2, tq, heads, dim), generator=gen, device=device).to(dtype)
        k_c, v_c = (torch.randn((2, tk, kv_heads, dim), generator=gen, device=device).to(dtype)
                    for _ in range(2))
    k, v = (fb._repeat_heads(t, heads // kv_heads) for t in (k_c, v_c))
    bias = _bias("band" if kind == "band_row" else kind, tq, tk, device)
    if kind == "band_row":
        bias[3] = fb.NEG_INF
    classes = fb.tile_classes(bias)
    block_max = fb._block_attention_cuda(q, k, v, bias, classes)[0]
    dsum = torch.randn((2, heads, tq), generator=gen, device=device)
    dw = torch.randn((2, tq, heads, dim), generator=gen, device=device)
    return q, k, v, bias, block_max, classes, dsum, dw


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", list(BACKWARD_CASES))
def test_backward_kernel_matches_plain_version(cuda, dtype, case):
    # The forward's tolerances: bf16 2e-2 of the largest value (P and dS are
    # rounded to bf16 from exponentials that differ in the last bits), f32
    # 1e-4 (3xTF32 against true f32 in another order).
    q, k, v, bias, block_max, classes, dsum, dw = _backward_operands(case, dtype, cuda)
    needs = (True, True, True, True)
    before = fb.BACKWARD_LAUNCHES, fb.BACKWARD_F32_LAUNCHES
    got = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw, needs)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert (fb.BACKWARD_LAUNCHES, fb.BACKWARD_F32_LAUNCHES) == (before[0] + 1, before[1] + f32)
    want = fb.block_attention_bwd_reference(q, k, v, bias, block_max, dsum, dw, needs)
    rtol = 1e-4 if f32 else 2e-2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        assert _within(g, w, rtol, 1e-5)
    if BACKWARD_CASES[case][5] == "band_row":  # the fully masked row
        assert torch.all(got[0][:, 3] == 0) and torch.all(got[3][3] == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("needs", [(True, True, True, False), (True, False, False, False),
                                   (False, True, True, False), (False, False, False, True)],
                         ids=["qkv", "q", "kv", "bias"])
def test_backward_kernel_is_deterministic_and_computes_what_is_needed(cuda, dtype, needs):
    # No atomics in dq, dk or dv: two calls give the same bits. dbias is
    # summed over (batch, head) by atomics: within the tolerance.
    args = _backward_operands("fused_gqa_triangle", dtype, cuda, seed=1)
    first = fb._block_attention_bwd_cuda(*args, needs)
    second = fb._block_attention_bwd_cuda(*args, needs)
    every = fb._block_attention_bwd_cuda(*args, (True,) * 4)
    for need, a, b, c in zip(needs[:3], first, second, every):
        assert (a is None) != need
        if need:
            assert torch.equal(a, b) and torch.equal(a, c)
    if needs[3]:
        assert _within(first[3], every[3], 1e-5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_backward_kernel_writes_zeros_where_no_tile_is_live(cuda, dtype):
    # Every block writes its whole tile: an all-masked block's gradients are
    # zeros, not what torch.empty left, and so are a masked row's dq and
    # dbias and the dk and dv rows no q row sees.
    q, k, v, bias, block_max, classes, dsum, dw = _backward_operands("all_masked", dtype, cuda)
    for _ in range(2):  # the second call's outputs reuse the first's freed memory
        got = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw,
                                           (True,) * 4)
        assert all(torch.all(g == 0) for g in got)
        del got
    bias = _bias("zero", 200, 200, cuda)
    bias[:, 128:] = fb.NEG_INF  # kv tiles 2 and 3 masked in every q tile
    classes = fb.tile_classes(bias)
    block_max = fb._block_attention_cuda(q, k, v, bias, classes)[0]
    dq, dk, dv, _ = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw,
                                                 (True, True, True, False))
    assert torch.all(dk[:, 128:] == 0) and torch.all(dv[:, 128:] == 0)
    assert torch.all(dk[:, :128].abs().sum(dim=-1) > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("tq,tk,heads,kv_heads,dim,kind,d_stride", [
    (100, 77, 4, 2, 8, "band_row", 1),
    (70, 130, 8, 4, 16, "alibi", 1),
    (130, 70, 4, 4, 36, "triangle", 1),
    (129, 129, 4, 1, 64, "reverse_triangle", 1),
    (100, 77, 4, 2, 64, "triangle", 2),
], ids=["d8_band_row", "d16_alibi", "d36_triangle", "d64_reverse_triangle", "d64_strided"])
def test_f32_backward_runs_on_tma_where_it_takes_the_views(cuda, tq, tk, heads, kv_heads, dim,
                                                          kind, d_stride):
    # Small ragged shapes against the plain version at the f32 tolerance, on
    # the variant the wrapper picks: tf32 wgmma fed by TMA for every view TMA
    # takes, mma.sync for views with stride 2 on D.
    gen = torch.Generator(device=cuda).manual_seed(dim)
    q = torch.randn((2, tq, heads, dim * d_stride), generator=gen, device=cuda)[..., ::d_stride]
    k_c, v_c = (torch.randn((2, tk, kv_heads, dim * d_stride), generator=gen,
                            device=cuda)[..., ::d_stride] for _ in range(2))
    k, v = (fb._repeat_heads(t, heads // kv_heads) for t in (k_c, v_c))
    bias = _bias("band" if kind == "band_row" else kind, tq, tk, cuda)
    if kind == "band_row":
        bias[3] = fb.NEG_INF
    classes = fb.tile_classes(bias)
    block_max = fb._block_attention_cuda(q, k, v, bias, classes)[0]
    dsum = torch.randn((2, heads, tq), generator=gen, device=cuda)
    dw = torch.randn((2, tq, heads, dim), generator=gen, device=cuda)
    needs = (True, True, True, True)
    before = fb.BACKWARD_F32_LAUNCHES, fb.BACKWARD_F32_MMA_LAUNCHES
    got = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw, needs)
    torch.cuda.synchronize()
    assert (fb.BACKWARD_F32_LAUNCHES, fb.BACKWARD_F32_MMA_LAUNCHES) == (
        before[0] + 1, before[1] + (d_stride > 1))
    want = fb.block_attention_bwd_reference(q, k, v, bias, block_max, dsum, dw, needs)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape and torch.isfinite(g).all()
        assert _within(g, w, 1e-4, 1e-5)
    again = fb._block_attention_bwd_cuda(q, k, v, bias, block_max, classes, dsum, dw, needs)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], again[:3]))


@pytest.mark.cuda
def test_flagship_train_step_with_and_without_the_backward_kernel(cuda, monkeypatch):
    # The flagship's 8 layers at B=8, T=1024 in bf16: the step with the
    # backward kernel against the same step with the plain backward (the
    # forward kernel in both), chip_smoke.py's train-step bounds: loss within
    # 1e-2 relative, each gradient leaf within 5e-2 in relative norm.
    from jobset_tpu_torch.runtime.model_bench import flagship_config

    cfg = flagship_config(n_layers=8)
    params = transformer.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    tokens = torch.randint(0, cfg.vocab_size, (8, 1025),
                           generator=torch.Generator(device=cuda).manual_seed(3), device=cuda)
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    opt = optim.sgd(1.0)

    def step():
        new, _, loss = transformer.build_train_step(cfg, opt)(params, opt.init(params), batch)
        return float(loss), [p - n for p, n in zip(tree.leaves(params), tree.leaves(new))]

    before = fb.BACKWARD_LAUNCHES
    loss, grads = step()
    assert fb.BACKWARD_LAUNCHES - before == cfg.n_layers

    def plain(q, k, v, bias, block_max, classes, dsum, dw, needs):
        return fb.block_attention_bwd_reference(q, k, v, bias, block_max, dsum, dw, needs)

    monkeypatch.setattr(fb, "_block_attention_bwd_cuda", plain)
    ref_loss, ref_grads = step()
    assert abs(loss - ref_loss) <= 1e-2 * abs(ref_loss)
    for g, w in zip(grads, ref_grads):
        assert ((g.float() - w.float()).norm() / w.float().norm()).item() <= 5e-2


def _small_config(**kw):
    return transformer.TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                                         d_ff=128, n_layers=2, dtype=torch.float32, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("remat, launches", [("off", 2), ("full", 4), ("dots", 2)])
def test_train_step_launches_and_matches_cpu(cuda, remat, launches):
    cfg = _small_config(remat=remat != "off", remat_policy="full" if remat == "off" else remat)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, 128, (4, 65), generator=torch.Generator().manual_seed(1))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    opt = optim.sgd(1.0)

    def step(device, p):
        return transformer.build_train_step(cfg, opt, device=device)(p, opt.init(p), batch)

    before = fb.KERNEL_LAUNCHES
    got, _, loss = step(None, tree.tree_map(lambda t: t.to(cuda), params))
    assert fb.KERNEL_LAUNCHES - before == launches
    want, _, want_loss = step("cpu", params)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for g, w, p in zip(tree.leaves(got), tree.leaves(want), tree.leaves(params)):
        assert _within((p - g.cpu()), (p - w), 1e-3, 1e-7)

    before = fb.KERNEL_LAUNCHES
    transformer.build_eval_step(replace(cfg, remat=True))(
        tree.tree_map(lambda t: t.to(cuda), params), batch)
    assert fb.KERNEL_LAUNCHES - before == cfg.n_layers


def _same_solve(got, want):
    """Kernel and plain version: identical assignments and iterations,
    prices bit for bit."""
    assert torch.equal(got[0].cpu(), want[0].cpu())
    assert torch.equal(got[2].cpu(), want[2].cpu())
    assert torch.equal(got[1].cpu().view(torch.int32), want[1].cpu().view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("jobs,domains,seed", [(4, 4, 0), (32, 64, 3), (64, 100, 4), (5, 2, 6),
                                               (1, 7, 5), (512, 960, 17)])
def test_auction_kernel_matches_plain_version(cuda, jobs, domains, seed):
    rng = np.random.default_rng(seed)
    costs = rng.integers(0, 256, size=(1, jobs, domains)).astype(np.float32)
    feasible = rng.random(costs.shape) > 0.1
    benefit = S._dense_benefit(costs, feasible, S._round_up_pow2(jobs),
                               S._round_up_pow2(domains), cuda)
    before = (auction_ops.AUCTION_LAUNCHES, auction_ops.DENSE_LAUNCHES)
    got = auction_ops.dense(benefit)
    assert (auction_ops.AUCTION_LAUNCHES, auction_ops.DENSE_LAUNCHES) == (before[0] + 1,
                                                                          before[1] + 1)
    _same_solve(got, S._auction_plain(benefit))


def _structured(seed, jobs, domains):
    rng = np.random.default_rng(seed)
    own = np.full(jobs, -1, np.int32)
    occupied = rng.random(domains) < 0.15
    owned = np.flatnonzero(occupied)[: jobs // 4]
    own[: len(owned)] = owned
    return dict(load=rng.random(domains).astype(np.float32),
                free=rng.integers(0, 24, domains).astype(np.float32),
                pods_needed=rng.integers(1, 12, jobs).astype(np.float32),
                sticky=np.where(rng.random(jobs) < 0.3, rng.integers(0, domains, jobs),
                                -1).astype(np.int32),
                occupied=occupied, own_domain=own)


@pytest.mark.cuda
@pytest.mark.parametrize("jobs,domains", [(5, 12), (48, 96), (512, 960), (40, 6250)])
def test_structured_auction_kernel_matches_plain_version(cuda, jobs, domains):
    problems = [_structured(seed, jobs, domains) for seed in range(3)]
    stacked = S._stack_structured(problems, S._round_up_pow2(jobs), S._round_up_pow2(domains))
    ops = [torch.from_numpy(a).to(cuda) for a in stacked.values()]
    before = auction_ops.STRUCTURED_BATCH_LAUNCHES
    got = auction_ops.structured(*ops, batched=True)
    assert auction_ops.STRUCTURED_BATCH_LAUNCHES == before + 1
    _same_solve(got, S._auction_plain(S._structured_benefit(*ops)))
    for b in range(len(problems)):  # each member equals its single solve
        single = auction_ops.structured(*(t[b:b + 1] for t in ops))
        assert torch.equal(single[0][0], got[0][b]) and torch.equal(single[2][0], got[2][b])


def _gradient(seed, jobs, domains):
    """chip_smoke.py's structured surface: a load gradient over the
    domains, a quarter of the jobs sticky, some owning their domain, and
    domains owned by other JobSets."""
    rng = np.random.default_rng(seed)
    taken = np.round(16 * 0.9 * np.arange(domains) / max(domains - 1, 1))
    free = (16 * (16 - taken)).astype(np.float32)
    picks = rng.choice(domains, size=jobs // 4 + jobs // 8, replace=False).astype(np.int32)
    movers = rng.choice(jobs, size=jobs // 4, replace=False)
    sticky = np.full(jobs, -1, np.int32)
    sticky[movers] = picks[: jobs // 4]
    own = np.full(jobs, -1, np.int32)
    own[movers[: jobs // 16]] = picks[: jobs // 16]
    occupied = np.zeros(domains, bool)
    occupied[picks[: jobs // 16]] = True
    occupied[picks[jobs // 4:]] = True
    return dict(load=(1.0 - free / 256).astype(np.float32), free=free,
                pods_needed=np.full(jobs, 4, np.float32), sticky=sticky, occupied=occupied,
                own_domain=own)


def _check_stats(stats, iterations):
    """The per-problem counters: every column present, every bid either a
    full scan or answered by the candidates, the hit rate in [0, 1]."""
    s = {name: stats[:, i].cpu() for i, name in enumerate(auction_ops.STATS)}
    assert stats.shape[1] == len(auction_ops.STATS)
    assert torch.equal(s["full_scan_rows"] + s["cached_bids"], s["bid_rows"])
    hit_rate = s["cached_bids"].sum().item() / max(s["bid_rows"].sum().item(), 1)
    assert 0.0 <= hit_rate <= 1.0
    assert bool((s["cycles_total"] > 0).all()) and bool((s["phases"] >= 1).all())
    assert bool((s["bid_rows"] >= iterations.cpu().long()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("batch,jobs,domains", [(1, 512, 8192), (8, 128, 240)],
                         ids=["512x8192, shared-memory budget", "storm of 8"])
def test_structured_auction_kernel_on_gradient_surfaces(cuda, batch, jobs, domains):
    problems = [_gradient(seed, jobs, domains) for seed in range(batch)]
    stacked = S._stack_structured(problems, S._round_up_pow2(jobs), S._round_up_pow2(domains))
    ops = [torch.from_numpy(a).to(cuda) for a in stacked.values()]
    before = (auction_ops.AUCTION_LAUNCHES, auction_ops.STRUCTURED_BATCH_LAUNCHES)
    got = auction_ops.structured(*ops, batched=True)
    assert (auction_ops.AUCTION_LAUNCHES, auction_ops.STRUCTURED_BATCH_LAUNCHES) == (
        before[0] + 1, before[1] + 1)
    _same_solve(got, S._auction_plain(S._structured_benefit(*ops)))
    _check_stats(got[3], got[2])


def _contended_dead_columns():
    """chip_smoke.py's edge case: 64 jobs alike over 96 domains on a
    gradient, the last 32 domains dead."""
    cost = np.round((1.0 + np.linspace(0, 0.9, 96)[None, :].repeat(64, 0)) * 64)
    feasible = np.ones((64, 96), bool)
    feasible[:, 64:] = False
    return cost[None].astype(np.float32), feasible[None]


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["contended dead columns 64x96", "ties 64x128 costs 0..3",
                                  "ties 512x1024 costs 0..7", "ties batch 4x256x512 costs 0..1"])
def test_dense_auction_kernel_on_contended_and_tied_problems(cuda, case):
    if case.startswith("contended"):
        costs, feasible = _contended_dead_columns()
    else:
        shape, top = {"ties 64x128 costs 0..3": ((1, 64, 128), 4),
                      "ties 512x1024 costs 0..7": ((1, 512, 1024), 8),
                      "ties batch 4x256x512 costs 0..1": ((4, 256, 512), 2)}[case]
        costs = np.random.default_rng(shape[1]).integers(0, top, size=shape).astype(np.float32)
        feasible = np.ones(shape, bool)
    benefit = S._dense_benefit(costs, feasible, S._round_up_pow2(costs.shape[1]),
                               S._round_up_pow2(costs.shape[2]), cuda)
    batched = costs.shape[0] > 1
    counter = "DENSE_BATCH_LAUNCHES" if batched else "DENSE_LAUNCHES"
    before = (auction_ops.AUCTION_LAUNCHES, getattr(auction_ops, counter))
    got = auction_ops.dense(benefit, batched=batched)
    assert (auction_ops.AUCTION_LAUNCHES, getattr(auction_ops, counter)) == (before[0] + 1,
                                                                             before[1] + 1)
    _same_solve(got, S._auction_plain(benefit))
    _check_stats(got[3], got[2])


@pytest.mark.cuda
def test_solver_surface_on_card_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    cost = rng.integers(0, 64, size=(24, 40)).astype(np.float32)
    costs = rng.integers(0, 40, size=(3, 8, 12)).astype(np.float32)
    problem = _structured(7, 30, 50)
    card = S.AssignmentSolver(backend="default")
    host = S.AssignmentSolver(backend="default", device="cpu")
    pending = card.solve_async(cost)
    np.testing.assert_array_equal(pending.result(), host.solve(cost))
    assert pending.is_ready() and pending.iterations == host.last_iterations
    np.testing.assert_array_equal(card.solve_structured_async(**problem).result(),
                                  host.solve_structured_async(**problem).result())
    np.testing.assert_array_equal(card.solve_batch(costs), host.solve_batch(costs))
    storm = [_structured(s, 20, 30) for s in range(4)]
    for got, want in zip(card.solve_structured_batch_async(storm),
                         host.solve_structured_batch_async(storm)):
        np.testing.assert_array_equal(got.result(), want.result())
        assert got.iterations == want.iterations
    assert card.routes == {"cuda": 4, "cpu": 0}


@pytest.mark.cuda
def test_auction_launcher_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError, match="power of two"):
        auction_ops.dense(torch.zeros((1, 8, 12), device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        auction_ops.dense(torch.zeros((1, 8, 16384), device=cuda))
    with pytest.raises(ValueError, match="expected contiguous"):
        auction_ops.dense(torch.zeros((1, 16, 8), device=cuda).transpose(1, 2))


# ---------------------------------------------------------------------------
# The control plane's device programs (torch code, no hand kernel): each on
# the card against the port's CPU path and plain versions.
# ---------------------------------------------------------------------------


def _tenths_snapshot(seed, Q, R, P, C):
    from jobset_tpu_torch.queue import scorer as QS

    rng = np.random.default_rng(seed)
    declared = rng.random((Q, R)) > 0.2
    return QS.Snapshot(
        [f"r{i}" for i in range(R)], [f"q{i}" for i in range(Q)],
        (rng.integers(0, 640, (Q, R)) * 0.1 * declared).astype(np.float32), declared,
        (rng.integers(0, 320, (Q, R)) * 0.1).astype(np.float32),
        rng.integers(1, 5, Q).astype(np.float32), rng.integers(-1, C, Q).astype(np.int32), C,
        (rng.integers(0, 160, (P, R)) * 0.1).astype(np.float32),
        rng.integers(0, Q, P).astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("Q,R,P,C", [(64, 1, 512, 8), (37, 3, 100, 5), (130, 8, 700, 12)])
def test_queue_scorer_on_card_matches_greedy_bit_for_bit(cuda, Q, R, P, C):
    from jobset_tpu_torch.queue import scorer as QS

    QS._P_HIGH_WATER.clear()
    snap = _tenths_snapshot(Q + R, Q, R, P, C)
    got, want = QS.score(snap), QS._score_greedy(snap)
    assert got.backend == "torch"
    for field in ("feasible", "queue_share", "candidate_share"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8)), field


@pytest.mark.cuda
@pytest.mark.parametrize("pods,jobs", [(1024, 1024), (16384, 1024), (1 << 18, 1 << 14)])
def test_job_counts_on_card_equal_bincount(cuda, pods, jobs):
    from jobset_tpu_torch.core import columnar as CC

    rng = np.random.default_rng(pods)
    job = rng.integers(-1, jobs + 3, pods).astype(np.int32)  # dead rows and past-capacity rows
    phase = rng.integers(0, 4, pods).astype(np.int32)
    ready = (rng.random(pods) < 0.5).astype(np.int8)
    for got, want in zip(CC.job_counts(job, phase, ready, jobs),
                         CC.job_counts_reference(job, phase, ready, jobs)):
        assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [1, 9, 960])
def test_policy_score_on_card_matches_cpu(cuda, rows):
    """Tolerance 1e-6 of the largest magnitude (f32 through three layers,
    sums in another order), with TF32 matmuls allowed in the process or
    not: the scorer's products are no matmuls, so the bits are the same."""
    from jobset_tpu_torch.policy import model as PM

    rng = np.random.default_rng(rows)
    model = PM.PolicyModel(PM.init_params(1), rng.random(16).astype(np.float32),
                           (0.5 + rng.random(16)).astype(np.float32), 20.0, 5.0)
    feats = rng.random((rows, 16)).astype(np.float32)
    got = PM.score(model, feats)
    want = PM.score(model, feats, device="cpu")
    assert np.abs(got - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0)
    assert np.abs(got - PM.score(model, feats, backend="numpy")).max() <= \
        1e-6 * max(np.abs(want).max(), 1.0)
    torch.backends.cuda.matmul.allow_tf32 = True  # the fixture restores it
    assert np.array_equal(PM.score(model, feats), got)


@pytest.mark.cuda
def test_policy_train_on_card_is_byte_deterministic_and_matches_cpu(cuda, tmp_path):
    """Two card runs of one seed write identical checkpoint bytes; against
    the CPU path, losses within 1e-5 relative and parameters within 1e-4
    of each tensor's largest magnitude."""
    from jobset_tpu_torch.device import backend_label
    from jobset_tpu_torch.policy import dataset as PD
    from jobset_tpu_torch.policy import features as PF
    from jobset_tpu_torch.policy import model as PM
    from jobset_tpu_torch.policy import train as PT

    rng = np.random.default_rng(0)
    x = (rng.random((300, 16)) * 3).astype(np.float32)
    y = ((x[:, 0] * 5 + x[:, 3] ** 2 + rng.random(300)) * 10).astype(np.float32)
    corpus = PD.Dataset(x, y, PF.DomainHistory(), {"synthetic": 300})
    blobs, summaries, models = [], [], []
    for i, device in enumerate(("cuda", "cuda", "cpu")):
        model, summary = PT.train(corpus, seed=3, epochs=60, device=device)
        PM.save_checkpoint(str(tmp_path / f"{i}.npz"), model)
        blobs.append((tmp_path / f"{i}.npz").read_bytes())
        summaries.append(summary)
        models.append(model)
    assert blobs[0] == blobs[1]
    for key in ("lossFirst", "lossFinal"):
        assert abs(summaries[0][key] - summaries[2][key]) <= 1e-5 * abs(summaries[2][key])
    for (wa, ba), (wc, bc) in zip(models[0].params, models[2].params):
        for a, c in ((wa, wc), (ba, bc)):
            assert np.abs(a - c).max() <= 1e-4 * np.abs(c).max()
    assert backend_label() == "cuda"


def _int8_within(got, want, dtype):
    """The int8 kernel's tolerance (module docstring), per element."""
    got, want = got.float(), want.float()
    peak = want.abs().max().item()
    if dtype == torch.bfloat16:
        limit = 2.0 ** -7 * want.abs() + 1e-4 * peak
    else:
        limit = torch.full_like(want, 1e-5 * peak)
    return bool(((got - want).abs() <= limit).all())


def _int8_operands(rows, k, n, dtype, device, seed=0, lead=()):
    gen = torch.Generator().manual_seed(seed)
    qt = quant.quantize_int8(torch.randn(k, n, generator=gen) / k ** 0.5)
    x = torch.randn(*lead, rows, k, generator=gen).to(dtype)
    return x.to(device), qt.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows,k,n", [(8, 1024, 1024), (8, 1024, 4096), (8, 4096, 1024),
                                      (8, 1024, 32000), (1, 1024, 1024), (16, 1024, 1024),
                                      (5, 1000, 1000), (3, 70, 24), (16, 300, 17), (2, 8, 8)])
def test_int8_kernel_matches_plain_version(cuda, dtype, rows, k, n):
    x, qt = _int8_operands(rows, k, n, dtype, cuda, seed=rows + k + n)
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul(x, qt, dtype)
    again = i8.int8_matmul(x, qt, dtype)
    torch.cuda.synchronize()
    assert i8.INT8_LAUNCHES == before + 2
    assert got.dtype == dtype and got.shape == (rows, n)
    assert torch.equal(got, again)  # a fixed order of sums: the same bits
    want = i8.int8_matmul_plain(x, qt, dtype)
    assert _int8_within(got, want, dtype)


@pytest.mark.cuda
def test_int8_kernel_takes_batched_rows_and_layer_slices(cuda):
    # x [B, 1, K] as the decode step gives it; q and scale as layer views of
    # a stacked [1, L, K, N] weight.
    gen = torch.Generator().manual_seed(5)
    stacked = quant.quantize_int8(torch.randn(1, 3, 256, 96, generator=gen) * 0.1).to(cuda)
    x = torch.randn(8, 1, 256, generator=gen).to(cuda, torch.bfloat16)
    layer = stacked[0, 2]
    got = quant.matmul(x, layer, torch.bfloat16)
    assert got.shape == (8, 1, 96)
    assert _int8_within(got, i8.int8_matmul_plain(x, layer, torch.bfloat16), torch.bfloat16)


@pytest.mark.cuda
def test_int8_matmul_above_the_cut_is_a_gemm(cuda):
    x, qt = _int8_operands(i8.ROW_CUT + 1, 64, 32, torch.float32, cuda)
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul(x, qt, torch.float32)
    assert i8.INT8_LAUNCHES == before
    assert torch.equal(got, i8.int8_matmul_plain(x, qt, torch.float32))


@pytest.mark.cuda
def test_int8_kernel_rejects_what_it_does_not_take(cuda):
    x, qt = _int8_operands(4, 64, 32, torch.float32, cuda)
    for bad_x, bad_qt, dtype in ((x, quant.QuantizedTensor(qt.q.float(), qt.scale),
                                  torch.float32),
                                 (x[:, :63], qt, torch.float32),
                                 (x, qt, torch.float16),
                                 (x, qt.to("cpu"), torch.float32)):
        with pytest.raises(ValueError, match="the kernel takes"):
            i8.int8_matmul(bad_x, bad_qt, dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("widths", [(1024, 1024, 1024), (1024, 256, 256), (1024, 17, 64)],
                         ids=["mha", "gqa", "unaligned"])
@pytest.mark.parametrize("rows", range(1, i8.ROW_CUT + 1))
def test_int8_group_is_one_launch_equal_to_separate_launches(cuda, dtype, widths, rows):
    gen = torch.Generator().manual_seed(rows + sum(widths))
    qts = [quant.quantize_int8(torch.randn(1024, n, generator=gen) / 32.0).to(cuda)
           for n in widths]
    x = torch.randn(rows, 1024, generator=gen).to(cuda, dtype)
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul_group(x, qts, dtype)
    assert i8.INT8_LAUNCHES == before + 1
    apart = [i8.int8_matmul(x, qt, dtype) for qt in qts]
    torch.cuda.synchronize()
    # The yardstick's bf16 matmuls sum in f32 throughout, as on the CPU
    # (cuBLAS may otherwise add split-K partial sums in bf16).
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        wants = i8.int8_matmul_group_plain(x, qts, dtype)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag
    for y, y_apart, want, n in zip(got, apart, wants, widths):
        assert y.dtype == dtype and y.shape == (rows, n)
        assert torch.equal(y, y_apart)  # the sum order depends on K alone
        assert _int8_within(y, want, dtype)


@pytest.mark.cuda
def test_int8_kernel_reports_the_wrappers_layout(cuda):
    assert i8.kernel_layout() == i8.layout()


def _quantized_small(cuda, dtype=torch.float32):
    cfg = _small_config()
    cfg = replace(cfg, dtype=dtype)
    params = quant.quantize_params_for_serving(
        transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    return cfg, params, tree.tree_map(lambda t: t.to(cuda), params)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,quantized_kv", [(True, False), (False, True), (True, True)],
                         ids=["int8", "int8_kv", "int8_both"])
def test_int8_generate_on_card_matches_cpu_at_f32(cuda, quantized, quantized_kv):
    cfg, qparams, qcard = _quantized_small(cuda)
    plain = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    params, on_card = ((qparams, qcard) if quantized
                       else (plain, tree.tree_map(lambda t: t.to(cuda), plain)))
    prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    flags = dict(quantized=quantized, quantized_kv=quantized_kv)
    want = decode.build_generate(cfg, 6, "cpu", **flags)(params, prompt)
    before = i8.INT8_LAUNCHES
    got = decode.build_generate(cfg, 6, **flags)(on_card, prompt)
    # The prefill's last-position unembedding, then 5 steps of 4 launches
    # a layer (Q, K and V grouped into one; O, w1, w2) and the unembedding.
    assert i8.INT8_LAUNCHES - before == (1 + 5 * (4 * cfg.n_layers + 1) if quantized else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_int8_ttft_call_launches_once_and_the_tree_quantizes_alike(cuda):
    cfg, qparams, qcard = _quantized_small(cuda, torch.bfloat16)
    card_tree = quant.quantize_params_for_serving(
        tree.tree_map(lambda t: t.to(cuda),
                      transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")))
    for a, b in zip(tree.leaves(card_tree), tree.leaves(qparams)):
        assert torch.equal(a.cpu(), b)  # bit for bit
    prompt = torch.randint(0, 128, (8, 40), generator=torch.Generator().manual_seed(1))
    before = i8.INT8_LAUNCHES
    decode.build_generate(cfg, 1, quantized=True)(qcard, prompt)
    assert i8.INT8_LAUNCHES - before == 1


@pytest.mark.cuda
def test_sampling_on_card_top_k_one_is_greedy_and_ties_give_exactly_k(cuda):
    cfg = _small_config()
    params = tree.tree_map(lambda t: t.to(cuda),
                           transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu"))
    prompt = torch.randint(0, 128, (2, 5), generator=torch.Generator().manual_seed(2))
    greedy = decode.build_generate(cfg, 6)(params, prompt)
    sampled = decode.build_generate(cfg, 6, temperature=1.7, top_k=1)(
        params, prompt, torch.Generator(device=cuda).manual_seed(7))
    assert torch.equal(sampled, greedy)
    logits = torch.full((3, 16), 9.0, device=cuda)
    seen = set()
    for seed in range(40):
        gen = torch.Generator(device=cuda).manual_seed(seed)
        seen.update(decode._pick_token(logits, gen, 1.3, 2).tolist())
    assert seen == {0, 1}


# --- MoE: the grouped expert kernel, the int8 expert axis, serving ----------


def _group_sizes(routing, m, experts):
    """Group sizes [E] for a routing case (the last two leave rows past the
    groups, which the kernel writes as zeros)."""
    if routing == "balanced":
        sizes = [m // experts] * experts
        sizes[-1] += m - sum(sizes)
    elif routing == "skewed":
        sizes = [0] * experts
        sizes[experts // 2] = m
    elif routing == "empty":
        sizes = [0] * experts
        sizes[0], sizes[-1] = m // 3, m - m // 3
    elif routing == "ragged":
        rng = np.random.default_rng(m)
        cuts = np.sort(rng.integers(0, m + 1, experts - 1))
        sizes = list(np.diff(np.concatenate([[0], cuts, [m]])))
        sizes[1] = 0
        sizes = [int(v) for v in sizes]
        sizes[-1] -= min(sizes[-1], 5)
    else:  # "none": no row routed
        sizes = [0] * experts
    return torch.tensor(sizes, dtype=torch.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("routing", ["balanced", "skewed", "empty", "ragged", "none"])
@pytest.mark.parametrize("m,k,n,experts", [(1000, 256, 512, 8), (333, 64, 136, 4),
                                           (130, 37, 19, 3), (1, 16, 16, 2), (2048, 128, 128, 40)])
def test_grouped_kernel_matches_plain_version(cuda, dtype, routing, m, k, n, experts):
    gen = torch.Generator().manual_seed(m + k + n)
    xs = torch.randn(m, k, generator=gen).to(cuda, dtype)
    w = (torch.randn(experts, k, n, generator=gen) / k ** 0.5).to(cuda, dtype)
    sizes = _group_sizes(routing, m, experts).to(cuda)
    before = _grouped_counts()
    got = gm.grouped_matmul(xs, w, sizes)
    again = gm.grouped_matmul(xs, w, sizes)
    torch.cuda.synchronize()
    kind = "f32" if dtype == torch.float32 else "tma" if k % 8 == 0 and n % 8 == 0 else "mma"
    assert _grouped_delta(before, 2) == _GROUPED_STEP[kind]
    assert got.dtype == dtype and got.shape == (m, n)
    assert torch.equal(got, again)  # one chain of sums an output: the same bits
    want = _grouped_plain(xs, w, sizes)
    assert _int8_within(got, want, dtype)
    assert torch.all(got[int(sizes.sum()):] == 0)


# Counter steps of one launch of each variant: (all, TMA, f32).
_GROUPED_STEP = {"tma": (1, 1, 0), "mma": (1, 0, 0), "f32": (1, 0, 1)}


def _grouped_counts():
    return (gm.GROUPED_LAUNCHES, gm.GROUPED_TMA_LAUNCHES, gm.GROUPED_F32_LAUNCHES)


def _grouped_delta(before, launches=1):
    """The counters' steps since `before`, per launch."""
    return tuple((now - then) / launches for now, then in zip(_grouped_counts(), before))


def _grouped_plain(xs, w, sizes):
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return gm.grouped_matmul_plain(xs, w, sizes)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


def _grouped_operands(m, k, n, experts, dtype, device, seed):
    gen = torch.Generator().manual_seed(seed)
    xs = torch.randn(m, k, generator=gen).to(device, dtype)
    w = (torch.randn(experts, k, n, generator=gen) / k ** 0.5).to(device, dtype)
    return xs, w


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_kernel_boundary_tile_beside_a_full_group(cuda, dtype):
    # Group 0 ends 64 rows into a tile whose other rows belong to group 1,
    # which is full there; group 2 ends 1 row into a tile. A store of the
    # whole box would overwrite group 1's rows with group 0's products.
    sizes = torch.tensor([gm.BM * 3 + 64, gm.BM * 2 - 64 + 5, gm.BM + 1, 300], dtype=torch.int32)
    m = int(sizes.sum()) + 17
    xs, w = _grouped_operands(m, 512, 768, 4, dtype, cuda, 11)
    got = gm.grouped_matmul(xs, w, sizes.to(cuda))
    want = _grouped_plain(xs, w, sizes.to(cuda))
    torch.cuda.synchronize()
    for r in range(m):  # row by row: each row of its own group's product
        assert _int8_within(got[r:r + 1], want[r:r + 1], dtype), r


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("m,k,n", [(300, 40, 72), (129, 8, 8), (5, 56, 248)])
def test_grouped_kernel_zero_fills_past_k_and_n(cuda, dtype, m, k, n):
    # K below one step and N below one tile: TMA's boxes (and the f32
    # kernel's copies) read zeros past K and N.
    xs, w = _grouped_operands(m, k, n, 3, dtype, cuda, m + k + n)
    sizes = _group_sizes("ragged", m, 3).to(cuda)
    before = _grouped_counts()
    got = gm.grouped_matmul(xs, w, sizes)
    assert _grouped_delta(before) == _GROUPED_STEP["f32" if dtype == torch.float32 else "tma"]
    assert _int8_within(got, _grouped_plain(xs, w, sizes), dtype)
    assert torch.all(got[int(sizes.sum()):] == 0)


@pytest.mark.cuda
def test_grouped_kernel_variant_by_shape_and_alignment(cuda):
    sizes = torch.tensor([40, 60], dtype=torch.int32, device=cuda)
    xs, w = _grouped_operands(100, 64, 64, 2, torch.bfloat16, cuda, 5)
    shifted = torch.empty(100 * 64 + 1, dtype=torch.bfloat16, device=cuda)[1:].view(100, 64)
    shifted.copy_(xs)  # the same values at an address 2 bytes past 16-byte alignment
    cases = [((xs, w), "tma"), ((shifted, w), "mma"), ((xs[:, :60].contiguous(), w[:, :60]
                                                          .contiguous()), "mma"),
             ((xs.float(), w.float()), "f32")]
    outs = []
    for (a, b), kind in cases:
        before = _grouped_counts()
        outs.append(gm.grouped_matmul(a, b, sizes))
        assert _grouped_delta(before) == _GROUPED_STEP[kind], kind
        assert gm.variant(a, b, outs[-1]) == kind
    torch.cuda.synchronize()
    # The same function whichever kernel ran (aligned and shifted operands).
    assert _int8_within(outs[1], outs[0], torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_kernel_at_a_prefill_width_is_bit_for_bit_repeatable(cuda, dtype):
    # More tiles than SMs: the persistent blocks walk several tiles each.
    xs, w = _grouped_operands(4096, 1024, 2048, 8, dtype, cuda, 21)
    sizes = _group_sizes("ragged", 4096, 8).to(cuda)
    first = gm.grouped_matmul(xs, w, sizes)
    runs = [gm.grouped_matmul(xs, w, sizes) for _ in range(3)]
    torch.cuda.synchronize()
    assert all(torch.equal(first, r) for r in runs)
    assert _int8_within(first, _grouped_plain(xs, w, sizes), dtype)


@pytest.mark.cuda
def test_grouped_kernel_reports_the_wrappers_layout_and_rejects_bad_operands(cuda):
    assert gm.kernel_layout() == gm.layout()
    xs = torch.randn(8, 16, device=cuda)
    w = torch.randn(2, 16, 8, device=cuda)
    sizes = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    for bad in ((xs.half(), w.half(), sizes), (xs, w, sizes.long()), (xs, w[:, :15], sizes),
                (xs, w.cpu(), sizes), (xs, w, sizes[:1])):
        with pytest.raises(ValueError, match="the kernel takes"):
            gm.grouped_matmul(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared_x", "expert_x"])
@pytest.mark.parametrize("rows,k,n,experts", [(8, 1024, 4096, 8), (8, 4096, 1024, 8),
                                              (1, 256, 96, 3), (16, 300, 17, 5)])
def test_int8_expert_launch_equals_2d_launches_bit_for_bit(cuda, dtype, shared, rows, k, n,
                                                           experts):
    gen = torch.Generator().manual_seed(rows + k + n)
    qt = quant.quantize_int8(torch.randn(experts, k, n, generator=gen) / k ** 0.5).to(cuda)
    x = torch.randn(1 if shared else experts, rows, k, generator=gen).to(cuda, dtype)
    before = i8.INT8_LAUNCHES
    got = i8.int8_matmul_experts(x, qt, dtype)
    assert i8.INT8_LAUNCHES == before + 1
    assert got.shape == (experts, rows, n) and got.dtype == dtype
    for e in range(experts):
        one = quant.QuantizedTensor(qt.q[e].contiguous(), qt.scale[e].contiguous())
        assert torch.equal(got[e], i8.int8_matmul(x[0 if shared else e], one, dtype))
    assert _int8_within(got, i8.int8_matmul_experts_plain(x, qt, dtype), dtype)


# A tp = 2 rank's int8 decode products (rows, K, N) of the flagship (d
# 1024, 16 heads of 64, d_ff 4096, vocab 32000) and the MoE flagship (8
# experts of d_ff_expert 4096); "row" marks the row-parallel products,
# whose K is split over tp.
TP_LOCAL_INT8 = {"wq": (8, 1024, 512, None), "wo": (8, 512, 1024, "row"),
                 "w1": (8, 1024, 2048, None), "w2": (8, 2048, 1024, "row"),
                 "unembed": (8, 1024, 16000, None)}
TP_LOCAL_EXPERTS = {"we1": (8, 1024, 2048, 8, None), "we2": (8, 2048, 1024, 8, "row")}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("name", list(TP_LOCAL_INT8) + list(TP_LOCAL_EXPERTS))
def test_int8_kernel_at_a_tp_rank_shapes_matches_plain_version(cuda, dtype, name):
    """The int8 kernel on a tp = 2 rank's shard of a weight quantized whole
    (`convert.shard_params`' order), against its plain version; for a
    row-parallel weight, the two ranks' products summed equal the product
    of the whole weight within each product's rounding: |d| <= 2^-7 (|p0|
    + |p1| + |full|) + 1e-4 max|full| in bf16 (three outputs rounded to
    bf16), 1e-5 max|full| in f32."""
    rows, k, n, *experts = TP_LOCAL_INT8.get(name) or TP_LOCAL_EXPERTS[name]
    lead = experts[:1] if name in TP_LOCAL_EXPERTS else []
    split = experts[-1] if lead else TP_LOCAL_INT8[name][3]
    gen = torch.Generator().manual_seed(k + n)
    whole_k = 2 * k if split == "row" else k
    whole_n = n if split == "row" else 2 * n
    full = quant.quantize_int8(torch.randn(*lead, whole_k, whole_n, generator=gen)
                               / whole_k ** 0.5).to(cuda)
    x = torch.randn(1 if lead else rows, *([rows] if lead else []), whole_k,
                    generator=gen).to(cuda, dtype)
    fn, plain = ((i8.int8_matmul_experts, i8.int8_matmul_experts_plain) if lead
                 else (i8.int8_matmul, i8.int8_matmul_plain))
    parts = []
    for rank in range(2):
        cut = (slice(rank * k, (rank + 1) * k), slice(None)) if split == "row" else (
            slice(None), slice(rank * n, (rank + 1) * n))
        local = quant.QuantizedTensor(full.q[..., cut[0], cut[1]].contiguous(),
                                      full.scale[..., :, cut[1]].contiguous())
        xr = x[..., cut[0]].contiguous()
        before = i8.INT8_LAUNCHES
        got = fn(xr, local, dtype)
        assert i8.INT8_LAUNCHES == before + 1
        assert got.dtype == dtype and got.shape[-2:] == (rows, n)
        assert _int8_within(got, plain(xr, local, dtype), dtype)
        parts.append(got.float())
    if split == "row":
        whole = fn(x, full, dtype).float()
        peak = whole.abs().max().item()
        limit = (2.0 ** -7 * (parts[0].abs() + parts[1].abs() + whole.abs()) + 1e-4 * peak
                 if dtype == torch.bfloat16 else torch.full_like(whole, 1e-5 * peak))
        assert bool(((parts[0] + parts[1] - whole).abs() <= limit).all())


def _moe_small(**kw):
    return transformer.TransformerConfig(vocab_size=128, d_model=64, n_heads=4, n_kv_heads=2,
                                         n_layers=2, n_experts=4, d_ff_expert=96, moe_top_k=2,
                                         moe_dispatch="dropless", dtype=torch.float32, **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("quantized,quantized_kv", [(False, False), (True, False), (True, True)],
                         ids=["f32", "int8", "int8_both"])
def test_moe_generate_on_card_matches_cpu_at_f32(cuda, quantized, quantized_kv):
    cfg = _moe_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    if quantized:
        params = quant.quantize_params_for_serving(params)
    prompt = torch.randint(0, 128, (2, 40), generator=torch.Generator().manual_seed(1))
    flags = dict(quantized=quantized, quantized_kv=quantized_kv)
    want = decode.build_generate(cfg, 6, "cpu", **flags)(params, prompt)
    grouped, int8 = gm.GROUPED_LAUNCHES, i8.INT8_LAUNCHES
    got = decode.build_generate(cfg, 6, **flags)(tree.tree_map(lambda t: t.to(cuda), params),
                                                 prompt)
    # The prefill: two grouped products a layer. Each decode step with int8
    # weights: Q/K/V, O and the two expert stacks a layer, the unembedding.
    assert gm.GROUPED_LAUNCHES - grouped == 2 * cfg.n_layers
    assert i8.INT8_LAUNCHES - int8 == (1 + 5 * (4 * cfg.n_layers + 1) if quantized else 0)
    assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_moe_forward_on_card_matches_cpu_at_f32(cuda):
    cfg = _moe_small()
    params = transformer.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    tokens = torch.randint(0, 128, (2, 70), generator=torch.Generator().manual_seed(3))
    want = transformer.build_forward(cfg, "cpu")(params, tokens)
    before = gm.GROUPED_LAUNCHES
    got = transformer.build_forward(cfg)(tree.tree_map(lambda t: t.to(cuda), params), tokens)
    assert gm.GROUPED_LAUNCHES - before == 2 * cfg.n_layers
    assert _within(got.cpu(), want, 1e-4, 1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_layers_make_no_host_sync(cuda, dtype):
    cfg = _moe_small(max_seq_len=64)
    cfg = replace(cfg, dtype=dtype)
    params = decode.cast_params(tree.tree_map(
        lambda t: t.to(cuda), transformer.init_params(cfg, torch.Generator().manual_seed(0),
                                                      "cpu")), dtype)
    layer = transformer.layer_params(params, 0)
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    cache = decode.init_kv_cache(cfg, 2, 48, cuda)
    with torch.no_grad():
        decode._prefill_layer(layer, x, cache["k"][0], cache["v"][0], cfg)  # warm
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            decode._prefill_layer(layer, x, cache["k"][0], cache["v"][0], cfg)
            decode._decode_layer(layer, x[:, :1], cache["k"][0], cache["v"][0], 40, cfg)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_moe_router_ignores_tf32(cuda):
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(512, 1024, generator=gen).to(cuda)
    wg = torch.randn(1024, 8, generator=gen).to(cuda)
    torch.backends.cuda.matmul.allow_tf32 = True  # the fixture restores it
    got = transformer._router_logits(x, wg)
    exact = (x.double() @ wg.double()).float()
    assert torch.equal(got, exact)
    assert not torch.equal(x @ wg, exact)  # an f32 matmul here would run in TF32


# --- MoE training: the grouped product's backward -----------------------------


def _backward_counts():
    return (gm.GROUPED_DGRAD_LAUNCHES, gm.GROUPED_DGRAD_F32_LAUNCHES, gm.GROUPED_WGRAD_LAUNCHES,
            gm.GROUPED_WGRAD_F32_LAUNCHES)


def _wgrad_f32_tma_launches(fn):
    """fn's launches of the f32 wgrad kernel on TMA and tf32 wgmma."""
    before = gm.GROUPED_WGRAD_F32_TMA_LAUNCHES
    out = fn()
    return out, gm.GROUPED_WGRAD_F32_TMA_LAUNCHES - before


def _backward_plain(fn, *args):
    flag = torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    try:
        return fn(*args)
    finally:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = flag


# (3000, 1000, 1000, 8): the TMA path with K a multiple of 8 but not of the
# 128-row K tile and N not of the 256-column N tile, so a partial K tile's
# stores would spill into the next expert's dw but for the 3-D map.
_BACKWARD_SHAPES = [(1000, 256, 512, 8), (333, 64, 136, 4), (130, 37, 19, 3), (1, 16, 16, 2),
                    (2048, 128, 128, 40), (3000, 1000, 1000, 8)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("routing", ["balanced", "skewed", "empty", "ragged", "none"])
@pytest.mark.parametrize("m,k,n,experts", _BACKWARD_SHAPES)
def test_grouped_wgrad_kernel_matches_plain_version(cuda, dtype, routing, m, k, n, experts):
    gen = torch.Generator().manual_seed(m + k + n + 1)
    xs = torch.randn(m, k, generator=gen).to(cuda, dtype)
    dy = torch.randn(m, n, generator=gen).to(cuda, dtype)
    sizes = _group_sizes(routing, m, experts).to(cuda)
    before = _backward_counts()
    got, tma = _wgrad_f32_tma_launches(lambda: gm.grouped_matmul_wgrad(xs, dy, sizes))
    again = gm.grouped_matmul_wgrad(xs, dy, sizes)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert tuple(a - b for a, b in zip(_backward_counts(), before)) == (0, 0, 2, 2 * f32)
    # f32 with K and N multiples of 4 (aligned, as torch allocates) runs on
    # TMA and tf32 wgmma; (130, 37, 19, 3) on the 4-byte mma.sync kernel.
    assert tma == int(f32 and k % 4 == 0 and n % 4 == 0)
    assert got.dtype == dtype and got.shape == (experts, k, n)
    assert torch.equal(got, again)  # one chain of sums an output: the same bits
    assert _int8_within(got, _backward_plain(gm.grouped_matmul_wgrad_plain, xs, dy, sizes), dtype)
    for e in torch.nonzero(sizes.cpu() == 0).flatten().tolist():
        assert torch.all(got[e] == 0)  # an empty group's gradient is exactly 0


@pytest.mark.cuda
@pytest.mark.parametrize("k,n,shift,kind", [(256, 512, 0, "f32_tma"), (36, 20, 0, "f32_tma"),
                                            (37, 512, 0, "f32"), (256, 18, 0, "f32"),
                                            (256, 512, 1, "f32")],
                         ids=["aligned", "narrow", "k_odd", "n_not_4", "misaligned"])
def test_grouped_wgrad_f32_takes_tma_where_it_can(cuda, k, n, shift, kind):
    # TMA needs K and N multiples of 4 and 16-byte aligned bases; elsewhere
    # the 4-byte cp.async kernel gives the same function.
    m, experts = 700, 5
    gen = torch.Generator().manual_seed(k + n + shift)
    xs = torch.randn(m * k + shift, generator=gen).to(cuda)[shift:].view(m, k)
    dy = torch.randn(m, n, generator=gen).to(cuda)
    sizes = _group_sizes("ragged", m, experts).to(cuda)
    dw = torch.empty((experts, k, n), device=cuda)
    assert gm.wgrad_variant(xs, dy, dw) == kind
    before = _backward_counts()
    got, tma = _wgrad_f32_tma_launches(lambda: gm.grouped_matmul_wgrad(xs, dy, sizes))
    torch.cuda.synchronize()
    assert tuple(a - b for a, b in zip(_backward_counts(), before)) == (0, 0, 1, 1)
    assert tma == (kind == "f32_tma")
    assert _int8_within(got, _backward_plain(gm.grouped_matmul_wgrad_plain, xs, dy, sizes),
                        torch.float32)
    assert torch.all(got[1] == 0)  # _group_sizes' ragged routing leaves expert 1 empty


@pytest.mark.cuda
@pytest.mark.parametrize("k,n", [(1024, 512), (512, 1024)])
def test_grouped_wgrad_f32_holds_the_tolerance_over_a_16384_row_segment(cuda, k, n):
    # One expert takes every row (the flagship's skewed routing): 512 steps
    # of 32 rows in one chain, promoted to f32 every WT_PROMOTE rows.
    m, experts = 16384, 4
    gen = torch.Generator().manual_seed(k - n)
    xs = torch.randn(m, k, generator=gen).to(cuda)
    dy = torch.randn(m, n, generator=gen).to(cuda)
    sizes = torch.tensor([0, m, 0, 0], dtype=torch.int32, device=cuda)
    got, tma = _wgrad_f32_tma_launches(lambda: gm.grouped_matmul_wgrad(xs, dy, sizes))
    want = (xs.double().T @ dy.double()).float()
    torch.cuda.synchronize()
    assert tma == 1
    assert _int8_within(got[1], want, torch.float32)
    assert torch.all(got[[0, 2, 3]] == 0)
    assert torch.equal(got, gm.grouped_matmul_wgrad(xs, dy, sizes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("routing", ["balanced", "skewed", "ragged"])
@pytest.mark.parametrize("m,k,n,experts", _BACKWARD_SHAPES)
def test_grouped_dgrad_matches_plain_version(cuda, dtype, routing, m, k, n, experts):
    xs, w = _grouped_operands(m, k, n, experts, dtype, cuda, m + k + n + 2)
    dy = torch.randn(m, n, generator=torch.Generator().manual_seed(m)).to(cuda, dtype)
    sizes = _group_sizes(routing, m, experts).to(cuda)
    before = _backward_counts()
    got = gm.grouped_matmul_dgrad(dy, w, sizes)
    torch.cuda.synchronize()
    f32 = dtype == torch.float32
    assert tuple(a - b for a, b in zip(_backward_counts(), before)) == (1, f32, 0, 0)
    assert got.dtype == dtype and got.shape == (m, k)
    assert _int8_within(got, _backward_plain(gm.grouped_matmul_dgrad_plain, dy, w, sizes), dtype)
    assert torch.all(got[int(sizes.sum()):] == 0)
    # The TMA kernel reading w K-major (bf16, K and N multiples of 8): the
    # forward's launch on a transposed copy of w, bit for bit.
    if dtype == torch.bfloat16 and k % 8 == 0 and n % 8 == 0:
        assert torch.equal(got, gm.grouped_matmul(dy, w.transpose(1, 2).contiguous(), sizes))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_grouped_wgrad_keeps_each_group_to_its_rows_at_a_boundary(cuda, dtype):
    # Groups ending inside a step of rows beside a full group: a step that
    # crosses the boundary must add none of the neighbour's rows.
    sizes = torch.tensor([gm.W_BR * 3 + 17, gm.W_BR - 17 + 5, 1, 300], dtype=torch.int32)
    m = int(sizes.sum()) + 9
    gen = torch.Generator().manual_seed(12)
    xs = torch.randn(m, 256, generator=gen).to(cuda, dtype)
    dy = torch.randn(m, 384, generator=gen).to(cuda, dtype)
    got = gm.grouped_matmul_wgrad(xs, dy, sizes.to(cuda))
    start = 0
    for e, size in enumerate(sizes.tolist()):
        want = _backward_plain(torch.matmul, xs[start:start + size].T, dy[start:start + size])
        assert _int8_within(got[e], want, dtype), e
        start += size


@pytest.mark.cuda
def test_grouped_backward_rejects_what_it_does_not_take(cuda):
    xs = torch.randn(8, 16, device=cuda)
    dy = torch.randn(8, 24, device=cuda)
    w = torch.randn(2, 16, 24, device=cuda)
    sizes = torch.tensor([3, 5], dtype=torch.int32, device=cuda)
    for bad in ((xs.half(), dy.half(), sizes), (xs, dy[:7], sizes), (xs, dy.bfloat16(), sizes),
                (xs, dy, sizes.long()), (xs, dy.cpu(), sizes), (xs, dy.T, sizes)):
        with pytest.raises(ValueError, match="the kernel takes"):
            gm.grouped_matmul_wgrad(*bad)
    for bad in ((dy, w[:, :, :20].contiguous(), sizes), (dy, w, sizes[:1]), (dy.half(), w, sizes)):
        with pytest.raises(ValueError, match="the kernel takes"):
            gm.grouped_matmul_dgrad(*bad)


@pytest.mark.cuda
@pytest.mark.parametrize("remat, forward", [("off", 4), ("full", 8), ("dots", 8)])
def test_moe_train_step_launches_and_matches_cpu(cuda, remat, forward):
    cfg = _moe_small(remat=remat != "off", remat_policy="full" if remat == "off" else remat)
    params = transformer.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    tokens = torch.randint(0, 128, (4, 65), generator=torch.Generator().manual_seed(1))
    batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
    opt = optim.sgd(1.0)

    def step(device, p):
        return transformer.build_train_step(cfg, opt, device=device)(p, opt.init(p), batch)

    before = (gm.GROUPED_F32_LAUNCHES,) + _backward_counts()
    (got, _, loss), tma = _wgrad_f32_tma_launches(
        lambda: step(None, tree.tree_map(lambda t: t.to(cuda), params)))
    # Two grouped products a layer: forward (again in the backward under a
    # remat policy), dgrad and wgrad each once, all f32; wgrad's on TMA and
    # tf32 wgmma (d_model 64 and d_ff_expert 96 are multiples of 4).
    layers = 2 * cfg.n_layers
    assert tuple(a - b for a, b in zip((gm.GROUPED_F32_LAUNCHES,) + _backward_counts(),
                                       before)) == (forward, layers, layers, layers, layers)
    assert tma == layers
    want, _, want_loss = step("cpu", params)
    assert abs(loss.item() - want_loss.item()) <= 1e-4 * abs(want_loss.item())
    for g, w, p in zip(tree.leaves(got), tree.leaves(want), tree.leaves(params)):
        assert _within((p - g.cpu()), (p - w), 1e-3, 1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moe_layer_forward_and_backward_make_no_host_sync(cuda, dtype):
    cfg = replace(_moe_small(), dtype=dtype)
    params = tree.tree_map(lambda t: t.to(cuda).requires_grad_(), transformer.init_params(
        cfg, torch.Generator().manual_seed(0), "cpu"))
    layer = transformer.layer_params(params, 0)
    x = torch.randn(2, 40, 64, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)

    def run():
        out, stats = transformer._layer(layer, x.requires_grad_(), cfg)
        torch.autograd.grad((out.float().sum(), stats[1].sum()), [x, *params["layers"].values()],
                            allow_unused=True)

    run()  # warm (masks)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# The mlp and cnn workload kinds and adafactor on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def no_cudnn_tf32(cuda):
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    yield cuda
    torch.backends.cudnn.allow_tf32 = prev


@pytest.mark.cuda
@pytest.mark.parametrize("size", [8, 9], ids=["even", "odd"])
@pytest.mark.parametrize("stride", [1, 2])
def test_cnn_conv_same_padding_matches_cpu(no_cudnn_tf32, size, stride):
    from jobset_tpu_torch.models import cnn

    gen = torch.Generator().manual_seed(size)
    x, w = torch.randn(2, size, size, 8, generator=gen), torch.randn(3, 3, 8, 16, generator=gen)
    got = cnn.conv(x.to(no_cudnn_tf32), w.to(no_cudnn_tf32), stride)
    want = cnn.conv(x, w, stride)
    assert got.shape == want.shape == (2, -(-size // stride), -(-size // stride), 16)
    assert _within(got.cpu(), want, 1e-5, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cnn_train_step_matches_cpu(no_cudnn_tf32, dtype):
    """One sgd step at lr 1 (p - p' is the gradient): f32 loss rtol 1e-4 and
    every gradient leaf within 1e-3 of the CPU's; bf16 loss 2e-2 and leaves
    5e-2 in relative norm (cuDNN and the CPU round each bf16 convolution's
    output apart)."""
    from jobset_tpu_torch.models import cnn

    cfg = cnn.CNNConfig(widths=(16, 32), blocks_per_stage=1, groups=4, dtype=dtype)
    params = cnn.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    gen = torch.Generator().manual_seed(1)
    batch = {"images": torch.randn(8, 16, 16, 3, generator=gen),
             "labels": torch.randint(0, 10, (8,), generator=gen)}
    opt = optim.sgd(1.0)

    def step(device, p):
        return cnn.build_train_step(cfg, opt, device)(p, opt.init(p), batch)

    got, _, loss = step(no_cudnn_tf32, tree.tree_map(lambda t: t.to(no_cudnn_tf32), params))
    want, _, want_loss = step("cpu", params)
    loss_rel, grad_rel = (1e-4, 1e-3) if dtype == torch.float32 else (2e-2, 5e-2)
    assert abs(loss.item() - want_loss.item()) <= loss_rel * abs(want_loss.item())
    for g, w, p in zip(tree.leaves(got), tree.leaves(want), tree.leaves(params)):
        d, ref = (p - g.cpu()), (p - w)
        assert ((d - ref).norm() / ref.norm()).item() <= grad_rel


@pytest.mark.cuda
def test_adafactor_matches_cpu(cuda):
    """Three updates on factored ([256, 128], the tie [128, 128], stacked
    [1, 4, 256, 384]) and unfactored ([4, 200], [300]) leaves: each update
    within 1e-6 of the CPU's, relative to its largest entry."""
    gen = torch.Generator().manual_seed(2)
    shapes = [(256, 128), (128, 128), (1, 4, 256, 384), (4, 200), (300,)]
    params = {f"p{i}": torch.randn(s, generator=gen) * 0.05 for i, s in enumerate(shapes)}
    opt = optim.adafactor(1e-2)
    on_card = tree.tree_map(lambda t: t.to(cuda), params)
    state, card_state = opt.init(params), opt.init(on_card)
    for _ in range(3):
        grads = tree.tree_map(lambda t: torch.randn(t.shape, generator=gen), params)
        want, state = opt.update(grads, state, params)
        got, card_state = opt.update(tree.tree_map(lambda t: t.to(cuda), grads), card_state,
                                     on_card)
        for g, w in zip(tree.leaves(got), tree.leaves(want)):
            assert _within(g.cpu(), w, 1e-6, 1e-12)
        params = tree.tree_map(lambda p, u: p + u, params, want)
        on_card = tree.tree_map(lambda p, u: p + u, on_card, got)


@pytest.mark.cuda
def test_mlp_workload_matches_cpu(cuda):
    from jobset_tpu_torch.runtime import runner

    payload = {"kind": "mlp", "steps": 8, "config": {"d_in": 8, "d_hidden": 32, "d_out": 4}}
    got, want = runner.train_workload(payload, cuda), runner.train_workload(payload, "cpu")
    assert all(abs(g - w) <= 1e-4 * abs(w) for g, w in zip(got, want))


GANG_CONFIG = {"vocab_size": 128, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
               "n_layers": 2, "dtype": "float32", "remat": False}


def _gang_batches(steps=2, b=4, t=64):
    rng = np.random.default_rng(9)
    out = []
    for _ in range(steps):
        tokens = rng.integers(0, 128, (b, t + 1))
        out.append({"inputs": tokens[:, :-1], "targets": tokens[:, 1:]})
    return out


def _gang_run(world, mesh, backend):
    import torch_gang_bodies as bodies
    from jobset_tpu_torch.runtime import gang

    return gang.spawn(bodies.train_steps, world, (GANG_CONFIG, mesh, _gang_batches()),
                      backend=backend, device="cuda", timeout_s=300, threads=0)


@pytest.mark.cuda
def test_gang_at_tp2_on_the_card_matches_one_process(cuda):
    """Two ranks share the card on gloo with CUDA tensors: losses and the
    gathered parameters after 2 adamw steps (lr 1e-3) against one rank's
    run of the same steps, f32 (TF32 off, torch's default in a fresh
    process): losses within 1e-5 relative,
    each parameter within 0.05 * lr a step (Adam's scale-free update)."""
    (one,) = _gang_run(1, {}, "gloo")
    ranks = _gang_run(2, {"tp": 2}, "gloo")
    assert ranks[0]["losses"] == ranks[1]["losses"]
    assert all(abs(a - b) <= 1e-5 * abs(b) for a, b in zip(ranks[0]["losses"], one["losses"]))
    for got, want in zip(tree.leaves(ranks[0]["params"]), tree.leaves(one["params"])):
        assert np.abs(got - want).max() <= 0.05 * 1e-3 * 2


@pytest.mark.cuda
def test_nccl_at_world_one_matches_gloo_bit_for_bit(cuda):
    (nccl,) = _gang_run(1, {}, "nccl")
    (gloo,) = _gang_run(1, {}, "gloo")
    assert nccl["losses"] == gloo["losses"]
    for a, b in zip(tree.leaves(nccl["params"]), tree.leaves(gloo["params"])):
        np.testing.assert_array_equal(a, b)
