"""Card-only tests of the port: the CUDA kernel against its plain version,
and the serving path on the card against the same path on the CPU.

They skip without a CUDA device. This file imports no JAX, so it also runs
on a machine that has none: `python -m pytest --noconftest -m cuda
tests/test_torch_cuda.py` (the repo's conftest imports JAX).

Tolerances: f32 1e-4 (the kernel's FMA order against cuBLAS/CPU sums);
bf16 2e-2 relative to the tensor's largest value on sums and weighted
values (p is rounded to bf16 against the running max in the kernel and
against the block max in the plain version).
"""

import pytest
import torch

from jobset_tpu_torch.models import decode, transformer
from jobset_tpu_torch.ops import flash_block as fb


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
    counter = "TENSOR_CORE_LAUNCHES" if dtype == torch.bfloat16 else "FMA_LAUNCHES"
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
