"""The port's flash block step against the JAX package's.

Same numpy inputs go through `jobset_tpu.ops` (the Pallas kernel under
its interpreter, and the jnp reference) and through
`jobset_tpu_torch.ops.flash_block` on the CPU, where `block_attention`
takes its plain version. The CUDA kernel itself is compared with the plain
version on the card (tests/test_torch_cuda.py and chip_smoke.py).

Tolerances: f32 1e-5 (same arithmetic, other summation order); bf16 2e-2
on sums and weighted values (bf16 operands are exact in the f32 products,
but the probabilities are rounded to bf16 before the PV product, and the
Pallas kernel rounds them against its running max where the references
round against the block max) and 1e-4 on the max.
"""

import contextlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jobset_tpu.ops import flash_block as jfb
from jobset_tpu_torch.ops import flash_block as tfb

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MAX_TOL = dict(rtol=1e-5, atol=1e-4)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _qkv(batch, tq, tk, heads, dim, seed=0, kv_heads=None):
    rng = np.random.default_rng(seed)
    kv_heads = kv_heads or heads
    return (
        rng.standard_normal((batch, tq, heads, dim)).astype(np.float32),
        rng.standard_normal((batch, tk, kv_heads, dim)).astype(np.float32),
        rng.standard_normal((batch, tk, kv_heads, dim)).astype(np.float32),
    )


def _bias(kind, tq, tk):
    if kind == "triangle":
        rel = np.arange(tq)[:, None] - np.arange(tk)[None, :]
        return np.where(rel >= 0, 0.0, tfb.NEG_INF).astype(np.float32)
    if kind == "zero":
        return np.zeros((tq, tk), np.float32)
    return np.full((tq, tk), tfb.NEG_INF, np.float32)


_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def _to_jax(x, dtype):
    return jnp.asarray(x).astype(dtype)


def _to_torch(x, dtype):
    return torch.from_numpy(x).to(dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(
        np.asarray(got, dtype=np.float32), np.asarray(want, dtype=np.float32), **tol
    )


def _check_triple(got, want, dtype_name):
    _close(got[0], want[0], MAX_TOL if dtype_name == "bf16" else F32_TOL)
    tol = BF16_TOL if dtype_name == "bf16" else F32_TOL
    _close(got[1], want[1], tol)
    _close(got[2], want[2], tol)


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("bias_kind", ["triangle", "zero", "all_masked"])
@pytest.mark.parametrize("shape", [(2, 32, 32, 2, 16), (1, 24, 40, 2, 8)],
                         ids=["square", "ragged"])
def test_block_attention_matches_pallas_and_reference(dtype_name, bias_kind, shape):
    batch, tq, tk, heads, dim = shape
    jdt, tdt = _DTYPES[dtype_name]
    q, k, v = _qkv(batch, tq, tk, heads, dim)
    bias = _bias(bias_kind, tq, tk)
    jargs = [_to_jax(x, jdt) for x in (q, k, v)] + [jnp.asarray(bias)]
    with jfb.force_interpret():
        pallas = jfb.block_attention(*jargs)
    reference = jfb.block_attention_reference(*jargs)

    got = tfb.block_attention(*(_to_torch(x, tdt) for x in (q, k, v)), torch.from_numpy(bias))
    for t in got:
        assert t.dtype == torch.float32
    assert got[0].shape == (batch, heads, tq) and got[2].shape == (batch, tq, heads, dim)
    _check_triple([t.numpy() for t in got], pallas, dtype_name)
    _check_triple([t.numpy() for t in got], reference, dtype_name)
    if bias_kind == "all_masked":
        assert np.all(got[1].numpy() == 0.0) and np.all(got[2].numpy() == 0.0)
        assert np.all(got[0].numpy() <= tfb.NEG_INF / 2)


def test_merge_and_normalize_match_jax():
    rng = np.random.default_rng(3)
    b, h, t, d = 2, 3, 5, 4

    def triple(masked_rows):
        m = rng.standard_normal((b, h, t)).astype(np.float32)
        m[:, :, :masked_rows] = tfb.NEG_INF
        s = rng.uniform(0.5, 2.0, (b, h, t)).astype(np.float32)
        s[:, :, :masked_rows] = 0.0
        w = rng.standard_normal((b, t, h, d)).astype(np.float32)
        w[:, :masked_rows] = 0.0
        return m, s, w

    acc, blk = triple(2), triple(1)
    want = jfb.merge_block_stats(
        tuple(map(jnp.asarray, acc)), tuple(map(jnp.asarray, blk))
    )
    got = tfb.merge_block_stats(
        tuple(map(torch.from_numpy, acc)), tuple(map(torch.from_numpy, blk))
    )
    for g, w in zip(got, want):
        _close(g.numpy(), w, F32_TOL)
    norm_want = jfb.normalize_block_stats(want[1], want[2])
    norm_got = tfb.normalize_block_stats(got[1], got[2])
    _close(norm_got.numpy(), norm_want, F32_TOL)
    assert np.all(np.isfinite(norm_got.numpy()))
    assert np.all(norm_got.numpy()[:, :1] == 0.0)  # fully masked rows give 0


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("causal", [True, False])
def test_blockwise_causal_attention_matches_jax(dtype_name, causal):
    # Ragged T = 37 with chunk 8: floor T/16 = 3 keeps 8, the last chunk is 5.
    jdt, tdt = _DTYPES[dtype_name]
    q, k, v = _qkv(2, 37, 37, 4, 8, seed=5, kv_heads=2)
    want = jfb.blockwise_causal_attention(
        *(_to_jax(x, jdt) for x in (q, k, v)), chunk=8, causal=causal
    )
    got = tfb.blockwise_causal_attention(
        *(_to_torch(x, tdt) for x in (q, k, v)), chunk=8, causal=causal
    )
    assert got.shape == (2, 37, 4, 8) and got.dtype == torch.float32
    _close(got.numpy(), want, BF16_TOL if dtype_name == "bf16" else F32_TOL)


def test_chunk_floor_is_t_over_16():
    # T = 160 with chunk 4: the floor raises the chunk to 10 -> 16 chunks,
    # 136 causal block calls (the count the JAX docstring promises).
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 160, 160, 1, 8, seed=6))
    calls = []
    real = tfb.block_attention

    def counting(*args):
        calls.append(args[0].shape[1])
        return real(*args)

    tfb.block_attention = counting
    try:
        tfb.blockwise_causal_attention(q, k, v, chunk=4)
    finally:
        tfb.block_attention = real
    assert len(calls) == 16 * 17 // 2 and set(calls) == {10}


def test_repeat_heads_is_a_view():
    x = torch.randn(2, 5, 3, 4)
    r = tfb._repeat_heads(x, 2)
    assert r.shape == (2, 5, 3, 2, 4)
    assert r.data_ptr() == x.data_ptr() and r.stride(3) == 0
    assert tfb._repeat_heads(x, 1) is x
    want = np.asarray(jfb._repeat_heads(jnp.asarray(x.numpy()), 2))
    np.testing.assert_array_equal(tfb._flat_heads(r).numpy(), want)


def test_block_attention_has_no_backward_yet():
    # The name is older than the backward: block_attention is now
    # differentiable in every input, and tests/test_torch_train.py holds its
    # gradients against the JAX package's _bwd.
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(1, 4, 4, 1, 8))
    bias = torch.zeros(4, 4, requires_grad=True)
    _, block_sum, weighted = tfb.block_attention(q, k, v, bias)
    grads = torch.autograd.grad(block_sum.sum() + weighted.sum(), (q, k, v, bias))
    for g, x in zip(grads, (q, k, v, bias)):
        assert g.shape == x.shape and torch.isfinite(g).all()


@pytest.mark.parametrize("mode", ["no_grad", "no_input_requires_grad"])
def test_block_attention_unrecorded_call_skips_autograd(mode):
    # A call that autograd does not record (serving runs under no_grad)
    # goes straight to the forward: no graph node, the same values.
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 8, 8, 2, 8, seed=7))
    bias = torch.from_numpy(np.triu(np.full((8, 8), tfb.NEG_INF, np.float32), 1))
    if mode == "no_grad":
        q.requires_grad_()
    context = torch.no_grad() if mode == "no_grad" else contextlib.nullcontext()
    with context:
        got = tfb.block_attention(q, k, v, bias)
    want = tfb.block_attention_reference(q.detach(), k, v, bias)
    for g, w in zip(got, want):
        assert g.grad_fn is None and not g.requires_grad
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_block_attention_refuses_other_devices():
    q = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tfb.block_attention(q, q, q, torch.empty((4, 4), device="meta"))


@pytest.mark.parametrize("case", ["head_dim", "dtype", "bias", "heads"])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(case):
    # The checks run before the library is built or loaded, so they can be
    # exercised here on CPU tensors.
    q = torch.zeros((1, 4, 2, 8))
    k = v = torch.zeros((1, 6, 2, 8))
    bias = torch.zeros((4, 6))
    if case == "head_dim":
        q, k, v = (torch.zeros((*t.shape[:3], 136)) for t in (q, k, v))
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "bias":
        bias = torch.zeros((4, 5))
    else:
        k = v = torch.zeros((1, 6, 3, 8))
    with pytest.raises(ValueError):
        tfb._block_attention_cuda(q, k, v, bias)


def test_ring_attention_runs_sp1_only():
    from jobset_tpu_torch.parallel import ring_attention

    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 6, 6, 2, 8))
    with pytest.raises(NotImplementedError, match="sp=2"):
        ring_attention(q, k, v, sp=2)
    out = ring_attention(q, k, v)
    want = tfb.blockwise_causal_attention(q, k, v)
    _close(out.numpy(), want.numpy(), F32_TOL)


def test_kernel_library_path_tracks_source(tmp_path, monkeypatch):
    from jobset_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    (tmp_path / "k.cu").write_text("// one\n")
    first = cuda_build._library_path("k")
    assert first == cuda_build._library_path("k")
    (tmp_path / "k.cu").write_text("// two\n")
    assert cuda_build._library_path("k") != first
    assert first.parent == cuda_build.BUILD_DIR and first.name.startswith("libk-")


def test_missing_nvcc_raises(tmp_path, monkeypatch):
    from jobset_tpu_torch.ops import cuda_build

    monkeypatch.setattr(cuda_build.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_build.nvcc_path()
