"""The port's flash block backward against the JAX package's `_bwd`.

The same numpy inputs and cotangents go through `jax.vjp` of the JAX
`block_attention` (its CPU path, the jnp reference, whose custom_vjp
backward is `_bwd`) and through the port's plain backward,
`block_attention_bwd_reference`, given the block max that the port's
forward returned. The CUDA kernel (`csrc/flash_block_bwd.cu`) is compared
with the plain version on the card (tests/test_torch_cuda.py and
chip_smoke.py); here only its wrapper's checks and dispatch run.

Tolerances are tests/test_torch_train.py's: f32 max|d| <= 1e-5 max|ref| +
1e-6 (the same arithmetic in another summation order); bf16 rtol 2e-2,
atol 1e-1 (both sides round the probabilities, dlogits and dweighted to
bf16 as operands, and a tie in that rounding may fall apart by one bf16
ulp, 2^-8 of the value).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.ops import flash_block as jfb
from jobset_tpu_torch.ops import cuda_build
from jobset_tpu_torch.ops import flash_block as tfb

BF16_TOL = dict(rtol=2e-2, atol=1e-1)
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}
ALL = (True, True, True, True)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _f32_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-5 * ref + 1e-6, f"max|d|={err:.3e}, max|ref|={ref:.3e}"


def _bf16_close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               **BF16_TOL)


def _bias(kind, tq, tk):
    """[Tq, Tk] f32 biases; every kind but "zero" and "masked" has a fully
    masked row (row 3)."""
    rel = np.arange(tq)[:, None] - np.arange(tk)[None, :]
    if kind == "triangle":
        bias = np.where(rel >= 0, 0.0, tfb.NEG_INF)
    elif kind == "zero":
        bias = np.zeros((tq, tk))
    elif kind == "masked":
        bias = np.full((tq, tk), tfb.NEG_INF)
    else:  # "band": non-zero values on a band, masked off it
        bias = np.where(np.abs(rel) <= 6, -0.1 * np.abs(rel), tfb.NEG_INF)
    if kind in ("triangle", "band"):
        bias[3] = tfb.NEG_INF
    return bias.astype(np.float32)


def _case(tq, tk, heads, kv_heads, dim=16, batch=2, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, tq, heads, dim)).astype(np.float32)
    k, v = (rng.standard_normal((batch, tk, kv_heads, dim)).astype(np.float32)
            for _ in range(2))
    dsum = rng.standard_normal((batch, heads, tq)).astype(np.float32)
    dw = rng.standard_normal((batch, tq, heads, dim)).astype(np.float32)
    return q, k, v, dsum, dw


def _port_grads(q, k, v, bias, dsum, dw, tdt, group, shift=0.0, needs=ALL):
    """The port's plain backward given its forward's block max (+ shift),
    with dk and dv summed over the GQA view's group axis."""
    qt, kt, vt = (torch.from_numpy(x).to(tdt) for x in (q, k, v))
    kv = [tfb._repeat_heads(x, group) for x in (kt, vt)]
    biast = torch.from_numpy(bias)
    block_max, _, _ = tfb.block_attention(qt, *kv, biast)
    dq, dk, dv, dbias = tfb.block_attention_bwd_reference(
        qt, *kv, biast, block_max + shift, torch.from_numpy(dsum), torch.from_numpy(dw), needs)
    if group > 1:
        dk, dv = (None if g is None else g.sum(dim=3) for g in (dk, dv))
    return [None if g is None else g.float().numpy() for g in (dq, dk, dv, dbias)], block_max


def _jax_grads(q, k, v, bias, dsum, dw, jdt, group):
    def f(qq, kk, vv, bb):
        return jfb.block_attention(qq, jfb._repeat_heads(kk, group),
                                   jfb._repeat_heads(vv, group), bb)

    args = [jnp.asarray(x).astype(jdt) for x in (q, k, v)] + [jnp.asarray(bias)]
    outs, vjp = jax.vjp(f, *args)
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp((jnp.zeros_like(outs[0]), jnp.asarray(dsum), jnp.asarray(dw)))]


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
@pytest.mark.parametrize("bias_kind", ["triangle", "zero", "masked", "band"])
def test_plain_backward_matches_jax_vjp(dtype_name, heads, bias_kind):
    jdt, tdt = _DTYPES[dtype_name]
    n_heads, kv_heads = heads
    tq, tk = 24, 20  # ragged: neither a multiple of the other
    q, k, v, dsum, dw = _case(tq, tk, n_heads, kv_heads, seed=len(bias_kind))
    bias = _bias(bias_kind, tq, tk)
    got, _ = _port_grads(q, k, v, bias, dsum, dw, tdt, n_heads // kv_heads)
    want = _jax_grads(q, k, v, bias, dsum, dw, jdt, n_heads // kv_heads)
    close = _bf16_close if dtype_name == "bf16" else _f32_close
    for name, g, w in zip(("dq", "dk", "dv", "dbias"), got, want):
        assert g.shape == w.shape, name
        close(g, w)
    if bias_kind in ("triangle", "band"):  # the fully masked row
        assert np.all(got[0][:, 3] == 0.0) and np.all(got[3][3] == 0.0)
    if bias_kind == "masked":
        assert all(np.all(g == 0.0) for g in got)


@pytest.mark.parametrize("needs", [(True, False, False, False), (False, True, True, False),
                                   (False, False, False, True)], ids=["dq", "dk_dv", "dbias"])
def test_plain_backward_computes_what_is_needed(needs):
    q, k, v, dsum, dw = _case(24, 20, 4, 2, seed=3)
    bias = _bias("band", 24, 20)
    part, _ = _port_grads(q, k, v, bias, dsum, dw, torch.float32, 2, needs=needs)
    every, _ = _port_grads(q, k, v, bias, dsum, dw, torch.float32, 2)
    for need, g, w in zip(needs, part, every):
        assert (g is None) != need
        if need:
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shift", [0.75, -1.5])
def test_shifting_the_saved_max_scales_every_gradient(shift):
    # The gauge: P = exp(logits - m) scales by exp(-d) when m moves by d, and
    # every gradient is linear in P, so the backward must read the max it is
    # given (a recomputed max would leave the gradients unchanged).
    q, k, v, dsum, dw = _case(24, 20, 4, 2, seed=4)
    bias = _bias("band", 24, 20)
    base, _ = _port_grads(q, k, v, bias, dsum, dw, torch.float32, 2)
    moved, _ = _port_grads(q, k, v, bias, dsum, dw, torch.float32, 2, shift=shift)
    for g, w in zip(moved, base):
        _f32_close(g, np.exp(-shift) * w)


@pytest.mark.parametrize("given", [True, False], ids=["classes_given", "no_classes"])
def test_block_attention_saves_the_forwards_max_and_classes(given, monkeypatch):
    q, k, v, dsum, dw = _case(64, 64, 2, 2, seed=5)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    bias, classes = tfb.constant_mask("causal", 64, 64, qt.device)
    out = tfb.block_attention(qt, kt, vt, bias, classes=classes if given else None)
    saved = out[0].grad_fn.saved_tensors
    assert torch.equal(saved[4], out[0])
    assert saved[5] is None if not given else torch.equal(saved[5], classes)

    seen = {}
    real = tfb.block_attention_bwd_reference

    def spy(*args):
        seen["block_max"] = args[4]
        return real(*args)

    monkeypatch.setattr(tfb, "block_attention_bwd_reference", spy)
    grads = torch.autograd.grad(out, (qt, kt, vt), grad_outputs=(
        torch.zeros_like(out[0]), torch.from_numpy(dsum), torch.from_numpy(dw)))
    assert torch.equal(seen["block_max"], out[0].detach())
    want = real(qt.detach(), kt.detach(), vt.detach(), bias, out[0].detach(),
                torch.from_numpy(dsum), torch.from_numpy(dw), (True, True, True, False))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)


def _cuda_args(case):
    """Arguments of `_block_attention_bwd_cuda` on CPU tensors, one of them
    wrong for `case`."""
    batch, tq, tk, heads, dim = 1, 8, 12, 2, 16
    q = torch.zeros((batch, tq, heads, dim))
    k = v = torch.zeros((batch, tk, heads, dim))
    bias = torch.zeros((tq, tk))
    block_max, dsum = torch.zeros((batch, heads, tq)), torch.zeros((batch, heads, tq))
    dw = torch.zeros((batch, tq, heads, dim))
    classes = torch.ones((1, 1), dtype=torch.uint8)
    if case == "head_dim":
        q, k, v, dw = (torch.zeros((*t.shape[:3], 136)) for t in (q, k, v, dw))
    elif case == "dtype":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "bias":
        bias = torch.zeros((tq, tk + 1))
    elif case == "block_max":
        block_max = torch.zeros((batch, tq, heads))
    elif case == "dsum":
        dsum = dsum.double()
    elif case == "dweighted":
        dw = torch.zeros((batch, tq, heads, dim + 1))
    elif case == "classes":
        classes = torch.ones((2, 1), dtype=torch.uint8)
    return q, k, v, bias, block_max, classes, dsum, dw, ALL


class _Built(Exception):
    pass


def _no_build(name):
    raise _Built(name)


@pytest.mark.parametrize("case", ["head_dim", "dtype", "bias", "block_max", "dsum",
                                  "dweighted", "classes"])
def test_backward_wrapper_rejects_what_the_kernel_does_not_take(case, monkeypatch):
    # The checks come before the library is built or loaded, so they run
    # here on CPU tensors; the loader is made to fail to show that.
    monkeypatch.setattr(cuda_build, "load", _no_build)
    tfb._backward_library.cache_clear()
    with pytest.raises(ValueError):
        tfb._block_attention_bwd_cuda(*_cuda_args(case))
    with pytest.raises(_Built, match="flash_block_bwd"):  # the same call, all right
        tfb._block_attention_bwd_cuda(*_cuda_args("valid"))
    tfb._backward_library.cache_clear()


def test_cpu_tensors_never_load_the_library_and_other_devices_raise(monkeypatch):
    monkeypatch.setattr(cuda_build, "load", _no_build)
    tfb._library.cache_clear()
    tfb._backward_library.cache_clear()
    q, k, v, dsum, dw = _case(24, 20, 4, 2, seed=6)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfb.block_attention(qt, tfb._repeat_heads(kt, 2), tfb._repeat_heads(vt, 2),
                              torch.from_numpy(_bias("triangle", 24, 20)))
    (out[1].sum() + out[2].sum()).backward()
    assert all(torch.isfinite(x.grad).all() for x in (qt, kt, vt))

    meta = torch.empty((1, 4, 1, 8), device="meta")
    with pytest.raises(ValueError, match="no implementation"):
        tfb._block_attention_bwd(meta, meta, meta, torch.empty((4, 4), device="meta"),
                                 torch.empty((1, 1, 4), device="meta"), None,
                                 torch.empty((1, 1, 4), device="meta"), meta, ALL)


def test_backward_library_path_tracks_its_own_source(tmp_path, monkeypatch):
    # The backward has a library of its own: editing its source rebuilds it
    # and leaves the forward's library, keyed by flash_block.cu alone, as is.
    for name in ("flash_block", "flash_block_bwd"):
        (tmp_path / f"{name}.cu").write_bytes((cuda_build.CSRC / f"{name}.cu").read_bytes())
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    forward, backward = (cuda_build._library_path(n) for n in ("flash_block", "flash_block_bwd"))
    assert backward.name.startswith("libflash_block_bwd-") and backward.parent == cuda_build.BUILD_DIR
    with open(tmp_path / "flash_block_bwd.cu", "a") as f:
        f.write("\n// edited\n")
    assert cuda_build._library_path("flash_block_bwd") != backward
    assert cuda_build._library_path("flash_block") == forward
