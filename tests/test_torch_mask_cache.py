"""The constant-mask cache of the flash block's callers, on the CPU.

`flash_block.constant_mask(kind, tq, tk, device)` builds the main path's
masks (the causal triangle and the zero bias) once per key with their tile
classes, and `blockwise_causal_attention` and `ring_attention` hand both to
`block_attention(..., classes=...)`. These tests hold the cache to the
functions it replaces (`causal_bias`, `torch.zeros`, `tile_classes_reference`)
and the callers to their per-call-mask behaviour, bit for bit: on the CPU
the plain version computes the same function from the same bias, whether
or not it is given classes. The card's side (the kernel given classes
against the call that computes them) is in tests/test_torch_cuda.py and
chip_smoke.py.
"""

import numpy as np
import pytest
import torch

from jobset_tpu_torch.ops import flash_block as tfb
from jobset_tpu_torch.parallel import ring_attention

CPU = torch.device("cpu")
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _per_call_mask(kind, tq, tk, device):
    """What the callers built before the cache: a fresh mask each call, no
    classes (the call computes them)."""
    if kind == "causal":
        return tfb.causal_bias(tq, device), None
    return torch.zeros((tq, tk), dtype=torch.float32, device=device), None


def _qkv(batch, t, heads, kv_heads, dim, dtype, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((batch, t, heads, dim), dtype=np.float32)
    k, v = (rng.standard_normal((batch, t, kv_heads, dim), dtype=np.float32) for _ in range(2))
    return [torch.from_numpy(x).to(dtype) for x in (q, k, v)]


def _outputs_and_grads(fn, inputs, seed):
    """fn's output and the gradients of a fixed random projection of it
    with respect to every input."""
    xs = [x.clone().requires_grad_() for x in inputs]
    out = fn(*xs)
    cot = torch.from_numpy(np.random.default_rng(seed).standard_normal(out.shape,
                                                                       dtype=np.float32))
    grads = torch.autograd.grad((out.float() * cot).sum(), xs)
    return out.detach(), grads


def _assert_identical(a, b):
    (out_a, grads_a), (out_b, grads_b) = a, b
    assert torch.equal(out_a, out_b)
    for ga, gb in zip(grads_a, grads_b):
        assert ga.dtype == gb.dtype and torch.equal(ga, gb)


@pytest.mark.parametrize("key", [("causal", 64, 64), ("causal", 130, 130), ("zero", 64, 64),
                                 ("zero", 100, 37)], ids=lambda k: f"{k[0]}-{k[1]}x{k[2]}")
def test_cache_returns_the_same_tensors_for_one_key(key):
    bias, classes = tfb.constant_mask(*key, CPU)
    again = tfb.constant_mask(*key, CPU)
    assert again[0] is bias and again[1] is classes


def test_cache_keeps_kinds_and_shapes_apart():
    keys = [("causal", 64, 64), ("zero", 64, 64), ("causal", 65, 65), ("zero", 64, 65),
            ("zero", 65, 64)]
    pairs = [tfb.constant_mask(*key, CPU) for key in keys]
    assert len({id(bias) for bias, _ in pairs}) == len(keys)
    assert len({id(classes) for _, classes in pairs}) == len(keys)
    for (kind, tq, tk), (bias, classes) in zip(keys, pairs):
        assert tuple(bias.shape) == (tq, tk)
        assert tuple(classes.shape) == (-(-tq // 64), -(-tk // 64))


@pytest.mark.parametrize("kind, tq, tk", [("causal", 1, 1), ("causal", 63, 63),
                                          ("causal", 512, 512), ("causal", 200, 200),
                                          ("zero", 1, 1), ("zero", 512, 512),
                                          ("zero", 77, 130)])
def test_cached_mask_equals_a_fresh_mask(kind, tq, tk):
    bias, classes = tfb.constant_mask(kind, tq, tk, CPU)
    want = (tfb.causal_bias(tq, CPU) if kind == "causal"
            else torch.zeros((tq, tk), dtype=torch.float32))
    assert bias.dtype == torch.float32 and bias.device == CPU and torch.equal(bias, want)
    assert classes.dtype == torch.uint8 and torch.equal(classes,
                                                        tfb.tile_classes_reference(want))


@pytest.mark.parametrize("kind, tq, tk", [("causal", 64, 65), ("triangle", 64, 64)])
def test_constant_mask_refuses_what_it_does_not_build(kind, tq, tk):
    with pytest.raises(ValueError, match="constant_mask"):
        tfb.constant_mask(kind, tq, tk, CPU)


def test_cache_is_bounded():
    for n in range(1, tfb.MASK_CACHE_SIZE + 5):
        tfb.constant_mask("zero", n, 3, CPU)
    info = tfb.constant_mask.cache_info()
    assert info.maxsize == tfb.MASK_CACHE_SIZE and info.currsize <= tfb.MASK_CACHE_SIZE


def test_masks_built_under_inference_mode_serve_a_training_step():
    tfb.constant_mask.cache_clear()
    with torch.inference_mode():
        bias, _ = tfb.constant_mask("causal", 24, 24, CPU)
    assert not bias.is_inference()
    q, k, v = _qkv(1, 24, 2, 2, 8, torch.float32, seed=1)
    out, grads = _outputs_and_grads(ring_attention, (q, k, v), seed=2)
    assert all(bool(torch.isfinite(g).all()) for g in grads)


@pytest.mark.parametrize("gqa", [False, True], ids=["mha", "gqa"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_blockwise_attention_with_the_cache_equals_per_call_masks(dtype_name, causal, gqa,
                                                                  monkeypatch):
    # T = 100 in chunks of 32: diagonal triangles of 32 and of the ragged 4,
    # zero blocks of [32, 32] and [4, 32].
    inputs = _qkv(2, 100, 4, 2 if gqa else 4, 16, DTYPES[dtype_name], seed=3)

    def run(*xs):
        return tfb.blockwise_causal_attention(*xs, chunk=32, causal=causal)

    cached = _outputs_and_grads(run, inputs, seed=4)
    monkeypatch.setattr(tfb, "constant_mask", _per_call_mask)
    _assert_identical(cached, _outputs_and_grads(run, inputs, seed=4))


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_ring_attention_with_the_cache_equals_per_call_masks(dtype_name, causal,
                                                             monkeypatch):
    inputs = _qkv(2, 70, 4, 2, 16, DTYPES[dtype_name], seed=5)

    def run(*xs):
        return ring_attention(*xs, causal=causal)

    cached = _outputs_and_grads(run, inputs, seed=6)
    monkeypatch.setattr(tfb, "constant_mask", _per_call_mask)
    _assert_identical(cached, _outputs_and_grads(run, inputs, seed=6))


@pytest.mark.parametrize("kind", ["causal", "zero"])
@pytest.mark.parametrize("dtype_name", list(DTYPES))
def test_block_attention_given_classes_equals_the_call_without(dtype_name, kind):
    q, k, v = _qkv(2, 96, 4, 4, 16, DTYPES[dtype_name], seed=7)
    bias, classes = tfb.constant_mask(kind, 96, 96, CPU)
    cot = [torch.from_numpy(np.random.default_rng(8).standard_normal(s, dtype=np.float32))
           for s in ((2, 4, 96), (2, 96, 4, 16))]

    def run(**kw):
        xs = [x.clone().requires_grad_() for x in (q, k, v)] + [bias.clone().requires_grad_()]
        outs = tfb.block_attention(*xs, **kw)
        grads = torch.autograd.grad(outs[1:], xs, grad_outputs=cot)
        return [o.detach() for o in outs], grads

    (outs, grads), (outs_given, grads_given) = run(), run(classes=classes)
    for a, b in zip(outs + list(grads), outs_given + list(grads_given)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_a_training_pass_leaves_the_cached_tensors_unchanged():
    tfb.constant_mask.cache_clear()
    pairs = [tfb.constant_mask("causal", 40, 40, CPU), tfb.constant_mask("zero", 40, 40, CPU),
             tfb.constant_mask("causal", 16, 16, CPU), tfb.constant_mask("zero", 8, 16, CPU),
             tfb.constant_mask("zero", 16, 16, CPU), tfb.constant_mask("causal", 8, 8, CPU)]
    before = [(t.clone(), t._version) for pair in pairs for t in pair]
    q, k, v = _qkv(1, 40, 2, 1, 8, torch.float32, seed=9)
    _outputs_and_grads(ring_attention, (q, k, v), seed=10)
    _outputs_and_grads(lambda *xs: tfb.blockwise_causal_attention(*xs, chunk=16),
                       (q, k, v), seed=11)
    after = [t for pair in pairs for t in pair]
    for (want, version), got in zip(before, after):
        assert torch.equal(got, want) and got._version == version


@pytest.mark.parametrize("case", ["shape", "dtype", "layout"])
def test_kernel_wrapper_rejects_classes_it_cannot_read(case):
    # Checked before the library is built or loaded, so on CPU tensors.
    q = k = v = torch.zeros((1, 70, 2, 8))
    bias, classes = tfb.constant_mask("causal", 70, 70, CPU)
    classes = {"shape": classes[:1], "dtype": classes.int(),
               "layout": classes.t().contiguous().t()}[case]
    with pytest.raises(ValueError, match="classes"):
        tfb._block_attention_cuda(q, k, v, bias, classes)
