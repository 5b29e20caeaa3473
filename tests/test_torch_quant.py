"""The port's int8 serving (weights and KV cache) against the JAX package's.

At f32 on the CPU: `quantize_int8` and `weight_cast` equal JAX bit for
bit; a JAX-quantized tree converted with `params_from_jax` equals the
port's quantization of the converted f32 tree; the int8 KV cache after the
prefill and a step equals JAX's `_cache_write` of the same values, bit for
bit; the forward with int8 parameters matches JAX's within the decode
tests' LOGITS_TOL (same arithmetic, another summation order); and greedy
tokens with int8 weights, the int8 cache, and both, are JAX's.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import decode as jdec
from jobset_tpu.models import quant as jquant
from jobset_tpu.models.transformer import build_forward as jax_forward
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import quant as tquant
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import int8_matmul as i8

LOGITS_TOL = dict(rtol=1e-5, atol=2e-5)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _setup(n_kv_heads, seed=0):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=n_kv_heads,
                d_ff=64, n_layers=2)
    jcfg = JaxConfig(dtype=jnp.float32, remat=False, **base)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **base)
    jparams = jax_init(jax.random.key(seed), jcfg, _mesh())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(seed).integers(0, 64, (2, 19)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt


def _weights(seed, shape):
    """Weights with an all-zero channel, exact .5 ties of q and values at
    the clip edge, in f32."""
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal(shape) * 0.05).astype(np.float32)
    w[..., 0] = 0.0  # an all-zero output channel (axis -2 reduced)
    w[..., 0, :] = 0.0  # and an all-zero row (axis -1 reduced)
    # Column 1: absmax 127 * 0.25 = 31.75, so the scale is exactly 0.25 and
    # w / scale hits every .5 tie in range, both signs.
    col = w[..., 1]
    col[...] = (np.arange(col.shape[-1]) % 9 - 4 + 0.5) * 0.25
    col[..., -1] = 31.75
    return w


def _bits(t):
    return t.numpy().view(np.uint8) if t.dtype != torch.bfloat16 else t.view(torch.int16).numpy()


@pytest.mark.parametrize("axis", [-2, -1])
@pytest.mark.parametrize("shape", [(64, 48), (3, 40, 24)])
def test_quantize_int8_equals_jax_bit_for_bit(axis, shape):
    w = _weights(1, shape)
    want = jquant.quantize_int8(jnp.asarray(w), axis=axis)
    got = tquant.quantize_int8(torch.from_numpy(w), axis=axis)
    assert got.q.dtype == torch.int8 and got.scale.dtype == torch.float32
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(_bits(got.scale), np.asarray(want.scale).view(np.uint8))
    # The ties were there, rounded half to even, and the zero channel has
    # the floor scale and zero values.
    if axis == -2:
        assert set(np.asarray(want.q)[..., :-1, 1].ravel()) >= {-4, -2, 0, 2, 4}
        assert np.all(got.q.numpy()[..., 0] == 0)
        np.testing.assert_array_equal(got.scale.numpy()[..., 0],
                                      np.float32(np.float32(1e-12) / np.float32(127.0)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_cast_equals_jax_bit_for_bit(dtype):
    w = _weights(2, (2, 48, 40))
    jt = jquant.quantize_int8(jnp.asarray(w))
    want = np.asarray(jquant.weight_cast(jt, jnp.dtype(dtype)))
    tt = tquant.quantize_int8(torch.from_numpy(w))
    got = tquant.weight_cast(tt, getattr(torch, dtype))
    if dtype == "bfloat16":
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), want.view(np.int16))
    else:
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
    # A plain tensor is a plain cast.
    assert torch.equal(tquant.weight_cast(torch.from_numpy(w), torch.float32),
                       torch.from_numpy(w))


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_converted_jax_quantized_tree_equals_port_quantization(n_kv_heads):
    _, _, jparams, tparams, _ = _setup(n_kv_heads)
    jq = jquant.quantize_params_for_serving(jparams)
    got = params_from_jax(jax.tree.map(np.asarray, jq))
    want = tquant.quantize_params_for_serving(tparams)
    got_leaves, want_leaves = tree.leaves(got), tree.leaves(want)
    assert len(got_leaves) == len(want_leaves) == len(jax.tree.leaves(jq))
    for a, b in zip(got_leaves, want_leaves):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    quantized = {name for name, v in got["layers"].items()
                 if isinstance(v, tquant.QuantizedTensor)}
    assert quantized == {"wq", "wk", "wv", "wo", "w1", "w2"}
    assert isinstance(got["unembed"], tquant.QuantizedTensor)
    assert got["layers"]["wq"].scale.shape == (1, 2, 1, 32)


def test_quantized_tensor_slices_and_tree_round_trip():
    qt = tquant.quantize_int8(torch.from_numpy(_weights(3, (1, 2, 16, 8))))
    layer = qt[0, 1]
    assert layer.shape == (16, 8) and layer.scale.shape == (1, 8)
    assert torch.equal(layer.q, qt.q[0, 1]) and layer.q.data_ptr() == qt.q[0, 1].data_ptr()
    params = {"layers": {"wq": qt, "ln1": torch.ones(1, 2, 16)}, "embed": torch.zeros(4, 16)}
    leaves = tree.leaves(params)
    assert [t.dtype for t in leaves] == [torch.float32, torch.float32, torch.int8, torch.float32]
    back = tree.rebuild(params, leaves)
    assert isinstance(back["layers"]["wq"], tquant.QuantizedTensor)
    assert back["layers"]["wq"].q is qt.q and back["layers"]["wq"].scale is qt.scale
    moved = tree.tree_map(lambda t: t.clone(), params)
    assert torch.equal(moved["layers"]["wq"].q, qt.q)


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_int8_forward_matches_jax(n_kv_heads):
    jcfg, tcfg, jparams, tparams, prompt = _setup(n_kv_heads, seed=1)
    want = np.asarray(jax_forward(jcfg, _mesh())(jquant.quantize_params_for_serving(jparams),
                                                 jnp.asarray(prompt)))
    got = ttf.build_forward(tcfg, "cpu")(tquant.quantize_params_for_serving(tparams),
                                         torch.from_numpy(prompt))
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("quantized,quantized_kv", [(True, False), (False, True), (True, True)],
                         ids=["int8", "int8_kv", "int8_both"])
@pytest.mark.parametrize("max_new", [0, 1, 6])
def test_int8_greedy_tokens_identical_to_jax(n_kv_heads, quantized, quantized_kv, max_new):
    jcfg, tcfg, jparams, tparams, prompt = _setup(n_kv_heads)
    if quantized:
        jparams = jquant.quantize_params_for_serving(jparams)
        tparams = tquant.quantize_params_for_serving(tparams)
    flags = dict(quantized=quantized, quantized_kv=quantized_kv)
    want = np.asarray(jdec.build_generate(jcfg, _mesh(), max_new, **flags)(
        jparams, jnp.asarray(prompt)))
    got = tdec.build_generate(tcfg, max_new, "cpu", **flags)(tparams, torch.from_numpy(prompt))
    assert got.shape == (2, 19 + max_new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_kv_cache_after_prefill_and_a_step_equals_jax_cache_write():
    # The port's cache (written in place by the prefill and one step) holds
    # what JAX's _cache_write puts there for the same K/V values.
    _, tcfg, _, tparams, prompt = _setup(2, seed=2)
    prompt = torch.from_numpy(prompt)
    cache = tdec.init_kv_cache(tcfg, 2, 24, "cpu", quantized_kv=True)
    assert torch.all(cache["k"].q == 0) and torch.all(cache["k"].scale == 1)
    written = []
    real = tdec._cache_write

    def recording(part, value, pos):
        written.append((value.clone(), pos))
        return real(part, value, pos)

    tdec._cache_write = recording
    try:
        first = tdec._pick_token(tdec._prefill_logits(tparams, prompt, cache, tcfg))
        tdec._token_logits(tparams, first.to(prompt.dtype), cache, 19, tcfg)
    finally:
        tdec._cache_write = real
    # Per layer: k and v of the prefill (pos 0), then k and v of the step.
    assert [pos for _, pos in written] == [0, 0] * 2 + [19, 19] * 2
    for name, offset in (("k", 0), ("v", 1)):
        for layer in range(2):
            want = jquant.QuantizedTensor(
                q=jnp.zeros((2, 24, tcfg.kv_heads, 8), jnp.int8),
                scale=jnp.ones((2, 24, tcfg.kv_heads, 1), jnp.float32))
            for value, pos in (written[2 * layer + offset], written[4 + 2 * layer + offset]):
                want = jdec._cache_write(want, jnp.asarray(value.numpy()), pos)
            got = cache[name][layer]
            np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
            np.testing.assert_array_equal(got.scale.numpy().view(np.uint32),
                                          np.asarray(want.scale).view(np.uint32))
    # Positions after the step are still unwritten: they read as 0.
    assert torch.all(tdec._cache_read(cache["k"], torch.float32)[:, :, 20:] == 0)


def test_quantized_flag_must_match_the_parameters():
    _, tcfg, _, tparams, prompt = _setup(0)
    prompt = torch.from_numpy(prompt)
    with pytest.raises(ValueError, match="quantize_params_for_serving"):
        tdec.build_generate(tcfg, 2, "cpu", quantized=True)(tparams, prompt)
    with pytest.raises(ValueError, match="quantized=False"):
        tdec.build_generate(tcfg, 2, "cpu")(tquant.quantize_params_for_serving(tparams), prompt)


def test_cast_params_keeps_quantized_tensors_whole():
    qparams = tquant.quantize_params_for_serving(
        {"unembed": torch.randn(8, 4, generator=torch.Generator().manual_seed(0)),
         "embed": torch.ones(4, 8)})
    cast = tdec.cast_params(qparams, torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16
    assert cast["unembed"].q.dtype == torch.int8 and cast["unembed"].scale.dtype == torch.float32
    assert cast["unembed"].q is qparams["unembed"].q


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 8, 16, 40])
def test_int8_matmul_on_cpu_is_the_plain_product(dtype, rows):
    gen = torch.Generator().manual_seed(rows)
    qt = tquant.quantize_int8(torch.randn(48, 40, generator=gen))
    x = torch.randn(rows, 48, generator=gen)
    want = x.to(dtype) @ tquant.weight_cast(qt, dtype)
    before = i8.INT8_LAUNCHES
    got = tquant.matmul(x.reshape(1, rows, 48), qt, dtype)
    assert got.shape == (1, rows, 40) and got.dtype == dtype
    assert torch.equal(got[0], want) and i8.INT8_LAUNCHES == before


def test_int8_matmul_refuses_other_devices():
    qt = tquant.quantize_int8(torch.randn(8, 8))
    with pytest.raises(ValueError, match="no implementation"):
        i8.int8_matmul(torch.zeros(2, 8, device="meta"), qt, torch.float32)
