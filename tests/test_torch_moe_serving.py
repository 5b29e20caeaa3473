"""The port's mixture-of-experts serving path against the JAX package's.

Small configs on the CPU (vocab 64, d 32, 4 heads, 2 layers, 4 experts,
d_ff_expert 32), f32, parameters from the JAX `init_params` (int8 trees
from JAX's `quantize_params_for_serving`) converted with
`params_from_jax`:

- greedy `generate` tokens equal JAX's for top-k 1, 2 and 4, soft
  dispatch and expert choice, and for top-k 1, 2 and 4 with int8
  weights, the int8 KV cache and both;
- the port's sorted prefill equals its all-experts formulation, also when
  every token goes to the same experts (as `tests/test_decode.py` holds
  the reference's), and top-k with k = E equals soft dispatch;
- `cast_params` leaves the router `wg` in f32;
- `int8_matmul_experts` on the CPU equals each expert's 2-D plain product
  bit for bit, with a shared and a per-expert x.

Tolerances: tokens exact. The two formulations' f32 outputs within
F32_TOL (the same products, summed in another order: a per-expert
segment against all experts weighted by zeros); bf16 within BF16_TOL (one
bf16 rounding of each expert's output, 2^-8 relative, in each).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import quant as jquant
from jobset_tpu.models.decode import build_generate as jax_generate
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import quant as tquant
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import int8_matmul as i8

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
MOE = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, n_experts=4,
           d_ff_expert=32)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _setup(seed=0, **moe):
    base = {**MOE, **moe}
    jcfg = JaxConfig(dtype=jnp.float32, remat=False, **base)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **base)
    jparams = jax_init(jax.random.key(seed), jcfg, _mesh())
    prompt = np.random.default_rng(seed).integers(0, 64, (2, 13)).astype(np.int32)
    return jcfg, tcfg, jparams, prompt


def _tokens(jcfg, tcfg, jparams, prompt, max_new=5, **flags):
    want = np.asarray(jax_generate(jcfg, _mesh(), max_new, **flags)(jparams, jnp.asarray(prompt)))
    got = tdec.build_generate(tcfg, max_new, "cpu", **flags)(
        params_from_jax(jax.tree.map(np.asarray, jparams)), torch.from_numpy(prompt))
    return got.numpy(), want


@pytest.mark.parametrize("moe", [dict(moe_top_k=1), dict(moe_top_k=2),
                                 dict(moe_top_k=2, moe_dispatch="dropless"), dict(moe_top_k=4),
                                 dict(moe_top_k=0), dict(moe_router="expert")],
                         ids=["top1", "top2", "top2_dropless", "top4", "soft", "expert_choice"])
def test_greedy_tokens_identical_to_jax(moe):
    got, want = _tokens(*_setup(**moe))
    assert got.shape == (2, 18)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("top_k", [1, 2, 4])
@pytest.mark.parametrize("quantized,quantized_kv", [(True, False), (False, True), (True, True)],
                         ids=["int8_weights", "int8_cache", "both"])
def test_int8_greedy_tokens_identical_to_jax(quantized, quantized_kv, top_k):
    jcfg, tcfg, jparams, prompt = _setup(seed=1, moe_top_k=top_k)
    if quantized:
        jparams = jquant.quantize_params_for_serving(jparams)
    got, want = _tokens(jcfg, tcfg, jparams, prompt, quantized=quantized,
                        quantized_kv=quantized_kv)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("case", ["spread", "concentrated"])
def test_sorted_prefill_matches_all_experts_formulation(dtype, case):
    jcfg, tcfg, jparams, _ = _setup(seed=3, moe_top_k=2)
    tcfg = dataclasses.replace(tcfg, dtype=dtype)
    layer = {name: a[0, 0] for name, a in
             tdec.cast_params(params_from_jax(jax.tree.map(np.asarray, jparams)), dtype)
             ["layers"].items()}
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 9, 32))
    if case == "concentrated":  # one ragged group pair holds every slot
        x = np.broadcast_to(x[:1, :1], x.shape) + 1e-3 * x
    xn = torch.from_numpy(x.astype(np.float32))
    sorted_out = tdec._moe_mlp_topk_sorted(layer, xn, tcfg)
    dense_out = tdec._moe_mlp_topk_decode(layer, xn, tcfg)
    assert sorted_out.dtype == dense_out.dtype == dtype
    np.testing.assert_allclose(sorted_out.float().numpy(), dense_out.float().numpy(),
                               **(F32_TOL if dtype == torch.float32 else BF16_TOL))


def test_topk_equals_soft_dispatch_when_k_is_all_experts():
    prompt = torch.from_numpy(np.random.default_rng(2).integers(0, 64, (2, 5)).astype(np.int32))
    outs = []
    for top_k in (0, 4):
        jcfg, tcfg, jparams, _ = _setup(seed=2, moe_top_k=top_k)
        params = params_from_jax(jax.tree.map(np.asarray, jparams))
        outs.append(tdec.build_generate(tcfg, 4, "cpu")(params, prompt))
    assert torch.equal(outs[0], outs[1])


def test_cast_params_keeps_the_router_in_f32():
    _, tcfg, jparams, _ = _setup(moe_top_k=2)
    params = params_from_jax(jax.tree.map(np.asarray, jparams))
    cast = tdec.cast_params(params, torch.bfloat16)
    assert cast["layers"]["wg"].dtype == torch.float32
    assert torch.equal(cast["layers"]["wg"], params["layers"]["wg"])
    assert cast["layers"]["we1"].dtype == cast["layers"]["we2"].dtype == torch.bfloat16
    q = tdec.cast_params(tquant.quantize_params_for_serving(params), torch.bfloat16)
    assert q["layers"]["wg"].dtype == torch.float32
    assert q["layers"]["we1"].q.dtype == torch.int8 and q["layers"]["we1"].scale.dtype == torch.float32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("shared", [True, False], ids=["shared_x", "expert_x"])
def test_int8_experts_on_cpu_equal_each_experts_2d_product(dtype, shared):
    gen = torch.Generator().manual_seed(4)
    qt = tquant.quantize_int8(torch.randn((3, 40, 24), generator=gen))
    x = torch.randn((1 if shared else 3, 5, 40), generator=gen).to(dtype)
    got = i8.int8_matmul_experts(x, qt, dtype)
    assert got.shape == (3, 5, 24) and got.dtype == dtype
    for e in range(3):
        one = tquant.QuantizedTensor(qt.q[e], qt.scale[e])
        want = i8.int8_matmul(x[0 if shared else e], one, dtype)
        assert torch.equal(got[e], want)
