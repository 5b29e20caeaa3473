"""The port's mixture-of-experts forward against the JAX package's.

Small configs on the CPU (vocab 64, d 32, 4 heads, 2 layers, 4 experts,
d_ff_expert 32), f32 unless a test says otherwise, parameters from the
JAX `init_params` converted with `params_from_jax`:

- `renormalized_topk` picks as `lax.top_k` does, exact ties to the lower
  expert index, with the same weights;
- `sorted_ragged_expert_ffn` equals the JAX function under uniform, skewed
  (one expert takes every slot) and empty-group routings, in f32 and bf16,
  with the same group sizes;
- every forward router (soft dispatch, capacity with and without drops,
  dropless, expert choice) through `build_forward`, and its balancing
  statistics, against JAX's;
- the config's MoE rules, the parameter tree, and the FLOP accounting.

Tolerances: f32 logits within LOGITS_TOL (the same arithmetic in another
summation order: XLA's dot against torch's, f64 router products rounded
to f32 against f32 ones); bf16 expert products within BF16_TOL (both sum
in f32 and round once to bf16; another order moves a result by one bf16
ulp, 2^-8 relative, and the combine adds two such).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import quant as jquant
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu.runtime import model_bench as jbench
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import quant as tquant
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import grouped_matmul as gm
from jobset_tpu_torch.runtime import model_bench as tbench

LOGITS_TOL = dict(rtol=1e-5, atol=2e-5)
F32_TOL = dict(rtol=1e-5, atol=1e-6)
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


def _configs(**moe):
    base = {**MOE, **moe}
    return (JaxConfig(dtype=jnp.float32, remat=False, **base),
            ttf.TransformerConfig(dtype=torch.float32, **base))


def _params(jcfg, seed=0):
    jparams = jax_init(jax.random.key(seed), jcfg, _mesh())
    return jparams, params_from_jax(jax.tree.map(np.asarray, jparams))


def _layer0(tree):
    return {name: a[0, 0] for name, a in tree["layers"].items()}


# --- routing ----------------------------------------------------------------


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_renormalized_topk_equals_jax(k):
    rng = np.random.default_rng(k)
    gates = rng.dirichlet(np.ones(4), size=(3, 7)).astype(np.float32)
    want_w, want_i = jtf.renormalized_topk(jnp.asarray(gates), k)
    got_w, got_i = ttf.renormalized_topk(torch.from_numpy(gates), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **F32_TOL)


@pytest.mark.parametrize("k", [1, 2, 3])
def test_renormalized_topk_breaks_exact_ties_to_the_lower_index(k):
    # Rows of exact ties: all four equal, a tie above and below the cut,
    # and a tie that straddles it.
    gates = np.array([[0.25, 0.25, 0.25, 0.25],
                      [0.1, 0.4, 0.1, 0.4],
                      [0.3, 0.2, 0.3, 0.2],
                      [0.0, 0.5, 0.0, 0.5],
                      [0.2, 0.2, 0.4, 0.2]], dtype=np.float32)
    want_w, want_i = jtf.renormalized_topk(jnp.asarray(gates), k)
    got_w, got_i = ttf.renormalized_topk(torch.from_numpy(gates), k)
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
    np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))
    if k == 2:
        assert got_i[0].tolist() == [0, 1] and got_i[4].tolist() == [2, 0]


def test_router_product_is_the_f32_product_rounded_once():
    # f64 products of f32 inputs are exact, so the router's logits are the
    # exact sums rounded once to f32: within half an f32 ulp of the f64
    # reference, and never a TF32-rounded value.
    rng = np.random.default_rng(5)
    x = rng.standard_normal((64, 256)).astype(np.float32)
    wg = rng.standard_normal((256, 8)).astype(np.float32)
    got = ttf._router_logits(torch.from_numpy(x), torch.from_numpy(wg)).numpy()
    exact = x.astype(np.float64) @ wg.astype(np.float64)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, exact.astype(np.float32))


# --- the sorted ragged core ---------------------------------------------------


def _routing(case, n, k, experts, rng):
    """(top_w, top_i) [n, k] for a routing case."""
    if case == "uniform":
        top_i = np.stack([rng.permutation(experts)[:k] for _ in range(n)])
    elif case == "skewed":  # one expert takes every slot
        top_i = np.full((n, k), 2)
    else:  # "empty": experts 1 and 2 get nothing
        top_i = np.tile(np.array([3, 0][:k]), (n, 1))
    top_w = rng.dirichlet(np.ones(k), size=n)
    return top_w.astype(np.float32), top_i.astype(np.int32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case,k", [("uniform", 2), ("uniform", 3), ("skewed", 1),
                                    ("empty", 2), ("empty", 1)])
def test_sorted_ragged_expert_ffn_equals_jax(case, k, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg, tcfg = _configs(moe_top_k=k)
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=jdt), dataclasses.replace(tcfg, dtype=tdt)
    jparams, tparams = _params(jcfg, seed=3)
    rng = np.random.default_rng(11)
    n = 21
    x = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)
    top_w, top_i = _routing(case, n, k, jcfg.n_experts, rng)
    want, want_sizes = jtf.sorted_ragged_expert_ffn(
        jax.tree.map(lambda a: a[0, 0], jparams["layers"]), jnp.asarray(x), jnp.asarray(top_w),
        jnp.asarray(top_i), jcfg)
    got, sizes = ttf.sorted_ragged_expert_ffn(
        _layer0(tparams), torch.from_numpy(x), torch.from_numpy(top_w),
        torch.from_numpy(top_i).long(), tcfg)
    assert sizes.dtype == torch.int32 and got.dtype == torch.float32
    np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


def test_sorted_ragged_combine_gives_the_same_bits_twice():
    _, tcfg = _configs(moe_top_k=3)
    _, tparams = _params(_configs(moe_top_k=3)[0], seed=4)
    rng = np.random.default_rng(12)
    x = torch.from_numpy(rng.standard_normal((33, 32)).astype(np.float32))
    top_w, top_i = (torch.from_numpy(a) for a in _routing("uniform", 33, 3, 4, rng))
    a, _ = ttf.sorted_ragged_expert_ffn(_layer0(tparams), x, top_w, top_i.long(), tcfg)
    b, _ = ttf.sorted_ragged_expert_ffn(_layer0(tparams), x, top_w, top_i.long(), tcfg)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("sizes", [[5, 0, 7, 3], [15, 0, 0, 0], [0, 0, 0, 0], [2, 3, 0, 4]])
def test_grouped_matmul_plain_multiplies_each_segment_by_its_expert(sizes):
    # [2, 3, 0, 4] leaves 6 of the 15 rows past the last group: zeros, as
    # lax.ragged_dot leaves them.
    rng = np.random.default_rng(sum(sizes))
    xs = rng.standard_normal((15, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12, 10)).astype(np.float32)
    got = gm.grouped_matmul(torch.from_numpy(xs), torch.from_numpy(w),
                            torch.tensor(sizes, dtype=torch.int32))
    want = np.asarray(jax.lax.ragged_dot(jnp.asarray(xs), jnp.asarray(w),
                                         jnp.asarray(sizes, jnp.int32)))
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    if sum(sizes) < 15:
        assert torch.all(got[sum(sizes):] == 0)


# --- the forward's routers ----------------------------------------------------


ROUTERS = {
    "soft": dict(moe_top_k=0),
    "capacity": dict(moe_top_k=2, moe_capacity_factor=8.0),
    "capacity_drops": dict(moe_top_k=2, moe_capacity_factor=0.5),
    "dropless": dict(moe_top_k=2, moe_dispatch="dropless"),
    "dropless_k1": dict(moe_top_k=1, moe_dispatch="dropless"),
    "expert_choice": dict(moe_router="expert"),
}


@pytest.mark.parametrize("router", list(ROUTERS))
def test_forward_matches_jax(router):
    jcfg, tcfg = _configs(**ROUTERS[router])
    jparams, tparams = _params(jcfg)
    tokens = np.random.default_rng(0).integers(0, 64, (2, 19)).astype(np.int32)
    want = np.asarray(jtf.build_forward(jcfg, _mesh())(jparams, jnp.asarray(tokens)))
    got = ttf.build_forward(tcfg, "cpu")(tparams, torch.from_numpy(tokens))
    assert got.shape == (2, 19, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)


def _jax_layer_mlp(fn, jcfg, layer, xn):
    mesh = _mesh()
    return jax.jit(jax.shard_map(lambda v: fn(layer, v, jcfg), mesh=mesh, in_specs=jax.P(),
                                 out_specs=(jax.P(), jax.P()), check_vma=False))(xn)


@pytest.mark.parametrize("router,jax_fn,port_fn", [
    ("capacity_drops", "_moe_mlp_routed", "_moe_mlp_routed"),
    ("dropless", "_moe_mlp_dropless", "_moe_mlp_dropless"),
    ("expert_choice", "_moe_mlp_expert_choice", "_moe_mlp_expert_choice"),
])
def test_router_outputs_and_balancing_stats_match_jax(router, jax_fn, port_fn):
    jcfg, tcfg = _configs(**ROUTERS[router])
    jparams, tparams = _params(jcfg, seed=2)
    xn = np.random.default_rng(2).standard_normal((2, 9, 32)).astype(np.float32)
    want_out, want_stats = _jax_layer_mlp(getattr(jtf, jax_fn), jcfg,
                                          jax.tree.map(lambda a: a[0, 0], jparams["layers"]),
                                          jnp.asarray(xn))
    out, stats = getattr(ttf, port_fn)(_layer0(tparams), torch.from_numpy(xn), tcfg)
    assert stats.shape == (2, ttf.aux_stat_width(tcfg)) == np.asarray(want_stats).shape
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), **F32_TOL)
    np.testing.assert_allclose(stats.numpy(), np.asarray(want_stats), **F32_TOL)


# --- the config, the tree, the accounting ------------------------------------


def test_validate_takes_the_flagship_moe_config():
    cfg = ttf.TransformerConfig(vocab_size=32000, d_model=1024, n_heads=16, n_layers=8,
                                n_experts=8, moe_top_k=2, d_ff_expert=4096,
                                moe_dispatch="dropless")
    cfg.validate()


@pytest.mark.parametrize("bad", [
    dict(moe_router="nope"), dict(n_experts=0, moe_router="expert"),
    dict(n_experts=0, moe_top_k=2), dict(moe_dispatch="nope"),
    dict(moe_dispatch="dropless"), dict(moe_dispatch="dropless", moe_top_k=2, moe_router="expert"),
    dict(moe_top_k=5),
])
def test_validate_applies_the_reference_moe_rules(bad):
    settings = {**MOE, **bad}
    with pytest.raises(ValueError) as port:
        ttf.TransformerConfig(**settings).validate()
    with pytest.raises(ValueError):
        JaxConfig(**settings).validate(MeshConfig())
    assert "moe" in str(port.value).lower() or "expert" in str(port.value).lower()


def test_param_tree_and_conversion_keep_the_expert_leaves():
    jcfg, tcfg = _configs(moe_top_k=2)
    jparams, tparams = _params(jcfg)
    shapes = {k: tuple(v[0]) for k, v in ttf.param_shapes(tcfg)["layers"].items()}
    assert shapes["wg"] == (1, 2, 32, 4) and shapes["we1"] == (1, 2, 4, 32, 32)
    assert shapes["we2"] == (1, 2, 4, 32, 32) and "w1" not in shapes
    for name, a in tparams["layers"].items():
        assert tuple(a.shape) == shapes[name] == np.asarray(jparams["layers"][name]).shape
    port_init = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in port_init["layers"].items()} == shapes
    # The int8 tree: JAX's QuantizedTensors arrive whole, with one scale per
    # expert and column, equal bit for bit to the port's own quantization.
    qj = params_from_jax(jax.tree.map(np.asarray, jquant.quantize_params_for_serving(jparams)))
    qt = tquant.quantize_params_for_serving(tparams)
    for name in ("we1", "we2"):
        a, b = qj["layers"][name], qt["layers"][name]
        assert isinstance(a, tquant.QuantizedTensor) and a.q.dtype == torch.int8
        assert tuple(a.scale.shape) == (1, 2, 4, 1, a.q.shape[-1])
        assert torch.equal(a.q, b.q) and torch.equal(a.scale, b.scale)
    assert not isinstance(qt["layers"]["wg"], tquant.QuantizedTensor)


@pytest.mark.parametrize("moe", [dict(), dict(moe_top_k=2), dict(moe_top_k=2, moe_dispatch="dropless"),
                                 dict(moe_router="expert"), dict(n_experts=0)])
def test_flop_accounting_equals_the_reference(moe):
    settings = {**dict(vocab_size=32000, d_model=1024, n_heads=16, n_layers=8, n_experts=8,
                       d_ff_expert=4096, d_ff=4096), **moe}
    jcfg, tcfg = JaxConfig(**settings), ttf.TransformerConfig(**settings)
    assert tbench.matmul_param_count(tcfg) == jbench.matmul_param_count(jcfg)
    active = tbench.active_param_count(tcfg)
    want_active = None
    if jcfg.n_experts and jcfg.moe_top_k and jcfg.moe_router == "token":
        want_active = jbench.matmul_param_count(jcfg) - jcfg.n_layers * (
            jcfg.n_experts - jcfg.moe_top_k) * jbench.expert_ffn_params(jcfg)
    assert active == want_active
    assert tbench.train_flops_per_token(tcfg, 1024, active) == jbench.train_flops_per_token(
        jcfg, 1024, active_params=want_active)
