"""The port's single-device forward against the JAX package's.

Parameters come from the JAX `init_params` on a one-device mesh and pass
through `params_from_jax`, so both packages run the same numbers.
Tolerances: f32 2e-5 absolute (same arithmetic, other summation order);
bf16 0.1 absolute plus 2e-2 relative on logits of magnitude up to ~5,
where one bf16 ulp is 2^-5 = 0.031 and the two frameworks round at other
places (XLA fuses elementwise bf16 chains in f32, PyTorch rounds each op).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.entry import entry
from jobset_tpu_torch.models import transformer as ttf

F32_TOL = dict(rtol=1e-5, atol=2e-5)
BF16_TOL = dict(rtol=2e-2, atol=1e-1)
_DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _configs(dtype_name, **kw):
    jdt, tdt = _DTYPES[dtype_name]
    base = dict(vocab_size=128, d_model=64, n_heads=4, d_ff=128, n_layers=2, **kw)
    return JaxConfig(dtype=jdt, remat=False, **base), ttf.TransformerConfig(dtype=tdt, **base)


def _jax_params(cfg, seed=0):
    params = jax_init(jax.random.key(seed), cfg, _mesh())
    return params, params_from_jax(jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("dtype_name", ["f32", "bf16"])
@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
def test_forward_matches_jax(dtype_name, variant):
    kw = {"mha": {}, "gqa": {"n_kv_heads": 2}, "tied": {"tie_embeddings": True}}[variant]
    jcfg, tcfg = _configs(dtype_name, **kw)
    jparams, tparams = _jax_params(jcfg)
    tokens = np.random.default_rng(1).integers(0, 128, (2, 40)).astype(np.int32)

    want = jtf.build_forward(jcfg, _mesh())(jparams, jnp.asarray(tokens))
    got = ttf.build_forward(tcfg, "cpu")(tparams, torch.from_numpy(tokens))
    assert got.shape == (2, 40, 128) and got.dtype == tcfg.dtype
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want.astype(jnp.float32)),
        **(BF16_TOL if dtype_name == "bf16" else F32_TOL),
    )


def test_norm_and_rotary_match_jax():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, 3, 8)).astype(np.float32)
    scale = rng.standard_normal(8).astype(np.float32)
    pos = np.arange(7, dtype=np.float32) + 3
    np.testing.assert_allclose(
        ttf.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-6).numpy(),
        np.asarray(jtf.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-6)), **F32_TOL)
    np.testing.assert_allclose(
        ttf.rotary(torch.from_numpy(x), torch.from_numpy(pos), 10000.0).numpy(),
        np.asarray(jtf.rotary(jnp.asarray(x), jnp.asarray(pos), 10000.0)), **F32_TOL)


def test_init_params_shapes_and_scaling():
    _, tcfg = _configs("f32", n_kv_heads=2)
    jcfg, _ = _configs("f32", n_kv_heads=2)
    jparams = jax.tree.map(np.asarray, jax_init(jax.random.key(0), jcfg, _mesh()))
    tparams = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")

    def shapes(tree):
        return {k: shapes(v) if isinstance(v, dict) else tuple(v.shape) for k, v in tree.items()}

    assert shapes(tparams) == shapes(jparams)
    # normal / sqrt(fan_in): wo has fan_in h*dh = 64, w2 fan_in d_ff = 128.
    assert abs(tparams["layers"]["wo"].std().item() - 64 ** -0.5) < 0.02
    assert abs(tparams["layers"]["w2"].std().item() - 128 ** -0.5) < 0.02
    assert torch.all(tparams["layers"]["ln1"] == 1.0)


def test_entry_on_cpu():
    fn, (params, tokens) = entry(device="cpu")
    logits = fn(params, tokens)
    assert logits.shape == (2, 64, 256) and logits.dtype == torch.bfloat16
    assert torch.isfinite(logits.float()).all()


def test_entry_config_matches_jax_entry():
    import __graft_entry__

    jfn, (jparams, jtokens) = __graft_entry__.entry()
    fn, _ = entry(device="cpu")
    want = np.asarray(jfn(jparams, jtokens).astype(jnp.float32))
    got = fn(params_from_jax(jax.tree.map(np.asarray, jparams)),
             torch.from_numpy(np.array(jtokens)))
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


@pytest.mark.parametrize("bad, match", [
    (dict(n_experts=4, moe_top_k=8), "MoE"),
    (dict(attn_impl="striped"), "attn_impl"),
    (dict(n_heads=3), "divide"),
    (dict(d_model=512, n_heads=2), "head_dim"),
    (dict(n_kv_heads=3), "n_kv_heads"),
])
def test_validate_rejects_unported_settings(bad, match):
    cfg = ttf.TransformerConfig(**{**dict(d_model=64, n_heads=4), **bad})
    with pytest.raises((ValueError, NotImplementedError), match=match):
        cfg.validate()


@pytest.mark.parametrize("axis", ["dp", "tp", "sp", "pp", "ep"])
def test_validate_rejects_mesh_axes(axis):
    """Every axis runs (tests/test_torch_tp.py, tests/test_torch_pp_train.py,
    tests/test_torch_sp_train.py, tests/test_torch_ep_train.py), with tp,
    pp, ep and Ulysses' sp held to the reference's divisibility rules."""
    ttf.TransformerConfig().validate({axis: 2})
    if axis in ("dp", "tp", "sp", "pp"):
        if axis == "pp":
            with pytest.raises(ValueError, match="not divisible by pp 2"):
                ttf.TransformerConfig(n_layers=3).validate({axis: 2})
            with pytest.raises(ValueError, match="pipeline_virtual"):
                ttf.TransformerConfig(pipeline_schedule="interleaved", pipeline_virtual=3,
                                      n_layers=4).validate({axis: 2})
        if axis == "tp":
            with pytest.raises(ValueError, match="not divisible by tp 3"):
                ttf.TransformerConfig().validate({axis: 3})
        if axis == "sp":
            ttf.TransformerConfig(attn_impl="ulysses").validate({axis: 2})
            with pytest.raises(ValueError, match="ulysses attention requires heads-per-tp-rank"):
                ttf.TransformerConfig(attn_impl="ulysses").validate({axis: 16})
        return
    moe = ttf.TransformerConfig(n_experts=4, moe_top_k=2)
    moe.validate({axis: 4})
    with pytest.raises(ValueError, match="n_experts 4 must be divisible by ep 8"):
        moe.validate({axis: 8})
