"""The port's greedy serving path against the JAX package's.

At f32 the greedy tokens must be identical to JAX `build_generate` on one
CPU device, and the prefill's last-position logits must match the JAX
forward's within 2e-5 (same arithmetic, other summation order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models.decode import build_generate as jax_generate
from jobset_tpu.models.transformer import build_forward as jax_forward
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import transformer as ttf

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


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("max_new", [0, 1, 6])
def test_greedy_tokens_identical_to_jax(n_kv_heads, max_new):
    jcfg, tcfg, jparams, tparams, prompt = _setup(n_kv_heads)
    want = np.asarray(jax_generate(jcfg, _mesh(), max_new)(jparams, jnp.asarray(prompt)))
    got = tdec.build_generate(tcfg, max_new, "cpu")(tparams, torch.from_numpy(prompt))
    assert got.shape == (2, 19 + max_new) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
def test_prefill_logits_match_jax_forward(n_kv_heads):
    # Chunk floor: T = 19 runs one chunk; the blockwise fold over several
    # chunks is covered by test_torch_flash_block.
    jcfg, tcfg, jparams, tparams, prompt = _setup(n_kv_heads, seed=1)
    want = np.asarray(jax_forward(jcfg, _mesh())(jparams, jnp.asarray(prompt)))[:, -1]
    cache = tdec.init_kv_cache(tcfg, 2, 24, "cpu")
    got = tdec._prefill_logits(tparams, torch.from_numpy(prompt), cache, tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **LOGITS_TOL)
    # The cache holds the prompt's positions and nothing after them.
    assert cache["k"].shape == (2, 2, 24, tcfg.kv_heads, 8)
    assert torch.all(cache["k"][:, :, 19:] == 0) and torch.any(cache["k"][:, :, :19] != 0)


def test_cached_step_matches_forward_on_grown_sequence():
    # One decode step through the cache equals the full forward's last
    # position on the sequence grown by that token.
    _, tcfg, _, tparams, prompt = _setup(2, seed=2)
    prompt = torch.from_numpy(prompt)
    cache = tdec.init_kv_cache(tcfg, 2, 20, "cpu")
    first = tdec._pick_token(tdec._prefill_logits(tparams, prompt, cache, tcfg))
    step = tdec._token_logits(tparams, first.to(prompt.dtype), cache, 19, tcfg)
    grown = torch.cat([prompt, first[:, None].to(prompt.dtype)], dim=1)
    full = ttf.build_forward(tcfg, "cpu")(tparams, grown)[:, -1]
    np.testing.assert_allclose(step.numpy(), full.numpy(), **LOGITS_TOL)


def test_prefill_of_1024_tokens_runs_three_flash_blocks_per_layer(monkeypatch):
    # The count chip_smoke.py expects on the card: chunks of 512 give two
    # diagonal blocks (triangle bias) and one below them (zero bias) per
    # layer; decode steps run no flash block.
    from jobset_tpu_torch.ops import flash_block as tfb

    tcfg = ttf.TransformerConfig(vocab_size=64, d_model=16, n_heads=2, d_ff=32, n_layers=2,
                                 dtype=torch.float32)
    params = ttf.init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    prompt = torch.randint(0, 64, (1, 1024), generator=torch.Generator().manual_seed(1))
    calls = []
    real = tfb.block_attention

    def counting(q, k, v, bias, **kw):
        calls.append((q.shape[1], k.shape[1], bool(bias.eq(0).all())))
        return real(q, k, v, bias, **kw)

    monkeypatch.setattr(tfb, "block_attention", counting)
    tdec.build_generate(tcfg, 3, "cpu")(params, prompt)
    assert calls == [(512, 512, False), (512, 512, True), (512, 512, False)] * 2


def test_global_argmax_takes_lowest_index_on_ties():
    logits = torch.tensor([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0]])
    assert tdec._global_argmax(logits).tolist() == [1, 0]


def test_sampling_is_not_ported_yet():
    # The name dates from before sampling was ported: a temperature above 0
    # used to raise. Now it draws a token (test_torch_sampling.py holds the
    # draws to JAX), reproducibly for one generator seed.
    def draw(seed):
        return tdec._pick_token(torch.zeros(1, 4), torch.Generator().manual_seed(seed),
                                temperature=0.7)

    token = draw(0)
    assert token.shape == (1,) and 0 <= int(token) < 4
    assert torch.equal(draw(0), token)


def test_generate_casts_params_once_to_compute_dtype():
    params = {"embed": torch.ones(4, 2), "layers": {"ln1": torch.ones(1, 1, 2) * 1.001},
              "ids": torch.arange(3)}
    cast = tdec.cast_params(params, torch.bfloat16)
    assert cast["embed"].dtype == torch.bfloat16 and cast["ids"].dtype == torch.int64
    # Norm scales are rounded to bf16 as in JAX: 1.001 -> 1.0.
    assert torch.all(cast["layers"]["ln1"].float() == 1.0)


def test_bf16_generate_runs_on_cpu():
    _, tcfg, _, tparams, prompt = _setup(2, seed=3)
    tcfg = ttf.TransformerConfig(**{**tcfg.__dict__, "dtype": torch.bfloat16})
    out = tdec.build_generate(tcfg, 3, "cpu")(tparams, torch.from_numpy(prompt))
    assert out.shape == (2, 22)
    assert torch.all((out >= 0) & (out < 64))
    np.testing.assert_array_equal(out[:, :19].numpy(), prompt)
