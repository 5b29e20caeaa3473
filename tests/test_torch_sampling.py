"""The port's sampled decoding against the JAX package's.

JAX's threefry bits cannot be matched, so sampling is held to JAX two ways:
- with the same Gumbel noise fed to both packages (`jax.random.gumbel`
  replaced for the length of one test, the port's `_gumbel` likewise), the
  sampled tokens are identical at f32, for several top_k;
- on properties: top_k=1 is greedy; tied logits admit exactly k
  candidates, the lowest indices; the draws' frequencies follow the
  softmax (300 draws, as `tests/test_decode.py` checks JAX's).
`run_decode_bench` on the CPU returns the reference's keys.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig, init_params as jax_init
from jobset_tpu.models import decode as jdec
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu.runtime.model_bench import run_decode_bench as jax_decode_bench
from jobset_tpu_torch.convert import params_from_jax
from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.runtime.model_bench import run_decode_bench


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _mesh():
    return build_mesh(MeshConfig(), jax.devices()[:1])


def _setup(n_kv_heads, seed=0, prompt_len=19):
    base = dict(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=n_kv_heads,
                d_ff=64, n_layers=2)
    jcfg = JaxConfig(dtype=jnp.float32, remat=False, **base)
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **base)
    jparams = jax_init(jax.random.key(seed), jcfg, _mesh())
    tparams = params_from_jax(jax.tree.map(np.asarray, jparams))
    prompt = np.random.default_rng(seed).integers(0, 64, (2, prompt_len)).astype(np.int32)
    return jcfg, tcfg, jparams, tparams, prompt


@pytest.mark.parametrize("n_kv_heads", [0, 2], ids=["mha", "gqa"])
@pytest.mark.parametrize("top_k", [0, 3, 100])
def test_sampled_tokens_identical_to_jax_under_the_same_noise(monkeypatch, n_kv_heads, top_k):
    jcfg, tcfg, jparams, tparams, prompt = _setup(n_kv_heads, seed=5)
    # One noise draw [B, V], given to every pick of both packages (JAX
    # traces its decode step once, so a fixed array is what it can take).
    noise = np.random.default_rng(11).gumbel(size=(2, 64)).astype(np.float32)
    monkeypatch.setattr(jax.random, "gumbel", lambda key, shape, dtype: jnp.asarray(noise))
    monkeypatch.setattr(tdec, "_gumbel", lambda gen, shape, device: torch.from_numpy(noise))
    want = np.asarray(jdec.build_generate(jcfg, _mesh(), 6, temperature=0.7, top_k=top_k)(
        jparams, jnp.asarray(prompt), jax.random.key(3)))
    got = tdec.build_generate(tcfg, 6, "cpu", temperature=0.7, top_k=top_k)(
        tparams, torch.from_numpy(prompt))
    np.testing.assert_array_equal(got.numpy(), want)
    # The noise moved the picks off the greedy path somewhere.
    greedy = tdec.build_generate(tcfg, 6, "cpu")(tparams, torch.from_numpy(prompt))
    assert not torch.equal(got, greedy)


def test_top_k_one_equals_greedy():
    _, tcfg, _, tparams, prompt = _setup(2, seed=2, prompt_len=5)
    prompt = torch.from_numpy(prompt)
    greedy = tdec.build_generate(tcfg, 6, "cpu")(tparams, prompt)
    sampled = tdec.build_generate(tcfg, 6, "cpu", temperature=1.7, top_k=1)(
        tparams, prompt, torch.Generator().manual_seed(7))
    assert torch.equal(sampled, greedy)


def test_topk_keeps_exactly_k_on_ties():
    logits = torch.full((3, 16), 9.0)  # every logit tied
    seen = set()
    for seed in range(40):
        toks = tdec._pick_token(logits, torch.Generator().manual_seed(seed), 1.3, 2)
        seen.update(toks.tolist())
    assert seen == {0, 1}, seen  # only the two lowest indices, both reachable


def _top_k_mask_numpy(logits, k):
    keep = np.zeros(logits.shape, bool)
    for row, out in zip(logits, keep):
        order = sorted(range(len(row)), key=lambda i: (-row[i], i))[:k]
        out[order] = True
    return keep


@pytest.mark.parametrize("k", [1, 2, 5, 16, 40])
def test_top_k_mask_takes_the_k_largest_lowest_index_first(k):
    # bf16-rounded logits: many ties, some straddling the k-th value.
    rng = np.random.default_rng(k)
    logits = torch.from_numpy(rng.standard_normal((6, 24)).astype(np.float32))
    logits = logits.to(torch.bfloat16).float().round(decimals=1)
    got = tdec._top_k_mask(logits, k)
    want = _top_k_mask_numpy(logits.numpy(), min(k, 24))
    np.testing.assert_array_equal(got.numpy(), want)
    assert torch.all(got.sum(-1) == min(k, 24))


def test_oversized_top_k_samples_the_full_vocab():
    logits = torch.zeros(2, 8)
    noise = torch.arange(16, dtype=torch.float32).reshape(2, 8)
    real = tdec._gumbel
    tdec._gumbel = lambda gen, shape, device: noise
    try:
        assert tdec._pick_token(logits, None, 1.0, 100).tolist() == [7, 7]
        assert tdec._pick_token(logits, None, 1.0, 3).tolist() == [2, 2]
    finally:
        tdec._gumbel = real


def test_sampling_frequencies_track_softmax():
    _, tcfg, _, tparams, _ = _setup(0, seed=0)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(0, 64, (1, 4)).astype(np.int32))
    logits = ttf.build_forward(tcfg, "cpu")(tparams, prompt)[0, -1].double().numpy()
    probs = np.exp(logits - logits.max())
    probs /= probs.sum()
    gen = tdec.build_generate(tcfg, 1, "cpu", temperature=1.0)
    picks = [int(gen(tparams, prompt, torch.Generator().manual_seed(s))[0, -1])
             for s in range(300)]
    freq = np.bincount(picks, minlength=64) / len(picks)
    assert probs[np.argmax(freq)] > 0.5 * probs.max()
    assert np.corrcoef(freq, probs)[0, 1] > 0.7


def test_default_generator_is_seeded():
    _, tcfg, _, tparams, prompt = _setup(2, seed=4)
    prompt = torch.from_numpy(prompt)
    gen = tdec.build_generate(tcfg, 8, "cpu", temperature=1.0, top_k=8)
    first, again = gen(tparams, prompt), gen(tparams, prompt)
    assert torch.equal(first, again)
    assert torch.equal(first, gen(tparams, prompt, torch.Generator().manual_seed(0)))
    assert not torch.equal(first, gen(tparams, prompt, torch.Generator().manual_seed(1)))


def test_gumbel_noise_is_standard_gumbel():
    g = tdec._gumbel(torch.Generator().manual_seed(0), (20000,), "cpu").double()
    assert torch.isfinite(g).all()
    assert abs(g.mean().item() - 0.5772) < 0.03  # Euler-Mascheroni
    assert abs(g.var().item() - np.pi ** 2 / 6) < 0.1


def test_run_decode_bench_on_cpu_returns_the_reference_keys():
    base = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2, max_seq_len=32)
    want = jax_decode_bench(batch=2, prompt_len=8, max_new_tokens=4,
                            config=JaxConfig(dtype=jnp.float32, **base), measure_ttft=True)
    got = run_decode_bench(batch=2, prompt_len=8, max_new_tokens=4,
                           config=ttf.TransformerConfig(dtype=torch.float32, **base),
                           measure_ttft=True, device="cpu")
    assert set(got) == set(want)
    assert got["backend"] == "cpu" and got["device_kind"] == "cpu"
    assert got["decode_tokens_per_sec"] > 0 and got["ttft_ms"] > 0
    assert got["quantized"] is False and got["quantized_kv"] is False
    for key in ("batch", "prompt_len", "max_new_tokens", "params_m"):
        assert got[key] == want[key], key
    q = run_decode_bench(batch=2, prompt_len=8, max_new_tokens=4,
                         config=ttf.TransformerConfig(dtype=torch.float32, **base),
                         quantized=True, device="cpu")
    assert q["quantized"] is True and q["quantized_kv"] is True and "ttft_ms" not in q
