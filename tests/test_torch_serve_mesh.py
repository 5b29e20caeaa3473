"""The port's serving over a dp x tp mesh against the JAX package's
`build_generate` on the virtual CPU mesh, f32, at (tp 2) here; (dp 2) in
tests/test_torch_serve_mesh_dp.py and (dp 2, tp 2) in
tests/test_torch_serve_mesh_dp_tp.py, so that each file stays short.

Each rank serves its dp rows of the prompt with its shards of the JAX
`init_params` tree (converted with `params_from_jax`, quantized whole
for int8 weights, then cut by `shard_params`), on one gang of processes
(gloo) a mesh. What is held:
- greedy tokens identical to JAX's for dense GQA, tied embeddings and MoE
  top-2 (the sorted prefill, the all-experts decode step), each in f32,
  with int8 weights, with the int8 cache, and with both; every tp rank
  returns the same tokens;
- sampled tokens identical to JAX's under the same Gumbel noise (one
  rank-shaped array [B / dp, V / tp] given to every draw of both
  packages: `jax.random.gumbel` patched for the test, the port's
  `decode._gumbel` in each rank), top_k 0 and 3;
- the reference's properties: top_k = 1 is greedy over the sharded vocab;
  all-tied logits at tp 2 with top_k 2 admit exactly the indices {0, 1};
  each rank draws noise of its own (the dp and tp files);
- `build_generate` raises on pp, sp or ep above 1, as the reference;
- a sharded int8 tree equals the reference's quantized global tree cut by
  `quantize_specs`, bit for bit, each shard contiguous.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import decode as jdec
from jobset_tpu.models import quant as jquant
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.convert import params_from_jax, shard_params
from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import quant as tquant
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.parallel.mesh import Mesh, MeshConfig as TorchMeshConfig
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies

BASE = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2)
MODELS = {"gqa": dict(n_kv_heads=2), "tied": dict(tie_embeddings=True),
          "moe": dict(n_experts=4, d_ff_expert=32, moe_top_k=2)}
# (int8 weights, int8 cache)
VARIANTS = {"f32": (False, False), "int8": (True, False), "int8 cache": (False, True),
            "int8 both": (True, True)}
GREEDY = [f"{model} {variant}" for model in MODELS for variant in VARIANTS]
BATCH, PROMPT, NEW = 4, 7, 5
SAMPLED_TOP_K = (0, 3)
TEMPERATURE = 0.9


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_cfg(model):
    return JaxConfig(dtype=jnp.float32, remat=False, **BASE, **MODELS[model])


def _prompt(seed=1):
    return np.random.default_rng(seed).integers(0, BASE["vocab_size"],
                                                (BATCH, PROMPT)).astype(np.int32)


def _noise(dp, tp):
    """One rank-shaped Gumbel draw [B / dp, V / tp]."""
    return np.random.default_rng(11).gumbel(
        size=(BATCH // dp, BASE["vocab_size"] // tp)).astype(np.float32)


def _run(model, mesh_shape, params, **extra):
    return dict(config=dict(BASE, **MODELS[model], dtype="float32"), mesh=mesh_shape,
                params=params, prompt=_prompt(), max_new=NEW, **extra)


def gang_runs(dp, tp, sampled=False):
    """JAX's tokens of every greedy case on the (dp, tp) mesh (and, with
    `sampled`, of the sampled cases under the same noise), and each rank's
    port results of one gang. The port's runs beside them: top_k 1 at a
    temperature (held to greedy) and a sampled run that keeps each rank's
    noise."""
    mesh = build_mesh(MeshConfig(dp=dp, tp=tp), allow_submesh=True)
    shape = {"dp": dp, "tp": tp}
    want, runs_ = {}, {}
    params = {model: jtf.init_params(jax.random.key(0), _jax_cfg(model), mesh)
              for model in MODELS}
    numpy_params = {model: jax.tree.map(np.asarray, p) for model, p in params.items()}
    for name in GREEDY:
        model, variant = name.split(" ", 1)
        weights, cache = VARIANTS[variant]
        p = jquant.quantize_params_for_serving(params[model]) if weights else params[model]
        want[name] = np.asarray(jdec.build_generate(
            _jax_cfg(model), mesh, NEW, quantized=weights, quantized_kv=cache)(
                p, jnp.asarray(_prompt())))
        runs_[name] = _run(model, shape, numpy_params[model], quantized=weights,
                           quantized_kv=cache)
    if sampled:
        noise = _noise(dp, tp)
        real = jax.random.gumbel
        jax.random.gumbel = lambda key, shape_, dtype: jnp.asarray(noise)
        try:
            for top_k in SAMPLED_TOP_K:
                want[f"sampled top_k {top_k}"] = np.asarray(jdec.build_generate(
                    _jax_cfg("gqa"), mesh, NEW, temperature=TEMPERATURE, top_k=top_k)(
                        params["gqa"], jnp.asarray(_prompt()), jax.random.key(3)))
                runs_[f"sampled top_k {top_k}"] = _run(
                    "gqa", shape, numpy_params["gqa"], temperature=TEMPERATURE, top_k=top_k,
                    noise=noise)
        finally:
            jax.random.gumbel = real
    runs_["top_k 1"] = _run("gqa", shape, numpy_params["gqa"], temperature=1.7, top_k=1,
                            seed=7)
    runs_["own noise"] = _run("gqa", shape, numpy_params["gqa"], temperature=TEMPERATURE,
                              seed=5, record_noise=True)
    ranks = gang.spawn(bodies.serve_runs, dp * tp, (runs_, "cpu"), device="cpu",
                       timeout_s=180)
    return want, ranks


def gathered_tokens(ranks, name):
    """The global tokens from the tp-rank-0 ranks' dp rows, in dp order."""
    mine = sorted((r[name]["coords"]["dp"], r[name]["tokens"]) for r in ranks
                  if r[name]["coords"]["tp"] == 0)
    return np.concatenate([tokens for _, tokens in mine])


def check_tokens(runs, name):
    want, ranks = runs
    got = gathered_tokens(ranks, name)
    assert got.shape == (BATCH, PROMPT + NEW)
    np.testing.assert_array_equal(got[:, :PROMPT], _prompt())
    np.testing.assert_array_equal(got, want[name])
    for r in ranks:  # every tp rank returns its dp rows' tokens
        same = [o for o in ranks if o[name]["coords"]["dp"] == r[name]["coords"]["dp"]]
        np.testing.assert_array_equal(r[name]["tokens"], same[0][name]["tokens"])


def check_top_k_one_is_greedy(runs):
    _, ranks = runs
    np.testing.assert_array_equal(gathered_tokens(ranks, "top_k 1"),
                                  gathered_tokens(ranks, "gqa f32"))


def check_own_noise(runs):
    """Each rank drew its own noise: no two ranks' first draws are equal,
    and the sampled tokens are the same on every tp rank of a dp row."""
    _, ranks = runs
    draws = [r["own noise"]["noise"] for r in ranks]
    for i in range(len(draws)):
        for j in range(i):
            assert not np.array_equal(draws[i], draws[j]), (i, j)
    for r in ranks:
        for o in ranks:
            if o["own noise"]["coords"]["dp"] == r["own noise"]["coords"]["dp"]:
                np.testing.assert_array_equal(o["own noise"]["tokens"], r["own noise"]["tokens"])


DP, TP = 1, 2


@pytest.fixture(scope="module")
def runs():
    return gang_runs(DP, TP, sampled=True)


@pytest.mark.parametrize("name", GREEDY)
def test_greedy_tokens_match_jax(runs, name):
    check_tokens(runs, name)


@pytest.mark.parametrize("top_k", SAMPLED_TOP_K)
def test_sampled_tokens_match_jax_under_the_same_noise(runs, top_k):
    check_tokens(runs, f"sampled top_k {top_k}")
    # The noise moved the picks off the greedy path somewhere.
    assert not np.array_equal(runs[0][f"sampled top_k {top_k}"], runs[0]["gqa f32"])


def test_top_k_one_equals_greedy_over_the_sharded_vocab(runs):
    check_top_k_one_is_greedy(runs)


def test_each_tp_rank_draws_its_own_noise(runs):
    check_own_noise(runs)


def test_top_k_keeps_exactly_k_on_ties_across_shards():
    logits = np.full((3, 16), 9.0, np.float32)  # every logit tied
    ranks = gang.spawn(bodies.pick_draws, 2, (logits, 2, 1.3, list(range(40)), "cpu"),
                       device="cpu", timeout_s=120)
    assert ranks[0] == ranks[1]  # the pick is the same on both tp ranks
    seen = {token for draw in ranks[0] for token in draw}
    assert seen == {0, 1}, seen  # only the two lowest indices, both reachable


@pytest.mark.parametrize("axis", ["pp", "sp", "ep"])
def test_generate_rejects_training_mesh_axes(axis):
    cfg = ttf.TransformerConfig(dtype=torch.float32, **BASE, n_experts=4, d_ff_expert=32)
    mesh = Mesh.at(TorchMeshConfig(**{axis: 2}), 0)
    with pytest.raises(ValueError, match=f"{axis}=1"):
        tdec.build_generate(cfg, 2, "cpu", mesh=mesh)


def _cut(a, spec, mesh_config, coords):
    """The block of the global numpy array `a` that a rank at `coords`
    holds under the PartitionSpec `spec`."""
    index = []
    for dim, axis in enumerate(tuple(spec) + (None,) * (a.ndim - len(spec))):
        n = getattr(mesh_config, axis) if axis else 1
        size = a.shape[dim] // n
        start = coords[axis] * size if axis else 0
        index.append(slice(start, start + size))
    return a[tuple(index)]


@pytest.mark.parametrize("model", ["gqa", "moe"])
@pytest.mark.parametrize("mesh_shape", [{"tp": 2}, {"dp": 2, "tp": 2}, {"ep": 2, "tp": 2}],
                         ids=["tp2", "dp2_tp2", "ep2_tp2"])
def test_sharded_int8_tree_equals_the_reference_cut_by_quantize_specs(model, mesh_shape):
    jcfg = _jax_cfg(model)
    jmesh = build_mesh(MeshConfig(**mesh_shape), allow_submesh=True)
    jparams = jtf.init_params(jax.random.key(0), jcfg, jmesh)
    jq = jquant.quantize_params_for_serving(jparams)
    jspecs = jax.tree.leaves(jquant.quantize_specs(jtf.param_specs(jcfg)),
                             is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    tcfg = ttf.TransformerConfig(dtype=torch.float32, **BASE, **MODELS[model])
    full_f32 = params_from_jax(jax.tree.map(np.asarray, jparams))
    full = tquant.quantize_params_for_serving(full_f32)
    # The port's spec tree is the reference's, entry for entry.
    assert [tuple(s) for s in jspecs] == tree.leaves(tquant.quantize_specs(
        ttf.param_specs(tcfg)))
    config = TorchMeshConfig(**mesh_shape)
    for rank in range(config.num_devices):
        mesh = Mesh.at(config, rank)
        local = shard_params(full, tcfg, mesh)
        want = [_cut(np.asarray(a), spec, config, mesh.coords)
                for a, spec in zip(jax.tree.leaves(jq), jspecs)]
        got = tree.leaves(local)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert g.is_contiguous() and g.shape == w.shape
            np.testing.assert_array_equal(g.numpy().view(np.uint8), w.view(np.uint8))
        assert isinstance(local["layers"]["wo"], tquant.QuantizedTensor)
        # The trap: wo's rows split over tp, so a scale taken from one rank's
        # rows is another scale than the reference's.
        rows = tquant.quantize_int8(shard_params(full_f32, tcfg, mesh)["layers"]["wo"])
        assert not torch.equal(rows.scale, local["layers"]["wo"].scale)


@pytest.mark.parametrize("model", ["gqa", "moe"])
def test_a_mesh_of_one_rank_computes_what_no_mesh_computes_bit_for_bit(model):
    """Every axis at size 1 (`single_device_mesh`, no process group): the
    forward's logits and the greedy, sampled and int8 tokens are those of
    the one-device path, bit for bit."""
    from jobset_tpu_torch.parallel.mesh import single_device_mesh

    cfg = ttf.TransformerConfig(dtype=torch.bfloat16, **BASE, **MODELS[model])
    params = ttf.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    qparams = tquant.quantize_params_for_serving(params)
    prompt = torch.from_numpy(_prompt())
    one = single_device_mesh()
    want = ttf.build_forward(cfg, "cpu")(params, prompt)
    got = ttf.build_forward(cfg, "cpu", one)(params, prompt)
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))
    for kw, p in ((dict(), params), (dict(temperature=0.8, top_k=3), params),
                  (dict(quantized=True, quantized_kv=True), qparams)):
        want = tdec.build_generate(cfg, NEW, "cpu", **kw)(p, prompt)
        got = tdec.build_generate(cfg, NEW, "cpu", mesh=one, **kw)(p, prompt)
        assert torch.equal(got, want), kw
