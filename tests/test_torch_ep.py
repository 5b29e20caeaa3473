"""Expert parallelism's pieces on the CPU, against the JAX package where it
has them:

- `sorted_ragged_expert_ffn`'s local-experts form, `(ep_idx, e_local)`,
  against JAX's for every ep rank at ep 2 and 4 (uniform, skewed and
  empty-group routings, top-1 and top-2, f32 and bf16): the same partial
  output and group sizes, and the ranks' partials add up to the ep = 1
  result;
- the reference's forced all-foreign case (`tests/test_transformer.py`'s
  `test_dropless_ep_empty_local_group_exact`): every slot on expert 0, so
  rank 1's groups are empty and its partial is exactly 0, and the sum is
  the hand-computed dense FFN;
- the grouped products' plain versions with a foreign tail (rows past
  the last group): forward and dgrad write exact zeros there, wgrad reads
  none of them (another finite fill changes no covered output or weight
  gradient by a bit), each against `lax.ragged_dot` and its VJP;
- the config's rule that ep divides the experts, and the routed paths'
  refusal of a token count ep does not divide (the reference's message);
- over a gang (gloo): the mesh's (ep, tp) and (dp, sp, ep) groups; at
  ep 2 and 4, `collectives.gather`'s forward against
  `lax.all_gather(tiled)` and its backward (this rank's slice of a whole
  cotangent), the all_to_all of the capacity path's [ep, e_local, C, d]
  buffers.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig as JaxMeshConfig
from jobset_tpu.parallel.mesh import build_mesh as jax_build_mesh
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import grouped_matmul as gm
from jobset_tpu_torch.parallel import mesh as tmesh
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_gang_runner import JOIN_S, _check_layouts
from test_torch_moe import BF16_TOL, F32_TOL, _configs, _params, _routing

P = jax.sharding.PartitionSpec


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _local(layer: dict, ep_idx: int, e_local: int) -> dict:
    """A layer's parameters with this ep rank's experts of we1 and we2."""
    cut = slice(ep_idx * e_local, (ep_idx + 1) * e_local)
    return dict(layer, we1=layer["we1"][cut], we2=layer["we2"][cut])


# --- the sorted ragged core's local-experts form ------------------------------


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ep", [2, 4])
@pytest.mark.parametrize("case,k", [("uniform", 2), ("skewed", 1), ("empty", 2)])
def test_local_experts_form_equals_jax_on_every_rank(case, k, ep, dtype):
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "f32" else (jnp.bfloat16, torch.bfloat16)
    jcfg, tcfg = _configs(moe_top_k=k)
    jcfg, tcfg = dataclasses.replace(jcfg, dtype=jdt), dataclasses.replace(tcfg, dtype=tdt)
    jparams, tparams = _params(jcfg, seed=5)
    jlayer = jax.tree.map(lambda a: a[0, 0], jparams["layers"])
    tlayer = {name: a[0, 0] for name, a in tparams["layers"].items()}
    rng = np.random.default_rng(13)
    n, e_local = 21, jcfg.n_experts // ep
    x = rng.standard_normal((n, jcfg.d_model)).astype(np.float32)
    top_w, top_i = _routing(case, n, k, jcfg.n_experts, rng)
    args = (torch.from_numpy(x), torch.from_numpy(top_w), torch.from_numpy(top_i).long(), tcfg)
    whole, _ = ttf.sorted_ragged_expert_ffn(tlayer, *args)
    total = torch.zeros_like(whole)
    for ep_idx in range(ep):
        want, want_sizes = jtf.sorted_ragged_expert_ffn(
            _local(jlayer, ep_idx, e_local), jnp.asarray(x), jnp.asarray(top_w),
            jnp.asarray(top_i), jcfg, local_experts=(ep_idx, e_local))
        got, sizes = ttf.sorted_ragged_expert_ffn(_local(tlayer, ep_idx, e_local), *args,
                                                  local_experts=(ep_idx, e_local))
        assert sizes.dtype == torch.int32 and tuple(sizes.shape) == (e_local,)
        np.testing.assert_array_equal(sizes.numpy(), np.asarray(want_sizes))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **(F32_TOL if dtype == "f32" else BF16_TOL))
        total += got
    # A slot's expert lives on one rank: the partials add up to ep = 1's
    # (each token's k products on their ranks, the combine's adds aside).
    np.testing.assert_allclose(total.numpy(), whole.numpy(),
                               **(F32_TOL if dtype == "f32" else BF16_TOL))


def test_dropless_all_foreign_rank_gives_an_exact_zero_part():
    """Every top-1 slot forced onto expert 0 (positive activations, router
    columns +1 and -1): at ep 2 rank 1's group is empty, every slot of its
    is foreign, and its partial output is exactly 0; rank 0's is the dense
    FFN of expert 0, as the reference's layer gives it under shard_map,
    and the pooled statistics (whole / ep on each rank) count every slot
    on expert 0."""
    d, f, n_tok = 16, 8, 12
    rng = np.random.default_rng(4)
    xn = np.abs(rng.standard_normal((1, n_tok, d))).astype(np.float32) + 0.1
    wg = np.stack([np.ones(d), -np.ones(d)], axis=1).astype(np.float32)
    we1 = rng.standard_normal((2, d, f)).astype(np.float32)
    we2 = rng.standard_normal((2, f, d)).astype(np.float32)
    jcfg, tcfg = _configs(d_model=d, n_experts=2, d_ff_expert=f, moe_top_k=1,
                          moe_dispatch="dropless")
    mesh = jax_build_mesh(JaxMeshConfig(ep=2), allow_submesh=True)
    want_out, want_stats = jax.jit(jax.shard_map(
        lambda p, x: jtf._moe_mlp_dropless(p, x, jcfg), mesh=mesh,
        in_specs=({"wg": P(), "we1": P("ep"), "we2": P("ep")}, P()),
        out_specs=(P(), P()), check_vma=False))(
            {"wg": jnp.asarray(wg), "we1": jnp.asarray(we1), "we2": jnp.asarray(we2)},
            jnp.asarray(xn))
    x = torch.from_numpy(xn.reshape(n_tok, d))
    layer = {"wg": torch.from_numpy(wg), "we1": torch.from_numpy(we1),
             "we2": torch.from_numpy(we2)}
    top_w, top_i = ttf.renormalized_topk(ttf._router_gates(x, layer["wg"]), 1)
    parts = [ttf.sorted_ragged_expert_ffn(_local(layer, r, 1), x, top_w, top_i, tcfg, (r, 1))
             for r in range(2)]
    assert parts[0][1].tolist() == [n_tok] and parts[1][1].tolist() == [0]
    assert torch.equal(parts[1][0], torch.zeros_like(parts[1][0]))
    expected = torch.nn.functional.silu(x @ layer["we1"][0]) @ layer["we2"][0]
    np.testing.assert_allclose(parts[0][0].numpy(), expected.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose((parts[0][0] + parts[1][0]).numpy(),
                               np.asarray(want_out).reshape(n_tok, d), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(want_stats)[0] * 2, [n_tok, 0.0], atol=1e-6)


# --- the grouped products with a foreign tail ----------------------------------


@pytest.mark.parametrize("sizes", [[5, 0, 3], [0, 0, 0], [9, 2, 0], [1, 1, 1]])
def test_plain_grouped_products_with_a_foreign_tail(sizes):
    """M = 20 rows, e_local = 3 groups covering sum(sizes) of them; the
    rest is an ep rank's foreign tail."""
    m, k, n = 20, 12, 10
    covered = sum(sizes)
    rng = np.random.default_rng(covered + 7)
    xs = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((3, k, n)).astype(np.float32)
    dy = rng.standard_normal((m, n)).astype(np.float32)
    dy[covered:] = 0.0  # the combine's zeroed weights: no cotangent past the groups
    gs = torch.tensor(sizes, dtype=torch.int32)
    t = torch.from_numpy
    y = gm.grouped_matmul_plain(t(xs), t(w), gs)
    dxs = gm.grouped_matmul_dgrad_plain(t(dy), t(w), gs)
    dw = gm.grouped_matmul_wgrad_plain(t(xs), t(dy), gs)
    assert torch.all(y[covered:] == 0) and torch.all(dxs[covered:] == 0)
    # Another finite fill of the tail moves no covered output, no bit.
    xs2, dy2 = xs.copy(), dy.copy()
    xs2[covered:], dy2[covered:] = 1e3, -7.0
    assert torch.equal(gm.grouped_matmul_plain(t(xs2), t(w), gs)[:covered], y[:covered])
    assert torch.equal(gm.grouped_matmul_dgrad_plain(t(dy2), t(w), gs)[:covered],
                       dxs[:covered])
    assert torch.equal(gm.grouped_matmul_wgrad_plain(t(xs2), t(dy2), gs), dw)
    # Against lax.ragged_dot and its VJP (covered rows; JAX's tail is its own).
    jgs = jnp.asarray(sizes, jnp.int32)
    want_y, vjp = jax.vjp(lambda a, b: jax.lax.ragged_dot(a, b, jgs), jnp.asarray(xs),
                          jnp.asarray(w))
    want_dxs, want_dw = vjp(jnp.asarray(dy))
    np.testing.assert_allclose(y[:covered].numpy(), np.asarray(want_y)[:covered], **F32_TOL)
    np.testing.assert_allclose(dxs[:covered].numpy(), np.asarray(want_dxs)[:covered], **F32_TOL)
    np.testing.assert_allclose(dw.numpy(), np.asarray(want_dw), **F32_TOL)


# --- validation -----------------------------------------------------------------


@pytest.mark.parametrize("mesh, ok", [({"ep": 2}, True), ({"ep": 4, "tp": 2}, True),
                                      ({"ep": 3}, False), ({"ep": 8}, False)])
def test_validate_requires_ep_to_divide_the_experts(mesh, ok):
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_experts=4,
                                d_ff_expert=32, moe_top_k=2)
    if ok:
        cfg.validate(mesh)
    else:
        with pytest.raises(ValueError, match=f"n_experts 4 must be divisible by ep {mesh['ep']}"):
            cfg.validate(mesh)
    # A dense model replicates over ep, as the reference's rule (0 % ep) allows.
    ttf.TransformerConfig().validate(mesh)


@pytest.mark.parametrize("router", ["_moe_mlp_routed", "_moe_mlp_expert_choice"])
def test_routed_paths_refuse_tokens_ep_does_not_divide(router):
    """3 x 5 tokens at ep 2: the reference's ValueError, before any
    collective (the mesh here has no process group)."""
    _, tcfg = _configs(moe_top_k=2, moe_router="expert" if "choice" in router else "token")
    _, tparams = _params(_configs(moe_top_k=2)[0])
    layer = _local({name: a[0, 0] for name, a in tparams["layers"].items()}, 0, 2)
    xn = torch.zeros((3, 5, 32))
    with pytest.raises(ValueError, match=r"routed MoE needs local tokens \(15\) divisible by "
                                         r"ep \(2\)"):
        getattr(ttf, router)(layer, xn, tcfg, tmesh.Mesh.at(tmesh.MeshConfig(ep=2), 0))


# --- over a gang -------------------------------------------------------------------


def test_mesh_layouts_with_ep_over_a_gang_of_four():
    """The ep axis's group and the joint (ep, tp) and (dp, sp, ep) groups
    all-reduce over the ranks `_check_layouts` expects."""
    layouts = [("mesh", {"ep": 2, "tp": 2}, False), ("mesh", {"dp": 2, "ep": 2}, False),
               ("mesh", {"ep": 2, "sp": 2}, False), ("mesh", {"ep": 2}, True)]
    got = gang.spawn(bodies.mesh_layouts, 4, (layouts, "cpu"), device="cpu", timeout_s=JOIN_S)
    _check_layouts(got, [tmesh.rank_grid(tmesh.MeshConfig(**shape)) for _, shape, _ in layouts])
    assert tmesh.EXPERT_AXES in got[0][0]["sums"] and tmesh.STATS_AXES in got[0][1]["sums"]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ep", [2, 4])
def test_gather_and_all_to_all_over_ep_match_lax(ep, dtype):
    """`gather` of each rank's chunk equals the tiled `lax.all_gather` bit
    for bit and its backward keeps the rank's slice of the (whole)
    cotangent; the all_to_all of [ep, e_local, C, d] send buffers equals
    `lax.all_to_all(split 0, concat 0)`."""
    rng = np.random.default_rng(ep)
    chunks = rng.standard_normal((ep, 3, 5)).astype(np.float32)
    sends = rng.standard_normal((ep, ep, 2, 3, 5)).astype(np.float32)
    cot = rng.standard_normal((ep * 3, 5)).astype(np.float32)
    mesh = jax_build_mesh(JaxMeshConfig(ep=ep), allow_submesh=True)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    gathered = jax.jit(jax.shard_map(
        lambda c: jax.lax.all_gather(c[0], "ep", tiled=True)[None], mesh=mesh,
        in_specs=P("ep"), out_specs=P("ep")))(jnp.asarray(chunks, jdt))
    moved = jax.jit(jax.shard_map(
        lambda s: jax.lax.all_to_all(s[0], "ep", 0, 0, tiled=True)[None], mesh=mesh,
        in_specs=P("ep"), out_specs=P("ep")))(jnp.asarray(sends, jdt))
    got = gang.spawn(bodies.ep_collectives, ep, (chunks, sends, cot, dtype, "cpu"),
                     device="cpu", timeout_s=JOIN_S)
    for rank, result in enumerate(got):
        np.testing.assert_array_equal(result["gathered"], np.asarray(gathered[rank], np.float32))
        np.testing.assert_array_equal(result["moved"], np.asarray(moved[rank], np.float32))
        want = np.asarray(jnp.asarray(cot[rank * 3:(rank + 1) * 3], jdt), np.float32)
        np.testing.assert_array_equal(result["gather_grad"], want)
