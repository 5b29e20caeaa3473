"""The port's forward over a gang's mesh against the JAX package's
`build_forward` on the virtual CPU mesh, f32.

Each rank is fed its dp rows and sp chunk of the tokens and holds its
shards of the JAX `init_params` tree (converted with `params_from_jax`,
cut by `shard_params`); its logits must be its block of JAX's global
logits, [B / dp, T / sp, vocab / tp] (the reference's out_spec P("dp",
"sp", "tp")), within LOGITS_TOL (rtol 1e-5, atol 2e-5: the same arithmetic,
its sums split over ranks and added in another order). Meshes: (tp 2),
(dp 2), (pp 2) under gpipe, the interleave and 1f1b (an indivisible batch
too), (sp 2) ring and Ulysses and (ep 2) dropless and capacity, all on one
gang of 2 processes; (dp 2, tp 2) on a gang of 4.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies

LOGITS_TOL = dict(rtol=1e-5, atol=2e-5)
BASE = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2)
MOE = dict(n_experts=4, d_ff_expert=32, moe_top_k=2)
GQA = dict(n_kv_heads=2)
PP = dict(n_layers=4)
# name -> (mesh, config overrides, batch rows)
CASES = {
    "tp2 gqa": ({"tp": 2}, GQA, 4),
    "tp2 tied": ({"tp": 2}, dict(tie_embeddings=True), 4),
    "tp2 dropless": ({"tp": 2}, dict(MOE, moe_dispatch="dropless"), 4),
    "dp2 gqa": ({"dp": 2}, GQA, 4),
    "dp2 routed": ({"dp": 2}, MOE, 4),
    "pp2 gpipe": ({"pp": 2}, dict(PP, **GQA, n_microbatches=2), 4),
    "pp2 interleaved": ({"pp": 2}, dict(PP, n_microbatches=2, pipeline_schedule="interleaved",
                                        pipeline_virtual=2), 4),
    "pp2 1f1b": ({"pp": 2}, dict(PP, tie_embeddings=True, n_microbatches=4,
                                 pipeline_schedule="1f1b"), 4),
    # 3 rows in at most 2 microbatches: the forward runs 1 of 3 rows.
    "pp2 indivisible": ({"pp": 2}, dict(PP, n_microbatches=2), 3),
    "pp2 dropless": ({"pp": 2}, dict(PP, **MOE, moe_dispatch="dropless"), 4),
    "sp2 ring": ({"sp": 2}, GQA, 4),
    "sp2 ulysses": ({"sp": 2}, dict(attn_impl="ulysses"), 4),
    "ep2 dropless": ({"ep": 2}, dict(MOE, moe_dispatch="dropless"), 4),
    "ep2 capacity": ({"ep": 2}, dict(MOE, moe_capacity_factor=1.0), 4),
    "dp2 tp2 gqa": ({"dp": 2, "tp": 2}, GQA, 4),
    "dp2 tp2 dropless": ({"dp": 2, "tp": 2}, dict(MOE, moe_dispatch="dropless"), 4),
}
SEQ = 8


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _jax_run(name):
    """(numpy params, tokens, JAX's global logits) of one case."""
    mesh_shape, overrides, batch = CASES[name]
    cfg = JaxConfig(dtype=jnp.float32, remat=False, **dict(BASE, **overrides))
    mesh = build_mesh(MeshConfig(**mesh_shape), allow_submesh=True)
    params = jtf.init_params(jax.random.key(len(name)), cfg, mesh)
    tokens = np.random.default_rng(len(name)).integers(0, BASE["vocab_size"], (batch, SEQ))
    tokens = tokens.astype(np.int32)
    logits = np.asarray(jtf.build_forward(cfg, mesh)(params, jnp.asarray(tokens)), np.float32)
    return jax.tree.map(np.asarray, params), tokens, logits


@pytest.fixture(scope="module")
def runs():
    """JAX's logits of every case, and each rank's of the port's gangs: one
    of 2 processes for the meshes of 2, one of 4 for (dp 2, tp 2)."""
    jax_runs = {name: _jax_run(name) for name in CASES}
    out = {}
    for world in (2, 4):
        mine = {name: dict(config=dict(BASE, **CASES[name][1], dtype="float32"),
                           mesh=CASES[name][0], params=jax_runs[name][0],
                           tokens=jax_runs[name][1])
                for name in CASES if int(np.prod(list(CASES[name][0].values()))) == world}
        ranks = gang.spawn(bodies.forward_runs, world, (mine, "cpu"), device="cpu",
                           timeout_s=180)
        for name in mine:
            out[name] = [r[name] for r in ranks]
    return jax_runs, out


@pytest.mark.parametrize("name", list(CASES))
def test_each_rank_holds_its_block_of_the_jax_logits(runs, name):
    jax_runs, ranks = runs
    want = jax_runs[name][2]
    mesh = MeshConfig(**CASES[name][0])
    b, t, v = want.shape
    for r in ranks[name]:
        c = r["coords"]
        rows = slice(c["dp"] * b // mesh.dp, (c["dp"] + 1) * b // mesh.dp)
        cols = slice(c["sp"] * t // mesh.sp, (c["sp"] + 1) * t // mesh.sp)
        vocab = slice(c["tp"] * v // mesh.tp, (c["tp"] + 1) * v // mesh.tp)
        got = r["logits"]
        assert got.shape == (b // mesh.dp, t // mesh.sp, v // mesh.tp), name
        np.testing.assert_allclose(got, want[rows, cols, vocab], **LOGITS_TOL, err_msg=str(c))


def test_ranks_that_share_a_block_agree_bit_for_bit(runs):
    """The ranks whose blocks coincide (over pp and ep, the replicated axes)
    hold the same logits bit for bit."""
    _, ranks = runs
    for name in CASES:
        by_block: dict = {}
        for r in ranks[name]:
            key = (r["coords"]["dp"], r["coords"]["sp"], r["coords"]["tp"])
            by_block.setdefault(key, []).append(r["logits"])
        for blocks in by_block.values():
            for other in blocks[1:]:
                np.testing.assert_array_equal(other, blocks[0], err_msg=name)
