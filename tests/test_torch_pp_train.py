"""The port's gang train step with pipeline parallelism against the JAX
package's shard_map train step, on the CPU: pp over processes on gloo
against the JAX step on the virtual CPU mesh `build_mesh(MeshConfig(...),
allow_submesh=True)`, at (pp 2) here; (pp 2, tp 2) in
tests/test_torch_pp_train_tp.py, (dp 2, pp 2) in
tests/test_torch_pp_train_dp.py and (pp 2, sp 2) in
tests/test_torch_pp_train_sp.py.

n_layers 4 and n_microbatches 4 (one row a microbatch). Cases: gpipe
dense (GQA, a masked batch, remat "full"); gpipe MoE dropless top-2 (the
aux loss from statistics pooled over every microbatch); interleaved with
pipeline_virtual 2, dense as the gpipe case; 1f1b with tied embeddings,
`loss_chunk`, label smoothing and z-loss; 1f1b with expert-choice MoE.
Parameters come from the JAX `init_params` on the same mesh (layer leaves
[pp, n_layers / pp, ...]), converted with `params_from_jax` and cut to
each rank's stage; every rank takes the whole batch (it is replicated
over pp). One gang runs every case.

What is held, f32, at tests/test_torch_tp.py's bounds: the first step's
gradients (gathered over pp) and loss, the losses of 2 adamw steps and
the parameters after them, and the eval loss of a held-out batch after
the steps (rtol 1e-5). Besides: the interleaved schedule on the tree
permuted by `interleave_stage_params` is the gpipe model (its losses
equal gpipe's, its gradients gpipe's permuted), as the reference's test
holds. tests/test_torch_pp_one_process.py runs pp = 1 with microbatches
and the interleave at pp = 1 in one process.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu.parallel.pipeline import interleave_stage_params
from jobset_tpu_torch import tree
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_tp import (
    BASE,
    LOSS_RTOL,
    LR,
    MOE,
    _adam_close,
    _batches,
    _close,
    _keep_first_grads,
    _np_tree,
)

PP_BASE = dict(BASE, n_layers=4, n_microbatches=4)
DENSE = dict(n_kv_heads=2, remat=True, remat_policy="full")
# name -> (config overrides, masked batches)
CASES = {
    "gpipe_dense": (DENSE, True),
    "gpipe_dropless": (dict(MOE, moe_dispatch="dropless", remat=False), False),
    "interleaved_dense": (dict(DENSE, pipeline_schedule="interleaved", pipeline_virtual=2),
                          True),
    "1f1b_tied": (dict(tie_embeddings=True, loss_chunk=4, label_smoothing=0.1,
                       z_loss_coef=1e-3, remat=False, pipeline_schedule="1f1b"), False),
    "1f1b_expert_choice": (dict(n_experts=4, d_ff_expert=32, moe_router="expert", remat=False,
                                pipeline_schedule="1f1b"), False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _eval_batch(b=4, t=8):
    rng = np.random.default_rng(100)
    tokens = rng.integers(0, BASE["vocab_size"], (b, t + 1)).astype(np.int32)
    return {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}


def _jax_run(overrides, masked, mesh_shape):
    """(params, grads of step 1, loss of step 1, losses and params after 2
    adamw steps, eval loss) of the JAX step on the mesh."""
    cfg = JaxConfig(dtype=jnp.float32, **dict(PP_BASE, **overrides))
    mesh = build_mesh(MeshConfig(**mesh_shape), allow_submesh=True)
    params = jtf.init_params(jax.random.key(0), cfg, mesh)
    start = _np_tree(params)
    opt = optax.chain(_keep_first_grads(), optax.adamw(LR))
    step = jtf.build_train_step(cfg, mesh, opt)
    opt_state, losses = opt.init(params), []
    for batch in _batches(masked):
        params, opt_state, loss = step(params, opt_state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    eval_loss = float(jtf.build_eval_step(cfg, mesh)(
        params, jax.tree.map(jnp.asarray, _eval_batch())))
    return start, _np_tree(opt_state[0]["g"]), losses[0], losses, _np_tree(params), eval_loss


def _run_args(overrides, masked, mesh_shape, params):
    return dict(config=dict(PP_BASE, **overrides, dtype="float32"), mesh_shape=mesh_shape,
                batches=_batches(masked), optimizer="adamw", learning_rate=LR,
                params=params, device="cpu", keep_grads=True, eval_batches=[_eval_batch()])


def gang_runs(mesh_shape, cases=CASES, permuted=False):
    """The JAX runs of every case on the mesh, and each rank's port results
    of one gang; with `permuted`, one more port run: interleaved_dense on
    gpipe_dense's parameters permuted by `interleave_stage_params`."""
    jax_runs = {name: _jax_run(*cases[name], mesh_shape) for name in cases}
    runs_ = {name: _run_args(*cases[name], mesh_shape, jax_runs[name][0]) for name in cases}
    if permuted:
        start = jax_runs["gpipe_dense"][0]
        moved = dict(start, layers=jax.tree.map(
            np.asarray, interleave_stage_params(start["layers"], mesh_shape["pp"], 2)))
        runs_["interleaved_permuted"] = _run_args(*cases["interleaved_dense"], mesh_shape, moved)
    world = int(np.prod(list(mesh_shape.values())))
    ranks = gang.spawn(bodies.train_runs, world, (runs_,), device="cpu", timeout_s=180)
    return jax_runs, ranks


def check_gradients(runs, case):
    jax_runs, ranks = runs
    _, want_grads, want_loss, _, _, _ = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"][0], want_loss, rtol=LOSS_RTOL)
    for path, (g, w) in enumerate(zip(tree.leaves(got["opt_state"]["g"]),
                                      jax.tree.leaves(want_grads))):
        _close(g, w, f"gradient leaf {path}")


def check_adamw_steps(runs, case):
    jax_runs, ranks = runs
    _, _, _, want_losses, want_params, want_eval = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval_losses"][0], want_eval, rtol=LOSS_RTOL)
    for path, (p, w) in enumerate(zip(tree.leaves(got["params"]),
                                      jax.tree.leaves(want_params))):
        _adam_close(p, w, f"parameter leaf {path}")


def check_ranks_agree(runs, mesh_shape):
    """Every rank reports the global losses and holds the whole tree; the
    ranks sit where the reference puts devices (dp outermost, then pp, tp
    fastest)."""
    _, ranks = runs
    pp, sp, tp = (mesh_shape.get(a, 1) for a in ("pp", "sp", "tp"))
    for rank, result in enumerate(ranks):
        first = next(iter(result.values()))
        assert first["coords"] == {"dp": rank // (pp * sp * tp), "pp": rank // (sp * tp) % pp,
                                   "ep": 0, "sp": rank // tp % sp, "tp": rank % tp}
        for case in result:
            assert result[case]["losses"] == ranks[0][case]["losses"]
            assert result[case]["eval_losses"] == ranks[0][case]["eval_losses"]
            for a, b in zip(tree.leaves(result[case]["params"]),
                            tree.leaves(ranks[0][case]["params"])):
                np.testing.assert_array_equal(a, b)


def check_interleave_is_gpipe(runs, pp):
    """interleaved_permuted (the interleave on gpipe_dense's tree, permuted)
    against gpipe_dense: the same losses, and its first-step gradients
    gpipe's permuted."""
    _, ranks = runs
    got, want = ranks[0]["interleaved_permuted"], ranks[0]["gpipe_dense"]
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval_losses"], want["eval_losses"], rtol=LOSS_RTOL)
    g, w = got["opt_state"]["g"], want["opt_state"]["g"]
    moved = jax.tree.map(np.asarray, interleave_stage_params(w["layers"], pp, 2))
    for path, (a, b) in enumerate(zip(tree.leaves(dict(g)), jax.tree.leaves(dict(w, layers=moved)))):
        _close(a, b, f"gradient leaf {path}")


MESH = {"pp": 2}


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, permuted=True)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)


def test_interleave_on_the_permuted_tree_is_gpipe(runs):
    check_interleave_is_gpipe(runs, MESH["pp"])
