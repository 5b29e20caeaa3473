"""The port's gang train step with sequence parallelism against the JAX
package's shard_map train step, on the CPU: sp over processes on gloo
against the JAX step on the virtual CPU mesh `build_mesh(MeshConfig(dp,
sp, tp), allow_submesh=True)`, at (sp 2) here, (dp 2, sp 2) in
tests/test_torch_sp_train_dp.py and (sp 2, tp 2) in
tests/test_torch_sp_train_tp.py.

Cases: ring and Ulysses attention, each dense (GQA, a masked batch) and
MoE dropless top-2 at ep = 1; the ring dense under remat "full", the ring
MoE under "dots". At (sp 2, tp 2) a rank holds one kv head, which sp does
not divide: Ulysses broadcasts K/V to q's heads first, as the reference
does. Parameters come from the JAX `init_params` on the same mesh,
converted with `params_from_jax` and cut to each rank's shards; each rank
takes its dp rows and its sp chunk of positions of every batch. One gang
a mesh runs every case.

What is held, f32, at tests/test_torch_tp.py's bounds: the first step's
gradients and loss, the losses of 2 adamw steps and the parameters after
them, and the eval loss of a held-out batch after the steps (rtol 1e-5).
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

CASES = {
    "dense_ring": (dict(n_kv_heads=2, remat=True, remat_policy="full"), True),
    "dense_ulysses": (dict(n_kv_heads=2, attn_impl="ulysses", remat=False), True),
    "dropless_ring": (dict(MOE, moe_dispatch="dropless", remat=True, remat_policy="dots"),
                      False),
    "dropless_ulysses": (dict(MOE, moe_dispatch="dropless", attn_impl="ulysses", remat=False),
                         False),
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


def _jax_run(name, mesh_shape):
    """(params, grads of step 1, loss of step 1, losses and params after 2
    adamw steps, eval loss) of the JAX step on the mesh."""
    overrides, masked = CASES[name]
    cfg = JaxConfig(dtype=jnp.float32, **BASE, **overrides)
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


def gang_runs(mesh_shape):
    """The JAX runs of every case on the mesh, and each rank's port results
    of one gang."""
    jax_runs = {name: _jax_run(name, mesh_shape) for name in CASES}
    runs_ = {name: dict(config=dict(BASE, **overrides, dtype="float32"),
                        mesh_shape=mesh_shape, batches=_batches(masked), optimizer="adamw",
                        learning_rate=LR, params=jax_runs[name][0], device="cpu",
                        keep_grads=True, eval_batches=[_eval_batch()])
             for name, (overrides, masked) in CASES.items()}
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
    ranks sit where the reference puts devices (dp outermost, tp
    fastest)."""
    _, ranks = runs
    sp, tp = mesh_shape.get("sp", 1), mesh_shape.get("tp", 1)
    for rank, result in enumerate(ranks):
        assert result["dense_ring"]["coords"] == {
            "dp": rank // (sp * tp), "pp": 0, "ep": 0, "sp": rank // tp % sp, "tp": rank % tp}
        for case in CASES:
            assert result[case]["losses"] == ranks[0][case]["losses"]
            assert result[case]["eval_losses"] == ranks[0][case]["eval_losses"]
            for a, b in zip(tree.leaves(result[case]["params"]),
                            tree.leaves(ranks[0][case]["params"])):
                np.testing.assert_array_equal(a, b)


MESH = {"sp": 2}


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
