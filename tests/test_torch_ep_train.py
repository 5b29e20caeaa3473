"""The port's gang train step with expert parallelism against the JAX
package's shard_map train step, on the CPU: ep over processes on gloo
against the JAX step on the virtual CPU mesh `build_mesh(MeshConfig(...),
allow_submesh=True)`, at (ep 2) here; (ep 2, tp 2) in
tests/test_torch_ep_tp.py, (dp 2, ep 2) with ZeRO-1 in
tests/test_torch_ep_dp.py and (pp 2, ep 2) under gpipe and 1f1b in
tests/test_torch_ep_pp.py.

Every router of the reference, with its aux loss at moe_aux_coef 0.1
(4 experts of d_ff_expert 32, 2 a rank): soft dispatch; token choice top-2
with a capacity at a dropping factor (1.0) and at no drop (2.0, the
factor at which an expert can take every token of a chunk); dropless
top-2; expert choice. The capacity and expert-choice routers route each
ep rank's chunk of the tokens, so they are held to JAX on the same mesh
(expert choice is not invariant to the chunking). Parameters come from
the JAX `init_params` on the same mesh, converted with `params_from_jax`
and cut to each rank's experts by `shard_params`; every ep rank takes
the same rows (the batch is replicated over ep). One gang runs every case.

What is held, f32, at tests/test_torch_tp.py's bounds: the first step's
gradients, gathered, leaf by leaf (the router `wg` among them, whose
gradient carries the aux term: a rank that summed none of it over ep
would hold 1/ep of it), the losses of 2 adamw steps and the parameters
after them, and the eval loss of a held-out batch (rtol 1e-5).
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
from jobset_tpu.parallel.zero import init_zero1_opt_state
from jobset_tpu_torch import tree
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_tp import (
    BASE,
    LOSS_RTOL,
    LR,
    _adam_close,
    _batches,
    _close,
    _keep_first_grads,
    _np_tree,
)

EXPERTS = dict(n_experts=4, d_ff_expert=32, moe_aux_coef=0.1, remat=False)
# name -> config overrides
ROUTERS = {
    "soft": dict(EXPERTS),
    "capacity_drop": dict(EXPERTS, moe_top_k=2, moe_capacity_factor=1.0),
    "capacity_no_drop": dict(EXPERTS, moe_top_k=2, moe_capacity_factor=2.0),
    "dropless": dict(EXPERTS, moe_top_k=2, moe_dispatch="dropless"),
    "expert_choice": dict(EXPERTS, moe_router="expert"),
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


def leaf_names(node, prefix="") -> list:
    """The leaves' paths, in `tree.leaves` order (jax.tree.leaves' too)."""
    if isinstance(node, dict):
        return [n for key in sorted(node) for n in leaf_names(node[key], f"{prefix}/{key}")]
    return [prefix.lstrip("/")]


def jax_run(overrides, mesh_shape, optimizer="adamw", zero1=False, accum=1):
    """(params, grads of step 1 or None, losses and params after 2 steps,
    eval loss) of the JAX step on the mesh; adamw keeps its first
    gradients, and zero1 places the state with `init_zero1_opt_state`."""
    cfg = JaxConfig(dtype=jnp.float32, **dict(BASE, **overrides))
    mesh = build_mesh(MeshConfig(**mesh_shape), allow_submesh=True)
    params = jtf.init_params(jax.random.key(0), cfg, mesh)
    start = _np_tree(params)
    keep = optimizer == "adamw"
    opt = (optax.chain(_keep_first_grads(), optax.adamw(LR)) if keep
           else optax.adafactor(learning_rate=LR))
    if zero1:
        opt_state, shardings = init_zero1_opt_state(opt, params, jtf.param_specs(cfg), mesh)
    else:
        opt_state, shardings = opt.init(params), None
    step = jtf.build_train_step(cfg, mesh, opt, opt_shardings=shardings, accum_steps=accum)
    losses = []
    for batch in _batches(False):
        params, opt_state, loss = step(params, opt_state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    eval_loss = float(jtf.build_eval_step(cfg, mesh)(
        params, jax.tree.map(jnp.asarray, _eval_batch())))
    grads = _np_tree(opt_state[0]["g"]) if keep else None
    return start, grads, losses, _np_tree(params), eval_loss


def run_args(overrides, mesh_shape, params, optimizer="adamw", zero1=False, accum=1):
    return dict(config=dict(BASE, **overrides, dtype="float32"), mesh_shape=mesh_shape,
                batches=_batches(False), optimizer=optimizer, learning_rate=LR,
                accum_steps=accum, params=params, device="cpu",
                keep_grads=optimizer == "adamw", zero1=zero1, eval_batches=[_eval_batch()])


def gang_runs(mesh_shape, cases):
    """cases: {name: (overrides, optimizer, zero1, accum)}. The JAX runs of
    every case on the mesh, and each rank's port results of one gang."""
    jax_runs = {name: jax_run(*case[:1], mesh_shape, *case[1:]) for name, case in cases.items()}
    runs_ = {name: run_args(case[0], mesh_shape, jax_runs[name][0], *case[1:])
             for name, case in cases.items()}
    world = int(np.prod(list(mesh_shape.values())))
    ranks = gang.spawn(bodies.train_runs, world, (runs_,), device="cpu", timeout_s=180)
    return jax_runs, ranks


def check_gradients(runs, case):
    """The first step's loss and gradients, leaf by leaf by name."""
    jax_runs, ranks = runs
    _, want_grads, want_losses, _, _ = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"][0], want_losses[0], rtol=LOSS_RTOL)
    names = leaf_names(want_grads)
    assert "layers/wg" in names
    for name, g, w in zip(names, tree.leaves(got["opt_state"]["g"]),
                          jax.tree.leaves(want_grads)):
        _close(g, w, f"{case}: gradient of {name}")


def check_steps(runs, case):
    """The losses of the steps, the parameters after them and the eval
    loss."""
    jax_runs, ranks = runs
    _, _, want_losses, want_params, want_eval = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    np.testing.assert_allclose(got["eval_losses"][0], want_eval, rtol=LOSS_RTOL)
    for name, p, w in zip(leaf_names(want_params), tree.leaves(got["params"]),
                          jax.tree.leaves(want_params)):
        _adam_close(p, w, f"{case}: parameter {name}")


def check_ranks_agree(runs, mesh_shape):
    """Every rank reports the global losses and holds the whole tree; the
    ranks sit where the reference puts devices (dp, pp, ep, sp, tp, tp
    fastest)."""
    _, ranks = runs
    sizes = [mesh_shape.get(a, 1) for a in ("dp", "pp", "ep", "sp", "tp")]
    for rank, result in enumerate(ranks):
        coords = np.unravel_index(rank, sizes)
        for case in result:
            assert result[case]["coords"] == dict(zip(("dp", "pp", "ep", "sp", "tp"),
                                                      (int(c) for c in coords)))
            assert result[case]["losses"] == ranks[0][case]["losses"]
            assert result[case]["eval_losses"] == ranks[0][case]["eval_losses"]
            for a, b in zip(tree.leaves(result[case]["params"]),
                            tree.leaves(ranks[0][case]["params"])):
                np.testing.assert_array_equal(a, b)


MESH = {"ep": 2}
CASES = {name: (overrides, "adamw", False, 1) for name, overrides in ROUTERS.items()}


@pytest.fixture(scope="module")
def runs():
    return gang_runs(MESH, CASES)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_and_eval_match_jax(runs, case):
    check_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, MESH)
