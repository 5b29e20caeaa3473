"""The port's gang train step against the JAX package's shard_map train
step, on the CPU: tp and dp over processes on gloo, against the JAX step
on the virtual CPU mesh `build_mesh(MeshConfig(dp=a, tp=b),
allow_submesh=True)`, for (dp, tp) in {(1, 2), (2, 1), (2, 2)}.

Cases: dense (GQA, a masked batch, remat "full"), MoE dropless top-2
(remat "dots"), routed with a capacity at ep = 1, and tied embeddings with
label smoothing, z-loss, `loss_chunk` and `accum_steps = 2`. Parameters
come from the JAX `init_params` on the same mesh, converted with
`params_from_jax` and cut to each rank's shards by `shard_params`;
batches are numpy arrays from a seed, each rank fed its rows
(`gang.batch_rows`). One gang a mesh runs every case (`gang.spawn`, one
spawn checks several configurations). This file holds (1, 2) and the
checks; tests/test_torch_tp_dp.py runs them at (2, 1) and
tests/test_torch_tp_dp_tp.py at (2, 2), so that each file stays short.

What is held, f32 throughout:
- the gradients of the first step (kept in the optimizer's state, gathered
  over tp): max|d| <= 1e-5 * max|ref| + 1e-6 per leaf (the same
  arithmetic, its sums split over ranks and added in another order), and
  the loss at rtol 1e-5;
- the losses of 2 adamw steps at lr 1e-3 (the lm workloads' default) at
  rtol 1e-5, and the gathered parameters after them: the gradient bound
  on all but one in a thousand entries of a leaf, and every entry within
  0.05 * lr per step. Adam's update g / (|g| + eps) is scale-free, so an
  entry whose gradient is near eps = 1e-8 turns a last-bit difference in
  its gradient into a visible part of lr (the bound of
  tests/test_torch_train.py for one device).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jobset_tpu.models import TransformerConfig as JaxConfig
from jobset_tpu.models import transformer as jtf
from jobset_tpu.parallel.mesh import MeshConfig, build_mesh
from jobset_tpu_torch import tree
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies

LR, STEPS, LOSS_RTOL = 1e-3, 2, 1e-5
BASE = dict(vocab_size=64, d_model=32, n_heads=4, d_ff=64, n_layers=2)
MOE = dict(n_experts=4, d_ff_expert=32, moe_top_k=2)
CASES = {
    "dense": (dict(n_kv_heads=2, remat=True, remat_policy="full"), 1, True),
    "dropless": (dict(MOE, moe_dispatch="dropless", remat=True, remat_policy="dots"), 1, False),
    "routed": (dict(MOE, remat=False), 1, False),
    "tied": (dict(tie_embeddings=True, label_smoothing=0.1, z_loss_coef=1e-3, loss_chunk=4,
                  remat=False), 2, False),
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _batches(masked: bool, b=4, t=8):
    out = []
    for seed in range(STEPS):
        rng = np.random.default_rng(seed)
        tokens = rng.integers(0, BASE["vocab_size"], (b, t + 1)).astype(np.int32)
        batch = {"inputs": tokens[:, :-1], "targets": tokens[:, 1:]}
        if masked:
            mask = np.ones((b, t), np.float32)
            mask[:, t // 2 + seed:] = 0.0
            mask[1] = 0.0
            batch["mask"] = mask
        out.append(batch)
    return out


def _jax_mesh(dp, tp):
    return build_mesh(MeshConfig(dp=dp, tp=tp), allow_submesh=True)


def _keep_first_grads():
    """An optax transform that keeps the first update's gradients in its
    state and passes every update on unchanged (the port's
    `torch_gang_bodies.grads_optimizer`), chained before adamw: one compiled step gives
    the gradients and the adamw run."""
    def init(params):
        return {"count": jnp.zeros((), jnp.int32), "g": jax.tree.map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        first = state["count"] == 0
        kept = jax.tree.map(lambda u, g: jnp.where(first, u, g), updates, state["g"])
        return updates, {"count": state["count"] + 1, "g": kept}

    return optax.GradientTransformation(init, update)


def _np_tree(t):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), t)


def _jax_run(name, dp, tp):
    """(params, grads of step 1, loss of step 1, losses and params after
    STEPS adamw steps) of the JAX step on the (dp, tp) mesh."""
    overrides, accum, masked = CASES[name]
    cfg = JaxConfig(dtype=jnp.float32, **BASE, **overrides)
    mesh = _jax_mesh(dp, tp)
    params = jtf.init_params(jax.random.key(0), cfg, mesh)
    start = _np_tree(params)
    opt = optax.chain(_keep_first_grads(), optax.adamw(LR))
    step = jtf.build_train_step(cfg, mesh, opt, accum_steps=accum)
    opt_state, losses = opt.init(params), []
    for batch in _batches(masked):
        params, opt_state, loss = step(params, opt_state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    return start, _np_tree(opt_state[0]["g"]), losses[0], losses, _np_tree(params)


def gang_runs(dp, tp):
    """The JAX runs of every case on the (dp, tp) mesh, and each rank's
    port results of one gang."""
    jax_runs = {name: _jax_run(name, dp, tp) for name in CASES}
    runs_ = {name: dict(config=dict(BASE, **overrides, dtype="float32"),
                        mesh_shape={"dp": dp, "tp": tp}, batches=_batches(masked),
                        optimizer="adamw", learning_rate=LR, accum_steps=accum,
                        params=jax_runs[name][0], device="cpu", keep_grads=True)
             for name, (overrides, accum, masked) in CASES.items()}
    ranks = gang.spawn(bodies.train_runs, dp * tp, (runs_,), device="cpu", timeout_s=180)
    return jax_runs, [{name: dict(r[name], grad_loss=r[name]["losses"][0],
                                  grads=r[name]["opt_state"]["g"]) for name in CASES}
                      for r in ranks]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err, ref = np.abs(got - want).max(), np.abs(want).max()
    assert err <= 1e-5 * ref + 1e-6, f"{what}: max|d|={err:.3e}, max|ref|={ref:.3e}"


def _adam_close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    d = np.abs(got - want)
    bound = 1e-5 * np.abs(want).max() + 1e-6
    assert (d > bound).mean() <= 1e-3, f"{what}: {(d > bound).sum()} of {d.size} entries"
    assert d.max() <= 0.05 * LR * STEPS, f"{what}: max|d|={d.max():.3e}"


def check_gradients(runs, case):
    """The gradients and loss of one step against the JAX step's."""
    jax_runs, ranks = runs
    _, want_grads, want_loss, _, _ = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["grad_loss"], want_loss, rtol=LOSS_RTOL)
    for path, (g, w) in enumerate(zip(tree.leaves(got["grads"]), jax.tree.leaves(want_grads))):
        _close(g, w, f"gradient leaf {path}")


def check_adamw_steps(runs, case):
    """The losses of STEPS adamw steps and the parameters after them."""
    jax_runs, ranks = runs
    _, _, _, want_losses, want_params = jax_runs[case]
    got = ranks[0][case]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    for path, (p, w) in enumerate(zip(tree.leaves(got["params"]),
                                      jax.tree.leaves(want_params))):
        _adam_close(p, w, f"parameter leaf {path}")


def check_ranks_agree(runs, tp):
    """Each rank's loss is the global batch's and its gathered tree the
    whole one, whatever its place on the mesh; the ranks sit where the
    reference puts devices (dp outermost, tp fastest)."""
    _, ranks = runs
    for rank, result in enumerate(ranks):
        assert result["dense"]["coords"] == {"dp": rank // tp, "pp": 0, "ep": 0, "sp": 0,
                                             "tp": rank % tp}
        for case in CASES:
            assert result[case]["losses"] == ranks[0][case]["losses"]
            for a, b in zip(tree.leaves(result[case]["params"]),
                            tree.leaves(ranks[0][case]["params"])):
                np.testing.assert_array_equal(a, b)


DP, TP = 1, 2


@pytest.fixture(scope="module")
def runs():
    return gang_runs(DP, TP)


@pytest.mark.parametrize("case", sorted(CASES))
def test_gradients_match_jax(runs, case):
    check_gradients(runs, case)


@pytest.mark.parametrize("case", sorted(CASES))
def test_adamw_steps_match_jax(runs, case):
    check_adamw_steps(runs, case)


def test_every_rank_holds_the_same_global_result(runs):
    check_ranks_agree(runs, TP)
