"""The port's gangs on the CPU (gloo), their state: dp = 2 `mlp` and `cnn`
workloads against their single-process runs; adafactor at tp = 2 against
`optax.adafactor` on the global leaves; an LM checkpoint written by a
tp = 2 gang (the global state, adafactor's factored moments included)
restored by one process at tp = 1; and the worker raising on a mesh axis
the reference does not have.

Tolerances, f32: losses at rtol 1e-5 (the same arithmetic, its sums split
over ranks and added in another order); adafactor's updates at max|d| <=
1e-6 * max|ref| + 1e-9 a leaf over 5 updates (tests/test_torch_workloads.py's
bound for one device: optax's formulas in f32, the row and column means
and the block RMSs summed over the tp shards). Every gang has a 180 s
limit that kills its processes.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.runtime import gang, runner
from jobset_tpu_torch.runtime.checkpoint import Checkpointer

import torch_gang_bodies as bodies
from test_torch_gang import JOIN_S, _example, _pod_envs, _run_workers

LOSS_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


MLP = {"kind": "mlp", "steps": 5, "batch_size": 8,
       "config": {"d_in": 8, "d_hidden": 32, "d_out": 4}}
CNN = {"kind": "cnn", "steps": 3, "batch_size": 4, "image_size": 8,
       "config": {"widths": [8, 16], "blocks_per_stage": 1, "groups": 4, "dtype": "float32"}}


def test_dp_mlp_and_cnn_match_their_single_process_runs():
    got = gang.spawn(bodies.workload_runs, 2, ([MLP, CNN], {"dp": 2}, "cpu"), device="cpu",
                     timeout_s=JOIN_S)
    assert got[0] == got[1]  # every rank reports the global loss
    for workload, losses in zip((MLP, CNN), got[0]):
        np.testing.assert_allclose(losses, list(runner.train_workload(workload, "cpu")),
                                   rtol=LOSS_RTOL)


# Leaves and the dim tp splits: the largest dim (d0), the second largest
# (d1), neither, a leaf too narrow to factor, a vector, and a leaf whose
# block RMS is below adafactor's 1e-3 floor.
ADAFACTOR_LEAVES = {
    "on_d0": ((256, 128), ("tp", None)),
    "on_d1": ((256, 128), (None, "tp")),
    "stacked": ((1, 2, 128, 256), ("pp", None, None, "tp")),
    "neither": ((4, 128, 256), ("tp", None, None)),
    "unfactored": ((8, 64), (None, "tp")),
    "vector": ((130,), (None,)),
    "small_scale": ((128, 256), ("tp", None)),
}


def test_adafactor_at_tp2_matches_optax_on_the_global_leaves():
    rng = np.random.default_rng(5)
    params = {k: (rng.standard_normal(s) * 0.05).astype(np.float32)
              for k, (s, _) in ADAFACTOR_LEAVES.items()}
    params["small_scale"][:] = 1e-4
    grads = [{k: rng.standard_normal(p.shape).astype(np.float32) for k, p in params.items()}
             for _ in range(5)]
    specs = {k: spec for k, (_, spec) in ADAFACTOR_LEAVES.items()}
    got = gang.spawn(bodies.optimizer_updates, 2, ("adafactor", 1e-2, params, grads, specs,
                                                    {"tp": 2}, "cpu"), device="cpu",
                     timeout_s=JOIN_S)
    opt = optax.adafactor(learning_rate=1e-2)
    jparams = jax.tree.map(jnp.asarray, params)
    state = opt.init(jparams)
    for step, g in enumerate(grads):
        want, state = opt.update(jax.tree.map(jnp.asarray, g), state, jparams)
        for key in sorted(params):
            ref = np.asarray(want[key], np.float64)
            for rank in range(2):
                d = np.abs(np.asarray(got[rank][step][key], np.float64) - ref).max()
                assert d <= 1e-6 * np.abs(ref).max() + 1e-9, (step, key, rank, d)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, want)


def test_checkpoint_saved_at_tp2_restores_at_tp1(tmp_path):
    """A tp = 2 gang writes the global state (every leaf at its global
    shape); one process resumes it at tp = 1, and its losses are those of
    one process that never stopped."""
    workload = {"kind": "lm", "steps": 4, "batch_size": 2, "seq_len": 8, "optimizer": "adafactor",
                "checkpoint_every": 2, "checkpoint_dir": str(tmp_path / "ck"),
                "config": {"vocab_size": 256, "d_model": 128, "n_heads": 4, "d_ff": 256,
                           "n_layers": 1}}
    gang_losses = gang.spawn(bodies.workload_runs, 2, ([workload], {"tp": 2}, "cpu"), device="cpu",
                             timeout_s=JOIN_S)[0][0]
    saved = Checkpointer(str(tmp_path / "ck")).restore()
    assert saved["step"] == 4
    cfg = runner.lm_config(workload)
    shapes = ttf.global_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in saved["state"]["params"]["layers"].items()} == \
        shapes["layers"]
    v_row = saved["state"]["opt_state"]["v_row"]["layers"]["w1"]
    assert tuple(v_row.shape) == (1, 1, 128)  # w1 [1, 1, 128, 256]: mean over 256

    straight = list(runner.train_workload(dict(workload, steps=6, checkpoint_every=0), "cpu"))
    np.testing.assert_allclose(gang_losses, straight[:4], rtol=LOSS_RTOL)
    resumed = list(runner.train_workload(dict(workload, steps=6), "cpu"))
    assert len(resumed) == 2
    np.testing.assert_allclose(resumed, straight[4:], rtol=LOSS_RTOL)


def test_worker_raises_on_an_axis_that_is_not_ported():
    workload = dict(_example().spec.replicated_jobs[0].template.spec.template.spec.workload,
                    mesh={"xp": 2})
    codes, _, errs = _run_workers(_pod_envs(2, workload))
    assert codes == [1, 1] and all("unexpected keyword argument 'xp'" in err
                                   and "TypeError" in err for err in errs)
