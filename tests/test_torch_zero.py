"""ZeRO-1 in the port against the JAX package's, on the CPU.

- `parallel.zero.widen_spec` against the reference's `_widen_spec` on
  every leaf of the dense, MoE and tied `param_specs` at dp ∈ {2, 4},
  with the global shapes (no gang).
- The `zero1` gang step (`optim.zero1`) at dp 2 here and at (dp 2, tp 2)
  in tests/test_torch_zero_tp.py, under adam and adafactor, against the
  JAX step built with `init_zero1_opt_state` (as tests/test_parallel.py
  builds it): losses at rtol 1e-5, adam's state (mu, nu) at
  tests/test_torch_tp.py's gradient bound, the parameters after 3 steps
  at its adam bound (adafactor's first update is g / |g| per entry, as
  scale-free as adam's). The port's zero1 adam run equals its run without
  zero1 bit for bit (the update is elementwise on each slice), with half
  the state's bytes a rank; zero1 adafactor is within 1e-6 relative of
  the run without it (its block RMSs summed over dp in another order).
- A `zero1` checkpoint (the global state, gathered over dp) restored by a
  run without zero1, and the other way round: the resumed losses equal
  those of a run that never stopped.

The adafactor config has d_model 128, so its embedding, unembedding and
attention weights are factored (their state is not split) and its norm
scales are not (their v is split over dp).
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
from jobset_tpu.parallel.zero import _widen_spec, init_zero1_opt_state
from jobset_tpu_torch import tree
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.parallel.zero import widen_spec
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies
from test_torch_tp import BASE, LOSS_RTOL, MOE, _adam_close, _batches, _close, _np_tree

LR, STEPS = 1e-3, 3
CONFIGS = {"adam": dict(BASE, n_kv_heads=2, remat=False),
           "adafactor": dict(BASE, d_model=128, d_ff=256, vocab_size=128, remat=False)}
SPEC_CONFIGS = {"dense": dict(BASE), "moe": dict(BASE, **MOE),
                "tied": dict(BASE, tie_embeddings=True, n_layers=3, d_model=36, n_heads=4)}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _spec_pairs(tspecs, jspecs, shapes):
    if isinstance(tspecs, dict):
        for key in tspecs:
            yield from _spec_pairs(tspecs[key], jspecs[key], shapes[key])
    else:
        yield tspecs, jspecs, shapes


@pytest.mark.parametrize("dp", [2, 4])
@pytest.mark.parametrize("name", sorted(SPEC_CONFIGS))
def test_widen_spec_matches_the_reference(name, dp):
    overrides = SPEC_CONFIGS[name]
    tcfg = ttf.TransformerConfig(**overrides)
    pairs = list(_spec_pairs(ttf.param_specs(tcfg), jtf.param_specs(JaxConfig(**overrides)),
                             ttf.global_shapes(tcfg)))
    assert pairs
    for tspec, jspec, shape in pairs:
        assert widen_spec(tspec, shape, dp) == tuple(_widen_spec(jspec, shape, dp, "dp"))
    # By names, not sizes: the embedding keeps dp off its vocab dim, a
    # stacked layer leaf takes it on the layer axis where dp divides it.
    assert widen_spec(("tp", None), (64, 32), dp) == ("tp", "dp")
    assert widen_spec(("pp", None, None, "tp"), (1, 4, 32, 32), dp) == ("pp", "dp", None, "tp")


def test_zero1_state_splits_and_gathers_back():
    """At (dp 2, tp 2): adam's mu and nu take dp on the leaves' widened
    specs and split to half the bytes a rank; adafactor widens only its
    unfactored v (the norm scales here), its factored rows and columns
    and the count keep their specs; gathered back, every leaf is as it
    was."""
    ranks = gang.spawn(bodies.zero_state_round_trip, 4,
                       (CONFIGS["adafactor"], {"dp": 2, "tp": 2}, "cpu"), device="cpu",
                       timeout_s=180)
    tcfg = ttf.TransformerConfig(**CONFIGS["adafactor"])
    specs = ttf.param_specs(tcfg)
    for rank in ranks:
        adam, adafactor = rank["adam"], rank["adafactor"]
        assert all(adam["equal"]) and all(adafactor["equal"])
        assert adam["specs"]["mu"] == adam["specs"]["nu"]
        assert adam["specs"]["mu"]["embed"] == ("tp", "dp")
        assert adam["specs"]["mu"]["layers"]["wq"] == ("pp", "dp", None, "tp")
        assert adam["bytes"][0] * 2 == adam["bytes"][1]
        assert adafactor["specs"]["v"]["final_norm"] == ("dp",)
        assert adafactor["specs"]["v"]["layers"]["ln1"] == ("pp", "dp", None)
        assert adafactor["specs"]["v"]["embed"] == (None,)
        assert adafactor["specs"]["v_row"] == rank["adafactor"]["specs"]["v_row"]
        assert adafactor["specs"]["count"] is None
        assert adafactor["specs"]["v_row"]["layers"]["wq"] != specs["layers"]["wq"]
        assert adafactor["bytes"][0] < adafactor["bytes"][1]


def _jax_run(opt_name, mesh_shape):
    """The JAX step's losses, parameters and optimizer state after STEPS
    steps, the state placed by `init_zero1_opt_state`."""
    cfg = JaxConfig(dtype=jnp.float32, **CONFIGS[opt_name])
    mesh = build_mesh(MeshConfig(**mesh_shape), allow_submesh=True)
    params = jtf.init_params(jax.random.key(0), cfg, mesh)
    start = _np_tree(params)
    opt = optax.adam(LR) if opt_name == "adam" else optax.adafactor(learning_rate=LR)
    state, shardings = init_zero1_opt_state(opt, params, jtf.param_specs(cfg), mesh)
    step = jtf.build_train_step(cfg, mesh, opt, opt_shardings=shardings)
    losses = []
    for batch in _batches_of(STEPS):
        params, state, loss = step(params, state, jax.tree.map(jnp.asarray, batch))
        losses.append(float(loss))
    return start, losses, _np_tree(params), _np_tree(state)


def _batches_of(n):
    return (_batches(False) * n)[:n]


def zero_runs(mesh_shape):
    """The JAX zero1 runs, and one gang running each optimizer with and
    without zero1 from the JAX parameters."""
    jax_runs = {name: _jax_run(name, mesh_shape) for name in CONFIGS}
    runs_ = {f"{name}_{'zero1' if z else 'plain'}": dict(
        config=dict(CONFIGS[name], dtype="float32"), mesh_shape=mesh_shape,
        batches=_batches_of(STEPS), optimizer=name, learning_rate=LR,
        params=jax_runs[name][0], device="cpu", zero1=z)
        for name in CONFIGS for z in (True, False)}
    world = int(np.prod(list(mesh_shape.values())))
    return jax_runs, gang.spawn(bodies.train_runs, world, (runs_,), device="cpu", timeout_s=180)


def check_matches_jax(runs, name):
    jax_runs, ranks = runs
    _, want_losses, want_params, want_state = jax_runs[name]
    got = ranks[0][f"{name}_zero1"]
    np.testing.assert_allclose(got["losses"], want_losses, rtol=LOSS_RTOL)
    for path, (p, w) in enumerate(zip(tree.leaves(got["params"]), jax.tree.leaves(want_params))):
        _adam_close(p, w, f"parameter leaf {path}")
    if name == "adam":
        adam_state = want_state[0]
        for key, ref in (("mu", adam_state.mu), ("nu", adam_state.nu)):
            for path, (s, w) in enumerate(zip(tree.leaves(got["opt_state"][key]),
                                              jax.tree.leaves(ref))):
                _close(s, w, f"{key} leaf {path}")


def check_against_plain(runs, name):
    """Every rank's zero1 run against the gang's run without zero1: adam
    bit for bit with half the state's bytes, adafactor within 1e-6."""
    _, ranks = runs
    for result in ranks:
        z, plain = result[f"{name}_zero1"], result[f"{name}_plain"]
        pairs = list(zip(tree.leaves(z["params"]), tree.leaves(plain["params"])))
        if name == "adam":
            assert z["losses"] == plain["losses"]
            for a, b in pairs:
                np.testing.assert_array_equal(a, b)
            for a, b in zip(tree.leaves(z["opt_state"]), tree.leaves(plain["opt_state"])):
                np.testing.assert_array_equal(a, b)
            assert z["state_bytes"] == plain["state_bytes"] // 2
        else:
            np.testing.assert_allclose(z["losses"], plain["losses"], rtol=1e-6)
            for a, b in pairs:
                assert np.abs(a - b).max() <= 1e-6 * np.abs(b).max()
            assert z["state_bytes"] < plain["state_bytes"]


MESH = {"dp": 2}


@pytest.fixture(scope="module")
def runs():
    return zero_runs(MESH)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zero1_step_matches_jax(runs, name):
    check_matches_jax(runs, name)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_zero1_against_the_run_without_it(runs, name):
    check_against_plain(runs, name)


def test_zero1_checkpoint_restores_across_the_switch(tmp_path):
    """A dp 2 gang: an uninterrupted run; a zero1 run to step 2 resumed
    without zero1; a run without zero1 to step 2 resumed with it. Each
    resumed run's losses are the uninterrupted run's, bit for bit (adamw's
    update does not depend on the split)."""
    base = {"kind": "lm", "batch_size": 4, "seq_len": 8, "mesh": dict(MESH),
            "config": dict(BASE, remat=False)}
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    workloads = [
        dict(base, steps=4),
        dict(base, steps=2, zero1=True, checkpoint_every=2, checkpoint_dir=a),
        dict(base, steps=4, checkpoint_every=2, checkpoint_dir=a),
        dict(base, steps=2, checkpoint_every=2, checkpoint_dir=b),
        dict(base, steps=4, zero1=True, checkpoint_every=2, checkpoint_dir=b),
    ]
    ranks = gang.spawn(bodies.workload_runs, 2, (workloads, MESH, "cpu"), device="cpu",
                       timeout_s=180)
    straight, first_a, resumed_a, first_b, resumed_b = ranks[0]
    assert len(straight) == 4 and len(resumed_a) == len(resumed_b) == 2
    assert first_a == first_b == straight[:2]
    assert resumed_a == resumed_b == straight[2:]
    assert ranks[1] == ranks[0]
