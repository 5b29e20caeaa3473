"""The port's pipeline schedules against the JAX package's, on the CPU.

- The tables: `schedule_steps`, `interleave_stage_params` and the 1F1B
  tables (`schedule_1f1b` against `_schedule_1f1b`) equal the reference's
  exactly, for m in 1..12 microbatches and pp in 1..4.
- The timetables: every rank runs each microbatch's F and B once a chunk,
  after what it needs (gpipe, interleaved, 1f1b).
- `parallel.pipeline.drive` on a toy stage, tanh(x @ w) a
  chunk, with a quadratic head, as a gloo gang of pp processes at pp 2
  and 4, against `pipeline_apply`, `pipeline_apply_interleaved` and
  `pipeline_1f1b_grads` under shard_map (as tests/test_parallel.py runs
  them): the objective, the last stage's outputs, every rank's stage
  gradients, the head's gradient and the microbatches' cotangents, within
  1e-6 (f32; the same arithmetic, the gradients added in another order).
- 1F1B's memory cap: rank r never holds more than 2 * (pp - r) - 1 saved
  graphs (the last rank none: its B runs forward and backward at once),
  where gpipe holds every microbatch's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from jobset_tpu.parallel import pipeline as jpipe
from jobset_tpu_torch.parallel import pipeline as tpipe
from jobset_tpu_torch.runtime import gang

import torch_gang_bodies as bodies

TOL = 1e-6
D, ROWS = 8, 2
# (schedule, n_virtual, microbatches) by pp: partial interleave groups
# (3 microbatches over 2 ranks) and 1F1B at 8 microbatches, where its cap
# binds.
CASES = {
    2: [("gpipe", 1, 4), ("interleaved", 2, 4), ("interleaved", 2, 3), ("1f1b", 1, 4),
        ("1f1b", 1, 8)],
    4: [("gpipe", 1, 4), ("interleaved", 2, 8), ("1f1b", 1, 8)],
}


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# ---------------------------------------------------------------------------
# The tables
# ---------------------------------------------------------------------------


def test_schedule_steps_match_the_reference():
    for m in range(1, 13):
        for pp in range(1, 5):
            for v in range(1, 4):
                assert tpipe.schedule_steps(m, pp, v) == jpipe.schedule_steps(m, pp, v)


@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_interleave_stage_params_match_the_reference(pp):
    rng = np.random.default_rng(pp)
    for lps, v in ((1, 1), (2, 2), (4, 2), (6, 3), (4, 4)):
        layers = {"a": rng.standard_normal((pp, lps, 3)).astype(np.float32),
                  "b": rng.standard_normal((pp, lps, 2, 5)).astype(np.float32)}
        want = jpipe.interleave_stage_params(jax.tree.map(jnp.asarray, layers), pp, v)
        got = tpipe.interleave_stage_params(
            {k: torch.from_numpy(a) for k, a in layers.items()}, pp, v)
        for k in layers:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    with pytest.raises(ValueError, match="not divisible"):
        tpipe.interleave_stage_params({"a": torch.zeros(pp, 3, 2)}, pp, 2)


@pytest.mark.parametrize("pp", [1, 2, 3, 4])
def test_1f1b_tables_match_the_reference(pp):
    for m in range(1, 13):
        want = jpipe._schedule_1f1b(m, pp)
        got = tpipe.schedule_1f1b(m, pp)
        for g, w in zip(got[:4], want[:4]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[4] == want[4]


@pytest.mark.parametrize("schedule, v", [("gpipe", 1), ("interleaved", 2), ("interleaved", 3),
                                         ("1f1b", 1)])
@pytest.mark.parametrize("pp", [1, 2, 4])
def test_timetables_run_each_event_once_after_what_it_needs(schedule, v, pp):
    for m in range(1, 10):
        table = tpipe.timetable(schedule, m, pp, v)
        done = {}
        for i, phase in enumerate(table.phases):
            for r, event in enumerate(phase.events):
                if event is None:
                    continue
                key = (phase.kind, event, r)
                assert key not in done
                done[key] = i
        for b in range(m):
            for c in range(table.n_virtual):
                for r in range(pp):
                    fused = table.fused and r == pp - 1
                    assert (("F", (b, c), r) in done) != fused
                    b_at = done[("B", (b, c), r)]
                    if not fused:
                        assert done[("F", (b, c), r)] < b_at
                    # The input comes from the stage before, a phase earlier.
                    prev = (r - 1, c) if r else (pp - 1, c - 1)
                    if prev[1] >= 0 and not (r == 0 and c == 0):
                        assert done[("F", (b, prev[1]), prev[0])] < done.get(
                            ("F", (b, c), r), b_at)
        assert table.cyclic == (schedule == "interleaved")
    with pytest.raises(ValueError, match="unknown pipeline_schedule"):
        tpipe.timetable("zigzag", 2, pp)


# ---------------------------------------------------------------------------
# drive against the reference's schedules
# ---------------------------------------------------------------------------


def _head(hw, y):
    return 0.01 * jnp.sum((y @ hw - 1.0) ** 2)


def _inputs(pp, v, m, seed):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((pp, v, D, D)) * 0.4).astype(np.float32)
    hw = (rng.standard_normal((D, D)) * 0.3).astype(np.float32)
    mbs = rng.standard_normal((m, ROWS, D)).astype(np.float32)
    return w, hw, mbs


def _reference(schedule, pp, v, w, hw, mbs):
    """(objective, last stage's outputs, w's gradient [pp, v, D, D], hw's,
    the microbatches') of the reference's schedule under shard_map."""
    mesh = Mesh(np.array(jax.devices()[:pp]), ("pp",))
    m = mbs.shape[0]

    def last(x):
        return jnp.where(lax.axis_index("pp") == pp - 1, x, jnp.zeros_like(x))

    def run(ws, xs):
        if schedule == "interleaved":
            return jpipe.pipeline_apply_interleaved(lambda c, x: jnp.tanh(x @ c), ws[0], xs, v,
                                                    "pp")
        return jpipe.pipeline_apply(lambda s, x: jnp.tanh(x @ s[0]), ws[0], xs, "pp")

    def local(ws, hw_, xs):
        out = lax.psum(last(run(ws, xs)), "pp")
        if schedule == "1f1b":
            loss, gw, gh, gx = jpipe.pipeline_1f1b_grads(
                lambda s, x: jnp.tanh(x @ s[0]), lambda h, y, b: _head(h, y), ws[0], hw_, xs,
                "pp")
            return lax.psum(loss, "pp"), gw[None], lax.psum(gh, "pp"), lax.psum(gx, "pp"), out

        def loss_fn(ws_, h, xs_):
            ys = run(ws_, xs_)
            return lax.psum(last(sum(_head(h, ys[b]) for b in range(m))), "pp")

        loss, (gw, gh, gx) = jax.value_and_grad(loss_fn, argnums=(0, 1, 2))(ws, hw_, xs)
        return loss, gw, gh, gx, out

    fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=(P("pp"), P(), P()),
                               out_specs=(P(), P("pp"), P(), P(), P())))
    return [np.asarray(a) for a in fn(jnp.asarray(w), jnp.asarray(hw), jnp.asarray(mbs))]


def _key(schedule, v, m):
    return f"{schedule}-v{v}-m{m}"


def _runs(pp):
    cases, refs = {}, {}
    for i, (schedule, v, m) in enumerate(CASES[pp]):
        w, hw, mbs = _inputs(pp, v, m, seed=10 * pp + i)
        cases[_key(schedule, v, m)] = (schedule, v, w, hw, mbs)
        refs[_key(schedule, v, m)] = _reference(schedule, pp, v, w, hw, mbs)
    ranks = gang.spawn(bodies.toy_pipeline, pp, (cases, pp, "cpu"), device="cpu", timeout_s=120)
    return refs, ranks


@pytest.fixture(scope="module", params=[2, 4], ids=["pp2", "pp4"])
def driven(request):
    return request.param, _runs(request.param)


def _close(got, want, what):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=what)


def test_drive_matches_the_reference_schedules(driven):
    pp, (refs, ranks) = driven
    for schedule, v, m in CASES[pp]:
        key = _key(schedule, v, m)
        loss, gw, gh, gx, out = refs[key]
        first, last = ranks[0][key], ranks[-1][key]
        _close(last[0], loss, f"{key}: objective")
        _close(last[4], out, f"{key}: the last stage's outputs")
        _close(last[2], gh, f"{key}: the head's gradient")
        _close(first[3], gx, f"{key}: the microbatches' cotangents")
        for r, rank in enumerate(ranks):
            _close(rank[key][1], gw[r], f"{key}: rank {r}'s stage gradient")


def test_1f1b_caps_the_saved_graphs_on_each_rank(driven):
    pp, (_, ranks) = driven
    for schedule, v, m in CASES[pp]:
        key = _key(schedule, v, m)
        for r, rank in enumerate(ranks):
            peak = rank[key][5]
            if schedule == "1f1b":
                assert peak <= 2 * (pp - r) - 1 if r < pp - 1 else peak == 0, (key, r, peak)
            else:
                assert peak == m * v, (key, r, peak)
    # At 8 microbatches 1F1B's rank 0 holds fewer than all of them.
    assert ranks[0][_key("1f1b", 1, 8)][5] < 8
