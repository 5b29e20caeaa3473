"""The port's placement solver against the JAX package's, on the CPU.

Each case feeds the same numpy inputs to JAX's jitted auction programs on
the CPU (`_auction`, `_auction_structured`, `_auction_batch`,
`_auction_structured_batch`) and to the port's plain versions. Tolerance:
none. The algorithm is deterministic and both sides do the same f32
operations in the same order, so assignments and iteration counts must be
identical and prices equal bit for bit. The instances are
tests/test_solver.py's. The `AssignmentSolver` surfaces are held to each
other on the same problems: the host portfolio (a capped auction, then
scipy's Hungarian), the numpy cost mirror, storms, and the routing policy
at a fixed ping.
"""

from unittest import mock

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from jobset_tpu.placement import solver as jsolver
from jobset_tpu_torch.ops import auction as auction_ops
from jobset_tpu_torch.placement import solver as tsolver


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _benefit(cost, feasible=None):
    """The scaled, padded [J_p, D_p] benefit the JAX surface builds."""
    cost = np.asarray(cost, np.float32)
    num_jobs, num_domains = cost.shape
    jobs_p, domains_p = (tsolver._round_up_pow2(n) for n in cost.shape)
    if feasible is None:
        feasible = np.ones(cost.shape, bool)
    out = np.full((jobs_p, domains_p), jsolver.NEG_INF, np.float32)
    out[:num_jobs, :num_domains] = np.where(
        feasible, jsolver.COST_CAP - np.clip(cost, 0.0, jsolver.COST_CAP - 1.0), jsolver.NEG_INF
    )
    return out * float(jobs_p + 1)


def _jax_dense(benefit, max_iters=20000):
    a, p, it = jsolver._auction(jnp.asarray(benefit), jnp.float32(1.0), max_iters=max_iters)
    return np.asarray(a), np.asarray(p), int(it)


def _port_dense(benefit, max_iters=20000):
    a, p, it = tsolver._auction(torch.from_numpy(benefit), max_iters=max_iters)
    return a.numpy(), p.numpy(), int(it)


def _assert_same(want, got):
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1].view(np.uint32), want[1].view(np.uint32))
    assert got[2] == want[2]


def _random_int(num_jobs, num_domains, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 50, size=(num_jobs, num_domains)).astype(np.float32), None


def _feasibility_mask():
    rng = np.random.default_rng(7)
    cost = rng.integers(0, 20, size=(6, 10)).astype(np.float32)
    return cost, rng.random((6, 10)) > 0.4


def _infeasible_row():
    feasible = np.ones((3, 4), bool)
    feasible[1, :] = False
    return np.zeros((3, 4), np.float32), feasible


def _sticky():
    cost = np.ones((3, 8), np.float32)
    cost[0, 5] = 0.0
    cost[2, 1] = 0.0
    return cost, None


def _contended(num_jobs, num_domains, dead):
    cost = np.round((1.0 + np.linspace(0, 0.9, num_domains)[None, :].repeat(num_jobs, 0)) * 64)
    feasible = np.ones((num_jobs, num_domains), bool)
    if dead:
        feasible[:, num_domains - dead:] = False
    return cost.astype(np.float32), feasible


def _rectangular(index):
    """The index-th instance of test_eps_scaling_rectangular_duality."""
    rng = np.random.default_rng(11)
    for _ in range(index + 1):
        j = int(rng.integers(2, 60))
        d = int(rng.integers(j, j + 70))
        cost = rng.integers(0, 50, size=(j, d)).astype(np.float32)
    return cost, None


def _sweep(index):
    """The index-th case of test_auction_optimality_property_sweep:
    integer, continuous, tie-heavy and wide-magnitude costs."""
    rng = np.random.default_rng(99)
    for case in range(index + 1):
        j = int(rng.integers(1, 48))
        d = int(rng.integers(j, j + int(rng.integers(1, 64))))
        kind = case % 4
        if kind == 0:
            cost = rng.integers(0, 50, size=(j, d)).astype(np.float32)
        elif kind == 1:
            cost = rng.random((j, d), dtype=np.float32) * 1e3
        elif kind == 2:
            cost = rng.integers(0, 3, size=(j, d)).astype(np.float32)
        else:
            cost = (10.0 ** rng.integers(0, 4, size=(j, d))).astype(np.float32)
    return cost, None


DENSE_CASES = {
    **{f"random {j}x{d}": (lambda j=j, d=d, s=s: _random_int(j, d, s))
       for j, d, s in ((4, 4, 0), (8, 16, 1), (16, 16, 2), (32, 64, 3), (64, 100, 4), (1, 7, 5))},
    "feasibility mask": _feasibility_mask,
    "infeasible row": _infeasible_row,
    "more jobs than domains": lambda: (np.ones((5, 2), np.float32), None),
    "stickiness": _sticky,
    **{f"contended {j}x{d} dead {k}": (lambda j=j, d=d, k=k: _contended(j, d, k))
       for j, d, k in ((40, 70, 0), (64, 96, 32), (13, 70, 6))},
    **{f"rectangular {i}": (lambda i=i: _rectangular(i)) for i in range(10)},
    **{f"sweep {i}": (lambda i=i: _sweep(i)) for i in range(0, 40, 3)},
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_dense_auction_matches_jax(case):
    cost, feasible = DENSE_CASES[case]()
    benefit = _benefit(cost, feasible)
    _assert_same(_jax_dense(benefit), _port_dense(benefit))


def _structured_problem(seed, num_jobs=None, num_domains=None):
    """A continuous structured problem: random load, free capacity, pods,
    stickiness and exclusive ownership; by default up to 90 domains and
    no more jobs than domains."""
    rng = np.random.default_rng(seed)
    num_domains = num_domains or int(rng.integers(1, 90))
    num_jobs = num_jobs or int(rng.integers(1, num_domains + 1))
    own = np.full(num_jobs, -1, np.int32)
    occupied = rng.random(num_domains) < 0.15
    owned = np.flatnonzero(occupied)[: num_jobs // 4]
    own[: len(owned)] = owned
    return dict(
        load=rng.random(num_domains).astype(np.float32),
        free=rng.integers(0, 24, num_domains).astype(np.float32),
        pods_needed=rng.integers(1, 12, num_jobs).astype(np.float32),
        sticky=np.where(rng.random(num_jobs) < 0.3, rng.integers(0, num_domains, num_jobs),
                        -1).astype(np.int32),
        occupied=occupied,
        own_domain=own,
    )


def _padded(problem):
    stacked = tsolver._stack_structured(
        [problem], tsolver._round_up_pow2(len(problem["pods_needed"])),
        tsolver._round_up_pow2(len(problem["load"])))
    return [a[0] for a in stacked.values()]  # num_domains last, a 1-element array


# Seeds 4 and 10 are capacity-bound: some jobs fit nowhere, and their
# solves run into the iteration cap, which then holds both sides to the
# same unfinished state. The cap is 1000 here to keep them cheap.
STRUCTURED_CASES = [(seed, None, None) for seed in range(16)] + [(99, 6, 3), (99, 3, 1)]
STRUCTURED_MAX_ITERS = 1000


@pytest.mark.parametrize("seed,num_jobs,num_domains", STRUCTURED_CASES)
def test_structured_auction_matches_jax(seed, num_jobs, num_domains):
    problem = _structured_problem(seed, num_jobs, num_domains)
    ops = _padded(problem)
    want_a, want_it = jsolver._auction_structured(*map(jnp.asarray, ops[:-1]),
                                                  jnp.int32(int(ops[-1])),
                                                  max_iters=STRUCTURED_MAX_ITERS)
    got_a, got_it = tsolver._auction_structured(*map(torch.from_numpy, ops[:-1]), int(ops[-1]),
                                                max_iters=STRUCTURED_MAX_ITERS)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    assert int(got_it) == int(want_it)

    # The port's on-device construction equals the reference's numpy
    # mirror bit for bit, and the prices of the solve on it equal JAX's.
    cost, feasible = jsolver._structured_cost_np(*(problem[k] for k in tsolver._STRUCTURED))
    mirror = _benefit(cost, feasible)
    built = tsolver._structured_benefit(*(torch.from_numpy(a)[None] for a in ops[:-1]),
                                        torch.from_numpy(ops[-1][None]))[0].numpy()
    np.testing.assert_array_equal(built.view(np.uint32), mirror.view(np.uint32))
    _assert_same(_jax_dense(mirror, STRUCTURED_MAX_ITERS),
                 _port_dense(mirror, STRUCTURED_MAX_ITERS))


def test_structured_cost_np_matches_jax():
    problem = _structured_problem(3, num_jobs=48, num_domains=96)
    args = [problem[k] for k in tsolver._STRUCTURED]
    for got, want in zip(tsolver._structured_cost_np(*args), jsolver._structured_cost_np(*args)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_batch_matches_jax_and_singles(kind):
    rng = np.random.default_rng(11)
    if kind == "dense":
        costs = rng.integers(0, 30, size=(4, 8, 12)).astype(np.float32)
        stack = np.stack([_benefit(c) for c in costs])
        want = np.asarray(jsolver._auction_batch(jnp.asarray(stack), jnp.float32(1.0)))
        got_a, got_p, got_it = tsolver._auction_batch(torch.from_numpy(stack))
        np.testing.assert_array_equal(got_a.numpy(), want)
        for b in range(len(stack)):
            _assert_same(_jax_dense(stack[b]), (got_a[b].numpy(), got_p[b].numpy(),
                                                int(got_it[b])))
        return
    problems = [_structured_problem(20 + i, num_jobs=j, num_domains=d)
                for i, (j, d) in enumerate(((5, 12), (8, 8), (3, 16), (30, 40)))]
    stacked = tsolver._stack_structured(problems, 32, 64)
    want_a, want_it = jsolver._auction_structured_batch(*map(jnp.asarray, stacked.values()),
                                                        max_iters=STRUCTURED_MAX_ITERS)
    got_a, got_it = tsolver._auction_structured_batch(*map(torch.from_numpy, stacked.values()),
                                                      max_iters=STRUCTURED_MAX_ITERS)
    np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(got_it.numpy(), np.asarray(want_it))
    for b in range(len(problems)):
        single_a, single_it = tsolver._auction_structured(
            *(torch.from_numpy(stacked[k][b]) for k in tsolver._STRUCTURED),
            int(stacked["num_domains"][b]), max_iters=STRUCTURED_MAX_ITERS)
        np.testing.assert_array_equal(single_a.numpy(), got_a[b].numpy())
        assert int(single_it) == int(got_it[b])


# ---------------------------------------------------------------------------
# The AssignmentSolver surface
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("backend", ["cpu", "default", "auto"])
@pytest.mark.parametrize("seed", range(3))
def test_solver_surface_matches_jax(backend, seed):
    rng = np.random.default_rng(seed)
    cost = rng.integers(0, 64, size=(24, 40)).astype(np.float32)
    feasible = rng.random((24, 40)) > 0.2
    problem = _structured_problem(40 + seed, num_jobs=30, num_domains=50)
    ours = tsolver.AssignmentSolver(backend=backend, device="cpu")
    ref = jsolver.AssignmentSolver(backend=backend)
    np.testing.assert_array_equal(ours.solve(cost, feasible), ref.solve(cost, feasible))
    assert ours.last_iterations == ref.last_iterations
    got = ours.solve_structured_async(**problem)
    want = ref.solve_structured_async(**problem)
    assert got.is_ready()
    np.testing.assert_array_equal(got.result(), want.result())
    assert got.iterations == want.iterations
    assert got.solve_seconds is not None and got.solve_seconds >= 0
    assert ours.routes == {"cuda": 0, "cpu": 2}


@pytest.mark.parametrize("kind", ["dense", "structured"])
def test_hungarian_portfolio_matches_jax(kind):
    """The budget-tripped host path: scipy's Hungarian on the same matrix,
    with the algorithm trail recording it."""
    rng = np.random.default_rng(5)
    ours = tsolver.AssignmentSolver(backend="cpu")
    ref = jsolver.AssignmentSolver(backend="cpu")
    for s in (ours, ref):
        s._HOST_AUCTION_ITER_CAP = 1
    before = len(tsolver.RECENT_ALGORITHMS)
    if kind == "dense":
        cost = rng.integers(0, 64, size=(32, 50)).astype(np.float32)
        np.testing.assert_array_equal(ours.solve(cost), ref.solve(cost))
        assert ours.last_iterations == 0
    else:
        problem = _structured_problem(11, num_jobs=48, num_domains=96)
        got = ours.solve_structured_async(**problem)
        assert isinstance(got, tsolver.HostSolve) and got.is_ready()
        np.testing.assert_array_equal(got.result(), ref.solve_structured_async(**problem).result())
    assert list(tsolver.RECENT_ALGORITHMS)[before:] == ["hungarian"]


def _storm(seed, sizes=((12, 5), (8, 8), (16, 3))):
    rng = np.random.default_rng(seed)
    problems = []
    for d, j in sizes:
        free = rng.integers(2, 6, size=d).astype(np.float32)
        problems.append({
            "load": (1.0 - free / 6.0).astype(np.float32),
            "free": free,
            "pods_needed": np.full(j, 2.0, np.float32),
            "sticky": np.where(rng.random(j) < 0.5, rng.integers(0, d, size=j), -1).astype(np.int32),
            "occupied": np.zeros(d, bool),
            "own_domain": np.full(j, -1, np.int32),
        })
    return problems


def test_storm_batch_matches_jax_and_reuses_resident_operands():
    problems = _storm(7)
    ours = tsolver.AssignmentSolver(backend="default", device="cpu")
    ref = jsolver.AssignmentSolver(backend="default")
    got = ours.solve_structured_batch_async(problems)
    want = ref.solve_structured_batch_async(problems)
    for g, w, p in zip(got, want, problems):
        np.testing.assert_array_equal(g.result(), w.result())
        assert g.iterations == w.iterations
        np.testing.assert_array_equal(g.result(), ours.solve_structured_async(**p).result())
    assert (ours.batch_operand_transfers, ours.batch_operand_reuses) == (7, 0)
    ours.solve_structured_batch_async(problems)  # the same round again: all resident
    assert (ours.batch_operand_transfers, ours.batch_operand_reuses) == (7, 7)
    problems[1]["free"] = problems[1]["free"] - 1.0  # one operand changes
    ours.solve_structured_batch_async(problems)
    assert (ours.batch_operand_transfers, ours.batch_operand_reuses) == (8, 13)
    costs = np.random.default_rng(4).integers(0, 40, size=(3, 8, 12)).astype(np.float32)
    np.testing.assert_array_equal(ours.solve_batch(costs), ref.solve_batch(costs))


@pytest.mark.parametrize("rtt", [0.065, 1e-3, 1e-4, 0.0])
def test_routing_policy_matches_jax(rtt):
    """The cells-vs-round-trip model at a fixed ping: the port on the card
    routes where JAX on an accelerator does (its default backend mocked,
    as tests/test_solver.py does)."""
    ours = tsolver.AssignmentSolver(device="cuda")  # never touched: the ping is fixed
    ref = jsolver.AssignmentSolver(backend="auto")
    ours._accel_rtt_s = ref._accel_rtt_s = rtt
    storms = [[_storm(1, ((64, 32),))[0]] * 3,
              [_storm(1, ((64, 32),))[0], _storm(2, ((8192, 4096),))[0]]]
    with mock.patch.object(jsolver.jax, "default_backend", return_value="tpu"):
        for cells in (64, 8 * 64, 512 * 1024, 1_200_000, 4096 * 8192, 200_000_000):
            host = ref._solve_device(cells) is not None
            assert (ours._solve_device(cells).type == "cpu") == host, cells
            assert ours._host_hungarian(cells) == ref._host_hungarian(cells), cells
            assert ours._solve_device(cells, is_batched=True).type == "cuda"
        for storm in storms:
            assert ours.prefers_host_singles(storm) == ref.prefers_host_singles(storm)
    assert not tsolver.AssignmentSolver(backend="cpu").prefers_host_singles(storms[0])
    assert not tsolver.AssignmentSolver(backend="default", device="cpu").prefers_host_singles(
        storms[0])


def test_pinned_backends_never_ping():
    for solver in (tsolver.AssignmentSolver(backend="default", device="cuda"),
                   tsolver.AssignmentSolver(backend="cpu"),
                   tsolver.AssignmentSolver(device="cpu")):
        solver._solve_device(512 * 1024)
        assert solver._accel_rtt_s is None


def test_bad_backend_and_devices_raise():
    with pytest.raises(ValueError, match="unknown solver backend"):
        tsolver.AssignmentSolver(backend="tpu", device="cpu")
    meta = torch.zeros((8, 8), device="meta")
    with pytest.raises(ValueError, match="no implementation on device meta"):
        tsolver._auction(meta)
    # The kernel's launcher takes CUDA tensors only: no CPU fallback there.
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        auction_ops.dense(torch.zeros((1, 8, 8)))
    with pytest.raises(ValueError, match="the kernel takes CUDA tensors"):
        auction_ops.structured(*(torch.from_numpy(a) for a in
                                 tsolver._stack_structured(_storm(0), 8, 16).values()))
