"""The auction kernel's candidate lists, as a numpy model of its rule.

A bid needs (best, first argmax, second) of benefit[j, :] - prices. The
kernel's full scan (`row_top2` in `ops/csrc/auction.cu`) gives lane l of
the warp the float4 columns l, l + 32, l + 64, ... of the row. On a full
scan each lane also keeps its k best columns (benefit and index; among
equal values any) and s_l, the largest value among its other columns; the
job keeps the 32·k candidates and T = max_l s_l. A later bid of the job
evaluates only the candidates at the current prices, and takes their
(best, first argmax, second) when best > T and second >= T; otherwise it
scans the row again. Within a phase prices only rise, and an f32
subtraction is monotone, so every other column's value is still at most
T: the answer equals the full scan's bit for bit. The repair at a phase
start can lower prices, so each list is tagged with its phase.

Each case runs seeded rows through a sequence of prices that rise within
a phase (the auction's own raises and random ones) and fall at phase
starts, and asserts that every answer taken from the candidates equals
the full scan exactly, that it came from prices that never fell since the
scan, and that the bid made from it (sink or object, and its amount) is
the full scan's. Tolerance: none.
"""

import numpy as np
import pytest
import torch

LANES = 32
COST_CAP = 1024.0
NEG_INF = -1.0e9
JOBS_P = 512
SCALE = np.float32(JOBS_P + 1)
SINK = np.float32(-4.0 * COST_CAP * (JOBS_P + 1))
EPS = np.float32(1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def lane_columns(domains):
    """The columns lane l reads in row_top2's order: float4 c = l, l + 32,
    ..., columns 4c .. 4c + 3 (ascending)."""
    n4 = domains // 4
    return [np.concatenate([np.arange(4 * c, 4 * c + 4) for c in range(lane, n4, LANES)])
            if lane < n4 else np.zeros(0, np.int64) for lane in range(LANES)]


def values(b, p):
    return (b - p).astype(np.float32)  # one f32 subtraction, rounded to nearest


def full_scan(b, p):
    """(best, first argmax, second) over the whole row."""
    v = values(b, p)
    idx = int(np.argmax(v))
    masked = v.copy()
    masked[idx] = -np.inf
    return v[idx], idx, masked.max()


def build_candidates(b, p, cols, k, rng):
    """Each lane's k best columns and the bound T = max over lanes of the
    largest value among the rest. Which of several equal values a lane
    keeps is drawn at random: the rule holds whichever it keeps, since T
    takes every value left out."""
    v = values(b, p)
    cands, bound = [], np.float32(-np.inf)
    for lane_cols in cols:
        order = np.lexsort((rng.random(len(lane_cols)), -v[lane_cols]))
        cands.extend(lane_cols[order[:k]].tolist())
        if len(order) > k:
            bound = max(bound, v[lane_cols[order[k]]])
    cands = np.asarray(sorted(cands), np.int64)
    return cands, b[cands].copy(), bound


def probe(cand_cols, cand_b, bound, p):
    """The candidates' (best, first argmax, second) at prices p, and
    whether the rule lets them answer."""
    v = values(cand_b, p[cand_cols])
    best = v.max()
    first = int(np.flatnonzero(v == best)[0])  # columns ascending: the first index
    rest = np.delete(v, first)
    second = rest.max() if len(rest) else np.float32(-np.inf)
    return (best, int(cand_cols[first]), second), bool(best > bound and second >= bound)


def bid(top, p):
    """The bid made from (best, idx, second): the sink, or (object, amount)."""
    best, idx, second = top
    second = max(second, SINK)
    if SINK > best:
        return "sink"
    return idx, np.float32(np.float32(p[idx] + np.float32(best - second)) + EPS)


def make_row(kind, domains, rng):
    """A scaled benefit row of one kind, as the solver builds it."""
    if kind == "continuous":
        cost = rng.random(domains, dtype=np.float32) * 8.0
    elif kind == "integer_ties":
        # Every cost about eight times a row (four at D = 8).
        cost = rng.integers(0, max(2, domains // 8), domains).astype(np.float32)
    else:
        cost = rng.integers(0, 256, domains).astype(np.float32)
    benefit = (np.float32(COST_CAP) - cost).astype(np.float32)
    if kind == "neg_inf_cells":
        benefit[rng.random(domains) < 0.5] = NEG_INF
        benefit[rng.integers(domains)] = COST_CAP  # at least one feasible cell
    elif kind == "one_feasible":
        keep = rng.integers(domains)
        benefit[np.arange(domains) != keep] = NEG_INF
    elif kind == "sink":
        # Four feasible cells, priced out by the sink once their prices
        # pass about 5 * COST_CAP * (J + 1).
        benefit[np.isin(np.arange(domains), rng.choice(domains, 4, replace=False),
                        invert=True)] = NEG_INF
    return (benefit * SCALE).astype(np.float32)


def raise_prices(p, top, rng, kind):
    """One step of prices that only rise: the job's own winning bid, and
    other objects outbid by random (integer for the tie case) amounts."""
    made = bid(top, p)
    if made != "sink":
        idx, amount = made
        p[idx] = amount
    share = 4 if kind == "sink" else 16
    others = rng.choice(len(p), size=max(1, len(p) // share), replace=False)
    if kind == "integer_ties":
        step = rng.integers(0, 3, len(others)).astype(np.float32) * SCALE
    elif kind == "sink":
        step = rng.random(len(others), dtype=np.float32) * np.float32(4e6)
    else:
        step = rng.random(len(others), dtype=np.float32) * np.float32(64.0)
    p[others] = (p[others] + step).astype(np.float32)


@pytest.mark.parametrize("domains", [8, 1024, 8192])
@pytest.mark.parametrize("kind", ["continuous", "integer_ties", "neg_inf_cells",
                                  "one_feasible", "sink"])
def test_candidate_answer_equals_full_scan(kind, domains):
    rng = np.random.default_rng([domains, len(kind)])
    cols = lane_columns(domains)
    b = make_row(kind, domains, rng)
    for k in (1, 2, 4):
        p = np.zeros(domains, np.float32)
        phase, cache, hits = 0, None, 0
        for step in range(48):
            if step % 16 == 0:
                # A phase start: the repair zeroes some prices, so every
                # list of the previous phase is stale.
                phase += 1
                p[rng.random(domains) < 0.3] = 0.0
            want = full_scan(b, p)
            top = None
            if cache is not None and cache[0] == phase:
                got, answers = probe(*cache[1:4], p)
                if answers:
                    assert np.all(p >= cache[4]), "a hit from prices that fell since the scan"
                    assert got[1] == want[1]
                    assert got[0].tobytes() == want[0].tobytes()
                    assert got[2].tobytes() == want[2].tobytes()
                    assert bid(got, p) == bid(want, p)
                    top, hits = got, hits + 1
            if top is None:
                cache = (phase, *build_candidates(b, p, cols, k, rng), p.copy())
                top = want
            raise_prices(p, top, rng, kind)
        if kind == "continuous" and k > 1:
            assert hits > 0


def test_candidates_answer_wrongly_after_a_price_falls():
    """Why lists are tagged by phase: after a price falls, a column that
    was no candidate can beat them, and the rule alone would still answer."""
    cols = lane_columns(8)
    b = np.array([10, 9, 8, 7, 6, 5, 4, 20], np.float32)
    p = np.array([0, 0, 0, 0, 0, 0, 0, 100], np.float32)
    cache = build_candidates(b, p, cols, 2, np.random.default_rng(0))
    p[7] = 0.0  # the phase-start repair zeroes an unowned object's price
    got, answers = probe(*cache, p)
    assert answers and got[1] == 0
    assert full_scan(b, p)[1] == 7
