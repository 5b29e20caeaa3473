"""Models, on the CPU, of what the grouped expert kernel
(`jobset_tpu_torch/ops/csrc/grouped_matmul.cu`) relies on, built from the
constants `ops/grouped_matmul.py` exposes (the card checks that the built
kernel reports the same):

- The tile schedule (`find_tile` in the source, modelled here with numpy):
  over the grid's `row_slots(M, E)` row slots, every row of every group is
  visited by exactly one tile of that group, rows past the last group by
  exactly one zero tile, no tile spans two groups, and the slots past the
  last tile are idle; for uniform, skewed, empty-group and over-full
  routings, M not a multiple of the tile, and more than 32 groups (the
  warp scans in chunks of 32).
- The schedule's tiles, each computed as the kernel masks it (rows past
  the group's end read as zeros and not written, columns past N dropped),
  give exactly the grouped product on integer-valued inputs.
- The shared-memory swizzles: each stage's 16-byte chunks are written
  once, and each 8-lane phase of the `ldmatrix` reads touches all 32
  banks once (no conflicts).
"""

import numpy as np
import pytest

from jobset_tpu_torch.ops import grouped_matmul as gm

BM, BN, THREADS, BK = gm.BM, gm.BN, gm.THREADS, gm.BK


def find_tile(sizes, m, slot):
    """The kernel's find_tile: (group, row0, row_end), group -1 for rows
    past the last group (zeros), -2 for an idle slot. The warp's chunks of
    32 groups, each an inclusive prefix sum, in numpy."""
    sizes = np.maximum(np.asarray(sizes, dtype=np.int64), 0)
    rows_before = tiles_before = 0
    for base in range(0, len(sizes), 32):
        size = sizes[base:base + 32]
        tiles = (size + BM - 1) // BM
        rows_incl, tiles_incl = np.cumsum(size), np.cumsum(tiles)
        t0 = tiles_before + tiles_incl - tiles
        hit = np.nonzero((slot >= t0) & (slot < t0 + tiles))[0]
        if hit.size:
            src = hit[0]
            row0 = rows_before + rows_incl[src] - size[src] + (slot - t0[src]) * BM
            if row0 >= m:
                return -2, 0, 0
            return base + src, row0, min(rows_before + rows_incl[src], m)
        rows_before += rows_incl[-1]
        tiles_before += tiles_incl[-1]
    rest = m - rows_before
    if rest > 0 and tiles_before <= slot < tiles_before + (rest + BM - 1) // BM:
        return -1, rows_before + (slot - tiles_before) * BM, m
    return -2, 0, 0


def _schedule(sizes, m):
    return [find_tile(sizes, m, s) for s in range(gm.row_slots(m, len(sizes)))]


CASES = {
    "uniform": ([2048] * 8, 16384),
    "skewed": ([0, 0, 16384, 0, 0, 0, 0, 0], 16384),
    "empty_groups": ([5000, 0, 0, 3000, 8384, 0, 0, 0], 16384),
    "ragged": ([1, 127, 128, 129, 255, 0, 3], 643),
    "rows_past_the_groups": ([10, 0, 300], 700),
    "no_rows_routed": ([0, 0, 0, 0], 130),
    "over_full": ([100, 200, 300], 250),
    "one_row": ([0, 1], 1),
    "many_groups": (list(np.random.default_rng(0).integers(0, 300, 70)), 11_000),
}


@pytest.mark.parametrize("case", list(CASES))
def test_schedule_visits_every_row_once_and_idles_past_the_end(case):
    sizes, m = CASES[case]
    sizes = np.asarray(sizes)
    starts = np.concatenate([[0], np.cumsum(sizes)])
    owner = np.full(m, -1)  # the group a row belongs to (-1: past the last group)
    for e, size in enumerate(sizes):
        owner[starts[e]:min(starts[e] + size, m)] = e
    seen = np.zeros(m, dtype=np.int64)
    tiles = _schedule(sizes, m)
    used = [i for i, (g, _, _) in enumerate(tiles) if g != -2]
    assert used == list(range(len(used)))  # the busy slots come first
    for group, row0, row_end in tiles:
        if group == -2:
            continue
        rows = np.arange(row0, min(row0 + BM, row_end))
        assert rows.size and row_end <= m
        assert np.all(owner[rows] == group)  # one group's rows (or the zero rows)
        seen[rows] += 1
    assert np.all(seen == 1)
    want_tiles = sum(-(-min(s, max(m - a, 0)) // BM) for s, a in zip(sizes, starts[:-1]))
    want_tiles += -(-max(m - starts[-1], 0) // BM)
    assert len(used) == want_tiles <= gm.row_slots(m, len(sizes))


def test_row_slots_is_reached():
    # Every group holds one row more than whole tiles: each takes an extra
    # tile, and the rows past them one more.
    sizes, m = [BM + 1] * 5, 5 * (BM + 1) + 1
    used = [t for t in _schedule(sizes, m) if t[0] != -2]
    assert len(used) == 2 * 5 + 1 <= gm.row_slots(m, 5)


def _tiled_product(xs, w, sizes, n_cols):
    """The launch as the kernel runs it: every (column tile, row slot)
    block computes its tile with the kernel's masks."""
    m = xs.shape[0]
    y = np.full((m, n_cols), np.nan)
    for group, row0, row_end in _schedule(sizes, m):
        if group == -2:
            continue
        for col0 in range(0, n_cols, BN):
            cols = slice(col0, min(col0 + BN, n_cols))
            a = np.zeros((BM, xs.shape[1]))
            valid = min(BM, row_end - row0)
            a[:valid] = xs[row0:row0 + valid]
            tile = a @ w[group][:, cols] if group >= 0 else np.zeros((BM, cols.stop - col0))
            y[row0:row0 + valid, cols] = tile[:valid]
    return y


@pytest.mark.parametrize("case", ["ragged", "rows_past_the_groups", "over_full", "one_row"])
def test_tiles_give_the_grouped_product(case):
    sizes, m = CASES[case]
    rng = np.random.default_rng(len(sizes))
    k_dim, n_cols = 40, 300  # K not a multiple of the step, N of the tile
    xs = rng.integers(-4, 5, (m, k_dim)).astype(np.float64)
    w = rng.integers(-4, 5, (len(sizes), k_dim, n_cols)).astype(np.float64)
    want = np.zeros((m, n_cols))
    start = 0
    for e, size in enumerate(sizes):
        end = min(start + size, m)
        want[start:end] = xs[start:end] @ w[e]
        start += size
    np.testing.assert_array_equal(_tiled_product(xs, w, sizes, n_cols), want)


# The kernel's swizzles (`a_off`, `b_off`): byte offsets of 16-byte chunk
# ch of row r in a stage's A (rows of 2 BK bytes) and B (rows of 2 BN bytes).
def a_off(row, ch):
    return row * 2 * BK + 16 * (ch ^ (row & 7))


def b_off(row, ch):
    return row * 2 * BN + 16 * (ch ^ (row & 7))


def test_stage_chunks_are_written_once():
    a = sorted(a_off(u // (BK // 8), u % (BK // 8)) for u in range(4 * THREADS))
    b = sorted(b_off(u // (BN // 8), u % (BN // 8)) for u in range(4 * THREADS))
    assert a == list(range(0, BM * BK * 2, 16)) and b == list(range(0, BK * BN * 2, 16))


def _banks(offsets):
    return sorted(b for off in offsets for b in range(off // 4 % 32, off // 4 % 32 + 4))


@pytest.mark.parametrize("warp", range(8))
def test_ldmatrix_phases_are_free_of_bank_conflicts(warp):
    wm, wn = warp // 4, warp % 4
    for k16 in range(BK // 16):
        for mt in range(4):
            lanes = [a_off(64 * wm + 16 * mt + lane % 16, 2 * k16 + lane // 16) for lane in range(32)]
            for phase in range(4):  # one 8x8 matrix: lanes 8 p .. 8 p + 7
                assert _banks(lanes[8 * phase:8 * phase + 8]) == list(range(32))
        for j in range(2):
            lanes = [b_off(16 * k16 + lane % 16, 4 * wn + 2 * j + lane // 16) for lane in range(32)]
            for phase in range(4):
                assert _banks(lanes[8 * phase:8 * phase + 8]) == list(range(32))
