"""Models, on the CPU, of what the grouped expert kernels
(`jobset_tpu_torch/ops/csrc/grouped_matmul.cu`) rely on, built from the
constants `ops/grouped_matmul.py` exposes (the card checks that the built
kernels report the same):

- The tile schedule (`find_tile` in the source, modelled here with numpy):
  over the `row_slots(M, E)` row slots, every row of every group is
  visited by exactly one tile of that group, rows past the last group by
  exactly one zero tile, no tile spans two groups, and the slots past the
  last tile are idle; for uniform, skewed, empty-group and over-full
  routings, M not a multiple of the tile, and more than 32 groups (the
  warp scans in chunks of 32).
- The bf16 TMA kernel's persistent walk: over grids of 1, 7 and 132
  blocks, every (busy row slot, column tile) pair is taken by exactly one
  block, and no block stops before a busy pair.
- The tiles, each computed as its kernel masks it, give exactly the
  grouped product on integer-valued inputs: the `mma.sync` kernels' tiles
  (rows past the group's end read as zeros) and the TMA kernel's boxes
  (the next group's rows, zeros past M, K and N, and stale columns where a
  box lies wholly past N), storing only the group's rows and columns
  below N; at a group boundary beside a full group, a store of the whole
  box would not.
- The shared-memory layouts: the `mma.sync` kernel's swizzled stages are
  written once and each 8-lane phase of its `ldmatrix` reads touches all
  32 banks once; the TMA boxes' 128-byte swizzle and the `wgmma`
  descriptors' address arithmetic (A K-major, B N-major through the
  transpose bit, and the backward's dgrad B K-major from w as it lies)
  name the same element for every (row, k) and (k, column); the TMA
  kernel's ring and barriers fit an SM's shared memory
  and its setmaxnreg split fits the register file.
- The f32 kernel: its `mma.sync.m16n8k8` fragment maps with the permuted
  k and column order give exactly the tile product on integer inputs,
  its A (float2) and B (float4) fragment reads and its loads are free of
  bank conflicts at the chosen pitches, its ring fits a block's shared
  memory, and the 3xTF32 split at K = 4096, with the
  tensor core's truncating sums started afresh every K step and added to
  the output in f32, keeps the product within the f32 tolerance (where
  one TF32 pass, or one truncating chain over all of K, does not).
- The backward's wgrad kernels (dw[e] = xs[seg_e]^T dy[seg_e], ragged on
  the contraction): their grid writes every (expert, K tile, N tile) of dw
  once, an empty expert's as zeros; each block walks its segment's rows
  once, in order from the first, in steps whose rows outside the segment
  are masked (a step across a group boundary would otherwise add the
  neighbour's rows); the walk gives exactly the per-expert products on
  integer inputs. The bf16 TMA kernel's persistent walk takes every
  (expert, K tile, N tile) once over grids of 1, 7 and 132 blocks; its
  boxes (the next group's rows and
  zeros past M, stale boxes past K and N), with the rows past the
  segment zeroed in shared memory, give the per-expert products exactly
  (and would not unzeroed); zeroing a row's 128 bytes zeroes exactly that
  row of a swizzled box; its `wgmma` A descriptor (xs^T read M-major
  through the transpose bit) names the elements TMA wrote; its epilogue
  (each consumer warpgroup's 64 x 256 outputs staged as four 128-byte
  swizzled TMA store boxes, then stored by TMA through a 3-D map over dw)
  writes each output to its own staging bytes, which are the bytes each
  store box reads as that element, free of bank conflicts across a warp;
  the boxes, clipped at the expert's own K and at N, and the empty
  experts' zero stores write each (e, k, n) of dw once (a 2-D map over E K
  rows would write a partial K tile into the next expert); the staging
  and the barriers fit the launch's shared memory. The bf16
  fallback's `ldmatrix.trans` reads of the
  transposed xs give `mma.sync` m16n8k16's A fragments (and, with dy's
  reads, the tile product), free of bank conflicts, and its stage is
  written once; the f32 kernel's fragment maps at the 136-float pitch give
  the tile product, its reads and loads are free of bank conflicts, and
  its sums promoted every step of 32 rows hold the f32 tolerance over a
  segment of 16384 rows (where one truncating chain does not); both rings
  fit their blocks an SM.
- The f32 wgrad TMA kernel (3xTF32 on tf32 `wgmma`, A = xs^T from
  registers, B = dy split and written K-major by the consumer warps): the
  transform's and the A reads name the elements TMA put in the 128-byte
  swizzled f32 boxes; the transform writes each float of B's tile once, and
  the K-major tf32 descriptor of each k8 step reads at (k, column) the
  step's row that A's register fragment (rows 8j + 2c and + 1 for its k c
  and c + 4) pairs with it, zeros past the segment; so A's fragments and B
  give each warpgroup's 64 K rows of the step's product exactly; its reads
  and writes are free of bank conflicts (A in the fragment's own row order
  would not be); the whole launch (boxes of 32 columns, stale boxes past K
  and N, rows past the segment zeroed in A and B, sums promoted every
  WT_PROMOTE rows, stores inside K and N, empty experts' zeros) gives the
  per-expert products, and a neighbour's non-finite row meets only zeros;
  its persistent walk takes every tile once; its promotion interval holds
  the tolerance over 16384 rows; its ring, B buffers and registers fit.
"""

import functools

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


# --- the bf16 TMA kernel (`grouped_mm_tma_kernel`) ---------------------------

TMA_BN, TMA_BK, TMA_STAGES = gm.TMA_BN, gm.TMA_BK, gm.TMA_STAGES
TMA_A_BYTES, TMA_B_BOX = BM * TMA_BK * 2, TMA_BK * 64 * 2
TMA_STAGE = TMA_A_BYTES + TMA_BN // 64 * TMA_B_BOX
SMEM_OPT_IN = 232_448  # the most shared memory a block may ask for
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233_472, 1024
REGISTERS_PER_SM = 65_536


def walk(sizes, m, n_cols, grid):
    """The persistent walk: block b takes tiles b, b + grid, ... of
    row_slots x column tiles (column tiles fastest) and stops at the first
    idle slot. Returns each block's (slot, column tile) pairs."""
    col_tiles = -(-n_cols // TMA_BN)
    tiles = gm.row_slots(m, len(sizes)) * col_tiles
    taken = []
    for b in range(min(grid, tiles)):
        mine = []
        for t in range(b, tiles, grid):
            if find_tile(sizes, m, t // col_tiles)[0] == -2:
                break
            mine.append((t // col_tiles, t % col_tiles))
        taken.append(mine)
    return taken


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("case", list(CASES))
def test_persistent_walk_takes_every_busy_tile_once(case, grid):
    sizes, m = CASES[case]
    n_cols = 1000  # four column tiles, the last one ragged
    col_tiles = -(-n_cols // TMA_BN)
    busy = [s for s, (g, _, _) in enumerate(_schedule(sizes, m)) if g != -2]
    taken = [pair for mine in walk(sizes, m, n_cols, grid) for pair in mine]
    assert sorted(taken) == [(s, c) for s in busy for c in range(col_tiles)]


def _box(src, row0, rows, col0, cols):
    """A TMA box: src[row0:row0 + rows, col0:col0 + cols], zeros past the
    tensor's edges."""
    out = np.zeros((rows, cols))
    part = src[row0:row0 + rows, col0:col0 + cols]
    out[:part.shape[0], :part.shape[1]] = part
    return out


def _tma_product(xs, w, sizes, n_cols, masked=True):
    """The TMA kernel's launch on the CPU: each busy tile's A box (rows
    row0 .. row0 + 127, whichever group they belong to), its B boxes (64 k
    x 64 columns of the tile's expert; a box wholly past N is not loaded
    and holds stale values), K in steps of TMA_BK; the consumers store the
    group's rows (all 128 with masked=False) and columns below N."""
    m, k_dim = xs.shape
    y = np.full((m, n_cols), np.nan)
    stale = np.random.default_rng(7).integers(-50, 50, (TMA_BK, 64)).astype(np.float64)
    for mine in walk(sizes, m, n_cols, 7):
        for slot, ct in mine:
            group, row0, row_end = find_tile(sizes, m, slot)
            col0 = ct * TMA_BN
            if group == -1:
                y[row0:min(row_end, row0 + BM), col0:col0 + TMA_BN] = 0
                continue
            acc = np.zeros((BM, TMA_BN))
            for k0 in range(0, k_dim, TMA_BK):
                a = _box(xs, row0, BM, k0, TMA_BK)
                b = np.concatenate([
                    _box(w[group].T, col0 + 64 * j, 64, k0, TMA_BK).T if col0 + 64 * j < n_cols
                    else stale for j in range(TMA_BN // 64)], axis=1)
                acc += a @ b
            end = min(row_end if masked else m, row0 + BM)
            cols = min(TMA_BN, n_cols - col0)
            y[row0:end, col0:col0 + cols] = acc[:end - row0, :cols]
    return y


def _grouped_reference(xs, w, sizes):
    m = xs.shape[0]
    want = np.zeros((m, w.shape[-1]))
    start = 0
    for e, size in enumerate(sizes):
        end = min(start + size, m)
        want[start:end] = xs[start:end] @ w[e]
        start += size
    return want


# Group 0 ends 64 rows into a tile whose other rows belong to group 1, full
# there: a store of the whole box races group 1's own tile.
BOUNDARY = ([BM * 2 + 64, BM * 2 - 64 + 3, 5], BM * 5 - 20)


@pytest.mark.parametrize("case", ["ragged", "rows_past_the_groups", "over_full", "one_row",
                                  "boundary"])
def test_tma_tiles_give_the_grouped_product(case):
    sizes, m = BOUNDARY if case == "boundary" else CASES[case]
    rng = np.random.default_rng(len(sizes) + m)
    k_dim, n_cols = 72, 328  # K past one step; the last column tile has one box and a part
    xs = rng.integers(-4, 5, (m, k_dim)).astype(np.float64)
    w = rng.integers(-4, 5, (len(sizes), k_dim, n_cols)).astype(np.float64)
    want = _grouped_reference(xs, w, sizes)
    np.testing.assert_array_equal(_tma_product(xs, w, sizes, n_cols), want)
    if case == "boundary":
        assert not np.array_equal(_tma_product(xs, w, sizes, n_cols, masked=False), want)


def swizzle128(addr):
    """CU_TENSOR_MAP_SWIZZLE_128B / the wgmma 128B layout on a shared
    address: the 16-byte chunk bits (4-6) xor the 128-byte row bits (7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_box_address(base, row, col_bytes):
    """Where TMA puts byte col_bytes of row `row` of a box with 128-byte
    rows at a 1024-byte aligned base."""
    return swizzle128(base + row * 128 + col_bytes)


def sw128_desc(start, lbo, sbo):
    """The kernel's `sw128_desc` bits."""
    return (start & 0x3FFFF) >> 4 | (lbo >> 4) << 16 | (sbo >> 4) << 32 | 1 << 62


def desc_fields(desc):
    return ((desc & 0x3FFF) << 4, (desc >> 16 & 0x3FFF) << 4, (desc >> 32 & 0x3FFF) << 4, desc >> 62)


def wgmma_a_address(desc, m, k, elem=2):
    """Element (m, k) of a K-major operand (64 x 16 bf16, or with elem 4
    rows of 8 tf32: a K-major B's column m) in the 128B layout: 8-row
    groups SBO apart, 128-byte rows, then the swizzle."""
    start, _, sbo, kind = desc_fields(desc)
    assert kind == 1
    return swizzle128(start + (m // 8) * sbo + (m % 8) * 128 + elem * k)


def wgmma_b_address(desc, k, n, elem=2):
    """Element (k, n) of an N-major B operand (16 x 256 bf16, the
    transpose bit) in the 128B layout: blocks of 128 bytes of columns LBO
    apart, 8-row k groups SBO apart, 128-byte rows, then the swizzle."""
    start, lbo, sbo, kind = desc_fields(desc)
    assert kind == 1
    cols = 128 // elem
    return swizzle128(start + (n // cols) * lbo + (k // 8) * sbo + (k % 8) * 128 + elem * (n % cols))


@pytest.mark.parametrize("stage", range(TMA_STAGES))
def test_wgmma_descriptors_name_the_elements_tma_wrote(stage):
    ring = 3 * 1024  # any 1024-byte aligned start of the ring
    a_s = ring + stage * TMA_STAGE
    b_s = a_s + TMA_A_BYTES
    assert a_s % 1024 == 0 and b_s % 1024 == 0 and TMA_B_BOX % 1024 == 0
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for wg in range(2):
        for kk in range(TMA_BK // 16):
            desc = sw128_desc(a_s + wg * 64 * 128 + 32 * kk, 16, 1024)
            got = wgmma_a_address(desc, m, k)
            want = tma_box_address(a_s, 64 * wg + m, 2 * (16 * kk + k))
            np.testing.assert_array_equal(got, want)
    k, n = np.meshgrid(np.arange(16), np.arange(TMA_BN), indexing="ij")
    for kk in range(TMA_BK // 16):
        desc = sw128_desc(b_s + 2048 * kk, TMA_B_BOX, 1024)
        got = wgmma_b_address(desc, k, n)
        want = tma_box_address(b_s + (n // 64) * TMA_B_BOX, 16 * kk + k, 2 * (n % 64))
        np.testing.assert_array_equal(got, want)
    # A box's swizzle is a permutation of its bytes' 16-byte chunks.
    chunks = sorted(tma_box_address(a_s, r, 16 * c) for r in range(BM) for c in range(8))
    assert chunks == list(range(a_s, a_s + TMA_A_BYTES, 16))


@pytest.mark.parametrize("stage", range(TMA_STAGES))
def test_wgmma_k_major_b_descriptors_name_the_elements_tma_wrote(stage):
    # dgrad's instantiation: w [E, N, K] as it lies, B boxes of 64 columns
    # x 64 k (128-byte swizzled rows of k, as A's) back to back, read by
    # wgmma K-major (transpose bit off) with A's strides.
    b_s = 3 * 1024 + stage * TMA_STAGE + TMA_A_BYTES
    n, k = np.meshgrid(np.arange(TMA_BN), np.arange(16), indexing="ij")
    for kk in range(TMA_BK // 16):
        desc = sw128_desc(b_s + 32 * kk, 16, 1024)
        got = wgmma_a_address(desc, n, k)  # K-major: (row n, k) as A's (row m, k)
        want = tma_box_address(b_s + (n // 64) * TMA_B_BOX, n % 64, 2 * (16 * kk + k))
        np.testing.assert_array_equal(got, want)


def test_tma_ring_and_registers_fit_the_sm():
    assert gm.TMA_SMEM == (1024 + TMA_STAGES * TMA_STAGE + BM * gm.TMA_OUT_PITCH
                           + 2 * TMA_STAGES * 8) <= SMEM_OPT_IN
    assert gm.TMA_SMEM + SMEM_PER_BLOCK_RESERVED <= SMEM_PER_SM
    # setmaxnreg: a producer warpgroup and two consumer warpgroups of 128
    # threads; at entry every thread has the launch's 65536 / 384 rounded
    # down to a multiple of 8 (168), the hand-over keeps the total.
    assert gm.TMA_THREADS == 3 * 128
    entry = REGISTERS_PER_SM // gm.TMA_THREADS // 8 * 8
    assert 128 * (gm.PRODUCER_REGS + 2 * gm.CONSUMER_REGS) <= entry * gm.TMA_THREADS
    assert entry * gm.TMA_THREADS <= REGISTERS_PER_SM
    assert gm.PRODUCER_REGS % 8 == 0 and gm.CONSUMER_REGS % 8 == 0 and gm.CONSUMER_REGS <= 255
    # Each consumer thread's m64n256 accumulators: 128 f32.
    assert 64 * TMA_BN // 128 == 128 < gm.CONSUMER_REGS


def test_tma_staged_output_is_free_of_bank_conflicts_and_copies_whole_rows():
    pitch = gm.TMA_OUT_PITCH
    # Lane (g, c) of a warp writes rows g and g + 8 of its 16, columns 8j +
    # 2c and + 1 (4 bytes) of n8 tile j: each write touches 32 banks once.
    for h in range(2):
        for j in range(TMA_BN // 8):
            words = [((lane // 4 + 8 * h) * pitch + 2 * (8 * j + 2 * (lane % 4))) // 4
                     for lane in range(32)]
            assert _phase_banks(words, 1)
    # Each row's bulk copy: a 16-byte aligned source and a multiple of 16
    # bytes for any N that is a multiple of 8 (and the ring's end, where the
    # staging starts, is 16-byte aligned).
    assert pitch % 16 == 0 and (TMA_STAGES * TMA_STAGE) % 16 == 0
    for n_cols in range(8, 1000, 8):
        for col0 in range(0, n_cols, TMA_BN):
            assert 2 * min(TMA_BN, n_cols - col0) % 16 == 0


# --- the f32 kernel (3xTF32 on mma.sync.m16n8k8) -----------------------------

F_BK, F_AP, F_BP = gm.F_BK, gm.F_AP, gm.F_BP
F_WARPS = THREADS // 32  # 2 x 4 warps of 64 x 32


def f32_b_column(wn, g, nt):
    """The physical column (of the tile) of logical column g of n8 tile nt
    in warp column wn."""
    return 32 * wn + 4 * g + nt


def f32_fragments(a_stage, b_stage, warp, lane, j):
    """The kernel's reads for k8 step j of warp `warp`, lane `lane`: A
    fragments of m16 tiles 0-3 (float2 pairs at rows g and g + 8,
    physical k 8j + 2c and + 1), B fragments of n8 tiles 0-3 (a float4
    quad at each of k rows 8j + 2c and + 1, columns 32 wn + 4g ..)."""
    wm, wn, g, c = warp // 4, warp % 4, lane // 4, lane % 4
    a = []
    for mt in range(4):
        at = (64 * wm + 16 * mt + g) * F_AP + 8 * j + 2 * c
        lo, hi = a_stage[at:at + 2], a_stage[at + 8 * F_AP:at + 8 * F_AP + 2]
        a.append([lo[0], hi[0], lo[1], hi[1]])
    bt = (8 * j + 2 * c) * F_BP + 32 * wn + 4 * g
    b0, b1 = b_stage[bt:bt + 4], b_stage[bt + F_BP:bt + F_BP + 4]
    return a, [[b0[nt], b1[nt]] for nt in range(4)]


def mma_m16n8k8(a_frags, b_frags):
    """mma.sync.m16n8k8 over a warp's fragments (PTX ISA maps): A (row g,
    k c), (g + 8, c), (g, c + 4), (g + 8, c + 4); B (k c, column g), (c +
    4, g). Returns D [16, 8]."""
    a, b = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        a[g, c], a[g + 8, c], a[g, c + 4], a[g + 8, c + 4] = a_frags[lane]
        b[c, g], b[c + 4, g] = b_frags[lane]
    return a @ b


def test_f32_fragment_maps_give_the_tile_product():
    rng = np.random.default_rng(3)
    a_tile = rng.integers(-5, 6, (BM, F_BK)).astype(np.float64)
    b_tile = rng.integers(-5, 6, (F_BK, BN)).astype(np.float64)
    a_stage = np.zeros(BM * F_AP)
    b_stage = np.zeros(F_BK * F_BP)
    for r in range(BM):
        a_stage[r * F_AP:r * F_AP + F_BK] = a_tile[r]
    for k in range(F_BK):
        b_stage[k * F_BP:k * F_BP + BN] = b_tile[k]
    y = np.full((BM, BN), np.nan)
    for warp in range(F_WARPS):
        acc = np.zeros((4, 4, 16, 8))
        for j in range(F_BK // 8):
            frags = [f32_fragments(a_stage, b_stage, warp, lane, j) for lane in range(32)]
            for mt in range(4):
                for nt in range(4):
                    acc[mt, nt] += mma_m16n8k8([f[0][mt] for f in frags], [f[1][nt] for f in frags])
        # The epilogue: lane (g, c) holds, for row g (+ 8), n8 tile nt's
        # accumulator columns 2c and 2c + 1, stored at the physical columns
        # of logical columns 2c and 2c + 1.
        wm, wn = warp // 4, warp % 4
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for mt in range(4):
                for h in range(2):
                    row = 64 * wm + 16 * mt + g + 8 * h
                    for nt in range(4):
                        for e in range(2):
                            y[row, f32_b_column(wn, 2 * c + e, nt)] = acc[mt, nt, g + 8 * h, 2 * c + e]
    np.testing.assert_array_equal(y, a_tile @ b_tile)


def test_f32_epilogue_columns_are_runs_of_8():
    # Lane (g, c)'s columns of a row: 32 wn + 8c .. + 7 (two float4
    # stores), and the warp's lanes cover its 32 once.
    for wn in range(4):
        cols = []
        for c in range(4):
            mine = sorted(f32_b_column(wn, 2 * c + e, nt) for nt in range(4) for e in range(2))
            assert mine == [32 * wn + 8 * c + i for i in range(8)]
            cols += mine
        assert sorted(cols) == list(range(32 * wn, 32 * wn + 32))


def _phase_banks(words_by_lane, width):
    """Bank conflicts of one warp-wide shared access of `width` words a
    lane: the hardware serves 32 // width lanes a phase; each phase must
    touch every bank at most once."""
    per = 32 // width
    for p0 in range(0, 32, per):
        banks = [(w + e) % 32 for w in words_by_lane[p0:p0 + per] for e in range(width)]
        if len(set(banks)) != len(banks):
            return False
    return True


@pytest.mark.parametrize("warp", range(F_WARPS))
def test_f32_fragment_reads_are_free_of_bank_conflicts(warp):
    wm, wn = warp // 4, warp % 4
    for j in range(F_BK // 8):
        for mt in range(4):
            for h in range(2):
                words = [(64 * wm + 16 * mt + lane // 4 + 8 * h) * F_AP + 8 * j + 2 * (lane % 4)
                         for lane in range(32)]
                assert _phase_banks(words, 2)
        for e in range(2):
            words = [(8 * j + 2 * (lane % 4) + e) * F_BP + 32 * wn + 4 * (lane // 4)
                     for lane in range(32)]
            assert _phase_banks(words, 4)
    # The pitches the kernel chose: 8 and 4 words past a multiple of 32.
    assert F_AP % 32 == 8 and F_BP % 32 == 4


def test_f32_loads_cover_the_stage_once_without_conflicts():
    a_chunks, b_chunks = [], []
    for i in range(4):
        for warp in range(THREADS // 32):
            a_words, b_words = [], []
            for lane in range(32):
                u = 32 * warp + lane + i * THREADS
                a_words.append((u // 8) * F_AP + 4 * (u % 8))
                b_words.append((u // 32) * F_BP + 4 * (u % 32))
            assert _phase_banks(a_words, 4) and _phase_banks(b_words, 4)
            a_chunks += a_words
            b_chunks += b_words
    assert sorted(a_chunks) == [r * F_AP + 4 * c for r in range(BM) for c in range(F_BK // 4)]
    assert sorted(b_chunks) == [k * F_BP + 4 * c for k in range(F_BK) for c in range(BN // 4)]
    # The ring fits a block's shared memory.
    assert gm.SMEM_F32 == gm.F_STAGES * (BM * F_AP + F_BK * F_BP) * 4 <= SMEM_OPT_IN


def tf32_rna(x):
    """cvt.rna.tf32.f32, as the kernel's split_tf32 writes it out."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    big = tf32_rna(x)
    return big, tf32_rna(np.asarray(x, np.float32) - big)


def _rz(x):
    """float64 -> float32 rounded toward zero, as the tensor core's f32
    accumulator rounds its sums (it keeps no extra bits and truncates)."""
    near = x.astype(np.float32)
    over = np.abs(near.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(near, np.float32(0)), near)


def _mma_chain(terms, k_dim, step):
    """The kernel's sums: each m16n8k8 adds its 8 (exact) TF32 products to
    its accumulator, rounded toward zero, the three terms in the kernel's
    order; every `step` of K the step's accumulator (started from zero)
    is added to the output's in f32, rounded to nearest."""
    out = np.zeros((terms[0][0].shape[0], terms[0][1].shape[1]), np.float32)
    for s0 in range(0, k_dim, step):
        part = np.zeros_like(out)
        for k0 in range(s0, min(s0 + step, k_dim), 8):
            ks = slice(k0, k0 + 8)
            for a, b in terms:
                part = _rz(part.astype(np.float64) + a[:, ks].astype(np.float64) @ b[ks].astype(np.float64))
        out = (out + part).astype(np.float32)
    return out


@pytest.mark.parametrize("k_dim", [1024, 4096])
def test_3xtf32_split_holds_the_f32_tolerance_at_the_prefill_depth(k_dim):
    # The prefill's operands (randn rows, weights randn / sqrt(K)); the
    # card's tolerance for the f32 kernel against true f32: 1e-5 max|want|.
    rng = np.random.default_rng(k_dim)
    a = rng.standard_normal((64, k_dim)).astype(np.float32)
    b = (rng.standard_normal((k_dim, 64)) / np.sqrt(k_dim)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    limit = 1e-5 * np.abs(want).max()
    (ab, as_), (bb, bs) = _split(a), _split(b)
    three = [(as_, bb), (ab, bs), (ab, bb)]
    got = _mma_chain(three, k_dim, F_BK)
    assert np.abs(got - want).max() <= limit / 2
    # One TF32 pass would not hold it; nor, at K = 4096, one chain of the
    # tensor core's truncating adds over all of K.
    assert np.abs(_mma_chain([(tf32_rna(a), tf32_rna(b))], k_dim, F_BK) - want).max() > limit
    if k_dim == 4096:
        assert np.abs(_mma_chain(three, k_dim, k_dim) - want).max() > limit


# --- the backward's wgrad kernels ---------------------------------------------

W_BR, W_STAGES, WF_BR, WF_P = gm.W_BR, gm.W_STAGES, gm.WF_BR, gm.WF_P


def segment(sizes, m, e):
    """The kernel's `segment`: expert e's rows [start, end), clamped to M."""
    before = int(np.maximum(np.asarray(sizes[:e], np.int64), 0).sum())
    return min(before, m), min(before + max(int(sizes[e]), 0), m)


def wgrad_walk(sizes, m, step, masked=True):
    """Each expert's steps as its blocks walk them: the rows each step
    loads (start + step * s .. + step - 1, those at or past M dropped) and
    which of them are live (inside the segment; all with masked=False)."""
    walks = []
    for e in range(len(sizes)):
        start, end = segment(sizes, m, e)
        steps = []
        for s0 in range(start, end, step):
            rows = np.arange(s0, min(s0 + step, m))
            steps.append((rows, rows < end if masked else np.ones(rows.size, bool)))
        walks.append(steps)
    return walks


def wgrad_product(xs, dy, sizes, step, masked=True):
    """The launch on the CPU: every (N tile, K tile, expert) block of BN x
    BN, its segment's steps summed in order, zeros for an empty segment."""
    m, k_dim = xs.shape
    n_cols = dy.shape[1]
    dw = np.full((len(sizes), k_dim, n_cols), np.nan)
    walks = wgrad_walk(sizes, m, step, masked)
    for e in range(len(sizes)):
        for k0 in range(0, k_dim, BN):
            for n0 in range(0, n_cols, BN):
                ks, ns = slice(k0, min(k0 + BN, k_dim)), slice(n0, min(n0 + BN, n_cols))
                acc = np.zeros((ks.stop - k0, ns.stop - n0))
                for rows, live in walks[e]:
                    acc += (xs[rows, ks] * live[:, None]).T @ (dy[rows, ns] * live[:, None])
                assert np.all(np.isnan(dw[e, ks, ns]))  # written once
                dw[e, ks, ns] = acc
    return dw


def _wgrad_reference(xs, dy, sizes):
    dw = np.zeros((len(sizes), xs.shape[1], dy.shape[1]))
    for e in range(len(sizes)):
        start, end = segment(sizes, xs.shape[0], e)
        dw[e] = xs[start:end].T @ dy[start:end]
    return dw


@pytest.mark.parametrize("step", [W_BR, WF_BR], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_wgrad_walk_takes_each_segment_row_once_in_order(case, step):
    sizes, m = CASES[case]
    for e, steps in enumerate(wgrad_walk(sizes, m, step)):
        start, end = segment(sizes, m, e)
        live = np.concatenate([rows[ok] for rows, ok in steps]) if steps else np.zeros(0, int)
        np.testing.assert_array_equal(live, np.arange(start, end))  # once each, in order
        if start == end:
            assert steps == []  # an empty expert's blocks write zeros and walk nothing


@pytest.mark.parametrize("step", [W_BR, WF_BR], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", ["ragged", "rows_past_the_groups", "over_full", "one_row",
                                  "boundary", "empty_groups_small"])
def test_wgrad_blocks_give_the_per_expert_products(case, step):
    sizes, m = {"boundary": BOUNDARY,
                "empty_groups_small": ([70, 0, 0, 30, 100, 0], 200)}.get(case) or CASES[case]
    rng = np.random.default_rng(len(sizes) + m + step)
    k_dim, n_cols = 136, 300  # the last K and N tiles ragged
    xs = rng.integers(-4, 5, (m, k_dim)).astype(np.float64)
    dy = rng.integers(-4, 5, (m, n_cols)).astype(np.float64)
    want = _wgrad_reference(xs, dy, sizes)
    got = wgrad_product(xs, dy, sizes, step)
    np.testing.assert_array_equal(got, want)
    for e, size in enumerate(sizes):
        if segment(sizes, m, e)[0] == segment(sizes, m, e)[1]:
            assert np.all(got[e] == 0)
    if case == "boundary":  # unmasked steps add the next group's rows
        assert not np.array_equal(wgrad_product(xs, dy, sizes, step, masked=False), want)


def test_wgrad_grid_writes_every_tile_once():
    # The grid (N tiles, K tiles, experts) over dw's tiles: one block each
    # (`wgrad_product` asserts each tile is written once, and NaNs mark any
    # left unwritten).
    sizes, m = [3, 0, 5], 8
    rng = np.random.default_rng(0)
    dw = wgrad_product(rng.standard_normal((m, 300)), rng.standard_normal((m, 260)), sizes, W_BR)
    assert not np.isnan(dw).any() and np.all(dw[1] == 0)


def ldmatrix(stage, addrs, trans):
    """ldmatrix.x4 on a stage of bf16 values (indexed by byte offset / 2):
    matrix q's eight rows are the 8 values at lanes 8q .. 8q + 7's byte
    addresses; lane T gets, of each matrix, (row T // 4, columns 2 (T % 4)
    and + 1), or with .trans (rows 2 (T % 4) and + 1, column T // 4).
    Returns [lane][matrix] pairs."""
    out = [[None] * 4 for _ in range(32)]
    for q in range(4):
        mat = np.array([stage[addrs[8 * q + r] // 2:addrs[8 * q + r] // 2 + 8] for r in range(8)])
        for lane in range(32):
            g, c = lane // 4, lane % 4
            out[lane][q] = ((mat[2 * c, g], mat[2 * c + 1, g]) if trans
                            else (mat[g, 2 * c], mat[g, 2 * c + 1]))
    return out


def mma_m16n8k16(a_regs, b_regs):
    """mma.sync.m16n8k16 (PTX ISA maps): A a0 (row g, k 2c, 2c + 1), a1 (g +
    8, ..), a2 (g, k 2c + 8, ..), a3 (g + 8, k 2c + 8, ..); B b0 (k 2c, 2c +
    1, column g), b1 (k 2c + 8, ..). Returns D [16, 8]."""
    a, b = np.zeros((16, 16)), np.zeros((16, 8))
    for lane in range(32):
        g, c = lane // 4, lane % 4
        for reg, (row, k) in enumerate(((g, 2 * c), (g + 8, 2 * c), (g, 2 * c + 8),
                                        (g + 8, 2 * c + 8))):
            a[row, k:k + 2] = a_regs[lane][reg]
        for reg in range(2):
            b[2 * c + 8 * reg:2 * c + 8 * reg + 2, g] = b_regs[lane][reg]
    return a @ b


def _wgrad_stage(tile):
    """A bf16 wgrad stage (W_BR rows of 128 values) as the loader writes it:
    16-byte chunk ch of row r at b_off(r, ch)."""
    stage = np.full(W_BR * BN, np.nan)
    for r in range(W_BR):
        for ch in range(BN // 8):
            stage[b_off(r, ch) // 2:b_off(r, ch) // 2 + 8] = tile[r, 8 * ch:8 * ch + 8]
    return stage


def test_wgrad_bf16_fragments_give_the_tile_product():
    rng = np.random.default_rng(9)
    x_tile = rng.integers(-5, 6, (W_BR, BN)).astype(np.float64)  # rows of xs, K columns
    d_tile = rng.integers(-5, 6, (W_BR, BN)).astype(np.float64)  # rows of dy, N columns
    x_s, d_s = _wgrad_stage(x_tile), _wgrad_stage(d_tile)
    assert not np.isnan(x_s).any()  # the loader fills the stage
    got = np.full((BN, BN), np.nan)
    for warp in range(THREADS // 32):
        wm, wn = warp // 4, warp % 4
        acc = np.zeros((4, 4, 16, 8))
        for k16 in range(W_BR // 16):
            for mt in range(4):
                a = ldmatrix(x_s, [b_off(16 * k16 + lane % 8 + 8 * (lane // 16),
                                         8 * wm + 2 * mt + (lane // 8) % 2) for lane in range(32)],
                             trans=True)
                for j in range(2):
                    r = ldmatrix(d_s, [b_off(16 * k16 + lane % 16, 4 * wn + 2 * j + lane // 16)
                                       for lane in range(32)], trans=True)
                    for half in range(2):
                        b = [(r[lane][2 * half], r[lane][2 * half + 1]) for lane in range(32)]
                        acc[mt, 2 * j + half] += mma_m16n8k16(a, b)
        for mt in range(4):
            for nt in range(4):
                rows = slice(64 * wm + 16 * mt, 64 * wm + 16 * mt + 16)
                got[rows, 32 * wn + 8 * nt:32 * wn + 8 * nt + 8] = acc[mt, nt]
    np.testing.assert_array_equal(got, x_tile.T @ d_tile)


@pytest.mark.parametrize("warp", range(8))
def test_wgrad_bf16_transposed_reads_are_free_of_bank_conflicts(warp):
    wm = warp // 4
    for k16 in range(W_BR // 16):
        for mt in range(4):
            lanes = [b_off(16 * k16 + lane % 8 + 8 * (lane // 16), 8 * wm + 2 * mt + (lane // 8) % 2)
                     for lane in range(32)]
            for phase in range(4):
                assert _banks(lanes[8 * phase:8 * phase + 8]) == list(range(32))


def test_wgrad_bf16_stage_is_written_once_and_fits_a_block():
    chunks = sorted(b_off(u // 16, u % 16) for u in range(4 * THREADS))
    assert chunks == list(range(0, W_BR * BN * 2, 16))
    assert gm.SMEM_W_BF16 == W_STAGES * 2 * W_BR * BN * 2 <= SMEM_OPT_IN


def wf32_fragments(x_stage, d_stage, warp, lane, j):
    """The f32 wgrad kernel's reads for k8 step j: A(i, k) = xs row k,
    column i, as (k c, row g), (c, g + 8), (c + 4, g), (c + 4, g + 8) of
    each m16 tile; B (k c, column g), (c + 4, g) of each n8 tile."""
    wm, wn, g, c = warp // 4, warp % 4, lane // 4, lane % 4
    x0 = (8 * j + c) * WF_P + 64 * wm + g
    d0 = (8 * j + c) * WF_P + 32 * wn + g
    a = [[x_stage[x0 + 16 * mt], x_stage[x0 + 16 * mt + 8], x_stage[x0 + 4 * WF_P + 16 * mt],
          x_stage[x0 + 4 * WF_P + 16 * mt + 8]] for mt in range(4)]
    b = [[d_stage[d0 + 8 * nt], d_stage[d0 + 4 * WF_P + 8 * nt]] for nt in range(4)]
    return a, b


def test_wgrad_f32_fragments_give_the_tile_product():
    rng = np.random.default_rng(10)
    x_tile = rng.integers(-5, 6, (WF_BR, BN)).astype(np.float64)
    d_tile = rng.integers(-5, 6, (WF_BR, BN)).astype(np.float64)
    x_s, d_s = np.zeros(WF_BR * WF_P), np.zeros(WF_BR * WF_P)
    for r in range(WF_BR):
        x_s[r * WF_P:r * WF_P + BN], d_s[r * WF_P:r * WF_P + BN] = x_tile[r], d_tile[r]
    got = np.full((BN, BN), np.nan)
    for warp in range(THREADS // 32):
        wm, wn = warp // 4, warp % 4
        acc = np.zeros((4, 4, 16, 8))
        for j in range(WF_BR // 8):
            frags = [wf32_fragments(x_s, d_s, warp, lane, j) for lane in range(32)]
            for mt in range(4):
                for nt in range(4):
                    acc[mt, nt] += mma_m16n8k8([f[0][mt] for f in frags], [f[1][nt] for f in frags])
        # The epilogue: accumulator (row g, columns 2c, 2c + 1), then g + 8.
        for mt in range(4):
            for nt in range(4):
                rows = slice(64 * wm + 16 * mt, 64 * wm + 16 * mt + 16)
                got[rows, 32 * wn + 8 * nt:32 * wn + 8 * nt + 8] = acc[mt, nt]
    np.testing.assert_array_equal(got, x_tile.T @ d_tile)


@pytest.mark.parametrize("warp", range(F_WARPS))
def test_wgrad_f32_reads_and_loads_are_free_of_bank_conflicts(warp):
    wm, wn = warp // 4, warp % 4
    for j in range(WF_BR // 8):
        for half in range(2):
            for mt in range(4):
                for h in range(2):
                    words = [(8 * j + lane % 4 + 4 * half) * WF_P + 64 * wm + 16 * mt + lane // 4
                             + 8 * h for lane in range(32)]
                    assert _phase_banks(words, 1)
            for nt in range(4):
                words = [(8 * j + lane % 4 + 4 * half) * WF_P + 32 * wn + 8 * nt + lane // 4
                         for lane in range(32)]
                assert _phase_banks(words, 1)
    # The loader's 16-byte copies: a stage's rows once, each phase of 8
    # lanes on distinct banks.
    if warp == 0:
        chunks = []
        for i in range(4):
            for w in range(THREADS // 32):
                words = [((32 * w + lane + i * THREADS) // 32) * WF_P
                         + 4 * ((32 * w + lane + i * THREADS) % 32) for lane in range(32)]
                assert _phase_banks(words, 4)
                chunks += words
        assert sorted(chunks) == [r * WF_P + 4 * q for r in range(WF_BR) for q in range(BN // 4)]
        assert WF_P % 32 == 8
        assert gm.SMEM_W_F32 == gm.WF_STAGES * 2 * WF_BR * WF_P * 4 <= SMEM_OPT_IN


@pytest.mark.parametrize("interval", [WF_BR, gm.WT_PROMOTE], ids=["mma_sync", "tma"])
def test_wgrad_f32_promotion_holds_the_tolerance_over_a_whole_segment(interval):
    # A skewed routing gives one expert every row: 16384 at the flagship.
    # Each interval's truncating sums (a step of 32 rows in the mma.sync
    # kernel, WT_PROMOTE rows in the TMA kernel, one rounding a k8
    # instruction in both) start afresh and are added to the output in f32
    # (rounded to nearest); one chain over all the rows drifts past the
    # card's f32 tolerance, 1e-5 max|want|.
    rows = 16384
    rng = np.random.default_rng(rows)
    xs_t = rng.standard_normal((32, rows)).astype(np.float32)  # A = xs^T
    dy = rng.standard_normal((rows, 32)).astype(np.float32)
    want = xs_t.astype(np.float64) @ dy.astype(np.float64)
    limit = 1e-5 * np.abs(want).max()
    (ab, as_), (bb, bs) = _split(xs_t), _split(dy)
    three = [(as_, bb), (ab, bs), (ab, bb)]
    assert np.abs(_mma_chain(three, rows, interval) - want).max() <= limit / 2
    assert np.abs(_mma_chain(three, rows, rows) - want).max() > limit


# --- the bf16 wgrad TMA kernel (`grouped_wgrad_tma_kernel`) --------------------


W_OUT_BOXES = TMA_BN // 64  # a consumer warpgroup's TMA store boxes, 64 x 64 each


def wgrad_staged_byte(warp, lane, h, j):
    """The kernel's staging address (bytes past its warpgroup's first box)
    of thread `lane` of warp `warp`'s accumulators d[j][2h], d[j][2h + 1]:
    row 16 warp + g + 8h, columns 8j + 2c and + 1 of the warpgroup's 64 x
    256 outputs, at chunk j % 8 ^ g of that row of box j / 8."""
    g, c = lane // 4, lane % 4
    return (j // 8) * TMA_B_BOX + (16 * warp + g + 8 * h) * 128 + 16 * ((j % 8) ^ g) + 4 * c


@functools.cache
def wgrad_staging_map():
    """(64, 256) staging byte of each of a warpgroup's outputs, as its 128
    threads write them (each output written once)."""
    addr = np.full((64, TMA_BN), -1)
    for warp in range(4):
        for lane in range(32):
            g, c = lane // 4, lane % 4
            for h in range(2):
                for j in range(TMA_BN // 8):
                    row, col = 16 * warp + g + 8 * h, 8 * j + 2 * c
                    assert addr[row, col] == -1 and addr[row, col + 1] == -1
                    addr[row, col] = wgrad_staged_byte(warp, lane, h, j)
                    addr[row, col + 1] = addr[row, col] + 2
    return addr


def wgrad_box_reads():
    """(boxes, 64, 64) staging byte that TMA store box b reads as its
    element (row, column): 128-byte swizzled rows, boxes TMA_B_BOX apart
    from a 1024-byte aligned start."""
    b, r, q = np.meshgrid(np.arange(W_OUT_BOXES), np.arange(64), np.arange(64), indexing="ij")
    return tma_box_address(b * TMA_B_BOX, r, 2 * q)


def wgrad_tile_stores(e, k0, n0, k_dim, n_cols, computed=True):
    """The (expert, rows, columns) each warpgroup of a tile writes: with
    rows to walk, its TMA store boxes inside K and N, each clipped at the
    3-D map's edges (rows at the expert's own K, columns at N); for an
    empty expert, its 16-byte zero stores."""
    for wg in range(2):
        r0 = k0 + 64 * wg
        if computed:
            if r0 >= k_dim:
                continue
            for b in range(W_OUT_BOXES):
                c0 = n0 + 64 * b
                if c0 >= n_cols:
                    break
                yield wg, b, e, slice(r0, min(r0 + 64, k_dim)), slice(c0, min(c0 + 64, n_cols))
        else:
            rows, chunks = max(0, min(64, k_dim - r0)), min(TMA_BN, n_cols - n0) // 8
            if rows:
                yield wg, None, e, slice(r0, r0 + rows), slice(n0, n0 + 8 * chunks)


def _stage_and_store(dw, acc, e, k0, n0):
    """A computed tile's epilogue on the CPU: each warpgroup's 64 x 256
    outputs written to its staging as the threads write them, then its
    boxes stored as TMA reads and clips them; every element of dw written
    once."""
    k_dim, n_cols = dw.shape[1:]
    reads = wgrad_box_reads() // 2
    staged = np.full((2, W_OUT_BOXES * TMA_B_BOX // 2), np.nan)
    for wg in range(2):
        staged[wg, wgrad_staging_map() // 2] = acc[64 * wg:64 * wg + 64]
    for wg, b, e, rows, cols in wgrad_tile_stores(e, k0, n0, k_dim, n_cols):
        assert np.all(np.isnan(dw[e, rows, cols]))
        dw[e, rows, cols] = staged[wg, reads[b]][:rows.stop - rows.start, :cols.stop - cols.start]


def _wgrad_tma_product(xs, dy, sizes, zero_rows=True):
    """The TMA wgrad launch on the CPU: each (256-column N tile, 128-row K
    tile, expert) block's steps of TMA_BK rows from its segment's start,
    xs boxes of 64 columns and dy boxes of 64 columns as TMA loads them
    (the next group's rows, zeros past M; a box wholly past K or N not
    loaded: stale), xs rows past the segment zeroed (all kept with
    zero_rows=False); the tile staged and stored by TMA boxes clipped at
    the expert's K and at N (`_stage_and_store`), an empty expert's tiles
    as zeros."""
    m, k_dim = xs.shape
    n_cols = dy.shape[1]
    stale = np.random.default_rng(8).integers(-50, 50, (TMA_BK, 64)).astype(np.float64)
    dw = np.full((len(sizes), k_dim, n_cols), np.nan)
    for e in range(len(sizes)):
        start, end = segment(sizes, m, e)
        for k0 in range(0, k_dim, BM):
            for n0 in range(0, n_cols, TMA_BN):
                if start == end:
                    for _, _, _, rows, cols in wgrad_tile_stores(e, k0, n0, k_dim, n_cols, False):
                        dw[e, rows, cols] = 0
                    continue
                acc = np.zeros((BM, TMA_BN))
                for r0 in range(start, end, TMA_BK):
                    a = np.concatenate([_box(xs, r0, TMA_BK, k0 + 64 * j, 64) if k0 + 64 * j < k_dim
                                        else stale for j in range(BM // 64)], axis=1)
                    b = np.concatenate([_box(dy, r0, TMA_BK, n0 + 64 * j, 64)
                                        if n0 + 64 * j < n_cols else stale
                                        for j in range(TMA_BN // 64)], axis=1)
                    if zero_rows:
                        a[max(end - r0, 0):] = 0
                    acc += a.T @ b
                _stage_and_store(dw, acc, e, k0, n0)
    return dw


@pytest.mark.parametrize("case", ["ragged", "rows_past_the_groups", "over_full", "one_row",
                                  "boundary", "empty_groups_small"])
def test_wgrad_tma_blocks_give_the_per_expert_products(case):
    sizes, m = {"boundary": BOUNDARY,
                "empty_groups_small": ([70, 0, 0, 30, 100, 0], 200)}.get(case) or CASES[case]
    rng = np.random.default_rng(len(sizes) + m + 1)
    k_dim, n_cols = 200, 328  # a K tile with one box past K; an N tile with one box and a part
    xs = rng.integers(-4, 5, (m, k_dim)).astype(np.float64)
    dy = rng.integers(-4, 5, (m, n_cols)).astype(np.float64)
    want = _wgrad_reference(xs, dy, sizes)
    np.testing.assert_array_equal(_wgrad_tma_product(xs, dy, sizes), want)
    if case == "boundary":  # the next group's rows would enter the sum
        assert not np.array_equal(_wgrad_tma_product(xs, dy, sizes, zero_rows=False), want)


def test_wgrad_tma_row_zeroing_covers_exactly_the_row():
    # The consumer zeroes bytes row * 128 .. + 127 of a 128-byte swizzled
    # box; the swizzle keeps every element of a row inside them.
    box = 5 * 1024
    for row in range(TMA_BK):
        addrs = {tma_box_address(box, row, 2 * col) for col in range(64)}
        assert min(addrs) >= box + row * 128 and max(addrs) < box + row * 128 + 128
        assert len(addrs) == 64


@pytest.mark.parametrize("stage", range(TMA_STAGES))
def test_wgrad_tma_a_descriptor_reads_xs_transposed(stage):
    # A = xs^T (64 K columns x k16 rows of the step) for warpgroup wg:
    # its xs box of 64 rows x 64 columns read M-major, as the forward
    # reads B N-major: element (m, k) of A is xs box row 16 kk + k, column m.
    x_s = 3 * 1024 + stage * TMA_STAGE
    k, m = np.meshgrid(np.arange(16), np.arange(64), indexing="ij")
    for wg in range(2):
        for kk in range(TMA_BK // 16):
            desc = sw128_desc(x_s + wg * TMA_B_BOX + 2048 * kk, TMA_B_BOX, 1024)
            got = wgmma_b_address(desc, k, m)
            want = tma_box_address(x_s + wg * TMA_B_BOX, 16 * kk + k, 2 * m)
            np.testing.assert_array_equal(got, want)
    # Two xs boxes and four dy boxes fill the forward's stage.
    assert 2 * TMA_B_BOX == TMA_A_BYTES and TMA_A_BYTES + 4 * TMA_B_BOX == TMA_STAGE


def wgrad_tile(t, k_tiles, n_tiles, tile_n=TMA_BN):
    """The kernel's `wgrad_tile`: (expert, k0, n0) of tile t, N tiles
    fastest, then K tiles, then experts."""
    return t // (k_tiles * n_tiles), (t // n_tiles) % k_tiles * BM, t % n_tiles * tile_n


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("experts,k_dim,n_cols", [(8, 1024, 4096), (8, 4096, 1024), (3, 200, 328)])
def test_wgrad_tma_persistent_walk_takes_every_tile_once(grid, experts, k_dim, n_cols):
    k_tiles, n_tiles = -(-k_dim // BM), -(-n_cols // TMA_BN)
    tiles = experts * k_tiles * n_tiles
    taken = [wgrad_tile(t, k_tiles, n_tiles) for b in range(min(grid, tiles))
             for t in range(b, tiles, grid)]
    assert sorted(taken) == [(e, k0, n0) for e in range(experts) for k0 in range(0, k_dim, BM)
                             for n0 in range(0, n_cols, TMA_BN)]


def test_wgrad_staging_covers_the_tile_once():
    # Each of a warpgroup's 64 x 256 outputs has its own 2 bytes, and the
    # outputs fill the four boxes' 32 KB exactly (`wgrad_staging_map`
    # asserts no output is written twice).
    addr = wgrad_staging_map()
    assert sorted(addr.ravel()) == list(range(0, W_OUT_BOXES * TMA_B_BOX, 2))


@pytest.mark.parametrize("wg", range(2))
def test_wgrad_staging_is_what_the_tma_store_boxes_read(wg):
    # The staging follows the ring (1024-byte aligned, as the swizzle needs),
    # the warpgroup's four boxes after the other's; TMA store box b reads its
    # element (row, column) at the byte where the threads put output (row,
    # 64 b + column).
    base = 3 * 1024 + TMA_STAGES * TMA_STAGE + wg * W_OUT_BOXES * TMA_B_BOX
    assert base % 1024 == 0 and TMA_B_BOX % 1024 == 0
    row, col = np.meshgrid(np.arange(64), np.arange(TMA_BN), indexing="ij")
    got = base + wgrad_staging_map()
    want = tma_box_address(base + (col // 64) * TMA_B_BOX, row, 2 * (col % 64))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(wgrad_box_reads() // 2,
                                  wgrad_staging_map().reshape(64, W_OUT_BOXES, 64)
                                  .transpose(1, 0, 2) // 2)


@pytest.mark.parametrize("warp", range(4))
def test_wgrad_staging_writes_are_free_of_bank_conflicts(warp):
    # One 4-byte store a lane for each (h, j): rows g and g + 8 of the
    # warp's 16 are 128 bytes apart (one bank cycle), so without the
    # swizzle the eight rows would hit four banks; with it, 32 banks once.
    for h in range(2):
        for j in range(TMA_BN // 8):
            words = [wgrad_staged_byte(warp, lane, h, j) // 4 for lane in range(32)]
            assert _phase_banks(words, 1)
    unswizzled = [((lane // 4) * 128 + 4 * (lane % 4)) // 4 for lane in range(32)]
    assert not _phase_banks(unswizzled, 1)


def _store_counts(sizes, k_dim, n_cols, flat=False):
    """How often the launch's stores write each (e, k, n) of dw: every tile
    of the walk, its boxes through the 3-D map (flat=True: a 2-D map over
    E K rows, which clips rows only at E K) or its zero stores."""
    experts = len(sizes)
    k_tiles, n_tiles = -(-k_dim // BM), -(-n_cols // TMA_BN)
    counts = np.zeros((experts * k_dim, n_cols), np.uint8)
    for t in range(experts * k_tiles * n_tiles):
        e, k0, n0 = wgrad_tile(t, k_tiles, n_tiles)
        computed = sizes[e] > 0
        for _, _, _, rows, cols in wgrad_tile_stores(e, k0, n0, k_dim, n_cols, computed):
            stop = e * k_dim + rows.stop
            if flat and computed:
                stop = min(e * k_dim + rows.start + 64, experts * k_dim)
            counts[e * k_dim + rows.start:stop, cols] += 1
    return counts


@pytest.mark.parametrize("sizes,k_dim,n_cols", [([5, 0, 9], 200, 328), ([1, 2, 0, 3], 64, 136),
                                                ([4, 0, 1, 1, 1, 1, 1, 2], 1000, 1000),
                                                ([2] * 8, 1024, 4096)])
def test_wgrad_tma_store_boxes_write_each_element_once(sizes, k_dim, n_cols):
    # Each (e, k, n) of dw exactly once, nothing past K or N: boxes of 64
    # rows and columns through the 3-D map, clipped at the expert's own K.
    assert np.all(_store_counts(sizes, k_dim, n_cols) == 1)
    if k_dim % 64:
        # A 2-D map over E K rows would let a K tile's last box write its
        # rows past K into the next expert's first rows.
        assert np.any(_store_counts(sizes, k_dim, n_cols, flat=True) > 1)


def test_wgrad_staging_and_barriers_fit_the_sm():
    # Ring, then the staging (the forward's staged-output room, which the
    # wgrad kernel's eight boxes fit), then a full and an empty barrier a
    # stage, all inside the launch's TMA_SMEM after the alignment slack.
    staged = TMA_STAGES * TMA_STAGE
    barriers = staged + BM * gm.TMA_OUT_PITCH
    assert staged % 1024 == 0 and barriers % 8 == 0
    assert 2 * W_OUT_BOXES * TMA_B_BOX <= BM * gm.TMA_OUT_PITCH
    assert 1024 + barriers + 2 * TMA_STAGES * 8 == gm.TMA_SMEM <= SMEM_OPT_IN
    assert gm.TMA_SMEM + SMEM_PER_BLOCK_RESERVED <= SMEM_PER_SM


# --- the f32 wgrad TMA kernel (`grouped_wgrad_f32_tma_kernel`) ----------------

WT_BN, WT_BR, WT_STAGES, WT_PROMOTE = gm.WT_BN, gm.WT_BR, gm.WT_STAGES, gm.WT_PROMOTE
WT_BOX = WT_BR * 32 * 4  # 32 rows x 32 f32, 128-byte swizzled rows
WT_STAGE = 8 * WT_BOX  # xs's four boxes, then dy's four
WT_B_TILE = WT_BN * WT_BR * 4  # [128 columns][32 rows] of tf32, K-major
WT_RING = 3 * 1024  # any 1024-byte aligned start of the ring
WT_B_BUFS = WT_RING + WT_STAGES * WT_STAGE  # two buffers of (big, small)


def wt_row_of_position(q):
    """The step's row that k position q of B's rows holds, and that A's k
    index of the same k8 step reads: of k8 step j = q // 8, k c < 4 is row
    8j + 2c and k c + 4 row 8j + 2c + 1."""
    j, k = q // 8, q % 8
    return 8 * j + 2 * (k % 4) + k // 4


def wt_tma_stage(x_tile, d_tile):
    """A stage as TMA writes it (floats by byte offset / 4 from the stage's
    start): x_tile [32 rows, 128 k] and d_tile [32, 128 n] as four 128-byte
    swizzled boxes of 32 columns each."""
    stage = np.full(WT_STAGE // 4, np.nan)
    r, x = np.meshgrid(np.arange(WT_BR), np.arange(32), indexing="ij")
    for b in range(8):
        tile = x_tile if b < 4 else d_tile
        stage[tma_box_address(b * WT_BOX, r, 4 * x) // 4] = tile[r, 32 * (b % 4) + x]
    return stage


def wt_transform_share(cw, lane):
    """The kernel's transform constants of lane `lane` of consumer warp cw
    (chunk cw of every column's row of B): the step's rows it reads
    (t_row0 + 2i), their byte offsets in a dy box (t_read) and its chunk's
    byte offset in B's first 32 columns (t_write)."""
    t_row0 = 8 * (cw // 2) + cw % 2
    rows = [t_row0 + 2 * i for i in range(4)]
    t_read = [r * 128 + 16 * ((lane // 4) ^ (r % 8)) + 4 * (lane % 4) for r in rows]
    t_write = (lane // 8) * 1024 + (lane % 8) * 128 + 16 * (cw ^ (lane % 8))
    return rows, t_read, t_write


def wt_transform_unit(u, lane):
    """Unit u of a step's transform (column box u // 8, chunk u % 8 of B's
    rows; consumer warp u % 8 takes it) for one lane: the rows it reads,
    their byte offsets in dy's boxes, its column n and the byte offset of
    its 16-byte chunk in B's tile."""
    box, ch = u // 8, u % 8
    rows, t_read, t_write = wt_transform_share(ch, lane)
    n = 32 * box + lane
    off = box * 32 * 128 + t_write
    assert off == (n // 8) * 1024 + (n % 8) * 128 + 16 * (ch ^ (n % 8))  # row n, chunk ch
    return rows, [box * WT_BOX + at for at in t_read], n, off


def wt_transform(stage, live):
    """B's tile (floats by byte offset / 4) as the 8 consumer warps write it
    from a stage's dy boxes, rows at or past `live` as zeros; each float
    once."""
    tile = np.full(WT_B_TILE // 4, np.nan)
    for cw in range(8):
        for box in range(4):
            for lane in range(32):
                rows, reads, _, off = wt_transform_unit(8 * box + cw, lane)
                for i, (r, at) in enumerate(zip(rows, reads)):
                    assert np.isnan(tile[off // 4 + i])
                    tile[off // 4 + i] = stage[(4 * WT_BOX + at) // 4] if r < live else 0.0
    return tile


def wt_a_reads(wg, w, lane, j):
    """The byte offsets in xs's boxes of lane (g, c) of warp w of consumer
    warpgroup wg for k8 step j: a float2 at row 8j + 2c (a0, a1) and one at
    row 8j + 2c + 1 (a2, a3), both at the lane's columns 16w + 2g and + 1
    of the warpgroup's 64."""
    g, c = lane // 4, lane % 4
    box, chunk = 2 * wg + w // 2, 4 * (w % 2) + g // 2
    rows = [8 * j + 2 * c + h for h in range(2)]
    return rows, [box * WT_BOX + r * 128 + 16 * (chunk ^ (r % 8)) + 8 * (g % 2) for r in rows]


def wt_output_row(wg, i):
    """The tile's K row of logical accumulator row i of warpgroup wg: row g
    of warp w's 16 is column 2g of its xs reads, row g + 8 column 2g + 1."""
    return 64 * wg + 16 * (i // 16) + 2 * (i % 8) + (i % 16) // 8


def wt_step_product(stage, b_tile, wg, live, zero_a=True):
    """One warpgroup's [64, 128] products of a step: for each k8 step j, A
    (64 x 8) from its four warps' register fragments, B (8 x 128) read by
    the K-major tf32 descriptor 32 bytes further a k8; rows by
    `wt_output_row`."""
    out = np.zeros((64, WT_BN))
    n, k = np.meshgrid(np.arange(WT_BN), np.arange(8), indexing="ij")
    for j in range(WT_BR // 8):
        a = np.full((64, 8), np.nan)
        for w in range(4):
            for lane in range(32):
                g, c = lane // 4, lane % 4
                rows, reads = wt_a_reads(wg, w, lane, j)
                for h, (r, at) in enumerate(zip(rows, reads)):
                    pair = stage[at // 4:at // 4 + 2] * (0 if zero_a and r >= live else 1)
                    a[16 * w + g, c + 4 * h], a[16 * w + g + 8, c + 4 * h] = pair
        desc = sw128_desc(WT_B_BUFS + 32 * j, 16, 1024)
        b = b_tile[(wgmma_a_address(desc, n, k, elem=4) - WT_B_BUFS) // 4].T  # (k, n)
        out += a @ b
    rows = [wt_output_row(wg, i) for i in range(64)]
    assert sorted(rows) == list(range(64 * wg, 64 * wg + 64))
    tile = np.full((BM, WT_BN), np.nan)
    tile[rows] = out
    return tile[64 * wg:64 * wg + 64]


def test_wgrad_f32_tma_kernel_reads_the_boxes_tma_wrote():
    # The transform's and the consumers' addresses name the elements TMA
    # put there (a f32 box's 128-byte rows of 32 values, swizzled).
    rng = np.random.default_rng(16)
    x_tile, d_tile = rng.standard_normal((2, WT_BR, 128))
    stage = wt_tma_stage(x_tile, d_tile)
    assert not np.isnan(stage).any()  # eight boxes fill the stage
    for u in range(32):
        for lane in range(32):
            rows, reads, n, _ = wt_transform_unit(u, lane)
            for r, at in zip(rows, reads):
                assert stage[(4 * WT_BOX + at) // 4] == d_tile[r, n]
    for wg in range(2):
        for w in range(4):
            for lane in range(32):
                g = lane // 4
                for j in range(WT_BR // 8):
                    for r, at in zip(*wt_a_reads(wg, w, lane, j)):
                        col = 64 * wg + 16 * w + 2 * g
                        np.testing.assert_array_equal(stage[at // 4:at // 4 + 2], x_tile[r, col:col + 2])


@pytest.mark.parametrize("live", [WT_BR, 19, 1])
def test_wgrad_f32_tma_b_descriptors_read_the_transposed_rows(live):
    # The transform writes each float of B's tile once; the K-major tf32
    # descriptor of k8 step j reads at (k, column n) the step's row
    # wt_row_of_position(8j + k) of dy's column n, zeros past `live`.
    rng = np.random.default_rng(live)
    d_tile = rng.integers(-50, 50, (WT_BR, 128)).astype(np.float64)
    tile = wt_transform(wt_tma_stage(np.zeros((WT_BR, 128)), d_tile), live)
    assert not np.isnan(tile).any()
    n, k = np.meshgrid(np.arange(WT_BN), np.arange(8), indexing="ij")
    for j in range(WT_BR // 8):
        desc = sw128_desc(WT_B_BUFS + 32 * j, 16, 1024)
        got = tile[(wgmma_a_address(desc, n, k, elem=4) - WT_B_BUFS) // 4]
        rows = np.vectorize(wt_row_of_position)(8 * j + k)
        np.testing.assert_array_equal(got, np.where(rows < live, d_tile[rows, n], 0))
    # A 128-byte row of B is one column's 32 rows: one step.
    assert WT_BR * 4 == 128 and WT_B_TILE == WT_BN * 128


@pytest.mark.parametrize("live", [WT_BR, 21])
def test_wgrad_f32_tma_register_a_gives_the_tile_product(live):
    # A = xs^T from registers and B from the transform's tile give each
    # warpgroup's 64 K rows of xs[:live]^T dy[:live], exactly on integers;
    # rows past `live` are zeroed in A and B alike.
    rng = np.random.default_rng(live + 1)
    x_tile = rng.integers(-5, 6, (WT_BR, 128)).astype(np.float64)
    d_tile = rng.integers(-5, 6, (WT_BR, 128)).astype(np.float64)
    stage = wt_tma_stage(x_tile, d_tile)
    b_tile = wt_transform(stage, live)
    want = x_tile[:live].T @ d_tile[:live]
    got = np.concatenate([wt_step_product(stage, b_tile, wg, live) for wg in range(2)])
    np.testing.assert_array_equal(got, want)
    if live < WT_BR:  # B's zeros alone already drop the rows' products
        got = np.concatenate([wt_step_product(stage, b_tile, wg, live, zero_a=False)
                              for wg in range(2)])
        np.testing.assert_array_equal(got, want)


def test_wgrad_f32_tma_reads_and_writes_are_free_of_bank_conflicts():
    # The consumers' float2 A reads (16 lanes a phase), the transform's
    # 4-byte reads (whole 128-byte rows) and 16-byte writes (8 lanes a
    # phase) of every step, by each consumer warp and box.
    for wg in range(2):
        for w in range(4):
            for j in range(WT_BR // 8):
                for h in range(2):
                    words = [wt_a_reads(wg, w, lane, j)[1][h] // 4 for lane in range(32)]
                    assert _phase_banks(words, 2)
    for u in range(32):
        units = [wt_transform_unit(u, lane) for lane in range(32)]
        for i in range(4):
            assert _phase_banks([unit[1][i] // 4 for unit in units], 1)
        assert _phase_banks([unit[3] // 4 for unit in units], 4)
    # Rows 8j + c and 8j + c + 4 for k c and c + 4 (the fragment's own
    # order) would put each half-warp's A reads on 4 chunks twice over.
    same_order = [(r * 128 + 16 * ((lane // 8) ^ (r % 8)) + 8 * ((lane // 4) % 2)) // 4
                  for lane in range(32) for r in [lane % 4]]
    assert not _phase_banks(same_order, 2)


def _wgrad_f32_tma_product(xs, dy, sizes, zero_rows=True):
    """The f32 TMA wgrad launch on the CPU: each (expert, 128-row K tile,
    128-column N tile) tile's steps of WT_BR rows from its segment's start,
    boxes of 32 columns as TMA loads them (the next group's rows, zeros
    past M; a box wholly past K or N not loaded: stale), rows past the
    segment zeroed in A and in B's tile (neither with zero_rows=False), the
    sums of each WT_PROMOTE rows added to the totals, the totals stored
    inside K and N; an empty expert's tiles as zeros."""
    m, k_dim = xs.shape
    n_cols = dy.shape[1]
    stale = np.random.default_rng(9).integers(-50, 50, (WT_BR, 32)).astype(np.float64)
    dw = np.full((len(sizes), k_dim, n_cols), np.nan)
    k_tiles, n_tiles = -(-k_dim // BM), -(-n_cols // WT_BN)
    for t in range(len(sizes) * k_tiles * n_tiles):
        e, k0, n0 = wgrad_tile(t, k_tiles, n_tiles, WT_BN)
        start, end = segment(sizes, m, e)
        ks, ns = slice(k0, min(k0 + BM, k_dim)), slice(n0, min(n0 + WT_BN, n_cols))
        assert np.all(np.isnan(dw[e, ks, ns]))
        if start == end:
            dw[e, ks, ns] = 0
            continue
        total = np.zeros((BM, WT_BN))
        part = None
        for s, r0 in enumerate(range(start, end, WT_BR)):
            a = np.concatenate([_box(xs, r0, WT_BR, k0 + 32 * j, 32) if k0 + 32 * j < k_dim
                                else stale for j in range(BM // 32)], axis=1)
            b = np.concatenate([_box(dy, r0, WT_BR, n0 + 32 * j, 32) if n0 + 32 * j < n_cols
                                else stale for j in range(WT_BN // 32)], axis=1)
            if zero_rows:
                a[max(end - r0, 0):] = 0
                b[max(end - r0, 0):] = 0
            with np.errstate(invalid="ignore"):
                step = a.T @ b
            part = step if s % (WT_PROMOTE // WT_BR) == 0 else part + step
            if s % (WT_PROMOTE // WT_BR) == WT_PROMOTE // WT_BR - 1 or r0 + WT_BR >= end:
                total += part
        dw[e, ks, ns] = total[:ks.stop - k0, :ns.stop - n0]
    return dw


@pytest.mark.parametrize("case", ["ragged", "rows_past_the_groups", "over_full", "one_row",
                                  "boundary", "empty_groups_small"])
def test_wgrad_f32_tma_blocks_give_the_per_expert_products(case):
    sizes, m = {"boundary": BOUNDARY,
                "empty_groups_small": ([70, 0, 0, 30, 100, 0], 200)}.get(case) or CASES[case]
    rng = np.random.default_rng(len(sizes) + m + 2)
    k_dim, n_cols = 196, 300  # a K tile with a box past K, an N tile with a part box
    xs = rng.integers(-4, 5, (m, k_dim)).astype(np.float64)
    dy = rng.integers(-4, 5, (m, n_cols)).astype(np.float64)
    want = _wgrad_reference(xs, dy, sizes)
    np.testing.assert_array_equal(_wgrad_f32_tma_product(xs, dy, sizes), want)
    if case == "boundary":  # the next group's rows would enter the sum
        assert not np.array_equal(_wgrad_f32_tma_product(xs, dy, sizes, zero_rows=False), want)
        # A neighbour's non-finite row meets only zeros: A's and B's both.
        xs[BOUNDARY[0][0] + 1, 3] = np.inf
        dy[BOUNDARY[0][0] + 1, 5] = np.inf
        with np.errstate(invalid="ignore"):  # the neighbour's own sums
            want = _wgrad_reference(xs, dy, sizes)
        got = _wgrad_f32_tma_product(xs, dy, sizes)
        assert np.isfinite(got[0]).all()
        np.testing.assert_array_equal(got[0], want[0])


@pytest.mark.parametrize("grid", [1, 7, 132])
@pytest.mark.parametrize("experts,k_dim,n_cols", [(8, 1024, 4096), (8, 4096, 1024), (3, 196, 300)])
def test_wgrad_f32_tma_persistent_walk_takes_every_tile_once(grid, experts, k_dim, n_cols):
    k_tiles, n_tiles = -(-k_dim // BM), -(-n_cols // WT_BN)
    tiles = experts * k_tiles * n_tiles
    taken = [wgrad_tile(t, k_tiles, n_tiles, WT_BN) for b in range(min(grid, tiles))
             for t in range(b, tiles, grid)]
    assert sorted(taken) == [(e, k0, n0) for e in range(experts) for k0 in range(0, k_dim, BM)
                             for n0 in range(0, n_cols, WT_BN)]


@pytest.mark.parametrize("case", list(CASES))
def test_wgrad_f32_tma_walk_takes_each_segment_row_once_in_order(case):
    sizes, m = CASES[case]
    for e, steps in enumerate(wgrad_walk(sizes, m, WT_BR)):
        start, end = segment(sizes, m, e)
        live = np.concatenate([rows[ok] for rows, ok in steps]) if steps else np.zeros(0, int)
        np.testing.assert_array_equal(live, np.arange(start, end))
        # Promotion intervals: whole steps, the last one possibly short.
        assert len(steps) == -(-(end - start) // WT_BR)


def test_wgrad_f32_tma_ring_buffers_and_registers_fit_the_sm():
    assert gm.WT_SMEM == (1024 + WT_STAGES * WT_STAGE + 2 * 2 * WT_B_TILE
                          + 2 * (WT_STAGES + 2) * 8) <= SMEM_OPT_IN
    assert gm.WT_SMEM + SMEM_PER_BLOCK_RESERVED <= SMEM_PER_SM
    # Every box and tile starts 1024-byte aligned (the 128-byte swizzle's
    # period), and a box's rows are the swizzle's 128 bytes.
    assert WT_BOX % 1024 == 0 and WT_STAGE % 1024 == 0 and WT_B_TILE % 1024 == 0
    assert WT_B_BUFS % 1024 == 0 and 32 * 4 == 128
    # The setmaxnreg split of the bf16 TMA kernels; a consumer thread holds
    # the interval's m64n128 sums (64 f32), the totals (64) and two steps'
    # A big and small parts (this step's and the next: 4 k8 steps x 4 x 2
    # each).
    assert gm.TMA_THREADS == 3 * 128
    assert 64 * WT_BN // 128 * 2 + 2 * 4 * 4 * 2 < gm.CONSUMER_REGS
    assert WT_PROMOTE % WT_BR == 0 and WT_BN == BM
