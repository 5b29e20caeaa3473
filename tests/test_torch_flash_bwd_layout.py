"""Models, on the CPU, of what the bf16 flash block backward kernels
(`flash_bwd_dkdv_tc_kernel`, `flash_bwd_dq_tc_kernel` in
`jobset_tpu_torch/ops/csrc/flash_block_bwd.cu`) rely on, built from the
constants `ops/flash_block.py` exposes (the card checks the built kernels):

- The tiles TMA writes (boxes of 64 rows x 64 bf16 columns, 128-byte
  swizzled, a [64, D] tile as D / 64 such boxes) and the `wgmma`
  descriptors that read them name the same element: the shared-memory
  operands of S^T = K.Q^T, dP^T = V.dW^T, S = Q.K^T and dP = dW.V^T
  K-major, one k16 step 32 bytes into the rows of its box; and the B of
  dV += P^T.dW, dK += dS^T.Q and dQ += dS.K MN-major through the
  transpose bit, a k16 step two 8-row groups (2048 bytes) on, the 64-column
  boxes one box apart.
- The accumulators of a 64-row `wgmma` product, relabelled as the kernel
  does (the C fragments of n8 tiles 2j and 2j + 1 are the A fragment of k16
  step j), are the A operand of the next product: the register fragments
  hold exactly its k16 slices, and the product through them is the tile
  product on integer inputs.
- Each pass's walk: the dK/dV pass's blocks (one a kv tile) and the dQ
  pass's (one a q tile, the longest first) each take every live (q tile, kv
  tile) pair of the bias's tile classes exactly once and no MASKED one,
  for the triangle, band, reverse triangle, all-masked, zero and alibi
  biases, ragged shapes included; every entry above NEG_INF/2 lies in a
  live tile. The grouped dispatch order takes every (b*h, tile) block once,
  with its group of heads, after the group's longer tiles.
- The ring: in the loop's order of loads, waits, reads and retirements,
  whenever the copies land, the warpgroup waits on each walked tile's own
  barrier phase, reads the tile that was loaded for it, and no stage is
  loaded again while a product may still read it.
- Shared memory, barriers and accumulators fit an SM at the blocks an SM
  each pass is sized for, and the source's launch constants are the
  module's.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jobset_tpu_torch.ops import flash_block as fb

TILE = fb.TILE
SUB = TILE * 64 * 2  # one 64 x 64 bf16 box
SMEM_OPT_IN = 232_448  # the most dynamic shared memory a block may ask for
SMEM_PER_SM = 233_472  # 228 KB an SM
SMEM_RESERVED = 1_024  # the system's share a block
REGISTERS_PER_SM = 65_536
SOURCE = Path(fb.__file__).parent / "csrc" / "flash_block_bwd.cu"


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def swizzle128(addr):
    """CU_TENSOR_MAP_SWIZZLE_128B / the wgmma 128B layout on a shared
    address: the 16-byte chunk bits (4-6) xor the 128-byte row bits (7-9)."""
    return addr ^ (((addr >> 7) & 7) << 4)


def tma_tile_address(base, row, col):
    """Where TMA puts bf16 element (row, col) of a [64, D] tile loaded as
    D / 64 boxes of 64 columns, SUB bytes apart, at a 1024-byte aligned base."""
    return swizzle128(base + (col // 64) * SUB + row * 128 + 2 * (col % 64))


def sw128_desc(start, lbo, sbo):
    """The kernel's `sw128_desc` bits."""
    return (start & 0x3FFFF) >> 4 | (lbo >> 4) << 16 | (sbo >> 4) << 32 | 1 << 62


def desc_fields(desc):
    return ((desc & 0x3FFF) << 4, (desc >> 16 & 0x3FFF) << 4, (desc >> 32 & 0x3FFF) << 4,
            desc >> 62)


def k_major_address(desc, m, k):
    """Element (m, k) of a K-major 64 x 16 bf16 operand in the 128B layout:
    8-row groups SBO apart, 128-byte rows, then the swizzle."""
    start, _, sbo, kind = desc_fields(desc)
    assert kind == 1
    return swizzle128(start + (m // 8) * sbo + (m % 8) * 128 + 2 * k)


def mn_major_address(desc, k, n):
    """Element (k, n) of an MN-major 16 x N bf16 B (the transpose bit) in
    the 128B layout: blocks of 64 columns LBO apart, 8-row k groups SBO
    apart, 128-byte rows, then the swizzle."""
    start, lbo, sbo, kind = desc_fields(desc)
    assert kind == 1
    return swizzle128(start + (n // 64) * lbo + (k // 8) * sbo + (k % 8) * 128 + 2 * (n % 64))


@pytest.mark.parametrize("dp", [64, 128])
def test_k_major_descriptors_name_the_elements_tma_wrote(dp):
    # S^T = K.Q^T (and the other three shared-memory products): both
    # operands [64 rows, dp] tiles, k16 step kk at (kk // 4) boxes and
    # (kk % 4) * 32 bytes on.
    base = 5 * 1024
    m, k = np.meshgrid(np.arange(64), np.arange(16), indexing="ij")
    for kk in range(dp // 16):
        desc = sw128_desc(base + (kk // 4) * SUB + (kk % 4) * 32, 16, 1024)
        np.testing.assert_array_equal(k_major_address(desc, m, k),
                                      tma_tile_address(base, m, 16 * kk + k))
    # A tile's boxes are a permutation of its bytes' 16-byte chunks.
    chunks = sorted(tma_tile_address(base, r, 8 * c) for r in range(64) for c in range(dp // 8))
    assert chunks == list(range(base, base + dp // 64 * SUB, 16))


@pytest.mark.parametrize("dp", [64, 128])
def test_transposed_b_descriptors_name_the_elements_tma_wrote(dp):
    # dV += P^T.dW: B[q][d] = dW's tile as TMA wrote it, k16 step j = q rows
    # 16j .. 16j + 15; likewise Q for dK and K for dQ.
    base = 3 * 1024
    k, n = np.meshgrid(np.arange(16), np.arange(dp), indexing="ij")
    for j in range(TILE // 16):
        desc = sw128_desc(base + j * 2048, SUB, 1024)
        np.testing.assert_array_equal(mn_major_address(desc, k, n),
                                      tma_tile_address(base, 16 * j + k, n))


def accumulator_owner(rows, cols):
    """wgmma m64nN's accumulators: (thread, n8 tile j, entry e) holding
    (row, col). Thread 32w + 4g + t holds rows 16w + g and + 8 (e >> 1),
    columns 8j + 2t + (e & 1)."""
    w, g = rows // 16, rows % 16 % 8
    t = cols % 8 // 2
    return 32 * w + 4 * g + t, cols // 8, 2 * (rows % 16 // 8) + cols % 2


def frag_c(c, j):
    """The kernel's relabelling: (register, half) -> accumulator (n8 tile,
    entry) for k16 step j. Register i packs two bf16, the low half first."""
    return [((2 * j, 0), (2 * j, 1)), ((2 * j, 2), (2 * j, 3)),
            ((2 * j + 1, 0), (2 * j + 1, 1)), ((2 * j + 1, 2), (2 * j + 1, 3))]


def a_fragment_position(thread, reg, half):
    """(row, k) of a warpgroup's register A operand (m64k16, each warp the
    A fragment of mma.m16n8k16 for its 16 rows): register 0 (row g, k 2t
    and 2t + 1), 1 (g + 8, ...), 2 (g, 2t + 8 ...), 3 (g + 8, 2t + 8 ...)."""
    w, lane = thread // 32, thread % 32
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (reg % 2), 2 * t + 8 * (reg // 2) + half


@pytest.mark.parametrize("dp", [64, 128])
def test_accumulators_relabelled_are_the_next_products_a_operand(dp):
    rng = np.random.default_rng(dp)
    acc = rng.integers(-8, 9, (64, 64)).astype(np.float64)  # P^T (or dS^T, dS) [64 rows, 64]
    b = rng.integers(-8, 9, (64, dp)).astype(np.float64)  # dW (or Q, K) [64, dp]
    regs = np.zeros((128, 8, 4))  # each thread's accumulators, as wgmma leaves them
    rows, cols = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    thread, j, e = accumulator_owner(rows, cols)
    regs[thread, j, e] = acc
    assert len(set(zip(thread.ravel(), j.ravel(), e.ravel()))) == 64 * 64  # each held once
    out = np.zeros((64, dp))
    for step in range(TILE // 16):
        a = np.full((64, 16), np.nan)
        for th in range(128):
            for reg, pair in enumerate(frag_c(regs[th], step)):
                for half, (n8, entry) in enumerate(pair):
                    r, k = a_fragment_position(th, reg, half)
                    assert np.isnan(a[r, k])
                    a[r, k] = regs[th, n8, entry]
        np.testing.assert_array_equal(a, acc[:, 16 * step:16 * step + 16])
        out += a @ b[16 * step:16 * step + 16]
    np.testing.assert_array_equal(out, acc @ b)


def bias_of(kind, tq, tk):
    rel = np.arange(tq)[:, None] - np.arange(tk)[None]
    neg = np.float32(fb.NEG_INF)
    if kind == "triangle":
        return np.where(rel >= 0, 0.0, neg).astype(np.float32)
    if kind == "reverse_triangle":
        return np.where(rel <= 0, 0.0, neg).astype(np.float32)
    if kind == "band":
        return np.where((rel >= 0) & (rel < 100), 0.0, neg).astype(np.float32)
    if kind == "band_row":
        bias = np.where((rel >= 0) & (rel < 100), 0.0, neg).astype(np.float32)
        bias[3] = neg
        return bias
    if kind == "all_masked":
        return np.full((tq, tk), neg, np.float32)
    if kind == "zero":
        return np.zeros((tq, tk), np.float32)
    if kind == "alibi":
        return (-0.1 * np.abs(rel)).astype(np.float32)
    if kind == "half_masked":  # kv tiles past the second masked in every q tile
        bias = np.zeros((tq, tk), np.float32)
        bias[:, 128:] = neg
        return bias
    raise ValueError(kind)


def classes_of(bias):
    """The tile classes, as `tile_classes_reference` defines them, in numpy."""
    tq, tk = bias.shape
    nq, nk = -(-tq // TILE), -(-tk // TILE)
    cls = np.empty((nq, nk), np.uint8)
    for i in range(nq):
        for j in range(nk):
            tile = bias[i * TILE:(i + 1) * TILE, j * TILE:(j + 1) * TILE]
            cls[i, j] = (fb.MASKED if np.all(tile <= fb.NEG_INF / 2)
                         else fb.ZERO_BIAS if np.all(tile == 0) else fb.BIAS)
    return cls


def live_walk(cls_line):
    """next_live_tile's walk over one line of classes."""
    out, i = [], 0
    while True:
        while i < len(cls_line) and cls_line[i] == fb.MASKED:
            i += 1
        if i >= len(cls_line):
            return out
        out.append(i)
        i += 1


WALK_CASES = {
    "triangle T1024": ("triangle", 1024, 1024),
    "triangle ragged Tq130 Tk200": ("triangle", 130, 200),
    "reverse triangle Tq130 Tk200": ("reverse_triangle", 130, 200),
    "band with a masked row Tq100 Tk77": ("band_row", 100, 77),
    "band T1024": ("band", 1024, 1024),
    "all masked T200": ("all_masked", 200, 200),
    "zero T256": ("zero", 256, 256),
    "alibi Tq100 Tk77": ("alibi", 100, 77),
    "kv tiles 2 and 3 masked T200": ("half_masked", 200, 200),
}


@pytest.mark.parametrize("case", list(WALK_CASES))
def test_each_pass_walks_every_live_tile_once(case):
    kind, tq, tk = WALK_CASES[case]
    bias = bias_of(kind, tq, tk)
    cls = classes_of(bias)
    np.testing.assert_array_equal(cls, fb.tile_classes_reference(torch.from_numpy(bias)).numpy())
    nq, nk = cls.shape
    live = {(i, j) for i in range(nq) for j in range(nk) if cls[i, j] != fb.MASKED}
    # The dK/dV pass: block (b*h, kv tile kt) walks its column of classes.
    dkdv = [(qt, kt) for kt in range(nk) for qt in live_walk(cls[:, kt])]
    # The dQ pass: block y takes q tile nq - 1 - y and walks its row.
    order = [nq - 1 - y for y in range(nq)]
    dq = [(qt, kt) for qt in order for kt in live_walk(cls[qt])]
    for walk in (dkdv, dq):
        assert len(walk) == len(set(walk)) and set(walk) == live
    # Every entry that adds a non-zero P lies in a live tile.
    rows, cols = np.nonzero(bias > fb.NEG_INF / 2)
    assert all((r // TILE, c // TILE) in live for r, c in zip(rows, cols))
    if kind == "triangle" and tq == tk:
        # The longest q tiles are launched first.
        counts = [len(live_walk(cls[qt])) for qt in order]
        assert counts == sorted(counts, reverse=True)


HEAD_GROUP = int(re.search(r"constexpr int HEAD_GROUP = (\d+);", SOURCE.read_text()).group(1))


def grouped_order(heads, tiles):
    """The kernels' grouped_order for every block of a (heads, tiles) grid,
    in dispatch order (blockIdx.x fastest): (b*h, k), k-th longest tile."""
    out = []
    for y in range(tiles):
        for x in range(heads):
            lin = y * heads + x
            group = lin // (HEAD_GROUP * tiles)
            size = min(HEAD_GROUP, heads - group * HEAD_GROUP)
            rem = lin - group * HEAD_GROUP * tiles
            out.append((group * HEAD_GROUP + rem % size, rem // size))
    return out


@pytest.mark.parametrize("heads,tiles", [(128, 16), (8, 3), (40, 5), (1, 1), (17, 2), (3, 16)])
def test_grouped_order_takes_every_block_once_longest_first_in_each_group(heads, tiles):
    order = grouped_order(heads, tiles)
    assert sorted(order) == [(bh, k) for bh in range(heads) for k in range(tiles)]
    for i, (bh, k) in enumerate(order):
        group = bh // HEAD_GROUP
        # Dispatched with its group, and after every block of its group with
        # a longer tile (a smaller k).
        first = group * HEAD_GROUP * tiles
        size = min(HEAD_GROUP, heads - group * HEAD_GROUP)
        assert first <= i < first + size * tiles
        assert all(k2 <= k for bh2, k2 in order[first:i] if bh2 // HEAD_GROUP == group)


def ring_program(tiles, stages):
    """A pass's loop in program order (the block's four warps move together:
    every product is a warpgroup instruction, and a stage is refilled after
    a __syncthreads): ("load", tile, stage) where warp 0 starts a walked
    tile's copies, ("wait", tile, stage, parity) where the warpgroup waits
    for them, ("read", tile, stage) while its products read the stage, and
    ("retire", tile) once they have all retired."""
    ops = [("load", j, j % stages) for j in range(min(stages, tiles))]
    ahead = min(stages, tiles)
    if tiles:
        ops.append(("wait", 0, 0, 0))
    for i in range(tiles):
        if i > 0:
            ops.append(("retire", i - 1))  # wgmma_wait<1> at the loop's top
            if ahead < tiles:
                ops.append(("load", ahead, (i - 1) % stages))
                ahead += 1
        ops.append(("read", i, i % stages))
        if i + 1 < tiles:
            ops.append(("wait", i + 1, (i + 1) % stages, ((i + 1) // stages) & 1))
            ops.append(("read", i + 1, (i + 1) % stages))  # its S and dP, issued
    if tiles:
        ops.append(("retire", tiles - 1))
    return ops


@pytest.mark.parametrize("stages", sorted(set(fb.BWD_STAGES.values())))
@pytest.mark.parametrize("tiles", [1, 2, 3, 7, 16])
def test_ring_hands_each_tile_over_once_whenever_the_copies_land(stages, tiles):
    # An mbarrier completes one phase a load (TMA's bytes and, in the dK/dV
    # pass, the statistics' cp.async arrivals); try_wait.parity p passes
    # once the count of completed phases has the other parity. Copies land
    # in any order and at any time after they start.
    ops = ring_program(tiles, stages)
    assert [op[1] for op in ops if op[0] == "load"] == list(range(tiles))
    for seed in range(30):
        rng = np.random.default_rng(seed)
        completed = [0] * stages  # phases of each stage's barrier
        held = [None] * stages  # the tile whose bytes a stage holds
        in_flight = []  # started loads: (tile, stage)
        reading = {}  # stage -> tile its products may still read
        for op in ops:
            if in_flight and rng.random() < 0.5:  # some copies land now
                tile, stage = in_flight.pop(rng.integers(len(in_flight)))
                held[stage], completed[stage] = tile, completed[stage] + 1
            if op[0] == "load":
                _, tile, stage = op
                assert stage not in reading, f"stage {stage} refilled while tile {reading[stage]} reads it"
                in_flight.append((tile, stage))
            elif op[0] == "wait":
                _, tile, stage, parity = op
                # The phase waited for is the tile's own: never one ahead.
                assert completed[stage] in (tile // stages, tile // stages + 1)
                while completed[stage] % 2 == parity:  # not yet: wait for the copies
                    k = next(k for k, (t, st) in enumerate(in_flight) if st == stage)
                    t, _ = in_flight.pop(k)
                    held[stage], completed[stage] = t, completed[stage] + 1
                assert held[stage] == tile
            elif op[0] == "read":
                _, tile, stage = op
                assert held[stage] == tile
                reading[stage] = tile
            else:
                stage = next(st for st, t in reading.items() if t == op[1])
                del reading[stage]
        assert not in_flight and not reading


def smem_bytes(dp, dkdv, n_classes):
    """The kernels' tc_smem_bytes: 1024 bytes of alignment slack, the two
    resident [64, dp] bf16 tiles, the ring (two walked tiles a stage, and in
    the dK/dV pass the q rows' maxes and dsums beside each), the barriers
    (the resident tiles' and each stage's), the block's tile classes."""
    tile, stages = TILE * dp * 2, fb.BWD_STAGES[dp]
    return (1024 + 2 * tile + stages * (2 * tile + (2 * TILE * 4 if dkdv else 0))
            + 8 * (1 + stages) + n_classes)


@pytest.mark.parametrize("dp", [64, 128])
def test_shared_memory_and_registers_fit_the_sm(dp):
    kv_blocks, q_blocks = fb.BWD_BLOCKS[dp]
    for dkdv, blocks in ((True, kv_blocks), (False, q_blocks)):
        smem = smem_bytes(dp, dkdv, 1024 // TILE)
        tile = TILE * dp * 2
        assert smem >= 1024 + (2 + 2 * fb.BWD_STAGES[dp]) * tile
        assert smem <= SMEM_OPT_IN and blocks * (smem + SMEM_RESERVED) <= SMEM_PER_SM
        # Registers a thread at the blocks an SM, rounded down to 8.
        cap = min(255, REGISTERS_PER_SM // (blocks * fb.BWD_THREADS) // 8 * 8)
        on = dp // 8 * 4  # a thread's floats of one [64, dp] accumulator
        # dK/dV: dK, dV, S^T, dP^T and P^T's fragments; dQ: dQ, S, dP, dS's.
        live = (2 * on + 2 * 32 + 16) if dkdv else (on + 2 * 32 + 16)
        assert live < cap
    assert fb.BWD_THREADS == 128


def test_the_sources_launch_constants_are_the_modules():
    src = SOURCE.read_text()
    assert re.search(r"return 1024 \+ 2 \* TB \+ S \* \(2 \* TB \+ \(dkdv \? 2 \* TILE \* 4 : 0\)\) "
                     r"\+ 8 \* \(1 \+ S\) \+ n_classes;", src)
    assert re.search(rf"constexpr int TC_THREADS = {fb.BWD_THREADS};", src)
    for dp in (64, 128):
        m = re.search(rf"struct TcConfig<{dp}> {{\s*static constexpr int STAGES = (\d+), "
                      rf"DKDV_BLOCKS = (\d+), DQ_BLOCKS = (\d+);", src)
        assert m, dp
        assert (int(m.group(1)), (int(m.group(2)), int(m.group(3)))) == (
            fb.BWD_STAGES[dp], fb.BWD_BLOCKS[dp])
