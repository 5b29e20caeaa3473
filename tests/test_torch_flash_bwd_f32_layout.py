"""Models, on the CPU, of what the f32 flash block backward kernels on tf32
`wgmma` fed by TMA (`flash_bwd_dkdv_tf32_kernel`, `flash_bwd_dq_tf32_kernel`
in `jobset_tpu_torch/ops/csrc/flash_block_bwd.cu`) rely on, built from the
constants `ops/flash_block.py` exposes and the source's own (the card checks
the built kernels):

- The tiles TMA writes (boxes of 64 rows x 32 f32 columns, one 128-byte
  swizzled row each, a [64, D] tile as D / 32 such boxes) and the `wgmma`
  descriptors that read them name the same element: both operands of S^T =
  K.Q^T, dP^T = V.dW^T, S = Q.K^T and dP = dW.V^T K-major, a k8 step 32
  bytes into the rows of its box, B a warpgroup's 32 rows of the walked
  tile; their small parts, written at the same offsets, likewise.
- The transposed copies (`transpose_step`, each of the block's two
  warpgroups writing the half of the walked rows it contracts over) that
  make the walked tile the K-major B of dV += P^T.dW, dK += dS^T.Q and
  dQ += dS.K hold each element's
  big and small TF32 parts once, where the B descriptors of the k8 steps
  read them, in the order the accumulator relabelling (`frag_split`) puts
  the rows' columns in A: on integer inputs the product through the
  register fragments and the copies is the tile product exactly. The same
  steps read every element of the raw tile once and write its small part
  at its own offset (V's, which has no copy, by `small_step`); their reads
  and writes are free of bank conflicts.
- The arithmetic: 3xTF32 as the kernels do it (resident operands split to
  nearest, walked raw tiles read truncated to their top 19 bits with the
  truncation's remainder as the small part, the small parts read truncated
  in turn, the tensor core's sums truncated a k8 instruction in the
  kernels' chain order: S^T, dP^T, S and dP take small.big and big.big
  over every k8 step, then big.small; each warpgroup's part of dK, dV and
  dQ over its 32 walked rows added to its totals in f32, the two
  warpgroups' totals added at the end) holds the card's f32 tolerances against float64 at
  the flagship block (Tq = Tk = 1024) and the sequence-parallel ring's
  block (Tq = Tk = 4096).
- The ring: in the loop's order of loads, waits, reads and retirements,
  whenever the copies land, each walked tile's stage is waited on at its own
  barrier phase, read for the tile loaded for it, and not loaded again while
  it may still be read.
- Shared memory and registers fit one block an SM at D <= 64, and D = 128
  would not (so the wrapper sends it to the mma.sync kernels); the source's
  launch constants are the module's; the wrapper sends a call to these
  kernels exactly where TMA takes its views.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jobset_tpu_torch.ops import flash_block as fb

TILE = fb.TILE
SUB = TILE * 128  # one 64-row x 32-column f32 box
SMEM_OPT_IN = 232_448  # the most dynamic shared memory a block may ask for
SMEM_PER_SM = 233_472  # 228 KB an SM
SMEM_RESERVED = 1_024  # the system's share a block
REGISTERS_PER_SM = 65_536
SOURCE = Path(fb.__file__).parent / "csrc" / "flash_block_bwd.cu"
PADDED = (32, 64)  # the kernels' instantiations (launch_tf32<DP>)
# The card's f32 backward tolerances (chip_smoke.py): max|d| <= 1e-4 max|want|
# + 1e-5 per output, and at the flagship block a relative norm of 1e-4.
RTOL, ATOL, REL = 1e-4, 1e-5, 1e-4


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


def tma_address(base, row, col):
    """Where TMA puts f32 element (row, col) of a [64, D] tile loaded as D / 32
    boxes of 32 columns, SUB bytes apart, at a 1024-byte aligned base."""
    return swizzle128(base + (col // 32) * SUB + row * 128 + 4 * (col % 32))


def sw128_desc(start, lbo, sbo):
    """The kernel's `sw128_desc` bits."""
    return (start & 0x3FFFF) >> 4 | (lbo >> 4) << 16 | (sbo >> 4) << 32 | 1 << 62


def k_major_address(desc, m, k):
    """Element (m, k) of a K-major operand of one tf32 k8 step in the 128B
    layout: 8-row groups SBO apart, 128-byte rows, 4 bytes an element, then
    the swizzle."""
    start = (desc & 0x3FFF) << 4
    sbo = (desc >> 32 & 0x3FFF) << 4
    assert desc >> 62 == 1
    return swizzle128(start + (m // 8) * sbo + (m % 8) * 128 + 4 * k)


@pytest.mark.parametrize("dp", PADDED)
def test_k_major_descriptors_name_the_elements_tma_wrote(dp):
    # S^T = K.Q^T (and the other three shared-memory products): both
    # operands [64 rows, dp] tiles, k8 step kk at (kk // 4) boxes and
    # (kk % 4) * 32 bytes on (issue_ss3); the small parts at the same
    # offsets of their own tile.
    base = 7 * 1024
    m, k = np.meshgrid(np.arange(64), np.arange(8), indexing="ij")
    for kk in range(dp // 8):
        desc = sw128_desc(base + (kk // 4) * SUB + (kk % 4) * 32, 16, 1024)
        np.testing.assert_array_equal(k_major_address(desc, m, k),
                                      tma_address(base, m, 8 * kk + k))
        # B of warpgroup wg: its 32 rows, HALF * 128 bytes into each box.
        for wg in range(2):
            desc = sw128_desc(base + wg * 32 * 128 + (kk // 4) * SUB + (kk % 4) * 32, 16, 1024)
            np.testing.assert_array_equal(k_major_address(desc, m[:32], k[:32]),
                                          tma_address(base, 32 * wg + m[:32], 8 * kk + k[:32]))
    # A tile's boxes are a permutation of its bytes' 16-byte chunks.
    chunks = sorted(tma_address(base, r, 4 * c) for r in range(64) for c in range(dp // 4))
    assert chunks == list(range(base, base + dp // 32 * SUB, 16))


def k_order(p):
    """The raw row (within a k8 step) that logical k p of the step holds."""
    return 2 * p if p < 4 else 2 * (p - 4) + 1


WG = fb.BWD_F32_WARPGROUP


def transpose_writes(dp):
    """`transpose_step`'s work: for each (step, thread of the block), the
    raw tile's (row, column) of its four reads, their byte offsets in the
    raw tile (where it also writes their small parts), and the byte offset
    of the 16-byte chunk it writes (big; small TB on), as the kernel
    computes them: warpgroup wg the rows 32 wg .. 32 wg + 31."""
    out = []
    for it in range(dp // 16):
        for th in range(fb.BWD_F32_THREADS):
            wg, idx = th // WG, it * WG + th % WG
            d, jl, h = idx % dp, idx // dp // 2, idx // dp % 2
            j = 4 * wg + jl
            rows = [8 * j + 2 * i + h for i in range(4)]
            reads = [(d // 32) * SUB + 4 * (d % 4) + r * 128 + 16 * ((d % 32 // 4) ^ (r % 8))
                     for r in rows]
            dst = wg * (dp * 128) + d * 128 + 16 * ((2 * jl + h) ^ (d % 8))
            out.append((it, th, [(r, d) for r in rows], reads, dst))
    return out


@pytest.mark.parametrize("dp", PADDED)
def test_small_steps_cover_the_walked_tile_once(dp):
    # V's small parts in the dQ pass: small_step, warpgroup wg its 32 rows
    # of each box, DP / 16 steps beside every other k8 step of dP.
    at = sorted((v // 256) * SUB + wg * 32 * 128 + (v % 256) * 16
                for wg in range(2) for it in range(dp // 16) for v in [it * WG + t for t in range(WG)])
    assert at == list(range(0, dp // 32 * SUB, 16))


@pytest.mark.parametrize("dp", PADDED)
def test_transposed_copies_hold_each_element_once_where_the_b_descriptors_read(dp):
    tb = dp // 32 * SUB
    where = {}  # byte offset in the copy -> (raw row, column)
    raw = []  # offsets read, and written in the raw tile's small parts
    for _, _, elems, reads, dst in transpose_writes(dp):
        for i, ((r, d), at) in enumerate(zip(elems, reads)):
            assert at == tma_address(0, r, d)  # the read is the element TMA wrote there
            assert dst + 4 * i not in where
            where[dst + 4 * i] = (r, d)
            raw.append(at)
    assert sorted(where) == list(range(0, tb, 4))  # every word of the copy once
    assert sorted(raw) == list(range(0, tb, 4))  # every word of the raw tile once
    assert sorted(where.values()) == [(r, d) for r in range(64) for d in range(dp)]
    # dV += P^T.dW (and dK's, dQ's): k8 step j's B descriptor (issue_rs3), N =
    # dp head-dim rows, logical k p = raw row 8j + k_order(p).
    n, k = np.meshgrid(np.arange(dp), np.arange(8), indexing="ij")
    for j in range(TILE // 8):
        desc = sw128_desc((j // 4) * (dp * 128) + (j % 4) * 32, 16, 1024)
        got = k_major_address(desc, n, k)
        for (nn, kk), addr in np.ndenumerate(got):
            assert where[addr] == (8 * j + k_order(kk), nn)


def accumulator_owner(rows, cols):
    """wgmma m64nN's accumulators: (thread, n8 tile j, entry e) holding
    (row, col). Thread 32w + 4g + t holds rows 16w + g and + 8 (e >> 1),
    columns 8j + 2t + (e & 1)."""
    w, g = rows // 16, rows % 16 % 8
    t = cols % 8 // 2
    return 32 * w + 4 * g + t, cols // 8, 2 * (rows % 16 // 8) + cols % 2


def a_of(r):
    """The kernel's a_of: A entry r of a k8 step is accumulator entry a_of(r)."""
    return {0: 0, 1: 2, 2: 1, 3: 3}[r]


def a_position(thread, r):
    """(row, logical k) of a warpgroup's tf32 register A (m64k8, each warp
    the A fragment of mma.m16n8k8 for its 16 rows): (g, t), (g + 8, t),
    (g, t + 4), (g + 8, t + 4)."""
    w, lane = thread // 32, thread % 32
    g, t = lane // 4, lane % 4
    return 16 * w + g + 8 * (r % 2), t + 4 * (r // 2)


@pytest.mark.parametrize("dp", PADDED)
def test_relabelled_accumulators_and_transposed_copies_give_the_tile_product(dp):
    rng = np.random.default_rng(dp)
    acc = rng.integers(-8, 9, (64, 64)).astype(np.float64)  # P^T (or dS^T, dS) [64, 64 rows of X]
    x = rng.integers(-8, 9, (64, dp)).astype(np.float64)  # dW (or Q, K) [64, dp]
    regs = np.zeros((128, 8, 4))  # each thread's accumulators, as wgmma leaves them
    rows, cols = np.meshgrid(np.arange(64), np.arange(64), indexing="ij")
    thread, j, e = accumulator_owner(rows, cols)
    regs[thread, j, e] = acc
    # The copy as transpose_split writes it (small integers: big = x, small 0).
    copy = {}
    for _, _, elems, _, dst in transpose_writes(dp):
        for i, (r, d) in enumerate(elems):
            copy[dst + 4 * i] = x[r, d]
    n, kk = np.meshgrid(np.arange(dp), np.arange(8), indexing="ij")
    out = np.zeros((64, dp))
    for step in range(TILE // 8):
        a = np.full((64, 8), np.nan)
        for th in range(128):
            for r in range(4):
                row, k = a_position(th, r)
                assert np.isnan(a[row, k])
                a[row, k] = regs[th, step, a_of(r)]
        desc = sw128_desc((step // 4) * (dp * 128) + (step % 4) * 32, 16, 1024)
        b = np.vectorize(copy.__getitem__)(k_major_address(desc, n, kk)).T  # [k8, dp]
        out += a @ b
    np.testing.assert_array_equal(out, acc @ x)


def _bank_free(addresses, width):
    """A warp's accesses of `width` bytes, by lane: each phase (128 bytes a
    phase) touches distinct banks."""
    per = 128 // width
    for p0 in range(0, 32, per):
        banks = [(a // 4 + w) % 32 for a in addresses[p0:p0 + per] for w in range(width // 4)]
        if len(banks) != len(set(banks)):
            return False
    return True


@pytest.mark.parametrize("dp", PADDED)
def test_transposed_copies_are_free_of_bank_conflicts(dp):
    work = transpose_writes(dp)
    for it in range(dp // 16):
        for warp in range(fb.BWD_F32_THREADS // 32):
            lanes = [w for w in work if w[0] == it and w[1] // 32 == warp]
            for i in range(4):
                assert _bank_free([w[3][i] for w in lanes], 4)
            assert _bank_free([w[4] for w in lanes], 16)


# --- the arithmetic ---------------------------------------------------------


def f32(x):
    return np.asarray(x, np.float64).astype(np.float32)


def tf32_trunc(x):
    """The tensor core's read of an f32 as TF32: its top 19 bits."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return (bits & np.uint32(0xFFFFE000)).view(np.float32)


def split_rn(x):
    """The kernels' split_rn: big = cvt.rna.tf32.f32, small = x - big (exact),
    as the tensor core reads them."""
    x = np.asarray(x, np.float32)
    big = ((x.view(np.uint32) + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    return big, tf32_trunc(x - big)


def split_raw(x):
    """A raw walked tile: its own big part, read truncated; the small part
    beside it x - trunc(x), read truncated in turn."""
    x = np.asarray(x, np.float32)
    big = tf32_trunc(x)
    return big, tf32_trunc(x - big)


def _rz(x):
    """float64 -> float32 rounded toward zero, as the tensor core's f32
    accumulator rounds its sums."""
    near = x.astype(np.float32)
    over = np.abs(near.astype(np.float64)) > np.abs(x)
    return np.where(over, np.nextafter(near, np.float32(0)), near)


def chain_ss(a, b):
    """S^T = K.Q^T (and dP^T, S, dP) as the kernels issue it: small.big and
    big.big a k8 step over the whole depth, then big.small a k8 step (once
    B's small parts are written), each wgmma's eight exact products added
    to the accumulator, truncated; the first overwrites it."""
    (ab, as_), (bb, bs) = a, b
    acc = np.zeros((ab.shape[0], bb.shape[1]), np.float32)
    for terms in (((as_, bb), (ab, bb)), ((ab, bs),)):
        for k0 in range(0, ab.shape[1], 8):
            ks = slice(k0, k0 + 8)
            for x, y in terms:
                acc = _rz(acc.astype(np.float64) + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
    return acc


def chain(a, b, acc=None):
    """A [m, K] x B [K, n] as 3xTF32 in the kernels' order: each k8 step
    small.big, big.small, big.big, each wgmma's eight exact products added
    to the accumulator, truncated; the first overwrites it (or adds to
    `acc`). a, b: (big, small) pairs as the tensor core reads them."""
    (ab, as_), (bb, bs) = a, b
    if acc is None:
        acc = np.zeros((ab.shape[0], bb.shape[1]), np.float32)
    for k0 in range(0, ab.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = _rz(acc.astype(np.float64) + x[:, ks].astype(np.float64) @ y[ks].astype(np.float64))
    return acc


def _inputs(t, dim, seed):
    """One (batch, head) of the card's backward cases: randn q, k, v, dW and
    dsum, the causal triangle; the block max over each q row's keys (the
    forward's, up to its rounding; any max is an input both sides share)."""
    rng = np.random.default_rng(seed)
    q, k, v, dw = (rng.standard_normal((t, dim)).astype(np.float32) for _ in range(4))
    dsum = rng.standard_normal(t).astype(np.float32)
    s = (q @ k.T) * np.float32(dim ** -0.5)
    s[np.triu_indices(t, 1)] = -np.inf
    return q, k, v, dw, dsum, s.max(axis=1)


def _reference(q, k, v, dw, dsum, m, rows, cols):
    """The backward in float64 over q rows `rows` and kv rows `cols` under
    the triangle: (dq of the rows, dk and dv of the cols)."""
    q64, k64, v64, dw64 = (x.astype(np.float64) for x in (q, k, v, dw))
    pos = np.arange(q.shape[0])

    def probs_and_ds(r, c):
        s = q64[r] @ k64[c].T * q.shape[1] ** -0.5
        s[pos[r, None] < pos[None, c]] = -np.inf
        p = np.exp(s - m[r, None])
        return p, p * (dw64[r] @ v64[c].T + dsum[r, None])

    _, ds = probs_and_ds(rows, slice(None))
    p_c, ds_c = probs_and_ds(slice(None), cols)
    scale = q.shape[1] ** -0.5
    return ds @ k64 * scale, ds_c.T @ q64 * scale, p_c.T @ dw64


def _kv_tile_pass(q, k, v, dw, dsum, m, kt, promote=True):
    """The dK/dV pass's block for kv tile kt as the kernel computes it: K
    and V split to nearest, each live q tile's Q and dW raw, S^T and dP^T
    as 3xTF32 chains, P^T and dS^T in f32, the parts dV = P^T.dW and dK =
    dS^T.Q through the transposed copies' split; `promote`: each tile's
    parts added to the totals in f32 (else one chain over every tile)."""
    t, dim = q.shape
    scale = np.float32(dim ** -0.5)
    cols = slice(kt * TILE, (kt + 1) * TILE)
    kk, vv = split_rn(k[cols]), split_rn(v[cols])
    dk = np.zeros((2, TILE, dim), np.float32)  # the two warpgroups' totals
    dv = np.zeros_like(dk)
    for qt in range(kt, t // TILE):  # the triangle's live q tiles of this column
        rows = slice(qt * TILE, (qt + 1) * TILE)
        qb, db = split_raw(q[rows]), split_raw(dw[rows])
        st = chain_ss(kk, (qb[0].T, qb[1].T))
        dpt = chain_ss(vv, (db[0].T, db[1].T))
        logit = f32(st * scale)
        live = np.arange(kt * TILE, (kt + 1) * TILE)[:, None] <= np.arange(qt * TILE, (qt + 1) * TILE)[None]
        pt = np.where(live, f32(np.exp(logit.astype(np.float64) - m[rows][None])), np.float32(0))
        dst = f32(pt * f32(dpt + dsum[rows][None]))
        for w in range(2):  # each warpgroup's 32 q rows, into its own totals
            cols_w, rows_w = slice(32 * w, 32 * w + 32), slice(qt * TILE + 32 * w, qt * TILE + 32 * w + 32)
            for total, a, x in ((dv[w], pt[:, cols_w], dw[rows_w]), (dk[w], dst[:, cols_w], q[rows_w])):
                if promote:
                    total += chain(split_rn(a), split_rn(x))
                else:
                    total[:] = chain(split_rn(a), split_rn(x), total)
    return f32((dk[0] + dk[1]) * scale), dv[0] + dv[1]


def _q_tile_pass(q, k, v, dw, dsum, m, qt):
    """The dQ pass's block for q tile qt as the kernel computes it."""
    t, dim = q.shape
    scale = np.float32(dim ** -0.5)
    rows = slice(qt * TILE, (qt + 1) * TILE)
    qq, dd = split_rn(q[rows]), split_rn(dw[rows])
    dq = np.zeros((2, TILE, dim), np.float32)  # the two warpgroups' totals
    for kt in range(qt + 1):
        cols = slice(kt * TILE, (kt + 1) * TILE)
        kb, vb = split_raw(k[cols]), split_raw(v[cols])
        s = chain_ss(qq, (kb[0].T, kb[1].T))
        dp = chain_ss(dd, (vb[0].T, vb[1].T))
        live = np.arange(qt * TILE, (qt + 1) * TILE)[:, None] >= np.arange(kt * TILE, (kt + 1) * TILE)[None]
        p = np.where(live, f32(np.exp(f32(s * scale).astype(np.float64) - m[rows][:, None])),
                     np.float32(0))
        ds = f32(p * f32(dp + dsum[rows][:, None]))
        for w in range(2):  # each warpgroup's 32 kv rows
            part = chain(split_rn(ds[:, 32 * w:32 * w + 32]),
                         split_rn(k[kt * TILE + 32 * w:kt * TILE + 32 * w + 32]))
            dq[w] += part
    return f32((dq[0] + dq[1]) * scale)


@pytest.mark.parametrize("t", [1024, 4096])
def test_3xtf32_on_wgmma_holds_the_f32_tolerances(t):
    # The longest walks of each pass: kv tile 0 (every q tile) and the last
    # q tile (every kv tile).
    dim = 64
    q, k, v, dw, dsum, m = _inputs(t, dim, t)
    last = t // TILE - 1
    dq_rows, kv_cols = slice(last * TILE, t), slice(0, TILE)
    want_dq, want_dk, want_dv = _reference(q, k, v, dw, dsum, m, dq_rows, kv_cols)
    got_dk, got_dv = _kv_tile_pass(q, k, v, dw, dsum, m, 0)
    got_dq = _q_tile_pass(q, k, v, dw, dsum, m, last)
    for got, want in ((got_dq, want_dq), (got_dk, want_dk), (got_dv, want_dv)):
        err = np.abs(got - want).max()
        assert err <= (ATOL + RTOL * np.abs(want).max()) / 2
        assert np.linalg.norm(got - want) / np.linalg.norm(want) <= REL / 10
    if t == 4096:
        # One truncating chain over every q tile drifts several times further
        # than the promoted sums (the reason for the promotion).
        one_dk, one_dv = _kv_tile_pass(q, k, v, dw, dsum, m, 0, promote=False)
        for one, got, want in ((one_dk, got_dk, want_dk), (one_dv, got_dv, want_dv)):
            assert np.linalg.norm(one - want) > 2 * np.linalg.norm(got - want)


# --- the ring, shared memory, registers and the launch constants -------------


def ring_program(tiles, stages):
    """A pass's loop in program order (one warpgroup; a stage is refilled
    after a __syncthreads): ("load", tile, stage) where its copies start,
    ("wait", tile, stage, parity) where the warpgroup waits for them at the
    top of iteration i, ("read", tile, stage) while its products, transposed
    copies and small parts read the stage, ("retire", tile) once the
    __syncthreads after the last product of iteration i shows every read of
    tile i done."""
    ops = [("load", j, j % stages) for j in range(min(stages, tiles))]
    ahead = min(stages, tiles)
    for i in range(tiles):
        ops += [("wait", i, i % stages, (i // stages) & 1), ("read", i, i % stages)]
        ops.append(("retire", i))
        if ahead < tiles:
            ops.append(("load", ahead, i % stages))
            ahead += 1
    return ops


@pytest.mark.parametrize("stages", sorted({s for pair in fb.BWD_F32_STAGES.values() for s in pair}))
@pytest.mark.parametrize("tiles", [1, 2, 3, 7, 16])
def test_ring_hands_each_tile_over_once_whenever_the_copies_land(stages, tiles):
    ops = ring_program(tiles, stages)
    assert [op[1] for op in ops if op[0] == "load"] == list(range(tiles))
    for seed in range(30):
        rng = np.random.default_rng(seed)
        completed = [0] * stages  # phases of each stage's barrier
        held = [None] * stages  # the tile whose bytes a stage holds
        in_flight = []  # started loads: (tile, stage)
        reading = {}  # stage -> tile that may still read it
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


def smem_bytes(dp, dkdv, n_classes, stages=None):
    """The kernels' tf_smem_bytes: 1024 bytes of alignment slack; the
    resident tiles split in place with their small parts (4 tiles); the
    walked tile's small parts and transposed copies (6 tiles in the dK/dV
    pass, 4 in the dQ pass); the ring (two raw walked tiles a stage, and in
    the dK/dV pass the q rows' maxes and dsums beside each); the barriers;
    the block's tile classes."""
    tile = TILE * dp * 4
    if stages is None:
        stages = fb.BWD_F32_STAGES[dp][0 if dkdv else 1]
    return (1024 + (10 if dkdv else 8) * tile + stages * (2 * tile + (2 * TILE * 4 if dkdv else 0))
            + 8 * (1 + stages) + n_classes)


@pytest.mark.parametrize("dp", [32, 64, 128])
def test_shared_memory_and_registers_fit_one_block_an_sm(dp):
    if dp > fb.BWD_F32_TMA_MAX_DIM:
        # The same layout at D = 128 exceeds a block's shared memory even
        # with one stage a pass: those calls run on the mma.sync kernels.
        assert all(smem_bytes(dp, dkdv, 1, stages=1) > SMEM_OPT_IN for dkdv in (True, False))
        return
    for dkdv in (True, False):
        # Up to Tq (or Tk) = 16384: 256 classes.
        smem = smem_bytes(dp, dkdv, 256)
        assert smem <= SMEM_OPT_IN and smem + SMEM_RESERVED <= SMEM_PER_SM
        # Registers a thread at one block of two warpgroups an SM.
        cap = min(255, REGISTERS_PER_SM // fb.BWD_F32_THREADS // 8 * 8)
        on = dp // 8 * 4  # a thread's floats of one [64, dp] accumulator
        half = 32 // 8 * 4  # of a warpgroup's [64, 32] S^T (or S, dP^T, dP)
        # dK/dV: dK and dV totals, a part, S^T, dP^T and P^T's big and small
        # A fragments (dS^T's replace them); dQ: the total, a part, S, dP,
        # dS's.
        live = 3 * on + 2 * half + 2 * half if dkdv else 2 * on + 2 * half + 2 * half
        assert live + 48 < cap  # with room for addresses and indices
        # The two warpgroups' totals pass through the transposed copies'
        # room at the end: two outputs in the dK/dV pass, one in the dQ pass.
        assert (2 if dkdv else 1) * on * WG * 4 <= 2 * TILE * dp * 4
    assert fb.BWD_F32_THREADS == 2 * WG == 256


def test_the_sources_launch_constants_are_the_modules():
    src = SOURCE.read_text()
    assert re.search(rf"constexpr int TF_WG = {WG};", src)
    assert re.search(r"constexpr int TF_THREADS = 2 \* TF_WG;", src)
    assert re.search(r"return 1024 \+ \(dkdv \? 10 : 8\) \* TB \+ stages \* \(2 \* TB \+ "
                     r"\(dkdv \? 2 \* TILE \* 4 : 0\)\) \+\s+8 \* \(1 \+ stages\) \+ n_classes;", src)
    for dp in PADDED:
        m = re.search(rf"struct TfConfig<{dp}> {{\s*static constexpr int DKDV_STAGES = (\d+), "
                      rf"DQ_STAGES = (\d+);", src)
        assert m, dp
        assert (int(m.group(1)), int(m.group(2))) == fb.BWD_F32_STAGES[dp]
    # A warpgroup's copies and small parts go one step beside every other k8
    # step of S^T, dP^T (S, dP): DP / 16 steps, a chunk a thread.
    for dp in PADDED:
        assert dp // 32 * SUB // 2 // 16 // WG == dp // 16
    m = re.search(r"if \(dtype == 2\) \{.*?bool ok = p\.D <= (\d+) &&", src, re.S)
    assert m and int(m.group(1)) == fb.BWD_F32_TMA_MAX_DIM
    assert "if (p.D <= 32) return (int)launch_tf32<32>" in src


def _views(dim, heads=4, kv_heads=2, t=8, batch=2):
    g = torch.Generator().manual_seed(dim)
    q = torch.randn((batch, t, heads, dim), generator=g)
    k, v = (torch.randn((batch, t, kv_heads, dim), generator=g) for _ in range(2))
    return q, k, v


def _route(q, k, v):
    bias = torch.zeros((q.shape[1], k.shape[1]))
    variant, _, k5, v5, dims, _ = fb._kernel_args(q, k, v, bias)
    assert variant == "f32"
    return fb._f32_tma_args(q, k5, v5, dims, bias)


def test_the_wrapper_sends_to_tma_exactly_the_views_it_takes():
    # Contiguous MHA at the paths' head dims (the flagship's 64, the small
    # configs' 32, the example yamls' 16 and 8): TMA.
    for dim in (64, 32, 16, 8):
        q, k, v = _views(dim, heads=4, kv_heads=4)
        args = _route(q, k, v)
        assert args is not None and args[2][4] == dim and args[2][5] == 1
    # A GQA expand view (stride 0 on the group axis) keeps its group.
    q, k, v = _views(64)
    args = _route(q, fb._repeat_heads(k, 2), fb._repeat_heads(v, 2))
    assert args is not None and args[2][5] == 2 and args[3][7] == 0  # k's group stride
    # Fused-QKV views: strides 3 * H * D and D, multiples of 4.
    qkv = torch.randn((2, 8, 3, 4, 64))
    assert _route(qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]) is not None
    # D > 64, a head dim whose rows are not 16 bytes, a non-unit D stride and
    # a base off 16 bytes: the mma.sync kernels.
    q, k, v = _views(128, heads=4, kv_heads=4)
    assert _route(q, k, v) is None
    q, k, v = _views(6, heads=4, kv_heads=4)
    assert _route(q, k, v) is None
    q, k, v = _views(64, heads=4, kv_heads=4)
    assert _route(q.transpose(2, 3).contiguous().transpose(2, 3), k, v) is None
    flat = torch.randn(2 * 8 * 4 * 64 + 1)
    assert _route(flat[1:].view(2, 8, 4, 64), k, v) is None
