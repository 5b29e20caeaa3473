"""The f32 flash block kernel's arithmetic and layout, as numpy models.

`flash_block_f32_kernel` (`jobset_tpu_torch/ops/csrc/flash_block.cu`) has
no CPU mode, so what it relies on is modelled here from its constants:

- the 3xTF32 split: `cvt.rna.tf32.f32` rounds an f32 to 10 mantissa bits,
  to nearest with ties away from zero; x = big + small with both TF32, and
  a product is small.big + big.small + big.big. At the flagship block's
  value ranges (randn q, k, v, D=64, T=512, causal triangle) and at large
  logits (|q.k| about 1e3) the block's outputs stay within the f32
  tolerances of `tests/test_torch_cuda.py` (max: 1e-5 relative, 1e-4
  absolute; sum and weighted: 1e-4 relative to the tensor's largest value,
  1e-5 absolute); single-pass TF32 does not. The model sums the TF32
  products exactly (float64), as an ideal accumulator; the card's
  accumulators are f32, which the card's tests cover;
- the m16n8k8 fragment maps (PTX ISA) with the kernel's k order (logical
  k = t, t + 4 read as physical 2t, 2t + 1), which lets P go from S's
  accumulator to P.V's A fragment in registers: on integer inputs both
  products come out exactly equal to the plain ones;
- the launch order: every (batch*head, q tile) once, longest first;
- the shared-memory row strides: every fragment read of a warp, and the
  block's pass that splits each K and V tile in place, is free of bank
  conflicts, and the blocks per SM the kernel asks for fit.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from jobset_tpu_torch.ops import flash_block as tfb

SOURCE = (Path(__file__).resolve().parents[1]
          / "jobset_tpu_torch" / "ops" / "csrc" / "flash_block.cu").read_text()
NEG_INF = np.float32(tfb.NEG_INF)
# An H100 SM's shared memory for resident blocks (228 KB); each block takes
# 1 KB more than it asks for.
SMEM_PER_SM, SMEM_PER_BLOCK_RESERVED = 233_472, 1024
BANKS = 32


def _constant(pattern):
    match = re.search(pattern, SOURCE)
    assert match, pattern
    return int(match.group(1))


TILE = _constant(r"constexpr int TILE = (\d+);")
BIAS_PAD = _constant(r"constexpr int BIAS_STRIDE = TILE \+ (\d+);")
QK_PAD = _constant(r"QK_STRIDE = DP \+ (\d+);")
V_PAD = _constant(r"V_STRIDE = DP \+ (\d+);")
MIN_BLOCKS = re.search(r"MIN_BLOCKS = DP <= (\d+) \? (\d+) : (\d+);", SOURCE)
PADDED_DIMS = (32, 64, 128)  # the kernel's instantiations (launch_f32<DP>)

# Tolerances of the f32 kernel against the plain version (tests/test_torch_cuda.py):
# (rtol, atol) per output.
TOL = {"max": (1e-5, 1e-4), "sum": (1e-4, 1e-5), "weighted": (1e-4, 1e-5)}


@pytest.fixture(autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


# --- the 3xTF32 split -------------------------------------------------------


def tf32_rna(x):
    """cvt.rna.tf32.f32: round an f32 to 10 mantissa bits, to nearest with
    ties away from zero (add half of the dropped 13 bits' range to the
    magnitude, then drop them). Finite inputs."""
    bits = np.asarray(x, np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def split_tf32(x):
    big = tf32_rna(x)
    return big, tf32_rna(np.asarray(x, np.float32) - big)


def _exact(a, b):
    return a.astype(np.float64) @ b.astype(np.float64)


def matmul_3xtf32(a, b):
    """small.big + big.small + big.big, each TF32 product exact."""
    (ab, as_), (bb, bs) = split_tf32(a), split_tf32(b)
    return (_exact(as_, bb) + _exact(ab, bs) + _exact(ab, bb)).astype(np.float32)


def matmul_1xtf32(a, b):
    return _exact(tf32_rna(a), tf32_rna(b)).astype(np.float32)


def matmul_f32(a, b):
    return _exact(a, b).astype(np.float32)


def block_step(q, k, v, bias, matmul):
    """One head of the block step with the given product:
    (max, sum, weighted)."""
    logits = matmul(q, k.T) * np.float32(q.shape[-1] ** -0.5) + bias
    row_max = logits.max(axis=-1)
    probs = np.exp(logits - row_max[:, None])
    return row_max, probs.sum(axis=-1), matmul(probs, v)


def _within(got, want, rtol, atol):
    return np.abs(got - want).max() <= atol + rtol * np.abs(want).max()


def test_rna_rounds_to_ten_mantissa_bits_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)  # TF32's unit in the last place at 1.0
    cases = {
        one + ulp / 2: one + ulp,                        # tie: away from zero
        -(one + ulp / 2): -(one + ulp),
        one + ulp / 2 - np.float32(2.0 ** -23): one,     # just below the tie
        one + 3 * ulp / 2: one + 2 * ulp,                # tie from an odd mantissa: away
        np.float32(3.0): np.float32(3.0),                # already TF32
    }
    for x, want in cases.items():
        assert tf32_rna(np.float32(x)) == want, x


@pytest.mark.parametrize("scale", [1e-3, 1.0, 125.0, 1e4])
def test_split_is_two_tf32_values_within_two_to_minus_22(scale):
    x = (np.random.default_rng(0).standard_normal(4096) * scale).astype(np.float32)
    big, small = split_tf32(x)
    for part in (big, small):
        assert not np.any(part.view(np.uint32) & np.uint32(0x1FFF))  # 13 low bits clear
    rest = x.astype(np.float64) - big.astype(np.float64) - small.astype(np.float64)
    assert np.all(np.abs(rest) <= 2.0 ** -22 * np.abs(x.astype(np.float64)))


def _flagship_head(seed, q_scale):
    rng = np.random.default_rng(seed)
    t, d = 512, 64
    q = (rng.standard_normal((t, d)) * q_scale).astype(np.float32)
    k, v = (rng.standard_normal((t, d)).astype(np.float32) for _ in range(2))
    rows = np.arange(t)
    bias = np.where(rows[:, None] >= rows[None], 0.0, NEG_INF).astype(np.float32)
    return q, k, v, bias


@pytest.mark.parametrize("q_scale", [1.0, 125.0], ids=["flagship_ranges", "large_logits"])
@pytest.mark.parametrize("seed", [0, 1])
def test_three_tf32_products_hold_the_f32_tolerance(seed, q_scale):
    q, k, v, bias = _flagship_head(seed, q_scale)
    if q_scale != 1.0:  # |q.k| about 1e3
        assert 300 < np.abs(q @ k.T).std() < 3000
    want = block_step(q, k, v, bias, matmul_f32)
    got = block_step(q, k, v, bias, matmul_3xtf32)
    for name, g, w in zip(TOL, got, want):
        assert _within(g, w, *TOL[name]), name


@pytest.mark.parametrize("q_scale", [1.0, 125.0], ids=["flagship_ranges", "large_logits"])
def test_single_pass_tf32_misses_the_f32_tolerance(q_scale):
    q, k, v, bias = _flagship_head(0, q_scale)
    want = block_step(q, k, v, bias, matmul_f32)
    got = block_step(q, k, v, bias, matmul_1xtf32)
    assert not all(_within(g, w, *TOL[name]) for name, g, w in zip(TOL, got, want))
    assert not _within(got[0], want[0], *TOL["max"])


# --- m16n8k8 fragment maps --------------------------------------------------


def lanes():
    lane = np.arange(32)
    return lane // 4, lane % 4  # (g, t)


def mma_m16n8k8(a, b, c):
    """The PTX mma.m16n8k8 (.row.col, 32-bit operands) on per-lane
    fragments: a [32, 4] holds A (16x8) at (g, t), (g + 8, t), (g, t + 4),
    (g + 8, t + 4); b [32, 2] holds B (8x8) at (t, g), (t + 4, g); c [32, 4]
    holds C (16x8) at (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
    Returns c + A.B in the same layout."""
    g, t = lanes()
    A = np.zeros((16, 8))
    B = np.zeros((8, 8))
    for e, (r, k) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
        A[r, k] = a[:, e]
    for e, k in enumerate((t, t + 4)):
        B[k, g] = b[:, e]
    D = A @ B
    out = c.copy()
    for e, (r, n) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t), (g + 8, 2 * t + 1))):
        out[:, e] += D[r, n]
    return out


def warp_block(q, k, v):
    """One warp's S = Q.K^T and O = P.V over one kv tile, fragment by
    fragment as the kernel reads them, with P = S (no softmax: the maps
    are the point). q [16, DP], k and v [TILE, DP]."""
    g, t = lanes()
    dp = q.shape[1]
    s = np.zeros((TILE // 8, 32, 4))
    for ks in range(dp // 8):
        d0 = ks * 8 + 2 * t  # logical k t and t + 4 are physical 2t and 2t + 1
        a = np.stack([q[g, d0], q[g + 8, d0], q[g, d0 + 1], q[g + 8, d0 + 1]], axis=1)
        for j in range(TILE // 8):
            b = np.stack([k[j * 8 + g, d0], k[j * 8 + g, d0 + 1]], axis=1)
            s[j] = mma_m16n8k8(a, b, s[j])
    o = np.zeros((dp // 8, 32, 4))
    for j in range(TILE // 8):
        a = s[j][:, [0, 2, 1, 3]]  # S's accumulator as P.V's A fragment
        for n in range(dp // 8):
            b = np.stack([v[j * 8 + 2 * t, n * 8 + g], v[j * 8 + 2 * t + 1, n * 8 + g]], axis=1)
            o[n] = mma_m16n8k8(a, b, o[n])
    return s, o


def gather(frags):
    """[n8 tiles, 32, 4] accumulators -> the [16, 8 * tiles] matrix."""
    g, t = lanes()
    out = np.zeros((16, 8 * len(frags)))
    for n, c in enumerate(frags):
        for e, (r, col) in enumerate(((g, 2 * t), (g, 2 * t + 1), (g + 8, 2 * t),
                                      (g + 8, 2 * t + 1))):
            out[r, n * 8 + col] = c[:, e]
    return out


@pytest.mark.parametrize("dp", PADDED_DIMS)
def test_fragment_maps_give_the_plain_products_exactly(dp):
    rng = np.random.default_rng(dp)
    q = rng.integers(-8, 9, size=(16, dp)).astype(np.float64)
    k, v = (rng.integers(-8, 9, size=(TILE, dp)).astype(np.float64) for _ in range(2))
    s, o = warp_block(q, k, v)
    np.testing.assert_array_equal(gather(s), q @ k.T)
    np.testing.assert_array_equal(gather(o), (q @ k.T) @ v)


def test_mma_model_follows_the_ptx_layout():
    # A one-hot check of the fragment layout itself: A = e_(r,k), B = e_(k,n).
    g, t = lanes()
    for r, kk, n in ((0, 0, 0), (9, 5, 3), (15, 7, 7), (4, 2, 6)):
        a = np.zeros((32, 4))
        b = np.zeros((32, 2))
        for e, (rr, ck) in enumerate(((g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4))):
            a[(rr == r) & (ck == kk), e] = 1
        for e, ck in enumerate((t, t + 4)):
            b[(ck == kk) & (g == n), e] = 1
        want = np.zeros((16, 8))
        want[r, n] = 1
        np.testing.assert_array_equal(gather([mma_m16n8k8(a, b, np.zeros((32, 4)))]), want)


# --- launch order -----------------------------------------------------------


@pytest.mark.parametrize("bh,tq,tk", [(128, 512, 512), (3, 100, 77), (5, 1024, 1024),
                                      (1, 1, 1), (2, 65, 700)])
def test_longest_q_tiles_launch_first_and_each_once(bh, tq, tk):
    # Grid (B*H, q tiles), x fastest; block (x, y) takes q tile
    # gridDim.y - 1 - y of batch*head x.
    n_qt = -(-tq // TILE)
    order = [(x, n_qt - 1 - y) for y in range(n_qt) for x in range(bh)]
    assert sorted(order) == [(x, qt) for x in range(bh) for qt in range(n_qt)]
    rows = torch.arange(tq)[:, None] - torch.arange(tk)[None]
    classes = tfb.tile_classes_reference(torch.where(rows >= 0, 0.0, tfb.NEG_INF))
    live = (classes != tfb.MASKED).sum(dim=1).tolist()
    work = [live[qt] for _, qt in order]
    assert work == sorted(work, reverse=True)


# --- shared memory ----------------------------------------------------------


def _conflict_free(words, width):
    """A warp's shared-memory read of `width` consecutive 4-byte words per
    lane is served in one pass per 128 bytes: within each group of
    32 / width lanes, no two lanes touch the same bank at different words."""
    lanes_per_pass = BANKS // width
    for start in range(0, 32, lanes_per_pass):
        banks = {}
        for w in words[start:start + lanes_per_pass]:
            for i in range(width):
                if banks.setdefault((w + i) % BANKS, w + i) != w + i:
                    return False
    return True


@pytest.mark.parametrize("dp", PADDED_DIMS)
def test_fragment_reads_are_free_of_bank_conflicts(dp):
    g, t = lanes()
    qk, vs, bs = dp + QK_PAD, dp + V_PAD, TILE + BIAS_PAD
    for j in range(TILE // 8):
        for ks in range(dp // 8):  # K as float2 along D
            assert _conflict_free((j * 8 + g) * qk + ks * 8 + 2 * t, 2)
        for n in range(dp // 8):  # V down rows 8j + 2t and 8j + 2t + 1
            for row in (j * 8 + 2 * t, j * 8 + 2 * t + 1):
                assert _conflict_free(row * vs + n * 8 + g, 1)
        for rows in range(0, TILE, 16):  # bias as float2, each m16 tile's rows g and g + 8
            for r in (0, 8):
                assert _conflict_free((rows + g + r) * bs + j * 8 + 2 * t, 2)
    lane = np.arange(32)
    chunks = dp // 4  # the block's split pass and its 16-byte copies: 4 floats a thread
    for stride in (qk, vs):
        for first in range(0, 4 * 32, 32):
            tid = first + lane
            assert _conflict_free((tid // chunks) * stride + 4 * (tid % chunks), 4)
    for stride in (qk, vs, bs):
        assert stride * 4 % 16 == 0  # 16-byte cp.async rows


@pytest.mark.parametrize("dp", PADDED_DIMS)
def test_blocks_per_sm_fit_in_shared_memory(dp):
    at_most, small, large = (int(x) for x in MIN_BLOCKS.groups())
    blocks = small if dp <= at_most else large
    a_region = TILE * max(dp + QK_PAD, TILE + BIAS_PAD)
    # region A (Q, then bias), K, the small parts of K or V, V
    floats = a_region + 2 * TILE * (dp + QK_PAD) + TILE * (dp + V_PAD)
    n_kt = 1024 // TILE  # the classes row at Tk = 1024
    assert blocks * (4 * floats + n_kt + SMEM_PER_BLOCK_RESERVED) <= SMEM_PER_SM
