"""Models, on the CPU, of what the int8 decode kernel relies on, built
from the kernel's constants and layout tables as `ops/int8_matmul.py`
exposes them (the card checks that the built kernel reports the same).

- The fragment relabelling: a lane's four 4-byte words of a k16 step,
  placed into the mma's A fragments by `FRAG_K` and `TILE_COL` and read
  back through PTX's m16n8k16 fragment layout, with x's B fragment in the
  same k order, give exactly the plain product on integer-valued inputs;
  the epilogue writes the true columns and rows.
- The words' shared-memory loads are free of bank conflicts, and a warp's
  copies cover whole 128-byte rows.
- The tile schedule covers every (member, column, row of K) exactly once,
  for ragged N and any number of resident clusters, and every output
  exactly once in the epilogue.
- The split of K is a function of K alone.
- `int8_matmul_group` on the CPU equals the separate plain products bit
  for bit, and `_layer_qkv` with int8 weights still gives the tensors of
  three separate products.
"""

import numpy as np
import pytest
import torch

from jobset_tpu_torch.models import decode as tdec
from jobset_tpu_torch.models import quant as tquant
from jobset_tpu_torch.models import transformer as ttf
from jobset_tpu_torch.ops import int8_matmul as i8

LANES = 32


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _lane(lane):
    return lane // 4, lane % 4  # (g, c)


# PTX ISA, mma.sync.m16n8k16 with .bf16 operands: where each element of
# A (16 x 16, row major), B (16 x 8) and D (16 x 8) lives, as (lane,
# register, half of the register).
def _ptx_a(row, k):
    return 4 * (row % 8) + (k % 8) // 2, (row // 8) + 2 * (k // 8), k % 2


def _ptx_b(k, col):
    return 4 * col + (k % 8) // 2, k // 8, k % 2


def _ptx_d(row, col):
    return 4 * (row % 8) + col // 2, 2 * (row // 8) + col % 2


def _stage_bytes(q, k0):
    """A step of q [K, TILE_COLS] as the kernel's shared memory holds it:
    row r's 16-byte chunk j at chunk j ^ CHUNK_SWIZZLE[r]."""
    stage = np.zeros((i8.STEP_ROWS, i8.TILE_COLS), dtype=np.int64)
    for r in range(i8.STEP_ROWS):
        for j in range(i8.TILE_COLS // 16):
            at = 16 * (j ^ i8.CHUNK_SWIZZLE[r])
            stage[r, at:at + 16] = q[k0 + r, 16 * j:16 * j + 16]
    return stage


def _word_byte(warp, lane, r):
    """Shared-memory byte of the lane's word r (row 4c + r, columns 32 warp
    + 4g .. + 3) in a step, as the kernel addresses it."""
    g, c = _lane(lane)
    chunk = (2 * warp + g // 4) ^ i8.CHUNK_SWIZZLE[4 * c + r]
    return (4 * c + r) * i8.TILE_COLS + 16 * chunk + 4 * (g % 4)


def _warp_product(q, scale, x, rows, warp):
    """Warp `warp`'s chain over the k16 steps of q [K, TILE_COLS] (int8
    values), as the bf16 kernel lays it out: each step in shared memory
    swizzled, each lane's words, its A fragments by FRAG_K and TILE_COL, B
    from x's rows g (+ 8) at physical rows 4c .. 4c + 3; then the
    epilogue's mapping to (x row, the warp's column). Exact in float64."""
    k_dim = q.shape[0]
    n8 = 2 if rows > 8 else 1
    col0 = warp * i8.WARP_COLS
    acc = np.zeros((2, n8, LANES, 4))  # [m16 tile][n8][lane][d register]
    for k0 in range(0, k_dim, i8.STEP_ROWS):
        flat = _stage_bytes(q, k0).reshape(-1)
        a_frag = np.zeros((2, LANES, 4, 2))
        b_frag = np.zeros((n8, LANES, 2, 2))
        for lane in range(LANES):
            g, c = _lane(lane)
            words = [flat[_word_byte(warp, lane, r):_word_byte(warp, lane, r) + 4]
                     for r in range(4)]
            for t in range(2):
                for reg in range(4):
                    for e in range(2):
                        r = i8.FRAG_K[2 * c + 8 * (reg // 2) + e] - 4 * c
                        assert 0 <= r < 4  # lane c's logical ks are its own rows
                        col = i8.TILE_COL[t][reg % 2]
                        a_frag[t, lane, reg, e] = words[r][col] * scale[col0 + 4 * g + col]
            for j in range(n8):
                if g + 8 * j < rows:
                    vals = x[g + 8 * j, k0 + 4 * c:k0 + 4 * c + 4]
                    b_frag[j, lane] = vals.reshape(2, 2)
        for t in range(2):
            a = np.array([[a_frag[t][_ptx_a(row, k)] for k in range(16)] for row in range(16)])
            for j in range(n8):
                b = np.array([[b_frag[j][_ptx_b(k, col)] for col in range(8)]
                              for k in range(16)])
                d = a @ b
                for row in range(16):
                    for col in range(8):
                        lane, reg = _ptx_d(row, col)
                        acc[t, j, lane, reg] += d[row, col]
    y = np.full((rows, i8.WARP_COLS), np.nan)
    for lane in range(LANES):
        g, c = _lane(lane)
        for j in range(n8):
            for e in range(2):
                m = 2 * c + 8 * j + e
                if m < rows:
                    y[m, 4 * g:4 * g + 4] = (acc[0, j, lane, e], acc[0, j, lane, 2 + e],
                                             acc[1, j, lane, e], acc[1, j, lane, 2 + e])
    return y


@pytest.mark.parametrize("rows", [1, 8, 9, 16])
def test_fragment_relabelling_gives_the_plain_product(rows):
    rng = np.random.default_rng(rows)
    k_dim = 2 * i8.STEP_ROWS
    q = rng.integers(-127, 128, (k_dim, i8.TILE_COLS))
    scale = rng.integers(1, 4, i8.TILE_COLS).astype(np.float64)
    x = rng.integers(-3, 4, (rows, k_dim)).astype(np.float64)
    got = np.concatenate([_warp_product(q, scale, x, rows, warp)
                          for warp in range(i8.TILE_COLS // i8.WARP_COLS)], axis=1)
    np.testing.assert_array_equal(got, x @ (q * scale))


def test_frag_k_is_a_permutation_that_keeps_each_lane_on_its_rows():
    assert sorted(i8.FRAG_K) == list(range(i8.STEP_ROWS))
    for c in range(4):
        logical = [2 * c, 2 * c + 1, 2 * c + 8, 2 * c + 9]
        assert [i8.FRAG_K[k] for k in logical] == [4 * c, 4 * c + 1, 4 * c + 2, 4 * c + 3]
    assert sorted(v for pair in i8.TILE_COL for v in pair) == [0, 1, 2, 3]
    assert len(i8.layout()) == 9 + 16 + 16 + 4


@pytest.mark.parametrize("warp", range(4))
@pytest.mark.parametrize("r", range(4))
def test_a_lanes_word_loads_are_free_of_bank_conflicts(warp, r):
    banks = [(_word_byte(warp, lane, r) // 4) % 32 for lane in range(LANES)]
    assert sorted(banks) == list(range(32))


def test_a_warps_copies_cover_whole_rows():
    # Thread tau of a rank lane copies chunk tau % chunks of row tau //
    # chunks: a warp's copy instruction covers four whole 128-byte rows.
    chunks = i8.TILE_COLS // 16
    for warp in range(i8.TILE_COLS // i8.WARP_COLS):
        rows = {(32 * warp + lane) // chunks for lane in range(LANES)}
        got = sorted((32 * warp + lane) % chunks for lane in range(LANES))
        assert len(rows) == 4 and got == sorted(list(range(chunks)) * 4)


def _schedule_coverage(ns, k_dim, rows, sms, grid_clusters):
    """Model of the kernel's work split (`block_for`'s shape): cluster cid
    walks 128-column tiles cid, cid + G, ...; block `brank` of it holds
    ranks brank * rank_lanes * ranks_per_warp ..; warp w is column group w
    % 4 of rank lane w // 4, summing its ranks in turn. A rank's sum for
    (x row m, column quad) is unit m * quads + quad of the tile, pushed to
    block unit // share, which writes units brank * share ... Returns the
    visits of every (member, row of K, column), the pushes of every (rank,
    member, x row, quad), and the writes of every (member, x row, quad)."""
    ranks, rank_rows = i8.split_for(k_dim)
    lanes, per_warp, cluster = i8.block_for(ranks, ns, sms)
    assert cluster * lanes * per_warp == ranks
    groups, quads = i8.TILE_COLS // i8.WARP_COLS, i8.TILE_COLS // 4
    share = rows * quads // cluster
    assert share * cluster == rows * quads
    tile0 = np.cumsum([0] + [-(-n // i8.TILE_COLS) for n in ns])
    tiles = int(tile0[-1])
    seen = [np.zeros((k_dim, n), dtype=int) for n in ns]
    pushed = [np.zeros((ranks, rows, -(-n // 4)), dtype=int) for n in ns]
    written = [np.zeros((rows, -(-n // 4)), dtype=int) for n in ns]
    for cid in range(grid_clusters):
        for tile in range(cid, tiles, grid_clusters):
            member = int(np.searchsorted(tile0, tile, side="right")) - 1
            n, first_col = ns[member], (tile - tile0[member]) * i8.TILE_COLS
            for brank in range(cluster):
                for warp in range(groups * lanes):
                    cg, lane = warp % groups, warp // groups
                    col = first_col + cg * i8.WARP_COLS
                    for rank in range((brank * lanes + lane) * per_warp,
                                      (brank * lanes + lane + 1) * per_warp):
                        row0, row_end = rank * rank_rows, min(k_dim, (rank + 1) * rank_rows)
                        for stage in range(rank_rows // i8.STAGE_ROWS):
                            ks = range(row0 + stage * i8.STAGE_ROWS,
                                       min(row_end, row0 + (stage + 1) * i8.STAGE_ROWS))
                            cols = range(col, min(n, col + i8.WARP_COLS))
                            if len(ks) and len(cols):
                                seen[member][ks.start:ks.stop, cols.start:cols.stop] += 1
                        for m in range(rows):
                            for g in range(8):  # lanes' quads: columns 4g .. 4g + 3
                                quad = cg * (i8.WARP_COLS // 4) + g
                                unit = m * quads + quad
                                assert unit // share < cluster  # an owner in the cluster
                                if first_col + 4 * quad < n:
                                    pushed[member][rank, m, (first_col + 4 * quad) // 4] += 1
                for unit in range(brank * share, (brank + 1) * share):
                    m, quad = divmod(unit, quads)
                    if first_col + 4 * quad < n:
                        written[member][m, (first_col + 4 * quad) // 4] += 1
    return seen, pushed, written


@pytest.mark.parametrize("ns,k_dim", [([1024], 1024), ([1024, 256, 256], 1024), ([4096], 1024),
                                      ([1024], 4096), ([32000], 1024), ([17], 300),
                                      ([1000, 17, 64], 1000), ([24], 70), ([4096], 1030)])
@pytest.mark.parametrize("rows,sms,grid", [(8, 132, None), (3, 132, 7), (16, 8, 1)])
def test_tile_schedule_visits_every_tile_and_k_slice_once(ns, k_dim, rows, sms, grid):
    tiles = sum(-(-n // i8.TILE_COLS) for n in ns)
    seen, pushed, written = _schedule_coverage(ns, k_dim, rows, sms, min(tiles, grid or tiles))
    for s, p, w in zip(seen, pushed, written):
        assert (s == 1).all()
        assert (p == 1).all()
        assert (w == 1).all()


@pytest.mark.parametrize("k_dim", [8, 70, 128, 300, 1000, 1024, 1030, 2050, 4096, 16384])
def test_the_split_is_a_function_of_k_alone(k_dim):
    ranks, rank_rows = i8.split_for(k_dim)
    assert ranks & (ranks - 1) == 0 and 1 <= ranks <= i8.MAX_RANKS
    assert rank_rows % i8.STAGE_ROWS == 0 and ranks * rank_rows >= k_dim
    assert ranks == 1 or rank_rows >= i8.RANK_ROWS // 2
    # Where the ranks live changes with the widths and the card, the split
    # never.
    for ns in ([64], [1024], [1024, 256, 256], [32000]):
        for sms in (8, 132):
            assert i8.split_for(k_dim) == (ranks, rank_rows)
            lanes, per_warp, cluster = i8.block_for(ranks, ns, sms)
            assert lanes & (lanes - 1) == 0 and lanes <= i8.MAX_RANK_LANES
            assert cluster & (cluster - 1) == 0 and cluster <= i8.MAX_CLUSTER
            assert cluster * lanes * per_warp == ranks


def test_flagship_schedule():
    # The decode step's products: the small ones spread across clusters,
    # the unembedding in whole tiles.
    assert i8.split_for(1024) == (8, 128) and i8.split_for(4096) == (32, 128)
    assert i8.block_for(8, [1024], 132) == (1, 1, 8)  # wo [1024, 1024]
    assert i8.block_for(8, [1024] * 3, 132) == (1, 1, 8)  # the grouped Q/K/V
    assert i8.block_for(8, [4096], 132) == (1, 1, 8)  # w1
    assert i8.block_for(32, [1024], 132) == (2, 2, 8)  # w2 [4096, 1024]
    assert i8.block_for(8, [32000], 132) == (2, 4, 1)  # the unembedding
    assert i8.block_for(64, [1024], 132) == (2, 4, 8)  # K = 8192
    # An MoE layer's expert stacks (8 experts): we1 [8, 1024, 4096] in
    # whole tiles, we2 [8, 4096, 1024] over clusters of 4, 4 ranks a warp.
    assert i8.block_for(8, [4096] * 8, 132) == (2, 4, 1)
    assert i8.block_for(32, [1024] * 8, 132) == (2, 4, 4)


def _operands(rows, k_dim, ns, dtype, seed=0, lead=()):
    gen = torch.Generator().manual_seed(seed)
    qts = [tquant.quantize_int8(torch.randn(k_dim, n, generator=gen) / k_dim ** 0.5) for n in ns]
    x = torch.randn(*lead, rows, k_dim, generator=gen).to(dtype)
    return x, qts


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("rows", [1, 8, 16])
@pytest.mark.parametrize("ns", [[64, 64, 64], [64, 16, 16]], ids=["mha", "gqa"])
def test_group_on_cpu_equals_the_separate_plain_products(dtype, rows, ns):
    x, qts = _operands(rows, 48, ns, dtype, seed=rows, lead=(2,))
    got = i8.int8_matmul_group(x, qts, dtype)
    assert len(got) == len(ns)
    for y, qt in zip(got, qts):
        want = i8.int8_matmul_plain(x, qt, dtype)
        assert y.dtype == dtype and y.shape == want.shape
        assert torch.equal(y.view(torch.int16) if dtype == torch.bfloat16 else y.view(torch.int32),
                           want.view(torch.int16) if dtype == torch.bfloat16
                           else want.view(torch.int32))
    assert all(torch.equal(a, b) for a, b in zip(
        tquant.matmul_group(x, qts, dtype), i8.int8_matmul_group_plain(x, qts, dtype)))


def test_group_takes_one_to_three_weights():
    x, qts = _operands(2, 32, [8, 8, 8, 8], torch.float32)
    for bad in ([], qts):
        with pytest.raises(ValueError, match="takes 1..3"):
            i8.int8_matmul_group(x, bad, torch.float32)


def _old_layer_qkv(p, xn, base, cfg):
    """`_layer_qkv` as it was: three separate products."""
    positions = base + torch.arange(xn.shape[1], dtype=torch.float32, device=xn.device)

    def proj(w, n_heads):
        y = tquant.matmul(xn, w, cfg.dtype)
        return y.reshape(*y.shape[:-1], n_heads, cfg.head_dim)

    q = ttf.rotary(proj(p["wq"], cfg.n_heads), positions, cfg.rope_theta)
    k = ttf.rotary(proj(p["wk"], cfg.kv_heads), positions, cfg.rope_theta)
    return q, k, proj(p["wv"], cfg.kv_heads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("quantized", [True, False], ids=["int8", "float"])
@pytest.mark.parametrize("n_kv_heads,t", [(0, 1), (2, 1), (2, 12)], ids=["mha", "gqa", "gqa_prefill"])
def test_layer_qkv_gives_the_tensors_of_three_separate_products(dtype, quantized, n_kv_heads, t):
    cfg = ttf.TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_kv_heads=n_kv_heads,
                                d_ff=64, n_layers=1, dtype=dtype)
    params = ttf.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    if quantized:
        params = tquant.quantize_params_for_serving(params)
    p = ttf.layer_params(tdec.cast_params(params, dtype), 0)
    xn = torch.randn(2, t, 32, generator=torch.Generator().manual_seed(4)).to(dtype)
    for got, want in zip(tdec._layer_qkv(p, xn, 5, cfg), _old_layer_qkv(p, xn, 5, cfg)):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert torch.equal(got, want)
