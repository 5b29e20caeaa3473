// The grouped (ragged) product of a mixture-of-experts layer on Hopper
// (sm_90a):
//
//     y[r, :] = T(sum_k xs[r, k] * w[g(r), k, :])      (f32 sums, y in T)
//
// for xs [M, K] whose rows are sorted by expert, group_sizes [E] int32 on
// the device (group e is the next group_sizes[e] rows), w [E, K, N] and T
// the compute dtype (bfloat16 or float32). Rows past the last group are
// written as zeros. It replaces `lax.ragged_dot` (with
// preferred_element_type = T) in `jobset_tpu/models/transformer.py::
// sorted_ragged_expert_ffn` (`:670`, `:675`), which XLA compiles on the
// TPU (no Pallas kernel there).
//
// Bound: operations. The flagship prefill's products, [16384, 1024] x
// [8, 1024, 4096] and back, do 2 * 16384 * 1024 * 4096 operations each
// (137 GFLOP, 0.14 ms at the card's 989 TFLOP/s in bf16; 0.83 ms as
// three TF32 products at 495 TFLOP/s, 2.05 ms on the f32 FMA pipes)
// against 50 MB of bf16 operands (0.015 ms at 3.35 TB/s).
//
// - No host sync. The group sizes are decided on the card, so the work is
//   sized from their static bound: a group of s rows takes ceil(s / BM)
//   row tiles, so all of them, and the zero rows past the last group, take
//   at most ceil(M / BM) + E + 1 row slots (`row_slots` in
//   `ops/grouped_matmul.py`). Row slot s finds its tile by a warp's prefix
//   sums over group_sizes (`find_tile`: one load a lane, shuffles): its
//   group, its first row and the group's end. The busy slots come first;
//   a slot past the last tile is idle. A tile never mixes two experts:
//   rows of a tile past its group's end are never written.
// - bf16 (`grouped_mm_tma_kernel`, where K and N are multiples of 8 and
//   xs, w and y 16-byte aligned, which TMA needs): warp-specialized and
//   persistent. One block an SM walks the (row slot, 256-column tile)
//   pairs in a fixed stride, column tiles fastest, so the blocks in flight
//   share a few A row tiles and an expert's weight in L2. Warp 0 of the
//   producer warpgroup (lane 0) loads each K step of 64 by TMA into a ring
//   of three 48 KB stages, each with a full and an empty mbarrier: A as one
//   box of 128 rows x 64 k from a 2-D map over xs (rows past the group's
//   end come along, the next group's rows or TMA's zeros past M; each
//   output row depends on its own A row only, and those rows are not
//   stored), B as four boxes of 64 k x 64 columns from a 3-D map over w
//   [E, K, N] (the expert is a coordinate; boxes wholly past N are not
//   loaded: their columns are not stored). Two consumer warpgroups each
//   own 64 rows x 256 columns of the tile: wgmma m64n256k16 reads A
//   (K-major) and B (N-major, through the transpose bit) from the
//   128-byte swizzled stages TMA wrote, into 128 f32 accumulators a
//   thread; each K step's products run while the step before completes,
//   then that step's stage is released. A tile's output goes to shared
//   memory and each of the group's rows to y by the bulk-copy engine
//   (`cp.async.bulk`, a row's bytes exactly: a box-wide store would
//   overwrite a neighbouring group's rows that another block writes),
//   which runs on while the consumers start the next tile and the
//   producer fills its stages. What bounds it is L2: a 128 x 256 tile
//   reads 48 KB a K step for 4.2 MFLOP, 11.6 TB/s at the tensor cores'
//   peak. Stores straight from the accumulators (4 bytes a thread, the
//   tensor cores idle meanwhile) were slower on an H100 than the staging
//   and the fourth ring stage whose room it takes. Registers move to the
//   consumers by setmaxnreg (40 for the producer warpgroup, 232 for each
//   consumer one: 128 x (40 + 2 x 232) <= 65,536).
// - bf16 operands TMA cannot take (`grouped_mm_bf16_kernel`): 128 x 128
//   tiles, one block a (column tile, row slot), K in steps of 64 read
//   element by element into a 3-stage ring in shared memory; 8 warps of
//   64 x 32, `ldmatrix` and `mma.sync.m16n8k16`. Shared rows are
//   xor-swizzled by 16-byte chunk, so the ldmatrix reads are free of bank
//   conflicts.
// - f32 (`grouped_mm_f32_kernel`): 3xTF32 on the tensor cores
//   (mma.sync.m16n8k8; tf32 wgmma takes K-major operands only, and w is
//   N-major), each operand x = big + small (two TF32 values) and a
//   product small.big + big.small + big.big, within f32's tolerances.
//   128 x 128 tiles, one block a (column tile, row slot), one block an
//   SM; K in steps of 32 through a 4-stage `cp.async` ring (16-byte
//   copies where K and N are multiples of 4 and the operands 16-byte
//   aligned, 4-byte ones elsewhere). 8 warps of 64 x 32; each k8 step
//   reads its logical k = t, t + 4 as physical 2t, 2t + 1 and B's column
//   of (n8 tile j, g) as 4g + j, so A fragments come as float2 pairs (row
//   pitch 8 mod 32 words), B fragments as float4 quads (pitch 4 mod 32),
//   both free of bank conflicts, and a thread's outputs of a row are 8
//   adjacent columns (two float4 stores). Operands are split where a warp
//   reads its fragments: on an H100 a pass that split each stage once in
//   shared memory (big parts in place, small parts beside them), with
//   its traffic and a second barrier a step, cost more than the redundant
//   splits, whose instructions hide under the tensor cores' time. The
//   tensor core's f32 adds truncate, so each K step's sums start from
//   zero and are added to the output's in f32 (rounded to nearest): one
//   chain of 3K/8 truncating adds drifts past the f32 tolerance at K =
//   4096.
// - Each output's sums run in one fixed order, with no split of K across
//   blocks and no atomics: two launches give the same bits.
//
// The product's backward (the two `ragged_dot_general` programs of the
// VJP of `lax.ragged_dot`):
// - dgrad, dxs = dy . w[g(r)]^T, is the forward's function with B
//   transposed: the TMA kernel's BKMajor instantiation reads w [E, K, N]
//   as it lies (B K-major, the transpose bit off); for the other kernels
//   `ops/grouped_matmul.py` copies w to [E, N, K] first.
// - wgrad, dw[e] = xs[seg_e]^T . dy[seg_e] [E, K, N], is ragged on the
//   contraction: one block a (tile of N, 128-row tile of K, expert), which
//   finds its segment from the group sizes on the card (the groups before
//   it, clamped to M) and walks its rows in steps, in order from the
//   first; rows of a step outside the segment are zeros, so a step that
//   crosses a group boundary adds nothing of the neighbour's rows. An
//   empty group's blocks write zeros. No split of the rows across blocks
//   and no atomics: two launches give the same bits. bf16 where TMA takes
//   the operands (`grouped_wgrad_tma_kernel`): 256-column tiles, steps of
//   64 rows loaded by TMA from a producer warp into the forward's 3-stage
//   ring, wgmma m64n256k16 with A = xs^T read M-major and B = dy N-major
//   (both through the transpose bit), the rows past the segment zeroed in
//   shared memory; the tile's output staged in the forward's staging room
//   as 128-byte swizzled boxes and stored by TMA (a 3-D map over dw, the
//   expert a coordinate), which runs on while the next tile's products
//   do. Other bf16 (`grouped_wgrad_bf16_kernel`): 128-column
//   tiles, `mma.sync` m16n8k16 on operands read element by element, both
//   by `ldmatrix.trans`. f32 where TMA takes the operands (K and N
//   multiples of 4, 16-byte aligned bases; `grouped_wgrad_f32_tma_kernel`):
//   3xTF32 on tf32 wgmma, which takes its shared-memory operands K-major
//   only, while here both arrive with the contraction (the rows)
//   outermost. So A = xs^T comes from registers (the RS form), loaded from
//   the raw xs stage TMA wrote, and only B = dy is made K-major: the
//   producer warpgroup's idle warps split each landed dy step into big and
//   small TF32 and write them transposed, [128 columns][32 rows], in the
//   128-byte swizzle wgmma reads. Persistent over (expert, 128-row K tile,
//   128-column N tile), as the bf16 TMA kernel; each promotion interval's
//   sums (64 rows) start from zero and are added to totals in registers
//   in f32 (a segment may hold every row: up to 16384 at the flagship,
//   where one truncating chain would drift past the tolerance). Other f32
//   (`grouped_wgrad_f32_kernel`): 128-column tiles, one block a tile,
//   steps of 32 rows through a 4-byte `cp.async` ring, 3xTF32 on m16n8k8
//   with each step's sums added to the output in f32; rows 136 floats
//   apart, so a warp's fragment reads (k = c, column g) are free of bank
//   conflicts.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                 // rows of an output tile (every kernel)
constexpr int BN = 128, THREADS = 256;  // bf16 mma.sync and f32: tile columns, threads
constexpr int BK = 64, STAGES = 3;      // bf16 mma.sync: K step, ring depth
constexpr int A_STAGE = BM * BK * 2;    // bytes of A a stage: 16 KB
constexpr int B_STAGE = BK * BN * 2;    // bytes of B a stage: 16 KB
constexpr int SMEM_BF16 = STAGES * (A_STAGE + B_STAGE);

constexpr int TMA_BN = 256, TMA_BK = 64, TMA_STAGES = 3;  // bf16 TMA: tile columns, K step, ring
constexpr int TMA_THREADS = 384;        // producer warpgroup, two consumer warpgroups
constexpr int CONSUMER_WARPS = 8;
constexpr int PRODUCER_REGS = 40, CONSUMER_REGS = 232;
constexpr int TMA_A_BYTES = BM * TMA_BK * 2;      // 16 KB: 128 rows x 128-byte swizzled k
constexpr int TMA_B_BOX = TMA_BK * 64 * 2;        // 8 KB: 64 k x 64 columns, 128-byte swizzled
constexpr int TMA_STAGE = TMA_A_BYTES + 4 * TMA_B_BOX;  // 48 KB
// A tile's output staged as bf16 rows 528 bytes apart (132 words: 4 mod
// 32, so a warp's accumulator writes are free of bank conflicts).
constexpr int TMA_OUT_PITCH = TMA_BN * 2 + 16;
constexpr int TMA_OUT_BYTES = BM * TMA_OUT_PITCH;
// 1024-byte alignment slack, the ring, the staged output, a full and an
// empty barrier a stage.
constexpr int TMA_SMEM = 1024 + TMA_STAGES * TMA_STAGE + TMA_OUT_BYTES + 2 * TMA_STAGES * 8;
// The bf16 wgrad kernel stages its tile in the same room: each consumer
// warpgroup's 64 x 256 outputs as four TMA store boxes of 64 rows x 64
// columns, 128-byte swizzled rows.
constexpr int W_OUT_BYTES = 2 * 4 * TMA_B_BOX;
static_assert(W_OUT_BYTES <= TMA_OUT_BYTES, "the wgrad staging fits the forward's");

constexpr int F_BK = 32, F_STAGES = 4;  // f32: K step, ring depth
constexpr int F_AP = F_BK + 8;          // A row pitch (floats): 8 mod 32
constexpr int F_BP = BN + 4;            // B row pitch (floats): 4 mod 32
constexpr int F_A_FLOATS = BM * F_AP, F_STAGE_FLOATS = F_A_FLOATS + F_BK * F_BP;
constexpr int SMEM_F32 = F_STAGES * F_STAGE_FLOATS * 4;

constexpr int W_BR = 64, W_STAGES = 3;           // bf16 wgrad: rows a step, ring depth
constexpr int W_STAGE = 2 * W_BR * BN * 2;       // xs and dy rows of a step: 32 KB
constexpr int SMEM_W_BF16 = W_STAGES * W_STAGE;  // 96 KB
constexpr int WF_BR = 32, WF_STAGES = 4;         // f32 wgrad: rows a step, ring depth
constexpr int WF_P = BN + 8;                     // row pitch (floats): 8 mod 32
constexpr int WF_STAGE_FLOATS = 2 * WF_BR * WF_P;
constexpr int SMEM_W_F32 = WF_STAGES * WF_STAGE_FLOATS * 4;  // 136 KB
// f32 wgrad by TMA and tf32 wgmma: tile columns (the tile's K rows are
// BM), rows a step (one 128-byte swizzled row of B's tf32 values), ring
// depth, rows a promotion interval.
constexpr int WT_BN = 128, WT_BR = 32, WT_STAGES = 4, WT_PROMOTE = 64;
constexpr int WT_BOX = WT_BR * 32 * 4;          // 4 KB: 32 rows x 32 f32, 128-byte swizzled
constexpr int WT_STAGE = 2 * 4 * WT_BOX;        // xs's four boxes, then dy's: 32 KB
constexpr int WT_B_TILE = WT_BN * WT_BR * 4;    // 16 KB: [128 columns][32 rows] tf32, K-major
constexpr int WT_B_BUF = 2 * WT_B_TILE;         // big, then small
// 1024-byte alignment slack, the ring, two B buffers, a full and an empty
// barrier a stage and a B buffer.
constexpr int WT_SMEM = 1024 + WT_STAGES * WT_STAGE + 2 * WT_B_BUF + 2 * (WT_STAGES + 2) * 8;
constexpr unsigned FULL = 0xffffffffu;

// TMA_T: bf16 by TMA and wgmma with w given as [E, N, K] (x . w[g]^T).
enum Variant { F32 = 0, TMA = 1, MMA = 2, TMA_T = 3 };
// `prepare`'s slots for the other kernels (the variants above take 0-2).
enum Slot { F32_VEC = 3, WGRAD_MMA = 4, WGRAD_F32 = 5, WGRAD_F32_TMA = 6, TMA_T_SLOT = 7,
            WGRAD_TMA = 8, SLOTS = 9 };

struct Params {
  const void* x;       // [M, K] in T
  const void* w;       // [E, K, N] in T
  void* y;             // [M, N] in T
  const int* sizes;    // [E] int32
  int M, K, N, E;
};

struct Tile {
  int group;  // -1: rows past the last group (zeros); -2: no tile
  int row0, row_end;
};

// Row tile `slot`, found by one warp (all its lanes return the same):
// groups in chunks of 32, a lane a group, inclusive prefix sums of their
// rows and row tiles by shuffles.
__device__ Tile find_tile(const Params& p, int slot) {
  const int lane = threadIdx.x % 32;
  int rows_before = 0, tiles_before = 0;
  for (int base = 0; base < p.E; base += 32) {
    const int e = base + lane;
    const int size = e < p.E ? max(p.sizes[e], 0) : 0;
    const int tiles = (size + BM - 1) / BM;
    int rows_incl = size, tiles_incl = tiles;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int r = __shfl_up_sync(FULL, rows_incl, o), t = __shfl_up_sync(FULL, tiles_incl, o);
      if (lane >= o) rows_incl += r, tiles_incl += t;
    }
    const int t0 = tiles_before + tiles_incl - tiles;
    const unsigned hit = __ballot_sync(FULL, slot >= t0 && slot < t0 + tiles);
    if (hit) {
      const int src = __ffs(hit) - 1;
      const int r0 = __shfl_sync(FULL, rows_before + rows_incl - size, src);
      const int first = __shfl_sync(FULL, t0, src);
      const int end = __shfl_sync(FULL, rows_before + rows_incl, src);
      const int row0 = r0 + (slot - first) * BM;
      if (row0 >= p.M) return {-2, 0, 0};  // group sizes past M: nothing left to write
      return {base + src, row0, min(end, p.M)};
    }
    rows_before += __shfl_sync(FULL, rows_incl, 31);
    tiles_before += __shfl_sync(FULL, tiles_incl, 31);
  }
  const int rest = p.M - rows_before;
  if (rest > 0 && slot >= tiles_before && slot < tiles_before + (rest + BM - 1) / BM)
    return {-1, rows_before + (slot - tiles_before) * BM, p.M};
  return {-2, 0, 0};
}

// The tile of block (column tile blockIdx.x, row slot blockIdx.y) in
// shared memory, found once. Returns false where the block has nothing
// to do (it has then written its zeros, if any).
template <typename T>
__device__ __forceinline__ bool block_tile(const Params& p, Tile& tile) {
  __shared__ Tile shared;
  if (threadIdx.x < 32) {
    const Tile t = find_tile(p, blockIdx.y);
    if (threadIdx.x == 0) shared = t;
  }
  __syncthreads();
  tile = shared;
  if (tile.group == -1) {
    T* y = static_cast<T*>(p.y);
    const int col0 = blockIdx.x * BN;
    const int rows = min(BM, tile.row_end - tile.row0), cols = min(BN, p.N - col0);
    for (int u = threadIdx.x; u < rows * cols; u += THREADS)
      y[(size_t)(tile.row0 + u / cols) * p.N + col0 + u % cols] = static_cast<T>(0.f);
  }
  return tile.group >= 0;
}

__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// A copy of `src_bytes` (0 or the full size) from global memory; the rest
// of the destination is zero-filled, and a 0-byte copy reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// bf16, operands TMA cannot take: mma.sync
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4], const void* ptr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(ptr)) : "memory");
}

// d += a * b: a 16x16 bf16 (row major), b 16x8 bf16, d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
               "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
               : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Byte offset of 16-byte chunk `ch` of row `row` in a stage: A rows are
// 128 bytes (8 chunks), B rows 256 bytes (16 chunks), each chunk xor row %
// 8. Eight consecutive rows at one logical chunk then cover all 32 banks,
// as ldmatrix reads them.
__device__ __forceinline__ int a_off(int row, int ch) { return row * (2 * BK) + 16 * (ch ^ (row & 7)); }
__device__ __forceinline__ int b_off(int row, int ch) { return row * 256 + 16 * (ch ^ (row & 7)); }

__global__ void __launch_bounds__(THREADS, 2) grouped_mm_bf16_kernel(const __grid_constant__ Params p) {
  Tile tile;
  if (!block_tile<__nv_bfloat16>(p, tile)) return;
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int col0 = blockIdx.x * BN;
  const int K = p.K, N = p.N;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* w = static_cast<const __nv_bfloat16*>(p.w) + (size_t)tile.group * K * N;
  const int steps = (K + BK - 1) / BK;

  // Stage `slot` <- K step `kt`: A rows row0.. (zeros past the group's
  // end), B rows kt * BK.. of columns col0..; four 8-element chunks of each
  // a thread, read element by element.
  auto load = [&](int slot, int kt) {
    unsigned char* a_s = smem + slot * (A_STAGE + B_STAGE);
    unsigned char* b_s = a_s + A_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * THREADS;
      const int row = u / (BK / 8), ch = u % (BK / 8), r = tile.row0 + row, k = kt * BK + ch * 8;
      const bool in = r < tile.row_end && k < K;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = in && k + j < K ? x[(size_t)r * K + k + j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(a_s + a_off(row, ch)) = *reinterpret_cast<const uint4*>(v);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * THREADS;
      const int row = u / 16, ch = u % 16, k = kt * BK + row, n = col0 + ch * 8;
      const bool in = k < K && n < N;
      __align__(16) __nv_bfloat16 v[8];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        v[j] = in && n + j < N ? w[(size_t)k * N + n + j] : __float2bfloat16_rn(0.f);
      *reinterpret_cast<uint4*>(b_s + b_off(row, ch)) = *reinterpret_cast<const uint4*>(v);
    }
  };

  // Warp (wm, wn) owns rows 64 wm .. + 63 and columns 32 wn .. + 31 of the
  // tile: 4 m16 tiles by 4 n8 tiles.
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s)
    if (s < steps) load(s, s);
  for (int kt = 0; kt < steps; ++kt) {
    __syncthreads();  // step kt is in place; the slot of step kt - 1 is free
    if (kt + STAGES - 1 < steps) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    const unsigned char* a_s = smem + (kt % STAGES) * (A_STAGE + B_STAGE);
    const unsigned char* b_s = a_s + A_STAGE;
#pragma unroll
    for (int k16 = 0; k16 < BK / 16; ++k16) {
      // A: lane l gives row l % 16 of the m16 tile, chunk 2 k16 + l / 16
      // (matrices: rows 0-7 | 8-15, k 0-7 | 8-15).
      unsigned a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], a_s + a_off(64 * wm + 16 * mt + lane % 16, 2 * k16 + lane / 16));
      // B, transposed: lane l gives k row l % 16 of the step, chunk of n8
      // tile 2 j + l / 16 (matrices: k 0-7 | 8-15 of n8 tile 2j, then 2j + 1).
      unsigned b[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(r, b_s + b_off(16 * k16 + lane % 16, 4 * wn + 2 * j + lane / 16));
        b[2 * j][0] = r[0], b[2 * j][1] = r[1], b[2 * j + 1][0] = r[2], b[2 * j + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }

  // D fragment: d0, d1 row g, columns 2c, 2c + 1; d2, d3 row g + 8.
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile.row0 + 64 * wm + 16 * mt + g + 8 * h;
      if (r >= tile.row_end) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = col0 + 32 * wn + 8 * nt + 2 * c;
        if (n < N) y[(size_t)r * N + n] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        if (n + 1 < N) y[(size_t)r * N + n + 1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
      }
    }
}

// ---------------------------------------------------------------------------
// bf16: wgmma fed by TMA from a producer warp, persistent
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, int parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of `parity` to complete. A wait of more than about a
// second means a lost arrival: trap, so the launch fails instead of
// holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 31)) __trap();
}

// One TMA box into shared memory (coordinates innermost first); completion
// is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)),
         "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// `bytes` (a multiple of 16) from shared memory to global memory by the
// bulk-copy engine, in this thread's bulk group; both addresses 16-byte
// aligned. The shared memory written before it must be fenced for the
// async proxy (fence_proxy_async).
__device__ __forceinline__ void bulk_store(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n"
               :: "l"(dst), "r"(smem_addr(src)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// One TMA box from shared memory (coordinates innermost first) in this
// thread's bulk group: only the box's elements inside the tensor are
// written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, const void* src, int c0,
                                             int c1, int c2) {
  asm volatile("cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
               :: "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(src)), "r"(c0), "r"(c1),
                  "r"(c2)
               : "memory");
}
// Wait until this thread's bulk copies have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Wait until this thread's bulk copies have completed.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma shared-memory descriptor of a tile stored as 128-byte swizzled rows
// (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address,
// leading and stride byte offsets (16-byte units), layout type 1 = 128B.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, int lbo, int sbo) {
  return (uint64_t)((smem_addr(smem) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching an accumulator that a wgmma in flight
// still writes before wgmma_wait.
template <int J>
__device__ __forceinline__ void reg_fence(float (&d)[J][4]) {
#pragma unroll
  for (int j = 0; j < J; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e]) :: "memory");
}

#define WG_D8(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_D64(j) WG_D8(j), WG_D8(j + 1), WG_D8(j + 2), WG_D8(j + 3), WG_D8(j + 4), \
                  WG_D8(j + 5), WG_D8(j + 6), WG_D8(j + 7)
#define WG_R128 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, " \
  "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, " \
  "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, " \
  "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, " \
  "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}"

// d (+)= A . B, m64n256k16 from shared memory: A K-major (TransA 0) or
// M-major (TransA 1, the transpose bit), B N-major (TransB 1) or K-major
// (TransB 0); `accumulate` 0 overwrites d.
template <int TransA, int TransB>
__device__ __forceinline__ void wgmma_n256(float (&d)[32][4], uint64_t a, uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 " WG_R128
      ", %128, %129, p, 1, 1, %131, %132;\n}\n"
      : WG_D64(0), WG_D64(8), WG_D64(16), WG_D64(24)
      : "l"(a), "l"(b), "r"(accumulate), "n"(TransA), "n"(TransB));
}

#define WG_R64 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, " \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, " \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A . B, m64n128k8 in TF32: A from registers (the m16n8k8 A
// fragment of the warp's 16 rows: (row g, k c), (g + 8, c), (g, c + 4),
// (g + 8, c + 4)), B K-major from shared memory (tf32 wgmma takes no
// transpose); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_n128(float (&d)[16][4], const uint32_t (&a)[4],
                                                uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D64(0), WG_D64(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// Grid: one block an SM (or one a tile where there are fewer). Warpgroup 0
// is the producer (warp 0's lane 0 issues every load; warps 1-3 leave at
// once); warpgroups 1 and 2 are the consumers, rows 0-63 and 64-127 of
// each tile. Every warp finds each tile itself (find_tile), so the roles
// share nothing but the ring: the same walk, the same tiles skipped.
// BKMajor: w is [E, N, K] and the product is x . w[g]^T (the backward's
// dgrad on the forward's weights as they lie): each B box is 64 columns x
// 64 k, 128-byte swizzled rows of k as A's, read by wgmma K-major.
template <bool BKMajor>
__global__ void __launch_bounds__(TMA_THREADS, 1)
    grouped_mm_tma_kernel(const __grid_constant__ Params p, const __grid_constant__ CUtensorMap tm_x,
                          const __grid_constant__ CUtensorMap tm_w, int col_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned destinations.
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* staged = ring + TMA_STAGES * TMA_STAGE;  // [BM][TMA_OUT_PITCH]
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + TMA_OUT_BYTES);
  uint64_t* empty = full + TMA_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int steps = (p.K + TMA_BK - 1) / TMA_BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp != 0) return;
    if (lane == 0) {
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_w)) : "memory");
    }
    int it = 0;  // K steps loaded so far (lane 0)
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      const Tile tile = find_tile(p, t / col_tiles);
      if (tile.group == -2) break;  // the busy slots come first: the rest are idle
      if (tile.group < 0) continue;
      if (lane == 0) {
        const int col0 = (t % col_tiles) * TMA_BN;
        const int boxes = min(4, (p.N - col0 + 63) / 64);
        for (int ks = 0; ks < steps; ++ks, ++it) {
          const int stage = it % TMA_STAGES;
          if (it >= TMA_STAGES) mbar_wait(&empty[stage], ((it / TMA_STAGES) & 1) ^ 1);
          unsigned char* a_s = ring + stage * TMA_STAGE;
          mbar_expect_tx(&full[stage], TMA_A_BYTES + boxes * TMA_B_BOX);
          tma_load_2d(a_s, &tm_x, &full[stage], ks * TMA_BK, tile.row0);
          for (int j = 0; j < boxes; ++j) {
            unsigned char* b_box = a_s + TMA_A_BYTES + j * TMA_B_BOX;
            if (BKMajor)
              tma_load_3d(b_box, &tm_w, &full[stage], ks * TMA_BK, col0 + 64 * j, tile.group);
            else
              tma_load_3d(b_box, &tm_w, &full[stage], col0 + 64 * j, ks * TMA_BK, tile.group);
          }
        }
      }
      __syncwarp();
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warp / 4 - 1;  // rows 64 wg .. 64 wg + 63 of each tile
  const int g = lane / 4, c = lane % 4;
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  float d[32][4];
  int it = 0;  // K steps consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const Tile tile = find_tile(p, t / col_tiles);
    if (tile.group == -2) break;
    const int col0 = (t % col_tiles) * TMA_BN;
    const int r_lo = tile.row0 + 64 * wg, r_hi = min(r_lo + 64, tile.row_end);
    if (tile.group < 0) {
      // Zeros: this warpgroup's rows of the tile, 16 bytes a store.
      const int chunks = min(TMA_BN, p.N - col0) / 8;
      for (int u = threadIdx.x % 128; u < (r_hi - r_lo) * chunks; u += 128)
        *reinterpret_cast<uint4*>(y + (size_t)(r_lo + u / chunks) * p.N + col0 + 8 * (u % chunks)) =
            make_uint4(0, 0, 0, 0);
      continue;
    }
    int prev = 0;
    for (int ks = 0; ks < steps; ++ks, ++it) {
      const int stage = it % TMA_STAGES;
      mbar_wait(&full[stage], (it / TMA_STAGES) & 1);
      const unsigned char* a_s = ring + stage * TMA_STAGE + wg * (64 * 128);
      const unsigned char* b_s = ring + stage * TMA_STAGE + TMA_A_BYTES;
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk) {
        // k16 step kk: 32 bytes into A's 128-byte rows; 16 k rows of B's
        // boxes (1024 bytes an 8-row group, 8 KB from one 64-column box to
        // the next), or with BKMajor 32 bytes into B's 128-byte column rows
        // (8-row groups 1024 bytes apart, the boxes back to back).
        const uint64_t a_desc = sw128_desc(a_s + 32 * kk, 16, 1024);
        if (BKMajor)
          wgmma_n256<0, 0>(d, a_desc, sw128_desc(b_s + 32 * kk, 16, 1024), ks > 0 || kk > 0);
        else
          wgmma_n256<0, 1>(d, a_desc, sw128_desc(b_s + 2048 * kk, TMA_B_BOX, 1024),
                           ks > 0 || kk > 0);
      }
      wgmma_commit();
      if (ks > 0) {
        // The step before is done: release its stage.
        wgmma_wait<1>();
        reg_fence(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    wgmma_wait<0>();
    reg_fence(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // The warp's 16 rows of the tile go to shared memory (accumulator of n8
    // tile j: row g, columns 8j + 2c, 8j + 2c + 1, then row g + 8), then
    // lane l < 16 copies row l, if it is the group's, to y by the bulk-copy
    // engine, which runs on while the warp goes on to the next tile. So only
    // the group's rows are written, a row's bytes at a time.
    unsigned char* rows = staged + (64 * wg + 16 * (warp % 4)) * TMA_OUT_PITCH;
    if (lane < 16) bulk_wait_read();  // the last tile's copies are done with these rows
    __syncwarp();
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<__nv_bfloat162*>(rows + (g + 8 * h) * TMA_OUT_PITCH + 2 * (8 * j + 2 * c)) =
            __floats2bfloat162_rn(d[j][2 * h], d[j][2 * h + 1]);
    fence_proxy_async();
    __syncwarp();
    const int r = r_lo + 16 * (warp % 4) + lane;
    if (lane < 16 && r < r_hi) {
      bulk_store(y + (size_t)r * p.N + col0, rows + lane * TMA_OUT_PITCH, 2 * min(TMA_BN, p.N - col0));
      bulk_commit();
    }
  }
  if (lane < 16) bulk_wait();  // no copy outlives the block's shared memory
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on the tensor cores (mma.sync.m16n8k8)
// ---------------------------------------------------------------------------

// x = big + small, each a TF32 value rounded as cvt.rna.tf32.f32 rounds
// (to nearest, ties away from zero: add half of the 13 dropped bits' range
// to the magnitude, then drop them), with |x - big - small| <= 2^-22 |x|.
// small's 13 low bits are left in place: the tensor core ignores them.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += A . B, m16n8k8, TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[n] += A . B[n] for N n8 tiles as 3xTF32: the two cross terms, then
// big . big (the order of CUTLASS's OpMultiplyAddFastF32); small . small
// (below 2^-22 of the product) is dropped. bb[n] and bs[n] are B[n]'s
// fragment, split.
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4], const uint32_t (&a_big)[4],
                                           const uint32_t (&a_small)[4],
                                           const uint32_t (&bb)[N][2],
                                           const uint32_t (&bs)[N][2]) {
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_small, bb[n][0], bb[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_big, bs[n][0], bs[n][1]);
#pragma unroll
  for (int n = 0; n < N; ++n) mma_tf32(d[n], a_big, bb[n][0], bb[n][1]);
}

// m16n8k8 fragments (lane = 4g + c): A holds (row g, k c), (g + 8, c),
// (g, c + 4), (g + 8, c + 4); B holds (k c, column g), (c + 4, g); the
// accumulator (g, 2c), (g, 2c + 1), (g + 8, 2c), (g + 8, 2c + 1). Logical
// k c and c + 4 of k8 step j are physical k 8j + 2c and 8j + 2c + 1 of
// the stage, in A and B alike; logical column g of n8 tile nt is physical
// column 4g + nt of the warp's 32. So a thread reads A as float2 pairs,
// B as float4 quads, and holds 8 adjacent output columns of each row.
template <bool Vec>
__global__ void __launch_bounds__(THREADS, 1) grouped_mm_f32_kernel(const __grid_constant__ Params p) {
  Tile tile;
  if (!block_tile<float>(p, tile)) return;
  extern __shared__ __align__(16) float fsm[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int col0 = blockIdx.x * BN;
  const int K = p.K, N = p.N;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w) + (size_t)tile.group * K * N;
  const int steps = (K + F_BK - 1) / F_BK;

  // Stage `slot` <- K step `kt`: A [BM][F_BK] at pitch F_AP (zeros past the
  // group's end and past K), B [F_BK][BN] at pitch F_BP (zeros past K and
  // N). Vec: a thread's four 16-byte chunks of each (K and N multiples of
  // 4, so a chunk is wholly in or out); else 4-byte copies.
  auto load = [&](int slot, int kt) {
    float* a_s = fsm + slot * F_STAGE_FLOATS;
    float* b_s = a_s + F_A_FLOATS;
    const int k0 = kt * F_BK;
    if (Vec) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = t + i * THREADS, row = u / 8, k = k0 + 4 * (u % 8), r = tile.row0 + row;
        const bool in = r < tile.row_end && k < K;
        cp_async16(a_s + row * F_AP + 4 * (u % 8), in ? x + (size_t)r * K + k : x, in ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int u = t + i * THREADS, kr = u / 32, n = col0 + 4 * (u % 32), k = k0 + kr;
        const bool in = k < K && n < N;
        cp_async16(b_s + kr * F_BP + 4 * (u % 32), in ? w + (size_t)k * N + n : w, in ? 16 : 0);
      }
    } else {
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int u = t + i * THREADS, row = u / F_BK, k = k0 + u % F_BK, r = tile.row0 + row;
        const bool in = r < tile.row_end && k < K;
        cp_async4(a_s + row * F_AP + u % F_BK, in ? x + (size_t)r * K + k : x, in ? 4 : 0);
      }
#pragma unroll 4
      for (int i = 0; i < 16; ++i) {
        const int u = t + i * THREADS, kr = u / BN, n = col0 + u % BN, k = k0 + kr;
        const bool in = k < K && n < N;
        cp_async4(b_s + kr * F_BP + u % BN, in ? w + (size_t)k * N + n : w, in ? 4 : 0);
      }
    }
  };

  // Warp (wm, wn) owns rows 64 wm .. + 63 and columns 32 wn .. + 31 of the
  // tile: 4 m16 tiles by 4 n8 tiles. Steps kt + 1 .. kt + F_STAGES - 1 load
  // while step kt computes.
  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = lane % 4;
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < F_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<F_STAGES - 2>();
    __syncthreads();  // step kt landed; every warp is done with step kt - 1
    if (kt + F_STAGES - 1 < steps) load((kt + F_STAGES - 1) % F_STAGES, kt + F_STAGES - 1);
    cp_async_commit();
    const float* a_s = fsm + (kt % F_STAGES) * F_STAGE_FLOATS;
    const float* b_s = a_s + F_A_FLOATS;

    // The step's sums start from zero and are then added to acc in f32
    // (rounded to nearest). The tensor core's own f32 adds truncate; over
    // one chain of 3K/8 of them into acc the bias would grow past the f32
    // tolerance at the prefill's K = 4096.
    float part[4][4][4] = {};
#pragma unroll
    for (int j = 0; j < F_BK / 8; ++j) {
      const int b_at = (8 * j + 2 * c) * F_BP + 32 * wn + 4 * g;
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + b_at);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + b_at + F_BP);
      const float b[4][2] = {{b0.x, b1.x}, {b0.y, b1.y}, {b0.z, b1.z}, {b0.w, b1.w}};
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) split_tf32(b[nt][e], bb[nt][e], bs[nt][e]);
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const int a_at = (64 * wm + 16 * mt + g) * F_AP + 8 * j + 2 * c;
        const float2 lo = *reinterpret_cast<const float2*>(a_s + a_at);
        const float2 hi = *reinterpret_cast<const float2*>(a_s + a_at + 8 * F_AP);
        const float a[4] = {lo.x, hi.x, lo.y, hi.y};
        uint32_t a_big[4], a_small[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) split_tf32(a[e], a_big[e], a_small[e]);
        mma_3xtf32<4>(part[mt], a_big, a_small, bb, bs);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
  }

  // Row r of m16 tile mt: columns 32 wn + 8c + nt from acc[mt][nt][e] (e
  // = 0 or 2) and 32 wn + 8c + 4 + nt from e = 1 or 3.
  float* y = static_cast<float*>(p.y);
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile.row0 + 64 * wm + 16 * mt + g + 8 * h;
      if (r >= tile.row_end) continue;
      const int n = col0 + 32 * wn + 8 * c;
      const float v[8] = {acc[mt][0][2 * h],     acc[mt][1][2 * h],     acc[mt][2][2 * h],
                          acc[mt][3][2 * h],     acc[mt][0][2 * h + 1], acc[mt][1][2 * h + 1],
                          acc[mt][2][2 * h + 1], acc[mt][3][2 * h + 1]};
      float* out = y + (size_t)r * N + n;
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        if (Vec && n + 4 * q + 3 < N) {
          *reinterpret_cast<float4*>(out + 4 * q) =
              make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (n + 4 * q + e < N) out[4 * q + e] = v[4 * q + e];
        }
      }
    }
}

// ---------------------------------------------------------------------------
// wgrad: dw[e] = xs[seg_e]^T . dy[seg_e], ragged on the contraction
// ---------------------------------------------------------------------------

struct WgradParams {
  const void* x;     // [M, K] in T, rows sorted by expert
  const void* dy;    // [M, N] in T
  void* dw;          // [E, K, N] in T
  const int* sizes;  // [E] int32
  int M, K, N, E;
};

// Expert e's rows [start, end): the rows of the groups before it, clamped
// to M (every thread sums the few sizes itself).
__device__ __forceinline__ void segment(const WgradParams& p, int e, int& start, int& end) {
  long long before = 0;
  for (int i = 0; i < e; ++i) before += max(p.sizes[i], 0);
  start = (int)min(before, (long long)p.M);
  end = (int)min(before + max(p.sizes[e], 0), (long long)p.M);
}

// Zeros into the block's tile of dw[e] (an empty group's gradient).
template <typename T>
__device__ void zero_tile(const WgradParams& p, T* dw, int k0, int n0) {
  const int rows = min(BN, p.K - k0), cols = min(BN, p.N - n0);
  for (int u = threadIdx.x; u < rows * cols; u += THREADS)
    dw[(size_t)(k0 + u / cols) * p.N + n0 + u % cols] = static_cast<T>(0.f);
}

// 8 bf16 values of row r, columns c.. of a [*, width] matrix into shared
// memory, read element by element: zeros where the row is not live or
// past width.
__device__ __forceinline__ void load8(unsigned char* dst, const __nv_bfloat16* src, int r, int c,
                                      int width, bool live) {
  __align__(16) __nv_bfloat16 v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    v[j] = live && c + j < width ? src[(size_t)r * width + c + j] : __float2bfloat16_rn(0.f);
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(v);
}

// bf16 operands TMA cannot take. Grid: (column tiles of N, row tiles of
// K, experts). Each stage holds 64 rows of xs (columns k0..) and of dy
// (columns n0..) as 256-byte swizzled rows (b_off), read element by
// element. Warp (wm, wn) owns rows 64 wm .. + 63 of the K tile and
// columns 32 wn .. + 31 of the N tile.
__global__ void __launch_bounds__(THREADS, 1)
    grouped_wgrad_bf16_kernel(const __grid_constant__ WgradParams p) {
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BN, e = blockIdx.z;
  int start, end;
  segment(p, e, start, end);
  __nv_bfloat16* dw = static_cast<__nv_bfloat16*>(p.dw) + (size_t)e * p.K * p.N;
  if (start >= end) {
    zero_tile(p, dw, k0, n0);
    return;
  }
  extern __shared__ __align__(128) unsigned char smem[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* dy = static_cast<const __nv_bfloat16*>(p.dy);
  const int steps = (end - start + W_BR - 1) / W_BR;

  auto load = [&](int slot, int s) {
    unsigned char* x_s = smem + slot * W_STAGE;
    unsigned char* d_s = x_s + W_STAGE / 2;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * THREADS, row = u / 16, ch = u % 16, r = start + s * W_BR + row;
      load8(x_s + b_off(row, ch), x, r, k0 + 8 * ch, p.K, r < end);
      load8(d_s + b_off(row, ch), dy, r, n0 + 8 * ch, p.N, r < end);
    }
  };

  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < W_STAGES - 1; ++s)
    if (s < steps) load(s, s);
  for (int s = 0; s < steps; ++s) {
    __syncthreads();  // step s is in place; the slot of step s - 1 is free
    if (s + W_STAGES - 1 < steps) load((s + W_STAGES - 1) % W_STAGES, s + W_STAGES - 1);
    const unsigned char* x_s = smem + (s % W_STAGES) * W_STAGE;
    const unsigned char* d_s = x_s + W_STAGE / 2;
#pragma unroll
    for (int k16 = 0; k16 < W_BR / 16; ++k16) {
      // B = dy, as the forward kernel reads w.
      unsigned b[4][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        unsigned r[4];
        ldmatrix_x4_trans(r, d_s + b_off(16 * k16 + lane % 16, 4 * wn + 2 * j + lane / 16));
        b[2 * j][0] = r[0], b[2 * j][1] = r[1], b[2 * j + 1][0] = r[2], b[2 * j + 1][1] = r[3];
      }
      // A = xs^T through ldmatrix.trans, an m16 tile at a time (fewer live
      // registers): matrix q = lane / 8 is stored rows 16 k16 + 8 (q / 2)
      // .. + 7 (the contraction) at the 8 columns of output rows 8 (q % 2)
      // .. of the m16 tile, so a lane gets a0..a3 as (row g, k 2c..), (g +
      // 8, 2c..), (g, 2c + 8..), (g + 8, 2c + 8..).
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        unsigned a[4];
        ldmatrix_x4_trans(a, x_s + b_off(16 * k16 + lane % 8 + 8 * (lane / 16),
                                         8 * wm + 2 * mt + (lane / 8) % 2));
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_bf16(acc[mt][nt], a, b[nt][0], b[nt][1]);
      }
    }
  }

  // D fragment: d0, d1 row g, columns 2c, 2c + 1; d2, d3 row g + 8.
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * wm + 16 * mt + g + 8 * h;
      if (k >= p.K) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wn + 8 * nt + 2 * c;
        __nv_bfloat16* out = dw + (size_t)k * p.N + n;
        if (n < p.N) out[0] = __float2bfloat16_rn(acc[mt][nt][2 * h]);
        if (n + 1 < p.N) out[1] = __float2bfloat16_rn(acc[mt][nt][2 * h + 1]);
      }
    }
}

// bf16 where TMA takes the operands (K and N multiples of 8, 16-byte
// aligned bases): persistent, one block an SM walking the tiles (expert,
// 128-row tile of K, 256-column tile of N), N tiles fastest, so the blocks
// in flight share an expert's rows in L2; a producer warpgroup and two
// consumer warpgroups as the forward's TMA kernel, the ring running on
// across tiles. Warp 0's lane 0 loads each step of 64 segment rows: xs's
// columns k0.. as two boxes of 64 rows x 64 columns and dy's columns n0..
// as four, 128-byte swizzled (boxes wholly past K or N are not loaded:
// their outputs are not stored). Consumer warpgroup wg owns rows 64 wg ..
// + 63 of the K tile: wgmma m64n256k16 reads A = xs^T from its xs box
// M-major (the transpose bit) and B = dy N-major, as the forward reads w.
// Rows of a step past the segment (the next group's, or TMA's zeros past
// M) are zeroed in the xs box by the warpgroup before its products, so
// they add nothing. A tile's outputs go to shared memory as four TMA
// store boxes a warpgroup (64 rows x 64 columns, 128-byte swizzled), and
// one thread of the warpgroup stores them to dw by TMA through a 3-D map
// over [E, K, N] (the expert a coordinate, so a K tile past K is clipped
// at its own expert's K; each dw tile is one block's alone, so whole
// boxes are right), which runs on while the warpgroup starts the next
// tile; the thread waits for its stores to have read the staging only
// before the next tile's outputs overwrite it. On an H100 the stores
// straight from the accumulators (4 bytes a thread, the tensor cores
// idle meanwhile, every block's epilogue at once) cost about 5 us a tile
// change at the MoE flagship's products, the staged ones under 1 us
// (`chip_smoke.py` phase 13). An empty expert's tiles are stored as
// zeros, 16 bytes a store.
__device__ __forceinline__ void wgrad_tile(int t, int k_tiles, int n_tiles, int tile_n, int& e,
                                           int& k0, int& n0) {
  e = t / (k_tiles * n_tiles);
  k0 = (t / n_tiles) % k_tiles * BM;
  n0 = t % n_tiles * tile_n;
}

__global__ void __launch_bounds__(TMA_THREADS, 1)
    grouped_wgrad_tma_kernel(const __grid_constant__ WgradParams p,
                             const __grid_constant__ CUtensorMap tm_x,
                             const __grid_constant__ CUtensorMap tm_dy,
                             const __grid_constant__ CUtensorMap tm_dw, int k_tiles, int n_tiles,
                             int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* staged = ring + TMA_STAGES * TMA_STAGE;  // [2][4 boxes][64 rows][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(staged + TMA_OUT_BYTES);
  uint64_t* empty = full + TMA_STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < TMA_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp != 0 || lane != 0) return;
    int it = 0;  // steps loaded so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, k0, n0, start, end;
      wgrad_tile(t, k_tiles, n_tiles, TMA_BN, e, k0, n0);
      segment(p, e, start, end);
      const int x_boxes = min(2, (p.K - k0 + 63) / 64), d_boxes = min(4, (p.N - n0 + 63) / 64);
      for (int row = start; row < end; row += TMA_BK, ++it) {
        const int stage = it % TMA_STAGES;
        if (it >= TMA_STAGES) mbar_wait(&empty[stage], ((it / TMA_STAGES) & 1) ^ 1);
        unsigned char* x_s = ring + stage * TMA_STAGE;
        mbar_expect_tx(&full[stage], (x_boxes + d_boxes) * TMA_B_BOX);
        for (int j = 0; j < x_boxes; ++j)
          tma_load_2d(x_s + j * TMA_B_BOX, &tm_x, &full[stage], k0 + 64 * j, row);
        for (int j = 0; j < d_boxes; ++j)
          tma_load_2d(x_s + TMA_A_BYTES + j * TMA_B_BOX, &tm_dy, &full[stage], n0 + 64 * j, row);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warp / 4 - 1, t128 = threadIdx.x % 128, g = lane / 4, c = lane % 4;
  __nv_bfloat16* dw_all = static_cast<__nv_bfloat16*>(p.dw);
  unsigned char* out = staged + wg * (4 * TMA_B_BOX);  // this warpgroup's four boxes
  if (t128 == 0)
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_dw)) : "memory");
  float d[32][4];
  int it = 0;  // steps consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int e, k0, n0, start, end;
    wgrad_tile(t, k_tiles, n_tiles, TMA_BN, e, k0, n0);
    segment(p, e, start, end);
    __nv_bfloat16* dw = dw_all + (size_t)e * p.K * p.N;
    if (start >= end) {
      // Zeros: this warpgroup's rows of the tile, 16 bytes a store.
      const int rows = max(0, min(64, p.K - k0 - 64 * wg)), chunks = min(TMA_BN, p.N - n0) / 8;
      for (int u = t128; u < rows * chunks; u += 128)
        *reinterpret_cast<uint4*>(dw + (size_t)(k0 + 64 * wg + u / chunks) * p.N + n0 +
                                  8 * (u % chunks)) = make_uint4(0, 0, 0, 0);
      continue;
    }
    int prev = 0;
    for (int row = start; row < end; row += TMA_BK, ++it) {
      const int stage = it % TMA_STAGES;
      mbar_wait(&full[stage], (it / TMA_STAGES) & 1);
      unsigned char* x_box = ring + stage * TMA_STAGE + wg * TMA_B_BOX;
      const unsigned char* d_s = ring + stage * TMA_STAGE + TMA_A_BYTES;
      const int live = end - row;  // rows of the step in the segment
      if (live < TMA_BK) {
        // A row of the box is 128 bytes whatever the swizzle: zero the rows
        // past the segment, then hand them to the async proxy.
        for (int u = t128; u < (TMA_BK - live) * 8; u += 128)
          *reinterpret_cast<uint4*>(x_box + (live + u / 8) * 128 + 16 * (u % 8)) =
              make_uint4(0, 0, 0, 0);
        fence_proxy_async();
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
      reg_fence(d);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TMA_BK / 16; ++kk)
        // k16 step kk: 16 rows of each box (1024 bytes an 8-row group); A's
        // 64 columns are one box, B's 256 four boxes 8 KB apart.
        wgmma_n256<1, 1>(d, sw128_desc(x_box + 2048 * kk, TMA_B_BOX, 1024),
                         sw128_desc(d_s + 2048 * kk, TMA_B_BOX, 1024), row > start || kk > 0);
      wgmma_commit();
      if (row > start) {
        // The step before is done: release its stage.
        wgmma_wait<1>();
        reg_fence(d);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      prev = stage;
    }
    wgmma_wait<0>();
    reg_fence(d);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[prev]);

    // Accumulator of n8 tile j: row r = g (then g + 8) of the warp's 16,
    // columns 8j + 2c and + 1: box j / 8, bytes 16 (j % 8) + 4c of its
    // 128-byte row r, whose 16-byte chunk the swizzle moves to j % 8 ^ g
    // (r % 8 = g): across a warp, 32 distinct banks. Thread 0 of the
    // warpgroup first waits until its stores of the last tile have read
    // the boxes, then, once every thread's writes are fenced for the async
    // proxy, stores the boxes inside K and N.
    if (t128 == 0) bulk_wait_read();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned char* row = out + (16 * (warp % 4) + g + 8 * h) * 128 + 4 * c;
#pragma unroll
      for (int j = 0; j < 32; ++j)
        *reinterpret_cast<__nv_bfloat162*>(row + (j / 8) * TMA_B_BOX + 16 * ((j % 8) ^ g)) =
            __floats2bfloat162_rn(d[j][2 * h], d[j][2 * h + 1]);
    }
    fence_proxy_async();
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    if (t128 == 0 && k0 + 64 * wg < p.K) {
      for (int b = 0; b < 4 && n0 + 64 * b < p.N; ++b)
        tma_store_3d(&tm_dw, out + b * TMA_B_BOX, n0 + 64 * b, k0 + 64 * wg, e);
      bulk_commit();
    }
  }
  if (t128 == 0) bulk_wait_read();  // no store outlives the block's shared memory
}

// f32 operands TMA cannot take (K or N not a multiple of 4, or a base not
// 16-byte aligned). Grid as the bf16 fallback's. Each stage holds 32 rows
// of xs (columns k0..) and of dy (columns n0..) at pitch WF_P, copied 4
// bytes at a time. In the m16n8k8 fragments A(i, k) = xs[k][i] and B(k,
// n) = dy[k][n], k the step's row: a lane reads A as (k c, row g), (c, g
// + 8), (c + 4, g), (c + 4, g + 8) and B as (k c, column g), (c + 4, g),
// each a word of a row 8 mod 32 words from the last.
__global__ void __launch_bounds__(THREADS, 1)
    grouped_wgrad_f32_kernel(const __grid_constant__ WgradParams p) {
  const int n0 = blockIdx.x * BN, k0 = blockIdx.y * BN, e = blockIdx.z;
  int start, end;
  segment(p, e, start, end);
  float* dw = static_cast<float*>(p.dw) + (size_t)e * p.K * p.N;
  if (start >= end) {
    zero_tile(p, dw, k0, n0);
    return;
  }
  extern __shared__ __align__(16) float wsm[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const float* x = static_cast<const float*>(p.x);
  const float* dy = static_cast<const float*>(p.dy);
  const int K = p.K, N = p.N;
  const int steps = (end - start + WF_BR - 1) / WF_BR;

  // Zeros outside the segment and past K or N.
  auto load = [&](int slot, int s) {
    float* x_s = wsm + slot * WF_STAGE_FLOATS;
    float* d_s = x_s + WF_BR * WF_P;
#pragma unroll 4
    for (int i = 0; i < 16; ++i) {
      const int u = t + i * THREADS, row = u / BN, q = u % BN, r = start + s * WF_BR + row;
      const bool in_x = r < end && k0 + q < K, in_d = r < end && n0 + q < N;
      cp_async4(x_s + row * WF_P + q, in_x ? x + (size_t)r * K + k0 + q : x, in_x ? 4 : 0);
      cp_async4(d_s + row * WF_P + q, in_d ? dy + (size_t)r * N + n0 + q : dy, in_d ? 4 : 0);
    }
  };

  const int wm = warp / 4, wn = warp % 4, g = lane / 4, c = lane % 4;
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < WF_STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<WF_STAGES - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + WF_STAGES - 1 < steps) load((s + WF_STAGES - 1) % WF_STAGES, s + WF_STAGES - 1);
    cp_async_commit();
    const float* x_s = wsm + (s % WF_STAGES) * WF_STAGE_FLOATS;
    const float* d_s = x_s + WF_BR * WF_P;

    // The step's sums start from zero and are then added to acc in f32
    // (rounded to nearest): the tensor core's own adds truncate.
    float part[4][4][4] = {};
#pragma unroll
    for (int j = 0; j < WF_BR / 8; ++j) {
      const float* x0 = x_s + (8 * j + c) * WF_P + 64 * wm + g;
      const float* d0 = d_s + (8 * j + c) * WF_P + 32 * wn + g;
      uint32_t bb[4][2], bs[4][2];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        split_tf32(d0[8 * nt], bb[nt][0], bs[nt][0]);
        split_tf32(d0[4 * WF_P + 8 * nt], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const float a[4] = {x0[16 * mt], x0[16 * mt + 8], x0[4 * WF_P + 16 * mt],
                            x0[4 * WF_P + 16 * mt + 8]};
        uint32_t a_big[4], a_small[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) split_tf32(a[q], a_big[q], a_small[q]);
        mma_3xtf32<4>(part[mt], a_big, a_small, bb, bs);
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[mt][nt][q] += part[mt][nt][q];
  }

  // Accumulator of (m16 tile mt, n8 tile nt): row g, columns 2c, 2c + 1,
  // then row g + 8.
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * wm + 16 * mt + g + 8 * h;
      if (k >= K) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = n0 + 32 * wn + 8 * nt + 2 * c;
        float* out = dw + (size_t)k * N + n;
        if (n < N) out[0] = acc[mt][nt][2 * h];
        if (n + 1 < N) out[1] = acc[mt][nt][2 * h + 1];
      }
    }
}

// f32 where TMA takes the operands (K and N multiples of 4, 16-byte
// aligned bases): 3xTF32 on tf32 wgmma, persistent, one block an SM
// walking the tiles (expert, 128-row K tile, 128-column N tile), N tiles
// fastest, as the bf16 TMA kernel. Bound: operations (three TF32 products
// at 495 TFLOP/s); shared memory comes close behind: about 190 KB a
// 32-row step of a tile (wgmma's B reads 96 KB, TMA's writes 32 KB, the
// transform 48 KB, the A loads 16 KB) against the SM's 128 bytes a clock.
//
// tf32 wgmma reads its shared-memory operands K-major only, and here the
// contraction runs over the rows, which both xs and dy hold outermost. So:
// - warp 0's lane 0 loads each step of 32 segment rows by TMA into a ring
//   of four 32 KB stages: xs's columns k0.. and dy's columns n0.. as four
//   boxes each of 32 rows x 32 f32 (128-byte swizzled rows; boxes wholly
//   past K or N are not loaded: their outputs are not stored). The
//   producer warpgroup's other warps leave at once.
// - B = dy is made K-major by the consumers themselves, a step ahead: while
//   step s's wgmmas run, each of the 8 consumer warps splits its share of
//   step s + 1's dy into big and small TF32 (split_tf32) and writes them
//   into B buffer (s + 1) % 2 as two K-major tiles [128 columns][32 rows]
//   in the 128-byte swizzle wgmma reads, rows past the segment as zeros,
//   then fences them for the async proxy and arrives on the buffer's full
//   barrier; a buffer is rewritten once both warpgroups' products of two
//   steps before have read it (its empty barrier). Warp cw's share is
//   chunk cw (k positions 4 cw .. + 3) of every column's 128-byte row:
//   lane l reads 4 rows of column 32 box + l of each box (whole 128-byte
//   rows across the warp) and writes one 16-byte chunk of big and one of
//   small (8 lanes: 8 rows of one 8-row group at 8 distinct chunks). On an
//   H100 the producer warpgroup's three idle warps could not keep up with
//   the products as the transform; the consumers' warps overlap it with
//   their wgmmas.
// - consumer warpgroup wg owns rows 64 wg .. + 63 of the K tile. Its A =
//   xs^T comes from registers (the RS form): lane (g, c) of warp w holds
//   tile columns 64 wg + 16 w + 2g and + 1 of xs as its rows g and g + 8
//   (a float2 a read), and of k8 step j the rows 8j + 2c (its k c) and 8j
//   + 2c + 1 (its k c + 4); the transform writes B's k positions in the
//   same order (chunk 2j: rows 8j, 8j + 2, 8j + 4, 8j + 6; chunk 2j + 1:
//   the odd ones). Rows past the segment are zeroed in registers, so with
//   B's zeros no non-finite value of a neighbouring group's row meets a 0.
//   The reads are free of bank conflicts (rows 8j + 2c put each half-warp
//   on 8 distinct chunks). It loads and splits the next step's A while
//   this step's products run (then releases that raw stage), and issues
//   wgmma m64n128k8 three times a k8 (small . big, big . small, big . big,
//   as mma_3xtf32), B's descriptor 32 bytes further a k8.
// The tensor core's f32 adds truncate: each promotion interval's sums
// (WT_PROMOTE rows) start from zero and are added to totals in registers
// in f32, rounded to nearest. The totals go straight to dw, a float2 a
// store, rows k0 + 64 wg + 16 w + 2g (+ 1): a 128 x 128 tile's 64 KB
// against ~50 us of products. An empty expert's tiles are stored as zeros.
// Each output's sums run in one fixed order: two launches give the same
// bits.
__global__ void __launch_bounds__(TMA_THREADS, 1)
    grouped_wgrad_f32_tma_kernel(const __grid_constant__ WgradParams p,
                                 const __grid_constant__ CUtensorMap tm_x,
                                 const __grid_constant__ CUtensorMap tm_dy, int k_tiles,
                                 int n_tiles, int tiles) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* b_bufs = ring + WT_STAGES * WT_STAGE;  // [2][big, small][128 columns][128 bytes]
  uint64_t* full = reinterpret_cast<uint64_t*>(b_bufs + 2 * WT_B_BUF);
  uint64_t* empty = full + WT_STAGES;
  uint64_t* b_full = empty + WT_STAGES;
  uint64_t* b_empty = b_full + 2;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < WT_STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMER_WARPS);
    }
    for (int b = 0; b < 2; ++b) {
      mbar_init(&b_full[b], CONSUMER_WARPS);
      mbar_init(&b_empty[b], CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(PRODUCER_REGS));
    if (warp != 0 || lane != 0) return;
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_x)) : "memory");
    asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(&tm_dy)) : "memory");
    int it = 0;  // steps loaded so far
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      int e, k0, n0, start, end;
      wgrad_tile(t, k_tiles, n_tiles, WT_BN, e, k0, n0);
      segment(p, e, start, end);
      const int x_boxes = min(4, (p.K - k0 + 31) / 32), d_boxes = min(4, (p.N - n0 + 31) / 32);
      for (int row = start; row < end; row += WT_BR, ++it) {
        const int stage = it % WT_STAGES;
        if (it >= WT_STAGES) mbar_wait(&empty[stage], ((it / WT_STAGES) & 1) ^ 1);
        unsigned char* x_s = ring + stage * WT_STAGE;
        mbar_expect_tx(&full[stage], (x_boxes + d_boxes) * WT_BOX);
        for (int j = 0; j < x_boxes; ++j)
          tma_load_2d(x_s + j * WT_BOX, &tm_x, &full[stage], k0 + 32 * j, row);
        for (int j = 0; j < d_boxes; ++j)
          tma_load_2d(x_s + (4 + j) * WT_BOX, &tm_dy, &full[stage], n0 + 32 * j, row);
      }
    }
    return;
  }

  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(CONSUMER_REGS));
  const int wg = warp / 4 - 1, w = warp % 4, t128 = threadIdx.x % 128, g = lane / 4, c = lane % 4;
  // This lane's xs columns 64 wg + 16 w + 2g and + 1: box 2 wg + w / 2,
  // chunk 4 (w % 2) + g / 2 of its 128-byte rows, bytes 8 (g % 2) in it.
  const int a_box = 2 * wg + w / 2, a_chunk = 4 * (w % 2) + g / 2, a_byte = 8 * (g % 2);
  // The transform's share of consumer warp cw: chunk cw of every column's
  // 128-byte row of B (k positions 4 cw .. + 3: the step's rows t_row0 +
  // 2i), column 32 box + lane of each of dy's four boxes.
  const int cw = warp - 4, t_row0 = 8 * (cw / 2) + cw % 2;
  int t_read[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = t_row0 + 2 * i;
    t_read[i] = r * 128 + 16 * ((lane / 4) ^ (r % 8)) + 4 * (lane % 4);
  }
  const int t_write = (lane / 8) * 1024 + (lane % 8) * 128 + 16 * (cw ^ (lane % 8));
  float* dw_all = static_cast<float*>(p.dw);
  float part[16][4], total[16][4];
  int it = 0;  // steps consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    int e, k0, n0, start, end;
    wgrad_tile(t, k_tiles, n_tiles, WT_BN, e, k0, n0);
    segment(p, e, start, end);
    float* dw = dw_all + (size_t)e * p.K * p.N;
    if (start >= end) {
      // Zeros: this warpgroup's rows of the tile, 16 bytes a store.
      const int rows = max(0, min(64, p.K - k0 - 64 * wg)), chunks = min(WT_BN, p.N - n0) / 4;
      for (int u = t128; u < rows * chunks; u += 128)
        *reinterpret_cast<float4*>(dw + (size_t)(k0 + 64 * wg + u / chunks) * p.N + n0 +
                                   4 * (u % chunks)) = make_float4(0.f, 0.f, 0.f, 0.f);
      continue;
    }
    // Step `step_it` (segment rows step_row ..) of dy, split and written
    // into B buffer step_it % 2 once the products of step step_it - 2 have
    // read it; rows past the segment as zeros.
    auto transform = [&](int step_it, int step_row) {
      const int stage = step_it % WT_STAGES, buf = step_it & 1;
      mbar_wait(&full[stage], (step_it / WT_STAGES) & 1);
      if (step_it >= 2) mbar_wait(&b_empty[buf], ((step_it >> 1) & 1) ^ 1);
      const unsigned char* d_s = ring + stage * WT_STAGE + 4 * WT_BOX;
      unsigned char* b_s = b_bufs + buf * WT_B_BUF;
      const int live = end - step_row;
#pragma unroll
      for (int box = 0; box < 4; ++box) {
        uint32_t hi[4], lo[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = *reinterpret_cast<const float*>(d_s + box * WT_BOX + t_read[i]);
          split_tf32(t_row0 + 2 * i < live ? v : 0.f, hi[i], lo[i]);
        }
        unsigned char* at = b_s + box * (32 * 128) + t_write;  // columns 32 box ..
        *reinterpret_cast<uint4*>(at) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
        *reinterpret_cast<uint4*>(at + WT_B_TILE) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      }
      fence_proxy_async();
      __syncwarp();
      if (lane == 0) mbar_arrive(&b_full[buf]);
    };
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) total[j][q] = 0.f;
    // A of step `step_it` (segment rows step_row ..) into ab, as: of k8 step
    // j, (a0, a1) = xs row 8j + 2c and (a2, a3) = row 8j + 2c + 1, each at
    // this lane's two columns; zeros past the segment. The stage has
    // landed: this warp's transform of the step waited for it. Then the
    // raw stage is released.
    uint32_t a_big[4][4], a_small[4][4], n_big[4][4], n_small[4][4];
    auto load_a = [&](int step_it, int step_row, uint32_t (&ab)[4][4], uint32_t (&as)[4][4]) {
      const int stage = step_it % WT_STAGES;
      const unsigned char* x_s = ring + stage * WT_STAGE + a_box * WT_BOX;
      const int live = end - step_row;
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 8 * j + 2 * c + h;
          float2 v = *reinterpret_cast<const float2*>(x_s + r * 128 + 16 * (a_chunk ^ (r % 8)) + a_byte);
          if (r >= live) v = make_float2(0.f, 0.f);
          split_tf32(v.x, ab[j][2 * h], as[j][2 * h]);
          split_tf32(v.y, ab[j][2 * h + 1], as[j][2 * h + 1]);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
    };
    transform(it, start);
    load_a(it, start, a_big, a_small);
    for (int row = start, s = 0; row < end; row += WT_BR, ++it, ++s) {
      const int buf = it & 1;
      mbar_wait(&b_full[buf], (it >> 1) & 1);
      const unsigned char* b_s = b_bufs + buf * WT_B_BUF;
      // The interval's first product overwrites the sums.
      const int fresh = s % (WT_PROMOTE / WT_BR) == 0;
      reg_fence(part);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // k8 step j: 32 bytes into B's 128-byte rows of 32 tf32 rows (8-row
        // groups of columns 1024 bytes apart), big then small.
        const uint64_t bb = sw128_desc(b_s + 32 * j, 16, 1024);
        const uint64_t bs = sw128_desc(b_s + WT_B_TILE + 32 * j, 16, 1024);
        wgmma_tf32_n128(part, a_small[j], bb, !(fresh && j == 0));
        wgmma_tf32_n128(part, a_big[j], bs, 1);
        wgmma_tf32_n128(part, a_big[j], bb, 1);
      }
      wgmma_commit();
      const bool more = row + WT_BR < end;
      if (more) {  // the next step's B and A while this step's products run
        transform(it + 1, row + WT_BR);
        load_a(it + 1, row + WT_BR, n_big, n_small);
      }
      wgmma_wait<0>();
      reg_fence(part);
      __syncwarp();
      if (lane == 0) mbar_arrive(&b_empty[buf]);
      if (s % (WT_PROMOTE / WT_BR) == WT_PROMOTE / WT_BR - 1 || !more) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) total[j][q] += part[j][q];
      }
      if (more) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int q = 0; q < 4; ++q) a_big[j][q] = n_big[j][q], a_small[j][q] = n_small[j][q];
      }
    }
    // total[j]: rows g (this lane's column 2g) and g + 8 (column 2g + 1) of
    // the warp's 16, columns 8j + 2c and + 1.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int k = k0 + 64 * wg + 16 * w + 2 * g + h;
      if (k >= p.K) continue;
      float* out = dw + (size_t)k * p.N + n0 + 2 * c;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        if (n0 + 8 * j + 2 * c < p.N)
          *reinterpret_cast<float2*>(out + 8 * j) = make_float2(total[j][2 * h], total[j][2 * h + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from libcuda, found through the runtime (no
// link against libcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A tensor map of `type` elements, 128-byte swizzled, dims and box
// innermost first; coordinates past the edges read as zeros.
bool make_map(CUtensorMap* map, CUtensorMapDataType type, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, type, rank, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Once a device and kernel: the shared-memory opt-in; for the TMA kernel
// also the check that it was built with the registers its setmaxnreg
// hand-over moves (168 a thread at entry: 128 x (40 + 2 x 232) in all),
// and the device's SM count. `which` is the kernel's Variant or Slot.
cudaError_t prepare(int which, const void* kernel, int smem, int device, int* sms) {
  static bool ready[64][SLOTS];
  static int sm_count[64];
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!ready[device][which]) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess &&
        (which == TMA || which == TMA_T_SLOT || which == WGRAD_TMA || which == WGRAD_F32_TMA)) {
      cudaFuncAttributes attr;
      err = cudaFuncGetAttributes(&attr, kernel);
      if (err == cudaSuccess &&
          attr.numRegs * TMA_THREADS < 128 * (PRODUCER_REGS + 2 * CONSUMER_REGS))
        err = cudaErrorInvalidDeviceFunction;
      if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&sm_count[device], cudaDevAttrMultiProcessorCount, device);
    }
    if (err != cudaSuccess) return err;
    ready[device][which] = true;
  }
  *sms = sm_count[device];
  return cudaSuccess;
}

cudaError_t launch(Variant v, const Params& p, int device, cudaStream_t stream) {
  const int row_slots = (p.M + BM - 1) / BM + p.E + 1;
  int sms = 0;
  cudaError_t err;
  if (v == TMA || v == TMA_T) {
    const bool k_major = v == TMA_T;
    auto kernel = k_major ? &grouped_mm_tma_kernel<true> : &grouped_mm_tma_kernel<false>;
    if ((err = prepare(k_major ? TMA_T_SLOT : TMA, reinterpret_cast<const void*>(kernel), TMA_SMEM,
                       device, &sms)) != cudaSuccess)
      return err;
    CUtensorMap tm_x, tm_w;
    const cuuint64_t x_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)p.K * 2};
    const cuuint32_t x_box[2] = {TMA_BK, BM};
    // w [E, K, N]: boxes of 64 columns x TMA_BK k; [E, N, K]: TMA_BK k x 64 columns.
    const cuuint64_t w_dims[3] = {(cuuint64_t)(k_major ? p.K : p.N),
                                  (cuuint64_t)(k_major ? p.N : p.K), (cuuint64_t)p.E};
    const cuuint64_t w_strides[2] = {(cuuint64_t)w_dims[0] * 2, (cuuint64_t)p.K * p.N * 2};
    const cuuint32_t w_box[3] = {64, 64, 1};
    if (!make_map(&tm_x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, 2, x_dims, x_strides, x_box) ||
        !make_map(&tm_w, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.w, 3, w_dims, w_strides, w_box))
      return cudaErrorInvalidValue;
    const int col_tiles = (p.N + TMA_BN - 1) / TMA_BN;
    const long long tiles = (long long)row_slots * col_tiles;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const int grid = (int)(tiles < sms ? tiles : sms);
    kernel<<<grid, TMA_THREADS, TMA_SMEM, stream>>>(p, tm_x, tm_w, col_tiles, (int)tiles);
    return cudaGetLastError();
  }
  if (row_slots > 65535) return cudaErrorInvalidValue;
  const dim3 grid((p.N + BN - 1) / BN, row_slots);
  if (v == MMA) {
    const void* kernel = reinterpret_cast<const void*>(&grouped_mm_bf16_kernel);
    if ((err = prepare(MMA, kernel, SMEM_BF16, device, &sms)) != cudaSuccess) return err;
    grouped_mm_bf16_kernel<<<grid, THREADS, SMEM_BF16, stream>>>(p);
    return cudaGetLastError();
  }
  // f32: 16-byte copies where K and N are multiples of 4 and the operands
  // 16-byte aligned, else 4-byte ones.
  const bool vec =
      p.K % 4 == 0 && p.N % 4 == 0 && aligned16(p.x) && aligned16(p.w) && aligned16(p.y);
  void (*kernel)(Params) = vec ? &grouped_mm_f32_kernel<true> : &grouped_mm_f32_kernel<false>;
  if ((err = prepare(vec ? F32_VEC : F32, reinterpret_cast<const void*>(kernel), SMEM_F32, device,
                     &sms)) != cudaSuccess)
    return err;
  kernel<<<grid, THREADS, SMEM_F32, stream>>>(p);
  return cudaGetLastError();
}

// wgrad. bf16 by TMA and wgmma where K and N are multiples of 8 and the
// operands 16-byte aligned, else by mma.sync on operands read element by
// element; f32 by TMA and tf32 wgmma where K and N are multiples of 4 and
// the operands 16-byte aligned, else by mma.sync on 4-byte copies. The TMA
// kernels are persistent (one block an SM, or a tile where there are
// fewer), the others one block a (N tile, K tile, expert).
cudaError_t launch_wgrad(bool f32, const WgradParams& p, int device, cudaStream_t stream) {
  const int width = f32 ? 4 : 8;
  const bool vec = p.K % width == 0 && p.N % width == 0 && aligned16(p.x) && aligned16(p.dy) &&
                   aligned16(p.dw);
  if (!f32 && vec) {
    // bf16 by TMA and wgmma: xs [M, K] and dy [M, N] as 2-D maps, dw [E,
    // K, N] as a 3-D one, boxes of 64 columns x 64 rows; one block an SM
    // (or a tile).
    const void* kernel = reinterpret_cast<const void*>(&grouped_wgrad_tma_kernel);
    int sms = 0;
    cudaError_t err = prepare(WGRAD_TMA, kernel, TMA_SMEM, device, &sms);
    if (err != cudaSuccess) return err;
    const int k_tiles = (p.K + BM - 1) / BM, n_tiles = (p.N + TMA_BN - 1) / TMA_BN;
    const long long tiles = (long long)p.E * k_tiles * n_tiles;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const int grid = (int)(tiles < sms ? tiles : sms);
    CUtensorMap tm_x{}, tm_dy{}, tm_dw;  // no map over 0 rows: every tile is then zeros
    const cuuint64_t x_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)p.K * 2};
    const cuuint64_t d_dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.M};
    const cuuint64_t d_strides[1] = {(cuuint64_t)p.N * 2};
    const cuuint64_t w_dims[3] = {(cuuint64_t)p.N, (cuuint64_t)p.K, (cuuint64_t)p.E};
    const cuuint64_t w_strides[2] = {(cuuint64_t)p.N * 2, (cuuint64_t)p.K * p.N * 2};
    const cuuint32_t box[2] = {64, TMA_BK}, w_box[3] = {64, 64, 1};
    const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    if ((p.M > 0 && (!make_map(&tm_x, bf16, p.x, 2, x_dims, x_strides, box) ||
                     !make_map(&tm_dy, bf16, p.dy, 2, d_dims, d_strides, box))) ||
        !make_map(&tm_dw, bf16, p.dw, 3, w_dims, w_strides, w_box))
      return cudaErrorInvalidValue;
    grouped_wgrad_tma_kernel<<<grid, TMA_THREADS, TMA_SMEM, stream>>>(p, tm_x, tm_dy, tm_dw,
                                                                      k_tiles, n_tiles, (int)tiles);
    return cudaGetLastError();
  }
  if (f32 && vec) {
    // f32 by TMA and tf32 wgmma: xs [M, K] and dy [M, N] as 2-D maps,
    // boxes of 32 columns x 32 rows.
    const void* kernel = reinterpret_cast<const void*>(&grouped_wgrad_f32_tma_kernel);
    int sms = 0;
    cudaError_t err = prepare(WGRAD_F32_TMA, kernel, WT_SMEM, device, &sms);
    if (err != cudaSuccess) return err;
    const int k_tiles = (p.K + BM - 1) / BM, n_tiles = (p.N + WT_BN - 1) / WT_BN;
    const long long tiles = (long long)p.E * k_tiles * n_tiles;
    if (tiles > 0x7fffffff) return cudaErrorInvalidValue;
    const int grid = (int)(tiles < sms ? tiles : sms);
    CUtensorMap tm_x{}, tm_dy{};  // no map over 0 rows: every tile is then zeros
    const cuuint64_t x_dims[2] = {(cuuint64_t)p.K, (cuuint64_t)p.M};
    const cuuint64_t x_strides[1] = {(cuuint64_t)p.K * 4};
    const cuuint64_t d_dims[2] = {(cuuint64_t)p.N, (cuuint64_t)p.M};
    const cuuint64_t d_strides[1] = {(cuuint64_t)p.N * 4};
    const cuuint32_t box[2] = {32, WT_BR};
    const CUtensorMapDataType f32_type = CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
    if (p.M > 0 && (!make_map(&tm_x, f32_type, p.x, 2, x_dims, x_strides, box) ||
                    !make_map(&tm_dy, f32_type, p.dy, 2, d_dims, d_strides, box)))
      return cudaErrorInvalidValue;
    grouped_wgrad_f32_tma_kernel<<<grid, TMA_THREADS, WT_SMEM, stream>>>(p, tm_x, tm_dy, k_tiles,
                                                                          n_tiles, (int)tiles);
    return cudaGetLastError();
  }
  const dim3 grid((p.N + BN - 1) / BN, (p.K + BN - 1) / BN, p.E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidValue;
  void (*kernel)(WgradParams) = f32 ? &grouped_wgrad_f32_kernel : &grouped_wgrad_bf16_kernel;
  const int smem = f32 ? SMEM_W_F32 : SMEM_W_BF16;
  int sms = 0;
  const int slot = f32 ? WGRAD_F32 : WGRAD_MMA;
  cudaError_t err = prepare(slot, reinterpret_cast<const void*>(kernel), smem, device, &sms);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(p);
  return cudaGetLastError();
}

// Runs `fn` with CUDA device `device` current, and the previous one restored.
template <typename Fn>
int on_device(int device, Fn fn) {
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = fn();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

extern "C" {

// The constants the kernels are built with, in the order
// `ops/grouped_matmul.py::layout` lists them. Returns the count written
// (at most cap).
int grouped_matmul_layout(int* out, int cap) {
  const int v[] = {BM,         BN,        THREADS,       BK,           STAGES,
                   TMA_BN,     TMA_BK,    TMA_STAGES,    TMA_THREADS,  PRODUCER_REGS,
                   CONSUMER_REGS, TMA_SMEM, F_BK,        F_STAGES,     F_AP,
                   F_BP,       SMEM_F32, W_BR,        W_STAGES,     SMEM_W_BF16,
                   WF_BR,      WF_STAGES, WF_P,       SMEM_W_F32,   WT_BN,
                   WT_BR,      WT_STAGES, WT_PROMOTE, WT_SMEM};
  const int count = (int)(sizeof(v) / sizeof(v[0]));
  const int n = cap < count ? cap : count;
  for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

// variant: 0 = float32 (3xTF32), 1 = bfloat16 by TMA and wgmma, 2 =
// bfloat16 by mma.sync (`ops/grouped_matmul.py::variant` chooses, by
// shape and alignment), 3 = as 1 with w given as [E, N, K] and y[r] = x[r]
// . w[g(r)]^T (the backward's dgrad). x [M, K], w [E, K, N] (3: [E, N,
// K]) and y [M, N] contiguous in the variant's dtype; sizes [E] int32; all
// on CUDA device `device` (made current for the launch, and the previous
// one restored), on `stream`.
// Returns a cudaError_t: cudaErrorInvalidValue for what the variant does
// not take (nothing is launched), else the launch's error.
int grouped_matmul_launch(int variant, const void* x, const void* w, const int* sizes, void* y,
                          int M, int K, int N, int E, int device, void* stream) {
  if (variant < F32 || variant > TMA_T || M < 1 || K < 0 || N < 1 || E < 1 || !x || !w ||
      !sizes || !y)
    return (int)cudaErrorInvalidValue;
  // TMA: rows and experts 16-byte strides, 16-byte aligned bases.
  if ((variant == TMA || variant == TMA_T) &&
      !(K > 0 && K % 8 == 0 && N % 8 == 0 && aligned16(x) && aligned16(w) && aligned16(y)))
    return (int)cudaErrorInvalidValue;
  const Params p = {x, w, y, sizes, M, K, N, E};
  return on_device(device, [&] {
    return launch(static_cast<Variant>(variant), p, device, (cudaStream_t)stream);
  });
}

// dw [E, K, N] = xs[seg_e]^T . dy[seg_e] for each expert e (zeros for an
// empty group): f32 nonzero for float32 (3xTF32), else bfloat16. xs [M,
// K], dy [M, N] and dw contiguous in that dtype; sizes [E] int32; all on
// CUDA device `device`, on `stream`. Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernels do not take (nothing is
// launched), else the launch's error.
int grouped_matmul_wgrad_launch(int f32, const void* x, const void* dy, const int* sizes, void* dw,
                                int M, int K, int N, int E, int device, void* stream) {
  if (M < 0 || K < 1 || N < 1 || E < 1 || !sizes || !dw || (M > 0 && (!x || !dy)))
    return (int)cudaErrorInvalidValue;
  const WgradParams p = {x, dy, dw, sizes, M, K, N, E};
  return on_device(device, [&] { return launch_wgrad(f32 != 0, p, device, (cudaStream_t)stream); });
}

}  // extern "C"
