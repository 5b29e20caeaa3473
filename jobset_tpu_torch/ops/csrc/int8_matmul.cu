// Weight-only int8 products of the decode step on Hopper (sm_90a), up to
// three of them sharing x in one launch (a layer's Q, K and V):
//
//     y_i[m, n] = sum_k x[m, k] * T(f32(q_i[k, n]) * scale_i[n])     (y_i in T)
//
// for a few rows of x (M <= 16, the decode batch), int8 q_i [K, N_i] and
// one f32 scale per output column; T is the compute dtype (bfloat16 or
// float32). Or, in one launch, the same product for every expert e of an
// MoE stack, q [E, K, N] with scales [E, 1, N], against x[e] or one x
// shared by all experts: y[e] = x[e] @ T(q[e] * scale[e]). It is what `jobset_tpu/models/quant.py::weight_cast` (`:82-92`)
// followed by the step's dot computes on the TPU, where XLA fuses the
// dequantization into the dot's operand read (no Pallas kernel there).
//
// Bound: bytes, and at the small products latency. At M = 8 the product
// does 16 operations for every int8 weight byte, against the ~300 the
// card's bf16 tensor cores need per byte of device memory, so the time is
// the weight bytes over the memory rate; a [1024, 1024] weight is 1 MB,
// 8 KB an SM, which one DRAM round trip delivers. So the kernel has to
// keep enough weight bytes in flight (about 25 KB an SM covers the
// latency at 3.35 TB/s), start them at once, spend few instructions a
// byte, and keep what follows the last bytes short. What each part does
// about it:
//
// - Bytes in flight in shared memory. A tile is 128 columns, four warps
//   side by side. The four warps of a rank lane stream their rows as
//   stages of 32 rows x 128 columns (4 KB, two 16-byte `cp.async.cg` a
//   thread; a warp's copy instruction covers 4 whole 128-byte rows, full
//   lines rather than scattered 32-byte sectors) through a ring of DEPTH
//   stages in shared memory, one commit group a stage: no registers hold
//   bytes in flight, and between stages only the lane's four warps meet (a
//   named barrier). A small product has all its stages in flight from the start,
//   and computes each as it lands; the unembedding 20 KB a rank lane.
// - The prologue paid once. A block stages x once, by `cp.async` in its
//   first group, only its real rows and only the K range its warps read;
//   zero rows of the mma operand come from registers. A tile's scales ride
//   in the stage of its first rows. Where the tiles outnumber the resident
//   blocks, a block walks tiles c, c + G, ...: each rank lane's ring runs
//   across tile boundaries, so the next tile's bytes are in flight during
//   this tile's epilogue, and x is not staged again.
// - No bf16 tile in shared memory. The tensor-core product runs with the
//   operands swapped, weight as A (m16: 16 output columns) and x as B (n8:
//   8 rows of x; 9-16 rows take a second n8), so M <= 8 wastes no tensor
//   work. For each k16 step a lane reads four 4-byte words (physical rows
//   4c .. 4c + 3, columns 4g .. 4g + 3; g = lane / 4, c = lane % 4), turns
//   each byte into its exact float (`prmt` into 2^23's mantissa, one
//   add), multiplies by its column's scale in f32 and rounds once to bf16,
//   packing pairs straight into the A fragments of two m16n8k16 tiles:
//   weight_cast's order. The k order inside a step is relabelled (`frag_k`)
//   and x's B fragment, one 8-byte load, uses the same order; the n order
//   is relabelled (`tile_col`) and the epilogue writes the true columns.
//   A stage's 16-byte chunks sit in shared memory xor `chunk_swizzle` of
//   their row, so the four loads are free of bank conflicts. bf16 x bf16
//   products are exact in the f32 sums.
// - f32 (`int8_matmul_f32_kernel`) shares the loader and the schedule; its
//   arithmetic stays true f32 on the CUDA cores: each lane keeps M x 4
//   sums over its rows 4c .. 4c + 3 of each step (x from shared memory,
//   one 16-byte load a row), and the four lanes of a column group are
//   added by two shuffles at the end of a rank's chain.
// - A column's sum order depends on K alone. K is cut into `ranks`
//   slices of `rank_rows` rows (`ops/int8_matmul.py::split_for`, from K
//   only). A warp sums one slice of its 32 columns in k order (one chain,
//   from 0), and the slices are added in rank order, from 0. Where the
//   ranks live is the host's choice (`block_for`, from the widths and the
//   SM count), and moves no bit: a tile is shared by `cluster` blocks (a
//   thread-block cluster above 1), each of 4 x `rank_lanes` warps (at most
//   8: a block's registers then allow 255 a thread, and no instantiation
//   spills), each warp summing `ranks_per_warp` ranks of its 32 columns in
//   turn. A rank's sums are pushed into the shared memory of the block
//   that writes those outputs: within a block by plain stores and a barrier; across a
//   cluster (which then takes one tile) by `st.async`, each push counted in
//   bytes on the owner's mbarrier, so an owner waits for its own inputs
//   only, and no block waits for the cluster at the end (the blocks arrive
//   once at their start, after setting their mbarriers, and wait before
//   their first push). Each block then adds its share in rank order from
//   its own shared memory and writes y. No atomics, no workspace. So two
//   launches give the same bits, and so do a grouped launch and separate
//   launches of its members.
// - Rows of q that are not 16-byte aligned (N not a multiple of 16, or a
//   misaligned base) are read byte by byte into the same stages (the
//   `VecQ = false` instantiations); the arithmetic is the same.
// - An expert stack is one member whose tiles run on: tile t is expert t /
//   tiles_e's column tile t % tiles_e, so a tile, and the cluster that
//   takes it, never spans two experts, and each expert's sums are those of
//   a 2-D launch on its weight (the split is K's). Where each expert has
//   its own x, a block (or cluster) takes one tile and stages that
//   expert's x; a shared x is staged once, as for a group. The stack's
//   code is its own instantiation (`Experts`): a 2-D launch runs none of
//   it.
// - No programmatic dependent launch: on the decode path every product
//   follows a PyTorch kernel, which never triggers early.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARP_COLS = 32;                    // columns a warp owns
constexpr int COL_GROUPS = 4;                    // warps across a tile
constexpr int TILE_COLS = COL_GROUPS * WARP_COLS;  // 128: whole 128-byte rows
constexpr int LANE_THREADS = COL_GROUPS * 32;    // a rank lane's threads
constexpr int CHUNKS = TILE_COLS / 16;           // 16-byte chunks a row
constexpr int STEP_ROWS = 16;                    // rows of q a k16 step
constexpr int STAGE_ROWS = 2 * STEP_ROWS;        // rows of q a stage
constexpr int STEP_Q = STEP_ROWS * TILE_COLS;    // q bytes of a step: 2 KB
constexpr int STAGE_Q = 2 * STEP_Q;              // q bytes of a stage: 4 KB
constexpr int STAGE_BYTES = STAGE_Q + 4 * TILE_COLS;  // and a tile's scales: 4.5 KB
constexpr int DEPTH = 6;                         // stages in a rank lane's ring
constexpr int MAX_RANK_LANES = 2;                // rank lanes a block: 8 warps
constexpr int MAX_THREADS = LANE_THREADS * MAX_RANK_LANES;
constexpr int MAX_CLUSTER = 8;                   // portable cluster size
constexpr int MAX_RANKS = 64;
constexpr int MAX_ROWS = 16;                     // largest M (the wrapper's cut)
constexpr int MAX_MEMBERS = 3;
constexpr int MAX_SMEM = 232448;                 // a block's opt-in shared memory

// The 16-byte chunk of a step's row r sits at chunk xor chunk_swizzle(r):
// lane c's rows 4c + i, read at chunk 2 * (warp) + g / 4, then land in
// distinct bank groups for the four c.
__host__ __device__ constexpr int chunk_swizzle(int r) { return 2 * ((r % STEP_ROWS) / 4); }
// Physical row in a step of the mma's logical k (A's column, B's row):
// logical 2c, 2c + 1, 2c + 8, 2c + 9 are lane c's rows 4c .. 4c + 3.
__host__ __device__ constexpr int frag_k(int k) {
  return 4 * ((k % 8) / 2) + 2 * (k / 8) + k % 2;
}
// Byte of a lane's 4-column word (column 4g + byte) of A's row g (h = 0)
// and g + 8 (h = 1) in m16 tile t.
__host__ __device__ constexpr int tile_col(int t, int h) { return 2 * t + h; }

struct Member {
  const int8_t* q;      // [K, n] int8, rows contiguous
  const float* scale;   // [n]
  void* y;              // rows ldy apart, in T
  int n;
  int tile0;            // the member's first tile in the launch
};

struct Params {
  const void* x;        // [M, K] in T, contiguous (an expert's, see x_expert)
  Member member[MAX_MEMBERS];
  int members, M, K, ldy;
  int tiles_e;          // an expert stack's tiles an expert; 0: no expert axis
  long long x_expert;   // bytes between experts' x (0: shared)
  long long y_expert;   // bytes between experts' y
  int ranks, rank_rows; // the split, from K alone
  int rank_lanes, ranks_per_warp, cluster;  // where the ranks live
  int tiles;            // 128-column tiles of all members
  int grid_clusters;    // G: cluster c walks tiles c, c + G, ...
  int x_pitch;          // elements between staged x rows
  bool vec_x, vec_y;    // 16-byte x chunks; 4-column y stores
};

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_id() {
  unsigned r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return r;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" :: "r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(unsigned bar, int parity) {
  unsigned done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done;
}

// Wait for the phase of `parity` to complete. A wait of more than about a
// second means a lost push: trap, so the launch fails instead of holding
// the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_addr(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 31)) __trap();
}

// Four floats to p in the shared memory of cluster block `rank`, counted
// in bytes on that block's mbarrier at `bar` (the same offset in every
// block).
__device__ __forceinline__ void st_async_f4(float* p, uint64_t* bar, int rank, float4 v) {
  unsigned remote, remote_bar;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(remote) : "r"(smem_addr(p)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote_bar) : "r"(smem_addr(bar)), "r"(rank));
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, [%5];"
               :: "r"(remote), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(remote_bar) : "memory");
}

// d += a * b: a 16x16 bf16 (16 weight columns by 16 k), b 16x8 bf16 (16 k
// by 8 rows of x), d 16x8 f32.
__device__ __forceinline__ void mma_bf16(float* d, const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four bytes of a word, times their columns' scales, in f32: byte j
// (of the word xor 0x80808080, so b + 128) in the low mantissa bits of
// 2^23 (`magic`, kept in a register so the selector is the immediate) is
// 2^23 + b + 128; one add leaves b exactly, one multiply rounds b * scale
// once, as weight_cast does.
template <int J>
__device__ __forceinline__ float byte_times(unsigned word, unsigned magic, float scale) {
  unsigned bits;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(bits) : "r"(word), "r"(magic), "n"(0x7540 | J));
  return __fmul_rn(__fadd_rn(__uint_as_float(bits), -8388736.f), scale);
}

__device__ __forceinline__ void dequant_word(unsigned word, unsigned magic, const float (&sc)[4],
                                             float (&v)[4]) {
  word ^= 0x80808080u;
  v[0] = byte_times<0>(word, magic, sc[0]);
  v[1] = byte_times<1>(word, magic, sc[1]);
  v[2] = byte_times<2>(word, magic, sc[2]);
  v[3] = byte_times<3>(word, magic, sc[3]);
}

__device__ __forceinline__ unsigned pack_bf16(float lo, float hi) {
  const __nv_bfloat162 pair = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&pair);
}

template <bool Experts>
__device__ __forceinline__ Member member_of(const Params& p, int tile) {
  // Selects, not an indexed read: a dynamic index into the parameters
  // would copy them to local memory.
  const bool second = p.members > 1 && tile >= p.member[1].tile0;
  const bool third = p.members > 2 && tile >= p.member[2].tile0;
  Member m = third ? p.member[2] : second ? p.member[1] : p.member[0];
  if constexpr (Experts) {  // an expert stack: expert e's weight, scales and y
    const int e = tile / p.tiles_e;
    m.q += (size_t)e * p.K * m.n;
    m.scale += (size_t)e * m.n;
    m.y = static_cast<char*>(m.y) + e * p.y_expert;
    m.tile0 = e * p.tiles_e;
  }
  return m;
}

__device__ __forceinline__ void store_out(float* y, size_t at, int valid, float4 s, bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<float4*>(y + at) = s;
  } else {
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < valid) y[at + e] = v[e];
  }
}

__device__ __forceinline__ void store_out(__nv_bfloat16* y, size_t at, int valid, float4 s,
                                          bool vec) {
  if (vec && valid >= 4) {
    *reinterpret_cast<uint2*>(y + at) = make_uint2(pack_bf16(s.x, s.y), pack_bf16(s.z, s.w));
  } else {
    const float v[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (e < valid) y[at + e] = __float2bfloat16_rn(v[e]);
  }
}

// The kernel body. MR: 8 or 16 rows of x; VecQ: 16-byte weight rows;
// Experts: an expert stack (instantiated apart, so that a 2-D launch runs
// none of its code).
template <typename T, int MR, bool VecQ, bool Experts>
__device__ __forceinline__ void int8_matmul_body(const Params& p) {
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int E = 16 / sizeof(T);  // values of x in 16 bytes
  constexpr int QUADS = TILE_COLS / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int g = lane / 4, c = lane % 4;
  const int C = p.cluster, M = p.M, K = p.K, RPW = p.ranks_per_warp;
  const int cg = warp % COL_GROUPS, rl = warp / COL_GROUPS;  // column group, rank lane
  const int tau = t % LANE_THREADS;                          // thread in the rank lane
  const int block_ranks = p.rank_lanes * RPW;
  const int brank = C > 1 ? (int)cluster_rank() : 0;
  const int cid = C > 1 ? (int)cluster_id() : (int)blockIdx.x;
  const int rank0 = brank * block_ranks + rl * RPW;  // the rank lane's first rank
  const int stages_rank = p.rank_rows / STAGE_ROWS;
  const int my_tiles = (p.tiles - cid + p.grid_clusters - 1) / p.grid_clusters;
  const int total = my_tiles * RPW * stages_rank;  // stages the rank lane consumes

  unsigned char* const ring = smem + rl * DEPTH * STAGE_BYTES;
  T* const xs = reinterpret_cast<T*>(smem + p.rank_lanes * DEPTH * STAGE_BYTES);
  const int x_rows = block_ranks * p.rank_rows;  // the block's values of K
  float* const slots = reinterpret_cast<float*>(
      smem + p.rank_lanes * DEPTH * STAGE_BYTES + ((M * p.x_pitch * (int)sizeof(T) + 15) & ~15));
  const int share = M * QUADS / C;  // output quads a block writes
  // [rank][share] float4, then (across a cluster) the mbarrier the pushes
  // into this block count their bytes on.
  uint64_t* const pushed = reinterpret_cast<uint64_t*>(slots + p.ranks * share * 4);

  // The producer, the rank lane's 128 threads. Stages go in order: tiles,
  // their ranks, 32 rows at a time; ring slots 0, 1, .., DEPTH - 1, 0, ...
  // Thread tau copies chunk tau % CHUNKS of rows tau / CHUNKS and 16 +
  // tau / CHUNKS (a warp: whole rows an instruction) and, in a tile's first
  // stage, the scale of column tau. One group a stage, empty past the end.
  int p_left = total, p_slot = 0, p_stage = 0, p_rank = 0, p_tile = cid;
  Member p_mb = member_of<Experts>(p, p_tile);
  int p_col = (p_tile - p_mb.tile0) * TILE_COLS + 16 * (tau % CHUNKS);
  int p_row = rank0 * p.rank_rows, p_end = min(K, p_row + p.rank_rows);
  const int lr = tau / CHUNKS;
  const int dst_off = lr * TILE_COLS + 16 * ((tau % CHUNKS) ^ chunk_swizzle(lr));
  auto issue = [&]() {
    if (p_left > 0) {
      unsigned char* stage = ring + p_slot * STAGE_BYTES;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int row = p_row + s * STEP_ROWS + lr;
        const bool inside = row < p_end && p_col < p_mb.n;
        unsigned char* dst = stage + s * STEP_Q + dst_off;
        if (VecQ) {
          cp_async16(dst, inside ? p_mb.q + (size_t)row * p_mb.n + p_col : p_mb.q,
                     inside ? 16 : 0);
        } else {
          unsigned word[4] = {0u, 0u, 0u, 0u};
          if (inside) {
            const int8_t* src = p_mb.q + (size_t)row * p_mb.n + p_col;
#pragma unroll
            for (int j = 0; j < 16; ++j)
              if (p_col + j < p_mb.n)
                word[j / 4] |= (unsigned)(unsigned char)src[j] << (8 * (j % 4));
          }
          *reinterpret_cast<uint4*>(dst) = make_uint4(word[0], word[1], word[2], word[3]);
        }
      }
      if (p_stage == 0 && p_rank == 0) {
        const int cn = p_col - 16 * (tau % CHUNKS) + tau;
        cp_async4(stage + STAGE_Q + 4 * tau, cn < p_mb.n ? p_mb.scale + cn : p_mb.scale,
                  cn < p_mb.n ? 4 : 0);
      }
      --p_left;
      p_slot = p_slot + 1 == DEPTH ? 0 : p_slot + 1;
      p_row += STAGE_ROWS;
      if (++p_stage == stages_rank && p_left > 0) {
        p_stage = 0;
        if (++p_rank == RPW) {
          p_rank = 0;
          p_tile += p.grid_clusters;
          p_mb = member_of<Experts>(p, p_tile);
          p_col = (p_tile - p_mb.tile0) * TILE_COLS + 16 * (tau % CHUNKS);
        }
        p_row = (rank0 + p_rank) * p.rank_rows;
        p_end = min(K, p_row + p.rank_rows);
      }
    }
    cp_async_commit();
  };

  // Across a cluster (one tile), the pushes into this block are counted in
  // bytes on `pushed`; and every block must run, its mbarrier set, before
  // one writes another's shared memory: arrive now, wait before the first
  // push.
  if (C > 1) {
    if (t == 0) {
      mbar_init(pushed, 1);
      mbar_expect_tx(pushed, p.ranks * share * 16);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  }

  // x rows m < M, values brank * x_rows .. + x_rows of K (zeros from K
  // on), by the whole block, in the first group.
  {
    // An expert's own x: the block's one tile is that expert's.
    const T* x = static_cast<const T*>(p.x);
    if constexpr (Experts) x = reinterpret_cast<const T*>(
        static_cast<const char*>(p.x) + cid / p.tiles_e * p.x_expert);
    const int chunks = x_rows / E, x_row0 = brank * x_rows;
    for (int u = t; u < M * chunks; u += blockDim.x) {
      const int m = u / chunks, e = u - m * chunks, k = x_row0 + e * E;
      T* dst = xs + m * p.x_pitch + e * E;
      if (p.vec_x) {
        const int valid = k < K ? min(E, K - k) : 0;
        cp_async16(dst, valid ? x + (size_t)m * K + k : x, valid * (int)sizeof(T));
      } else {
#pragma unroll
        for (int j = 0; j < E; ++j)
          dst[j] = k + j < K ? x[(size_t)m * K + k + j] : static_cast<T>(0.f);
      }
    }
  }
#pragma unroll
  for (int s = 0; s < DEPTH - 1; ++s) issue();
  cp_async_wait<DEPTH - 2>();
  __syncthreads();  // x and every rank lane's first stage have landed

  unsigned magic;
  asm("mov.b32 %0, 0x4B000000;" : "=r"(magic));
  constexpr int NT8 = BF16 ? MR / 8 : 1;
  float acc[BF16 ? 2 : MR][BF16 ? NT8 * 4 : 4];  // bf16: [m16 tile][n8 * 4]; f32: [m][col]
  float sc[4];  // scales of columns 4g .. 4g + 3 of the warp's 32
  // The lane's word i of a step: row 4c + i, chunk 2 cg + g / 4 (swizzled
  // by the row: xor 2c), bytes 4 (g % 4).
  const int word_off = 4 * c * TILE_COLS + 16 * ((2 * cg + g / 4) ^ chunk_swizzle(4 * c)) +
                       4 * (g % 4);
  // B (bf16): x rows g (+ 8), logical k 2c, 2c + 1 | 2c + 8, 2c + 9 =
  // physical 4c .. 4c + 3, from the block's K range at the lane's rank.
  const T* x_lane = xs + (BF16 ? g * p.x_pitch : 0) + rl * RPW * p.rank_rows + 4 * c;
  int stage_i = 0, rank_i = 0, tile_i = 0, slot = 0;
  bool joined = C == 1;
  for (int i = 0; i < total; ++i) {
    cp_async_wait<DEPTH - 2>();  // stage i landed (this thread's copies)
    // ... and the rank lane's: its warps meet, so stage i - 1 is read.
    asm volatile("bar.sync %0, %1;" :: "r"(1 + rl), "n"(LANE_THREADS) : "memory");
    issue();  // stage i + DEPTH - 1, into stage i - 1's slot
    const unsigned char* stage = ring + slot * STAGE_BYTES;
    slot = slot + 1 == DEPTH ? 0 : slot + 1;
    if (stage_i == 0) {
      if (rank_i == 0) {
        const float4 s4 =
            *reinterpret_cast<const float4*>(stage + STAGE_Q + 4 * (cg * WARP_COLS + 4 * g));
        sc[0] = s4.x, sc[1] = s4.y, sc[2] = s4.z, sc[3] = s4.w;
      }
#pragma unroll
      for (int a = 0; a < (BF16 ? 2 : MR); ++a)
#pragma unroll
        for (int b = 0; b < (BF16 ? NT8 * 4 : 4); ++b) acc[a][b] = 0.f;
    }
    const T* xk = x_lane + rank_i * p.rank_rows + stage_i * STAGE_ROWS;
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const unsigned char* words = stage + s * STEP_Q + word_off;
      float v[4][4];  // rows 4c + r, columns 4g + j: f32(q) * scale
#pragma unroll
      for (int r = 0; r < 4; ++r)
        dequant_word(*reinterpret_cast<const unsigned*>(words + r * TILE_COLS), magic, sc, v[r]);
      if constexpr (BF16) {
        unsigned b[NT8][2];
#pragma unroll
        for (int j = 0; j < NT8; ++j) {
          b[j][0] = b[j][1] = 0u;
          if (g + 8 * j < M) {
            const uint2 pair =
                *reinterpret_cast<const uint2*>(xk + 8 * j * p.x_pitch + s * STEP_ROWS);
            b[j][0] = pair.x, b[j][1] = pair.y;
          }
        }
        // A of m16 tile tt: register reg holds A's row g + 8 (reg % 2),
        // logical k 2c + 8 (reg / 2) + {0, 1}: words frag_k(8 (reg / 2) + {0, 1}).
#pragma unroll
        for (int tt = 0; tt < 2; ++tt) {
          unsigned a[4];
#pragma unroll
          for (int reg = 0; reg < 4; ++reg) {
            const int col = tile_col(tt, reg % 2);
            a[reg] = pack_bf16(v[frag_k(8 * (reg / 2))][col], v[frag_k(8 * (reg / 2) + 1)][col]);
          }
#pragma unroll
          for (int j = 0; j < NT8; ++j) mma_bf16(&acc[tt][4 * j], a, b[j][0], b[j][1]);
        }
      } else {
#pragma unroll
        for (int m = 0; m < MR; ++m) {
          if (m < M) {
            const float4 x4 =
                *reinterpret_cast<const float4*>(xk + m * p.x_pitch + s * STEP_ROWS);
            const float xr[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
            for (int r = 0; r < 4; ++r)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[m][j] = fmaf(xr[r], v[r][j], acc[m][j]);
          }
        }
      }
    }
    if (++stage_i < stages_rank) continue;
    stage_i = 0;

    // The rank's chain is summed: push its quads (row m, columns 4g .. 4g
    // + 3 of this warp's 32) to the slot of the block that writes them.
    if (!joined) {
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      joined = true;
    }
    const int rank = rank0 + rank_i;
    auto push = [&](int m, float4 v) {
      const int u = m * QUADS + cg * (WARP_COLS / 4) + g;
      const int owner = u / share;
      float* dst = slots + (rank * share + u - owner * share) * 4;
      if (C > 1) st_async_f4(dst, pushed, owner, v); else *reinterpret_cast<float4*>(dst) = v;
    };
    if constexpr (BF16) {
      // acc[tt][4j + e'] is D's row g (+ 8 for e' >= 2): column 4g +
      // tile_col(tt, e' / 2); and D's column 2c + e' % 2 (+ 8j): x's row.
#pragma unroll
      for (int j = 0; j < NT8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 2 * c + 8 * j + e;
          if (m < M)
            push(m, make_float4(acc[0][4 * j + e], acc[0][4 * j + 2 + e], acc[1][4 * j + e],
                                acc[1][4 * j + 2 + e]));
        }
    } else {
      // The four lanes of a column group summed over their rows 4c + r.
#pragma unroll
      for (int m = 0; m < MR; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 1);
          acc[m][j] += __shfl_xor_sync(0xffffffffu, acc[m][j], 2);
        }
#pragma unroll
      for (int m = 0; m < MR; ++m)
        if (m < M && m % 4 == c) push(m, make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]));
    }
    if (++rank_i < RPW) continue;
    rank_i = 0;

    // The tile's epilogue, once every rank is pushed (the block's own
    // warps; across a cluster, the bytes counted on `pushed`): this
    // block's share of the outputs, the ranks added in rank order, from 0.
    if (C > 1) mbar_wait(pushed, 0); else __syncthreads();
    const int tile = cid + tile_i * p.grid_clusters;
    const Member mb = member_of<Experts>(p, tile);
    for (int u = t; u < share; u += blockDim.x) {
      float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r0 = 0; r0 < p.ranks; r0 += 8) {
        float4 w[8];  // eight ranks' loads in flight, then their sums in order
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (r0 + j < p.ranks)
            w[j] = *reinterpret_cast<const float4*>(slots + ((r0 + j) * share + u) * 4);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (r0 + j < p.ranks) s.x += w[j].x, s.y += w[j].y, s.z += w[j].z, s.w += w[j].w;
      }
      const int q = brank * share + u, m = q / QUADS;
      const int n = (tile - mb.tile0) * TILE_COLS + 4 * (q - m * QUADS);
      if (n < mb.n)
        store_out(static_cast<T*>(mb.y), (size_t)m * p.ldy + n, mb.n - n, s, p.vec_y);
    }
    if (C == 1) __syncthreads();  // the slots are written again by the next tile
    ++tile_i;
  }
  cp_async_wait<0>();
}

template <int MR, bool VecQ, bool Experts>
__global__ void __launch_bounds__(MAX_THREADS, 1)
int8_matmul_tc_kernel(const __grid_constant__ Params p) {
  int8_matmul_body<__nv_bfloat16, MR, VecQ, Experts>(p);
}

template <int MR, bool VecQ, bool Experts>
__global__ void __launch_bounds__(MAX_THREADS, 1)
int8_matmul_f32_kernel(const __grid_constant__ Params p) {
  int8_matmul_body<float, MR, VecQ, Experts>(p);
}

int sm_count() {
  static int count = 0;
  if (!count) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, dev);
    if (count <= 0) count = 132;
  }
  return count;
}

using Kernel = void (*)(Params);

// The instantiation for a launch: dtype 1 bf16 (tensor cores) else f32;
// 16 or 8 rows of x; 16-byte weight rows or not.
template <bool Experts>
Kernel kernel_for(int dtype, bool rows16, bool vec_q) {
  if (dtype == 1)
    return rows16 ? (vec_q ? &int8_matmul_tc_kernel<16, true, Experts>
                           : &int8_matmul_tc_kernel<16, false, Experts>)
                  : (vec_q ? &int8_matmul_tc_kernel<8, true, Experts>
                           : &int8_matmul_tc_kernel<8, false, Experts>);
  return rows16 ? (vec_q ? &int8_matmul_f32_kernel<16, true, Experts>
                         : &int8_matmul_f32_kernel<16, false, Experts>)
                : (vec_q ? &int8_matmul_f32_kernel<8, true, Experts>
                         : &int8_matmul_f32_kernel<8, false, Experts>);
}

// Resident blocks an SM for (kernel, device, threads, shared memory),
// cached: the occupancy query costs host time, and a decode step meets
// few shapes. A kernel's shared-memory opt-in is set at its first query on
// a device.
int blocks_per_sm(Kernel kernel, int device, int threads, int smem) {
  struct Entry { Kernel kernel; int device, threads, smem, blocks; };
  static Entry cache[64];
  static int used = 0;
  bool opted = false;
  for (int i = 0; i < used; ++i) {
    const Entry& e = cache[i];
    if (e.kernel != kernel || e.device != device) continue;
    if (e.threads == threads && e.smem == smem) return e.blocks;
    opted = true;
  }
  if (!opted)
    cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, MAX_SMEM);
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, threads, smem) != cudaSuccess)
    blocks = 0;
  if (used < 64) cache[used++] = {kernel, device, threads, smem, blocks};
  return blocks;
}

bool pow2(int v) { return v >= 1 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// The layout tables and constants the kernel is built with, for the
// wrapper's models of it: WARP_COLS, TILE_COLS, STEP_ROWS, STAGE_ROWS,
// MAX_ROWS, MAX_MEMBERS, MAX_CLUSTER, MAX_RANK_LANES, MAX_RANKS, then
// chunk_swizzle(0..15), frag_k(0..15), tile_col(0..1, 0..1). Returns the
// count written (at most cap).
int int8_matmul_layout(int* out, int cap) {
  int v[9 + 16 + 16 + 4] = {WARP_COLS, TILE_COLS, STEP_ROWS, STAGE_ROWS, MAX_ROWS,
                            MAX_MEMBERS, MAX_CLUSTER, MAX_RANK_LANES, MAX_RANKS};
  for (int r = 0; r < 16; ++r) v[9 + r] = chunk_swizzle(r), v[25 + r] = frag_k(r);
  for (int i = 0; i < 4; ++i) v[41 + i] = tile_col(i / 2, i % 2);
  const int n = cap < 45 ? cap : 45;
  for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

// Bytes of dynamic shared memory a block of the launch below takes: the
// rank lanes' rings, x's rows, the rank slots and their mbarrier.
int int8_matmul_smem(int dtype, int M, int K, int ranks, int rank_rows, int rank_lanes,
                     int ranks_per_warp, int cluster) {
  const int size = dtype == 1 ? 2 : 4;
  const int x_rows = rank_lanes * ranks_per_warp * rank_rows;
  const int x_pitch = dtype == 1 ? x_rows + (16 - x_rows % 64 + 64) % 64 : x_rows;
  const int share = M * (TILE_COLS / 4) / cluster;
  return rank_lanes * DEPTH * STAGE_BYTES + ((M * x_pitch * size + 15) & ~15) +
         ranks * share * 16 + 8;
}

// dtype: 0 = float32, 1 = bfloat16 (x and y). x [M, K] contiguous; member
// i (i < members): q_i [K, n_i] int8 contiguous, scale_i [n_i] f32, y_i
// rows ldy elements apart. experts > 1: one member, a stack q [experts, K,
// n], scale [experts, n], y [experts, M, ldy], against x[e] x_stride
// elements apart (0: one x for every expert). ranks and rank_rows the split of K
// (`split_for`); rank_lanes, ranks_per_warp and cluster where the ranks
// live (`block_for`); all on CUDA device `device`, made current
// for the launch (and the previous one restored), on `stream`. Returns a
// cudaError_t: cudaErrorInvalidValue for what the kernel does not take
// (nothing is launched), else the launch's error.
int int8_matmul_launch(int dtype, const void* x, int M, int K, int ldy, int ranks,
                       int rank_rows, int rank_lanes, int ranks_per_warp, int cluster,
                       int members,
                       const void* q0, const void* s0, void* y0, int n0,
                       const void* q1, const void* s1, void* y1, int n1,
                       const void* q2, const void* s2, void* y2, int n2,
                       int experts, long long x_stride, int device, void* stream) {
  const void* qs[3] = {q0, q1, q2};
  const void* ss[3] = {s0, s1, s2};
  void* ys[3] = {y0, y1, y2};
  const int ns[3] = {n0, n1, n2};
  if (M < 1 || M > MAX_ROWS || K < 1 || (dtype != 0 && dtype != 1) || members < 1 ||
      members > MAX_MEMBERS || !pow2(ranks) || ranks > MAX_RANKS || rank_rows < STAGE_ROWS ||
      rank_rows % STAGE_ROWS || (long long)ranks * rank_rows < K || !pow2(rank_lanes) ||
      rank_lanes > MAX_RANK_LANES || ranks_per_warp < 1 || !pow2(cluster) || cluster > MAX_CLUSTER ||
      cluster * rank_lanes * ranks_per_warp != ranks || experts < 1 ||
      (experts > 1 && members != 1) || x_stride < 0 || (x_stride && experts == 1))
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 1 ? 2 : 4;
  Params p = {};
  p.x = x;
  p.members = members, p.M = M, p.K = K, p.ldy = ldy;
  p.ranks = ranks, p.rank_rows = rank_rows;
  p.rank_lanes = rank_lanes, p.ranks_per_warp = ranks_per_warp;
  p.cluster = cluster;
  bool vec_q = true, vec_y = ldy % 4 == 0;
  int tiles = 0, width = 0;
  for (int i = 0; i < members; ++i) {
    if (ns[i] < 1 || !qs[i] || !ss[i] || !ys[i]) return (int)cudaErrorInvalidValue;
    p.member[i] = {static_cast<const int8_t*>(qs[i]), static_cast<const float*>(ss[i]), ys[i],
                   ns[i], tiles};
    tiles += (ns[i] + TILE_COLS - 1) / TILE_COLS;
    width = ns[i] > width ? ns[i] : width;
    vec_q = vec_q && ns[i] % 16 == 0 && reinterpret_cast<uintptr_t>(qs[i]) % 16 == 0;
    vec_y = vec_y && reinterpret_cast<uintptr_t>(ys[i]) % (4 * size) == 0;
  }
  if (ldy < width) return (int)cudaErrorInvalidValue;
  if (experts > 1) {
    p.tiles_e = tiles;
    tiles *= experts;
    p.x_expert = x_stride * size;
    p.y_expert = (long long)M * ldy * size;
  }
  p.tiles = tiles;
  p.vec_y = vec_y;
  p.vec_x = K % (16 / size) == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
            p.x_expert % 16 == 0;

  const int threads = LANE_THREADS * rank_lanes;
  const int x_rows = rank_lanes * ranks_per_warp * rank_rows;
  // bf16 x rows 16 mod 64 elements apart: a half warp's 8-byte B loads
  // (rows g, columns 4c) fall in distinct banks.
  p.x_pitch = dtype == 1 ? x_rows + (16 - x_rows % 64 + 64) % 64 : x_rows;
  const int smem =
      int8_matmul_smem(dtype, M, K, ranks, rank_rows, rank_lanes, ranks_per_warp, cluster);
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  const bool rows16 = M > 8;
  const Kernel kernel = experts > 1 ? kernel_for<true>(dtype, rows16, vec_q)
                                    : kernel_for<false>(dtype, rows16, vec_q);

  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // Blocks resident at once (G) walk tiles c, c + G, ...; a cluster takes
  // one tile, and so does a block whose expert has its own x.
  const int resident = blocks_per_sm(kernel, device, threads, smem) * sm_count();
  p.grid_clusters = cluster > 1 || tiles < resident || p.x_expert ? tiles
                    : resident < 1 ? 1 : resident;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(p.grid_clusters * cluster);
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = (cudaStream_t)stream;
  config.attrs = &attr;
  config.numAttrs = cluster > 1 ? 1 : 0;
  cudaError_t result = cudaLaunchKernelEx(&config, kernel, p);
  const cudaError_t last = cudaGetLastError();
  if (result == cudaSuccess) result = last;
  if (current != device) cudaSetDevice(current);
  return (int)result;
}

}  // extern "C"
