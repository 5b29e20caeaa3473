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
// (137 GFLOP, 0.14 ms at the card's 989 TFLOP/s in bf16) against 50 MB
// of operands (0.015 ms at 3.35 TB/s).
//
// - No host sync. The group sizes are decided on the card, so the grid
//   is sized from their static bound: a group of s rows takes ceil(s /
//   BM) row tiles, so all of them, and the zero rows past the last group,
//   take at most ceil(M / BM) + E + 1 (`row_slots` in
//   `ops/grouped_matmul.py`). Block (c, s) finds its row tile s by a
//   warp's prefix sums over group_sizes (one load a lane, shuffles), then
//   its group, its first row and the group's end; slots past the last
//   tile exit at once. Rows of a tile past its group's end are neither
//   read (zeros in shared memory) nor written, so a tile never mixes two
//   experts. Column tiles run fastest in the grid, so the blocks in
//   flight share an expert's weight in L2 and read each row tile once.
// - bf16 (`grouped_mm_bf16_kernel`): 128 x 128 tiles, K in steps of 64
//   through a 3-stage `cp.async` ring in shared memory (32 KB a stage,
//   two blocks an SM); 8 warps of 64 x 32, each k16 step 4 `ldmatrix.x4`
//   of A, 2 `ldmatrix.x4.trans` of B and 16 `mma.sync.m16n8k16` into f32.
//   Shared rows are xor-swizzled by 16-byte chunk, so the ldmatrix reads
//   are free of bank conflicts. A 128 x 128 tile asks L2 for a byte every
//   64 operations, so L2's rate, more than the tensor cores, likely sets
//   the pace (on an H100, tiles of 128 x 256 with one block an SM ran
//   slower; K steps of 64 rather than 32 ran 5-7% faster). `wgmma`, TMA
//   and cluster multicast are a later step.
// - f32 (`grouped_mm_f32_kernel`): true f32 on the FMA pipes: 128 x 128
//   tiles, K in steps of 8, A kept transposed in shared memory, two
//   buffers with the next step's loads in registers, 8 x 8 sums a thread.
// - Each output is one thread's chain in k order: two launches give the
//   same bits. Operands that are not 16-byte aligned, or N or K not a
//   multiple of 8 (bf16) or 4 (f32), are read element by element (the
//   `Vec = false` instantiations); the arithmetic is the same.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128;      // output tile
constexpr int THREADS = 256;           // 8 warps
constexpr int BK = 64, STAGES = 3;     // bf16: K step, ring depth
constexpr int A_STAGE = BM * BK * 2;   // bytes of A a stage: 16 KB
constexpr int B_STAGE = BK * BN * 2;   // bytes of B a stage: 16 KB
constexpr int SMEM_BF16 = STAGES * (A_STAGE + B_STAGE);
constexpr int FK = 8;                  // f32: K step
constexpr int A_PITCH = BM + 4;        // f32: floats between transposed A rows
constexpr unsigned FULL = 0xffffffffu;

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

// Row tile `slot` of the launch, found by warp 0 (all its lanes return the
// same): groups in chunks of 32, a lane a group, inclusive prefix sums of
// their rows and row tiles by shuffles.
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

// The block's tile in shared memory, found once. Returns false where the
// block has nothing to do (it has then written its zeros, if any).
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

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" :: "n"(N) : "memory");
}

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

template <bool Vec>
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
  // end), B rows kt * BK.. of columns col0..; four 16-byte chunks of each
  // a thread.
  auto load = [&](int slot, int kt) {
    unsigned char* a_s = smem + slot * (A_STAGE + B_STAGE);
    unsigned char* b_s = a_s + A_STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * THREADS;
      const int row = u / (BK / 8), ch = u % (BK / 8), r = tile.row0 + row, k = kt * BK + ch * 8;
      const bool in = r < tile.row_end && k < K;
      if (Vec) {
        cp_async16(a_s + a_off(row, ch), in ? x + (size_t)r * K + k : x, in ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = in && k + j < K ? x[(size_t)r * K + k + j] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(a_s + a_off(row, ch)) = *reinterpret_cast<const uint4*>(v);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int u = t + i * THREADS;
      const int row = u / 16, ch = u % 16, k = kt * BK + row, n = col0 + ch * 8;
      const bool in = k < K && n < N;
      if (Vec) {
        cp_async16(b_s + b_off(row, ch), in ? w + (size_t)k * N + n : w, in ? 16 : 0);
      } else {
        __align__(16) __nv_bfloat16 v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = in && n + j < N ? w[(size_t)k * N + n + j] : __float2bfloat16_rn(0.f);
        *reinterpret_cast<uint4*>(b_s + b_off(row, ch)) = *reinterpret_cast<const uint4*>(v);
      }
    }
  };

  // Warp (wm, wn) owns rows 64 wm .. + 63 and columns 32 wn .. + 31 of the
  // tile: 4 m16 tiles by 4 n8 tiles.
  const int wm = warp / 4, wn = warp % 4;
  float acc[4][4][4] = {};
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step kt landed; the slot of step kt - 1 is free
    if (kt + STAGES - 1 < steps) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
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
  cp_async_wait<0>();

  // D fragment: d0, d1 row g, columns 2c, 2c + 1; d2, d3 row g + 8.
  __nv_bfloat16* y = static_cast<__nv_bfloat16*>(p.y);
  const int g = lane / 4, c = lane % 4;
  const bool pairs = Vec && N % 2 == 0;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = tile.row0 + 64 * wm + 16 * mt + g + 8 * h;
      if (r >= tile.row_end) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = col0 + 32 * wn + 8 * nt + 2 * c;
        const float v0 = acc[mt][nt][2 * h], v1 = acc[mt][nt][2 * h + 1];
        if (pairs && n + 1 < N) {
          *reinterpret_cast<__nv_bfloat162*>(y + (size_t)r * N + n) = __floats2bfloat162_rn(v0, v1);
        } else {
          if (n < N) y[(size_t)r * N + n] = __float2bfloat16_rn(v0);
          if (n + 1 < N) y[(size_t)r * N + n + 1] = __float2bfloat16_rn(v1);
        }
      }
    }
}

template <bool Vec>
__global__ void __launch_bounds__(THREADS, 2) grouped_mm_f32_kernel(const __grid_constant__ Params p) {
  Tile tile;
  if (!block_tile<float>(p, tile)) return;
  __shared__ __align__(16) float a_s[2][FK][A_PITCH];  // A transposed: [k][row]
  __shared__ __align__(16) float b_s[2][FK][BN];
  const int t = threadIdx.x;
  const int col0 = blockIdx.x * BN;
  const int K = p.K, N = p.N;
  const float* x = static_cast<const float*>(p.x);
  const float* w = static_cast<const float*>(p.w) + (size_t)tile.group * K * N;
  const int steps = (K + FK - 1) / FK;

  // A: row t / 2, k 4 (t % 2) .. + 3; B: k row t / 32, columns 4 (t % 32)
  // .. + 3; both into registers a step ahead.
  const int ar = t / 2, ak = 4 * (t % 2), bk = t / 32, bn = 4 * (t % 32);
  float ra[4], rb[4];
  auto fetch = [&](int kt) {
    const int r = tile.row0 + ar, k = kt * FK + ak;
    const bool a_in = r < tile.row_end && k < K;
    if (Vec && a_in) {
      const float4 v = *reinterpret_cast<const float4*>(x + (size_t)r * K + k);
      ra[0] = v.x, ra[1] = v.y, ra[2] = v.z, ra[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) ra[j] = a_in && k + j < K ? x[(size_t)r * K + k + j] : 0.f;
    }
    const int kb = kt * FK + bk, n = col0 + bn;
    const bool b_in = kb < K && n < N;
    if (Vec && b_in) {
      const float4 v = *reinterpret_cast<const float4*>(w + (size_t)kb * N + n);
      rb[0] = v.x, rb[1] = v.y, rb[2] = v.z, rb[3] = v.w;
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) rb[j] = b_in && n + j < N ? w[(size_t)kb * N + n + j] : 0.f;
    }
  };
  auto store = [&](int buf) {
#pragma unroll
    for (int j = 0; j < 4; ++j) a_s[buf][ak + j][ar] = ra[j];
    *reinterpret_cast<float4*>(&b_s[buf][bk][bn]) = make_float4(rb[0], rb[1], rb[2], rb[3]);
  };

  // Thread (ty, tx) sums rows 4 ty .. + 3 and 64 + 4 ty .. + 3, columns
  // 4 tx .. + 3 and 64 + 4 tx .. + 3 of the tile.
  const int ty = t / 16, tx = t % 16;
  float acc[8][8] = {};
  if (steps > 0) {
    fetch(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < steps; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < steps) fetch(kt + 1);
#pragma unroll
    for (int k = 0; k < FK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&a_s[buf][k][4 * ty]);
      const float4 a1 = *reinterpret_cast<const float4*>(&a_s[buf][k][64 + 4 * ty]);
      const float4 b0 = *reinterpret_cast<const float4*>(&b_s[buf][k][4 * tx]);
      const float4 b1 = *reinterpret_cast<const float4*>(&b_s[buf][k][64 + 4 * tx]);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
    if (kt + 1 < steps) store(buf ^ 1);  // the other buffer: read last step, before the barrier
    __syncthreads();
  }

  float* y = static_cast<float*>(p.y);
  const bool quads = Vec;  // N % 4 == 0 and y 16-byte aligned
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = tile.row0 + (i < 4 ? 4 * ty + i : 64 + 4 * ty + i - 4);
    if (r >= tile.row_end) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = col0 + 64 * h + 4 * tx;
      if (quads && n + 3 < N) {
        *reinterpret_cast<float4*>(y + (size_t)r * N + n) =
            make_float4(acc[i][4 * h], acc[i][4 * h + 1], acc[i][4 * h + 2], acc[i][4 * h + 3]);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (n + j < N) y[(size_t)r * N + n + j] = acc[i][4 * h + j];
      }
    }
  }
}

using Kernel = void (*)(Params);

}  // namespace

extern "C" {

// The tile constants the kernels are built with: BM, BN, THREADS, BK,
// STAGES, FK. Returns the count written (at most cap).
int grouped_matmul_layout(int* out, int cap) {
  const int v[6] = {BM, BN, THREADS, BK, STAGES, FK};
  const int n = cap < 6 ? cap : 6;
  for (int i = 0; i < n; ++i) out[i] = v[i];
  return n;
}

// dtype: 0 = float32, 1 = bfloat16 (x, w and y). x [M, K], w [E, K, N]
// and y [M, N] contiguous; sizes [E] int32; all on CUDA device `device`
// (made current for the launch, and the previous one restored), on
// `stream`; the grid is col_tiles x row_slots blocks (`ops/grouped_matmul.py`
// sizes it: ceil(N / BN) x ceil(M / BM) + E + 1). Returns a cudaError_t:
// cudaErrorInvalidValue for what the kernels do not take (nothing is
// launched), else the launch's error.
int grouped_matmul_launch(int dtype, const void* x, const void* w, const int* sizes, void* y,
                          int M, int K, int N, int E, int col_tiles, int row_slots, int device,
                          void* stream) {
  if ((dtype != 0 && dtype != 1) || M < 1 || K < 0 || N < 1 || E < 1 || !x || !w || !sizes || !y ||
      col_tiles != (N + BN - 1) / BN || row_slots < (M + BM - 1) / BM + E + 1 ||
      row_slots > 65535)
    return (int)cudaErrorInvalidValue;
  const int size = dtype == 1 ? 2 : 4, per = 16 / size;
  const bool vec = K % per == 0 && N % per == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(w) % 16 == 0 && reinterpret_cast<uintptr_t>(y) % 16 == 0;
  Params p = {x, w, y, sizes, M, K, N, E};
  Kernel kernel;
  int smem = 0;
  if (dtype == 1) {
    kernel = vec ? &grouped_mm_bf16_kernel<true> : &grouped_mm_bf16_kernel<false>;
    smem = SMEM_BF16;
  } else {
    kernel = vec ? &grouped_mm_f32_kernel<true> : &grouped_mm_f32_kernel<false>;
  }
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  // The bf16 kernels' shared-memory opt-in, once a device and kernel.
  static unsigned opted[2];
  const int which = vec ? 1 : 0;
  if (smem && device < 32 && !(opted[which] >> device & 1u)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err == cudaSuccess) opted[which] |= 1u << device;
  } else if (smem && device >= 32) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err == cudaSuccess) {
    kernel<<<dim3(col_tiles, row_slots), THREADS, smem, (cudaStream_t)stream>>>(p);
    err = cudaGetLastError();
  }
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
