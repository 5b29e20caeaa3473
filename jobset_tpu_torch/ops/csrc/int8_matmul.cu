// Weight-only int8 product of the decode step on Hopper (sm_90a):
//
//     y[m, n] = sum_k x[m, k] * T(f32(q[k, n]) * scale[n])     (y in T)
//
// for a few rows of x (M <= 16, the decode batch), int8 q [K, N] and one
// f32 scale per output column; T is the compute dtype (bfloat16 or
// float32). It is what `jobset_tpu/models/quant.py::weight_cast` (`:82-92`)
// followed by the step's dot computes on the TPU, where XLA fuses the
// dequantization into the dot's operand read (no Pallas kernel there).
//
// Bound: bytes. At M = 8 the product does 2 * M = 16 operations for every
// int8 weight byte, against the ~300 the card's bf16 tensor cores need
// per byte of device memory before they bound it, so the time is the
// weight bytes (plus scales, x and y) over the memory rate. The kernels
// read every weight byte once, as int8, and never write it back in the
// compute dtype: eager dequantization followed by a matmul would move
// ~21 bytes per weight element. Done on the CUDA cores, the 2 * M
// operations a weight are instructions too: at M = 8, 8 FMAs and about 4
// more to dequantize, which for the unembedding's 32.8 M weights is about
// 14 us of issue on 132 SMs against 10 us for its bytes. So the bf16
// kernel, the serving path's, does its products on the tensor cores.
//
// Common design (no wgmma or TMA):
// - A block owns 32 output columns and one slice of K, with 128 threads.
//   A thread reads 16 int8 columns of a row as one 16-byte load (two
//   threads cover one 32-byte sector) and keeps several such rows in
//   flight; the first go out before x is staged, so the two latencies
//   overlap.
// - Each weight is dequantized per element exactly as weight_cast does:
//   f32(q) * scale in f32, rounded once to the compute dtype T. The
//   products with x are exact in f32 (bf16 times bf16) or f32 FMAs, and
//   are summed in f32.
// - K is split across the blocks of a thread-block cluster (1, 2, 4 or 8
//   blocks, chosen so that N = 1024 still fills the 132 SMs; a split of 1
//   launches without the cluster attribute, each block its own implicit
//   cluster of one, which measured faster than clusters of one). Partial
//   sums are reduced in a fixed order, so two runs give the same bits:
//   within a warp (below), the 4 warps in warp order through shared
//   memory, and the cluster's blocks in rank order, each reading the
//   others' shared memory (distributed shared memory). No atomics and no
//   library call.
// - A row of q that is not 16-byte aligned (N not a multiple of 16, or a
//   misaligned base) is read byte by byte instead (the `Vec = false`
//   instantiations); the arithmetic is the same.
//
// bf16 (`int8_matmul_tc_kernel`): each warp takes k16 steps of the slice
// in turn. Its 32 lanes load the step's 16 rows x 32 columns of q, write
// them dequantized to a bf16 tile in shared memory, and `ldmatrix.trans`
// hands them back as the B fragments of four mma.sync m16n8k16 (bf16 in,
// f32 sums); x's rows (up to 16, zeros past M) are the A fragment, from
// shared memory by `ldmatrix`. About 3 instructions a weight instead of
// 12.
//
// f32 (`int8_matmul_f32_kernel`): on the CUDA cores. 2 threads across N and
// 64 "K lanes" down the slice; x's rows (up to 8 a block; gridDim.z
// covers M up to 16) in shared memory as f32, up to 1024 values of K at
// a time; each thread sums its rows in K order, then the 16 K lanes of a
// warp are summed by a butterfly of shuffles (each step halves the sums
// a lane holds, so a lane ends with 8 of the warp's 256).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int MR = 8;                 // x rows a block
constexpr int VEC = 16;               // int8 columns a thread (one 16-byte load)
constexpr int NT = 2;                 // threads across N
constexpr int BN = NT * VEC;          // columns a block: 32
constexpr int KL = 64;                // K lanes a block
constexpr int THREADS = NT * KL;      // 128
constexpr int WARPS = THREADS / 32;   // 4, each 16 K lanes
constexpr int G = 4;                  // rows of q a lane has in flight
constexpr int KC = 1024;              // values of K staged from x at a time
constexpr int MAX_ROWS = 16;          // largest M (the wrapper's cut)
constexpr int MAX_SPLIT = 8;          // largest cluster (portable size)
constexpr int OUT = MR * BN;          // a block's outputs: 256
constexpr int ACC = MR * VEC;         // a thread's sums: 128

// The 16 int8 values of a 16-byte vector as exact floats, without the
// quarter-rate int-to-float conversion: byte b + 128 placed in the low
// mantissa bits of 2^23 gives the float 2^23 + b + 128, and subtracting
// 2^23 + 128 leaves b exactly.
__device__ __forceinline__ void int8x16_to_float(const uint4& v, float (&f)[16]) {
  const unsigned words[4] = {v.x ^ 0x80808080u, v.y ^ 0x80808080u, v.z ^ 0x80808080u,
                             v.w ^ 0x80808080u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    f[j] = __fadd_rn(__uint_as_float(__byte_perm(words[j / 4], 0x4B000000u, 0x7540 | (j % 4))),
                     -8388736.f);
}

// The 16 columns at src (the first `valid` of them; the rest 0) read byte
// by byte, packed as one 16-byte vector.
__device__ __forceinline__ uint4 load_bytes(const int8_t* src, int valid) {
  unsigned word[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16; ++j)
    if (j < valid) word[j / 4] |= (unsigned)(unsigned char)src[j] << (8 * (j % 4));
  return make_uint4(word[0], word[1], word[2], word[3]);
}

// Stage x's rows m0.. (zeros past M), values kc .. kc + len of K, into
// xs. All of a thread's loads in a batch are issued before any is used:
// x is read by every block, so its latency, not its bytes, is the cost.
// With `vec` (rows and the slice 16-byte aligned) a load takes 16 bytes.
__device__ __forceinline__ void stage_x(float* xs, const float* __restrict__ x, int M, int K,
                                        int m0, int kc, int len, bool vec, int t) {
  if (vec) {
    constexpr int RV = KC / 4;            // float4 vectors in a staged row
    constexpr int U = MR * RV / THREADS;  // vectors a thread stages: 16
    constexpr int B = 4;                  // of them in flight at once
#pragma unroll
    for (int u0 = 0; u0 < U; u0 += B) {
      float4 buf[B];
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int i = (u0 + u) * THREADS + t, m = i / RV, v = i % RV;
        buf[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (v * 4 < len && m0 + m < M)
          buf[u] = __ldg(reinterpret_cast<const float4*>(x + (size_t)(m0 + m) * K + kc + v * 4));
      }
#pragma unroll
      for (int u = 0; u < B; ++u) {
        const int i = (u0 + u) * THREADS + t, m = i / RV, v = i % RV;
        if (v * 4 < len) *reinterpret_cast<float4*>(xs + m * KC + v * 4) = buf[u];
      }
    }
  } else {
#pragma unroll 16
    for (int i = t; i < MR * KC; i += THREADS) {
      const int m = i / KC, c = i % KC;
      if (c < len) xs[i] = m0 + m < M ? x[(size_t)(m0 + m) * K + kc + c] : 0.f;
    }
  }
}

// Rows k, k + KL, ... (G of them, those below k_end) of this thread's
// 16 columns; zeros elsewhere.
template <bool Vec>
__device__ __forceinline__ void load_rows(uint4 (&raw)[G], const int8_t* __restrict__ q,
                                          int k, int k_end, int col0, int N) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int row = k + g * KL;
    raw[g] = make_uint4(0, 0, 0, 0);
    if (row < k_end && col0 < N) {
      const int8_t* src = q + (size_t)row * N + col0;
      raw[g] = Vec ? __ldg(reinterpret_cast<const uint4*>(src)) : load_bytes(src, N - col0);
    }
  }
}

// One step of the warp's butterfly over its 16 K lanes: the lane keeps
// HALF of its sums (the upper HALF where its lane bit OFFSET is set) and
// adds the partner's copy of them. Steps at HALF = 64, 32, 16, 8 pair
// lanes across bits 4, 3, 2, 1 (bit 0 is the thread's column group).
template <int HALF>
__device__ __forceinline__ void butterfly_step(float (&acc)[ACC], int lane, int& first) {
  constexpr int OFFSET = HALF / 4;
  const bool upper = lane & OFFSET;
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? acc[i] : acc[i + HALF];
    const float keep = upper ? acc[i + HALF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, OFFSET);
  }
  first += upper ? HALF : 0;
}

template <bool Vec>
__global__ void __launch_bounds__(THREADS)
int8_matmul_f32_kernel(const float* __restrict__ x, const int8_t* __restrict__ q,
                       const float* __restrict__ scale, float* __restrict__ y, int M, int K,
                       int N, int k_per_split, bool x_vec) {
  __shared__ float xs[MR * KC];        // x rows m0.., values kc.. of K, f32
  __shared__ float warp_sums[WARPS][OUT];
  __shared__ float block_sums[OUT];    // read by the cluster's other blocks

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int t = threadIdx.x;
  const int lane = t % 32;
  const int nv = t % NT;
  const int lane_k = t / NT;
  const int col0 = blockIdx.x * BN + nv * VEC;  // this thread's first column
  const int m0 = blockIdx.z * MR;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float sc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sc[j] = col0 + j < N ? scale[col0 + j] : 0.f;
  float acc[ACC];  // acc[m * VEC + j]: row m0 + m, column col0 + j
#pragma unroll
  for (int i = 0; i < ACC; ++i) acc[i] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += KC) {
    const int kc_end = min(k_end, kc + KC);
    uint4 cur[G];
    load_rows<Vec>(cur, q, kc + lane_k, kc_end, col0, N);  // in flight while x is staged
    __syncthreads();  // the previous chunk's x is no longer read
    stage_x(xs, x, M, K, m0, kc, kc_end - kc, x_vec, t);
    __syncthreads();

    for (int k0 = kc; k0 < kc_end; k0 += G * KL) {
      uint4 next[G];
      const bool more = k0 + G * KL < kc_end;
      if (more) load_rows<Vec>(next, q, k0 + G * KL + lane_k, kc_end, col0, N);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const int kk = k0 - kc + lane_k + g * KL;
        if (kc + kk < kc_end) {  // x is staged up to kc_end only
          float w[VEC];  // weight_cast at f32: f32(q) * scale
          int8x16_to_float(cur[g], w);
#pragma unroll
          for (int j = 0; j < VEC; ++j) w[j] = __fmul_rn(w[j], sc[j]);
#pragma unroll
          for (int m = 0; m < MR; ++m) {
            const float xv = xs[m * KC + kk];  // 0 for rows past M
#pragma unroll
            for (int j = 0; j < VEC; ++j) acc[m * VEC + j] = fmaf(xv, w[j], acc[m * VEC + j]);
          }
        }
      }
      if (more) {
#pragma unroll
        for (int g = 0; g < G; ++g) cur[g] = next[g];
      }
    }
  }

  // The warp's 16 K lanes, by the butterfly.
  int first = 0;  // index into acc of the sums this lane ends with
  butterfly_step<64>(acc, lane, first);
  butterfly_step<32>(acc, lane, first);
  butterfly_step<16>(acc, lane, first);
  butterfly_step<8>(acc, lane, first);
  // acc[0..8) are the warp's sums at acc indices first.., i.e. row
  // m = first / VEC and this thread's columns first % VEC + i.
  const int warp = t / 32;
#pragma unroll
  for (int i = 0; i < ACC / 16; ++i)
    warp_sums[warp][(first / VEC) * BN + nv * VEC + first % VEC + i] = acc[i];
  __syncthreads();
  for (int o = t; o < OUT; o += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w][o];
    block_sums[o] = s;
  }

  // The cluster's blocks in rank order, each block writing its share of
  // the outputs.
  cluster.sync();
  const int share = OUT / n_split;
  for (int o = split * share + t; o < (split + 1) * share; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < n_split; ++r) s += cluster.map_shared_rank(block_sums, r)[o];
    const int row = m0 + o / BN, col = blockIdx.x * BN + o % BN;
    if (row < M && col < N) y[(size_t)row * N + col] = s;
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores (mma.sync m16n8k16, f32 sums)
// ---------------------------------------------------------------------------

constexpr int TC_ROWS = 16;             // x rows: the mma's M; rows past M are 0
constexpr int TC_KC = 1024;             // values of K staged from x at a time
constexpr int TC_XP = TC_KC + 8;        // x row pitch (bf16): ldmatrix rows 16 B apart in banks
constexpr int TC_WP = BN + 8;           // weight tile row pitch (bf16), likewise
constexpr int TC_U = 4;                 // k16 steps of q a warp has in flight
constexpr int TC_XS_BYTES = TC_ROWS * TC_XP * 2;
constexpr int TC_WS_BYTES = WARPS * 16 * TC_WP * 2;
static_assert(WARPS * TC_ROWS * BN * 4 <= TC_XS_BYTES, "warp sums reuse x's shared memory");

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* row, bool trans) {
  if (trans)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(row)));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(row)));
}

// d += a * b: a 16x16 bf16 (rows of x), b 16x8 bf16 (a weight tile), d f32.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4], unsigned b0,
                                         unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A warp's k16 step of q: lane L holds row k + L / 2, columns
// (L % 2) * 16 .. + 15 of the block's 32 (one 32-byte sector a row).
template <bool Vec>
__device__ __forceinline__ uint4 load_step(const int8_t* __restrict__ q, int k, int k_end,
                                           int col0, int N, int lane) {
  const int row = k + lane / 2;
  if (row >= k_end || col0 >= N) return make_uint4(0, 0, 0, 0);
  const int8_t* src = q + (size_t)row * N + col0;
  return Vec ? __ldg(reinterpret_cast<const uint4*>(src)) : load_bytes(src, N - col0);
}

template <bool Vec>
__global__ void __launch_bounds__(THREADS)
int8_matmul_tc_kernel(const __nv_bfloat16* __restrict__ x, const int8_t* __restrict__ q,
                      const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M,
                      int K, int N, int k_per_split, bool x_vec) {
  __shared__ __align__(16) unsigned char smem[TC_XS_BYTES + TC_WS_BYTES];
  __shared__ float block_sums[TC_ROWS * BN];  // read by the cluster's other blocks
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [16][TC_XP]
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + TC_XS_BYTES) +
                      (threadIdx.x / 32) * 16 * TC_WP;          // this warp's [16][TC_WP]

  cg::cluster_group cluster = cg::this_cluster();
  const int split = (int)cluster.block_rank();
  const int n_split = (int)cluster.num_blocks();
  const int t = threadIdx.x, lane = t % 32, warp = t / 32;
  const int col0 = blockIdx.x * BN + (lane % 2) * VEC;  // this lane's first column
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);

  float sc[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) sc[j] = col0 + j < N ? scale[col0 + j] : 0.f;
  float acc[BN / 8][4];  // one m16n8 tile of sums for each 8 columns
#pragma unroll
  for (int i = 0; i < BN / 8; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) acc[i][r] = 0.f;

  // ldmatrix row addresses: lane L names row L % 8 of matrix L / 8.
  const int mat = lane / 8, mrow = lane % 8;
  for (int kc = k_begin; kc < k_end; kc += TC_KC) {
    const int len = min(k_end - kc, TC_KC);
    const int steps = (len + 15) / 16;
    // The warp's steps: warp, warp + WARPS, ... of this chunk. A ring of
    // TC_U is in flight: the load of step s + TC_U * WARPS is issued as
    // soon as step s's bytes are dequantized. The first TC_U go out while
    // x is staged.
    uint4 cur[TC_U];
#pragma unroll
    for (int u = 0; u < TC_U; ++u)
      cur[u] = load_step<Vec>(q, kc + 16 * (warp + u * WARPS), kc + len, col0, N, lane);
    __syncthreads();  // the previous chunk's x is no longer read
    // x rows as bf16, zeros past M and from len up to the next 16. Every
    // load of a thread is in flight before the first is stored (fixed
    // trip counts, unrolled): x's latency, not its bytes, is the cost.
    if (x_vec) {
      // Thread t stages vector t (8 values) of each row.
      static_assert(TC_KC / 8 == THREADS, "one vector of each row a thread");
      const bool live = t * 8 < len, inside = t < steps * 2;
#pragma unroll
      for (int m0 = 0; m0 < TC_ROWS; m0 += 8) {
        uint4 val[8];
#pragma unroll
        for (int m = 0; m < 8; ++m)
          val[m] = live && m0 + m < M
                       ? __ldg(reinterpret_cast<const uint4*>(x + (size_t)(m0 + m) * K + kc + t * 8))
                       : make_uint4(0, 0, 0, 0);
#pragma unroll
        for (int m = 0; m < 8; ++m)
          if (inside) *reinterpret_cast<uint4*>(xs + (m0 + m) * TC_XP + t * 8) = val[m];
      }
    } else {
#pragma unroll 16
      for (int i = t; i < TC_ROWS * TC_KC; i += THREADS) {
        const int m = i / TC_KC, c = i % TC_KC;
        if (c < steps * 16)
          xs[m * TC_XP + c] = m < M && c < len ? x[(size_t)m * K + kc + c] : __float2bfloat16(0.f);
      }
    }
    __syncthreads();

    for (int s0 = warp; s0 < steps; s0 += TC_U * WARPS) {
#pragma unroll
      for (int u = 0; u < TC_U; ++u) {
        const int s = s0 + u * WARPS;
        if (s < steps) {
          // weight_cast of the lane's 16 values, stored as its row of the
          // warp's [16 k][32 n] bf16 tile.
          float w[VEC];
          int8x16_to_float(cur[u], w);
          unsigned packed[VEC / 2];
#pragma unroll
          for (int j = 0; j < VEC; j += 2) {
            const __nv_bfloat162 pair = __floats2bfloat162_rn(__fmul_rn(w[j], sc[j]),
                                                              __fmul_rn(w[j + 1], sc[j + 1]));
            packed[j / 2] = *reinterpret_cast<const unsigned*>(&pair);
          }
          cur[u] = load_step<Vec>(q, kc + 16 * (s + TC_U * WARPS), kc + len, col0, N, lane);
          uint4* dst = reinterpret_cast<uint4*>(ws + (lane / 2) * TC_WP + (lane % 2) * VEC);
          dst[0] = make_uint4(packed[0], packed[1], packed[2], packed[3]);
          dst[1] = make_uint4(packed[4], packed[5], packed[6], packed[7]);
          __syncwarp();
          // B fragments, k-major pairs: matrices (k 0-7 | 8-15) x (n 0-7 |
          // 8-15), then the same for n 16-31.
          unsigned b[2][4];
#pragma unroll
          for (int h = 0; h < 2; ++h)
            ldmatrix_x4(b[h], ws + ((mat % 2) * 8 + mrow) * TC_WP + h * 16 + (mat / 2) * 8, true);
          // A fragment: rows (0-7 | 8-15) x k (0-7 | 8-15) of x.
          unsigned a[4];
          ldmatrix_x4(a, xs + ((mat % 2) * 8 + mrow) * TC_XP + 16 * s + (mat / 2) * 8, false);
#pragma unroll
          for (int i = 0; i < BN / 8; ++i)
            mma_bf16(acc[i], a, b[i / 2][(i % 2) * 2], b[i / 2][(i % 2) * 2 + 1]);
          __syncwarp();  // the tile is read before the next step writes it
        }
      }
    }
  }

  // The block's sums: warps in warp order through shared memory (x's).
  __syncthreads();
  float* warp_sums = reinterpret_cast<float*>(smem);  // [WARPS][16 * BN]
  const int g = lane / 4, c = lane % 4;
#pragma unroll
  for (int i = 0; i < BN / 8; ++i) {
    float* w = warp_sums + warp * TC_ROWS * BN;
    w[g * BN + 8 * i + 2 * c] = acc[i][0];
    w[g * BN + 8 * i + 2 * c + 1] = acc[i][1];
    w[(g + 8) * BN + 8 * i + 2 * c] = acc[i][2];
    w[(g + 8) * BN + 8 * i + 2 * c + 1] = acc[i][3];
  }
  __syncthreads();
  for (int o = t; o < TC_ROWS * BN; o += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += warp_sums[w * TC_ROWS * BN + o];
    block_sums[o] = s;
  }

  // The cluster's blocks in rank order, each block writing its share.
  cluster.sync();
  const int share = TC_ROWS * BN / n_split;
  for (int o = split * share + t; o < (split + 1) * share; o += THREADS) {
    float s = 0.f;
    for (int r = 0; r < n_split; ++r) s += cluster.map_shared_rank(block_sums, r)[o];
    const int row = o / BN, col = blockIdx.x * BN + o % BN;
    if (row < M && col < N) y[(size_t)row * N + col] = __float2bfloat16_rn(s);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
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

// Launch `kernel` on a (N / 32, split, z) grid, the split blocks of a
// column tile as one cluster. x_vec: x's rows and every block's slice of
// K start 16-byte aligned.
template <typename T>
cudaError_t launch(void (*kernel)(const T*, const int8_t*, const float*, T*, int, int, int,
                                  int, bool),
                   int z, const void* x, const void* q, const float* scale, void* y, int M,
                   int K, int N, int split, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = split;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((N + BN - 1) / BN, split, z);
  config.blockDim = dim3(THREADS);
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = split > 1 ? 1 : 0;
  const int k_per_split = (K + split - 1) / split;
  constexpr int E = 16 / sizeof(T);  // values of x in 16 bytes
  const bool x_vec = K % E == 0 && k_per_split % E == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
  const cudaError_t err =
      cudaLaunchKernelEx(&config, kernel, static_cast<const T*>(x), static_cast<const int8_t*>(q),
                         scale, static_cast<T*>(y), M, K, N, k_per_split, x_vec);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

// The cluster size for a product: the fewest blocks that fill the card's
// SMs, at most 8, and at least 64 rows of K a block.
int split_for(int K, int N) {
  const int tiles = (N + BN - 1) / BN;
  int split = 1;
  while (split < MAX_SPLIT && tiles * split < sm_count() && K >= 2 * split * KL) split *= 2;
  return split;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (x and y). x [M, K] and y [M, N]
// contiguous, q [K, N] int8 contiguous, scale [N] f32, all on CUDA device
// `device`, which is made current for the launch (and the previous one
// restored), and `stream` one of its streams. Returns a cudaError_t:
// cudaErrorInvalidValue for shapes the kernel does not take (nothing is
// launched), else the launch's error.
int int8_matmul_launch(int dtype, const void* x, const void* q, const void* scale, void* y,
                       int M, int K, int N, int device, void* stream) {
  if (M < 1 || M > MAX_ROWS || K < 1 || N < 1 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  int current = device;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const bool vec = N % VEC == 0 && reinterpret_cast<uintptr_t>(q) % 16 == 0;
  const int split = split_for(K, N);
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    err = launch(vec ? &int8_matmul_tc_kernel<true> : &int8_matmul_tc_kernel<false>, 1, x, q,
                 s, y, M, K, N, split, st);
  else
    err = launch(vec ? &int8_matmul_f32_kernel<true> : &int8_matmul_f32_kernel<false>,
                 (M + MR - 1) / MR, x, q, s, y, M, K, N, split, st);
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // extern "C"
