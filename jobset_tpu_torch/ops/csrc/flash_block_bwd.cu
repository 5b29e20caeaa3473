// The flash block step's backward for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the backward half of the Pallas kernel's custom_vjp pair: the JAX
// package's `_bwd` (jobset_tpu/ops/flash_block.py:483-553), registered for
// `block_attention` beside the forward kernel `_flash_block_kernel` (:194).
// For the forward's (q, k, v, bias), its saved block max m and the
// cotangents of (block_sum, weighted) it computes, per (batch, head):
//
//   S  = (Q.K^T) * D^-1/2 + bias          products in the input dtype, f32 sums
//   P  = exp(S - m), 0 on a row with m <= NEG_INF/2
//   dP = dW.V^T + dsum                    dW rounded to the input dtype first
//   dS = P * dP                           f32
//   dV = P^T.dW,  dK = dS^T.Q * D^-1/2,  dQ = dS.K * D^-1/2   (P and dS rounded
//   to the input dtype as operands), dbias = sum over (batch, head) of dS.
//
// No cotangent flows through the block max: (max, sum, weighted) is a gauge
// that every consumer is invariant to. The forward's own max is used, so P is
// the forward kernel's P up to the exponential's rounding.
//
// What bounds it. At the flagship block (bf16, B=8, H=16, Tq=Tk=1024, D=64,
// causal triangle: 136 of 256 64x64 tiles live) the function's five products
// are 45.6 GFLOP, 46 us at 989 TFLOP/s, and it must read q, k, v (50.3 MB),
// dW f32 (33.6 MB), m and dsum (1.0 MB) and write dq, dk, dv (50.3 MB): 135
// MB, 40 us at 3.35 TB/s. So it is bound by operations, on the tensor cores.
// The torch code it replaces wrote the [B, H, Tq, Tk] probabilities and
// their gradient to device memory (512 MB each at the flagship).
//
// Design: two passes, neither of which writes anything [Tq, Tk]-sized, and
// neither of which adds into another block's output, so the same inputs give
// the same bits on every run (dbias, which no training path asks for, is the
// exception: f32 atomicAdd).
// - The dK/dV pass: one block per (batch*head, 64-row kv tile); K and V of
//   the tile stay in shared memory, and the block walks the q tiles whose
//   tile class at (q tile, kv tile) is not MASKED, recomputing S^T and dP^T
//   and adding P^T.dW and dS^T.Q into dK and dV accumulators in registers.
// - The dQ pass: one block per (batch*head, 64-row q tile); Q, dW, m and
//   dsum of the tile are resident, and the block walks the live kv tiles,
//   recomputing S, P, dP and dS and adding dS.K into dQ (and dS into dbias).
// Together they do seven products where the function needs five; what that
// buys is no atomics and no [Tq, Tk] scratch. Each block has four warps of
// 16 rows; the products run on mma.sync: bf16 as m16n8k16 with f32 sums, f32
// as 3xTF32 on m16n8k8 (each operand split into two TF32 values, three
// products summed in f32: an accuracy on a par with f32, as in the forward's
// f32 kernel). P and dS never leave the registers: the accumulator fragment
// of S (and of dP) is the A fragment of the next product (the forward
// kernels' trick), so only the B operands are read from shared memory.
// Tiles arrive by cp.async (16-byte copies where a view allows) into two
// buffers: the next live tile's copies run while this one's products do,
// so a block waits on memory once, not once a tile (a first build that
// waited each tile ran at 8% of the bound). dW is staged as f32 and rounded
// to the compute dtype in shared memory. Tile classes are the forward's: a
// MASKED tile is skipped (no load, no product: it adds P = 0), a ZERO_BIAS
// tile reads no bias, a BIAS tile reads its bias from global memory (L2).
// Ragged Tq, Tk and D < 32, 64 or 128 are zero-filled loads, with P forced to
// 0 past Tk and m treated as masked past Tq. Every block writes its whole
// tile of outputs, so a tile with nothing live is written as zeros.
//
// Operands are read in place from [B, T, H, D] with element strides (k and v
// as [B, T, H_kv, group, D]: query head h reads kv head h / group), so GQA
// expand views and fused-QKV views go in without a copy; dk and dv are
// written per query head, [B, Tk, H, D], and the caller sums the group axis.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;      // rows of a q tile and of a kv tile (and of one class)
constexpr int THREADS = 128;  // four warps, 16 rows of the block's own tile each
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr unsigned char CLASS_MASKED = 0, CLASS_ZERO = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const unsigned char* classes;  // [n_qt, n_kt]
  const float* block_max;        // [B, H, Tq], the forward's
  const float* dsum;             // [B, H, Tq]
  const float* dw;               // [B, Tq, H, D] f32, contiguous
  void* dq;                      // [B, Tq, H, D] in the input dtype, or null
  void* dk;                      // [B, Tk, H, D], or null
  void* dv;                      // [B, Tk, H, D], or null
  float* dbias;                  // [Tq, Tk] f32, zeroed, or null
  int B, H, Tq, Tk, D, group, n_qt, n_kt;
  float scale;
  long long q_sb, q_st, q_sh, q_sd;
  long long k_sb, k_st, k_sh, k_sg, k_sd;
  long long v_sb, v_st, v_sh, v_sg, v_sd;
  long long bias_sq, bias_sk;
  // The operand's tiles go by 16-byte copies (unit stride on D, 16-byte
  // aligned base and row strides), else element by element.
  int vec_q, vec_k, vec_v, vec_dw;
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Fragments. Lane = 4g + t. The accumulator of an m16n8 product holds (row g,
// col 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A k step covers KSTEP
// columns of A (rows of B): 16 for bf16 (m16n8k16), 8 for f32 (m16n8k8).
// For f32 the step's logical k = t and t + 4 are read as physical 2t and
// 2t + 1 (the sum over k does not care, as long as A and B agree), so both
// dtypes take A as pairs of adjacent columns and B as pairs of adjacent rows,
// and the accumulator of n8 tiles (2j, 2j + 1) for bf16, or j for f32, is
// the A fragment of k step j. bf16 fragments come from shared memory by
// ldmatrix (.trans where B's pairs run down X's columns), f32 ones by plain
// loads. Rows are DP + 8 elements apart, so the 8 rows of one ldmatrix
// phase land on 8 distinct 16-byte bank groups.
// ---------------------------------------------------------------------------

template <typename T>
struct Mma;

template <>
struct Mma<bf16> {
  static constexpr int KSTEP = 16;
  static constexpr int PAD = 8;  // elements a row: rows 16 bytes apart mod 128, no bank conflicts
  using Frag = uint32_t;         // two bf16
};

template <>
struct Mma<float> {
  static constexpr int KSTEP = 8;
  static constexpr int PAD = 8;
  using Frag = float;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)) : "memory");
}

// A fragment of rows r16..r16+15 and k columns k0.. of a row-major tile.
// bf16: one ldmatrix.x4, lanes 8i..8i+7 naming the rows of 8x8 matrix i
// (rows +8 for odd i, columns +8 for i >= 2), whose fragments are a0..a3.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* s, int ld, int r16, int k0,
                                       int lane) {
  const int i = lane / 8;
  ldsm_x4(a, s + (r16 + (i & 1) * 8 + lane % 8) * ld + k0 + (i >> 1) * 8);
}

__device__ __forceinline__ void frag_a(float (&a)[4], const float* s, int ld, int r16, int k0,
                                       int lane) {
  const float* p = s + (r16 + lane / 4) * ld + k0 + 2 * (lane % 4);
  const float2 lo = *reinterpret_cast<const float2*>(p);
  const float2 hi = *reinterpret_cast<const float2*>(p + 8 * ld);
  a[0] = lo.x;
  a[1] = hi.x;
  a[2] = lo.y;
  a[3] = hi.y;
}

// B fragments of A.X^T for the n8 tiles n0 and n0 + 8: B[k][n] = X[n][k],
// X's rows n0..n0+15. bf16: one ldmatrix.x4 (matrix i: rows +8 for i >= 2,
// columns +8 for odd i).
__device__ __forceinline__ void frag_bt2(uint32_t (&b)[2][2], const bf16* s, int ld, int n0,
                                         int k0, int lane) {
  const int i = lane / 8;
  uint32_t r[4];
  ldsm_x4(r, s + (n0 + (i >> 1) * 8 + lane % 8) * ld + k0 + (i & 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

__device__ __forceinline__ void frag_bt2(float (&b)[2][2], const float* s, int ld, int n0, int k0,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float2 x = *reinterpret_cast<const float2*>(s + (n0 + 8 * h + lane / 4) * ld + k0 +
                                                      2 * (lane % 4));
    b[h][0] = x.x;
    b[h][1] = x.y;
  }
}

// B fragments of A.X for the n8 tiles n0 and n0 + 8: B[k][n] = X[k][n],
// X's columns n0..n0+15. bf16: one ldmatrix.x4.trans (matrix i: rows +8 for
// odd i, columns +8 for i >= 2), which hands each lane the column pairs the
// fragment wants.
__device__ __forceinline__ void frag_bn2(uint32_t (&b)[2][2], const bf16* s, int ld, int n0,
                                         int k0, int lane) {
  const int i = lane / 8;
  uint32_t r[4];
  ldsm_x4_trans(r, s + (k0 + (i & 1) * 8 + lane % 8) * ld + n0 + (i >> 1) * 8);
  b[0][0] = r[0];
  b[0][1] = r[1];
  b[1][0] = r[2];
  b[1][1] = r[3];
}

__device__ __forceinline__ void frag_bn2(float (&b)[2][2], const float* s, int ld, int n0, int k0,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* p = s + (k0 + 2 * (lane % 4)) * ld + n0 + 8 * h + lane / 4;
    b[h][0] = p[0];
    b[h][1] = p[ld];
  }
}

// A fragment of k step j from the accumulators c of a product's n8 tiles,
// rounded to the compute dtype (bf16: to nearest even; f32: as is).
__device__ __forceinline__ void frag_c(uint32_t (&a)[4], const float (*c)[4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

__device__ __forceinline__ void frag_c(float (&a)[4], const float (*c)[4], int j) {
  a[0] = c[j][0];
  a[1] = c[j][2];
  a[2] = c[j][1];
  a[3] = c[j][3];
}

// d += A.B: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = big + small, each a TF32 value (big rounded to nearest, ties away, as
// cvt.rna.tf32.f32), |x - big - small| <= 2^-22 |x| (the forward's split).
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

// d += A.B in f32 as 3xTF32: the two cross terms, then big.big; small.small
// (below 2^-22 of the product) is dropped.
__device__ __forceinline__ void mma(float (&d)[4], const float (&a)[4], const float (&b)[2]) {
  uint32_t ab[4], as[4], bb[2], bs[2];
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(a[e], ab[e], as[e]);
#pragma unroll
  for (int e = 0; e < 2; ++e) split_tf32(b[e], bb[e], bs[e]);
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

// ---------------------------------------------------------------------------
// Loads into shared memory
// ---------------------------------------------------------------------------

// Start copying a [TILE][DP] tile of T into shared memory (row stride LD):
// element (r, c) from base[r * srow + c * scol] for r < rows and c < cols,
// zero elsewhere. `vec`: unit stride on columns, 16-byte aligned base and
// row stride, so 16-byte copies, the tail of a row zero-filled by the copy's
// source size; otherwise element by element (4-byte copies for f32, plain
// loads for bf16). The caller waits (cp_async_wait_all) and synchronizes.
template <typename T, int DP, int LD>
__device__ __forceinline__ void load_tile(T* dst, const T* base, int rows, int cols,
                                          long long srow, long long scol, bool vec) {
  constexpr int EPC = 16 / sizeof(T);  // elements a 16-byte copy
  if (vec) {
    constexpr int CH = DP / EPC, RSTEP = THREADS / CH;
    static_assert(THREADS % CH == 0, "a thread keeps its columns");
    const int c = EPC * (threadIdx.x % CH), r0 = threadIdx.x / CH;
    const int bytes = (int)sizeof(T) * max(0, min(cols - c, EPC));
#pragma unroll
    for (int i = 0; i < TILE / RSTEP; ++i) {
      const int r = r0 + i * RSTEP;
      // A copy of 0 bytes reads nothing: its source may lie past the tensor.
      cp_async16(dst + r * LD + c, base + (r < rows ? (long long)r * srow + c : 0),
                 r < rows ? bytes : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * DP; i += THREADS) {
      const int r = i / DP, c = i % DP;
      const bool in = r < rows && c < cols;
      if constexpr (sizeof(T) == 4) {
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
                     :: "r"(smem_u32(dst + r * LD + c)),
                        "l"(in ? base + r * srow + c * scol : base), "r"(in ? 4 : 0)
                     : "memory");
      } else {
        dst[r * LD + c] = in ? base[r * srow + c * scol] : __float2bfloat16_rn(0.f);
      }
    }
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

// Start copying dW's [TILE][DP] f32 tile (rows of stride srow, unit column
// stride) into shared memory at `dst`, row stride LDF floats: the T tile
// itself for f32, a staging tile for bf16 (`round_dw` rounds it once it
// has landed).
template <int DP, int LDF>
__device__ __forceinline__ void load_dw(float* dst, const float* base, int rows, int cols,
                                        long long srow, bool vec) {
  load_tile<float, DP, LDF>(dst, base, rows, cols, srow, 1, vec);
}

// The staged f32 dW tile (row stride LDF) rounded to bf16 to nearest even
// (the reference's dweighted.astype(q.dtype)) into dst (row stride LD).
template <int DP, int LDF, int LD>
__device__ __forceinline__ void round_dw(bf16* dst, const float* src) {
  constexpr int CH = DP / 4, RSTEP = THREADS / CH;
  const int c = 4 * (threadIdx.x % CH), r0 = threadIdx.x / CH;
#pragma unroll
  for (int i = 0; i < TILE / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    const float4 x = *reinterpret_cast<const float4*>(src + r * LDF + c);
    *reinterpret_cast<uint2*>(dst + r * LD + c) =
        make_uint2(pack_bf16(x.x, x.y), pack_bf16(x.z, x.w));
  }
}

// The base-2 max of a q row as the passes use it: +inf on a fully masked
// row (or a row past Tq), so that every P of the row is exp2(-inf) = 0.
__device__ __forceinline__ float row_max2(float m, bool in) {
  return in && m > 0.5f * NEG_INF ? m * LOG2E : INFINITY;
}

// Store a warp's [16][DP] accumulator (rows r0 and r0 + 8 of this thread),
// times `mul`, as T into out[row * row_stride + col] for row < rows, col < D.
template <typename T, int ON>
__device__ __forceinline__ void store_rows(T* out, long long row_stride, const float (&acc)[ON][4],
                                           float mul, int r0, int rows, int D, int t) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + 8 * r;
    if (row >= rows) continue;
    T* dst = out + row * row_stride;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int col = n * 8 + 2 * t;
      const float lo = acc[n][2 * r] * mul, hi = acc[n][2 * r + 1] * mul;
      if constexpr (sizeof(T) == 4) {
        if (D % 2 == 0 && col + 1 < D) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(lo, hi);
        } else {
          if (col < D) dst[col] = lo;
          if (col + 1 < D) dst[col + 1] = hi;
        }
      } else {
        if (D % 2 == 0 && col + 1 < D) {
          *reinterpret_cast<uint32_t*>(dst + col) = pack_bf16(lo, hi);
        } else {
          if (col < D) dst[col] = __float2bfloat16_rn(lo);
          if (col + 1 < D) dst[col + 1] = __float2bfloat16_rn(hi);
        }
      }
    }
  }
}

__device__ __forceinline__ int next_live_tile(const unsigned char* cls, int i, int n) {
  while (i < n && cls[i] == CLASS_MASKED) ++i;
  return i;
}

template <typename T, int DP>
struct Config {
  static constexpr int LD = DP + Mma<T>::PAD;
  static constexpr int LDF = DP + 4;  // a staged f32 dW row: 16-byte aligned
  static constexpr int TILE_BYTES = TILE * LD * (int)sizeof(T);
  static constexpr int STAGE_BYTES = sizeof(T) == 2 ? TILE * LDF * 4 : 0;
  // dK/dV pass: K, V, two buffers of Q and of dW, bf16's dW staging tile,
  // two buffers of the q tile's maxes and dsums, the block's column of
  // tile classes.
  static int dkdv_smem_bytes(int n_qt) { return 6 * TILE_BYTES + STAGE_BYTES + 4 * TILE * 4 + n_qt; }
  // dQ pass: Q, dW, two buffers of K and V (bf16 stages dW in the second),
  // the block's row of tile classes.
  static int dq_smem_bytes(int n_kt) { return 6 * TILE_BYTES + n_kt; }
  static_assert(STAGE_BYTES <= 2 * TILE_BYTES, "dW's staging tile fits a K/V buffer");
  // bf16 at DP <= 64 is sized for three blocks an SM (168 registers; the
  // dK/dV pass spills a few bytes under that cap and still ran faster on
  // the card than at two blocks and 243 registers).
  static constexpr int MIN_BLOCKS = sizeof(T) == 2 && DP <= 64 ? 3 : 1;
};

// ---------------------------------------------------------------------------
// The dK/dV pass. Grid (B*H, kv tiles). Warp w owns kv rows 16w..16w+15 of
// the block's kv tile; every product here is over those rows:
// S^T = K.Q^T and dP^T = V.dW^T ([16 kv][64 q] a warp), then
// dV += P^T.dW and dK += dS^T.Q ([16 kv][DP]). The next live q tile's Q,
// dW, maxes and dsums are copied into the other buffer while this one's
// products run.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, Config<T, DP>::MIN_BLOCKS)
    flash_bwd_dkdv_kernel(const __grid_constant__ Params p) {
  using Cfg = Config<T, DP>;
  using F = typename Mma<T>::Frag;
  constexpr int LD = Cfg::LD, LDF = Cfg::LDF, KSTEP = Mma<T>::KSTEP;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int SN = TILE / 8;  // n8 tiles of S^T (q columns)
  constexpr int ON = DP / 8;    // n8 tiles of dK, dV (head-dim columns)

  extern __shared__ __align__(16) unsigned char smem[];
  T* k_s = reinterpret_cast<T*>(smem);
  T* v_s = k_s + TILE * LD;
  T* q_s = v_s + TILE * LD;       // [2][TILE][LD]
  T* dw_s = q_s + 2 * TILE * LD;  // [2][TILE][LD]
  float* stage = reinterpret_cast<float*>(dw_s + 2 * TILE * LD);  // bf16: dW as f32
  float* m_s = stage + Cfg::STAGE_BYTES / 4;                       // [2][TILE]
  float* ds_s = m_s + 2 * TILE;                                    // [2][TILE]
  unsigned char* cls = reinterpret_cast<unsigned char*>(ds_s + 2 * TILE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const int hk = h / p.group, hg = h % p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;
  const float* dw = p.dw + ((long long)b * p.Tq * p.H + h) * p.D;
  const long long dw_st = (long long)p.H * p.D;
  const float* bmax = p.block_max + (long long)bh * p.Tq;
  const float* dsum = p.dsum + (long long)bh * p.Tq;

  // Start the copies of q tile `qt` into buffer `buf`.
  auto load_q_tile = [&](int qt, int buf) {
    const int q0 = qt * TILE;
    load_tile<T, DP, LD>(q_s + buf * TILE * LD, q + (long long)q0 * p.q_st, p.Tq - q0, p.D,
                         p.q_st, p.q_sd, p.vec_q);
    if constexpr (BF16)
      load_dw<DP, LDF>(stage, dw + q0 * dw_st, p.Tq - q0, p.D, dw_st, p.vec_dw);
    else
      load_dw<DP, LD>(dw_s + buf * TILE * LD, dw + q0 * dw_st, p.Tq - q0, p.D, dw_st, p.vec_dw);
    if (threadIdx.x < TILE) {
      const int row = min(q0 + (int)threadIdx.x, p.Tq - 1), bytes = q0 + threadIdx.x < p.Tq ? 4 : 0;
      cp_async4(m_s + buf * TILE + threadIdx.x, bmax + row, bytes);
      cp_async4(ds_s + buf * TILE + threadIdx.x, dsum + row, bytes);
    }
    cp_async_commit();
  };

  for (int i = threadIdx.x; i < p.n_qt; i += THREADS) cls[i] = p.classes[(long long)i * p.n_kt + kt];
  load_tile<T, DP, LD>(k_s, k + (long long)k0 * p.k_st, p.Tk - k0, p.D, p.k_st, p.k_sd, p.vec_k);
  load_tile<T, DP, LD>(v_s, v + (long long)k0 * p.v_st, p.Tk - k0, p.D, p.v_st, p.v_sd, p.vec_v);
  __syncthreads();  // the classes
  int qt = next_live_tile(cls, 0, p.n_qt);
  if (qt < p.n_qt) load_q_tile(qt, 0);
  else cp_async_commit();

  const int row0 = warp * 16 + g;  // this thread's kv rows in the tile: row0, row0 + 8
  const bool row_in[2] = {k0 + row0 < p.Tk, k0 + row0 + 8 < p.Tk};
  const float scale2 = p.scale * LOG2E;
  float dk[ON][4], dv[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int i = 0; qt < p.n_qt; ++i) {
    const int buf = i & 1, q0 = qt * TILE;
    const unsigned char c = cls[qt];
    const T* qb = q_s + buf * TILE * LD;
    const T* dwb = dw_s + buf * TILE * LD;
    float* mb = m_s + buf * TILE;
    float* dsb = ds_s + buf * TILE;
    cp_async_wait_all();
    __syncthreads();  // q tile qt has landed; every warp is done with the other buffer
    if constexpr (BF16) round_dw<DP, LDF, LD>(dw_s + buf * TILE * LD, stage);
    if (threadIdx.x < TILE) {
      const bool in = q0 + threadIdx.x < p.Tq;
      mb[threadIdx.x] = row_max2(mb[threadIdx.x], in);
      if (!in) dsb[threadIdx.x] = 0.f;
    }
    __syncthreads();  // dW rounded (the staging tile is free), the maxes in base 2
    const int next = next_live_tile(cls, qt + 1, p.n_qt);
    if (next < p.n_qt) load_q_tile(next, buf ^ 1);

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / KSTEP; ++ks) {
      F a[4], a2[4];
      frag_a(a, k_s, LD, warp * 16, ks * KSTEP, lane);
      frag_a(a2, v_s, LD, warp * 16, ks * KSTEP, lane);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        F bq[2][2], bw[2][2];
        frag_bt2(bq, qb, LD, n * 8, ks * KSTEP, lane);
        frag_bt2(bw, dwb, LD, n * 8, ks * KSTEP, lane);
        mma(s[n], a, bq[0]);
        mma(s[n + 1], a, bq[1]);
        mma(dp[n], a2, bw[0]);
        mma(dp[n + 1], a2, bw[1]);
      }
    }

    // P^T and dS^T in place of S^T and dP^T. Entry e of n8 tile n: kv row
    // row0 + 8 (e >> 1), q column 8n + 2t + (e & 1).
#pragma unroll
    for (int n = 0; n < SN; ++n) {
      const float2 mc = *reinterpret_cast<const float2*>(mb + n * 8 + 2 * t);
      const float2 dc = *reinterpret_cast<const float2*>(dsb + n * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale2;
        if (c != CLASS_ZERO) {
          const int qr = min(q0 + col, p.Tq - 1), kr = min(k0 + row0 + 8 * (e >> 1), p.Tk - 1);
          x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
        }
        const float pr = row_in[e >> 1] ? fast_exp2(x - (e & 1 ? mc.y : mc.x)) : 0.f;
        s[n][e] = pr;
        dp[n][e] = pr * (dp[n][e] + (e & 1 ? dc.y : dc.x));
      }
    }

#pragma unroll
    for (int j = 0; j < TILE / KSTEP; ++j) {
      F ap[4], ad[4];
      frag_c(ap, s, j);
      frag_c(ad, dp, j);
#pragma unroll
      for (int n = 0; n < ON; n += 2) {
        F bw[2][2], bq[2][2];
        frag_bn2(bw, dwb, LD, n * 8, j * KSTEP, lane);
        frag_bn2(bq, qb, LD, n * 8, j * KSTEP, lane);
        mma(dv[n], ap, bw[0]);
        mma(dv[n + 1], ap, bw[1]);
        mma(dk[n], ad, bq[0]);
        mma(dk[n + 1], ad, bq[1]);
      }
    }
    qt = next;
  }

  cp_async_wait_all();  // with no live q tile, K and V's copies are still outstanding
  const long long out = ((long long)b * p.Tk + k0) * p.H + h;  // row k0 of this head
  const long long stride = (long long)p.H * p.D;
  if (p.dk != nullptr)
    store_rows<T, ON>(static_cast<T*>(p.dk) + out * p.D, stride, dk, p.scale, row0, p.Tk - k0,
                      p.D, t);
  if (p.dv != nullptr)
    store_rows<T, ON>(static_cast<T*>(p.dv) + out * p.D, stride, dv, 1.f, row0, p.Tk - k0, p.D,
                      t);
}

// ---------------------------------------------------------------------------
// The dQ pass. Grid (B*H, q tiles), the q tiles with the most live kv tiles
// under a causal mask first. Warp w owns q rows 16w..16w+15 of the block's
// q tile: S = Q.K^T and dP = dW.V^T ([16 q][64 kv] a warp), dQ += dS.K.
// The next live kv tile's K and V are copied into the other buffer while
// this one's products run.
// ---------------------------------------------------------------------------
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS, Config<T, DP>::MIN_BLOCKS)
    flash_bwd_dq_kernel(const __grid_constant__ Params p) {
  using Cfg = Config<T, DP>;
  using F = typename Mma<T>::Frag;
  constexpr int LD = Cfg::LD, LDF = Cfg::LDF, KSTEP = Mma<T>::KSTEP;
  constexpr bool BF16 = sizeof(T) == 2;
  constexpr int SN = TILE / 8;  // n8 tiles of S (kv columns)
  constexpr int ON = DP / 8;    // n8 tiles of dQ

  extern __shared__ __align__(16) unsigned char smem[];
  T* q_s = reinterpret_cast<T*>(smem);
  T* dw_s = q_s + TILE * LD;
  T* kv_s = dw_s + TILE * LD;  // [2][K, V][TILE][LD]
  unsigned char* cls = reinterpret_cast<unsigned char*>(kv_s + 4 * TILE * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  const int hk = h / p.group, hg = h % p.group;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;
  const long long dw_st = (long long)p.H * p.D;
  const float* dw = p.dw + ((long long)b * p.Tq * p.H + h) * p.D;

  // Start the copies of kv tile `kt` into buffer `buf`.
  auto load_kv_tile = [&](int kt, int buf) {
    const int k0 = kt * TILE;
    T* dst = kv_s + buf * 2 * TILE * LD;
    load_tile<T, DP, LD>(dst, k + (long long)k0 * p.k_st, p.Tk - k0, p.D, p.k_st, p.k_sd,
                         p.vec_k);
    load_tile<T, DP, LD>(dst + TILE * LD, v + (long long)k0 * p.v_st, p.Tk - k0, p.D, p.v_st,
                         p.v_sd, p.vec_v);
    cp_async_commit();
  };

  // Q and dW (bf16 stages dW as f32 in the second K/V buffer), the classes
  // of this q tile's row and the first live kv tile.
  load_tile<T, DP, LD>(q_s, q + (long long)q0 * p.q_st, p.Tq - q0, p.D, p.q_st, p.q_sd, p.vec_q);
  float* stage = BF16 ? reinterpret_cast<float*>(kv_s + 2 * TILE * LD)
                      : reinterpret_cast<float*>(dw_s);
  load_dw<DP, BF16 ? LDF : LD>(stage, dw + q0 * dw_st, p.Tq - q0, p.D, dw_st, p.vec_dw);
  for (int j = threadIdx.x; j < p.n_kt; j += THREADS) cls[j] = p.classes[(long long)qt * p.n_kt + j];
  __syncthreads();  // the classes
  int kt = next_live_tile(cls, 0, p.n_kt);
  if (kt < p.n_kt) load_kv_tile(kt, 0);
  else cp_async_commit();

  const int row0 = warp * 16 + g;  // this thread's q rows in the tile: row0, row0 + 8
  float m2[2], ds[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long at = (long long)bh * p.Tq + min(row, p.Tq - 1);
    m2[r] = row_max2(p.block_max[at], row < p.Tq);
    ds[r] = row < p.Tq ? p.dsum[at] : 0.f;
  }
  const float scale2 = p.scale * LOG2E;
  float dq[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;

  cp_async_wait_all();
  __syncthreads();  // Q, dW and the first kv tile have landed
  if constexpr (BF16) {
    round_dw<DP, LDF, LD>(dw_s, stage);
    __syncthreads();  // dW rounded: the second K/V buffer is free
  }

  for (int i = 0; kt < p.n_kt; ++i) {
    const int buf = i & 1, k0 = kt * TILE;
    const unsigned char c = cls[kt];
    const T* kb = kv_s + buf * 2 * TILE * LD;
    const T* vb = kb + TILE * LD;
    if (i > 0) {
      cp_async_wait_all();
      __syncthreads();  // kv tile kt has landed; every warp is done with the other buffer
    }
    const int next = next_live_tile(cls, kt + 1, p.n_kt);
    if (next < p.n_kt) load_kv_tile(next, buf ^ 1);

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / KSTEP; ++ks) {
      F a[4], a2[4];
      frag_a(a, q_s, LD, warp * 16, ks * KSTEP, lane);
      frag_a(a2, dw_s, LD, warp * 16, ks * KSTEP, lane);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        F bk[2][2], bv[2][2];
        frag_bt2(bk, kb, LD, n * 8, ks * KSTEP, lane);
        frag_bt2(bv, vb, LD, n * 8, ks * KSTEP, lane);
        mma(s[n], a, bk[0]);
        mma(s[n + 1], a, bk[1]);
        mma(dp[n], a2, bv[0]);
        mma(dp[n + 1], a2, bv[1]);
      }
    }

    // dS in place of dP. Entry e of n8 tile n: q row row0 + 8 (e >> 1), kv
    // column 8n + 2t + (e & 1).
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale2;
        if (c != CLASS_ZERO) {
          const int qr = min(q0 + row0 + 8 * r, p.Tq - 1), kr = min(col, p.Tk - 1);
          x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
        }
        const float pr = col < p.Tk ? fast_exp2(x - m2[r]) : 0.f;
        dp[n][e] = pr * (dp[n][e] + ds[r]);
        if (p.dbias != nullptr && col < p.Tk && q0 + row0 + 8 * r < p.Tq)
          atomicAdd(p.dbias + (long long)(q0 + row0 + 8 * r) * p.Tk + col, dp[n][e]);
      }

#pragma unroll
    for (int j = 0; j < TILE / KSTEP; ++j) {
      F ad[4];
      frag_c(ad, dp, j);
#pragma unroll
      for (int n = 0; n < ON; n += 2) {
        F bk[2][2];
        frag_bn2(bk, kb, LD, n * 8, j * KSTEP, lane);
        mma(dq[n], ad, bk[0]);
        mma(dq[n + 1], ad, bk[1]);
      }
    }
    kt = next;
  }

  if (p.dq != nullptr) {
    const long long out = ((long long)b * p.Tq + q0) * p.H + h;  // row q0 of this head
    store_rows<T, ON>(static_cast<T*>(p.dq) + out * p.D, (long long)p.H * p.D, dq, p.scale, row0,
                      p.Tq - q0, p.D, t);
  }
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

template <typename T, int DP>
cudaError_t launch_passes(const Params& p, bool kv_pass, bool q_pass, cudaStream_t stream) {
  using Cfg = Config<T, DP>;
  cudaError_t err;
  if (kv_pass) {
    const int bytes = Cfg::dkdv_smem_bytes(p.n_qt);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_kernel<T, DP><<<dim3(p.B * p.H, p.n_kt), THREADS, bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_pass) {
    const int bytes = Cfg::dq_smem_bytes(p.n_kt);
    err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_kernel<T, DP><<<dim3(p.B * p.H, p.n_qt), THREADS, bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <typename T>
cudaError_t launch_dtype(const Params& p, bool kv_pass, bool q_pass, cudaStream_t stream) {
  if (p.D <= 32) return launch_passes<T, 32>(p, kv_pass, q_pass, stream);
  if (p.D <= 64) return launch_passes<T, 64>(p, kv_pass, q_pass, stream);
  return launch_passes<T, 128>(p, kv_pass, q_pass, stream);
}

// 16-byte copies: unit stride on D (or one column), a 16-byte aligned base,
// and every row stride a multiple of 16 bytes.
int rows16(const void* ptr, bool unit_stride, int elem_bytes,
           std::initializer_list<long long> strides) {
  bool ok = unit_stride && aligned16(ptr);
  for (long long st : strides) ok = ok && (st * elem_bytes) % 16 == 0;
  return ok;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k, v and the outputs dq, dk, dv);
// bias, block_max, dsum, dweighted and dbias are f32. classes: the bias's
// tile classes ([ceil(Tq/64), ceil(Tk/64)] uint8, 0 MASKED, 1 ZERO_BIAS, 2
// BIAS). block_max, dsum: [B, H, Tq] contiguous; dweighted [B, Tq, H, D]
// contiguous; dq [B, Tq, H, D], dk and dv [B, Tk, H, D] contiguous (per
// query head), dbias [Tq, Tk] contiguous and zeroed. dims: B, H, Tq, Tk, D,
// group. strides (elements): q b,t,h,d; k b,t,h,g,d; v b,t,h,g,d; bias q,k.
// needs: bit 0 dq, 1 dk, 2 dv, 3 dbias; an output not asked for may be null
// and is not written. Launches the dK/dV pass if dk or dv is asked for, then
// the dQ pass if dq or dbias is. Returns a cudaError_t: the first launch
// error, or cudaErrorInvalidValue for arguments the kernels do not take
// (then nothing is launched).
extern "C" int flash_block_backward(int dtype, const void* q, const void* k, const void* v,
                                    const void* bias, const void* classes, const void* block_max,
                                    const void* dsum, const void* dweighted, void* dq, void* dk,
                                    void* dv, void* dbias, const long long* dims,
                                    const long long* strides, int needs, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.classes = static_cast<const unsigned char*>(classes);
  p.block_max = static_cast<const float*>(block_max);
  p.dsum = static_cast<const float*>(dsum);
  p.dw = static_cast<const float*>(dweighted);
  p.dq = needs & 1 ? dq : nullptr;
  p.dk = needs & 2 ? dk : nullptr;
  p.dv = needs & 4 ? dv : nullptr;
  p.dbias = needs & 8 ? static_cast<float*>(dbias) : nullptr;
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Tq = (int)dims[2];
  p.Tk = (int)dims[3];
  p.D = (int)dims[4];
  p.group = (int)dims[5];
  if (p.D < 1 || p.D > 128 || p.group < 1 || p.H % p.group || p.Tq < 1 || p.Tk < 1 ||
      p.B * p.H > 65535 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  p.n_qt = (p.Tq + TILE - 1) / TILE;
  p.n_kt = (p.Tk + TILE - 1) / TILE;
  p.scale = (float)(1.0 / sqrt((double)p.D));
  long long* dst[] = {&p.q_sb, &p.q_st, &p.q_sh, &p.q_sd, &p.k_sb, &p.k_st,
                      &p.k_sh, &p.k_sg, &p.k_sd, &p.v_sb, &p.v_st, &p.v_sh,
                      &p.v_sg, &p.v_sd, &p.bias_sq, &p.bias_sk};
  for (int i = 0; i < 16; ++i) *dst[i] = strides[i];
  const int eb = dtype == 0 ? 4 : 2;
  const bool unit_d = p.D == 1;  // one column: its stride is never used
  p.vec_q = rows16(q, unit_d || p.q_sd == 1, eb, {p.q_sb, p.q_st, p.q_sh});
  p.vec_k = rows16(k, unit_d || p.k_sd == 1, eb, {p.k_sb, p.k_st, p.k_sh, p.k_sg});
  p.vec_v = rows16(v, unit_d || p.v_sd == 1, eb, {p.v_sb, p.v_st, p.v_sh, p.v_sg});
  p.vec_dw = rows16(dweighted, true, 4, {(long long)p.D, (long long)p.H * p.D});
  const bool kv_pass = (needs & 6) != 0, q_pass = (needs & 9) != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_dtype<float>(p, kv_pass, q_pass, s);
  return (int)launch_dtype<bf16>(p, kv_pass, q_pass, s);
}
