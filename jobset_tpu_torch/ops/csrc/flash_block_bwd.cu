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
//
// Both dtypes run two passes, neither of which writes anything [Tq, Tk]-sized
// and neither of which adds into another block's output, so the same inputs
// give the same bits on every run (dbias, which no training path asks for, is
// the exception: f32 atomicAdd in the dQ pass). Together they do seven
// products where the function needs five; what that buys is no atomics and
// no [Tq, Tk] scratch.
// - The dK/dV pass: one block per (batch*head, 64-row kv tile); K and V of
//   the tile stay in shared memory, and the block walks the q tiles whose
//   tile class at (q tile, kv tile) is not MASKED, recomputing S^T and dP^T
//   and adding P^T.dW and dS^T.Q into dK and dV accumulators in registers.
// - The dQ pass: one block per (batch*head, 64-row q tile), the q tiles with
//   the most live kv tiles under a causal mask first; Q, dW, m and dsum of
//   the tile are resident, and the block walks the live kv tiles,
//   recomputing S, P, dP and dS and adding dS.K into dQ (and dS into dbias).
// Tile classes are the forward's: a MASKED tile is skipped (no load, no
// product: it adds P = 0), a ZERO_BIAS tile reads no bias, a BIAS tile reads
// its bias from global memory (L2). Every block writes its whole tile of
// outputs, so a tile with nothing live is written as zeros.
//
// bf16 (flash_bwd_dkdv_tc_kernel, flash_bwd_dq_tc_kernel): wgmma fed by TMA.
// What held the first build (mma.sync m16n8k16 with ldmatrix, tiles copied
// by the consumer threads with cp.async into two buffers, dW staged as f32
// and rounded in shared memory; 10.7% of the bound on an H100 SXM) was each warp's
// dependent chain: products, exponentials, products, each waited for in
// turn on 16 rows, at 168 registers and three warps an SM sub-partition.
// The design takes the copies off the threads and lets the tensor cores
// run while the threads do the elementwise work:
// - A block is one warpgroup (four warps, 16 rows each of the block's own
//   64-row tile); three blocks an SM at D <= 64 (168 registers a thread).
//   Warp 0 loads the block's resident tiles once and each live tile of the
//   walked operand into a ring of STAGES stages in shared memory by TMA
//   (lane 0), through 4-D tensor maps over [B, T, H, D] with the 128-byte
//   swizzle that the wgmma descriptors name, so no thread copies or
//   reshuffles a tile. Each load completes on the stage's mbarrier; in the
//   dK/dV pass warp 0's lanes also copy the q tile's maxes and dsums beside
//   the stage (cp.async, arriving on the same barrier). A stage is refilled,
//   STAGES live tiles ahead, once a __syncthreads shows every warp's
//   products of the tile in it retired. (A producer warp of its own, as in
//   the forward, is a fifth warp: at three blocks an SM it would cut every
//   thread to 128 registers, and at two the blocks are too few to hide each
//   one's chain; both ran slower.)
// - dW is rounded to bf16 once, by the wrapper (the reference's
//   dweighted.astype(compute)), so TMA loads bf16 tiles, half the bytes of
//   f32, with no staging tile and no conversion on the consumers.
// - The products are wgmma m64nNk16 with f32 accumulators in registers. S^T
//   = K.Q^T and dP^T = V.dW^T (S = Q.K^T and dP = dW.V^T in the dQ pass)
//   take both operands from shared memory, K-major. P^T and dS^T go from
//   f32 registers to bf16 A fragments (the C fragments of two n8 column
//   groups are the A fragment of one k16 step, the forward's trick) and dV
//   += P^T.dW, dK += dS^T.Q and dQ += dS.K read B MN-major through the
//   transpose bit, from the tiles as TMA wrote them.
// - The products are issued asynchronously in commit groups and waited for
//   only where their result is read: S^T and dP^T are issued together, P^T
//   is computed while dP^T runs, dV's product is issued before dS^T is
//   computed and runs under it, then dK's.
// - A BIAS tile's loop (bias reads) and the dQ pass with dbias (atomics)
//   are instantiations of their own: compiled into the common loop, their
//   code, predicated off, slowed every ZERO_BIAS tile several-fold.
// - Blocks take their (b*h, tile) in groups of HEAD_GROUP heads, longest
//   tile first within a group, so that the blocks in flight walk tiles that
//   stay in L2; and the dQ pass runs under programmatic dependent launch
//   behind the dK/dV pass (it reads nothing that pass writes), so its
//   blocks fill the SMs the dK/dV pass's last blocks leave idle.
// - Ragged Tq, Tk and D < 64 or < 128 come from TMA's zero fill of
//   out-of-bounds boxes; P is forced to 0 past Tk, and a q row past Tq has
//   an infinite max and a dsum of 0.
// What holds it now: per tile a warpgroup issues 16 wgmma (12 in the dQ
// pass), 32 exponentials a thread and the elementwise work around them, in
// a chain of three waits, and the tensor cores run about a third of the
// time; a block's start (barriers, classes, its resident tiles' loads)
// costs about as much as a tile.
//
// f32 (flash_bwd_dkdv_tf32_kernel, flash_bwd_dq_tf32_kernel): 3xTF32 on tf32
// wgmma m64nNk8 fed by TMA. Each operand x is big + small, two TF32 values,
// and a product small.big + big.small + big.big, summed in f32: an accuracy
// on a par with f32. The bound is the three TF32 products at 495 TFLOP/s
// (0.26 ms at the flagship block; seven products over the live tiles, as
// the passes do them, 0.39 ms). The bf16 design carries over: warp 0
// loading the walked tiles by TMA into a ring of stages (4-D maps, boxes of
// 32 f32 columns, one 128-byte swizzled row), blocks in groups of heads
// longest tile first, the dQ pass under PDL behind the dK/dV pass, a BIAS
// tile's loop and dbias's atomics instantiations of their own. A block is
// two warpgroups, each taking half of every walked tile's rows (32 q rows
// in the dK/dV pass, 32 kv rows in the dQ pass) against the block's whole
// 64-row tile, with totals of its own that the two add at the end in a
// fixed order: one warpgroup alone left the SM idle while it copied, split
// and exponentiated. What it has to meet, and what it does:
// - tf32 wgmma reads shared memory K-major only. S^T = K.Q^T and dP^T =
//   V.dW^T (S = Q.K^T and dP = dW.V^T in the dQ pass) read both operands as
//   TMA writes them. dV += P^T.dW, dK += dS^T.Q and dQ += dS.K read B down
//   its columns: A (P^T, dS^T, dS) comes from the accumulators in registers
//   (the RS form; the C fragment of n8 tile j, relabelled as in frag_c, is
//   the A fragment of k8 step j), and each warpgroup writes its half of the
//   walked tile's transposed copy, T[d][row] K-major in the 128-byte
//   swizzle, big and small parts, its k positions in the relabelling's
//   order (transpose_step). The other way, the walked tile in registers and P^T
//   or dS^T staged in shared memory, writes as many bytes and puts the head
//   dim on M, which wgmma takes 64 rows at a time.
// - The split. Resident tiles are split once a block, in place: big
//   rounded to nearest (cvt.rna), small = x - big beside it. A walked tile
//   is read raw as its own big part (the tensor core takes an f32's top 19
//   bits: truncation) with small = x - trunc(x) beside it; the transposed
//   copies and the register A fragments are split to nearest. The tensor
//   core reads each small part truncated in turn: every operand is within
//   2^-20 of itself, and the f32 tolerances hold (the numpy model in
//   tests/test_torch_flash_bwd_f32_layout.py).
// - The tensor core's f32 sums truncate: each warpgroup's part of dK, dV
//   and dQ over a walked tile's 32 rows starts from zero and is added to
//   totals in registers in f32 (rounded to nearest). One chain over a block of Tq = 4096 would drift
//   about 20 times further (4.8e-5 against 2.3e-6 in relative norm, in the
//   model); the products over D of S^T and dP^T stay one chain.
// - Shared memory, beside the tensor cores, bounds a tile. At D = 64 a
//   walked tile in the dK/dV pass moves ~540 KB through shared memory (the
//   shared-memory operands of S^T and dP^T, both warpgroups reading K and V
//   whole, 288 KB; the transposed copies' B 96 KB; reading the raw tile and
//   writing the copies and small parts 128 KB; TMA 32 KB) against the SM's
//   128 bytes a clock, ~4,200 clocks, beside ~3,800 of the tensor cores'.
//   So the work beside the products is put between their issues (a wgmma's
//   issue waits for room in the tensor core's queue): every other k8 step
//   of S^T and dP^T is followed by a step of the transposed copies, which
//   also write the raw tile's small parts; the terms that read those
//   (big.small) are issued after the warpgroup's barrier, the terms that
//   read the tile raw before it. dS^T is computed beside dV's product.
// - The resident tiles, their small parts, the walked tile's small parts and
//   transposed copies and the ring fill one SM's shared memory at D <= 64
//   (tf_smem_bytes: 226 KB at D = 64): one block an SM. At D = 128 they would
//   not fit; that D, a D that is not a multiple of 4, and views TMA cannot
//   take (unit stride on D, a 16-byte aligned base, strides that are
//   multiples of 4 elements) run on the kernels below.
// - Every block writes its whole tile; no atomics but dbias's: two calls
//   give the same bits.
// What holds it now (H100 80GB HBM3, 700.00 W; [8,1024,16,64] with the
// triangle): 1.04 ms, 25% of the bound, the dK/dV pass 0.58 ms and the dQ
// pass 0.46 (the mma.sync kernels took 1.42 in the same call). A dK/dV
// block spends about 4.4 us a walked tile, against ~4,200 clocks of
// shared-memory traffic: the two warpgroups run their phases in step
// (staggering them by half a phase ran slower), and the copies,
// exponentials and waits between the products leave the tensor cores idle
// about half the time.
//
// f32 on mma.sync (flash_bwd_dkdv_f32_kernel, flash_bwd_dq_f32_kernel), for
// D > 64 and views TMA cannot take: 3xTF32 on mma.sync m16n8k8. Each block
// has four warps of 16 rows; P and dS never leave the registers (the
// accumulator fragment of S, and of dP, is the A fragment of the next
// product), so only the B operands are read from shared memory. Tiles
// arrive by cp.async (16-byte copies where a view allows) into two
// buffers: the next live tile's copies run while this one's products do.
//
// Operands are read in place from [B, T, H, D] (k and v as [B, T, H_kv,
// group, D]: query head h reads kv head h / group), so GQA expand views and
// fused-QKV views go in without a copy; dk and dv are written per query
// head, [B, Tk, H, D], and the caller sums the group axis. The bf16 kernels'
// tensor maps cover the compact [B, T, H_kv, D] storage and address kv head
// h / group by coordinate, so no stride-0 axis reaches a map; TMA needs
// unit stride on D, a 16-byte aligned base and strides that are multiples
// of 16 bytes, which the wrapper checks as the forward's does.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int TILE = 64;  // rows of a q tile and of a kv tile (and of one class)
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
  // f32: [B, Tq, H, D] f32 contiguous (by TMA, D a multiple of 4); bf16:
  // [B, Tq, H, DW] bf16 contiguous, DW = D rounded up to a multiple of 8
  // (TMA's 16-byte strides).
  const void* dw;
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
  // f32: the operand's tiles go by 16-byte copies (unit stride on D, 16-byte
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The base-2 max of a q row as the passes use it: +inf on a fully masked
// row (or a row past Tq), so that every P of the row is exp2(-inf) = 0.
__device__ __forceinline__ float row_max2(float m, bool in) {
  return in && m > 0.5f * NEG_INF ? m * LOG2E : INFINITY;
}

// Store a warp's [16][DP] accumulator (rows r0 and r0 + 8 of this thread),
// times `mul`, as T into out[row * row_stride + col] for row < rows, col < D.
// The accumulators of mma.sync m16n8 and of a warp's 16 rows of wgmma m64nN
// have the same layout: n8 tile n holds (r0, 8n + 2t + {0, 1}) and
// (r0 + 8, 8n + 2t + {0, 1}).
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

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// ===========================================================================
// f32: 3xTF32 on mma.sync m16n8k8
// ===========================================================================

constexpr int F32_THREADS = 128;  // four warps, 16 rows of the block's own tile each
constexpr int KSTEP = 8;          // k columns of one m16n8k8 step

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
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
// col 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1). A k step covers 8
// columns of A (rows of B); its logical k = t and t + 4 are read as physical
// 2t and 2t + 1 (the sum over k does not care, as long as A and B agree), so
// A is read as pairs of adjacent columns and B as pairs of adjacent rows, and
// the accumulator of n8 tile j is the A fragment of k step j. Rows are DP +
// 8 floats apart.
// ---------------------------------------------------------------------------

// A fragment of rows r16..r16+15 and k columns k0.. of a row-major tile.
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
// X's rows n0..n0+15.
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
// X's columns n0..n0+15.
__device__ __forceinline__ void frag_bn2(float (&b)[2][2], const float* s, int ld, int n0, int k0,
                                         int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* p = s + (k0 + 2 * (lane % 4)) * ld + n0 + 8 * h + lane / 4;
    b[h][0] = p[0];
    b[h][1] = p[ld];
  }
}

// A fragment of k step j from the accumulators c of a product's n8 tiles.
__device__ __forceinline__ void frag_c(float (&a)[4], const float (*c)[4], int j) {
  a[0] = c[j][0];
  a[1] = c[j][2];
  a[2] = c[j][1];
  a[3] = c[j][3];
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

// Start copying a [TILE][DP] f32 tile into shared memory (row stride LD):
// element (r, c) from base[r * srow + c * scol] for r < rows and c < cols,
// zero elsewhere. `vec`: unit stride on columns, 16-byte aligned base and
// row stride, so 16-byte copies, the tail of a row zero-filled by the copy's
// source size; otherwise 4-byte copies. The caller waits
// (cp_async_wait_all) and synchronizes.
template <int DP, int LD>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int rows, int cols,
                                          long long srow, long long scol, bool vec) {
  constexpr int EPC = 4;  // floats a 16-byte copy
  if (vec) {
    constexpr int CH = DP / EPC, RSTEP = F32_THREADS / CH;
    static_assert(F32_THREADS % CH == 0, "a thread keeps its columns");
    const int c = EPC * (threadIdx.x % CH), r0 = threadIdx.x / CH;
    const int bytes = 4 * max(0, min(cols - c, EPC));
#pragma unroll
    for (int i = 0; i < TILE / RSTEP; ++i) {
      const int r = r0 + i * RSTEP;
      // A copy of 0 bytes reads nothing: its source may lie past the tensor.
      cp_async16(dst + r * LD + c, base + (r < rows ? (long long)r * srow + c : 0),
                 r < rows ? bytes : 0);
    }
  } else {
    for (int i = threadIdx.x; i < TILE * DP; i += F32_THREADS) {
      const int r = i / DP, c = i % DP;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * LD + c, in ? base + r * srow + c * scol : base, in ? 4 : 0);
    }
  }
}

template <int DP>
struct F32Config {
  static constexpr int LD = DP + 8;  // floats a row
  static constexpr int TILE_BYTES = TILE * LD * 4;
  // dK/dV pass: K, V, two buffers of Q and of dW, two buffers of the q
  // tile's maxes and dsums, the block's column of tile classes.
  static int dkdv_smem_bytes(int n_qt) { return 6 * TILE_BYTES + 4 * TILE * 4 + n_qt; }
  // dQ pass: Q, dW, two buffers of K and V, the block's row of tile classes.
  static int dq_smem_bytes(int n_kt) { return 6 * TILE_BYTES + n_kt; }
};

// The dK/dV pass. Grid (B*H, kv tiles). Warp w owns kv rows 16w..16w+15 of
// the block's kv tile; every product here is over those rows:
// S^T = K.Q^T and dP^T = V.dW^T ([16 kv][64 q] a warp), then
// dV += P^T.dW and dK += dS^T.Q ([16 kv][DP]). The next live q tile's Q,
// dW, maxes and dsums are copied into the other buffer while this one's
// products run.
template <int DP>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_bwd_dkdv_f32_kernel(const __grid_constant__ Params p) {
  constexpr int LD = F32Config<DP>::LD;
  constexpr int SN = TILE / 8;  // n8 tiles of S^T (q columns)
  constexpr int ON = DP / 8;    // n8 tiles of dK, dV (head-dim columns)

  extern __shared__ __align__(16) unsigned char smem[];
  float* k_s = reinterpret_cast<float*>(smem);
  float* v_s = k_s + TILE * LD;
  float* q_s = v_s + TILE * LD;       // [2][TILE][LD]
  float* dw_s = q_s + 2 * TILE * LD;  // [2][TILE][LD]
  float* m_s = dw_s + 2 * TILE * LD;  // [2][TILE]
  float* ds_s = m_s + 2 * TILE;       // [2][TILE]
  unsigned char* cls = reinterpret_cast<unsigned char*>(ds_s + 2 * TILE);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int kt = blockIdx.y, k0 = kt * TILE;
  const int hk = h / p.group, hg = h % p.group;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;
  const float* dw = static_cast<const float*>(p.dw) + ((long long)b * p.Tq * p.H + h) * p.D;
  const long long dw_st = (long long)p.H * p.D;
  const float* bmax = p.block_max + (long long)bh * p.Tq;
  const float* dsum = p.dsum + (long long)bh * p.Tq;

  // Start the copies of q tile `qt` into buffer `buf`.
  auto load_q_tile = [&](int qt, int buf) {
    const int q0 = qt * TILE;
    load_tile<DP, LD>(q_s + buf * TILE * LD, q + (long long)q0 * p.q_st, p.Tq - q0, p.D, p.q_st,
                      p.q_sd, p.vec_q);
    load_tile<DP, LD>(dw_s + buf * TILE * LD, dw + q0 * dw_st, p.Tq - q0, p.D, dw_st, 1,
                      p.vec_dw);
    if (threadIdx.x < TILE) {
      const int row = min(q0 + (int)threadIdx.x, p.Tq - 1), bytes = q0 + threadIdx.x < p.Tq ? 4 : 0;
      cp_async4(m_s + buf * TILE + threadIdx.x, bmax + row, bytes);
      cp_async4(ds_s + buf * TILE + threadIdx.x, dsum + row, bytes);
    }
    cp_async_commit();
  };

  for (int i = threadIdx.x; i < p.n_qt; i += F32_THREADS)
    cls[i] = p.classes[(long long)i * p.n_kt + kt];
  load_tile<DP, LD>(k_s, k + (long long)k0 * p.k_st, p.Tk - k0, p.D, p.k_st, p.k_sd, p.vec_k);
  load_tile<DP, LD>(v_s, v + (long long)k0 * p.v_st, p.Tk - k0, p.D, p.v_st, p.v_sd, p.vec_v);
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
    const float* qb = q_s + buf * TILE * LD;
    const float* dwb = dw_s + buf * TILE * LD;
    float* mb = m_s + buf * TILE;
    float* dsb = ds_s + buf * TILE;
    cp_async_wait_all();
    __syncthreads();  // q tile qt has landed; every warp is done with the other buffer
    if (threadIdx.x < TILE) {
      const bool in = q0 + threadIdx.x < p.Tq;
      mb[threadIdx.x] = row_max2(mb[threadIdx.x], in);
      if (!in) dsb[threadIdx.x] = 0.f;
    }
    __syncthreads();  // the maxes in base 2
    const int next = next_live_tile(cls, qt + 1, p.n_qt);
    if (next < p.n_qt) load_q_tile(next, buf ^ 1);

    float s[SN][4], dp[SN][4];
#pragma unroll
    for (int n = 0; n < SN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < DP / KSTEP; ++ks) {
      float a[4], a2[4];
      frag_a(a, k_s, LD, warp * 16, ks * KSTEP, lane);
      frag_a(a2, v_s, LD, warp * 16, ks * KSTEP, lane);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        float bq[2][2], bw[2][2];
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
      float ap[4], ad[4];
      frag_c(ap, s, j);
      frag_c(ad, dp, j);
#pragma unroll
      for (int n = 0; n < ON; n += 2) {
        float bw[2][2], bq[2][2];
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
    store_rows<float, ON>(static_cast<float*>(p.dk) + out * p.D, stride, dk, p.scale, row0,
                          p.Tk - k0, p.D, t);
  if (p.dv != nullptr)
    store_rows<float, ON>(static_cast<float*>(p.dv) + out * p.D, stride, dv, 1.f, row0,
                          p.Tk - k0, p.D, t);
}

// The dQ pass. Grid (B*H, q tiles), the q tiles with the most live kv tiles
// under a causal mask first. Warp w owns q rows 16w..16w+15 of the block's
// q tile: S = Q.K^T and dP = dW.V^T ([16 q][64 kv] a warp), dQ += dS.K.
// The next live kv tile's K and V are copied into the other buffer while
// this one's products run.
template <int DP>
__global__ void __launch_bounds__(F32_THREADS, 1)
    flash_bwd_dq_f32_kernel(const __grid_constant__ Params p) {
  constexpr int LD = F32Config<DP>::LD;
  constexpr int SN = TILE / 8;  // n8 tiles of S (kv columns)
  constexpr int ON = DP / 8;    // n8 tiles of dQ

  extern __shared__ __align__(16) unsigned char smem[];
  float* q_s = reinterpret_cast<float*>(smem);
  float* dw_s = q_s + TILE * LD;
  float* kv_s = dw_s + TILE * LD;  // [2][K, V][TILE][LD]
  unsigned char* cls = reinterpret_cast<unsigned char*>(kv_s + 4 * TILE * LD);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y, q0 = qt * TILE;
  const int hk = h / p.group, hg = h % p.group;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;
  const long long dw_st = (long long)p.H * p.D;
  const float* dw = static_cast<const float*>(p.dw) + ((long long)b * p.Tq * p.H + h) * p.D;

  // Start the copies of kv tile `kt` into buffer `buf`.
  auto load_kv_tile = [&](int kt, int buf) {
    const int k0 = kt * TILE;
    float* dst = kv_s + buf * 2 * TILE * LD;
    load_tile<DP, LD>(dst, k + (long long)k0 * p.k_st, p.Tk - k0, p.D, p.k_st, p.k_sd, p.vec_k);
    load_tile<DP, LD>(dst + TILE * LD, v + (long long)k0 * p.v_st, p.Tk - k0, p.D, p.v_st,
                      p.v_sd, p.vec_v);
    cp_async_commit();
  };

  // Q and dW, the classes of this q tile's row and the first live kv tile.
  load_tile<DP, LD>(q_s, q + (long long)q0 * p.q_st, p.Tq - q0, p.D, p.q_st, p.q_sd, p.vec_q);
  load_tile<DP, LD>(dw_s, dw + q0 * dw_st, p.Tq - q0, p.D, dw_st, 1, p.vec_dw);
  for (int j = threadIdx.x; j < p.n_kt; j += F32_THREADS)
    cls[j] = p.classes[(long long)qt * p.n_kt + j];
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

  for (int i = 0; kt < p.n_kt; ++i) {
    const int buf = i & 1, k0 = kt * TILE;
    const unsigned char c = cls[kt];
    const float* kb = kv_s + buf * 2 * TILE * LD;
    const float* vb = kb + TILE * LD;
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
      float a[4], a2[4];
      frag_a(a, q_s, LD, warp * 16, ks * KSTEP, lane);
      frag_a(a2, dw_s, LD, warp * 16, ks * KSTEP, lane);
#pragma unroll
      for (int n = 0; n < SN; n += 2) {
        float bk[2][2], bv[2][2];
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
      float ad[4];
      frag_c(ad, dp, j);
#pragma unroll
      for (int n = 0; n < ON; n += 2) {
        float bk[2][2];
        frag_bn2(bk, kb, LD, n * 8, j * KSTEP, lane);
        mma(dq[n], ad, bk[0]);
        mma(dq[n + 1], ad, bk[1]);
      }
    }
    kt = next;
  }

  if (p.dq != nullptr) {
    const long long out = ((long long)b * p.Tq + q0) * p.H + h;  // row q0 of this head
    store_rows<float, ON>(static_cast<float*>(p.dq) + out * p.D, (long long)p.H * p.D, dq,
                          p.scale, row0, p.Tq - q0, p.D, t);
  }
}

template <int DP>
cudaError_t launch_f32(const Params& p, bool kv_pass, bool q_pass, cudaStream_t stream) {
  using Cfg = F32Config<DP>;
  cudaError_t err;
  if (kv_pass) {
    const int bytes = Cfg::dkdv_smem_bytes(p.n_qt);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_f32_kernel<DP><<<dim3(p.B * p.H, p.n_kt), F32_THREADS, bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_pass) {
    const int bytes = Cfg::dq_smem_bytes(p.n_kt);
    err = cudaFuncSetAttribute(flash_bwd_dq_f32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dq_f32_kernel<DP><<<dim3(p.B * p.H, p.n_qt), F32_THREADS, bytes, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ===========================================================================
// bf16: wgmma fed by TMA
// ===========================================================================

constexpr int TC_THREADS = 128;           // one warpgroup: 64 rows, 16 per warp
constexpr int SUB_BYTES = TILE * 64 * 2;  // one [64 rows][64] bf16 swizzled sub-tile

// Per padded head dim: the depth of the ring of walked tiles, and the
// blocks an SM each pass's registers are sized for. An SM sub-partition's
// 16K registers hold its warps: three blocks of four warps leave 168 a
// thread, two 255. The dK/dV pass keeps dK's and dV's accumulators beside
// S^T's, dP^T's, P^T's and the A fragments; the dQ pass only dQ's. At D =
// 128 two blocks an SM: the dK/dV pass's accumulators alone take 192.
template <int DP>
struct TcConfig;
template <>
struct TcConfig<64> {
  static constexpr int STAGES = 3, DKDV_BLOCKS = 3, DQ_BLOCKS = 3;
};
template <>
struct TcConfig<128> {
  static constexpr int STAGES = 2, DKDV_BLOCKS = 2, DQ_BLOCKS = 2;
};

// Shared memory of a pass: 1024-byte alignment slack, the two resident
// tiles, the ring of two walked tiles a stage (with the dK/dV pass's q
// rows' maxes and dsums beside each stage), the barriers (the resident
// tiles' and each stage's), then the block's classes.
template <int DP>
int tc_smem_bytes(bool dkdv, int n_classes) {
  constexpr int TB = DP / 64 * SUB_BYTES, S = TcConfig<DP>::STAGES;
  return 1024 + 2 * TB + S * (2 * TB + (dkdv ? 2 * TILE * 4 : 0)) + 8 * (1 + S) + n_classes;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Arrive on `bar` once this thread's cp.async copies so far have landed
// (the arrival counts against the barrier's expected count).
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" :: "r"(smem_u32(bar))
               : "memory");
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
  const uint32_t addr = smem_u32(bar);
  if (mbar_try_wait(addr, parity)) return;
  const long long start = clock64();
  while (!mbar_try_wait(addr, parity))
    if (clock64() - start > (1ll << 31)) __trap();
}

// One TMA box of a 4-D tensor map (coordinates innermost first) into
// shared memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)),
         "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// Programmatic dependent launch (sm_90). The dQ pass does not read what the
// dK/dV pass writes, so when both run it is launched under programmatic
// stream serialization: its blocks may be scheduled once every dK/dV block
// has issued launch_dependents (at entry), filling the SMs the dK/dV pass's
// last blocks leave idle. Each dQ block waits in griddepcontrol.wait before
// it exits, so the dQ pass completes, for the work after it on the stream,
// only once the dK/dV pass has. Launched without the attribute, the wait
// returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// wgmma shared-memory descriptor of a tile stored as 128-byte swizzled rows
// (the layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B): start address,
// leading and stride byte offsets (16-byte units), layout type 1 = 128B.
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, int lbo, int sbo) {
  return (uint64_t)((smem_u32(smem) & 0x3FFFF) >> 4) | (uint64_t)(lbo >> 4) << 16 |
         (uint64_t)(sbo >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// Keep the compiler from touching a register that a wgmma in flight still
// reads or writes before the wait that retires it.
__device__ __forceinline__ void reg_fence(float& r) { asm volatile("" : "+f"(r) :: "memory"); }
__device__ __forceinline__ void reg_fence(uint32_t& r) { asm volatile("" : "+r"(r) :: "memory"); }

template <int N, int E, typename T>
__device__ __forceinline__ void reg_fence(T (&r)[N][E]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int e = 0; e < E; ++e) reg_fence(r[i][e]);
}

#define WG_D8(j) "+f"(d[j][0]), "+f"(d[j][1]), "+f"(d[j][2]), "+f"(d[j][3])
#define WG_D64 WG_D8(0), WG_D8(1), WG_D8(2), WG_D8(3), WG_D8(4), WG_D8(5), WG_D8(6), WG_D8(7)
#define WG_D128 WG_D64, WG_D8(8), WG_D8(9), WG_D8(10), WG_D8(11), WG_D8(12), WG_D8(13), \
                WG_D8(14), WG_D8(15)
#define WG_R32                                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, " \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define WG_R64                                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, "  \
  "%18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, "  \
  "%34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "  \
  "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d (+)= A . B, m64n64k16: A and B K-major in shared memory; `accumulate`
// 0 overwrites d.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[8][4], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D64
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += A . B, m64nNk16: A in registers (per warp, the A fragment of
// mma.m16n8k16), B MN-major in shared memory (transpose bit set).
__device__ __forceinline__ void wgmma_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

__device__ __forceinline__ void wgmma_rs(float (&d)[16][4], const uint32_t (&a)[4],
                                         uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " WG_R64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : WG_D128
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// The A fragment of k16 step j, rounded to bf16 to nearest even, from the
// accumulators c of a product's n8 tiles: the C fragments of n8 tiles 2j
// and 2j + 1 are the A fragment of k16 step j.
__device__ __forceinline__ void frag_c(uint32_t (&a)[4], const float (*c)[4], int j) {
  a[0] = pack_bf16(c[2 * j][0], c[2 * j][1]);
  a[1] = pack_bf16(c[2 * j][2], c[2 * j][3]);
  a[2] = pack_bf16(c[2 * j + 1][0], c[2 * j + 1][1]);
  a[3] = pack_bf16(c[2 * j + 1][2], c[2 * j + 1][3]);
}

// The two products of a walked tile that read only shared memory, each its
// own commit group: X = A1.B1^T and Y = A2.B2^T over the padded head dim,
// every operand a [TILE][DP] tile of 64-column swizzled sub-tiles, K-major.
template <int DP>
__device__ __forceinline__ void issue_pair(float (&x)[8][4], float (&y)[8][4],
                                           const unsigned char* a1, const unsigned char* b1,
                                           const unsigned char* a2, const unsigned char* b2) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    // k16 step kk: 32 bytes into the 128-byte swizzled rows of its sub-tile.
    const int off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(x, sw128_desc(a1 + off, 16, 1024), sw128_desc(b1 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
    wgmma_ss_n64(y, sw128_desc(a2 + off, 16, 1024), sw128_desc(b2 + off, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// acc += A.B over a 64-deep contraction, one commit group: A the bf16
// fragments of four k16 steps in registers, B a [64][DP] tile as TMA wrote
// it, read MN-major (16 rows = two 8-row groups of 1024 bytes a step; the
// 64-column sub-tiles SUB_BYTES apart).
template <int ON>
__device__ __forceinline__ void issue_rs(float (&acc)[ON][4], const uint32_t (&a)[TILE / 16][4],
                                         const unsigned char* b) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < TILE / 16; ++j) wgmma_rs(acc, a[j], sw128_desc(b + j * 2048, SUB_BYTES, 1024));
  wgmma_commit();
}

template <int SN>
__device__ __forceinline__ void zero(float (&x)[SN][4]) {
#pragma unroll
  for (int j = 0; j < SN; ++j) x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.f;
}

// P^T from S^T in the dK/dV pass. Entry e of this thread's n8 tile
// j: kv row row0 + 8 (e >> 1), q column 8j + 2t + (e & 1); the q rows' maxes
// from the stage (raw: made base 2 here, +inf past Tq and on rows masked
// whole). BIASED: the tile's bias is read (a BIAS tile); an instantiation of
// its own, so that a ZERO_BIAS tile's loop carries no predicated loads.
template <bool BIASED>
__device__ __forceinline__ void probs_t(float (&pf)[8][4], const float (&s)[8][4], const Params& p,
                                        const float* m_s, float scale2, int q0, int k0, int row0,
                                        int t, const bool (&row_in)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int c = q0 + j * 8 + 2 * t;
    const float2 mr = *reinterpret_cast<const float2*>(m_s + j * 8 + 2 * t);
    const float m[2] = {row_max2(mr.x, c < p.Tq), row_max2(mr.y, c + 1 < p.Tq)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale2;
      if (BIASED) {
        const int qr = min(c + (e & 1), p.Tq - 1), kr = min(k0 + row0 + 8 * (e >> 1), p.Tk - 1);
        x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
      }
      pf[j][e] = row_in[e >> 1] ? fast_exp2(x - m[e & 1]) : 0.f;
    }
  }
}

// P from S in the dQ pass. Entry e of this thread's n8 tile j: q
// row row0 + 8 (e >> 1), kv column k0 + 8j + 2t + (e & 1); kv columns past
// Tk get 0.
template <bool BIASED>
__device__ __forceinline__ void probs(float (&pf)[8][4], const float (&s)[8][4], const Params& p,
                                      const float (&m2)[2], float scale2, int q0, int k0, int row0,
                                      int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
      float x = s[j][e] * scale2;
      if (BIASED) {
        const int qr = min(q0 + row0 + 8 * r, p.Tq - 1), kr = min(col, p.Tk - 1);
        x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
      }
      pf[j][e] = col < p.Tk ? fast_exp2(x - m2[r]) : 0.f;
    }
}

// Blocks are dispatched in the order of their linear index. Heads go in
// groups of HEAD_GROUP, each group's blocks longest tile first: the blocks
// in flight then walk a few heads' tiles, which stay in L2 (all heads
// at once, at the training block's 16 MB of Q and dW, did not), and the
// last blocks of the grid are short ones. Returns this block's (b*h, k): it
// takes the k-th tile of its head in the longest-first order.
constexpr int HEAD_GROUP = 16;

__device__ __forceinline__ void grouped_order(int& bh, int& k) {
  const int heads = gridDim.x, tiles = gridDim.y;
  const int lin = blockIdx.y * heads + blockIdx.x;
  const int group = lin / (HEAD_GROUP * tiles), size = min(HEAD_GROUP, heads - group * HEAD_GROUP);
  const int rem = lin - group * HEAD_GROUP * tiles;
  k = rem / size;
  bh = group * HEAD_GROUP + rem % size;
}

// The dK/dV pass. Grid (B*H, kv tiles) in grouped order; one warpgroup a
// block, warp w owning kv rows 16w..16w+15 of the block's kv tile. K and V
// are resident; each live q tile's Q and dW come through the ring, its
// maxes and dsums beside them. Warp 0 issues the loads (no producer warp:
// a fifth warp would cost every thread of three blocks an SM 40
// registers), STAGES tiles ahead; a stage is refilled once every warp's
// products of the tile in it have retired.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS, TcConfig<DP>::DKDV_BLOCKS)
    flash_bwd_dkdv_tc_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_dw) {
  using Cfg = TcConfig<DP>;
  constexpr int NSUB = DP / 64;         // 64-column sub-tiles of the head dim
  constexpr int TB = NSUB * SUB_BYTES;  // bytes of one [TILE][DP] tile
  constexpr int SN = TILE / 8;          // n8 tiles of S^T (q columns)
  constexpr int ON = DP / 8;            // n8 tiles of dK, dV (head-dim columns)

  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned destinations.
  unsigned char* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* v_s = k_s + TB;
  unsigned char* ring = v_s + TB;  // [stage][Q, dW][TB]
  float* stats = reinterpret_cast<float*>(ring + Cfg::STAGES * 2 * TB);  // [stage][m, dsum][TILE]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + Cfg::STAGES * 2 * TILE);
  uint64_t* full = kv_full + 1;
  unsigned char* cls = reinterpret_cast<unsigned char*>(full + Cfg::STAGES);  // kv tile's column

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  launch_dependents();  // the dQ pass, if launched under PDL, may be scheduled now
  int bh, kt;
  grouped_order(bh, kt);  // kv tile 0 walks the most q tiles under a causal mask
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * TILE;

  if (threadIdx.x == 0) {
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v, &tm_dw}) prefetch_map(map);
    mbar_init(kv_full, 1);
    // A stage is full once TMA's bytes and warp 0's 32 lanes' copies of the
    // statistics have landed.
    for (int s = 0; s < Cfg::STAGES; ++s) mbar_init(&full[s], 1 + 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int hk = h / p.group;
    mbar_expect_tx(kv_full, 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(k_s + s * SUB_BYTES, &tm_k, kv_full, s * 64, hk, k0, b);
      tma_load_4d(v_s + s * SUB_BYTES, &tm_v, kv_full, s * 64, hk, k0, b);
    }
  }
  for (int i = threadIdx.x; i < p.n_qt; i += TC_THREADS)
    cls[i] = p.classes[(long long)i * p.n_kt + kt];
  __syncthreads();

  // Warp 0 loads live q tile `qt` into `stage`: Q and dW by TMA (lane 0),
  // the rows' maxes and dsums by 4-byte cp.async (rows past Tq zero-filled).
  const float* bmax = p.block_max + (long long)bh * p.Tq;
  const float* dsum = p.dsum + (long long)bh * p.Tq;
  auto load = [&](int qt, int stage) {
    const int q0 = qt * TILE;
    unsigned char* q_s = ring + stage * 2 * TB;
    if (lane == 0) {
      mbar_expect_tx(&full[stage], 2 * TB);
      for (int s = 0; s < NSUB; ++s) {
        tma_load_4d(q_s + s * SUB_BYTES, &tm_q, &full[stage], s * 64, h, q0, b);
        tma_load_4d(q_s + TB + s * SUB_BYTES, &tm_dw, &full[stage], s * 64, h, q0, b);
      }
    }
    float* st = stats + stage * 2 * TILE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + lane + 32 * r, at = min(row, p.Tq - 1), bytes = row < p.Tq ? 4 : 0;
      cp_async4(st + lane + 32 * r, bmax + at, bytes);
      cp_async4(st + TILE + lane + 32 * r, dsum + at, bytes);
    }
    cp_async_arrive(&full[stage]);
  };
  // The next live q tile to load; warp 0 starts the first STAGES.
  int ahead = next_live_tile(cls, 0, p.n_qt);
  for (int s = 0; s < Cfg::STAGES && ahead < p.n_qt; ++s) {
    if (warp == 0) load(ahead, s);
    ahead = next_live_tile(cls, ahead + 1, p.n_qt);
  }

  // This thread's entries of an n8 tile j of S^T: kv rows row0 and row0 + 8
  // (e >> 1), q columns 8j + 2t + (e & 1).
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;
  const bool row_in[2] = {k0 + row0 < p.Tk, k0 + row0 + 8 < p.Tk};
  const float scale2 = p.scale * LOG2E;
  float dk[ON][4], dv[ON][4], s[SN][4], dp[SN][4];
  uint32_t pa[TILE / 16][4], da[TILE / 16][4];
  zero(dk);
  zero(dv);

  mbar_wait(kv_full, 0);  // even with no live q tile: no TMA write outlives the block
  int i = 0;
  for (int qt = next_live_tile(cls, 0, p.n_qt); qt < p.n_qt;
       qt = next_live_tile(cls, qt + 1, p.n_qt), ++i) {
    const int stage = i % Cfg::STAGES, q0 = qt * TILE;
    const unsigned char* q_s = ring + stage * 2 * TB;
    const unsigned char* dw_s = q_s + TB;
    const float* m_s = stats + stage * 2 * TILE;
    zero(s);
    zero(dp);
    mbar_wait(&full[stage], (i / Cfg::STAGES) & 1);
    issue_pair<DP>(s, dp, k_s, q_s, v_s, dw_s);
    wgmma_wait<1>();
    reg_fence(s);
    // P^T, while dP^T's product runs.
    float pf[SN][4];
    if (cls[qt] != CLASS_ZERO)
      probs_t<true>(pf, s, p, m_s, scale2, q0, k0, row0, t, row_in);
    else
      probs_t<false>(pf, s, p, m_s, scale2, q0, k0, row0, t, row_in);
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) frag_c(pa[j], pf, j);
    issue_rs(dv, pa, dw_s);  // dV += P^T.dW
    wgmma_wait<1>();         // dP^T retired; dV's product runs on
    reg_fence(dp);

    // dS^T = P^T * (dP^T + dsum), while dV's product runs.
    const float* ds_s = m_s + TILE;
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float2 dc = *reinterpret_cast<const float2*>(ds_s + j * 8 + 2 * t);
#pragma unroll
      for (int e = 0; e < 4; ++e) pf[j][e] *= dp[j][e] + (e & 1 ? dc.y : dc.x);
    }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) frag_c(da[j], pf, j);
    issue_rs(dk, da, q_s);  // dK += dS^T.Q

    wgmma_wait<0>();
    reg_fence(dv);
    reg_fence(dk);
    reg_fence(pa);
    reg_fence(da);
    __syncthreads();  // every warp is done with the stage: refill it
    if (warp == 0 && ahead < p.n_qt) load(ahead, stage);
    if (ahead < p.n_qt) ahead = next_live_tile(cls, ahead + 1, p.n_qt);
  }
  wgmma_wait<0>();
  reg_fence(dv);
  reg_fence(dk);
  reg_fence(pa);
  reg_fence(da);

  const long long out = ((long long)b * p.Tk + k0) * p.H + h;  // row k0 of this head
  const long long stride = (long long)p.H * p.D;
  if (p.dk != nullptr)
    store_rows<bf16, ON>(static_cast<bf16*>(p.dk) + out * p.D, stride, dk, p.scale, row0,
                         p.Tk - k0, p.D, t);
  if (p.dv != nullptr)
    store_rows<bf16, ON>(static_cast<bf16*>(p.dv) + out * p.D, stride, dv, 1.f, row0, p.Tk - k0,
                         p.D, t);
}

// The dQ pass. Grid (B*H, q tiles) in grouped order, the q tiles with the
// most live kv tiles under a causal mask first; one warpgroup a block, warp
// w owning q rows 16w..16w+15 of the block's q tile. Q and dW are
// resident; each live kv tile's K and V come through the ring, loaded by
// thread 0 as in the dK/dV pass. DBIAS: dS is also added into dbias (an
// instantiation of its own: the atomics' code, even untaken, slows every
// tile of the other).
template <int DP, bool DBIAS>
__global__ void __launch_bounds__(TC_THREADS, TcConfig<DP>::DQ_BLOCKS)
    flash_bwd_dq_tc_kernel(const __grid_constant__ Params p,
                           const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_dw) {
  using Cfg = TcConfig<DP>;
  constexpr int NSUB = DP / 64;
  constexpr int TB = NSUB * SUB_BYTES;
  constexpr int SN = TILE / 8;  // n8 tiles of S (kv columns)
  constexpr int ON = DP / 8;    // n8 tiles of dQ

  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* dw_s = q_s + TB;
  unsigned char* ring = dw_s + TB;  // [stage][K, V][TB]
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ring + Cfg::STAGES * 2 * TB);
  uint64_t* full = qd_full + 1;
  unsigned char* cls = reinterpret_cast<unsigned char*>(full + Cfg::STAGES);  // q tile's row

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int bh, order;
  grouped_order(bh, order);
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - order, q0 = qt * TILE;  // the last q tile walks the most
  const int hk = h / p.group;

  if (threadIdx.x == 0) {
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v, &tm_dw}) prefetch_map(map);
    mbar_init(qd_full, 1);
    for (int s = 0; s < Cfg::STAGES; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qd_full, 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(q_s + s * SUB_BYTES, &tm_q, qd_full, s * 64, h, q0, b);
      tma_load_4d(dw_s + s * SUB_BYTES, &tm_dw, qd_full, s * 64, h, q0, b);
    }
  }
  for (int j = threadIdx.x; j < p.n_kt; j += TC_THREADS)
    cls[j] = p.classes[(long long)qt * p.n_kt + j];
  __syncthreads();

  // Thread 0 loads live kv tile `kt`'s K and V into `stage` by TMA.
  auto load = [&](int kt, int stage) {
    unsigned char* k_s = ring + stage * 2 * TB;
    mbar_expect_tx(&full[stage], 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(k_s + s * SUB_BYTES, &tm_k, &full[stage], s * 64, hk, kt * TILE, b);
      tma_load_4d(k_s + TB + s * SUB_BYTES, &tm_v, &full[stage], s * 64, hk, kt * TILE, b);
    }
  };
  int ahead = next_live_tile(cls, 0, p.n_kt);
  for (int s = 0; s < Cfg::STAGES && ahead < p.n_kt; ++s) {
    if (threadIdx.x == 0) load(ahead, s);
    ahead = next_live_tile(cls, ahead + 1, p.n_kt);
  }

  // This thread's entries of an n8 tile j of S: q rows row0 and row0 + 8
  // (e >> 1), kv columns 8j + 2t + (e & 1).
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp * 16 + g;
  float m2[2], ds[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long at = (long long)bh * p.Tq + min(row, p.Tq - 1);
    m2[r] = row_max2(p.block_max[at], row < p.Tq);
    ds[r] = row < p.Tq ? p.dsum[at] : 0.f;
  }
  const float scale2 = p.scale * LOG2E;
  float dq[ON][4], s[SN][4], dp[SN][4];
  uint32_t da[TILE / 16][4];
  zero(dq);

  mbar_wait(qd_full, 0);  // even with no live kv tile: no TMA write outlives the block
  int i = 0;
  for (int kt = next_live_tile(cls, 0, p.n_kt); kt < p.n_kt;
       kt = next_live_tile(cls, kt + 1, p.n_kt), ++i) {
    const int stage = i % Cfg::STAGES, k0 = kt * TILE;
    const unsigned char* k_s = ring + stage * 2 * TB;
    zero(s);
    zero(dp);
    mbar_wait(&full[stage], (i / Cfg::STAGES) & 1);
    issue_pair<DP>(s, dp, q_s, k_s, dw_s, ring + stage * 2 * TB + TB);
    wgmma_wait<1>();
    reg_fence(s);
    // P, while dP's product runs.
    float pf[SN][4];
    if (cls[kt] != CLASS_ZERO)
      probs<true>(pf, s, p, m2, scale2, q0, k0, row0, t);
    else
      probs<false>(pf, s, p, m2, scale2, q0, k0, row0, t);
    wgmma_wait<0>();
    reg_fence(dp);

    // dS = P * (dP + dsum) in place of P (and into dbias).
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        pf[j][e] *= dp[j][e] + ds[r];
        if (DBIAS && col < p.Tk && q0 + row0 + 8 * r < p.Tq)
          atomicAdd(p.dbias + (long long)(q0 + row0 + 8 * r) * p.Tk + col, pf[j][e]);
      }
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j) frag_c(da[j], pf, j);
    issue_rs(dq, da, k_s);  // dQ += dS.K

    wgmma_wait<0>();
    reg_fence(dq);
    reg_fence(da);
    __syncthreads();  // every warp is done with the stage: refill it
    if (threadIdx.x == 0 && ahead < p.n_kt) load(ahead, stage);
    if (ahead < p.n_kt) ahead = next_live_tile(cls, ahead + 1, p.n_kt);
  }
  wgmma_wait<0>();
  reg_fence(dq);
  reg_fence(da);

  if (p.dq != nullptr) {
    const long long out = ((long long)b * p.Tq + q0) * p.H + h;  // row q0 of this head
    store_rows<bf16, ON>(static_cast<bf16*>(p.dq) + out * p.D, (long long)p.H * p.D, dq, p.scale,
                         row0, p.Tq - q0, p.D, t);
  }
  wait_for_prerequisite_grid();  // under PDL: complete only after the dK/dV pass
}

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

// A 4-D map over a bf16 operand [B, T, Hm, D] (element strides b, t, h; unit
// stride on D): boxes of 64 head-dim columns by TILE rows of one (b, h),
// 128-byte swizzled. Coordinates past the operand's edges read as zeros.
// A dimension of size 1 is never stepped; it gets the stride a compact
// tensor would have.
bool make_map(CUtensorMap* map, const void* ptr, int B, int T, int Hm, int D, long long sb,
              long long st, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hm, (cuuint64_t)T, (cuuint64_t)B};
  const long long given[3] = {sh, st, sb};
  cuuint64_t strides[3];
  cuuint64_t compact = ((cuuint64_t)D * 2 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? compact : (cuuint64_t)given[i] * 2;
    compact = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {64, 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_tc(const Params& p, bool kv_pass, bool q_pass, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_dw;
  const int hkv = p.H / p.group;
  const long long dw_row = (p.D + 7) / 8 * 8;
  if (!make_map(&tm_q, p.q, p.B, p.Tq, p.H, p.D, p.q_sb, p.q_st, p.q_sh) ||
      !make_map(&tm_k, p.k, p.B, p.Tk, hkv, p.D, p.k_sb, p.k_st, p.k_sh) ||
      !make_map(&tm_v, p.v, p.B, p.Tk, hkv, p.D, p.v_sb, p.v_st, p.v_sh) ||
      !make_map(&tm_dw, p.dw, p.B, p.Tq, p.H, p.D, (long long)p.Tq * p.H * dw_row,
                p.H * dw_row, dw_row))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kv_pass) {
    const int bytes = tc_smem_bytes<DP>(true, p.n_qt);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_tc_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_tc_kernel<DP><<<dim3(p.B * p.H, p.n_kt), TC_THREADS, bytes, stream>>>(
        p, tm_q, tm_k, tm_v, tm_dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_pass) {
    const int bytes = tc_smem_bytes<DP>(false, p.n_kt);
    auto kernel = p.dbias != nullptr ? flash_bwd_dq_tc_kernel<DP, true>
                                     : flash_bwd_dq_tc_kernel<DP, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    // Under PDL behind the dK/dV pass, when it runs.
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p.B * p.H, p.n_qt);
    config.blockDim = dim3(TC_THREADS);
    config.dynamicSmemBytes = bytes;
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = kv_pass ? 1 : 0;
    err = cudaLaunchKernelEx(&config, kernel, p, tm_q, tm_k, tm_v, tm_dw);
    const cudaError_t last = cudaGetLastError();
    if (err != cudaSuccess || (err = last) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// ===========================================================================
// f32: 3xTF32 on tf32 wgmma fed by TMA
// ===========================================================================

constexpr int TF_WG = 128;              // a warpgroup: the block's 64-row tile, 16 rows a warp
constexpr int TF_THREADS = 2 * TF_WG;   // two warpgroups, each half of every walked tile
constexpr int HALF = TILE / 2;          // walked rows a warpgroup takes
constexpr int TF_SUB = TILE * 128;      // one [64 rows][32] f32 sub-tile, 128-byte swizzled rows

// Per padded head dim: the depth of each pass's ring of walked tiles. One
// block an SM: shared memory holds it (tf_smem_bytes); D = 128 does not
// fit and runs on the mma.sync kernels.
template <int DP>
struct TfConfig;
template <>
struct TfConfig<32> {
  static constexpr int DKDV_STAGES = 3, DQ_STAGES = 3;
};
template <>
struct TfConfig<64> {
  static constexpr int DKDV_STAGES = 2, DQ_STAGES = 3;
};

// Shared memory of a pass, TB = one [64][DP] f32 tile: 1024-byte alignment
// slack; the resident tiles, each split in place into its big part and a
// small part beside it (4 TB); the walked tile's small parts (2 TB in the
// dK/dV pass, Q's and dW's; 2 TB in the dQ pass, K's and V's) and its
// transposed big and small copies (4 TB: Q^T and dW^T; 2 TB: K^T); the ring
// of two raw walked tiles a stage (with the dK/dV pass's q rows' maxes and
// dsums beside each); the barriers; the block's classes.
template <int DP>
int tf_smem_bytes(bool dkdv, int n_classes) {
  constexpr int TB = DP / 32 * TF_SUB;
  const int stages = dkdv ? TfConfig<DP>::DKDV_STAGES : TfConfig<DP>::DQ_STAGES;
  return 1024 + (dkdv ? 10 : 8) * TB + stages * (2 * TB + (dkdv ? 2 * TILE * 4 : 0)) +
         8 * (1 + stages) + n_classes;
}

__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The 128 threads of warpgroup wg wait for each other (named barrier 1 + wg;
// 0 is __syncthreads').
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(1 + wg), "n"(TF_WG) : "memory");
}

#define WG_D32 WG_D8(0), WG_D8(1), WG_D8(2), WG_D8(3)
#define WG_R16 \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}"

// d (+)= A . B, m64n32k8 in TF32, A and B K-major in shared memory (tf32
// wgmma has no transpose); `accumulate` 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32_ss(float (&d)[4][4], uint64_t a, uint64_t b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
      ", %16, %17, p, 1, 1;\n}\n"
      : WG_D32
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (+)= A . B, m64nNk8 in TF32: A from registers (per warp the m16n8k8 A
// fragment of its 16 rows: (row g, k t), (g + 8, t), (g, t + 4), (g + 8,
// t + 4)), B K-major in shared memory.
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[8][4], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " WG_R32
      ", {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : WG_D64
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[4][4], const uint32_t (&a)[4],
                                              uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 " WG_R16
      ", {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : WG_D32
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// x = big + small: big rounded to TF32 (to nearest, ties away, as
// cvt.rna.tf32.f32), small = x - big exactly, an f32 of which the tensor
// core reads the top 19 bits: |x - big - small read| < 2^-21 |x|.
__device__ __forceinline__ void split_rn(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}

// A raw f32 read by the tensor core as TF32 is truncated to its top 19
// bits; the small part beside it is x - trunc(x), exact, read truncated in
// turn: |x - big read - small read| < 2^-20 |x|.
__device__ __forceinline__ float small_of_raw(float x) {
  return x - __uint_as_float(__float_as_uint(x) & 0xffffe000u);
}

// A resident tile as TMA wrote it, split in place by the block: each
// element replaced by its big part, its small part at the same offset in
// `small` (the split maps bytes to bytes, so the layout does not matter).
template <int TB>
__device__ __forceinline__ void split_in_place(unsigned char* tile, unsigned char* small) {
#pragma unroll 4
  for (int i = threadIdx.x; i < TB / 16; i += TF_THREADS) {
    uint4 x = reinterpret_cast<uint4*>(tile)[i], b, s;
    split_rn(__uint_as_float(x.x), b.x, s.x);
    split_rn(__uint_as_float(x.y), b.y, s.y);
    split_rn(__uint_as_float(x.z), b.z, s.z);
    split_rn(__uint_as_float(x.w), b.w, s.w);
    reinterpret_cast<uint4*>(tile)[i] = b;
    reinterpret_cast<uint4*>(small)[i] = s;
  }
}

// Step `it` of DP / 16: warpgroup wg writes the small parts (small_of_raw)
// of 16 bytes a thread of its half of a raw walked tile (rows HALF * wg ..,
// 4 KB of each 32-column sub-tile), at the same offsets in `small`.
template <int DP>
__device__ __forceinline__ void small_step(unsigned char* small, const unsigned char* raw, int wg,
                                           int it) {
  const int v = it * TF_WG + threadIdx.x % TF_WG;
  const int at = (v / 256) * TF_SUB + wg * HALF * 128 + (v % 256) * 16;
  const float4 x = *reinterpret_cast<const float4*>(raw + at);
  *reinterpret_cast<float4*>(small + at) =
      make_float4(small_of_raw(x.x), small_of_raw(x.y), small_of_raw(x.z), small_of_raw(x.w));
}

// The B operand of a product that contracts over a walked tile's rows
// (dV += P^T.dW, dK += dS^T.Q, dQ += dS.K), made K-major: from the raw tile
// X [64 rows][DP] as TMA wrote it, T[d][row] split into big (at t) and
// small (TB on), each two 32-row halves of [DP][128 bytes] (DP * 128 bytes
// apart), 128-byte swizzled; warpgroup wg writes half wg, the rows it
// contracts over. Within k8 step j (rows 8j .. 8j + 7) the logical k p
// holds row 8j + 2p for p < 4 and 8j + 2(p - 4) + 1 for p >= 4: the order
// in which the accumulator relabelling (frag_split) puts the rows' columns
// in A. Step `it` of DP / 16: a thread writes one 16-byte chunk (logical k
// 4h .. 4h + 3 of step j of row d: rows 8j + 2i + h), a warp 32
// consecutive d of one chunk position: its reads are one 128-byte row of
// X, its writes 8 distinct chunks a quarter-warp, free of bank conflicts.
// Each element read is also written to `raw_small` at its own offset as
// the small part of the raw tile (small_of_raw), the B of the products that
// read X K-major.
template <int DP>
__device__ __forceinline__ void transpose_step(unsigned char* t, unsigned char* raw_small,
                                               const unsigned char* x, int wg, int it) {
  constexpr int TB = DP / 32 * TF_SUB;
  const int idx = it * TF_WG + threadIdx.x % TF_WG;
  const int d = idx % DP, jl = idx / DP / 2, h = idx / DP % 2, j = 4 * wg + jl;
  const int col = (d / 32) * TF_SUB + 4 * (d % 4);
  uint32_t big[4], small[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 8 * j + 2 * i + h;
    const int at = col + r * 128 + 16 * ((d % 32 / 4) ^ (r % 8));
    const float v = *reinterpret_cast<const float*>(x + at);
    *reinterpret_cast<float*>(raw_small + at) = small_of_raw(v);
    split_rn(v, big[i], small[i]);
  }
  unsigned char* dst = t + wg * (DP * 128) + d * 128 + 16 * ((2 * jl + h) ^ (d % 8));
  *reinterpret_cast<uint4*>(dst) = make_uint4(big[0], big[1], big[2], big[3]);
  *reinterpret_cast<uint4*>(dst + TB) = make_uint4(small[0], small[1], small[2], small[3]);
}

// The tf32 A fragments (big, small) of the N k8 steps of a [64][8N]
// accumulator tile c: step j's are the C fragment of n8 tile j relabelled
// (logical k t and t + 4 read as physical 2t and 2t + 1, as in frag_c), so
// A entry r of step j is c[j][a_of(r)].
__device__ __forceinline__ int a_of(int r) { return r == 1 ? 2 : r == 2 ? 1 : r; }

template <int N>
__device__ __forceinline__ void frag_split(uint32_t (&big)[N][4], uint32_t (&small)[N][4],
                                           const float (&c)[N][4]) {
#pragma unroll
  for (int j = 0; j < N; ++j)
#pragma unroll
    for (int r = 0; r < 4; ++r) split_rn(c[j][a_of(r)], big[j][r], small[j][r]);
}

// X = A.B^T over the padded head dim as 3xTF32, in two parts, A a [64][DP]
// resident tile (big and small parts), B a warpgroup's 32 rows of a walked
// tile (HALF * 128 bytes into each 32-column sub-tile; raw, its own big
// part read truncated, and its small parts), every operand K-major in
// 32-column swizzled sub-tiles. The first part, small.big and big.big a k8
// step, reads B raw; `beside(kk)` runs after k8 step kk's products are
// issued (a wgmma's issue waits for room in the tensor core's queue, so
// work put between the steps runs while the products do; it must not touch
// x), and writes B's small parts. The second part, big.small, once they are
// written. Neither commits.
template <int DP, typename Beside>
__device__ __forceinline__ void issue_ss_raw(float (&x)[4][4], const unsigned char* a_big,
                                             const unsigned char* a_small,
                                             const unsigned char* b_raw, Beside&& beside) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    // k8 step kk: 32 bytes into the 128-byte swizzled rows of its sub-tile.
    const int off = (kk / 4) * TF_SUB + (kk % 4) * 32;
    const uint64_t bb = sw128_desc(b_raw + off, 16, 1024);
    wgmma_tf32_ss(x, sw128_desc(a_small + off, 16, 1024), bb, kk > 0);
    wgmma_tf32_ss(x, sw128_desc(a_big + off, 16, 1024), bb, 1);
    beside(kk);
  }
}

template <int DP>
__device__ __forceinline__ void issue_ss_small(float (&x)[4][4], const unsigned char* a_big,
                                               const unsigned char* b_small) {
#pragma unroll
  for (int kk = 0; kk < DP / 8; ++kk) {
    const int off = (kk / 4) * TF_SUB + (kk % 4) * 32;
    wgmma_tf32_ss(x, sw128_desc(a_big + off, 16, 1024), sw128_desc(b_small + off, 16, 1024), 1);
  }
}

// acc = A.B over a warpgroup's 32 walked rows, as 3xTF32, one commit group:
// A the fragments of the 4 k8 steps in registers, B its half of a
// transposed copy (transpose_step; big at b, small TB on), k8 step j 32
// bytes into the half's rows; `beside(j)` as in issue_ss_raw.
template <int DP, int ON, typename Beside>
__device__ __forceinline__ void issue_rs3(float (&acc)[ON][4], const uint32_t (&a_big)[HALF / 8][4],
                                          const uint32_t (&a_small)[HALF / 8][4],
                                          const unsigned char* b, Beside&& beside) {
  constexpr int TB = DP / 32 * TF_SUB;
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    const uint64_t bb = sw128_desc(b + j * 32, 16, 1024);
    wgmma_tf32_rs(acc, a_small[j], bb, j > 0);
    wgmma_tf32_rs(acc, a_big[j], sw128_desc(b + TB + j * 32, 16, 1024), 1);
    wgmma_tf32_rs(acc, a_big[j], bb, 1);
    beside(j);
  }
  wgmma_commit();
}

template <int ON>
__device__ __forceinline__ void add_into(float (&total)[ON][4], const float (&part)[ON][4]) {
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) total[j][e] += part[j][e];
}

// P^T from S^T over a warpgroup's 32 q columns in the dK/dV pass: entry e of
// n8 tile j is kv row row0 + 8 (e >> 1), q column q0 + 8j + 2t + (e & 1);
// m_s the half's raw maxes (made base 2 here, +inf past Tq). BIASED: the
// tile's bias is read (an instantiation of its own).
template <bool BIASED>
__device__ __forceinline__ void probs_t_half(float (&pf)[HALF / 8][4],
                                             const float (&s)[HALF / 8][4], const Params& p,
                                             const float* m_s, float scale2, int q0, int k0,
                                             int row0, int t, const bool (&row_in)[2]) {
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j) {
    const int c = q0 + j * 8 + 2 * t;
    const float2 mr = *reinterpret_cast<const float2*>(m_s + j * 8 + 2 * t);
    const float m[2] = {row_max2(mr.x, c < p.Tq), row_max2(mr.y, c + 1 < p.Tq)};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * scale2;
      if (BIASED) {
        const int qr = min(c + (e & 1), p.Tq - 1), kr = min(k0 + row0 + 8 * (e >> 1), p.Tk - 1);
        x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
      }
      pf[j][e] = row_in[e >> 1] ? fast_exp2(x - m[e & 1]) : 0.f;
    }
  }
}

// P from S over a warpgroup's 32 kv columns in the dQ pass: entry e of n8
// tile j is q row row0 + 8 (e >> 1), kv column k0 + 8j + 2t + (e & 1);
// columns past Tk get 0.
template <bool BIASED>
__device__ __forceinline__ void probs_half(float (&pf)[HALF / 8][4], const float (&s)[HALF / 8][4],
                                           const Params& p, const float (&m2)[2], float scale2,
                                           int q0, int k0, int row0, int t) {
#pragma unroll
  for (int j = 0; j < HALF / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
      float x = s[j][e] * scale2;
      if (BIASED) {
        const int qr = min(q0 + row0 + 8 * r, p.Tq - 1), kr = min(col, p.Tk - 1);
        x = fmaf(p.bias[qr * p.bias_sq + kr * p.bias_sk], LOG2E, x);
      }
      pf[j][e] = col < p.Tk ? fast_exp2(x - m2[r]) : 0.f;
    }
}

// The two warpgroups' sums of the block's outputs, added in a fixed order
// (warpgroup 0's, then warpgroup 1's): each writes the one it does not
// store into `xfer` ([ON * 4][TF_WG] floats an output, a thread's entries
// TF_WG apart: conflict-free), and after the barrier adds the other's into
// the one it stores.
template <int ON>
__device__ __forceinline__ void put_sum(float* xfer, const float (&x)[ON][4]) {
  const int tw = threadIdx.x % TF_WG;
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) xfer[(4 * j + e) * TF_WG + tw] = x[j][e];
}

template <int ON>
__device__ __forceinline__ void take_sum(float (&x)[ON][4], const float* xfer, bool first) {
  const int tw = threadIdx.x % TF_WG;
#pragma unroll
  for (int j = 0; j < ON; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float other = xfer[(4 * j + e) * TF_WG + tw];
      x[j][e] = first ? x[j][e] + other : other + x[j][e];
    }
}

// The dK/dV pass. Grid (B*H, kv tiles) in grouped order; two warpgroups a
// block, warp w of each owning kv rows 16 (w % 4) .. + 15 of the block's kv
// tile, warpgroup wg taking q rows HALF * wg .. + HALF - 1 of every walked
// tile. K and V are resident, split in place; each live q tile's Q and dW
// come raw through the ring (warp 0 loads them, the maxes and dsums beside
// them), and each warpgroup writes its half's transposed copies and small
// parts. Per tile and warpgroup: S^T = K.Q^T and dP^T = V.dW^T over its 32
// q columns (shared-memory operands), the copies written beside their
// issue; P^T; dV's part = P^T.dW, dS^T computed beside it; dK's part =
// dS^T.Q. Each part starts from zero and is added to the warpgroup's dK and
// dV totals in f32; the two warpgroups' totals are added at the end.
template <int DP>
__global__ void __launch_bounds__(TF_THREADS, 1)
    flash_bwd_dkdv_tf32_kernel(const __grid_constant__ Params p,
                               const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_dw) {
  constexpr int S = TfConfig<DP>::DKDV_STAGES;
  constexpr int NSUB = DP / 32;       // 32-column sub-tiles of the head dim
  constexpr int TB = NSUB * TF_SUB;   // bytes of one [TILE][DP] f32 tile
  constexpr int HN = HALF / 8;        // n8 tiles of a warpgroup's S^T (q columns)
  constexpr int ON = DP / 8;          // n8 tiles of dK, dV (head-dim columns)

  extern __shared__ unsigned char smem_raw[];
  unsigned char* k_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* k_small = k_s + TB;
  unsigned char* v_s = k_small + TB;
  unsigned char* v_small = v_s + TB;
  unsigned char* q_small = v_small + TB;
  unsigned char* dw_small = q_small + TB;
  unsigned char* q_t = dw_small + TB;  // Q^T big, small
  unsigned char* dw_t = q_t + 2 * TB;  // dW^T big, small
  unsigned char* ring = dw_t + 2 * TB;  // [stage][Q, dW][TB]
  float* stats = reinterpret_cast<float*>(ring + S * 2 * TB);  // [stage][m, dsum][TILE]
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(stats + S * 2 * TILE);
  uint64_t* full = kv_full + 1;
  unsigned char* cls = reinterpret_cast<unsigned char*>(full + S);  // kv tile's column

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, wg = threadIdx.x / TF_WG;
  launch_dependents();  // the dQ pass, if launched under PDL, may be scheduled now
  int bh, kt;
  grouped_order(bh, kt);  // kv tile 0 walks the most q tiles under a causal mask
  const int b = bh / p.H, h = bh % p.H;
  const int k0 = kt * TILE;

  if (threadIdx.x == 0) {
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v, &tm_dw}) prefetch_map(map);
    mbar_init(kv_full, 1);
    // A stage is full once TMA's bytes and warp 0's 32 lanes' copies of the
    // statistics have landed.
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1 + 32);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int hk = h / p.group;
    mbar_expect_tx(kv_full, 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(k_s + s * TF_SUB, &tm_k, kv_full, s * 32, hk, k0, b);
      tma_load_4d(v_s + s * TF_SUB, &tm_v, kv_full, s * 32, hk, k0, b);
    }
  }
  for (int i = threadIdx.x; i < p.n_qt; i += TF_THREADS)
    cls[i] = p.classes[(long long)i * p.n_kt + kt];
  __syncthreads();

  // Warp 0 loads live q tile `qt` into `stage`: Q and dW by TMA (lane 0),
  // the rows' maxes and dsums by 4-byte cp.async (rows past Tq zero-filled).
  const float* bmax = p.block_max + (long long)bh * p.Tq;
  const float* dsum = p.dsum + (long long)bh * p.Tq;
  auto load = [&](int qt, int stage) {
    const int q0 = qt * TILE;
    unsigned char* q_s = ring + stage * 2 * TB;
    if (lane == 0) {
      mbar_expect_tx(&full[stage], 2 * TB);
      for (int s = 0; s < NSUB; ++s) {
        tma_load_4d(q_s + s * TF_SUB, &tm_q, &full[stage], s * 32, h, q0, b);
        tma_load_4d(q_s + TB + s * TF_SUB, &tm_dw, &full[stage], s * 32, h, q0, b);
      }
    }
    float* st = stats + stage * 2 * TILE;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + lane + 32 * r, at = min(row, p.Tq - 1), bytes = row < p.Tq ? 4 : 0;
      cp_async4(st + lane + 32 * r, bmax + at, bytes);
      cp_async4(st + TILE + lane + 32 * r, dsum + at, bytes);
    }
    cp_async_arrive(&full[stage]);
  };
  int ahead = next_live_tile(cls, 0, p.n_qt);
  for (int s = 0; s < S && ahead < p.n_qt; ++s) {
    if (warp == 0) load(ahead, s);
    ahead = next_live_tile(cls, ahead + 1, p.n_qt);
  }

  // This thread's entries of an n8 tile j of its warpgroup's S^T: kv rows
  // row0 and row0 + 8 (e >> 1), q columns HALF * wg + 8j + 2t + (e & 1).
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp % 4 * 16 + g;
  const bool row_in[2] = {k0 + row0 < p.Tk, k0 + row0 + 8 < p.Tk};
  const float scale2 = p.scale * LOG2E;
  float dk[ON][4], dv[ON][4], part[ON][4], s[HN][4], dp[HN][4];
  uint32_t a_big[HN][4], a_small[HN][4];
  zero(dk);
  zero(dv);

  mbar_wait(kv_full, 0);  // even with no live q tile: no TMA write outlives the block
  split_in_place<TB>(k_s, k_small);
  split_in_place<TB>(v_s, v_small);
  fence_proxy_async();
  __syncthreads();  // the resident splits
  const int own = wg * HALF * 128;  // this warpgroup's rows in a walked sub-tile
  int qt = next_live_tile(cls, 0, p.n_qt);
  for (int i = 0; qt < p.n_qt; ++i) {
    const int stage = i % S, q0 = qt * TILE + wg * HALF;  // this warpgroup's first q row
    const unsigned char* q_s = ring + stage * 2 * TB;
    const unsigned char* dw_s = q_s + TB;
    const float* m_s = stats + stage * 2 * TILE + wg * HALF;
    const int next = next_live_tile(cls, qt + 1, p.n_qt);
    // S^T = K.Q^T and dP^T = V.dW^T over this warpgroup's q rows: the parts
    // that read Q and dW raw, the transposed copies and small parts written
    // beside their steps (one step every other k8 step); then the parts that
    // read the small parts.
    mbar_wait(&full[stage], (i / S) & 1);
    wgmma_fence();
    issue_ss_raw<DP>(s, k_s, k_small, q_s + own, [&](int kk) {
      if (kk % 2 == 0) transpose_step<DP>(q_t, q_small, q_s, wg, kk / 2);
    });
    issue_ss_raw<DP>(dp, v_s, v_small, dw_s + own, [&](int kk) {
      if (kk % 2 == 0) transpose_step<DP>(dw_t, dw_small, dw_s, wg, kk / 2);
    });
    fence_proxy_async();
    warpgroup_sync(wg);  // the warpgroup's copies and small parts are written
    issue_ss_small<DP>(s, k_s, q_small + own);
    wgmma_commit();
    issue_ss_small<DP>(dp, v_s, dw_small + own);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);
    // P^T, while dP^T's product runs, split into A fragments.
    float pf[HN][4];
    if (cls[qt] != CLASS_ZERO)
      probs_t_half<true>(pf, s, p, m_s, scale2, q0, k0, row0, t, row_in);
    else
      probs_t_half<false>(pf, s, p, m_s, scale2, q0, k0, row0, t, row_in);
    frag_split(a_big, a_small, pf);
    wgmma_wait<0>();
    reg_fence(dp);
    // dV's part = P^T.dW; beside its steps, dS^T = P^T * (dP^T + dsum) in
    // place of dP^T (P^T = big + small exactly; entry r of A step j is
    // accumulator entry a_of(r)).
    const float* ds_s = m_s + TILE;
    wgmma_fence();
    issue_rs3<DP>(part, a_big, a_small, dw_t + wg * (DP * 128), [&](int j) {
      const float2 dc = *reinterpret_cast<const float2*>(ds_s + j * 8 + 2 * t);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float pr = __uint_as_float(a_big[j][r]) + __uint_as_float(a_small[j][r]);
        dp[j][a_of(r)] = pr * (dp[j][a_of(r)] + (r >> 1 ? dc.y : dc.x));
      }
    });
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(a_big);
    reg_fence(a_small);
    add_into(dv, part);
    frag_split(a_big, a_small, dp);
    wgmma_fence();
    issue_rs3<DP>(part, a_big, a_small, q_t + wg * (DP * 128), [](int) {});  // dK's part
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(a_big);
    reg_fence(a_small);
    add_into(dk, part);
    fence_proxy_async();
    __syncthreads();  // both warpgroups are done with the stage and the copies: refill
    if (warp == 0 && ahead < p.n_qt) load(ahead, stage);
    if (ahead < p.n_qt) ahead = next_live_tile(cls, ahead + 1, p.n_qt);
    qt = next;
  }

  // Warpgroup 0 stores dV, warpgroup 1 dK, each the sum of both (q_t is free).
  float* xfer = reinterpret_cast<float*>(q_t);
  if (wg == 0)
    put_sum(xfer, dk);
  else
    put_sum(xfer + ON * 4 * TF_WG, dv);
  __syncthreads();
  if (wg == 0)
    take_sum(dv, xfer + ON * 4 * TF_WG, true);
  else
    take_sum(dk, xfer, false);
  const long long out = ((long long)b * p.Tk + k0) * p.H + h;  // row k0 of this head
  const long long stride = (long long)p.H * p.D;
  if (wg == 1 && p.dk != nullptr)
    store_rows<float, ON>(static_cast<float*>(p.dk) + out * p.D, stride, dk, p.scale, row0,
                          p.Tk - k0, p.D, t);
  if (wg == 0 && p.dv != nullptr)
    store_rows<float, ON>(static_cast<float*>(p.dv) + out * p.D, stride, dv, 1.f, row0,
                          p.Tk - k0, p.D, t);
}

// The dQ pass. Grid (B*H, q tiles) in grouped order, the q tiles with the
// most live kv tiles under a causal mask first; two warpgroups a block, warp
// w of each owning q rows 16 (w % 4) .. + 15 of the block's q tile,
// warpgroup wg taking kv rows HALF * wg .. + HALF - 1 of every walked tile.
// Q and dW are resident, split in place; each live kv tile's K and V come
// raw through the ring (thread 0 loads them). Per tile and warpgroup: S =
// Q.K^T and dP = dW.V^T over its 32 kv columns, K^T's transposed copy and
// the small parts written beside their issue; P; dS; dQ's part = dS.K, added
// to the warpgroup's dQ total in f32; the two totals are added at the end.
// DBIAS: dS is also added into dbias (an instantiation of its own, as in
// bf16).
template <int DP, bool DBIAS>
__global__ void __launch_bounds__(TF_THREADS, 1)
    flash_bwd_dq_tf32_kernel(const __grid_constant__ Params p,
                             const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_dw) {
  constexpr int S = TfConfig<DP>::DQ_STAGES;
  constexpr int NSUB = DP / 32;
  constexpr int TB = NSUB * TF_SUB;
  constexpr int HN = HALF / 8;  // n8 tiles of a warpgroup's S (kv columns)
  constexpr int ON = DP / 8;    // n8 tiles of dQ

  extern __shared__ unsigned char smem_raw[];
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* q_small = q_s + TB;
  unsigned char* dw_s = q_small + TB;
  unsigned char* dw_small = dw_s + TB;
  unsigned char* k_small = dw_small + TB;
  unsigned char* v_small = k_small + TB;
  unsigned char* k_t = v_small + TB;  // K^T big, small
  unsigned char* ring = k_t + 2 * TB;  // [stage][K, V][TB]
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(ring + S * 2 * TB);
  uint64_t* full = qd_full + 1;
  unsigned char* cls = reinterpret_cast<unsigned char*>(full + S);  // q tile's row

  const int wg = threadIdx.x / TF_WG;
  int bh, order;
  grouped_order(bh, order);
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - order, q0 = qt * TILE;  // the last q tile walks the most
  const int hk = h / p.group;

  if (threadIdx.x == 0) {
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v, &tm_dw}) prefetch_map(map);
    mbar_init(qd_full, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(qd_full, 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(q_s + s * TF_SUB, &tm_q, qd_full, s * 32, h, q0, b);
      tma_load_4d(dw_s + s * TF_SUB, &tm_dw, qd_full, s * 32, h, q0, b);
    }
  }
  for (int j = threadIdx.x; j < p.n_kt; j += TF_THREADS)
    cls[j] = p.classes[(long long)qt * p.n_kt + j];
  __syncthreads();

  // Thread 0 loads live kv tile `kt`'s K and V into `stage` by TMA.
  auto load = [&](int kt, int stage) {
    unsigned char* k_s = ring + stage * 2 * TB;
    mbar_expect_tx(&full[stage], 2 * TB);
    for (int s = 0; s < NSUB; ++s) {
      tma_load_4d(k_s + s * TF_SUB, &tm_k, &full[stage], s * 32, hk, kt * TILE, b);
      tma_load_4d(k_s + TB + s * TF_SUB, &tm_v, &full[stage], s * 32, hk, kt * TILE, b);
    }
  };
  int ahead = next_live_tile(cls, 0, p.n_kt);
  for (int s = 0; s < S && ahead < p.n_kt; ++s) {
    if (threadIdx.x == 0) load(ahead, s);
    ahead = next_live_tile(cls, ahead + 1, p.n_kt);
  }

  // This thread's entries of an n8 tile j of its warpgroup's S: q rows row0
  // and row0 + 8 (e >> 1), kv columns HALF * wg + 8j + 2t + (e & 1).
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int row0 = warp % 4 * 16 + g;
  float m2[2], ds[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + 8 * r;
    const long long at = (long long)bh * p.Tq + min(row, p.Tq - 1);
    m2[r] = row_max2(p.block_max[at], row < p.Tq);
    ds[r] = row < p.Tq ? p.dsum[at] : 0.f;
  }
  const float scale2 = p.scale * LOG2E;
  float dq[ON][4], part[ON][4], s[HN][4], dp[HN][4];
  uint32_t a_big[HN][4], a_small[HN][4];
  zero(dq);

  mbar_wait(qd_full, 0);  // even with no live kv tile: no TMA write outlives the block
  split_in_place<TB>(q_s, q_small);
  split_in_place<TB>(dw_s, dw_small);
  fence_proxy_async();
  __syncthreads();  // the resident splits
  const int own = wg * HALF * 128;  // this warpgroup's rows in a walked sub-tile
  int kt = next_live_tile(cls, 0, p.n_kt);
  for (int i = 0; kt < p.n_kt; ++i) {
    const int stage = i % S, k0 = kt * TILE + wg * HALF;  // this warpgroup's first kv row
    const unsigned char* k_s = ring + stage * 2 * TB;
    const unsigned char* v_s = k_s + TB;
    const int next = next_live_tile(cls, kt + 1, p.n_kt);
    // S = Q.K^T and dP = dW.V^T over this warpgroup's kv rows: the parts
    // that read K and V raw, K^T's transposed copy and the small parts
    // written beside their steps; then the parts that read the small parts.
    mbar_wait(&full[stage], (i / S) & 1);
    wgmma_fence();
    issue_ss_raw<DP>(s, q_s, q_small, k_s + own, [&](int kk) {
      if (kk % 2 == 0) transpose_step<DP>(k_t, k_small, k_s, wg, kk / 2);
    });
    issue_ss_raw<DP>(dp, dw_s, dw_small, v_s + own, [&](int kk) {
      if (kk % 2 == 0) small_step<DP>(v_small, v_s, wg, kk / 2);
    });
    fence_proxy_async();
    warpgroup_sync(wg);  // the warpgroup's copy and small parts are written
    issue_ss_small<DP>(s, q_s, k_small + own);
    wgmma_commit();
    issue_ss_small<DP>(dp, dw_s, v_small + own);
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(s);
    float pf[HN][4];  // P, then dS
    if (cls[kt] != CLASS_ZERO)
      probs_half<true>(pf, s, p, m2, scale2, q0, k0, row0, t);
    else
      probs_half<false>(pf, s, p, m2, scale2, q0, k0, row0, t);
    wgmma_wait<0>();
    reg_fence(dp);

    // dS = P * (dP + dsum) (and into dbias), split into A fragments.
#pragma unroll
    for (int j = 0; j < HN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, col = k0 + j * 8 + 2 * t + (e & 1);
        pf[j][e] *= dp[j][e] + ds[r];
        if (DBIAS && col < p.Tk && q0 + row0 + 8 * r < p.Tq)
          atomicAdd(p.dbias + (long long)(q0 + row0 + 8 * r) * p.Tk + col, pf[j][e]);
      }
    frag_split(a_big, a_small, pf);
    wgmma_fence();
    issue_rs3<DP>(part, a_big, a_small, k_t + wg * (DP * 128), [](int) {});  // dQ's part
    wgmma_wait<0>();
    reg_fence(part);
    reg_fence(a_big);
    reg_fence(a_small);
    add_into(dq, part);
    fence_proxy_async();
    __syncthreads();  // both warpgroups are done with the stage and the copies: refill
    if (threadIdx.x == 0 && ahead < p.n_kt) load(ahead, stage);
    if (ahead < p.n_kt) ahead = next_live_tile(cls, ahead + 1, p.n_kt);
    kt = next;
  }

  // Warpgroup 0 stores dQ, the sum of both (k_t is free).
  float* xfer = reinterpret_cast<float*>(k_t);
  if (wg == 1) put_sum(xfer, dq);
  __syncthreads();
  if (wg == 0) {
    take_sum(dq, xfer, true);
    if (p.dq != nullptr) {
      const long long out = ((long long)b * p.Tq + q0) * p.H + h;  // row q0 of this head
      store_rows<float, ON>(static_cast<float*>(p.dq) + out * p.D, (long long)p.H * p.D, dq,
                            p.scale, row0, p.Tq - q0, p.D, t);
    }
  }
  wait_for_prerequisite_grid();  // under PDL: complete only after the dK/dV pass
}

// A 4-D map over an f32 operand [B, T, Hm, D] (element strides b, t, h; unit
// stride on D): boxes of 32 head-dim columns (one 128-byte row) by TILE rows
// of one (b, h), 128-byte swizzled. Coordinates past the operand's edges
// read as zeros. A dimension of size 1 is never stepped; it gets the stride
// a compact tensor would have.
bool make_map_f32(CUtensorMap* map, const void* ptr, int B, int T, int Hm, int D, long long sb,
                  long long st, long long sh) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hm, (cuuint64_t)T, (cuuint64_t)B};
  const long long given[3] = {sh, st, sb};
  cuuint64_t strides[3];
  cuuint64_t compact = ((cuuint64_t)D * 4 + 15) / 16 * 16;
  for (int i = 0; i < 3; ++i) {
    strides[i] = dims[i + 1] == 1 ? compact : (cuuint64_t)given[i] * 4;
    compact = strides[i] * dims[i + 1];
  }
  const cuuint32_t box[4] = {32, 1, TILE, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr), dims, strides,
                box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP>
cudaError_t launch_tf32(const Params& p, bool kv_pass, bool q_pass, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_dw;
  const int hkv = p.H / p.group;
  const long long dw_row = p.D;
  if (!make_map_f32(&tm_q, p.q, p.B, p.Tq, p.H, p.D, p.q_sb, p.q_st, p.q_sh) ||
      !make_map_f32(&tm_k, p.k, p.B, p.Tk, hkv, p.D, p.k_sb, p.k_st, p.k_sh) ||
      !make_map_f32(&tm_v, p.v, p.B, p.Tk, hkv, p.D, p.v_sb, p.v_st, p.v_sh) ||
      !make_map_f32(&tm_dw, p.dw, p.B, p.Tq, p.H, p.D, (long long)p.Tq * p.H * dw_row,
                    p.H * dw_row, dw_row))
    return cudaErrorInvalidValue;
  cudaError_t err;
  if (kv_pass) {
    const int bytes = tf_smem_bytes<DP>(true, p.n_qt);
    err = cudaFuncSetAttribute(flash_bwd_dkdv_tf32_kernel<DP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    flash_bwd_dkdv_tf32_kernel<DP><<<dim3(p.B * p.H, p.n_kt), TF_THREADS, bytes, stream>>>(
        p, tm_q, tm_k, tm_v, tm_dw);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (q_pass) {
    const int bytes = tf_smem_bytes<DP>(false, p.n_kt);
    auto kernel = p.dbias != nullptr ? flash_bwd_dq_tf32_kernel<DP, true>
                                     : flash_bwd_dq_tf32_kernel<DP, false>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return err;
    // Under PDL behind the dK/dV pass, when it runs.
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t config = {};
    config.gridDim = dim3(p.B * p.H, p.n_qt);
    config.blockDim = dim3(TF_THREADS);
    config.dynamicSmemBytes = bytes;
    config.stream = stream;
    config.attrs = &attr;
    config.numAttrs = kv_pass ? 1 : 0;
    err = cudaLaunchKernelEx(&config, kernel, p, tm_q, tm_k, tm_v, tm_dw);
    const cudaError_t last = cudaGetLastError();
    if (err != cudaSuccess || (err = last) != cudaSuccess) return err;
  }
  return cudaSuccess;
}

// 16-byte copies: unit stride on D (or one column), a 16-byte aligned base,
// and every row stride a multiple of 16 bytes.
int rows16(const void* ptr, bool unit_stride, std::initializer_list<long long> strides) {
  bool ok = unit_stride && aligned16(ptr);
  for (long long st : strides) ok = ok && (st * 4) % 16 == 0;
  return ok;
}

}  // namespace

// dtype (q, k, v and the outputs dq, dk, dv): 0 = float32 on the mma.sync
// kernels (any strides), 1 = bfloat16, 2 = float32 by TMA and tf32 wgmma (D
// <= 64); bias, block_max, dsum and dbias are f32. classes: the bias's tile
// classes ([ceil(Tq/64), ceil(Tk/64)] uint8, 0 MASKED, 1 ZERO_BIAS, 2 BIAS).
// block_max, dsum: [B, H, Tq] contiguous. dweighted: f32 [B, Tq, H, D]
// contiguous for dtypes 0 and 2 (for 2, D a multiple of 4); for dtype 1
// already rounded to bf16, [B, Tq, H, DW] contiguous with DW = D rounded up
// to a multiple of 8 (columns past D are never read). dq [B, Tq, H, D], dk
// and dv [B, Tk, H, D] contiguous (per query head), dbias [Tq, Tk] contiguous and zeroed. dims: B, H, Tq, Tk, D,
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
  p.dw = dweighted;
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
      p.B * p.H > 65535 || dtype < 0 || dtype > 2)
    return (int)cudaErrorInvalidValue;
  p.n_qt = (p.Tq + TILE - 1) / TILE;
  p.n_kt = (p.Tk + TILE - 1) / TILE;
  p.scale = (float)(1.0 / sqrt((double)p.D));
  long long* dst[] = {&p.q_sb, &p.q_st, &p.q_sh, &p.q_sd, &p.k_sb, &p.k_st,
                      &p.k_sh, &p.k_sg, &p.k_sd, &p.v_sb, &p.v_st, &p.v_sh,
                      &p.v_sg, &p.v_sd, &p.bias_sq, &p.bias_sk};
  for (int i = 0; i < 16; ++i) *dst[i] = strides[i];
  const bool kv_pass = (needs & 6) != 0, q_pass = (needs & 9) != 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    const bool unit_d = p.D == 1;  // one column: its stride is never used
    p.vec_q = rows16(q, unit_d || p.q_sd == 1, {p.q_sb, p.q_st, p.q_sh});
    p.vec_k = rows16(k, unit_d || p.k_sd == 1, {p.k_sb, p.k_st, p.k_sh, p.k_sg});
    p.vec_v = rows16(v, unit_d || p.v_sd == 1, {p.v_sb, p.v_st, p.v_sh, p.v_sg});
    p.vec_dw = rows16(dweighted, true, {(long long)p.D, (long long)p.H * p.D});
    if (p.D <= 32) return (int)launch_f32<32>(p, kv_pass, q_pass, s);
    if (p.D <= 64) return (int)launch_f32<64>(p, kv_pass, q_pass, s);
    return (int)launch_f32<128>(p, kv_pass, q_pass, s);
  }
  if (dtype == 2) {
    // f32 by TMA: unit stride on D, 16-byte aligned bases and strides that
    // are multiples of 4 elements; D <= 64, a multiple of 4.
    bool ok = p.D <= 64 && p.D % 4 == 0 && p.q_sd == 1 && p.k_sd == 1 && p.v_sd == 1 && aligned16(q) &&
              aligned16(k) && aligned16(v) && aligned16(dweighted);
    const long long rows[] = {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh,
                              p.k_sg, p.v_sb, p.v_st, p.v_sh, p.v_sg};
    for (long long st : rows) ok = ok && st % 4 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (p.D <= 32) return (int)launch_tf32<32>(p, kv_pass, q_pass, s);
    return (int)launch_tf32<64>(p, kv_pass, q_pass, s);
  }
  // TMA: unit stride on D, 16-byte aligned bases and strides.
  bool ok = p.q_sd == 1 && p.k_sd == 1 && p.v_sd == 1 && aligned16(q) && aligned16(k) &&
            aligned16(v) && aligned16(dweighted);
  const long long rows[] = {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh,
                            p.k_sg, p.v_sb, p.v_st, p.v_sh, p.v_sg};
  for (long long st : rows) ok = ok && st % 8 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  if (p.D <= 64) return (int)launch_tc<64>(p, kv_pass, q_pass, s);
  return (int)launch_tc<128>(p, kv_pass, q_pass, s);
}
