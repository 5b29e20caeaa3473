// One flash-attention block step for Hopper (sm_90a), hand-written CUDA C++.
//
// Replaces the Pallas TPU kernel `_flash_block_kernel`
// (jobset_tpu/ops/flash_block.py:194, launched by `_block_attention_pallas`).
// It computes the same function, not the same blocking:
//
//   logits = q . k^T * D^-1/2 + bias          (f32 accumulation)
//   running max m, unnormalized sum l, acc += p . v, each rescaled by
//   exp(m_old - m_new); logits <= NEG_INF/2 give p = 0, so a fully
//   masked row ends with max ~ NEG_INF, sum 0 and weighted 0.
//
// Outputs: block_max and block_sum [B, H, Tq] f32, weighted [B, Tq, H, D]
// f32 (unnormalized), plain arrays with no lane packing.
//
// What bounds it. At the flagship prefill block (B=8, H=16, Tq=Tk=512,
// D=64, bf16, causal triangle) the call must read q, k, v (25.2 MB) and the
// bias (1.0 MB) and write weighted f32 (16.8 MB) and the stats (0.5 MB):
// 43.5 MB, 13 us at 3.35 TB/s. The unmasked half of the products is
// 4.3 GFLOP, 4.4 us on the bf16 tensor cores (989 TFLOP/s), but 64 us on
// the f32 pipes (67 TFLOP/s). So on tensor cores the bound is memory; what
// keeps a simple kernel from it is the work around the products: address arithmetic, the softmax's
// exponentials and waits for data. The design moves each of those off the
// consumer threads:
//
// - Tile classes (tile_classes_kernel). A pass over the [Tq, Tk] bias
//   writes one class per 64x64 (q tile, kv tile):
//   0 = every entry <= NEG_INF/2 (the tile adds p = 0 everywhere and cannot
//   raise a max above NEG_INF/2, so it is skipped: no load, no product),
//   1 = every entry exactly 0.0 (the bias is not read), 2 = anything else
//   (the bias tile is read). Exact, not approximate. The causal triangle
//   at T=512 has 28 tiles of class 0, 28 of class 1 and 8 of class 2.
//   What bounds the pass: its bytes (1 MB at [512, 512], 0.3 us at 3.35
//   TB/s) are far below what any launch costs; its time is a launch, one
//   DRAM round trip and a block-wide vote, a few us, and on the block
//   kernel's serial chain it also costs the drain and launch gap between
//   two dependent grids. So the design takes it off that chain rather than
//   polishing its body. (1) The main path's masks (the causal triangle and
//   the zero bias) depend on the shape alone: ops/flash_block.py builds each
//   once with its classes (`constant_mask`) and hands them to the block
//   call, which then launches the block kernel alone. (2) A call without
//   classes launches both grids from one host call (flash_block_forward),
//   the block kernel under programmatic dependent launch (PDL): the pass
//   issues griddepcontrol.launch_dependents at entry, so the block grid is
//   scheduled while the pass runs; each block kernel does what reads no
//   class first (barriers, Q's load, tensor-map prefetch), then waits in
//   griddepcontrol.wait until the pass has completed and its writes are
//   visible, then reads its row of classes. This is safe because PDL
//   relaxes only the dependency on the pass: q, k, v and the bias come from
//   work ahead of the pass in stream order, which a normally launched pass
//   waits for, and the block kernel writes nothing before its wait. The
//   kernel after the block kernel is launched normally and waits for it to
//   complete. Launched without the attribute, griddepcontrol.wait returns
//   at once. Each thread loads its 16 entries as four 16-byte vectors where
//   the bias rows are unit-stride and 16-byte aligned (the main path's
//   masks are contiguous), as 16 scalars elsewhere.
// - bf16: tensor cores (flash_block_tc_kernel). One block per (batch*head,
//   64-row q tile): one consumer warpgroup (four warps, 16 q rows each) and
//   one producer warp. The producer's lane 0 starts TMA loads of the K and
//   V tiles of every live kv tile into a ring of stages in shared memory;
//   each load completes on an mbarrier, and the consumers free a stage on
//   another. So loads cost the consumers no registers and
//   no instructions, and run ahead of the products. TMA's 128-byte swizzle
//   is the layout the wgmma descriptors name, so no thread reshuffles a
//   tile. S = Q.K^T is wgmma.m64n64k16 with Q and K in shared memory and f32
//   accumulators in registers. The C fragments of two n8 column groups of
//   S are the A fragment of one k16 step of P.V, so P goes from the
//   accumulators to bf16 A registers (rounded against the running max, as
//   the TPU kernel's p.astype(v.dtype)) without shared memory, and
//   O += P.V is wgmma.m64nDk16 with V read in its [kv, D] layout through
//   the transpose bit. m, l and O stay in registers across the kv loop.
//   Each step of that loop waits on the one before (K, S, softmax, V, P.V),
//   so what keeps the tensor cores fed is the number of warpgroups an SM
//   holds: at D <= 64 two K/V stages and 96 registers a thread fit four
//   blocks on an SM, with no setmaxnreg hand-over between producer and
//   consumers. The block reads its row of tile classes into shared
//   memory once, and thread 0 starts the Q load at entry, so no step of the
//   loop waits on a global load of its own.
//   The softmax runs in base 2 with log2(e) folded into the scale, one
//   ex2.approx per entry; every value stays finite (masked entries are
//   about -1.4e30, never -inf), so no difference of two infinities occurs.
//   O leaves from the accumulators, each quad of threads writing 32
//   contiguous bytes of a row (whole sectors) per store.
//   Blocks of the longest q tiles (most live kv tiles under a causal mask)
//   are launched first. Ragged Tq, Tk and D < 64 or < 128 come from TMA's
//   zero fill of out-of-bounds boxes; kv columns past Tk also get NEG_INF.
// - f32: 3xTF32 on the tensor cores (flash_block_f32_kernel). The LM
//   workload's default f32 compute runs it: the worker's steps, f32 train
//   and eval steps, f32 `generate`. At the flagship block in f32 the call
//   moves 68.7 MB (21 us) and its 4.3 GFLOP take 64 us on the FP32 pipe
//   (67 TFLOP/s), so an FMA kernel is bound by operations. Here every
//   operand is split x = big + small, each a TF32 value (as cvt.rna), and a
//   product is small.big + big.small + big.big in f32 accumulators (small.
//   small, below 2^-22 of the product, is dropped): three TF32 products,
//   26 us at 495 TFLOP/s, at an accuracy on a par with f32, which the f32
//   tolerances hold. mma.sync m16n8k8 (tf32 wgmma takes K-major operands
//   only, and V is not); one block per (batch*head, 64-row q tile), four
//   warps of 16 q rows; Q in registers; P stays in registers (the kv
//   order inside each k8 step is permuted so that S's accumulator is
//   P.V's A fragment). What bounds it is the instruction stream around
//   the 384 HMMAs of a warp's 16 x 64 tile step: the splits, the shared-
//   memory fragment loads and the softmax. So the block splits each K and
//   V tile once, in shared memory (big parts in place, small parts in one
//   buffer that K and V take in turn), instead of every warp splitting
//   all of it; K, V and class-2 bias tiles arrive by cp.async (16-byte
//   copies where the view allows, 4-byte ones elsewhere), V of a tile in
//   flight during its S product and the next K during P.V, one buffer
//   each: a ring of stages would need about 108 KB a block, two blocks
//   an SM instead of three. The softmax, the tile classes and the launch
//   order are the bf16 kernel's.
//
// Operands are read in place from [B, T, H, D] (k and v as [B, T, H_kv,
// group, D]: query head h reads kv head h / group, with a stride-0 group
// axis for a GQA expand view), so the fused-QKV split views and GQA views
// go in without a copy. The bf16 kernel's tensor maps cover the compact
// [B, T, H_kv, D] storage and address kv head h / group by coordinate, so
// no stride-0 axis reaches a map; TMA needs unit stride on D, a 16-byte
// aligned base and strides that are multiples of 16 bytes, and the wrapper
// raises on any other view.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>
#include <utility>

namespace {

constexpr int TILE = 64;            // q rows and kv rows of one tile (and of one class)
constexpr float NEG_INF = -1.0e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr float NEG_INF2 = NEG_INF * LOG2E;  // NEG_INF in base-2 logits
constexpr unsigned char CLASS_MASKED = 0, CLASS_ZERO = 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  const unsigned char* classes;     // [ceil(Tq/TILE), n_kt]
  float* out_max;
  float* out_sum;
  float* out_weighted;
  int B, H, Tq, Tk, D, group, n_kt;
  float scale;
  // Element strides. k and v are [B, Tk, H / group, group, D]: query head h
  // reads kv head h / group at slot h % group (slot stride 0 for GQA views).
  long long q_sb, q_st, q_sh, q_sd;
  long long k_sb, k_st, k_sh, k_sg, k_sd;
  long long v_sb, v_st, v_sh, v_sg, v_sd;
  long long bias_sq, bias_sk;
  // f32 kernel: the operand's tiles go by 16-byte copies (unit stride on D,
  // 16-byte aligned base and strides), else by 4-byte copies.
  int vec_q, vec_k, vec_v, vec_bias;
};

// ---------------------------------------------------------------------------
// Tile classes of the bias
// ---------------------------------------------------------------------------

constexpr int CLASS_THREADS = 256;
constexpr int CLASS_LOADS = TILE * TILE / CLASS_THREADS;  // entries per thread
constexpr int CLASS_VECS = CLASS_LOADS / 4;               // 16-byte loads per thread

// Programmatic dependent launch (sm_90). A grid launched with programmatic
// stream serialization may be scheduled once every block of the grid ahead
// of it has issued launch_dependents (or exited); griddepcontrol.wait then
// blocks until that grid has completed and its writes are visible. In a
// grid launched without the attribute the wait returns at once.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void wait_for_prerequisite_grid() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// One block per tile. Every thread starts all its loads before it looks at
// one, so a block waits for memory once; entries past a ragged edge count
// as both masked and zero. VEC: the bias rows are unit-stride with a
// 16-byte aligned base and row stride, so each thread reads four 16-byte
// vectors (a vector that would cross the ragged column edge is read as
// scalars); otherwise 16 scalars at any strides.
template <bool VEC>
__global__ void __launch_bounds__(CLASS_THREADS)
tile_classes_kernel(const float* bias, unsigned char* classes, int Tq, int Tk,
                    long long sq, long long sk) {
  launch_dependents();  // a block kernel under PDL may be scheduled now; it waits for our writes
  const int qt = blockIdx.y, kt = blockIdx.x;
  float x[CLASS_LOADS];
  bool in[CLASS_LOADS];
  if (VEC) {
#pragma unroll
    for (int j = 0; j < CLASS_VECS; ++j) {
      const int i = j * CLASS_THREADS + threadIdx.x;  // 16-byte vector i of the tile
      const int r = qt * TILE + i / (TILE / 4), c = kt * TILE + 4 * (i % (TILE / 4));
      const float* src = bias + r * sq + c;
      if (r < Tq && c + 3 < Tk) {
        const float4 v = __ldg(reinterpret_cast<const float4*>(src));
        x[4 * j] = v.x;
        x[4 * j + 1] = v.y;
        x[4 * j + 2] = v.z;
        x[4 * j + 3] = v.w;
#pragma unroll
        for (int e = 0; e < 4; ++e) in[4 * j + e] = true;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          in[4 * j + e] = r < Tq && c + e < Tk;
          x[4 * j + e] = in[4 * j + e] ? __ldg(src + e) : 0.f;
        }
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < CLASS_LOADS; ++j) {
      const int i = j * CLASS_THREADS + threadIdx.x;
      const int r = qt * TILE + i / TILE, c = kt * TILE + i % TILE;
      in[j] = r < Tq && c < Tk;
      x[j] = in[j] ? __ldg(&bias[r * sq + c * sk]) : 0.f;
    }
  }
  int masked = 1, zero = 1;
#pragma unroll
  for (int j = 0; j < CLASS_LOADS; ++j) {
    masked &= !in[j] || x[j] <= 0.5f * NEG_INF;
    zero &= x[j] == 0.f;
  }
  masked = __syncthreads_and(masked);
  zero = __syncthreads_and(zero);
  if (threadIdx.x == 0) classes[qt * gridDim.x + kt] = masked ? 0 : zero ? 1 : 2;
}

__device__ __forceinline__ int next_live_tile(const unsigned char* cls, int kt, int n_kt) {
  while (kt < n_kt && cls[kt] == CLASS_MASKED) ++kt;
  return kt;
}

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Both block kernels end alike. Thread (g, t) of warp w holds rows r0 and
// r0 + 8 (r0 = q0 + 16w + g): a base-2 max, a partial sum over its columns
// (reduced here across the quad that shares a row) and O's accumulator
// columns 8n + 2t, 8n + 2t + 1. The max goes back to base e; O leaves
// from the accumulators, each quad writing 32 contiguous bytes of a row
// (whole sectors) per store.
template <int ON>
__device__ __forceinline__ void store_outputs(const Params& p, const float (&m)[2], float (&l)[2],
                                              const float (&o)[ON][4], int b, int h, int r0,
                                              int t) {
  const long long bh = (long long)b * p.H + h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = r0 + r * 8;
    if (row >= p.Tq) continue;
    if (t == 0) {
      p.out_max[bh * p.Tq + row] = m[r] * LN2;
      p.out_sum[bh * p.Tq + row] = l[r];
    }
    float* out = p.out_weighted + (((long long)b * p.Tq + row) * p.H + h) * p.D;
#pragma unroll
    for (int n = 0; n < ON; ++n) {
      const int col = n * 8 + 2 * t;
      if (p.D % 2 == 0 && col + 1 < p.D) {
        *reinterpret_cast<float2*>(out + col) = make_float2(o[n][2 * r], o[n][2 * r + 1]);
      } else {
        if (col < p.D) out[col] = o[n][2 * r];
        if (col + 1 < p.D) out[col + 1] = o[n][2 * r + 1];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 products on the tensor cores (mma.sync m16n8k8)
// ---------------------------------------------------------------------------

constexpr int F32_THREADS = 128;       // four warps, 16 q rows each
constexpr int BIAS_STRIDE = TILE + 8;  // floats; 8 mod 32 keeps float2 reads conflict-free

// Row strides in floats. Q and K are read as float2 along D, so their rows
// are 8 mod 32 floats apart; V is read as single floats down two adjacent
// rows, so its rows are 4 mod 32 apart. Both keep a warp's reads free of
// bank conflicts and every row 16-byte aligned for cp.async.
template <int DP>
struct F32Config {
  static constexpr int QK_STRIDE = DP + 8;
  static constexpr int V_STRIDE = DP + 4;
  // Region A holds Q until it is in registers, then each class-2 bias tile.
  static constexpr int A_FLOATS = TILE * (QK_STRIDE > BIAS_STRIDE ? QK_STRIDE : BIAS_STRIDE);
  // A, K and V (their TF32 big parts once split), and the small parts of
  // K (during S) or V (during P.V).
  static constexpr int FLOATS = A_FLOATS + 2 * TILE * QK_STRIDE + TILE * V_STRIDE;
  static constexpr int MIN_BLOCKS = DP <= 64 ? 3 : 1;  // as the shared memory allows
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src, int bytes) {
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Start the copy of a [TILE][COLS] f32 tile into shared memory (row stride
// DS floats): element (r, c) from base[r * srow + c * scol] for r < rows and
// c < cols, zero elsewhere. `vec`: unit stride on columns (or one column),
// 16-byte aligned base and row stride, so 16-byte copies (each thread
// always the same 4 columns, every F32_THREADS * 4 / COLS rows), the tail
// of a row zero-filled by the copy's source size; otherwise one 4-byte copy
// an element. Nothing waits here: the caller commits and waits.
template <int COLS, int DS>
__device__ __forceinline__ void load_tile(float* dst, const float* base, int rows, int cols,
                                          long long srow, long long scol, bool vec) {
  if (vec) {
    constexpr int CH = COLS / 4, RSTEP = F32_THREADS / CH;
    static_assert(F32_THREADS % CH == 0, "a thread keeps its columns");
    const int c = 4 * (threadIdx.x % CH), r0 = threadIdx.x / CH;
    const int bytes = 4 * max(0, min(cols - c, 4));
    const float* src = base + (long long)r0 * srow + c;
    float* d = dst + r0 * DS + c;
#pragma unroll
    for (int i = 0; i < TILE / RSTEP; ++i) {
      // A copy of 0 bytes reads nothing: its source may lie past the tensor.
      cp_async16(d, src, r0 + i * RSTEP < rows ? bytes : 0);
      src += RSTEP * srow;
      d += RSTEP * DS;
    }
  } else {
    for (int i = threadIdx.x; i < TILE * COLS; i += F32_THREADS) {
      const int r = i / COLS, c = i % COLS;
      const bool in = r < rows && c < cols;
      cp_async4(dst + r * DS + c, in ? base + r * srow + c * scol : base, in ? 4 : 0);
    }
  }
}

// x = big + small, each a TF32 value rounded as cvt.rna.tf32.f32 rounds
// (to nearest, ties away from zero: add half of the 13 dropped bits' range
// to the magnitude, then drop them), with |x - big - small| <= 2^-22 |x|.
// Written out, because the compiler's cvt.rna adds a guard against inf of
// three more instructions an element; here a non-finite operand still
// gives a non-finite product, as in f32. small's 13 low bits are
// left in place: the tensor core ignores them, and the compiler's own cvt
// leaves them too.
__device__ __forceinline__ void split_tf32(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

__device__ __forceinline__ void split_frag(const float (&x)[4], uint32_t (&big)[4],
                                           uint32_t (&small)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], big[e], small[e]);
}

// Split the [TILE][DP] f32 tile at x (row stride XS) in place into its
// big parts, and write its small parts at the same places of `small`: the
// block splits each K and V element once, where every warp would split the
// whole tile for its own fragments.
template <int DP, int XS>
__device__ __forceinline__ void split_tile(float* x, float* small) {
  constexpr int CH = DP / 4, RSTEP = F32_THREADS / CH;
  const int c = 4 * (threadIdx.x % CH), r0 = threadIdx.x / CH;
#pragma unroll
  for (int i = 0; i < TILE / RSTEP; ++i) {
    const int r = r0 + i * RSTEP;
    float4* xv = reinterpret_cast<float4*>(x + r * XS + c);
    const float4 v = *xv;
    uint4 big, sm;
    split_tf32(v.x, big.x, sm.x);
    split_tf32(v.y, big.y, sm.y);
    split_tf32(v.z, big.z, sm.z);
    split_tf32(v.w, big.w, sm.w);
    *reinterpret_cast<uint4*>(xv) = big;
    *reinterpret_cast<uint4*>(small + r * XS + c) = sm;
  }
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

// Fragment maps (lane = 4g + t). m16n8k8's A fragment holds (row g, k t),
// (g + 8, t), (g, t + 4), (g + 8, t + 4); B holds (k t, col g), (t + 4, g);
// the accumulator holds (g, 2t), (g, 2t + 1), (g + 8, 2t), (g + 8, 2t + 1).
// The sum over k does not care which physical index each logical k names,
// as long as A and B agree, so each k8 step reads its logical k = t and
// t + 4 as physical 2t and 2t + 1:
// - S = Q.K^T: Q's and K's two values are adjacent along D (one float2);
// - O += P.V: the k8 step over kv rows 8j..8j+7 takes its A fragment
//   straight from S's accumulator of n8 tile j, (c0, c2, c1, c3), and B
//   from V rows 8j + 2t and 8j + 2t + 1. P never leaves the registers.
//
// Grid: (B*H, q tiles), the longest q tiles first. Warp w owns q rows
// 16w..16w+15 of the tile. K and V have one buffer each, loaded in turn:
// V(i) is in flight during S(i) and the softmax, K(i+1) (and its bias
// tile) during P.V(i). Each tile is split in place once it has landed.
template <int DP>
__global__ void __launch_bounds__(F32_THREADS, F32Config<DP>::MIN_BLOCKS)
    flash_block_f32_kernel(const __grid_constant__ Params p) {
  using Cfg = F32Config<DP>;
  constexpr int QS = Cfg::QK_STRIDE, VS = Cfg::V_STRIDE;
  constexpr int KS = DP / 8;    // k8 steps of Q.K^T
  constexpr int SN = TILE / 8;  // n8 tiles of S (kv columns)
  constexpr int ON = DP / 8;    // n8 tiles of O (head-dim columns)
  constexpr int OG = ON < 8 ? ON : 8;  // n8 tiles of O per 3xTF32 call

  extern __shared__ __align__(16) float smem_f[];
  float* a_s = smem_f;                 // Q [TILE][QS], then bias [TILE][BIAS_STRIDE]
  float* k_s = a_s + Cfg::A_FLOATS;    // [TILE][QS]
  float* small_s = k_s + TILE * QS;    // K's small parts [TILE][QS] or V's [TILE][VS]
  float* v_s = small_s + TILE * QS;    // [TILE][VS]
  unsigned char* cls = reinterpret_cast<unsigned char*>(v_s + TILE * VS);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest q tiles first
  const int q0 = qt * TILE;
  const int hk = h / p.group, hg = h % p.group;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;

  // Start the copies of kv tile `tile`: K, and (separately) the bias tile
  // unless its class says it is all zero.
  auto load_k = [&](int tile) {
    load_tile<DP, QS>(k_s, k + (long long)tile * TILE * p.k_st, p.Tk - tile * TILE, p.D, p.k_st,
                      p.k_sd, p.vec_k);
  };
  auto load_bias = [&](int tile) {
    if (cls[tile] != CLASS_ZERO)
      load_tile<TILE, BIAS_STRIDE>(
          a_s, p.bias + (long long)q0 * p.bias_sq + (long long)tile * TILE * p.bias_sk,
          p.Tq - q0, p.Tk - tile * TILE, p.bias_sq, p.bias_sk, p.vec_bias);
  };

  // Q's copy starts at entry, before the wait for the tile-class pass (a
  // no-op unless launched under PDL; see the note at the top); then the
  // block copies its row of tile classes to shared memory and starts the
  // first live K tile's copy.
  load_tile<DP, QS>(a_s, q + (long long)q0 * p.q_st, p.Tq - q0, p.D, p.q_st, p.q_sd, p.vec_q);
  cp_async_commit();
  wait_for_prerequisite_grid();
  for (int j = threadIdx.x; j < p.n_kt; j += F32_THREADS)
    cls[j] = p.classes[(long long)qt * p.n_kt + j];
  __syncthreads();
  int kt = next_live_tile(cls, 0, p.n_kt);
  if (kt < p.n_kt) load_k(kt);
  cp_async_commit();

  // Q into registers (its region then takes the bias tiles): this thread's
  // A-fragment values of each k8 step, (row g, 2t), (g + 8, 2t),
  // (g, 2t + 1), (g + 8, 2t + 1).
  cp_async_wait<1>();
  __syncthreads();
  float qf[KS][4];
  {
    const float* q_row = a_s + (warp * 16 + g) * QS + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float2 lo = *reinterpret_cast<const float2*>(q_row + ks * 8);
      const float2 hi = *reinterpret_cast<const float2*>(q_row + 8 * QS + ks * 8);
      qf[ks][0] = lo.x;
      qf[ks][1] = hi.x;
      qf[ks][2] = lo.y;
      qf[ks][3] = hi.y;
    }
  }
  __syncthreads();  // every warp has its Q: region A is free
  if (kt < p.n_kt) load_bias(kt);
  cp_async_commit();

  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const float scale2 = p.scale * LOG2E;
  // Base-2 running max of each row, and this thread's partial sums over the
  // columns it holds (reduced across the quad at the end).
  float m[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  while (kt < p.n_kt) {
    const int k0 = kt * TILE;
    cp_async_wait<0>();
    __syncthreads();  // K(kt) and its bias have landed; every warp is done with V
    load_tile<DP, VS>(v_s, v + (long long)k0 * p.v_st, p.Tk - k0, p.D, p.v_st, p.v_sd, p.vec_v);
    cp_async_commit();
    split_tile<DP, QS>(k_s, small_s);
    __syncthreads();  // K is split

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a_big[4], a_small[4];
      split_frag(qf[ks], a_big, a_small);
      uint32_t kb[SN][2], kx[SN][2];
#pragma unroll
      for (int j = 0; j < SN; ++j) {
        const int at = (j * 8 + g) * QS + ks * 8 + 2 * t;
        const uint2 big = *reinterpret_cast<const uint2*>(k_s + at);
        const uint2 sm = *reinterpret_cast<const uint2*>(small_s + at);
        kb[j][0] = big.x;
        kb[j][1] = big.y;
        kx[j][0] = sm.x;
        kx[j][1] = sm.y;
      }
      mma_3xtf32<SN>(s, a_big, a_small, kb, kx);
    }

    // Base-2 logits x2 = log2(e) * (q.k * scale + bias); kv columns past Tk
    // get NEG_INF2 whatever the tile's class.
    if (cls[kt] != CLASS_ZERO) {
      const float* brow = a_s + (warp * 16 + g) * BIAS_STRIDE + 2 * t;
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float2 bv = *reinterpret_cast<const float2*>(brow + r * 8 * BIAS_STRIDE + j * 8);
          s[j][2 * r] = fmaf(s[j][2 * r], scale2, bv.x * LOG2E);
          s[j][2 * r + 1] = fmaf(s[j][2 * r + 1], scale2, bv.y * LOG2E);
        }
    } else {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }
    if (k0 + TILE > p.Tk) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= p.Tk) s[j][e] = NEG_INF2;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float m_used[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = fast_exp2(m[r] - mx[r]);  // both finite: never NaN
      m[r] = mx[r];
      // A row with no entry above NEG_INF/2 yet subtracts 0, so its masked
      // entries give exp2(-1.4e30) = 0 and not exp2(0) = 1.
      m_used[r] = mx[r] > 0.5f * NEG_INF2 ? mx[r] : 0.f;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - m_used[e >> 1]);
        l[e >> 1] += s[j][e];
      }

    cp_async_wait<0>();
    __syncthreads();  // V(kt) has landed; every warp is done with K(kt), its small parts
                      // and the bias
    const int next = next_live_tile(cls, kt + 1, p.n_kt);
    if (next < p.n_kt) {
      load_k(next);
      load_bias(next);
      cp_async_commit();
    }
    split_tile<DP, VS>(v_s, small_s);
    __syncthreads();  // V is split

#pragma unroll
    for (int j = 0; j < SN; ++j) {
      const float pf[4] = {s[j][0], s[j][2], s[j][1], s[j][3]};
      uint32_t a_big[4], a_small[4];
      split_frag(pf, a_big, a_small);
      const int row = (j * 8 + 2 * t) * VS + g;
#pragma unroll
      for (int n0 = 0; n0 < ON; n0 += OG) {
        uint32_t vb[OG][2], vx[OG][2];
#pragma unroll
        for (int n = 0; n < OG; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            vb[n][e] = __float_as_uint(v_s[row + e * VS + (n0 + n) * 8]);
            vx[n][e] = __float_as_uint(small_s[row + e * VS + (n0 + n) * 8]);
          }
        mma_3xtf32<OG>(o + n0, a_big, a_small, vb, vx);
      }
    }
    kt = next;
  }

  store_outputs(p, m, l, o, b, h, r0, t);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

// The tile-class pass over a [Tq, Tk] f32 bias, launched normally: it waits
// for all work ahead of it on the stream.
cudaError_t launch_classes(const float* bias, unsigned char* classes, long long Tq, long long Tk,
                           long long sq, long long sk, cudaStream_t stream) {
  if (Tq < 1 || Tk < 1) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)((Tk + TILE - 1) / TILE), (unsigned)((Tq + TILE - 1) / TILE));
  if (grid.y > 65535) return cudaErrorInvalidValue;
  if (aligned16(bias) && (sk == 1 || Tk == 1) && (sq % 4 == 0 || Tq == 1))
    tile_classes_kernel<true><<<grid, CLASS_THREADS, 0, stream>>>(bias, classes, (int)Tq, (int)Tk,
                                                                  sq, 1);
  else
    tile_classes_kernel<false><<<grid, CLASS_THREADS, 0, stream>>>(bias, classes, (int)Tq,
                                                                   (int)Tk, sq, sk);
  return cudaGetLastError();
}

// With `pdl`, the tile-class pass into p.classes (the caller's workspace)
// goes ahead of the block kernel on the stream.
cudaError_t classes_first(const Params& p, cudaStream_t stream, bool pdl) {
  if (!pdl) return cudaSuccess;
  return launch_classes(p.bias, const_cast<unsigned char*>(p.classes), p.Tq, p.Tk, p.bias_sq,
                        p.bias_sk, stream);
}

// Launch `kernel` on `stream`. With `pdl`, under programmatic stream
// serialization: the grid may be scheduled before the grid ahead of it on
// the stream has completed, and waits for it in griddepcontrol.wait.
// Returns the launch's error (the last error is cleared either way).
template <typename... Expected, typename... Actual>
cudaError_t launch(void (*kernel)(Expected...), dim3 grid, int threads, int smem,
                   cudaStream_t stream, bool pdl, Actual&&... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t config = {};
  config.gridDim = grid;
  config.blockDim = dim3(threads);
  config.dynamicSmemBytes = smem;
  config.stream = stream;
  config.attrs = &attr;
  config.numAttrs = pdl ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, std::forward<Actual>(args)...);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <int DP>
cudaError_t launch_f32(const Params& p, cudaStream_t stream, bool pdl) {
  const int bytes = F32Config<DP>::FLOATS * (int)sizeof(float) + p.n_kt;
  cudaError_t err = cudaFuncSetAttribute(flash_block_f32_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  if ((err = classes_first(p, stream, pdl)) != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + TILE - 1) / TILE);
  return launch(flash_block_f32_kernel<DP>, grid, F32_THREADS, bytes, stream, pdl, p);
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (wgmma fed by TMA from one producer warp)
// ---------------------------------------------------------------------------

constexpr int TC_CONSUMERS = 128;              // one warpgroup: 64 q rows, 16 per warp
constexpr int TC_THREADS = TC_CONSUMERS + 32;  // and the producer warp
constexpr int SUB_BYTES = TILE * 64 * 2;       // one [64 rows][64] bf16 swizzled sub-tile

// Per padded head dim: K/V ring depth and the blocks per SM that the
// registers (96 a thread at DP = 64, 168 at DP = 128) and the shared memory
// (43 KB and 83 KB a block) are sized for. At DP = 64 a fourth resident
// block hides more of each block's serial wait chain than a third stage.
template <int DP>
struct TcConfig;
template <>
struct TcConfig<64> {
  static constexpr int STAGES = 2, MIN_BLOCKS = 4;
};
template <>
struct TcConfig<128> {
  static constexpr int STAGES = 2, MIN_BLOCKS = 2;
};

template <int DP>
int tc_smem_bytes(int n_kt) {
  // 1024-byte alignment slack, Q, the [stage][K, V] ring, the barriers,
  // then one q tile's row of tile classes.
  return 1024 + (1 + 2 * TcConfig<DP>::STAGES) * (DP / 64) * SUB_BYTES +
         8 * (3 * TcConfig<DP>::STAGES + 1) + n_kt;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_u32(bar)) : "memory");
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
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from touching a register that a wgmma in flight still
// reads or writes before wgmma_wait_all.
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid: (B*H, q tiles). Warps 0-3 are the consumer warpgroup (warp w owns
// q rows 16w..16w+15 of the tile); warp 4 is the producer, whose lane 0
// starts every TMA load.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS, TcConfig<DP>::MIN_BLOCKS)
    flash_block_tc_kernel(const __grid_constant__ Params p,
                          const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v) {
  using Cfg = TcConfig<DP>;
  constexpr int NSUB = DP / 64;          // 64-column sub-tiles of the head dim
  constexpr int TB = NSUB * SUB_BYTES;   // bytes of one [TILE][DP] tile
  constexpr int KS = DP / 16;            // k16 steps of Q.K^T
  constexpr int SN = TILE / 8;           // n8 tiles of S (kv columns)
  constexpr int ON = DP / 8;             // n8 tiles of O (head-dim columns)

  extern __shared__ unsigned char smem_raw[];
  // 128-byte swizzled boxes want 1024-byte aligned destinations.
  unsigned char* q_s = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = q_s + TB;  // [stage][K, V][TB]
  uint64_t* full_k = reinterpret_cast<uint64_t*>(ring + 2 * Cfg::STAGES * TB);
  uint64_t* full_v = full_k + Cfg::STAGES;
  uint64_t* empty = full_v + Cfg::STAGES;
  uint64_t* q_full = empty + Cfg::STAGES;
  unsigned char* cls = reinterpret_cast<unsigned char*>(q_full + 1);  // this q tile's classes

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bh = blockIdx.x;
  const int b = bh / p.H, h = bh % p.H;
  const int qt = gridDim.y - 1 - blockIdx.y;  // longest q tiles first
  const int q0 = qt * TILE;

  // Thread 0 prefetches the three tensor maps and starts the Q load as soon
  // as its barrier exists. All of that reads no class, so it comes before
  // the wait for the tile-class pass (a no-op unless launched under PDL;
  // see the note at the top). Then the block copies its row of tile
  // classes to shared memory in one pass, so the kv loop never waits on a
  // global load to find its next tile.
  if (threadIdx.x == 0) {
    for (const CUtensorMap* map : {&tm_q, &tm_k, &tm_v})
      asm volatile("prefetch.tensormap [%0];\n" :: "l"(reinterpret_cast<uint64_t>(map))
                   : "memory");
    for (int s = 0; s < Cfg::STAGES; ++s) {
      mbar_init(&full_k[s], 1);
      mbar_init(&full_v[s], 1);
      mbar_init(&empty[s], TC_CONSUMERS / 32);
    }
    mbar_init(q_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(q_full, TB);
    for (int s = 0; s < NSUB; ++s) tma_load_4d(q_s + s * SUB_BYTES, &tm_q, q_full, s * 64, h, q0, b);
  }
  wait_for_prerequisite_grid();
  for (int j = threadIdx.x; j < p.n_kt; j += TC_THREADS)
    cls[j] = p.classes[(long long)qt * p.n_kt + j];
  __syncthreads();

  if (warp == TC_CONSUMERS / 32) {
    // Producer: K and V of each live kv tile into the ring.
    if (lane == 0) {
      const int hk = h / p.group;
      int i = 0;
      for (int kt = next_live_tile(cls, 0, p.n_kt); kt < p.n_kt;
           kt = next_live_tile(cls, kt + 1, p.n_kt), ++i) {
        const int stage = i % Cfg::STAGES;
        if (i >= Cfg::STAGES) mbar_wait(&empty[stage], ((i / Cfg::STAGES) & 1) ^ 1);
        unsigned char* k_s = ring + stage * 2 * TB;
        mbar_expect_tx(&full_k[stage], TB);
        for (int s = 0; s < NSUB; ++s)
          tma_load_4d(k_s + s * SUB_BYTES, &tm_k, &full_k[stage], s * 64, hk, kt * TILE, b);
        mbar_expect_tx(&full_v[stage], TB);
        for (int s = 0; s < NSUB; ++s)
          tma_load_4d(k_s + TB + s * SUB_BYTES, &tm_v, &full_v[stage], s * 64, hk, kt * TILE, b);
      }
    }
    return;
  }

  // Consumers: S = Q.K^T, online softmax, O += P.V for each live tile.
  const int g = lane / 4, t = lane % 4;
  const int r0 = q0 + warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const float scale2 = p.scale * LOG2E;
  // Base-2 running max of each row, and this thread's partial sums over the
  // columns it holds (reduced across the quad at the end).
  float m[2] = {NEG_INF2, NEG_INF2}, l[2] = {0.f, 0.f};
  float o[ON][4];
#pragma unroll
  for (int n = 0; n < ON; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;

  mbar_wait(q_full, 0);  // even with no live kv tile: no TMA write outlives the block
  int i = 0;
  for (int kt = next_live_tile(cls, 0, p.n_kt); kt < p.n_kt;
       kt = next_live_tile(cls, kt + 1, p.n_kt), ++i) {
    const int stage = i % Cfg::STAGES, parity = (i / Cfg::STAGES) & 1;
    const unsigned char* k_s = ring + stage * 2 * TB;
    const unsigned char* v_s = k_s + TB;

    float s[SN][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    mbar_wait(&full_k[stage], parity);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      // k16 step kk: 32 bytes into the 128-byte swizzled rows of its sub-tile.
      const int off = (kk / 4) * SUB_BYTES + (kk % 4) * 32;
      wgmma_ss_n64(s, sw128_desc(q_s + off, 16, 1024), sw128_desc(k_s + off, 16, 1024),
                   kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(s);

    // Base-2 logits x2 = log2(e) * (q.k * scale + bias); kv columns past Tk
    // get NEG_INF2 whatever the tile's class. Clamped reads stay in bounds.
    const int k0 = kt * TILE;
    if (cls[kt] != CLASS_ZERO) {
      const float* brow[2] = {p.bias + (long long)min(r0, p.Tq - 1) * p.bias_sq,
                              p.bias + (long long)min(r0 + 8, p.Tq - 1) * p.bias_sq};
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = min(k0 + j * 8 + 2 * t + (e & 1), p.Tk - 1);
          s[j][e] = fmaf(s[j][e], scale2, brow[e >> 1][col * p.bias_sk] * LOG2E);
        }
    } else {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] *= scale2;
    }
    if (k0 + TILE > p.Tk) {
#pragma unroll
      for (int j = 0; j < SN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + j * 8 + 2 * t + (e & 1) >= p.Tk) s[j][e] = NEG_INF2;
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < SN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    float m_used[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float corr = fast_exp2(m[r] - mx[r]);  // both finite: never NaN
      m[r] = mx[r];
      // A row with no entry above NEG_INF/2 yet subtracts 0, so its masked
      // entries give exp2(-1.4e30) = 0 and not exp2(0) = 1.
      m_used[r] = mx[r] > 0.5f * NEG_INF2 ? mx[r] : 0.f;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < ON; ++n) {
        o[n][2 * r] *= corr;
        o[n][2 * r + 1] *= corr;
      }
    }
    // P as bf16 A fragments: the C fragments of S's n8 tiles 2j and 2j+1
    // are the A fragment of k16 step j of P.V.
    uint32_t pa[TILE / 16][4];
#pragma unroll
    for (int j = 0; j < SN; ++j) {
      float pe[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pe[e] = fast_exp2(s[j][e] - m_used[e >> 1]);
        l[e >> 1] += pe[e];
      }
      pa[j / 2][(j % 2) * 2] = pack_bf16(pe[0], pe[1]);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pe[2], pe[3]);
    }

    mbar_wait(&full_v[stage], parity);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < TILE / 16; ++j)  // 16 kv rows = two 8-row groups of 1024 bytes
      wgmma_rs(o, pa[j], sw128_desc(v_s + j * 2048, SUB_BYTES, 1024));
    wgmma_commit();
    wgmma_wait_all();
    reg_fence(o);
    reg_fence(pa);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
  }

  store_outputs(p, m, l, o, b, h, r0, t);
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
cudaError_t launch_tc(const Params& p, cudaStream_t stream, bool pdl) {
  const int bytes = tc_smem_bytes<DP>(p.n_kt);
  cudaError_t err = cudaFuncSetAttribute(flash_block_tc_kernel<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  CUtensorMap tm_q, tm_k, tm_v;
  const int hkv = p.H / p.group;
  if (!make_map(&tm_q, p.q, p.B, p.Tq, p.H, p.D, p.q_sb, p.q_st, p.q_sh) ||
      !make_map(&tm_k, p.k, p.B, p.Tk, hkv, p.D, p.k_sb, p.k_st, p.k_sh) ||
      !make_map(&tm_v, p.v, p.B, p.Tk, hkv, p.D, p.v_sb, p.v_st, p.v_sh))
    return cudaErrorInvalidValue;
  if ((err = classes_first(p, stream, pdl)) != cudaSuccess) return err;
  const dim3 grid(p.B * p.H, (p.Tq + TILE - 1) / TILE);
  return launch(flash_block_tc_kernel<DP>, grid, TC_THREADS, bytes, stream, pdl, p, tm_q, tm_k,
                tm_v);
}

// An f32 operand whose tiles can go by 16-byte copies: unit stride along
// the row, a 16-byte aligned base, and every row stride a multiple of 4
// elements.
int rows16(const void* ptr, bool unit_stride, std::initializer_list<long long> strides) {
  bool ok = unit_stride && aligned16(ptr);
  for (long long st : strides) ok = ok && st % 4 == 0;
  return ok;
}

}  // namespace

// Classes of the [Tq, Tk] f32 bias, one byte per 64x64 tile, row-major
// [ceil(Tq/64), ceil(Tk/64)]: 0 all <= NEG_INF/2, 1 all 0.0, 2 otherwise.
extern "C" int flash_block_tile_classes(const void* bias, void* classes, long long Tq,
                                        long long Tk, long long bias_sq, long long bias_sk,
                                        void* stream) {
  return (int)launch_classes(static_cast<const float*>(bias), static_cast<unsigned char*>(classes),
                             Tq, Tk, bias_sq, bias_sk, (cudaStream_t)stream);
}

// dtype: 0 = float32 (3xTF32 kernel), 1 = bfloat16 (wgmma kernel); q, k
// and v share it; bias is f32. classes: the bias's tile classes
// (flash_block_tile_classes's layout), or with `compute_classes` a
// workspace of that size: then the tile-class pass is launched into it
// first and the block kernel after it under programmatic dependent launch.
// dims: B, H, Tq, Tk, D, group.
// strides (elements): q b,t,h,d; k b,t,h,g,d; v b,t,h,g,d; bias q,k.
// Returns a cudaError_t: the first launch error, or cudaErrorInvalidValue
// for arguments the kernels do not take (then nothing is launched; a
// failed launch of the pass launches no block kernel).
extern "C" int flash_block_forward(int dtype, const void* q, const void* k, const void* v,
                                   const void* bias, void* classes, void* out_max,
                                   void* out_sum, void* out_weighted, const long long* dims,
                                   const long long* strides, int compute_classes,
                                   void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
  p.classes = static_cast<const unsigned char*>(classes);
  p.out_max = static_cast<float*>(out_max);
  p.out_sum = static_cast<float*>(out_sum);
  p.out_weighted = static_cast<float*>(out_weighted);
  p.B = (int)dims[0];
  p.H = (int)dims[1];
  p.Tq = (int)dims[2];
  p.Tk = (int)dims[3];
  p.D = (int)dims[4];
  p.group = (int)dims[5];
  if (p.D < 1 || p.D > 128 || p.group < 1 || p.H % p.group || p.Tq < 1 || p.Tk < 1 ||
      p.B * p.H > 65535)
    return (int)cudaErrorInvalidValue;
  p.n_kt = (p.Tk + TILE - 1) / TILE;
  p.scale = (float)(1.0 / sqrt((double)p.D));
  long long* dst[] = {&p.q_sb, &p.q_st, &p.q_sh, &p.q_sd, &p.k_sb, &p.k_st,
                      &p.k_sh, &p.k_sg, &p.k_sd, &p.v_sb, &p.v_st, &p.v_sh,
                      &p.v_sg, &p.v_sd, &p.bias_sq, &p.bias_sk};
  for (int i = 0; i < 16; ++i) *dst[i] = strides[i];
  cudaStream_t s = (cudaStream_t)stream;
  const bool pdl = compute_classes != 0;
  if (dtype == 0) {
    const bool unit_d = p.D == 1;  // one column: its stride is never used
    p.vec_q = rows16(q, unit_d || p.q_sd == 1, {p.q_sb, p.q_st, p.q_sh});
    p.vec_k = rows16(k, unit_d || p.k_sd == 1, {p.k_sb, p.k_st, p.k_sh, p.k_sg});
    p.vec_v = rows16(v, unit_d || p.v_sd == 1, {p.v_sb, p.v_st, p.v_sh, p.v_sg});
    p.vec_bias = rows16(bias, p.Tk == 1 || p.bias_sk == 1, {p.bias_sq});
    if (p.D <= 32) return (int)launch_f32<32>(p, s, pdl);
    if (p.D <= 64) return (int)launch_f32<64>(p, s, pdl);
    return (int)launch_f32<128>(p, s, pdl);
  }
  if (dtype == 1) {
    // TMA: unit stride on D, 16-byte aligned bases and strides.
    bool ok = p.q_sd == 1 && p.k_sd == 1 && p.v_sd == 1 && aligned16(q) && aligned16(k) &&
              aligned16(v);
    const long long rows[] = {p.q_sb, p.q_st, p.q_sh, p.k_sb, p.k_st, p.k_sh,
                              p.k_sg, p.v_sb, p.v_st, p.v_sh, p.v_sg};
    for (long long st : rows) ok = ok && st % 8 == 0;
    if (!ok) return (int)cudaErrorInvalidValue;
    if (p.D <= 64) return (int)launch_tc<64>(p, s, pdl);
    return (int)launch_tc<128>(p, s, pdl);
  }
  return (int)cudaErrorInvalidValue;
}
