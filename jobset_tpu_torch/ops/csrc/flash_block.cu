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
// Design. One thread block per (batch*head, 64-row q tile). The kv axis,
// which the TPU ran as a sequential grid dimension with VMEM scratch, is a
// loop inside the block: m, l and the f32 accumulator [64, D] live in
// registers for the whole loop. K and V stream through shared memory in
// 64-row tiles (f32 after conversion: 70 KB at D = 64, 119 KB at D = 128,
// inside the 227 KB a block may use). Operands are read in place from
// [B, T, H, D] through element strides, so there is no transpose or pad
// pass, and a GQA broadcast (a stride-0 group axis on k and v) is read
// without a copy. Ragged edges are masked here: kv columns past Tk get
// NEG_INF, q rows past Tq are not written. The products are FMA loops on
// f32 copies of the operands, so a bf16 product is exact and an f32 one
// stays f32 (no TF32). For bf16, p is rounded to bf16 before the PV
// product, as the TPU kernel does with p.astype(v.dtype).
//
// Bound at the flagship prefill shape (B=8, H=16, Tq=Tk=512, D=64, bf16),
// worked out from the shapes, not measured: it must read q, k, v
// (25.2 MB) and the bias (1.0 MB) and write weighted f32 (16.8 MB) and the
// stats (0.5 MB): 43.5 MB, 13 us at 3.35 TB/s. It does 8.6 GFLOP, 8.7 us
// at the 989 TFLOP/s bf16 tensor-core rate. So the bound is memory, about
// 13 us a launch. This kernel runs its products on the FP32 pipes
// (67 TFLOP/s), so it cannot come near that bound; tensor cores (mma.sync,
// then wgmma with TMA) are the later step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;              // q rows per block
constexpr int BK = 64;              // kv rows per shared-memory tile
constexpr int THREADS = 128;        // 16 row groups x 8 lanes
constexpr int LANES = 8;            // threads that share one row group
constexpr int ROWS = 4;             // q rows per thread
constexpr int SCOLS = BK / LANES;   // logits columns per thread, strided by LANES
constexpr float NEG_INF = -1.0e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const float* bias;
  float* out_max;
  float* out_sum;
  float* out_weighted;
  int B, H, Tq, Tk, D, group;
  float scale;
  // Element strides. k and v are [B, Tk, H / group, group, D]: query head h
  // reads kv head h / group at slot h % group (slot stride 0 for GQA views).
  long long q_sb, q_st, q_sh, q_sd;
  long long k_sb, k_st, k_sh, k_sg, k_sd;
  long long v_sb, v_st, v_sh, v_sg, v_sd;
  long long bias_sq, bias_sk;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

// p as the PV product sees it: rounded to the operand dtype of v.
template <typename T>
__device__ __forceinline__ float round_like(float x) { return x; }
template <>
__device__ __forceinline__ float round_like<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16(x));
}

__device__ __forceinline__ float lane_group_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}

__device__ __forceinline__ float lane_group_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// DP: D rounded up to 32, 64 or 128; the extra columns load as zeros.
template <int DP>
constexpr int smem_floats() {
  return 3 * BQ * (DP + 4) + BQ * (BK + 4);
}

template <typename T, int DP>
__global__ void __launch_bounds__(THREADS) flash_block_kernel(Params p) {
  constexpr int RS = DP + 4;         // q/k/v row stride in floats (16-byte rows, spread banks)
  constexpr int PS = BK + 4;         // p row stride
  constexpr int OC = DP / LANES;     // output columns per thread, contiguous
  static_assert(BQ == BK, "q and kv tiles share the row stride");
  static_assert(OC % 4 == 0, "output columns are read as float4");

  extern __shared__ __align__(16) float smem[];
  float* q_s = smem;                 // [BQ][RS]
  float* k_s = q_s + BQ * RS;        // [BK][RS]
  float* v_s = k_s + BK * RS;        // [BK][RS]
  float* p_s = v_s + BK * RS;        // [BQ][PS]

  const int tid = threadIdx.x;
  const int rg = tid / LANES;
  const int lane = tid % LANES;
  const int bh = blockIdx.y;
  const int b = bh / p.H;
  const int h = bh % p.H;
  const int q0 = blockIdx.x * BQ;
  const int hk = h / p.group;
  const int hg = h % p.group;

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh + hg * p.k_sg;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh + hg * p.v_sg;

  for (int i = tid; i < BQ * DP; i += THREADS) {
    const int r = i / DP, d = i % DP;
    float x = 0.f;
    if (q0 + r < p.Tq && d < p.D) x = to_f32(q[(q0 + r) * p.q_st + d * p.q_sd]);
    q_s[r * RS + d] = x;
  }

  float m[ROWS], l[ROWS], acc[ROWS][OC];
#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < OC; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = 0; k0 < p.Tk; k0 += BK) {
    __syncthreads();  // the last tile's readers are done
    for (int i = tid; i < BK * DP; i += THREADS) {
      const int r = i / DP, d = i % DP;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < p.Tk && d < p.D) {
        kx = to_f32(k[(k0 + r) * p.k_st + d * p.k_sd]);
        vx = to_f32(v[(k0 + r) * p.v_st + d * p.v_sd]);
      }
      k_s[r * RS + d] = kx;
      v_s[r * RS + d] = vx;
    }
    __syncthreads();

    // s[i][j]: q row rg*ROWS+i against kv row lane + LANES*j of this tile.
    float s[ROWS][SCOLS];
#pragma unroll
    for (int i = 0; i < ROWS; ++i)
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < DP; d += 4) {
      float4 a[ROWS], kb[SCOLS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        a[i] = *reinterpret_cast<const float4*>(&q_s[(rg * ROWS + i) * RS + d]);
#pragma unroll
      for (int j = 0; j < SCOLS; ++j)
        kb[j] = *reinterpret_cast<const float4*>(&k_s[(lane + LANES * j) * RS + d]);
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
#pragma unroll
        for (int j = 0; j < SCOLS; ++j) {
          float t = s[i][j];
          t = fmaf(a[i].x, kb[j].x, t);
          t = fmaf(a[i].y, kb[j].y, t);
          t = fmaf(a[i].z, kb[j].z, t);
          s[i][j] = fmaf(a[i].w, kb[j].w, t);
        }
    }

    // Online softmax over this tile, one row group per 8 lanes.
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      const int row = q0 + rg * ROWS + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const int col = k0 + lane + LANES * j;
        float x = NEG_INF;
        if (col < p.Tk) {
          const float bias = row < p.Tq ? p.bias[row * p.bias_sq + col * p.bias_sk] : 0.f;
          x = s[i][j] * p.scale + bias;
        }
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
      const float m_new = lane_group_max(mx);
      const float corr = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < SCOLS; ++j) {
        const float e = s[i][j] > 0.5f * NEG_INF ? expf(s[i][j] - m_new) : 0.f;
        rs += e;
        p_s[(rg * ROWS + i) * PS + lane + LANES * j] = round_like<T>(e);
      }
      l[i] = l[i] * corr + lane_group_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < OC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[i][c] += p[row i] . v[:, lane*OC + c]
#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 a[ROWS];
#pragma unroll
      for (int i = 0; i < ROWS; ++i)
        a[i] = *reinterpret_cast<const float4*>(&p_s[(rg * ROWS + i) * PS + kk]);
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float* vrow = &v_s[(kk + t) * RS + lane * OC];
#pragma unroll
        for (int c4 = 0; c4 < OC; c4 += 4) {
          const float4 vb = *reinterpret_cast<const float4*>(&vrow[c4]);
#pragma unroll
          for (int i = 0; i < ROWS; ++i) {
            const float pa = t == 0 ? a[i].x : t == 1 ? a[i].y : t == 2 ? a[i].z : a[i].w;
            acc[i][c4 + 0] = fmaf(pa, vb.x, acc[i][c4 + 0]);
            acc[i][c4 + 1] = fmaf(pa, vb.y, acc[i][c4 + 1]);
            acc[i][c4 + 2] = fmaf(pa, vb.z, acc[i][c4 + 2]);
            acc[i][c4 + 3] = fmaf(pa, vb.w, acc[i][c4 + 3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < ROWS; ++i) {
    const int row = q0 + rg * ROWS + i;
    if (row >= p.Tq) continue;
    if (lane == 0) {
      p.out_max[(long long)bh * p.Tq + row] = m[i];
      p.out_sum[(long long)bh * p.Tq + row] = l[i];
    }
    float* out = p.out_weighted + (((long long)b * p.Tq + row) * p.H + h) * p.D;
#pragma unroll
    for (int c = 0; c < OC; ++c) {
      const int d = lane * OC + c;
      if (d < p.D) out[d] = acc[i][c];
    }
  }
}

template <typename T, int DP>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DP>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_block_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Tq + BQ - 1) / BQ, p.B * p.H);
  flash_block_kernel<T, DP><<<grid, THREADS, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dtype(const Params& p, cudaStream_t stream) {
  if (p.D <= 32) return launch<T, 32>(p, stream);
  if (p.D <= 64) return launch<T, 64>(p, stream);
  return launch<T, 128>(p, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it; bias is f32).
// dims: B, H, Tq, Tk, D, group.
// strides (elements): q b,t,h,d; k b,t,h,g,d; v b,t,h,g,d; bias q,k.
// Returns a cudaError_t: the launch's own error, or cudaErrorInvalidValue
// for arguments the kernel does not take.
extern "C" int flash_block_forward(int dtype, const void* q, const void* k, const void* v,
                                   const void* bias, void* out_max, void* out_sum,
                                   void* out_weighted, const long long* dims,
                                   const long long* strides, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.bias = static_cast<const float*>(bias);
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
  p.scale = (float)(1.0 / sqrt((double)p.D));
  long long* dst[] = {&p.q_sb, &p.q_st, &p.q_sh, &p.q_sd, &p.k_sb, &p.k_st,
                      &p.k_sh, &p.k_sg, &p.k_sd, &p.v_sb, &p.v_st, &p.v_sh,
                      &p.v_sg, &p.v_sd, &p.bias_sq, &p.bias_sk};
  for (int i = 0; i < 16; ++i) *dst[i] = strides[i];
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch_dtype<float>(p, s);
  if (dtype == 1) return (int)launch_dtype<__nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
