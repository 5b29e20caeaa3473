// The auction placement solver for Hopper (sm_90a): one thread block per
// problem, the whole solve in one launch.
//
// What it replaces. jobset_tpu/placement/solver.py::_auction, with
// _auction_structured, _auction_batch and _auction_structured_batch around
// it (solver.py:77-383). On the TPU these are XLA programs, not Pallas
// kernels: the rank-matched warm start, the eps-scaling phases, the repair
// fixpoints and the Jacobi bidding rounds all run inside lax.while_loop on
// the device, so a solve is one dispatch that the host does not wait on.
// This kernel keeps that: the loop conditions are decided on the card
// (__syncthreads_or), never by a device-to-host copy.
//
// What bounds it. A chain of dependent rounds: every bidding round reads
// the prices the previous one wrote, and every phase starts from the
// previous phase's prices. Within a round the work is the bidders' benefit
// rows (D_p floats each, from L2: a 512x1024 problem is 2 MB) plus O(D_p)
// conflict resolution; a repair pass reads every assigned row. So a solve
// is latency-bound (barriers and L2 round trips per round), far from the
// card's memory rate.
//
// What the design does about it. All per-round state lives in shared
// memory: prices, owners and the per-object best bid (one 64-bit key,
// (bid, -job) ordered, so the highest bid wins and ties go to the lowest
// job index under atomicMax, independent of the order warps run in), the
// assignment, the bidder list and per-job flags: 16 B per object and 12 B
// per job, 22 KB at 512x1024 and 134 KB at 512x8192 (dynamic shared memory
// opt-in). Only unassigned rows are scanned, one warp per row with float4
// loads four deep and shuffle reductions for (best, first argmax,
// second-best); the reference's full [J, D] pass gives the same result,
// since assigned rows' bids are masked there. A round is three barriers.
// Batches are free: grid = B, one block each. A single solve therefore
// uses one SM of 132; a cooperative or cluster-wide solve is later work.
//
// Results equal the reference's bit for bit: the same operations in the
// same order (prices[best] + (best - second) + eps; the structured cost
// 1 + load + 0.1 * ((d - j) mod nd) / nd with jnp's floor-mod), all with
// round-to-nearest intrinsics and built with -fmad=false, so no multiply-
// add is contracted. The repair fixpoint is bounded by J_p + 1 passes; the
// kernel traps past that, so a fault cannot hold the card.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1.0e9f;   // forbidden cell (IEEE-finite)
constexpr float kHalfNegInf = -5.0e8f;
constexpr float kCostCap = 1024.0f;
constexpr float kSinkBenefit = -4096.0f;
constexpr float kTheta = 8.0f;

struct Params {
  const float* benefit;        // dense: [B, J, D] scaled benefit
  float* scratch;              // structured: [B, J, D] written by the kernel
  const float* load;           // structured: [B, D]
  const float* free_cap;       // [B, D] (padded: -1)
  const float* pods;           // [B, J] (padded: +inf)
  const int* sticky;           // [B, J]
  const unsigned char* occupied;  // [B, D] bool
  const int* own;              // [B, J]
  const int* num_domains;      // [B]
  int* assignment;             // [B, J] out; D = took the sink
  float* prices;               // [B, D] out
  int* iterations;             // [B] out: bidding rounds
  long long* stats;            // [B, 4] out: bid rows, repair rows, phases, repair passes
  int jobs, domains, log2_domains, max_iters;
  float eps;
};

// Float bits as an unsigned key with the float's order.
__device__ __forceinline__ unsigned ordered(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

// Best value, the first column holding it, and the largest value at any
// other column (the reference's max after masking the argmax).
struct Top2 {
  float best;
  int idx;
  float second;
};

__device__ __forceinline__ void top2_add(Top2& t, float v, int d) {
  if (v > t.best) {
    t.second = t.best;
    t.best = v;
    t.idx = d;
  } else {
    t.second = fmaxf(t.second, v);
  }
}

__device__ __forceinline__ void top2_add4(Top2& t, float4 b, float4 p, int d) {
  top2_add(t, __fsub_rn(b.x, p.x), d);
  top2_add(t, __fsub_rn(b.y, p.y), d + 1);
  top2_add(t, __fsub_rn(b.z, p.z), d + 2);
  top2_add(t, __fsub_rn(b.w, p.w), d + 3);
}

__device__ __forceinline__ Top2 top2_warp(Top2 t) {
  for (int off = 16; off; off >>= 1) {
    const float ob = __shfl_xor_sync(0xffffffffu, t.best, off);
    const int oi = __shfl_xor_sync(0xffffffffu, t.idx, off);
    const float os = __shfl_xor_sync(0xffffffffu, t.second, off);
    if (ob > t.best || (ob == t.best && oi < t.idx)) {
      t.second = fmaxf(os, t.best);
      t.best = ob;
      t.idx = oi;
    } else {
      t.second = fmaxf(t.second, ob);
    }
  }
  return t;
}

// (best, first argmax, second) of benefit[j, :] - prices over one row,
// every lane of the warp ending with the row's result.
__device__ __forceinline__ Top2 row_top2(const float* row, const float* prices, int domains,
                                         int lane) {
  Top2 t{-CUDART_INF_F, 0x7fffffff, -CUDART_INF_F};
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* p4 = reinterpret_cast<const float4*>(prices);
  const int n4 = domains >> 2;
  int c = lane;
  for (; c + 96 < n4; c += 128) {
    const float4 b0 = r4[c], b1 = r4[c + 32], b2 = r4[c + 64], b3 = r4[c + 96];
    top2_add4(t, b0, p4[c], 4 * c);
    top2_add4(t, b1, p4[c + 32], 4 * (c + 32));
    top2_add4(t, b2, p4[c + 64], 4 * (c + 64));
    top2_add4(t, b3, p4[c + 96], 4 * (c + 96));
  }
  for (; c < n4; c += 32) top2_add4(t, r4[c], p4[c], 4 * c);
  return top2_warp(t);
}

__device__ __forceinline__ float max4(float m, float4 b, float4 p) {
  m = fmaxf(m, __fsub_rn(b.x, p.x));
  m = fmaxf(m, __fsub_rn(b.y, p.y));
  m = fmaxf(m, __fsub_rn(b.z, p.z));
  return fmaxf(m, __fsub_rn(b.w, p.w));
}

// max over d of benefit[j, d] - prices[d], on every lane.
__device__ __forceinline__ float row_max(const float* row, const float* prices, int domains,
                                         int lane) {
  float m = -CUDART_INF_F;
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* p4 = reinterpret_cast<const float4*>(prices);
  const int n4 = domains >> 2;
  int c = lane;
  for (; c + 96 < n4; c += 128) {
    const float4 b0 = r4[c], b1 = r4[c + 32], b2 = r4[c + 64], b3 = r4[c + 96];
    m = max4(m, b0, p4[c]);
    m = max4(m, b1, p4[c + 32]);
    m = max4(m, b2, p4[c + 64]);
    m = max4(m, b3, p4[c + 96]);
  }
  for (; c < n4; c += 32) m = max4(m, r4[c], p4[c]);
  for (int off = 16; off; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  return m;
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The structured cost model's scaled benefit for problem b, written to out.
__device__ void build_structured(const Params& p, int b, float* out) {
  const int jobs = p.jobs, domains = p.domains;
  const int nd_i = p.num_domains[b];
  const float nd = static_cast<float>(nd_i);
  const float* load = p.load + static_cast<size_t>(b) * domains;
  const float* free_cap = p.free_cap + static_cast<size_t>(b) * domains;
  const unsigned char* occupied = p.occupied + static_cast<size_t>(b) * domains;
  const float* pods = p.pods + static_cast<size_t>(b) * jobs;
  const int* sticky = p.sticky + static_cast<size_t>(b) * jobs;
  const int* own = p.own + static_cast<size_t>(b) * jobs;
  const float scale = static_cast<float>(jobs + 1);
  const size_t cells = static_cast<size_t>(jobs) * domains;
  for (size_t i = threadIdx.x; i < cells; i += kThreads) {
    const int j = static_cast<int>(i >> p.log2_domains);
    const int d = static_cast<int>(i & (domains - 1));
    float rot = fmodf(__fsub_rn(static_cast<float>(d), static_cast<float>(j)), nd);
    if (rot != 0.0f && ((rot < 0.0f) != (nd < 0.0f))) rot = __fadd_rn(rot, nd);
    float cost = __fadd_rn(__fadd_rn(1.0f, load[d]), __fdiv_rn(__fmul_rn(0.1f, rot), nd));
    if (d == sticky[j]) cost = 0.0f;
    const bool feasible = free_cap[d] >= pods[j] && (!occupied[d] || d == own[j]) && d < nd_i;
    const float benefit =
        feasible ? __fsub_rn(kCostCap, fminf(fmaxf(cost, 0.0f), kCostCap - 1.0f)) : kNegInf;
    out[i] = __fmul_rn(benefit, scale);
  }
}

// Descending bitonic sort of n (a power of two) unique keys in shared memory.
__device__ void sort_descending(unsigned long long* key, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int l = i ^ j;
        if (l > i) {
          const unsigned long long a = key[i], c = key[l];
          if (((i & k) == 0) ? (a < c) : (a > c)) {
            key[i] = c;
            key[l] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int order_at(const unsigned long long* key, int rank) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(key[rank] & 0xffffffffull));
}

__global__ void __launch_bounds__(kThreads, 1) auction_kernel(Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int jobs = p.jobs, domains = p.domains;
  unsigned long long* key = reinterpret_cast<unsigned long long*>(smem);  // [D]
  float* price = reinterpret_cast<float*>(key + domains);                 // [D]
  int* owner = reinterpret_cast<int*>(price + domains);                   // [D]
  int* assign = owner + domains;                                          // [J]
  int* list = assign + jobs;                                              // [J]
  int* flag = list + jobs;                                                // [J]
  __shared__ unsigned s_bmax, s_bmin, s_min_live;
  __shared__ int s_num_finite, s_num_live, s_count;
  __shared__ unsigned long long s_repair_rows;

  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cells = static_cast<size_t>(jobs) * domains;
  const float* benefit;
  if (p.load != nullptr) {
    float* out = p.scratch + b * cells;
    build_structured(p, b, out);
    benefit = out;
  } else {
    benefit = p.benefit + b * cells;
  }
  const float sink = static_cast<float>(static_cast<double>(kSinkBenefit) * (jobs + 1));
  if (tid == 0) {
    s_bmax = ordered(-CUDART_INF_F);
    s_bmin = ordered(CUDART_INF_F);
    s_min_live = ordered(CUDART_INF_F);
    s_num_finite = 0;
    s_num_live = 0;
    s_repair_rows = 0;
  }
  __syncthreads();  // also makes the structured benefit visible to the block

  // ---- Warm start. Column scores into price[] for now.
  for (int d = tid; d < domains; d += kThreads) {
    float m = -CUDART_INF_F;
    for (int j = 0; j < jobs; ++j) m = fmaxf(m, benefit[static_cast<size_t>(j) * domains + d]);
    price[d] = m;
  }
  // Per row: any feasible cell; the finite spread over the whole matrix.
  for (int j = warp; j < jobs; j += kWarps) {
    const float* row = benefit + static_cast<size_t>(j) * domains;
    float mx = -CUDART_INF_F, fmn = CUDART_INF_F, fmx = -CUDART_INF_F;
    for (int d = lane; d < domains; d += 32) {
      const float v = row[d];
      mx = fmaxf(mx, v);
      if (v > kHalfNegInf) {
        fmn = fminf(fmn, v);
        fmx = fmaxf(fmx, v);
      }
    }
    mx = warp_max(mx);
    fmn = warp_min(fmn);
    fmx = warp_max(fmx);
    if (lane == 0) {
      const bool finite = mx > kHalfNegInf;
      flag[j] = finite;
      if (finite) {
        atomicAdd(&s_num_finite, 1);
        atomicMax(&s_bmax, ordered(fmx));
        atomicMin(&s_bmin, ordered(fmn));
      }
    }
  }
  __syncthreads();
  for (int d = tid; d < domains; d += kThreads) {
    const float s = price[d];
    if (s > kHalfNegInf) {
      atomicAdd(&s_num_live, 1);
      atomicMin(&s_min_live, ordered(s));
    }
    // Descending score, then ascending index: a stable argsort(-score).
    key[d] = (static_cast<unsigned long long>(ordered(s)) << 32) | (0xffffffffu - d);
  }
  __syncthreads();
  sort_descending(key, domains);
  // seed_rank = cumsum(row_finite) - 1, by warp 0 in chunks of 32.
  if (warp == 0) {
    int run = 0;
    for (int base = 0; base < jobs; base += 32) {
      const int j = base + lane;
      const int f = j < jobs ? flag[j] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      if (j < jobs) list[j] = run + __popc(m & ((1u << lane) - 1u)) + f - 1;
      run += __popc(m);
    }
  }
  __syncthreads();
  const int num_finite = s_num_finite, num_live = s_num_live;
  const float min_live = from_ordered(s_min_live);
  const float s_thresh = num_finite < num_live
                             ? price[order_at(key, min(num_finite, domains - 1))]
                             : (isfinite(min_live) ? min_live : 0.0f);
  const int seed_cap = min(jobs, domains);
  for (int j = tid; j < jobs; j += kThreads) {
    const int rank = list[j];
    const int obj = order_at(key, min(max(rank, 0), domains - 1));
    float gain = __fsub_rn(price[obj], s_thresh);
    gain = fmaxf(isfinite(gain) ? gain : 0.0f, 0.0f);
    assign[j] = (flag[j] && rank < seed_cap) ? obj : -1;
    list[j] = __float_as_int(gain);
  }
  __syncthreads();
  for (int d = tid; d < domains; d += kThreads) {
    price[d] = 0.0f;
    owner[d] = -1;
    key[d] = 0ull;
  }
  __syncthreads();
  for (int j = tid; j < jobs; j += kThreads) {
    const int a = assign[j];
    if (a >= 0) {
      price[a] = __int_as_float(list[j]);
      owner[a] = j;
    }
  }
  const float eps_final = p.eps;
  const float spread =
      num_finite > 0 ? __fsub_rn(from_ordered(s_bmax), from_ordered(s_bmin)) : 0.0f;
  float eps_k = fmaxf(eps_final, __fdiv_rn(spread, kTheta));
  __syncthreads();

  // ---- eps-scaling phases.
  int it = 0, phases = 0, repair_passes = 0;
  long long bid_rows = 0;
  unsigned long long my_repair_rows = 0;
  bool done = false;
  while (!done && it < p.max_iters) {
    ++phases;
    // Repair to a fixpoint: drop pairs violating eps_k-CS, orphan their
    // objects, zero every unowned object's price.
    for (int pass = 0;; ++pass) {
      if (pass > jobs + 1) __trap();
      ++repair_passes;
      int mine = 0;
      for (int j = warp; j < jobs; j += kWarps) {
        const int a = assign[j];
        if (a < 0) {
          if (lane == 0) flag[j] = 0;
          continue;
        }
        const float* row = benefit + static_cast<size_t>(j) * domains;
        const float vmax = fmaxf(row_max(row, price, domains, lane), sink);
        const float va = a >= domains ? sink : __fsub_rn(row[a], price[a]);
        const int violates = va < __fsub_rn(vmax, eps_k);
        if (lane == 0) {
          flag[j] = violates;
          mine |= violates;
          ++my_repair_rows;
        }
      }
      const int changed = __syncthreads_or(mine);
      for (int j = tid; j < jobs; j += kThreads)
        if (flag[j]) assign[j] = -1;
      for (int d = tid; d < domains; d += kThreads) {
        int o = owner[d];
        if (o >= 0 && flag[o]) {
          o = -1;
          owner[d] = -1;
        }
        if (o < 0) price[d] = 0.0f;
      }
      __syncthreads();
      if (!changed) break;
    }
    // Jacobi bidding rounds until every job holds an object or its sink.
    for (;;) {
      if (tid == 0) s_count = 0;
      __syncthreads();
      int mine = 0;
      for (int j = tid; j < jobs; j += kThreads) {
        if (assign[j] < 0) {
          list[atomicAdd(&s_count, 1)] = j;
          mine = 1;
        }
      }
      if (!__syncthreads_or(mine) || it >= p.max_iters) break;
      const int bidders = s_count;
      for (int k = warp; k < bidders; k += kWarps) {
        const int j = list[k];
        const Top2 t = row_top2(benefit + static_cast<size_t>(j) * domains, price, domains, lane);
        if (lane == 0) {
          const float second = fmaxf(t.second, sink);
          if (sink > t.best) {
            flag[j] = 2;  // takes its sink: uncontested and final
          } else {
            flag[j] = 0;
            const float bid =
                __fadd_rn(__fadd_rn(price[t.idx], __fsub_rn(t.best, second)), eps_k);
            atomicMax(&key[t.idx],
                      (static_cast<unsigned long long>(ordered(bid)) << 32) | (0xffffffffu - j));
          }
        }
      }
      bid_rows += bidders;
      __syncthreads();
      // Winners evict the previous owners and set the price to their bid.
      for (int d = tid; d < domains; d += kThreads) {
        const unsigned long long k = key[d];
        if (k) {
          key[d] = 0ull;
          const int winner = static_cast<int>(0xffffffffu - static_cast<unsigned>(k));
          const int prev = owner[d];
          if (prev >= 0) assign[prev] = -1;
          assign[winner] = d;
          owner[d] = winner;
          price[d] = from_ordered(static_cast<unsigned>(k >> 32));
        }
      }
      for (int k = tid; k < bidders; k += kThreads) {
        const int j = list[k];
        if (flag[j] == 2) assign[j] = domains;
      }
      ++it;
      __syncthreads();
    }
    done = eps_k <= eps_final;
    eps_k = fmaxf(eps_final, __fdiv_rn(eps_k, kTheta));
  }

  if (lane == 0 && my_repair_rows) atomicAdd(&s_repair_rows, my_repair_rows);
  for (int j = tid; j < jobs; j += kThreads) p.assignment[static_cast<size_t>(b) * jobs + j] = assign[j];
  for (int d = tid; d < domains; d += kThreads)
    p.prices[static_cast<size_t>(b) * domains + d] = price[d];
  __syncthreads();
  if (tid == 0) {
    p.iterations[b] = it;
    long long* s = p.stats + 4 * static_cast<size_t>(b);
    s[0] = bid_rows;
    s[1] = static_cast<long long>(s_repair_rows);
    s[2] = phases;
    s[3] = repair_passes;
  }
}

}  // namespace

extern "C" int auction_shared_bytes(int jobs, int domains) {
  return 16 * domains + 12 * jobs;
}

// Launch one block per problem on `stream`; returns the CUDA error code of
// the launch (0 on success). Structured problems pass load != nullptr and
// a [B, J, D] scratch; dense ones pass benefit.
extern "C" int auction_launch(int batch, int jobs, int domains, int log2_domains, int max_iters,
                              float eps, const float* benefit, float* scratch, const float* load,
                              const float* free_cap, const float* pods, const int* sticky,
                              const unsigned char* occupied, const int* own,
                              const int* num_domains, int* assignment, float* prices,
                              int* iterations, long long* stats, void* stream) {
  Params p{benefit, scratch, load, free_cap, pods, sticky, occupied, own, num_domains,
           assignment, prices, iterations, stats, jobs, domains, log2_domains, max_iters, eps};
  const int smem = auction_shared_bytes(jobs, domains);
  cudaError_t err =
      cudaFuncSetAttribute(auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  auction_kernel<<<batch, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
