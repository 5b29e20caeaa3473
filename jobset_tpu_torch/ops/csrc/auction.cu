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
// (block votes and counts in shared memory), never by a device-to-host copy.
//
// What bounds it. A chain of dependent rounds: every bidding round reads
// the prices the previous one wrote, and every phase starts from the
// previous phase's prices. A round's work is its bidders' bids, each of
// which a warp makes alone; the round waits for the last of them, then
// resolves the objects' bids. On one SM the bids are latency-bound chains
// (an L2 trip, warp reductions, a shared atomic) that share the SM's
// instruction throughput, so the time of a round follows the latency of a
// bid and the number of instructions per bid, far from the card's memory
// rate.
//
// What the design does about it.
// - Candidate lists. Within a phase prices only rise, so a bidder's values
//   only fall. A full scan of a job's row keeps each lane's four best
//   columns and the largest value among its other columns (the bound); a
//   later bid in the phase reads those 128 candidates (one 16-byte and one
//   8-byte load a lane) and answers from them alone when their best beats
//   the bound and their second reaches it, which no other column can then
//   change: the full scan's (best, first argmax, second), bit for bit. A
//   job's first two bids in a phase are plain scans, since most jobs of a
//   short phase bid once or twice (ListState). The lists live in shared
//   memory where they fit beside the state, else in a global scratch that
//   stays in L2.
// - Round bookkeeping stays the parent design's (a bidder list by shared
//   atomicAdd, four barriers a round, warp w bidding for list entries w,
//   w + 32, ..., winners evicting previous owners): on the card, a list
//   from ballots with fewer barriers, and warps taking bidders from a
//   counter, each cost more a round than they saved.
// - Warp reductions are __reduce_*_sync over order-preserving integer keys.
// All per-round state lives in shared memory: 16 B per object (bid key,
// price, owner) and 20 B per job, 26,624 B at 512x1024 and 141,312 B at
// 512x8192 (dynamic shared memory opt-in). A job's list is 768 B in
// shared memory or the scratch (its bound and state are 8 B of the 20):
// lists fit in shared memory up to 256 jobs at 1024 objects, not at 512.
// Batches are free: grid = B, one block each; a single solve uses one SM
// of 132.
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
constexpr unsigned kFullMask = 0xffffffffu;
constexpr float kNegInf = -1.0e9f;   // forbidden cell (IEEE-finite)
constexpr float kHalfNegInf = -5.0e8f;
constexpr float kCostCap = 1024.0f;
constexpr float kSinkBenefit = -4096.0f;
constexpr float kTheta = 8.0f;
constexpr int kMaxShared = 232448;  // what one block may opt into on an H100
// Candidate columns each lane keeps of a bidder's row on a full scan.
constexpr int kCand = 4;  // one float4 of benefits and one uint2 of columns a lane
constexpr unsigned short kNoColumn = 0xffff;  // an empty candidate slot (D_p <= 8192)
// float4 loads of a row a lane keeps in flight on a full scan.
constexpr int kRowBatch = 4;

// Shared memory that a block's static variables may take.
constexpr int kStaticReserve = 512;

// Dynamic shared memory of the solve's state: 16 B per object (bid key,
// price, owner) and 20 B per job, rounded up to 16 B so the candidate
// records that may follow are aligned.
__host__ __device__ constexpr int state_bytes(int jobs, int domains) {
  return (16 * domains + 20 * jobs + 15) / 16 * 16;
}

// A job's candidate list, one record: kCand benefits (f32) a lane, lane by
// lane, then kCand columns (u16) a lane. Its bound and its state (below)
// live in shared memory.
constexpr int kRecordBytes = 32 * kCand * 6;

// A job's list state within a phase, kept beside the phase as
// phase * 8 + state: a job's first two bids in a phase are plain scans
// (most jobs of a short phase bid once or twice); its third makes a list;
// once a list has answered a bid the job is proven and remakes its list
// whenever it fails; a first list that fails before it answered leaves
// the job to plain scans for the rest of the phase (as on dense problems
// with many ties).
enum ListState { kFresh, kFirst, kSecond, kListed, kProven, kNoList };

__host__ __device__ constexpr int candidate_bytes(int jobs) { return jobs * kRecordBytes; }

// The candidate lists live in shared memory where they fit beside the
// state, else in the launcher's global scratch (L2-resident).
__host__ __device__ constexpr bool candidates_in_shared(int jobs, int domains) {
  return state_bytes(jobs, domains) + candidate_bytes(jobs) + kStaticReserve <= kMaxShared;
}

struct Params {
  const float* benefit;        // dense: [B, J, D] scaled benefit
  float* scratch;              // structured: [B, J, D] written by the kernel; then, where
                               // they do not fit in shared memory, candidate lists
                               // of candidate_bytes(J) per problem
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
  long long* stats;            // [B, kStats] out: the counters below
  int jobs, domains, log2_domains, max_iters;
  float eps;
};

// Per-problem counters, in the order ops/auction.py::STATS names them.
// Cycles are thread 0's clock64(): the kernel's span, the repair
// fixpoints, and the parts of a bidding round from barrier to barrier
// (building the bidder list, the bids, conflict resolution); "barrier" is
// thread 0's wait inside the round's barriers, already inside those parts.
// Warp 0 also times its own bids, so a bid's latency is known. The round's
// parts and warp 0's bids are timed in one round of kTimedEvery (counted
// in kTimedRounds): on every round the clock reads and their sums in
// shared memory cost about 0.4 us a round.
enum Stat {
  kBidRows, kRepairRows, kPhases, kRepairPasses, kFullScanRows, kCachedBids, kCandidateBytes,
  kCyclesTotal, kCyclesRepair, kCyclesList, kCyclesBid, kCyclesResolve, kCyclesBarrier,
  kWarp0Scans, kWarp0ScanCycles, kWarp0Hits, kWarp0HitCycles, kTimedRounds, kStats
};
constexpr int kTimedEvery = 16;

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

// The warp's (best, first argmax, second) from each lane's over its own
// columns, on every lane, by integer reductions over order-preserving
// keys. Once the best is known, the argmax and the second reduce side by
// side: with the best in two lanes the second is the best; else it is the
// best lane's own second or another lane's best.
__device__ __forceinline__ Top2 top2_warp(Top2 t) {
  const float best = from_ordered(__reduce_max_sync(kFullMask, ordered(t.best)));
  const bool holds = t.best == best;
  const int idx = static_cast<int>(
      __reduce_min_sync(kFullMask, holds ? static_cast<unsigned>(t.idx) : 0xffffffffu));
  const float other =
      from_ordered(__reduce_max_sync(kFullMask, ordered(holds ? t.second : t.best)));
  return Top2{best, idx, __popc(__ballot_sync(kFullMask, holds)) > 1 ? best : other};
}

__device__ __forceinline__ float warp_min(float v) {
  for (int off = 16; off; off >>= 1) v = fminf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

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

// (best, first argmax, second) of benefit[j, :] - prices over one row,
// every lane of the warp ending with the row's result. Lane l reads float4
// columns l, l + 32, ..., kRowBatch loads in flight.
__device__ __forceinline__ Top2 row_top2(const float* row, const float* prices, int domains,
                                         int lane) {
  Top2 t{-CUDART_INF_F, 0x7fffffff, -CUDART_INF_F};
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* p4 = reinterpret_cast<const float4*>(prices);
  const int n4 = domains >> 2;
  int c = lane;
  for (; c + 32 * (kRowBatch - 1) < n4; c += 32 * kRowBatch) {
    float4 b[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) b[i] = r4[c + 32 * i];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) top2_add4(t, b[i], p4[c + 32 * i], 4 * (c + 32 * i));
  }
  for (; c < n4; c += 32) top2_add4(t, r4[c], p4[c], 4 * c);
  return top2_warp(t);
}

// Bidders' candidate lists. On a full scan each lane keeps its kCand best
// columns (benefit and column; ties to the lower column) and the largest
// value among its other columns; the job keeps the 32 x kCand candidates
// and the bound T, the largest such value over the lanes. Within a phase
// prices only rise (a winning bid is price + (best - second) + eps with
// best >= second and eps > 0, all rounded monotonically), so every
// non-candidate's value stays <= T. When the candidates' own best > T and
// their second >= T, no other column can equal the best or exceed the
// second: their (best, first argmax, second) is the full scan's, bit for
// bit. The phase-start repair lowers prices, so a list is used only in the
// phase it was made in (the job's ListState says which). A list is one
// record of kRecordBytes (see candidate_bytes).
static_assert(kCand == 4, "a lane's candidates are one float4 and one uint2");

// Best value, the first column holding it, and the largest other value,
// over values offered in any column order.
__device__ __forceinline__ void top2_add_any(Top2& t, float v, int d) {
  if (v > t.best || (v == t.best && d < t.idx)) {
    t.second = t.best;
    t.best = v;
    t.idx = d;
  } else {
    t.second = fmaxf(t.second, v);
  }
}

// One lane's kCand largest values with their columns, in descending
// order, and the largest value among its other columns.
struct LaneTopK {
  float v[kCand];
  int d[kCand];
  float rest;
};

// Offer column d (value v) to a lane's list. Columns come in ascending
// order, so strict comparisons keep slot 0 on the first column of the
// largest value (which of several equal values the list keeps does not
// matter: the bound takes every value left out).
__device__ __forceinline__ void topk_add(LaneTopK& k, float v, int d) {
  if (!(v > k.v[kCand - 1])) {
    k.rest = fmaxf(k.rest, v);
    return;
  }
  k.rest = fmaxf(k.rest, k.v[kCand - 1]);
  bool placed = false;
#pragma unroll
  for (int s = kCand - 1; s > 0; --s) {
    if (!placed) {
      if (v > k.v[s - 1]) {
        k.v[s] = k.v[s - 1];
        k.d[s] = k.d[s - 1];
      } else {
        k.v[s] = v;
        k.d[s] = d;
        placed = true;
      }
    }
  }
  if (!placed) {
    k.v[0] = v;
    k.d[0] = d;
  }
}

__device__ __forceinline__ void topk_add4(LaneTopK& k, float4 b, float4 p, int d) {
  topk_add(k, __fsub_rn(b.x, p.x), d);
  topk_add(k, __fsub_rn(b.y, p.y), d + 1);
  topk_add(k, __fsub_rn(b.z, p.z), d + 2);
  topk_add(k, __fsub_rn(b.w, p.w), d + 3);
}

// row_top2 that also writes the job's candidate list into `record` and
// its bound into `bound`, on every lane.
__device__ __forceinline__ Top2 row_top2_listed(const float* row, const float* prices,
                                                int domains, int lane, unsigned char* record,
                                                float& bound) {
  LaneTopK k;
#pragma unroll
  for (int s = 0; s < kCand; ++s) {
    k.v[s] = -CUDART_INF_F;
    k.d[s] = 0x7fffffff;
  }
  k.rest = -CUDART_INF_F;
  const float4* r4 = reinterpret_cast<const float4*>(row);
  const float4* p4 = reinterpret_cast<const float4*>(prices);
  const int n4 = domains >> 2;
  int c = lane;
  for (; c + 32 * (kRowBatch - 1) < n4; c += 32 * kRowBatch) {
    float4 b[kRowBatch];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) b[i] = r4[c + 32 * i];
#pragma unroll
    for (int i = 0; i < kRowBatch; ++i) topk_add4(k, b[i], p4[c + 32 * i], 4 * (c + 32 * i));
  }
  for (; c < n4; c += 32) topk_add4(k, r4[c], p4[c], 4 * c);
  // The candidates' benefits, from the row just read (L1).
  float b[kCand];
  unsigned short col[kCand];
#pragma unroll
  for (int s = 0; s < kCand; ++s) {
    const bool some = k.d[s] < domains;
    b[s] = some ? row[k.d[s]] : -CUDART_INF_F;
    col[s] = some ? static_cast<unsigned short>(k.d[s]) : kNoColumn;
  }
  reinterpret_cast<float4*>(record)[lane] = make_float4(b[0], b[1], b[2], b[3]);
  reinterpret_cast<uint2*>(record + 128 * kCand)[lane] =
      make_uint2(col[0] | static_cast<unsigned>(col[1]) << 16,
                 col[2] | static_cast<unsigned>(col[3]) << 16);
  bound = from_ordered(__reduce_max_sync(kFullMask, ordered(k.rest)));
  return top2_warp(Top2{k.v[0], k.d[0], fmaxf(k.v[1], k.rest)});
}

// Whether job j's list (its record, and its bound) answers for the whole
// row at the current prices: its (best, first argmax, second), left in t,
// has best > bound and second >= bound.
__device__ __forceinline__ bool candidate_top2(const unsigned char* record, float bound,
                                               const float* prices, int domains, int lane,
                                               Top2& t) {
  const float4 b4 = reinterpret_cast<const float4*>(record)[lane];
  const uint2 c2 = reinterpret_cast<const uint2*>(record + 128 * kCand)[lane];
  const float bv[kCand] = {b4.x, b4.y, b4.z, b4.w};
  const int d[kCand] = {static_cast<int>(c2.x & 0xffffu), static_cast<int>(c2.x >> 16),
                        static_cast<int>(c2.y & 0xffffu), static_cast<int>(c2.y >> 16)};
  t = Top2{-CUDART_INF_F, 0x7fffffff, -CUDART_INF_F};
#pragma unroll
  for (int s = 0; s < kCand; ++s)
    if (d[s] < domains) top2_add_any(t, __fsub_rn(bv[s], prices[d[s]]), d[s]);
  t = top2_warp(t);
  return t.best > bound && t.second >= bound;
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

// A block barrier; in a timed round thread 0 adds the cycles it waited
// there to `stat`.
__device__ __forceinline__ void timed_barrier(unsigned long long* stat, bool timed) {
  if (!timed) {
    __syncthreads();
    return;
  }
  const long long t = clock64();
  __syncthreads();
  if (threadIdx.x == 0) stat[kCyclesBarrier] += clock64() - t;
}

__device__ __forceinline__ int timed_barrier_or(unsigned long long* stat, bool timed, int pred) {
  if (!timed) return __syncthreads_or(pred);
  const long long t = clock64();
  pred = __syncthreads_or(pred);
  if (threadIdx.x == 0) stat[kCyclesBarrier] += clock64() - t;
  return pred;
}

// The job that a nonzero (bid, -job) key names.
__device__ __forceinline__ int winner(unsigned long long k) {
  return static_cast<int>(0xffffffffu - static_cast<unsigned>(k));
}

// Job j's bid from its row's (best, first argmax, second), by one thread:
// the sink when it beats every object (flag 2: uncontested and final),
// else prices[best] + (best - second) + eps for the argmax, into the
// object's (bid, -job) key, so the highest bid wins and ties go to the
// lowest job index whatever order the warps run in.
__device__ __forceinline__ void place_bid(Top2 t, int j, float sink, float eps_k,
                                          const float* price, unsigned long long* key, int* flag) {
  const float second = fmaxf(t.second, sink);
  if (sink > t.best) {
    flag[j] = 2;
    return;
  }
  flag[j] = 0;
  const float bid = __fadd_rn(__fadd_rn(price[t.idx], __fsub_rn(t.best, second)), eps_k);
  atomicMax(&key[t.idx], (static_cast<unsigned long long>(ordered(bid)) << 32) | (0xffffffffu - j));
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
  int* list_tag = flag + jobs;                                            // [J]
  float* list_bound = reinterpret_cast<float*>(list_tag + jobs);          // [J]
  __shared__ unsigned s_bmax, s_bmin, s_min_live;
  __shared__ int s_num_finite, s_num_live;
  __shared__ unsigned long long s_stat[kStats];
  __shared__ int s_count;

  const long long t_start = clock64();
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t cells = static_cast<size_t>(jobs) * domains;
  const float* benefit;
  float* spare = p.scratch;  // past the structured benefit, if any
  if (p.load != nullptr) {
    float* out = p.scratch + b * cells;
    build_structured(p, b, out);
    benefit = out;
    spare = p.scratch + gridDim.x * cells;
  } else {
    benefit = p.benefit + b * cells;
  }
  // The candidate lists: one record per job.
  const bool cand_shared = candidates_in_shared(jobs, domains);
  unsigned char* const records =
      cand_shared ? smem + state_bytes(jobs, domains)
                  : reinterpret_cast<unsigned char*>(spare) +
                        static_cast<size_t>(b) * candidate_bytes(jobs);
  const float sink = static_cast<float>(static_cast<double>(kSinkBenefit) * (jobs + 1));
  if (tid == 0) {
    s_bmax = ordered(-CUDART_INF_F);
    s_bmin = ordered(CUDART_INF_F);
    s_min_live = ordered(CUDART_INF_F);
    s_num_finite = 0;
    s_num_live = 0;
  }
  for (int i = tid; i < kStats; i += kThreads) s_stat[i] = 0;
  for (int j = tid; j < jobs; j += kThreads) list_tag[j] = 0;
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
  int bid_rows = 0;            // bids over all rounds
  int probes = 0, cached = 0;  // this warp's list probes, and the bids they answered
  int my_repair_rows = 0;
  bool done = false;
  while (!done && it < p.max_iters) {
    ++phases;
    const long long t_phase = clock64();
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
    if (tid == 0) s_stat[kCyclesRepair] += clock64() - t_phase;
    // Jacobi bidding rounds until every job holds an object or its sink.
    // A round: the bidder list, the bids, the resolution.
    for (;;) {
      const bool timed = it % kTimedEvery == 0;
      const long long t_round = timed ? clock64() : 0;
      if (tid == 0) s_count = 0;
      timed_barrier(s_stat, timed);
      int mine = 0;
      for (int j = tid; j < jobs; j += kThreads) {
        if (assign[j] < 0) {
          list[atomicAdd(&s_count, 1)] = j;
          mine = 1;
        }
      }
      const int any = timed_barrier_or(s_stat, timed, mine);
      const long long t_listed = timed ? clock64() : 0;
      if (!any || it >= p.max_iters) break;
      const int total = s_count;
      bid_rows += total;
      if (timed && tid == 0) {
        s_stat[kCyclesList] += t_listed - t_round;
        s_stat[kTimedRounds] += 1;
      }
      for (int k = warp; k < total; k += kWarps) {
        const int j = list[k];
        const bool timed_bid = timed && warp == 0;
        const long long t_bid = timed_bid ? clock64() : 0;
        // The list answers where the rule lets it; else a full scan does,
        // which makes or remakes the list as the job's state says.
        unsigned char* record = records + static_cast<size_t>(j) * kRecordBytes;
        const float* row = benefit + static_cast<size_t>(j) * domains;
        const int tag = list_tag[j];
        const int state = tag >> 3 == phases ? tag & 7 : kFresh;
        Top2 t;
        bool hit = false;
        if (state == kListed || state == kProven) {
          hit = candidate_top2(record, list_bound[j], price, domains, lane, t);
          ++probes;
        }
        int next = kProven;
        if (!hit && (state == kSecond || state == kProven)) {
          float bound;
          t = row_top2_listed(row, price, domains, lane, record, bound);
          if (lane == 0) list_bound[j] = bound;
          next = state == kProven ? kProven : kListed;
        } else if (!hit) {
          t = row_top2(row, price, domains, lane);
          next = state == kFresh ? kFirst : state == kFirst ? kSecond : kNoList;
        }
        if (lane == 0) list_tag[j] = phases << 3 | next;
        cached += hit;
        if (lane == 0) {
          place_bid(t, j, sink, eps_k, price, key, flag);
          if (timed_bid) {
            const long long c = clock64() - t_bid;
            s_stat[hit ? kWarp0Hits : kWarp0Scans] += 1;
            s_stat[hit ? kWarp0HitCycles : kWarp0ScanCycles] += c;
          }
        }
      }
      timed_barrier(s_stat, timed);
      const long long t_bids = timed ? clock64() : 0;
      if (timed && tid == 0) s_stat[kCyclesBid] += t_bids - t_listed;
      // Winners evict the previous owners and set the price to their bid;
      // jobs that took their sink hold it.
      for (int d = tid; d < domains; d += kThreads) {
        const unsigned long long k = key[d];
        if (k) {
          key[d] = 0ull;
          const int won = winner(k);
          const int prev = owner[d];
          if (prev >= 0) assign[prev] = -1;
          assign[won] = d;
          owner[d] = won;
          price[d] = from_ordered(static_cast<unsigned>(k >> 32));
        }
      }
      for (int k = tid; k < total; k += kThreads) {
        const int j = list[k];
        if (flag[j] == 2) assign[j] = domains;
      }
      ++it;
      timed_barrier(s_stat, timed);
      if (timed && tid == 0) s_stat[kCyclesResolve] += clock64() - t_bids;
    }
    done = eps_k <= eps_final;
    eps_k = fmaxf(eps_final, __fdiv_rn(eps_k, kTheta));
  }

  if (lane == 0) {
    atomicAdd(&s_stat[kRepairRows], static_cast<unsigned long long>(my_repair_rows));
    atomicAdd(&s_stat[kCachedBids], static_cast<unsigned long long>(cached));
    if (!cand_shared) {
      atomicAdd(&s_stat[kCandidateBytes],
                static_cast<unsigned long long>(probes) * kRecordBytes);
    }
  }
  for (int j = tid; j < jobs; j += kThreads) p.assignment[static_cast<size_t>(b) * jobs + j] = assign[j];
  for (int d = tid; d < domains; d += kThreads)
    p.prices[static_cast<size_t>(b) * domains + d] = price[d];
  __syncthreads();
  if (tid == 0) {
    p.iterations[b] = it;
    s_stat[kBidRows] = bid_rows;
    s_stat[kFullScanRows] = bid_rows - s_stat[kCachedBids];
    s_stat[kPhases] = phases;
    s_stat[kRepairPasses] = repair_passes;
    s_stat[kCyclesTotal] = clock64() - t_start;
    long long* s = p.stats + kStats * static_cast<size_t>(b);
    for (int i = 0; i < kStats; ++i) s[i] = static_cast<long long>(s_stat[i]);
  }
}

}  // namespace

// Dynamic shared memory of one block: the state, and the candidate lists
// where they fit beside it.
extern "C" int auction_shared_bytes(int jobs, int domains) {
  return state_bytes(jobs, domains) +
         (candidates_in_shared(jobs, domains) ? candidate_bytes(jobs) : 0);
}

// Global scratch bytes a problem's candidate lists need: 0 where they live
// in shared memory.
extern "C" int auction_candidate_scratch_bytes(int jobs, int domains) {
  return candidates_in_shared(jobs, domains) ? 0 : candidate_bytes(jobs);
}

// Launch one block per problem on `stream`; returns the CUDA error code of
// the launch (0 on success). Structured problems pass load != nullptr and
// a scratch of B x J x D floats; dense ones pass benefit. Where the
// candidate lists do not fit in shared memory, the scratch continues (or,
// for dense problems, starts) with B x auction_candidate_scratch_bytes.
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
