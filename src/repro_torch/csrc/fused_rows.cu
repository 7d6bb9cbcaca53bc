// fused_rows: the fused plane's row solver, one CTA per (decision, alpha)
// row (sm_90a).
//
// Replaces the device row solver of FusedJaxBackend._solver_core
// (src/repro/core/backend.py: prep's consumers solve_row / solve_rows) and,
// inside it, the two calls of the TPU kernel _cover_kernel (the core-bound
// DP and the decode DP), which here are cover_dp_block of cover_dp.cuh, and
// the TPU kernel _score_kernel, which here is score_block of score.cuh in
// the tail of each golden row.
// One row is one host engine row of repro_torch.core.ilp._solve_rows, stage
// for stage:
//   1. saturation: neg = coef < 0 & active; sat = bound where neg;
//      covered / capacity; residual = max(req - covered, 0); exits for
//      residual == 0 (feasible, counts = sat) and capacity < residual
//      (infeasible, counts = sat);
//   2. the coarsening mode: granularity eff_g (the market gcd in gcd mode,
//      else 1) and the DP target eff_res = ceil(residual / eff_g);
//   3. the LP prune over the row's DP bundles (those of active, non-negative
//      items, compacted in market order): bcost = coef[item] * copies, rate
//      = bcost / pods, a stable rate order, the sequential sums cum_p and
//      cum_c, the greedy bound ub = cum_c[k_ub], k_ub =
//      searchsorted(cum_p, residual), lp per bundle and keep = bcost + lp
//      <= ub * (1 + 1e-12) + 1e-9;
//   4. when more than 160 bundles are kept, the core bound: a values-only
//      cover DP over the first K = min(n, max(k_ub + 33, 96)) rate-ordered
//      bundles at eff_res, and the keep test again with it when tighter;
//   5. the kept bundles in market order;
//   6. the decode DP with improvement bits over them at eff_res;
//   7. the backtrack (one warp) adding each taken bundle's copies to sat;
//   8. when the caller asks for scores (the golden rows), the pool score of
//      the row's counts at its decision's demand score_req[r], or -inf
//      unless the row is FEASIBLE: every exit reaches this tail, so its
//      barriers stay uniform across the CTA.
// The DP runs at width eff_res + 1, as the host engine does: the
// reference's tier ladder and shape buckets exist only for XLA's static
// shapes.
//
// Only a prefix of the rate order is ever read. Every LP search targets
// rb <= residual, so it lands at or before k_ub; ub is cum_c[k_ub]; the
// core DP reads ord[0:K]. So a row needs the first M = K (>= k_ub + 1)
// bundles of the stable order, and cum_c only up to k_ub. The kernel
// selects them instead of sorting all n:
//   * select: two warp-segmented passes over the bundles compact them in
//     market order (a ballot a step, the warps' counts from the first
//     pass) and build a shared-memory histogram of the rate's bit pattern
//     (keys are >= 0 and finite, + 0.0 folds -0.0, so the patterns order
//     as the values; 4095 bins over [min positive key, max key], bin 0 for
//     0.0) holding each bin's count and pod sum (clamped to the residual,
//     in 32 bits). The first bin whose pod sum reaches the residual bounds
//     k_ub, hence M; the cut is the first bin whose count reaches that
//     bound. Every bundle at or below the cut is a candidate: a superset
//     of the prefix, ties included;
//   * prefix path (candidates <= kCap): the candidates are sorted by (key,
//     market index) with a bitonic sort in shared memory, which is the
//     stable order's prefix; cum_p is an int64 block scan over them;
//   * full path (more candidates, e.g. a residual near capacity or a row of
//     ties): a bottom-up merge sort of all n keys in global memory and the
//     int64 scan over all n. Both paths feed the same code below and are
//     bitwise equal; the path a row took goes to `paths`.
// cum_c is a strict left-to-right float64 chain over [0, k_ub] (one
// thread), cum_p integers far below 2^53, so both are np.cumsum's bits.
// A bundle's LP bound depends on it only through rb = max(residual - pods,
// 0), so for residuals below kLpTable it is computed once per rb into a
// shared table that the LP pass reads. The kept bundles are staged (pods
// in DP units, cost, copies, item) for the decode DP and the backtrack
// (one warp, 32 bits rows a read). Both DPs run on two dp rows
// (cover_dp.cuh), their bundles staged a chunk at a time through a small
// static buffer: the first row in front of the work region, the second
// where the LP table was, since stage 3d is the table's last reader; when
// the rows do not fit shared memory, both are the row's own two rows of
// `dp_global`.
//
// Where bitwise parity with the host could break, and what this does:
//   * FMA contraction: bcost, lp, the keep thresholds are products feeding
//     adds or compares; the library is built with --fmad=false.
//   * sequential sums: above; cum_p as int64 is exact.
//   * stable order with ties (+inf never occurs here: only finite bundles
//     are compacted in; -0.0 vs 0.0 does): keys + 0.0 compared as bit
//     patterns, ties broken by the compacted (market-order) index; the
//     merge sort compares the same keys with < and <=.
//   * clamped gathers: every searchsorted index is clamped to the searched
//     range, as JAX clamps; no read leaves the row.
//   * searchsorted is side-left (integer compares on cum_p), rb taken in
//     market order.
//   * parallel blocks: no dp row, bracket or counter crosses CTAs.
//
// What bounds it on an H100: the chains, not bytes or flops. Per row the
// two DPs are chains of bundle steps, one barrier each, still the longest
// stages; the O(n) stages are a few coalesced passes at 768 threads. A
// row's inputs are N coefficients and flags, its output N counts. Rows
// are independent, so a launch fills the SMs with as many rows as the
// caller stacks (a prescan is D x G rows, a golden round D).
//
// `stages`, when not null, receives kStages clock64() stamps a row, taken
// by thread 0 after the barrier that ends each stage: start, saturation,
// select (compaction, histogram, cut, candidates), sort, sums, LP, core
// DP, kept, decode DP, backtrack, score. A row that exits early stamps
// the rest but the score at its exit.

#include <stdint.h>

#include "cover_dp.cuh"
#include "score.cuh"

namespace {

constexpr int kRowThreads = 768;
constexpr int kRowWarps = kRowThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// the selection histogram and the prefix path's capacity (a power of two)
constexpr int kBins = 4096;
constexpr int kCap = 2048;
// residuals up to which the LP bound per rb = residual - pods is tabled
constexpr long long kLpTable = 8192;
constexpr int kStages = 11;
constexpr int kSlabs = 7;      // B-long 8-byte scratch slabs a row
constexpr long long kPodClamp = 1ll << 21;   // residuals the histogram bounds

// the host engine's prune constants (repro_torch.core.backend); the prefix
// holds k_ub + 1 and K bundles only while K >= k_ub + 1, which
// kCorePad >= 1 keeps
constexpr long long kCoreTrigger = 160;
constexpr long long kCorePad = 33;
constexpr long long kCoreMin = 96;
constexpr double kKeepRel = 1.0 + 1e-12;
constexpr double kKeepAbs = 1e-9;
static_assert(kCorePad >= 1, "the prefix must reach k_ub");

// row status codes (the `feas` output)
constexpr unsigned char kInfeasible = 0;
constexpr unsigned char kFeasible = 1;
constexpr unsigned char kTooWide = 2;   // eff_res + 1 > width_cap: not solved

// row path codes (the `paths` output)
constexpr unsigned char kPathNone = 0;     // exited before the prune
constexpr unsigned char kPathPrefix = 1;   // candidates sorted in shared
constexpr unsigned char kPathFull = 2;     // all n sorted in global

// shared memory after the dp row: a work region holding the histogram,
// then (aliasing it) the sorted prefix, then the staged kept bundles, then
// the score's partial sums; and the LP table, then the second dp row
constexpr int kHistBytes = kBins * (4 + 4);
constexpr int kWorkBytes = kCap * (8 + 4 + 8 + 8 + 8);
// a staged kept bundle: pods / eff_g, cost, copies (8 bytes each), item
constexpr int kKeptBytes = 8 + 8 + 8 + 4;
// loads a lane issues ahead of their use in the O(n) passes
constexpr int kBatch = 4;
static_assert(kHistBytes <= kWorkBytes, "histogram outgrows the work region");
// the LP table, and the second dp row of any row that runs in shared
// memory (width_cap <= kLpTable + 1, core/cover_dp.py SMEM_DP_WIDTH)
constexpr int kLpTableBytes = (kLpTable + 1) * 8;
static_assert(3 * kubepacs::kScoreLanes * 8 <= kWorkBytes,
              "the score's partial sums outgrow the work region");

struct Market {
  const long long* pods;      // (N,)
  const long long* bound;     // (N,)
  const double* perf;         // (N,) the score's market vectors
  const double* price;        // (N,)
  const double* podsf;        // (N,) pods as float64
  const long long* b_item;    // (B,)
  const long long* b_pods;    // (B,)
  const long long* b_copies;  // (B,)
  long long n_items;
  long long n_bundles;
};

// The rate-ordered DP bundles: the core DP's input.
struct SortedBundles {
  const long long* p_sorted;
  const double* c_sorted;
  long long eff_g;
  __device__ long long pods(long long i) const {
    return eff_g == 1 ? p_sorted[i] : p_sorted[i] / eff_g;
  }
  __device__ double cost(long long i) const { return c_sorted[i]; }
};

// The kept bundles in market order, staged: the decode DP's input.
struct KeptBundles {
  const long long* pods_g;   // pods / eff_g
  const double* costs;
  __device__ long long pods(long long i) const { return pods_g[i]; }
  __device__ double cost(long long i) const { return costs[i]; }
};

__device__ __forceinline__ unsigned long long key_bits(double key) {
  return static_cast<unsigned long long>(__double_as_longlong(key));
}

// Sum of v over the CTA, returned to every thread.
__device__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_down_sync(kFull, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kRowWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Exclusive prefix of v over the CTA in thread order; `*total` gets the
// sum. Every thread must call it.
__device__ long long block_excl_scan(long long v, long long* red,
                                     long long* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  long long inc = v;
  for (int o = 1; o < 32; o <<= 1) {
    const long long u = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) red[warp] = inc;
  __syncthreads();
  long long before = 0, sum = 0;
  for (int w = 0; w < kRowWarps; ++w) {
    const long long c = red[w];
    if (w < warp) before += c;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return before + inc - v;
}

// out[i] = in[0] + ... + in[i] for i < len (int64, exact). Every thread
// must call it; ends with a barrier.
__device__ void block_incl_scan(const long long* in, long long* out,
                                long long len, long long* red) {
  constexpr int kPer = 4;
  long long carry = 0;
  for (long long base = 0; base < len;
       base += static_cast<long long>(kRowThreads) * kPer) {
    const long long i0 = base + static_cast<long long>(threadIdx.x) * kPer;
    long long v[kPer];
    long long s = 0;
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      s += i0 + e < len ? in[i0 + e] : 0;
      v[e] = s;
    }
    long long total;
    const long long before = block_excl_scan(s, red, &total);
#pragma unroll
    for (int e = 0; e < kPer; ++e) {
      if (i0 + e < len) out[i0 + e] = carry + before + v[e];
    }
    carry += total;
  }
  __syncthreads();
}

// First index in sorted cum[0:n) with cum[i] >= x (numpy's side-left
// searchsorted), clamped to n - 1 as JAX clamps a gather.
__device__ long long search_left(const long long* cum, long long n,
                                 long long x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (cum[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < n ? lo : n - 1;
}

// This warp's slice of [0, len): consecutive runs of 32, so that a ballot
// a step keeps market order within the warp and warps follow each other.
struct WarpSegment {
  int lo, hi;
  __device__ explicit WarpSegment(int len) {
    const int per = (len + kRowWarps - 1) / kRowWarps;
    const int seg = (per + 31) / 32 * 32;
    lo = static_cast<int>(threadIdx.x >> 5) * seg;
    if (lo > len) lo = len;
    hi = lo + seg < len ? lo + seg : len;
  }
};

// Per-warp counts -> each warp's exclusive offset and the total.
__device__ long long warp_offset(const long long* counts, long long* total) {
  const int warp = threadIdx.x >> 5;
  long long before = 0, sum = 0;
  for (int w = 0; w < kRowWarps; ++w) {
    if (w < warp) before += counts[w];
    sum += counts[w];
  }
  *total = sum;
  return before;
}

// Stages 1-7 of row blockIdx.x, with the whole CTA (every thread must call
// it); returns the row's status, the same in every thread. `work` is its
// work region in shared memory, after the first dp row (`dp_smem` bytes,
// 0 when both rows are the row's two rows of `dp_global`), the LP table
// after it; `st` its clock64 stamps or null.
__device__ __forceinline__ unsigned char solve_row(
    const Market& m, const double* __restrict__ coefs,
    const unsigned char* __restrict__ actives,
    const long long* __restrict__ reqs, long long thr, long long maxr,
    long long gcd, long long width_cap, double* fscratch, int* iscratch,
    unsigned char* keep, double* dp_global, unsigned char* bits,
    long long* counts_out, unsigned char* feas_out, int dp_smem,
    unsigned char* work, unsigned char* paths, long long* st) {
  __shared__ long long red[kRowWarps];
  __shared__ long long wcount[kRowWarps];
  __shared__ unsigned long long wmin[kRowWarps], wmax[kRowWarps];
  __shared__ long long s_b1_count, s_cut_bin, s_cut_count;
  __shared__ int s_cand;

  const long long r = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const unsigned lane_lt = (1u << lane) - 1u;
  const long long N = m.n_items, B = m.n_bundles;
  const double* coef = coefs + r * N;
  const unsigned char* active = actives + r * N;
  long long* counts = counts_out + r * N;
  auto stamp = [&](int s) {
    if (st && tid == 0) st[s] = clock64();
  };
  auto exit_row = [&](unsigned char status) {
    if (tid == 0) {
      if (st) {
        const long long c = clock64();
        for (int s = 2; s < kStages - 1; ++s) st[s] = c;
      }
      if (paths) paths[r] = kPathNone;
      feas_out[r] = status;
    }
    return status;
  };
  double* lp_table = reinterpret_cast<double*>(work + kWorkBytes);
  // the two dp rows: the first in front of the work region, the second
  // where the LP table is (free from the core DP on); or both in global
  // memory. Two calls of the DP, so that the shared one compiles to shared
  // loads and stores
  double* row_s = reinterpret_cast<double*>(work - ((dp_smem + 15) & ~15));
  double* row_g = dp_global + r * 2 * width_cap;
  __shared__ kubepacs::Stage stage;   // the DPs' staged bundles
  auto cover = [&](const auto& bundles, long long nb, long long target,
                   unsigned char* bits_rows) {
    if (dp_smem) {
      kubepacs::cover_dp_block<kRowThreads>(bundles, nb, target, row_s,
                                            lp_table, bits_rows, stage);
    } else {
      kubepacs::cover_dp_block<kRowThreads>(bundles, nb, target, row_g,
                                            row_g + width_cap, bits_rows,
                                            stage);
    }
  };

  // -- 1. saturation ------------------------------------------------------
  long long cov = 0, cap = 0;
  for (long long i = tid; i < N; i += kRowThreads) {
    const bool a = active[i] != 0;
    const bool neg = a && coef[i] < 0.0;
    counts[i] = neg ? m.bound[i] : 0;
    const long long pb = m.pods[i] * m.bound[i];
    if (neg) cov += pb;
    if (a && !neg) cap += pb;
  }
  const long long covered = block_sum(cov, red);
  const long long capacity = block_sum(cap, red);
  const long long req = reqs[r];
  const long long residual = req - covered > 0 ? req - covered : 0;
  stamp(1);
  if (residual == 0) return exit_row(kFeasible);
  if (capacity < residual) return exit_row(kInfeasible);

  // -- 2. coarsening mode -------------------------------------------------
  const long long rs_g = (residual + gcd - 1) / gcd;
  const bool use_g = residual > thr && gcd > 1 && rs_g <= maxr;
  const long long eff_g = use_g ? gcd : 1;
  const long long eff_res = (residual + eff_g - 1) / eff_g;
  if (eff_res + 1 > width_cap) return exit_row(kTooWide);

  // per-row scratch: kSlabs B-long 8-byte slabs, three B-long int slabs.
  // Compacted (market order, index k): bcost, key, lp, pods_c, bidx.
  // Select pass 1 leaves each bundle's key and cost by bundle index in
  // slabs the full path reuses for its sort buffer and cum_c.
  double* f = fscratch + r * kSlabs * B;
  double* bcost = f;
  double* key_k = f + B;
  double* key_alt = f + 2 * B;
  long long* cum_p_g = reinterpret_cast<long long*>(f + 3 * B);
  double* cum_c_g = f + 4 * B;
  double* lp = f + 5 * B;
  long long* pods_c = reinterpret_cast<long long*>(f + 6 * B);
  double* key_b = key_alt;
  double* cost_b = cum_c_g;
  int* ip = iscratch + r * 3 * B;
  int* bidx = ip;
  int* ibuf0 = ip + B;
  int* ibuf1 = ip + 2 * B;
  unsigned char* kp = keep + r * B;
  unsigned* hist_count = reinterpret_cast<unsigned*>(work);
  unsigned* hist_pods = reinterpret_cast<unsigned*>(work + kBins * 4);
  // A bin's pod sum only has to be compared with the residual: each bundle
  // adds min(pods, residual), and none adds once the bin has reached it.
  // The bin's value is then >= residual iff its true sum is, and equal to
  // it below that; it stays under residual * (kRowThreads + 2), so 32 bits
  // hold it for residuals below kPodClamp (native shared atomics; a 64-bit
  // shared add is a compare-and-swap loop). Larger residuals skip the
  // bound: M = n.
  const bool pods_hist = residual < kPodClamp;
  const unsigned pod_cap = pods_hist ? static_cast<unsigned>(residual) : 0u;

  // -- 3a. select: compact in market order, histogram of the rate keys ----
  // pass 1: each bundle's key and cost, this warp's count, key range (no
  // warp collective in the loop, so its gathers pipeline)
  for (int i = tid; i < kBins; i += kRowThreads) {
    hist_count[i] = 0;
    hist_pods[i] = 0;
  }
  const WarpSegment bseg(static_cast<int>(B));
  {
    long long cnt = 0;
    unsigned long long lo_key = ~0ull, hi_key = 0;
    for (int base = bseg.lo + lane; base < bseg.hi; base += 32 * kBatch) {
      long long it[kBatch], cp[kBatch], pp[kBatch];
      double c0[kBatch];
      unsigned char on[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = base + 32 * u;
        it[u] = b < bseg.hi ? m.b_item[b] : 0;
        cp[u] = b < bseg.hi ? m.b_copies[b] : 1;
        pp[u] = b < bseg.hi ? m.b_pods[b] : 1;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        c0[u] = coef[it[u]];
        on[u] = active[it[u]];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int b = base + 32 * u;
        if (b >= bseg.hi) continue;
        double c = 0.0, key = -1.0;        // a key below zero: not in the DP
        if (on[u] != 0 && !(c0[u] < 0.0)) {
          c = c0[u] * static_cast<double>(cp[u]);
          key = c / static_cast<double>(pp[u]) + 0.0;
          const unsigned long long kb = key_bits(key);
          ++cnt;
          if (kb != 0 && kb < lo_key) lo_key = kb;
          if (kb > hi_key) hi_key = kb;
        }
        key_b[b] = key;
        cost_b[b] = c;
      }
    }
    for (int o = 16; o >= 1; o >>= 1) {
      cnt += __shfl_xor_sync(kFull, cnt, o);
      const unsigned long long a = __shfl_xor_sync(kFull, lo_key, o);
      const unsigned long long z = __shfl_xor_sync(kFull, hi_key, o);
      lo_key = a < lo_key ? a : lo_key;
      hi_key = z > hi_key ? z : hi_key;
    }
    if (lane == 0) {
      wcount[warp] = cnt;
      wmin[warp] = lo_key;
      wmax[warp] = hi_key;
    }
  }
  __syncthreads();
  long long n;
  long long k = warp_offset(wcount, &n);
  unsigned long long lo_key = ~0ull, hi_key = 0;
  for (int w = 0; w < kRowWarps; ++w) {
    lo_key = wmin[w] < lo_key ? wmin[w] : lo_key;
    hi_key = wmax[w] > hi_key ? wmax[w] : hi_key;
  }
  // bin 0 holds the zero keys, bins 1.. kBins - 1 [lo_key, hi_key]
  const unsigned long long span = hi_key > lo_key && lo_key != ~0ull
                                      ? hi_key - lo_key : 0;
  int shift = 0;
  while ((span >> shift) >= static_cast<unsigned long long>(kBins - 1)) {
    ++shift;
  }
  auto bin_of = [&](unsigned long long kb) -> int {
    return kb == 0 ? 0 : 1 + static_cast<int>((kb - lo_key) >> shift);
  };
  // pass 2: compact (a ballot a step) and count into the histogram; a key
  // below zero marks a bundle outside the row's DP
  for (int base = bseg.lo; base < bseg.hi; base += 32 * kBatch) {
    double keys[kBatch], costs[kBatch];
    long long pods[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = base + 32 * u + lane;
      keys[u] = b < bseg.hi ? key_b[b] : -1.0;
      costs[u] = b < bseg.hi ? cost_b[b] : 0.0;
      pods[u] = b < bseg.hi ? m.b_pods[b] : 0;
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int b = base + 32 * u + lane;
      const double key = keys[u];
      const bool in = !(key < 0.0);
      const unsigned mask = __ballot_sync(kFull, in);
      if (in) {
        const long long pos = k + __popc(mask & lane_lt);
        const long long p = pods[u];
        bidx[pos] = b;
        bcost[pos] = costs[u];
        key_k[pos] = key;
        pods_c[pos] = p;
        const int bin = bin_of(key_bits(key));
        atomicAdd(&hist_count[bin], 1u);
        if (hist_pods[bin] < pod_cap) {
          atomicAdd(&hist_pods[bin], p < pod_cap ? static_cast<unsigned>(p)
                                                 : pod_cap);
        }
      }
      k += __popc(mask);
    }
  }
  if (tid == 0) {
    s_b1_count = n;      // defaults; every bin sum below is reached
    s_cut_bin = kBins - 1;
    s_cut_count = n;
    s_cand = 0;
  }
  __syncthreads();

  // the cut: bin b1 where the pod sum reaches the residual bounds k_ub <=
  // count(bins <= b1) - 1, hence M; the cut bin's count reaches that bound
  {
    constexpr int kPer = (kBins + kRowThreads - 1) / kRowThreads;
    const int b0 = tid * kPer < kBins ? tid * kPer : kBins;
    const int b_end = b0 + kPer < kBins ? b0 + kPer : kBins;
    long long c_own = 0, p_own = 0;
    for (int e = b0; e < b_end; ++e) {
      c_own += hist_count[e];
      p_own += hist_pods[e];
    }
    long long c_all, p_all;
    const long long c_before = block_excl_scan(c_own, red, &c_all);
    const long long p_before = block_excl_scan(p_own, red, &p_all);
    if (pods_hist && p_before < residual && p_before + p_own >= residual) {
      long long cc = c_before, pp = p_before;
      for (int e = b0; e < b_end; ++e) {
        cc += hist_count[e];
        pp += hist_pods[e];
        if (pp >= residual) break;
      }
      s_b1_count = cc;
    }
    __syncthreads();
    const long long bound_k = s_b1_count - 1 + kCorePad > kCoreMin
                                  ? s_b1_count - 1 + kCorePad : kCoreMin;
    const long long m_bound = bound_k < n ? bound_k : n;
    if (c_before < m_bound && c_before + c_own >= m_bound) {
      long long cc = c_before;
      for (int e = b0; e < b_end; ++e) {
        cc += hist_count[e];
        if (cc >= m_bound) {
          s_cut_bin = e;
          s_cut_count = cc;
          break;
        }
      }
    }
    __syncthreads();
  }
  const long long n_cand = s_cut_count;
  const bool prefix = n_cand <= kCap;

  // the sorted prefix (shared) or the full order (global)
  const double* c_sorted;
  const long long* p_sorted;
  long long* cum_p;
  double* cum_c;
  int* kept;
  long long len;
  if (prefix) {
    unsigned long long* cand_key = reinterpret_cast<unsigned long long*>(work);
    int* cand_idx = reinterpret_cast<int*>(work + kCap * 8);
    long long* p_s = reinterpret_cast<long long*>(work + kCap * 12);
    long long* cum_p_s = reinterpret_cast<long long*>(work + kCap * 20);
    double* cum_c_s = reinterpret_cast<double*>(work + kCap * 28);
    const int cut = static_cast<int>(s_cut_bin);
#pragma unroll 4
    for (long long i = tid; i < n; i += kRowThreads) {
      const unsigned long long kb = key_bits(key_k[i]);
      if (bin_of(kb) <= cut) {
        const int slot = atomicAdd(&s_cand, 1);
        cand_key[slot] = kb;
        cand_idx[slot] = static_cast<int>(i);
      }
    }
    int P = 1;
    while (P < n_cand) P <<= 1;
    for (int i = static_cast<int>(n_cand) + tid; i < P; i += kRowThreads) {
      cand_key[i] = ~0ull;
      cand_idx[i] = 0x7fffffff;
    }
    __syncthreads();
    stamp(2);

    // -- 3b. bitonic sort of the candidates by (key, market index) --------
    for (int size = 2; size <= P; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int i = tid; i < P / 2; i += kRowThreads) {
          const int lo = (i / stride) * 2 * stride + i % stride;
          const int hi = lo + stride;
          const unsigned long long ka = cand_key[lo], kz = cand_key[hi];
          const int ia = cand_idx[lo], iz = cand_idx[hi];
          const bool gt = ka > kz || (ka == kz && ia > iz);
          if (gt == ((lo & size) == 0)) {
            cand_key[lo] = kz;
            cand_key[hi] = ka;
            cand_idx[lo] = iz;
            cand_idx[hi] = ia;
          }
        }
        __syncthreads();
      }
    }
    double* c_s = reinterpret_cast<double*>(cand_key);   // keys are done
    for (long long i = tid; i < n_cand; i += kRowThreads) {
      const int o = cand_idx[i];
      c_s[i] = bcost[o];
      p_s[i] = pods_c[o];
    }
    c_sorted = c_s;
    p_sorted = p_s;
    cum_p = cum_p_s;
    cum_c = cum_c_s;
    kept = ibuf1;
    len = n_cand;
  } else {
    for (long long i = tid; i < n; i += kRowThreads) {
      ibuf0[i] = static_cast<int>(i);
    }
    __syncthreads();
    stamp(2);

    // -- 3b. stable order of all n: bottom-up merge sort of (key, index) --
    // An element of a left run lands after the right run's strictly
    // smaller keys; one of a right run after the left run's smaller-or-
    // equal keys: stable.
    double* ka = key_k;
    double* kz = key_alt;
    int* ia = ibuf0;
    int* iz = ibuf1;
    for (long long w = 1; w < n; w <<= 1) {
      for (long long i = tid; i < n; i += kRowThreads) {
        const long long lo = (i / (2 * w)) * (2 * w);
        const long long mid = lo + w < n ? lo + w : n;
        const long long hi = lo + 2 * w < n ? lo + 2 * w : n;
        const double key = ka[i];
        long long out;
        if (i < mid) {
          long long a = mid, z = hi;
          while (a < z) {
            const long long h = (a + z) >> 1;
            if (ka[h] < key) a = h + 1; else z = h;
          }
          out = i + (a - mid);
        } else {
          long long a = lo, z = mid;
          while (a < z) {
            const long long h = (a + z) >> 1;
            if (ka[h] <= key) a = h + 1; else z = h;
          }
          out = lo + (i - mid) + (a - lo);
        }
        kz[out] = key;
        iz[out] = ia[i];
      }
      __syncthreads();
      double* kt = ka; ka = kz; kz = kt;
      int* it = ia; ia = iz; iz = it;
    }
    // ia is the order; ka / kz (the keys) and iz are free
    double* c_g = ka;
    long long* p_g = reinterpret_cast<long long*>(kz);
    for (long long i = tid; i < n; i += kRowThreads) {
      const int o = ia[i];
      c_g[i] = bcost[o];
      p_g[i] = pods_c[o];
    }
    c_sorted = c_g;
    p_sorted = p_g;
    cum_p = cum_p_g;
    cum_c = cum_c_g;
    kept = iz;
    len = n;
  }
  __syncthreads();
  stamp(3);

  // -- 3c. sums: int64 scan for cum_p, the float64 chain to k_ub ----------
  block_incl_scan(p_sorted, cum_p, len, red);
  const long long k_ub = search_left(cum_p, len, residual);
  if (tid == 0) {
    double sc = 0.0;
    for (long long i = 0; i <= k_ub; ++i) {
      sc = sc + c_sorted[i];
      cum_c[i] = sc;
    }
    if (paths) paths[r] = prefix ? kPathPrefix : kPathFull;
  }
  __syncthreads();
  stamp(4);

  // -- 3d. greedy bound, LP bound per bundle, first keep -------------------
  // lp depends on a bundle only through rb = max(residual - pods, 0): up to
  // kLpTable it is tabled once per rb (the same ops on the same operands)
  const double ub = cum_c[k_ub];
  auto lp_of = [&](long long rbc) -> double {
    const double rb = static_cast<double>(rbc);
    const long long kk = search_left(cum_p, k_ub + 1, rbc);
    const double prev_p = kk > 0 ? static_cast<double>(cum_p[kk - 1]) : 0.0;
    const double prev_c = kk > 0 ? cum_c[kk - 1] : 0.0;
    const double q = c_sorted[kk] / static_cast<double>(p_sorted[kk]);
    const double l = prev_c + (rb - prev_p) * q;
    return rb <= 0.0 ? 0.0 : l;
  };
  const bool tabled = residual < kLpTable;
  if (tabled) {
    for (int rb = tid; rb <= residual; rb += kRowThreads) {
      lp_table[rb] = lp_of(rb);
    }
    __syncthreads();
  }
  const WarpSegment nseg(static_cast<int>(n));
  {
    const double ub_keep = ub * kKeepRel + kKeepAbs;
    long long kc = 0;
    for (int base = nseg.lo; base < nseg.hi; base += 32 * kBatch) {
      long long pods[kBatch];
      double costs[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u + lane;
        pods[u] = i < nseg.hi ? pods_c[i] : 0;
        costs[u] = i < nseg.hi ? bcost[i] : 0.0;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int i = base + 32 * u + lane;
        bool kf = false;
        if (i < nseg.hi) {
          const long long rbi = residual - pods[u];
          const long long rbc = rbi > 0 ? rbi : 0;
          const double l = tabled ? lp_table[rbc] : lp_of(rbc);
          lp[i] = l;
          kf = costs[u] + l <= ub_keep;
          kp[i] = kf;
        }
        kc += __popc(__ballot_sync(kFull, kf));
      }
    }
    if (lane == 0) wcount[warp] = kc;
  }
  __syncthreads();
  long long n_keep;
  warp_offset(wcount, &n_keep);
  stamp(5);

  // -- 4. core bound -------------------------------------------------------
  if (n_keep > kCoreTrigger) {
    long long K = k_ub + kCorePad > kCoreMin ? k_ub + kCorePad : kCoreMin;
    if (K > n) K = n;
    cover(SortedBundles{p_sorted, c_sorted, eff_g}, K, eff_res, nullptr);
    const double core_ub = (dp_smem ? row_s : row_g)[eff_res];
    if (core_ub < ub) {
      const double core_keep = core_ub * kKeepRel + kKeepAbs;
      long long kc = 0;
      for (int base = nseg.lo; base < nseg.hi; base += 32) {
        const int i = base + lane;
        bool kf = false;
        if (i < nseg.hi) {
          kf = bcost[i] + lp[i] <= core_keep;
          kp[i] = kf;
        }
        kc += __popc(__ballot_sync(kFull, kf));
      }
      if (lane == 0) wcount[warp] = kc;   // read before the DP's barriers
    }
    __syncthreads();
  }
  stamp(6);

  // -- 5. kept bundles in market order --------------------------------------
  long long kept_n;
  {
    long long pos = warp_offset(wcount, &kept_n);
    for (int base = nseg.lo; base < nseg.hi; base += 32) {
      const int i = base + lane;
      const bool kf = i < nseg.hi && kp[i] != 0;
      const unsigned mask = __ballot_sync(kFull, kf);
      if (kf) kept[pos + __popc(mask & lane_lt)] = i;
      pos += __popc(mask);
    }
  }
  __syncthreads();
  // staged for the decode DP and the backtrack: each kept bundle's pods in
  // DP units, cost, copies and item, in shared memory when they fit (the
  // prefix is done with), else in slabs that are done with
  const bool staged_in_smem = kept_n * kKeptBytes <= kWorkBytes;
  long long* k_pods = staged_in_smem ? reinterpret_cast<long long*>(work)
                                     : cum_p_g;
  double* k_cost = staged_in_smem
                       ? reinterpret_cast<double*>(work + kept_n * 8) : lp;
  long long* k_copies = staged_in_smem
                            ? reinterpret_cast<long long*>(work + kept_n * 16)
                            : reinterpret_cast<long long*>(key_alt);
  int* k_item = staged_in_smem ? reinterpret_cast<int*>(work + kept_n * 24)
                               : (kept == ibuf0 ? ibuf1 : ibuf0);
  for (long long i = tid; i < kept_n; i += kRowThreads) {
    const int kk = kept[i];
    const int b = bidx[kk];
    k_pods[i] = eff_g == 1 ? pods_c[kk] : pods_c[kk] / eff_g;
    k_cost[i] = bcost[kk];
    k_copies[i] = m.b_copies[b];
    k_item[i] = static_cast<int>(m.b_item[b]);
  }
  __syncthreads();
  stamp(7);

  // -- 6. decode DP with improvement bits ----------------------------------
  unsigned char* rbits = bits + r * B * width_cap;
  cover(KeptBundles{k_pods, k_cost}, kept_n, eff_res, rbits);
  stamp(8);

  // -- 7. backtrack and scatter onto sat (warp 0) ----------------------------
  // Between two taken bundles j stays put, so the next taken one is the
  // last i' < i with bits[i'][j] set: 32 of them are read at once.
  if (warp == 0) {
    const long long width = eff_res + 1;
    long long j = eff_res;
    long long i = kept_n - 1;
    while (i >= 0 && j > 0) {
      const long long at = i - lane;
      const bool t = at >= 0 && rbits[at * width + j] != 0;
      const unsigned mask = __ballot_sync(kFull, t);
      if (mask == 0) {
        i -= 32;
        continue;
      }
      const long long taken = i - (__ffs(mask) - 1);
      if (lane == 0) counts[k_item[taken]] += k_copies[taken];
      const long long nj = j - k_pods[taken];
      j = nj > 0 ? nj : 0;
      i = taken - 1;
    }
    if (lane == 0) feas_out[r] = kFeasible;
  }
  __syncthreads();
  stamp(9);
  return kFeasible;
}

__global__ void __launch_bounds__(kRowThreads)
fused_rows_kernel(Market m, const double* __restrict__ coefs,
                  const unsigned char* __restrict__ actives,
                  const long long* __restrict__ reqs,
                  const double* __restrict__ score_req, long long thr,
                  long long maxr, long long gcd, long long width_cap,
                  double* fscratch, int* iscratch, unsigned char* keep,
                  double* dp_global, unsigned char* bits,
                  long long* counts_out, unsigned char* feas_out,
                  double* score_out, int dp_smem, unsigned char* paths,
                  long long* stages) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  long long* st = stages ? stages + r * kStages : nullptr;
  if (st && tid == 0) st[0] = clock64();
  unsigned char* work = smem + ((dp_smem + 15) & ~15);
  const unsigned char status = solve_row(
      m, coefs, actives, reqs, thr, maxr, gcd, width_cap, fscratch,
      iscratch, keep, dp_global, bits, counts_out, feas_out, dp_smem, work,
      paths, st);

  // -- 8. pool score (golden rows) -----------------------------------------
  // status is uniform, so the score's barriers are; the work region is
  // free (the backtrack's last reads end at a barrier)
  if (score_out) {
    double e = -CUDART_INF;
    if (status == kFeasible) {
      __syncthreads();      // every thread's counts writes before the reads
      e = kubepacs::score_block<kRowThreads>(
          counts_out + r * m.n_items, m.perf, m.price, m.podsf, score_req[r],
          m.n_items, reinterpret_cast<double*>(work));
    }
    if (tid == 0) score_out[r] = e;
  }
  if (st && tid == 0) st[kStages - 1] = clock64();
}

}  // namespace

// Launches one CTA of 768 threads per row on `stream`. Scratch, owned by
// the caller: `fscratch` n_rows * 7 * B doubles, `iscratch` n_rows * 3 * B
// ints, `keep` n_rows * B bytes, `bits` n_rows * B * width_cap bytes, and
// `dp_global` n_rows * 2 * width_cap doubles unless `dp_smem` is not 0
// (then it is width_cap * 8, the rows sit in dynamic shared memory and it
// may be null). `smem_total` is the dynamic shared memory of a CTA, the dp
// row (16-byte aligned), the work region and the LP table
// (core/fused_rows.py rows_smem). `score_req` and `score_out` (n_rows
// float64 each; the market's perf, price, podsf are then read) ask for the
// pool score of each row. Optional outputs (null to skip): `paths` one
// byte a row (0 no prune, 1 prefix path, 2 full path), `stages` kStages
// clock64 stamps a row. Returns the CUDA error code of the launch (0 on
// success); cudaErrorInvalidValue when the sizes disagree with the
// kernel's regions.
extern "C" int fused_rows_launch(
    const long long* pods, const long long* bound, const double* perf,
    const double* price, const double* podsf, const long long* b_item,
    const long long* b_pods, const long long* b_copies, long long n_items,
    long long n_bundles, const double* coefs, const unsigned char* actives,
    const long long* reqs, const double* score_req, long long thr,
    long long maxr, long long gcd, long long width_cap, double* fscratch,
    int* iscratch, unsigned char* keep, double* dp_global,
    unsigned char* bits, long long* counts_out, unsigned char* feas_out,
    double* score_out, int n_rows, int dp_smem, int smem_total,
    void* stream, unsigned char* paths, long long* stages) {
  if (n_rows <= 0) return 0;
  const bool rows_fit = dp_smem == 0 || (width_cap * 8 <= dp_smem &&
                                         width_cap * 8 <= kLpTableBytes);
  if (!rows_fit || (score_out && !score_req) ||
      smem_total != ((dp_smem + 15) & ~15) + kWorkBytes + kLpTableBytes) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      fused_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Market m{pods,   bound,    perf,    price,   podsf,
                 b_item, b_pods,   b_copies, n_items, n_bundles};
  fused_rows_kernel<<<n_rows, kRowThreads, smem_total,
                      static_cast<cudaStream_t>(stream)>>>(
      m, coefs, actives, reqs, score_req, thr, maxr, gcd, width_cap,
      fscratch, iscratch, keep, dp_global, bits, counts_out, feas_out,
      score_out, dp_smem, paths, stages);
  return static_cast<int>(cudaGetLastError());
}
