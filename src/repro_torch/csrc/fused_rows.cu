// fused_rows: the fused plane's row solver, one CTA per (decision, alpha)
// row (sm_90a).
//
// Replaces the device row solver of FusedJaxBackend._solver_core
// (src/repro/core/backend.py: prep's consumers solve_row / solve_rows) and,
// inside it, the two calls of the TPU kernel _cover_kernel (the core-bound
// DP and the decode DP), which here are cover_dp_block of cover_dp.cuh.
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
//      cum_c, the greedy bound ub = cum_c[searchsorted(cum_p, residual)],
//      lp per bundle and keep = bcost + lp <= ub * (1 + 1e-12) + 1e-9;
//   4. when more than 160 bundles are kept, the core bound: a values-only
//      cover DP over the first K rate-ordered bundles at eff_res, and the
//      keep test again with it when it is tighter;
//   5. the kept bundles in market order;
//   6. the decode DP with improvement bits over them at eff_res;
//   7. the backtrack (one thread) adding each taken bundle's copies to sat.
// The DP runs at width eff_res + 1, as the host engine does: the
// reference's tier ladder and shape buckets exist only for XLA's static
// shapes.
//
// Where bitwise parity with the host could break, and what this does:
//   * FMA contraction: bcost, lp, the keep thresholds are products feeding
//     adds or compares; the library is built with --fmad=false.
//   * sequential sums: cum_c is a strict left-to-right chain, run by one
//     thread (cum_p, integer-valued, rides the same loop).
//   * stable order with ties (+inf never occurs here: only finite bundles
//     are compacted in; -0.0 vs 0.0 does): a merge sort that compares with
//     < and <=, so -0.0 == 0.0 and equal keys keep index order.
//   * clamped gathers: every searchsorted index is clamped to the row's
//     last bundle, as JAX clamps; no read leaves the row.
//   * searchsorted is side-left on float64, rb taken in market order.
//   * parallel blocks: no dp row, bracket or counter crosses CTAs.
//
// What bounds it on an H100: the chains, not bytes or flops. Per row the
// sort is log2(n) dependent passes, the cumulative sums one serial chain of
// n adds, and each DP a chain of bundle steps ending in barriers; a row's
// inputs are N coefficients and flags, its output N counts. Rows are
// independent, so a launch fills the SMs with as many rows as the caller
// stacks (a prescan is D x G rows, a golden round D).

#include "cover_dp.cuh"

namespace {

using kubepacs::kThreads;
constexpr int kWarps = kThreads / 32;

// the host engine's prune constants (repro_torch.core.backend)
constexpr long long kCoreTrigger = 160;
constexpr long long kCorePad = 33;
constexpr long long kCoreMin = 96;
constexpr double kKeepRel = 1.0 + 1e-12;
constexpr double kKeepAbs = 1e-9;

// row status codes (the `feas` output)
constexpr unsigned char kInfeasible = 0;
constexpr unsigned char kFeasible = 1;
constexpr unsigned char kTooWide = 2;   // eff_res + 1 > width_cap: not solved

struct Market {
  const long long* pods;      // (N,)
  const long long* bound;     // (N,)
  const long long* b_item;    // (B,)
  const long long* b_pods;    // (B,)
  const long long* b_copies;  // (B,)
  long long n_items;
  long long n_bundles;
};

// The rate-ordered DP bundles: the core DP's input.
struct SortedBundles {
  const int* ord;
  const int* bidx;
  const long long* b_pods;
  const double* c_sorted;
  long long eff_g;
  __device__ long long pods(long long i) const {
    return b_pods[bidx[ord[i]]] / eff_g;
  }
  __device__ double cost(long long i) const { return c_sorted[i]; }
};

// The kept bundles in market order: the decode DP's input.
struct KeptBundles {
  const int* kept;
  const int* bidx;
  const long long* b_pods;
  const double* bcost;
  long long eff_g;
  __device__ long long pods(long long i) const {
    return b_pods[bidx[kept[i]]] / eff_g;
  }
  __device__ double cost(long long i) const { return bcost[kept[i]]; }
};

// Sum of v over the CTA, returned to every thread.
__device__ long long block_sum(long long v, long long* red) {
  for (int o = 16; o >= 1; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < kWarps; ++w) total += red[w];
  __syncthreads();
  return total;
}

// Exclusive prefix count of `flag` over the CTA in thread order; `*total`
// gets the CTA's count. Every thread must call it.
__device__ int block_scan(bool flag, int* warp_counts, int* total) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const unsigned mask = __ballot_sync(0xffffffffu, flag);
  const int in_warp = __popc(mask & ((1u << lane) - 1u));
  if (lane == 0) warp_counts[warp] = __popc(mask);
  __syncthreads();
  int before = 0, sum = 0;
  for (int w = 0; w < kWarps; ++w) {
    const int c = warp_counts[w];
    if (w < warp) before += c;
    sum += c;
  }
  __syncthreads();
  *total = sum;
  return before + in_warp;
}

// First index in sorted v[0:n) with v[i] >= x (numpy's side-left
// searchsorted), clamped to n - 1 as JAX clamps a gather.
__device__ long long search_left(const double* v, long long n, double x) {
  long long lo = 0, hi = n;
  while (lo < hi) {
    const long long mid = (lo + hi) >> 1;
    if (v[mid] < x) lo = mid + 1; else hi = mid;
  }
  return lo < n ? lo : n - 1;
}

__global__ void __launch_bounds__(kThreads)
fused_rows_kernel(Market m, const double* __restrict__ coefs,
                  const unsigned char* __restrict__ actives,
                  const long long* __restrict__ reqs, long long thr,
                  long long maxr, long long gcd, long long width_cap,
                  double* fscratch, int* iscratch, unsigned char* keep,
                  double* dp_global, unsigned char* bits,
                  long long* counts_out, unsigned char* feas_out,
                  int smem_bytes) {
  extern __shared__ double smem_row[];
  __shared__ long long red[kWarps];
  __shared__ int warp_counts[kWarps];

  const long long r = blockIdx.x;
  const int tid = threadIdx.x;
  const long long N = m.n_items, B = m.n_bundles;
  const double* coef = coefs + r * N;
  const unsigned char* active = actives + r * N;
  long long* counts = counts_out + r * N;

  // -- 1. saturation ------------------------------------------------------
  long long cov = 0, cap = 0;
  for (long long i = tid; i < N; i += kThreads) {
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
  if (residual == 0) {
    if (tid == 0) feas_out[r] = kFeasible;
    return;
  }
  if (capacity < residual) {
    if (tid == 0) feas_out[r] = kInfeasible;
    return;
  }

  // -- 2. coarsening mode -------------------------------------------------
  const long long rs_g = (residual + gcd - 1) / gcd;
  const bool use_g = residual > thr && gcd > 1 && rs_g <= maxr;
  const long long eff_g = use_g ? gcd : 1;
  const long long eff_res = (residual + eff_g - 1) / eff_g;
  if (eff_res + 1 > width_cap) {
    if (tid == 0) feas_out[r] = kTooWide;
    return;
  }

  // per-row scratch: six B-long double slabs, three B-long int slabs
  double* f = fscratch + r * 6 * B;
  double* bcost = f;
  double* kbuf[2] = {f + B, f + 2 * B};
  double* cum_p = f + 3 * B;
  double* cum_c = f + 4 * B;
  double* lp = f + 5 * B;
  int* ip = iscratch + r * 3 * B;
  int* bidx = ip;
  int* ibuf[2] = {ip + B, ip + 2 * B};
  unsigned char* kp = keep + r * B;
  const bool in_smem = width_cap * 8 <= smem_bytes;
  double* row = in_smem ? smem_row : dp_global + r * width_cap;

  // -- 3a. the row's DP bundles, compacted in market order ----------------
  long long n = 0;
  for (long long base = 0; base < B; base += kThreads) {
    const long long b = base + tid;
    bool in_dp = false;
    if (b < B) {
      const long long it = m.b_item[b];
      in_dp = active[it] != 0 && !(coef[it] < 0.0);
    }
    int total;
    const int pos = block_scan(in_dp, warp_counts, &total);
    if (in_dp) {
      const long long k = n + pos;
      const long long it = m.b_item[b];
      const double c = coef[it] * static_cast<double>(m.b_copies[b]);
      bidx[k] = static_cast<int>(b);
      bcost[k] = c;
      kbuf[0][k] = c / static_cast<double>(m.b_pods[b]);
      ibuf[0][k] = static_cast<int>(k);
    }
    n += total;
  }
  __syncthreads();

  // -- 3b. stable rate order: bottom-up merge sort of (rate, index) -------
  // An element of a left run lands after the right run's strictly smaller
  // keys; one of a right run after the left run's smaller-or-equal keys:
  // stable, and -0.0 ties 0.0.
  int cur = 0;
  for (long long w = 1; w < n; w <<= 1) {
    const double* ka = kbuf[cur];
    const int* ia = ibuf[cur];
    double* kb = kbuf[cur ^ 1];
    int* ib = ibuf[cur ^ 1];
    for (long long i = tid; i < n; i += kThreads) {
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
      kb[out] = key;
      ib[out] = ia[i];
    }
    __syncthreads();
    cur ^= 1;
  }
  const int* ord = ibuf[cur];
  int* kept = ibuf[cur ^ 1];
  double* c_sorted = kbuf[0];     // the sorted rates are no longer needed
  double* p_sorted = kbuf[1];
  for (long long i = tid; i < n; i += kThreads) {
    const int o = ord[i];
    c_sorted[i] = bcost[o];
    p_sorted[i] = static_cast<double>(m.b_pods[bidx[o]]);
  }
  __syncthreads();

  // -- 3c. sequential sums, one thread (np.cumsum order) -------------------
  if (tid == 0) {
    double sp = 0.0, sc = 0.0;
    for (long long i = 0; i < n; ++i) {
      sp = sp + p_sorted[i];
      sc = sc + c_sorted[i];
      cum_p[i] = sp;
      cum_c[i] = sc;
    }
  }
  __syncthreads();

  // -- 3d. greedy bound, LP bound per bundle, first keep -------------------
  const long long k_ub = search_left(cum_p, n, static_cast<double>(residual));
  const double ub = cum_c[k_ub];
  long long kc = 0;
  for (long long i = tid; i < n; i += kThreads) {
    const long long rbi = residual - m.b_pods[bidx[i]];
    const double rb = static_cast<double>(rbi > 0 ? rbi : 0);
    const long long kk = search_left(cum_p, n, rb);
    const double prev_p = kk > 0 ? cum_p[kk - 1] : 0.0;
    const double prev_c = kk > 0 ? cum_c[kk - 1] : 0.0;
    const double q = c_sorted[kk] / p_sorted[kk];
    double l = prev_c + (rb - prev_p) * q;
    if (rb <= 0.0) l = 0.0;
    lp[i] = l;
    const bool k = bcost[i] + l <= ub * kKeepRel + kKeepAbs;
    kp[i] = k;
    kc += k;
  }
  const long long n_keep = block_sum(kc, red);

  // -- 4. core bound -------------------------------------------------------
  if (n_keep > kCoreTrigger) {
    long long K = k_ub + kCorePad > kCoreMin ? k_ub + kCorePad : kCoreMin;
    if (K > n) K = n;
    kubepacs::cover_dp_block(SortedBundles{ord, bidx, m.b_pods, c_sorted,
                                           eff_g},
                             K, eff_res, row, nullptr);
    const double core_ub = row[eff_res];
    if (core_ub < ub) {
      for (long long i = tid; i < n; i += kThreads) {
        kp[i] = bcost[i] + lp[i] <= core_ub * kKeepRel + kKeepAbs;
      }
    }
    __syncthreads();
  }

  // -- 5. kept bundles in market order --------------------------------------
  long long kept_n = 0;
  for (long long base = 0; base < n; base += kThreads) {
    const long long i = base + tid;
    const bool k = i < n && kp[i] != 0;
    int total;
    const int pos = block_scan(k, warp_counts, &total);
    if (k) kept[kept_n + pos] = static_cast<int>(i);
    kept_n += total;
  }
  __syncthreads();

  // -- 6. decode DP with improvement bits ----------------------------------
  unsigned char* rbits = bits + r * B * width_cap;
  const KeptBundles kept_bundles{kept, bidx, m.b_pods, bcost, eff_g};
  kubepacs::cover_dp_block(kept_bundles, kept_n, eff_res, row, rbits);

  // -- 7. backtrack and scatter onto sat ------------------------------------
  if (tid == 0) {
    const long long width = eff_res + 1;
    long long j = eff_res;
    for (long long i = kept_n - 1; i >= 0 && j > 0; --i) {
      if (rbits[i * width + j]) {
        const long long b = bidx[kept[i]];
        counts[m.b_item[b]] += m.b_copies[b];
        const long long nj = j - kept_bundles.pods(i);
        j = nj > 0 ? nj : 0;
      }
    }
    feas_out[r] = kFeasible;
  }
}

}  // namespace

// Launches one CTA per row on `stream`. Scratch, owned by the caller:
// `fscratch` n_rows * 6 * B doubles, `iscratch` n_rows * 3 * B ints,
// `keep` n_rows * B bytes, `bits` n_rows * B * width_cap bytes, and
// `dp_global` n_rows * width_cap doubles unless width_cap * 8 <= smem_bytes
// (then the dp row sits in dynamic shared memory and it may be null).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int fused_rows_launch(
    const long long* pods, const long long* bound, const long long* b_item,
    const long long* b_pods, const long long* b_copies, long long n_items,
    long long n_bundles, const double* coefs, const unsigned char* actives,
    const long long* reqs, long long thr, long long maxr, long long gcd,
    long long width_cap, double* fscratch, int* iscratch,
    unsigned char* keep, double* dp_global, unsigned char* bits,
    long long* counts_out, unsigned char* feas_out, int n_rows,
    int smem_bytes, void* stream) {
  if (n_rows <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      fused_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Market m{pods, bound, b_item, b_pods, b_copies, n_items, n_bundles};
  fused_rows_kernel<<<n_rows, kThreads, smem_bytes,
                      static_cast<cudaStream_t>(stream)>>>(
      m, coefs, actives, reqs, thr, maxr, gcd, width_cap, fscratch, iscratch,
      keep, dp_global, bits, counts_out, feas_out, smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
