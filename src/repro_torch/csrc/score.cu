// score: the fused plane's speculative pool score, one CTA per decision
// (sm_90a).
//
// Replaces the TPU kernel _score_kernel in FusedJaxBackend._solver_core
// (src/repro/core/backend.py). Per decision d, in float64:
//     sp = sum_i c[d,i] * perf[i],  sc = sum_i c[d,i] * price[i],
//     sq = sum_i c[d,i] * pods[i]
//     E  = (sp / sc) * (req[d] / sq)  if sq >= req[d] and sc > 0 and sq > 0
//          else 0
// The score only steers the golden bracket on the card; the host rescores
// every pool exactly, so a score that differs from the host's in the last
// bit can cost a counted fallback solve, never a selection.
//
// Summation order, fixed so that score_plain reproduces it bitwise: thread
// t of kThreads adds the products of columns t, t + kThreads, ... left to
// right (columns past N add 0.0 * 0.0), then the kThreads partial sums are
// folded pairwise, partial[t] += partial[t + s] for s = kThreads/2 .. 1.
// Built with --fmad=false: each product is rounded before its add.
//
// What bounds it on an H100: bytes. Each decision reads N counts (int64) and
// the three N-long market vectors (shared by every decision, so L2-resident)
// and writes one double; 4 flops a column. With D of 1-32 decisions the
// launch is latency, not bandwidth: one CTA per decision keeps the whole
// reduction inside the CTA with no second pass and no atomics.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
score_kernel(const long long* __restrict__ counts,
             const double* __restrict__ perf,
             const double* __restrict__ price,
             const double* __restrict__ pods,
             const double* __restrict__ req,
             double* __restrict__ out, long long n) {
  __shared__ double s_sp[kThreads];
  __shared__ double s_sc[kThreads];
  __shared__ double s_sq[kThreads];
  const int d = blockIdx.x;
  const int t = threadIdx.x;
  const long long* c = counts + static_cast<long long>(d) * n;
  double sp = 0.0, sc = 0.0, sq = 0.0;
  for (long long k = 0; k < n; k += kThreads) {
    const long long j = k + t;
    const bool in = j < n;
    const double cj = in ? static_cast<double>(c[j]) : 0.0;
    sp = sp + cj * (in ? perf[j] : 0.0);
    sc = sc + cj * (in ? price[j] : 0.0);
    sq = sq + cj * (in ? pods[j] : 0.0);
  }
  s_sp[t] = sp;
  s_sc[t] = sc;
  s_sq[t] = sq;
  __syncthreads();
  for (int s = kThreads / 2; s >= 1; s >>= 1) {
    if (t < s) {
      s_sp[t] = s_sp[t] + s_sp[t + s];
      s_sc[t] = s_sc[t] + s_sc[t + s];
      s_sq[t] = s_sq[t] + s_sq[t + s];
    }
    __syncthreads();
  }
  if (t == 0) {
    const double tsp = s_sp[0], tsc = s_sc[0], tsq = s_sq[0];
    const double rq = req[d];
    const bool ok = (tsq >= rq) && (tsc > 0.0) && (tsq > 0.0);
    out[d] = ok ? (tsp / tsc) * (rq / tsq) : 0.0;
  }
}

}  // namespace

// Launches one CTA per decision on `stream`. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int score_launch(const long long* counts, const double* perf,
                            const double* price, const double* pods,
                            const double* req, double* out, int n_decisions,
                            long long n_items, void* stream) {
  if (n_decisions <= 0) return 0;
  score_kernel<<<n_decisions, kThreads, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      counts, perf, price, pods, req, out, n_items);
  return static_cast<int>(cudaGetLastError());
}
