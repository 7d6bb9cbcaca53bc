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
// The summation order (fixed, so that score_plain reproduces it bitwise)
// and the block that computes the score live in score.cuh (score_block),
// which the golden rows of fused_rows.cu run in their own tail too: the
// fused plane's golden loop launches no score of its own.
//
// What bounds it on an H100: bytes. Each decision reads N counts (int64) and
// the three N-long market vectors (shared by every decision, so L2-resident)
// and writes one double; 4 flops a column. With D of 1-32 decisions the
// launch is latency, not bandwidth: one CTA per decision keeps the whole
// reduction inside the CTA with no second pass and no atomics.

#include <cuda_runtime.h>

#include "score.cuh"

namespace {

constexpr int kThreads = kubepacs::kScoreLanes;

__global__ void __launch_bounds__(kThreads)
score_kernel(const long long* __restrict__ counts,
             const double* __restrict__ perf,
             const double* __restrict__ price,
             const double* __restrict__ pods,
             const double* __restrict__ req,
             double* __restrict__ out, long long n) {
  __shared__ double red[3 * kubepacs::kScoreLanes];
  const int d = blockIdx.x;
  const double e = kubepacs::score_block<kThreads>(
      counts + static_cast<long long>(d) * n, perf, price, pods, req[d], n,
      red);
  if (threadIdx.x == 0) out[d] = e;
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
