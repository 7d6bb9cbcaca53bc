// The fused plane's speculative pool score of one counts row, run by one
// CTA: the one definition shared by score.cu (one CTA per decision) and the
// tail of fused_rows.cu (each golden row scores its own counts).
//
// Per row, in float64:
//     sp = sum_i c[i] * perf[i],  sc = sum_i c[i] * price[i],
//     sq = sum_i c[i] * pods[i]
//     E  = (sp / sc) * (req / sq)  if sq >= req and sc > 0 and sq > 0
//          else 0
// Summation order, fixed so that score_plain reproduces it bitwise, for
// any CTA width: thread t of the first kScoreLanes adds the products of
// columns t, t + kScoreLanes, ... left to right (columns past N add
// 0.0 * 0.0), then the partial sums fold pairwise, p[t] = p[t] + p[t + s]
// for s = kScoreLanes/2 .. 1: s = 128 and 64 through shared memory, s = 32
// as warp 0 reads both halves, s = 16 .. 1 by warp shuffles, each the same
// add. Built with --fmad=false: each product is rounded before its add.

#pragma once

#include <cuda_runtime.h>

namespace kubepacs {

constexpr int kScoreLanes = 256;
constexpr unsigned kScoreMask = 0xffffffffu;

// Every thread of the CTA (blockDim.x == Threads >= kScoreLanes) must call
// it; `red` is 3 * kScoreLanes doubles of shared memory, free on entry.
// `c` is not restrict: fused_rows.cu scores counts its CTA has just
// written, which the read-only cache path would not see.
// Returns E to thread 0 (other threads get an unspecified value); ends
// with no barrier, after the last one that reads `red`.
template <int Threads>
__device__ double score_block(const long long* c,
                              const double* __restrict__ perf,
                              const double* __restrict__ price,
                              const double* __restrict__ pods, double req,
                              long long n, double* red) {
  static_assert(Threads >= kScoreLanes, "a partial sum per lane");
  const int t = threadIdx.x;
  double* r_sp = red;
  double* r_sc = red + kScoreLanes;
  double* r_sq = red + 2 * kScoreLanes;
  if (t < kScoreLanes) {
    double sp = 0.0, sc = 0.0, sq = 0.0;
    for (long long k = 0; k < n; k += kScoreLanes) {
      const long long j = k + t;
      const bool in = j < n;
      const double cj = in ? static_cast<double>(c[j]) : 0.0;
      sp = sp + cj * (in ? perf[j] : 0.0);
      sc = sc + cj * (in ? price[j] : 0.0);
      sq = sq + cj * (in ? pods[j] : 0.0);
    }
    r_sp[t] = sp;
    r_sc[t] = sc;
    r_sq[t] = sq;
  }
  __syncthreads();
#pragma unroll
  for (int s = kScoreLanes / 2; s >= 64; s >>= 1) {
    if (t < s) {
      r_sp[t] = r_sp[t] + r_sp[t + s];
      r_sc[t] = r_sc[t] + r_sc[t + s];
      r_sq[t] = r_sq[t] + r_sq[t + s];
    }
    __syncthreads();
  }
  double e = 0.0;
  if (t < 32) {
    double sp = r_sp[t] + r_sp[t + 32];
    double sc = r_sc[t] + r_sc[t + 32];
    double sq = r_sq[t] + r_sq[t + 32];
#pragma unroll
    for (int s = 16; s >= 1; s >>= 1) {
      sp = sp + __shfl_down_sync(kScoreMask, sp, s);
      sc = sc + __shfl_down_sync(kScoreMask, sc, s);
      sq = sq + __shfl_down_sync(kScoreMask, sq, s);
    }
    const bool ok = (sq >= req) && (sc > 0.0) && (sq > 0.0);
    e = ok ? (sp / sc) * (req / sq) : 0.0;
  }
  return e;
}

}  // namespace kubepacs
