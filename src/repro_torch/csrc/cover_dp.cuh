// The min-plus cover DP with improvement bits, run by one CTA over one
// group: the one definition shared by cover_dp.cu (a ragged stack of groups)
// and fused_rows.cu (the core-bound and decode DPs of a fused row).
//
// For a group of nb bundles (pods pb >= 1, cost cb) and target T, in float64:
//     dp[0] = 0, dp[j>0] = +inf
//     for b in bundle order:
//         cand[j]    = dp[j - pb] + cb  (j >= pb),  cb  (1 <= j < pb)
//         bits[b, j] = cand[j] < dp[j]              (bits[b, 0] = 0)
//         dp[j]      = min(dp[j], cand[j])          (dp[0] stays 0)
// with a non-finite cb leaving dp untouched and writing a zero bits row.
// dp and bits are bitwise the host reference (NumpyBackend._one/_values):
// only adds, compares and selects, in the host's order.
//
// The row is updated in place, in descending tiles of kThreads*kPerThread
// columns: a tile reads its candidates into registers, then one barrier,
// then writes. pb >= 1, so dp[j - pb] lies below the tile's writes and
// above nothing a later tile of the same bundle writes before reading; one
// barrier per tile plus one per bundle keeps the update exact.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace kubepacs {

constexpr int kThreads = 512;
constexpr int kPerThread = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kPerThread;

// Runs the DP with the whole calling CTA (blockDim.x == kThreads; every
// thread must call it). `bundles.pods(b)` and `bundles.cost(b)` give bundle
// b; `row` holds T + 1 doubles (shared or global memory) and ends as dp;
// `bits`, when not null, receives nb rows of T + 1 bytes. Ends with a
// barrier, so every thread may read `row` and `bits` on return.
template <class Bundles>
__device__ void cover_dp_block(const Bundles& bundles, long long nb,
                               long long T, double* row,
                               unsigned char* bits) {
  const int tid = threadIdx.x;
  const long long width = T + 1;
  for (long long j = tid; j < width; j += kThreads) {
    row[j] = j == 0 ? 0.0 : CUDART_INF;
  }
  __syncthreads();

  for (long long b = 0; b < nb; ++b) {
    const double cb = bundles.cost(b);
    unsigned char* brow = bits ? bits + b * width : nullptr;
    if (!isfinite(cb)) {             // uniform across the CTA: no barrier
      if (brow) {
        for (long long j = tid; j < width; j += kThreads) brow[j] = 0;
      }
      continue;
    }
    const long long pb = bundles.pods(b);
    for (long long hi = T; hi >= 1; hi -= kTile) {
      double next[kPerThread];
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const long long j = hi - static_cast<long long>(k) * kThreads - tid;
        if (j >= 1) {
          const double d = row[j];
          const double c = j >= pb ? row[j - pb] + cb : cb;
          const bool take = c < d;
          next[k] = take ? c : d;
          if (brow) brow[j] = take;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const long long j = hi - static_cast<long long>(k) * kThreads - tid;
        if (j >= 1) row[j] = next[k];
      }
    }
    if (brow && tid == 0) brow[0] = 0;
    __syncthreads();
  }
  __syncthreads();   // the bits rows of trailing non-finite bundles
}

}  // namespace kubepacs
