// cover_dp: the min-plus cover DP with improvement bits, for a ragged stack
// of groups, one CTA per group (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/core/backend.py):
//   * relax_kernel in JaxBackend._step_fn: one relaxation step of G stacked
//     groups, launched once per bundle by lax.scan;
//   * _cover_kernel in FusedJaxBackend._pallas_cover_fn: the whole forward DP
//     of one row, with the dp row carried across sequential grid steps.
// Both compute, per group (bpods, costs, T), in float64:
//     dp[0] = 0, dp[j>0] = +inf
//     for b in bundle order:
//         cand[j]    = dp[j - pb] + cb  (j >= pb),  cb  (1 <= j < pb)
//         bits[b, j] = cand[j] < dp[j]              (bits[b, 0] = 0)
//         dp[j]      = min(dp[j], cand[j])          (dp[0] stays 0)
// with a non-finite cb leaving dp untouched and writing a zero bits row.
// dp and bits are bitwise the host reference (NumpyBackend._one/_values):
// the kernel only adds, compares and selects, in the host's order.
//
// What bounds it on an H100: not bytes. The bits are B*(T+1) bytes a group
// and dp is read and written in shared memory, but the B bundles of a group
// are a chain of dependent steps, each ending in a CTA-wide barrier, so a
// group costs B * (tiles + 1) barriers however wide the card is. The design
// answers that the way the host loop cannot be answered on the TPU:
//   * one CTA owns one group and runs its bundle loop inside the CTA; the
//     Pallas accumulator idiom (dp carried across grid steps) would race
//     here, since blocks run concurrently;
//   * the dp row lives in dynamic shared memory when (T+1)*8 bytes fit the
//     launch's allocation, else in the group's own slice of the dp output in
//     global memory (L2-resident at these sizes);
//   * the row is updated in place, in descending tiles of THREADS*PER_THREAD
//     columns: a tile reads its candidates into registers, then one barrier,
//     then writes. pb >= 1, so dp[j - pb] lies below the tile's writes and
//     above nothing a later tile of the same bundle writes before reading;
//     one barrier per tile plus one per bundle keeps the update exact;
//   * groups are independent, so a launch fills the SMs with as many groups
//     as the caller stacks (the engine stacks every plan of a round).
// Built with --fmad=false: this kernel has no products, but kernels that
// join this file later will, and contraction breaks host parity there.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 512;
constexpr int PER_THREAD = 4;
constexpr long long TILE = static_cast<long long>(THREADS) * PER_THREAD;

__global__ void __launch_bounds__(THREADS)
cover_dp_kernel(const long long* __restrict__ pods,
                const double* __restrict__ costs,
                const long long* __restrict__ b_off,
                const long long* __restrict__ targets,
                const long long* __restrict__ dp_off,
                const long long* __restrict__ bits_off,
                double* __restrict__ dp_out,
                unsigned char* __restrict__ bits_out,
                int smem_bytes) {
  extern __shared__ double smem_row[];
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const long long T = targets[g];
  const long long width = T + 1;
  const long long b0 = b_off[g];
  const long long nb = b_off[g + 1] - b0;
  double* gl_row = dp_out + dp_off[g];
  const bool in_smem = width * 8 <= smem_bytes;
  double* row = in_smem ? smem_row : gl_row;
  unsigned char* bits = bits_out ? bits_out + bits_off[g] : nullptr;

  for (long long j = tid; j < width; j += THREADS) {
    row[j] = j == 0 ? 0.0 : CUDART_INF;
  }
  __syncthreads();

  for (long long b = 0; b < nb; ++b) {
    const double cb = costs[b0 + b];
    unsigned char* brow = bits ? bits + b * width : nullptr;
    if (!isfinite(cb)) {             // uniform across the CTA: no barrier
      if (brow) {
        for (long long j = tid; j < width; j += THREADS) brow[j] = 0;
      }
      continue;
    }
    const long long pb = pods[b0 + b];
    for (long long hi = T; hi >= 1; hi -= TILE) {
      double next[PER_THREAD];
#pragma unroll
      for (int k = 0; k < PER_THREAD; ++k) {
        const long long j = hi - static_cast<long long>(k) * THREADS - tid;
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
      for (int k = 0; k < PER_THREAD; ++k) {
        const long long j = hi - static_cast<long long>(k) * THREADS - tid;
        if (j >= 1) row[j] = next[k];
      }
    }
    if (brow && tid == 0) brow[0] = 0;
    __syncthreads();
  }

  if (in_smem) {
    for (long long j = tid; j < width; j += THREADS) gl_row[j] = row[j];
  }
}

}  // namespace

// Launches one CTA per group on `stream`. `bits_out` may be null (values
// only). `smem_bytes` is the dynamic shared memory of every CTA; a group
// whose row does not fit runs in its slice of `dp_out`. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int cover_dp_launch(const long long* pods, const double* costs,
                               const long long* b_off,
                               const long long* targets,
                               const long long* dp_off,
                               const long long* bits_off, double* dp_out,
                               unsigned char* bits_out, int n_groups,
                               int smem_bytes, void* stream) {
  if (n_groups <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      cover_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cover_dp_kernel<<<n_groups, THREADS, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      pods, costs, b_off, targets, dp_off, bits_off, dp_out, bits_out,
      smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
