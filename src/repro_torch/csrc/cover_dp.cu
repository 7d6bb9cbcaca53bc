// cover_dp: the min-plus cover DP with improvement bits, for a ragged stack
// of groups, one CTA per group (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/core/backend.py):
//   * relax_kernel in JaxBackend._step_fn: one relaxation step of G stacked
//     groups, launched once per bundle by lax.scan;
//   * _cover_kernel in FusedJaxBackend._pallas_cover_fn: the whole forward DP
//     of one row, with the dp row carried across sequential grid steps.
// The recurrence, and the in-place tiled update that keeps it exact, live in
// cover_dp.cuh (cover_dp_block), which fused_rows.cu calls too.
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
//   * groups are independent, so a launch fills the SMs with as many groups
//     as the caller stacks (the engine stacks every plan of a round).
// Built with --fmad=false, as every source of the library is: this kernel
// has no products, but fused_rows.cu and score.cu do, and contraction
// breaks host parity there.

#include "cover_dp.cuh"

namespace {

using kubepacs::kThreads;

struct FlatBundles {
  const long long* p;
  const double* c;
  __device__ long long pods(long long b) const { return p[b]; }
  __device__ double cost(long long b) const { return c[b]; }
};

__global__ void __launch_bounds__(kThreads)
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
  double* gl_row = dp_out + dp_off[g];
  const bool in_smem = width * 8 <= smem_bytes;
  double* row = in_smem ? smem_row : gl_row;

  kubepacs::cover_dp_block(FlatBundles{pods + b0, costs + b0},
                           b_off[g + 1] - b0, T, row,
                           bits_out ? bits_out + bits_off[g] : nullptr);

  if (in_smem) {
    for (long long j = tid; j < width; j += kThreads) gl_row[j] = row[j];
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
  cover_dp_kernel<<<n_groups, kThreads, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      pods, costs, b_off, targets, dp_off, bits_off, dp_out, bits_out,
      smem_bytes);
  return static_cast<int>(cudaGetLastError());
}
