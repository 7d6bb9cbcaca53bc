// cover_dp: the min-plus cover DP with improvement bits, for a ragged stack
// of groups, one CTA per group (sm_90a).
//
// Replaces two TPU kernels of the JAX package (src/repro/core/backend.py):
//   * relax_kernel in JaxBackend._step_fn: one relaxation step of G stacked
//     groups, launched once per bundle by lax.scan;
//   * _cover_kernel in FusedJaxBackend._pallas_cover_fn: the whole forward DP
//     of one row, with the dp row carried across sequential grid steps.
// The recurrence, and the two-row update that keeps it exact, live in
// cover_dp.cuh (cover_dp_block), which fused_rows.cu calls too.
//
// What bounds it on an H100: not bytes. The bits are B*(T+1) bytes a group
// and dp is read and written in shared memory, but the B bundles of a group
// are a chain of dependent steps, each ending in a CTA-wide barrier, so a
// group costs B steps of latency however wide the card is. The design
// answers that the way the host loop cannot be answered on the TPU:
//   * one CTA owns one group and runs its bundle loop inside the CTA; the
//     Pallas accumulator idiom (dp carried across grid steps) would race
//     here, since blocks run concurrently;
//   * a step is one pass of reads of the old dp row, writes of the new one
//     and one barrier (two rows, ping-pong), over columns a thread keeps in
//     registers, and its bundle comes from shared memory, where the CTA
//     stages the group's bundles a chunk ahead, off the chain;
//   * both dp rows live in dynamic shared memory when 2*(T+1)*8 bytes fit
//     (T <= 8192; the wrapper decides, core/cover_dp.py two_rows_smem),
//     else the group's slice of the dp output and a scratch row in global
//     memory (L2-resident at these sizes) take their place;
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
                const long long* __restrict__ scr_off,
                double* __restrict__ dp_out, double* __restrict__ scratch,
                unsigned char* __restrict__ bits_out) {
  extern __shared__ double smem_rows[];
  __shared__ kubepacs::Stage stage;
  const int g = blockIdx.x;
  const int tid = threadIdx.x;
  const long long T = targets[g];
  const long long width = T + 1;
  const long long b0 = b_off[g];
  double* gl_row = dp_out + dp_off[g];
  const FlatBundles bundles{pods + b0, costs + b0};
  const long long nb = b_off[g + 1] - b0;
  unsigned char* bits = bits_out ? bits_out + bits_off[g] : nullptr;
  // a group with no scratch row runs both rows in shared memory (two calls,
  // so that the shared one compiles to shared loads and stores)
  if (scr_off[g + 1] == scr_off[g]) {
    kubepacs::cover_dp_block(bundles, nb, T, smem_rows, smem_rows + width,
                             bits, stage);
    for (long long j = tid; j < width; j += kThreads) {
      gl_row[j] = smem_rows[j];
    }
  } else {
    kubepacs::cover_dp_block(bundles, nb, T, gl_row, scratch + scr_off[g],
                             bits, stage);
  }
}

}  // namespace

// Launches one CTA per group on `stream`. `bits_out` may be null (values
// only). `smem_bytes` is the dynamic shared memory of every CTA, two rows
// of the widest group that runs in it; a group with a scratch row
// (scr_off[g + 1] > scr_off[g], T + 1 doubles of `scratch`) runs in its
// slice of `dp_out` and that row instead. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int cover_dp_launch(const long long* pods, const double* costs,
                               const long long* b_off,
                               const long long* targets,
                               const long long* dp_off,
                               const long long* bits_off,
                               const long long* scr_off, double* dp_out,
                               double* scratch, unsigned char* bits_out,
                               int n_groups, int smem_bytes, void* stream) {
  if (n_groups <= 0) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      cover_dp_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  cover_dp_kernel<<<n_groups, kThreads, smem_bytes,
                    static_cast<cudaStream_t>(stream)>>>(
      pods, costs, b_off, targets, dp_off, bits_off, scr_off, dp_out,
      scratch, bits_out);
  return static_cast<int>(cudaGetLastError());
}
