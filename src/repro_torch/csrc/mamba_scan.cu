// mamba_scan: the Mamba-1 selective scan, one thread per (batch, channel)
// (sm_90a).
//
// Replaces the TPU kernel _scan_kernel / selective_scan_pallas
// (src/repro/kernels/mamba_scan.py). For x, dt (B,S,di), A (di,N) float32,
// B, C (B,S,N), D (di,) float32 and an optional h0 (B,di,N) float32:
//     h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t
//     y_t = sum_n h_t[n] * C_t[n] + D * x_t
// with the state h in float32. y is written in x's dtype, and the final
// state h_S (B,di,N) in float32, so the model's cache handoff needs no
// second pass (the reference recomputes it with two chunked scans).
//
// Design. The TPU kernel keeps h (di_blk, N) in VMEM scratch across the
// sequential chunk axis of its grid; here one thread owns one channel d of
// one batch row and keeps its h[N] (N <= 16) in registers for the whole
// sequence, so no state crosses a CTA and any S works. A CTA of kThreads
// consecutive channels walks t in order in chunks of kChunk steps: it first
// stages the chunk's B_t and C_t (shared by every channel of the row) and
// its own x and dt columns (read coalesced across d) in shared memory, then
// steps the recurrence. Each product is rounded before its add
// (--fmad=false), in the order of the oracle selective_scan_ref, which
// also rounds dt * x to the inputs' dtype (a bf16 run that took it in
// float32, as the Pallas kernel does, sits a bf16 rounding away from the
// oracle and can flip an output of magnitude >= 8 by one ulp, 0.0625,
// past the 5e-2 bar); exp is expf (no fast math).
//
// What bounds it on an H100: operations, the N exps per (b, t, d) on the
// special-function units. It reads x, dt, B, C once and writes y and h_S
// once; at the falcon-mamba-7b prefill (B 4, S 1024, di 8192, N 16) that is
// 0.2 GB against 537 M exps. The sequence is a dependent chain per thread,
// so occupancy (B * di threads) hides the exp latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 64;   // channels of a CTA
constexpr int kChunk = 32;     // time steps staged at once
constexpr int kMaxState = 16;  // N

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ bmat,
            const T* __restrict__ cmat, const float* __restrict__ D,
            const float* __restrict__ h0, T* __restrict__ y,
            float* __restrict__ h_out, int s, int di, int n) {
  __shared__ float sb[kChunk][kMaxState];
  __shared__ float sc[kChunk][kMaxState];
  __shared__ float sx[kChunk][kThreads];
  __shared__ float sdt[kChunk][kThreads];
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  const int d = blockIdx.x * kThreads + lane;
  const bool live = d < di;

  float a[kMaxState], h[kMaxState];
#pragma unroll
  for (int j = 0; j < kMaxState; ++j) {
    const bool on = live && j < n;
    const long long at = (static_cast<long long>(b) * di + d) * n + j;
    a[j] = on ? A[static_cast<long long>(d) * n + j] : 0.f;
    h[j] = (on && h0 != nullptr) ? h0[at] : 0.f;
  }
  const float dskip = live ? D[d] : 0.f;
  const long long row = static_cast<long long>(b) * s;

  for (int t0 = 0; t0 < s; t0 += kChunk) {
    const int len = min(kChunk, s - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int i = lane; i < len * n; i += kThreads) {
      const int tt = i / n, j = i % n;
      const long long at = (row + t0 + tt) * n + j;
      sb[tt][j] = to_f32(bmat[at]);
      sc[tt][j] = to_f32(cmat[at]);
    }
    if (live) {
      for (int tt = 0; tt < len; ++tt) {
        const long long at = (row + t0 + tt) * di + d;
        sx[tt][lane] = to_f32(x[at]);
        sdt[tt][lane] = to_f32(dt[at]);
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int tt = 0; tt < len; ++tt) {
      const float xt = sx[tt][lane], dtt = sdt[tt][lane];
      // dt * x in the inputs' dtype, as the oracle selective_scan_ref
      // takes it (exact in float32, then one rounding)
      const float u = to_f32(from_f32<T>(dtt * xt));
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < kMaxState; ++j) {
        if (j < n) {
          const float decay = expf(dtt * a[j]);
          h[j] = decay * h[j] + u * sb[tt][j];
          acc = acc + h[j] * sc[tt][j];
        }
      }
      y[(row + t0 + tt) * di + d] = from_f32<T>(acc + dskip * xt);
    }
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < kMaxState; ++j)
      if (j < n) h_out[(static_cast<long long>(b) * di + d) * n + j] = h[j];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* bmat,
           const void* cmat, const float* D, const float* h0, void* y,
           float* h_out, int b, int s, int di, int n, cudaStream_t stream) {
  const dim3 grid((di + kThreads - 1) / kThreads, b);
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), D, h0,
      static_cast<T*>(y), h_out, s, di, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches the kernel on `stream` for contiguous x, dt (B,S,di), B, C
// (B,S,N) of one dtype (0 float32, 1 bfloat16), A (di,N) and D (di,)
// float32, h0 (B,di,N) float32 or null; writes y (B,S,di) in that dtype and
// h_out (B,di,N) float32. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take (N > 16).
extern "C" int mamba_scan_launch(const void* x, const void* dt,
                                 const float* A, const void* bmat,
                                 const void* cmat, const float* D,
                                 const float* h0, void* y, float* h_out,
                                 int b, int s, int di, int n, int dtype,
                                 void* stream) {
  if (b <= 0 || di <= 0) return 0;
  if (n <= 0 || n > kMaxState || s < 0 || b > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, bmat, cmat, D, h0, y, h_out, b, s, di, n,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, bmat, cmat, D, h0, y, h_out, b, s,
                                 di, n, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
