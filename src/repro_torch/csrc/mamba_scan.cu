// mamba_scan: the Mamba-1 selective scan, four lanes per (batch, channel)
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
// sequential chunk axis of its grid; here a group of G = 4 lanes owns one
// channel d of one batch row, each lane ceil(N / G) of its states in
// registers for the whole sequence (lane g the states [g * N/G, (g+1) *
// N/G)), so no state crosses a CTA and any S works. A CTA of kThreads lanes
// covers kThreads / G consecutive channels of one batch row and walks t in
// chunks of kChunk steps through a double-buffered shared-memory ring:
// while it steps chunk c, chunk c + 1's x and dt tiles and B_t, C_t rows
// arrive by cp.async (16-byte granules); at the top of the next round each
// thread converts the B and C granules it copied itself (its own copies are
// visible to it after its wait) to float32, then one barrier a chunk.
// Shapes or pointers that do not allow 16-byte granules fill the ring with
// plain loads instead. In a step each lane reads x and dt and, at N = 16,
// its B_t and C_t values with one vector load each. y_t is each lane's
// partial sum over its states, reduced across the group by __shfl_xor_sync,
// G steps at a time: a reduce-scatter (G - 1 shuffles for G steps) leaves
// step t0 + g's sum in lane g, which adds D * x and writes it to a y tile
// that leaves in 16-byte stores. Each product is rounded before its add
// (--fmad=false), in the order of the oracle selective_scan_ref, which also
// rounds dt * x to the inputs' dtype (a bf16 run that took it in float32,
// as the Pallas kernel does, sits a bf16 rounding away from the oracle and
// can flip an output of magnitude >= 8 by one ulp, 0.0625, past the 5e-2
// bar). exp is ex2.approx of dt * (A * log2 e), with A * log2 e taken once.
// G = 4 and ex2 were chosen by timing G 4, 8, 16 with expf and ex2 at the
// falcon-mamba-7b prefill on an H100 (PERF.md): all six held the bars, and
// this one was the fastest.
//
// What bounds it on an H100: operations, the N exps per (b, t, d) on the
// special-function units, and the float32 work around them. It reads x, dt,
// B, C once and writes y and h_S once; at the falcon-mamba-7b prefill (B 4,
// S 1024, di 8192, N 16) that is 0.2 GB against 537 M exps. The sequence is
// a dependent chain per lane, so occupancy (B * di * G lanes) hides the
// exp latency.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;  // lanes of a CTA
constexpr int kMaxState = 16;  // N
constexpr int G = 4;           // lanes of a channel
constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

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

// K consecutive floats of a shared-memory row (one vector load for 2 or 4).
template <int K>
__device__ __forceinline__ void load_row(const float* p, float (&out)[K]) {
  if constexpr (K == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
  } else if constexpr (K == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < K; ++i) out[i] = p[i];
  }
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_kernel(const T* __restrict__ x, const T* __restrict__ dt,
            const float* __restrict__ A, const T* __restrict__ bmat,
            const T* __restrict__ cmat, const float* __restrict__ D,
            const float* __restrict__ h0, T* __restrict__ y,
            float* __restrict__ h_out, int s, int di, int n, int aligned) {
  constexpr int kCh = kThreads / G;          // channels of a CTA
  constexpr int kPer = kMaxState / G;        // states a lane holds at most
  constexpr int kChunk = 64 / sizeof(T);     // steps a ring slot holds
  constexpr int kEpg = 16 / sizeof(T);       // elements a 16-byte granule
  constexpr int kGpr = kCh / kEpg;           // granules a tile row
  static_assert(kCh % kEpg == 0, "a tile row is whole granules");
  static_assert(kChunk % G == 0, "a chunk is whole groups of G steps");
  // x, dt and y tiles in the inputs' dtype (double-buffered); B and C land
  // in lb, lc and are read as float32 from fb, fc
  __shared__ __align__(16) T sx[2][kChunk][kCh];
  __shared__ __align__(16) T sdt[2][kChunk][kCh];
  __shared__ __align__(16) T sy[2][kChunk][kCh];
  __shared__ __align__(16) T lb[kChunk * kMaxState];
  __shared__ __align__(16) T lc[kChunk * kMaxState];
  __shared__ __align__(16) float fb[2][kChunk * kMaxState];
  __shared__ __align__(16) float fc[2][kChunk * kMaxState];

  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int ch = tid / G, g = tid % G;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di;
  const int per = (n + G - 1) / G;           // states of each lane
  const bool full = n == kMaxState;          // every lane holds kPer
  const long long row = static_cast<long long>(b) * s;

  float a[kPer], h[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = g * per + p;
    const bool on = live && p < per && j < n;
    const long long at = (static_cast<long long>(b) * di + d) * n + j;
    const float av = on ? A[static_cast<long long>(d) * n + j] : 0.f;
    a[p] = av * kLog2e;
    h[p] = (on && h0 != nullptr) ? h0[at] : 0.f;
  }
  const float dskip = live ? D[d] : 0.f;

  auto chunk_len = [&](int c) { return min(kChunk, s - c * kChunk); };
  // chunk c into ring slot q: by cp.async (16-byte granules), or, without
  // them, by plain loads (B and C straight to float32)
  auto issue = [&](int c, int q) {
    const int t0 = c * kChunk, len = chunk_len(c);
    if (aligned) {
      for (int i = tid; i < len * kGpr; i += kThreads) {
        const int tt = i / kGpr, cg = i % kGpr;
        const int dd = d0 + cg * kEpg;
        if (dd < di) {
          const long long at = (row + t0 + tt) * di + dd;
          cp_async16(&sx[q][tt][cg * kEpg], x + at);
          cp_async16(&sdt[q][tt][cg * kEpg], dt + at);
        }
      }
      for (int i = tid; i < len * n / kEpg; i += kThreads) {
        const long long at = (row + t0) * n + static_cast<long long>(i) * kEpg;
        cp_async16(&lb[i * kEpg], bmat + at);
        cp_async16(&lc[i * kEpg], cmat + at);
      }
      cp_async_commit();
    } else {
      for (int i = tid; i < len * kCh; i += kThreads) {
        const int tt = i / kCh, cc = i % kCh;
        if (d0 + cc < di) {
          const long long at = (row + t0 + tt) * di + d0 + cc;
          sx[q][tt][cc] = x[at];
          sdt[q][tt][cc] = dt[at];
        }
      }
      for (int i = tid; i < len * n; i += kThreads) {
        const long long at = (row + t0) * n + i;
        fb[q][i] = to_f32(bmat[at]);
        fc[q][i] = to_f32(cmat[at]);
      }
    }
  };
  // B and C of chunk c to float32: each thread converts the granules it
  // copied itself (its own cp.async data is visible to it after its wait)
  auto convert = [&](int c, int q) {
    if (!aligned) return;
    cp_async_wait_all();
    for (int i = tid; i < chunk_len(c) * n / kEpg; i += kThreads) {
#pragma unroll
      for (int e = 0; e < kEpg; ++e) {
        fb[q][i * kEpg + e] = to_f32(lb[i * kEpg + e]);
        fc[q][i * kEpg + e] = to_f32(lc[i * kEpg + e]);
      }
    }
  };
  // chunk c's y tile out of ring slot q
  auto store = [&](int c, int q) {
    const int t0 = c * kChunk, len = chunk_len(c);
    if (aligned) {
      for (int i = tid; i < len * kGpr; i += kThreads) {
        const int tt = i / kGpr, cg = i % kGpr;
        const int dd = d0 + cg * kEpg;
        if (dd < di) {
          *reinterpret_cast<uint4*>(y + (row + t0 + tt) * di + dd) =
              *reinterpret_cast<const uint4*>(&sy[q][tt][cg * kEpg]);
        }
      }
    } else {
      for (int i = tid; i < len * kCh; i += kThreads) {
        const int tt = i / kCh, cc = i % kCh;
        if (d0 + cc < di) y[(row + t0 + tt) * di + d0 + cc] = sy[q][tt][cc];
      }
    }
  };
  // one step of this lane's states: the partial sum of h * C
  auto step = [&](int q, int tt) -> float {
    const float xt = to_f32(sx[q][tt][ch]);
    const float dtt = to_f32(sdt[q][tt][ch]);
    // dt * x in the inputs' dtype, as the oracle selective_scan_ref takes
    // it (exact in float32, then one rounding)
    const float u = to_f32(from_f32<T>(dtt * xt));
    float acc = 0.f;
    if (full) {
      float bv[kPer], cv[kPer];
      load_row<kPer>(&fb[q][tt * kMaxState + g * kPer], bv);
      load_row<kPer>(&fc[q][tt * kMaxState + g * kPer], cv);
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const float decay = ex2_approx(dtt * a[p]);
        h[p] = decay * h[p] + u * bv[p];
        acc = acc + h[p] * cv[p];
      }
    } else {
#pragma unroll
      for (int p = 0; p < kPer; ++p) {
        const int j = g * per + p;
        if (p < per && j < n) {
          const float decay = ex2_approx(dtt * a[p]);
          h[p] = decay * h[p] + u * fb[q][tt * n + j];
          acc = acc + h[p] * fc[q][tt * n + j];
        }
      }
    }
    return acc;
  };

  const int n_chunks = (s + kChunk - 1) / kChunk;
  if (n_chunks > 0) issue(0, 0);
  for (int c = 0; c < n_chunks; ++c) {
    const int q = c & 1;
    convert(c, q);
    __syncthreads();  // chunk c is in slot q; chunk c - 1's readers are done
    if (c + 1 < n_chunks) issue(c + 1, q ^ 1);
    if (c > 0) store(c - 1, q ^ 1);
    const int len = chunk_len(c);
    // G steps at a time: each lane's partial sums of the G steps, then a
    // reduce-scatter across the group (G - 1 shuffles) leaves step t0 + g's
    // y_t in lane g, which adds D * x and writes it
    for (int t0 = 0; t0 < len; t0 += G) {
      float part[G];
      if (t0 + G <= len) {
#pragma unroll
        for (int k = 0; k < G; ++k) part[k] = step(q, t0 + k);
      } else {
#pragma unroll
        for (int k = 0; k < G; ++k) part[k] = t0 + k < len ? step(q, t0 + k)
                                                           : 0.f;
      }
#pragma unroll
      for (int half = G / 2; half >= 1; half >>= 1) {
        const bool upper = (g & half) != 0;
#pragma unroll
        for (int k = 0; k < half; ++k) {
          const float send = upper ? part[k] : part[k + half];
          const float own = upper ? part[k + half] : part[k];
          part[k] = own + __shfl_xor_sync(kFull, send, half);
        }
      }
      const int tt = t0 + g;
      if (tt < len) {
        sy[q][tt][ch] =
            from_f32<T>(part[0] + dskip * to_f32(sx[q][tt][ch]));
      }
    }
  }
  __syncthreads();
  if (n_chunks > 0) store(n_chunks - 1, (n_chunks - 1) & 1);
  if (live) {
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const int j = g * per + p;
      if (p < per && j < n)
        h_out[(static_cast<long long>(b) * di + d) * n + j] = h[p];
    }
  }
}

template <typename T>
int launch(const void* x, const void* dt, const float* A, const void* bmat,
           const void* cmat, const float* D, const float* h0, void* y,
           float* h_out, int b, int s, int di, int n, cudaStream_t stream) {
  constexpr int kCh = kThreads / G;
  auto al = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int aligned = al(x) && al(dt) && al(bmat) && al(cmat) && al(y) &&
                      (di * sizeof(T)) % 16 == 0 &&
                      (n * sizeof(T)) % 16 == 0;
  const dim3 grid((di + kCh - 1) / kCh, b);
  scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), D, h0,
      static_cast<T*>(y), h_out, s, di, n, aligned);
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
