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

#include <type_traits>

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


// ---------------------------------------------------------------------------
// scan_bwd_kernel and scan_bwd_sums: the scan's seven gradients.
//
// Replaces no TPU kernel: the reference differentiates its chunked scan with
// jax.grad, and the port's plain version (ops.scan_backward) re-runs the
// chunked associative scan under autograd chunk by chunk, ~850 ms a call at
// falcon-mamba-7b's train_4k shape, all of it unfused float32 elementwise
// traffic; no PyTorch call computes it. It was added because that plain
// backward was 92% of the falcon-mamba-7b train step. For the forward above
// and output gradients dy (B,S,di) in the inputs' dtype and dh (B,di,N)
// float32 (either may be null, read as zero), with g_t = dL/dh_t = C_t dy_t +
// exp(dt_{t+1} A) g_{t+1} (dh entering at t = S-1), z_t = exp(dt_t A) h_{t-1}
// g_t and du_t = sum_n B_t g_t:
//     dx = dt du + D dy                 ddt = x du + sum_n A z
//     dA = sum_{b,t} dt z               dD = sum_{b,t} x dy
//     dB_t = sum_d u_t g_t              dC_t = sum_d h_t dy_t
//     dh0 = exp(dt_0 A) g_0
// dx, ddt, dB, dC in the inputs' dtype; dA, dD, dh0 in float32.
//
// Design. The forward's decomposition: G lanes own one (batch row, channel),
// each lane its states in registers; a CTA covers kCh consecutive channels of
// one batch row. Two walks over the sequence:
//  1. forward from h0, stepping as scan_kernel does, writing only the state
//     before every kBwdK-th step to a checkpoint in device memory;
//  2. in reverse, chunk by chunk of kBwdK steps: the chunk's x, dt, dy tiles
//     and B, C rows staged in shared memory, its checkpoint reloaded, its
//     states recomputed into registers exactly as the forward makes them
//     (ex2.approx of dt * (A log2 e), u = dt x rounded to the inputs' dtype,
//     the same unfused products), so the kernel differentiates the states the
//     forward produced; then the walk back, g carried in registers.
// du and sum_n A z of each step are reduced over the channel's G lanes G steps
// at a time (a reduce-scatter, as y in the forward), and the lane holding a
// step writes its dx and ddt. dB_t and dC_t, sums over channels, are reduced
// over the warp's channels by a reduce-scatter (7 shuffles for 8 values) and
// over the CTA's warps in shared memory in warp order, into per-CTA partials;
// dA and dD are each lane's sums over t, into per-row partials. A second,
// small kernel (scan_bwd_sums) sums the partials in CTA and row order. No
// atomics: the same inputs give the same bits on every launch. (Summing a
// chunk's partials in the CTA that finishes it last, in one kernel, took
// half the time at the train_4k shape: that CTA falls behind, finishes every
// later chunk last too, and sums all of them in series.)
//
// What bounds it on an H100: operations, as the forward. The gradient needs
// one exp per (b, t, d, n): 0.5135 ms at falcon-mamba-7b's train_4k launch
// (B 4, S 4096, di 8192, N 16), against ~0.40 ms of bytes. This kernel takes
// three (walk 1, the recompute, the walk back) and about three times the
// forward's float32 work, and moves the checkpoints and partials besides
// (0.8 GB at that shape). kBwdK = 16 keeps a chunk's 17 states in registers
// at two CTAs an SM; it was chosen by timing (PERF.md).

constexpr int kBwdK = 16;                   // steps between checkpoints
constexpr int kWarps = kThreads / 32;
constexpr int kRed = 2 * kMaxState;         // dB_t and dC_t values of a step
constexpr float kLn2 = 0.6931471805599453f;

// Sum of v[sel] over the lanes that differ from this one in the bits of
// `sel` (each bit `stride` lanes apart), left in this lane: log2(V) levels,
// V - 1 shuffles for V values.
template <int V>
__device__ __forceinline__ float reduce_scatter(float (&v)[V], int sel,
                                                int stride) {
#pragma unroll
  for (int half = V / 2; half >= 1; half >>= 1) {
    const bool upper = (sel & half) != 0;
#pragma unroll
    for (int k = 0; k < half; ++k) {
      const float send = upper ? v[k] : v[k + half];
      const float own = upper ? v[k + half] : v[k];
      v[k] = own + __shfl_xor_sync(kFull, send, half * stride);
    }
  }
  return v[0];
}

// Device memory the backward needs besides its outputs, carved from one
// buffer: the checkpoints, the per-CTA dB / dC partials and the per-row
// dA / dD partials (byte offsets). kernels/mamba_scan.py's
// scan_bwd_work_bytes gives the same total, for the allocation and the
// cost model's memory account; the launch refuses a smaller buffer.
struct BwdWork {
  long long ckpt, part, part_ad, total;
};

BwdWork bwd_work(int b, int s, int di, int n) {
  const long long nx = (di + kThreads / G - 1) / (kThreads / G);
  const long long nc = (s + kBwdK - 1) / kBwdK;
  auto up = [](long long bytes) { return (bytes + 255) / 256 * 256; };
  BwdWork w;
  w.ckpt = 0;
  w.part = up(4LL * b * nc * di * n);
  w.part_ad = w.part + up(4LL * b * nc * nx * kBwdK * kRed);
  w.total = w.part_ad + up(4LL * b * di * (n + 1));
  return w;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
scan_bwd_kernel(const T* __restrict__ x, const T* __restrict__ dt,
                const float* __restrict__ A, const T* __restrict__ bmat,
                const T* __restrict__ cmat, const float* __restrict__ D,
                const float* __restrict__ h0, const T* __restrict__ dy,
                const float* __restrict__ dh, T* __restrict__ dx,
                T* __restrict__ ddt, float* __restrict__ dh0,
                float* __restrict__ ckpt, float* __restrict__ part,
                float* __restrict__ part_ad, int s, int di, int n) {
  constexpr int K = kBwdK;
  constexpr int kCh = kThreads / G;         // channels of a CTA
  constexpr int kPer = kMaxState / G;       // states a lane holds at most
  constexpr int kGroups = 32 / G;           // channels of a warp
  static_assert(2 * kPer == kGroups, "one dB or dC value a lane of a warp");
  static_assert(K % G == 0, "a chunk is whole groups of G steps");
  __shared__ __align__(16) T sx[K][kCh];
  __shared__ __align__(16) T sdt[K][kCh];
  __shared__ __align__(16) T sdy[K][kCh];
  __shared__ __align__(16) T sdx[K][kCh];
  __shared__ __align__(16) T sddt[K][kCh];
  __shared__ __align__(16) float fb[K * kMaxState];
  __shared__ __align__(16) float fc[K * kMaxState];
  __shared__ float sred[kWarps][K][kRed];

  const int b = blockIdx.y, nb = gridDim.y, nx = gridDim.x;
  const int tid = threadIdx.x;
  const int ch = tid / G, g = tid % G;
  const int warp = tid / 32, sel = ch % kGroups;
  const int d0 = blockIdx.x * kCh;
  const int d = d0 + ch;
  const bool live = d < di;
  const int per = (n + G - 1) / G;          // states of each lane
  const long long row = static_cast<long long>(b) * s;
  const long long state = (static_cast<long long>(b) * di + d) * n;
  const int n_chunks = (s + K - 1) / K;

  // lane g holds the states [g * per, g * per + per); a state past N, or of
  // a channel past di, is off: its A, B and C read as zero, so it stays zero
  // and adds nothing
  float a[kPer];
  bool on[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    const int j = g * per + p;
    on[p] = live && p < per && j < n;
    a[p] = on[p] ? A[static_cast<long long>(d) * n + j] * kLog2e : 0.f;
  }
  const float dskip = live ? D[d] : 0.f;

  // chunk c's tiles: x, dt (and, walking back, dy) of the CTA's channels, B
  // (and C) rows in float32, zero past the sequence, di and N
  auto load = [&](int c, bool back) {
    const int t0 = c * K, len = min(K, s - t0);
    for (int i = tid; i < K * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      const bool in = tt < len && d0 + cc < di;
      const long long at = (row + t0 + tt) * di + d0 + cc;
      sx[tt][cc] = in ? x[at] : from_f32<T>(0.f);
      sdt[tt][cc] = in ? dt[at] : from_f32<T>(0.f);
      if (back)
        sdy[tt][cc] = in && dy != nullptr ? dy[at] : from_f32<T>(0.f);
    }
    for (int i = tid; i < K * kMaxState; i += kThreads) {
      const int tt = i / kMaxState, j = i % kMaxState;
      const bool in = tt < len && j < n;
      const long long at = (row + t0 + tt) * n + j;
      fb[i] = in ? to_f32(bmat[at]) : 0.f;
      if (back) fc[i] = in ? to_f32(cmat[at]) : 0.f;
    }
  };
  // this lane's values of step tt's B or C row
  auto row_of = [&](const float* f, int tt, float (&v)[kPer]) {
    if (per == kPer) {
      load_row<kPer>(&f[tt * kMaxState + g * kPer], v);
    } else {
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        v[p] = p < per ? f[tt * kMaxState + g * per + p] : 0.f;
    }
  };
  // step tt of the forward: hout = exp(dt A) hin + u B, as scan_kernel
  auto advance = [&](int tt, const float (&hin)[kPer], float (&hout)[kPer]) {
    const float xt = to_f32(sx[tt][ch]);
    const float dtt = to_f32(sdt[tt][ch]);
    const float u = to_f32(from_f32<T>(dtt * xt));
    float bv[kPer];
    row_of(fb, tt, bv);
#pragma unroll
    for (int p = 0; p < kPer; ++p) {
      const float decay = ex2_approx(dtt * a[p]);
      hout[p] = decay * hin[p] + u * bv[p];
    }
  };
  auto checkpoint = [&](int c) {
    return ckpt + ((static_cast<long long>(b) * n_chunks + c) * di + d) * n;
  };

  // -- walk 1: forward, the state before each chunk checkpointed -----------
  float h[kPer];
#pragma unroll
  for (int p = 0; p < kPer; ++p)
    h[p] = on[p] && h0 != nullptr ? h0[state + g * per + p] : 0.f;
  for (int c = 0; c < n_chunks; ++c) {
#pragma unroll
    for (int p = 0; p < kPer; ++p)
      if (on[p]) checkpoint(c)[g * per + p] = h[p];
    if (c + 1 == n_chunks) break;
    __syncthreads();                 // chunk c - 1's readers are done
    load(c, false);
    __syncthreads();
#pragma unroll
    for (int tt = 0; tt < K; ++tt) advance(tt, h, h);
  }

  // -- walk 2: in reverse, chunk by chunk ----------------------------------
  float carry[kPer], sum_a[kPer];            // exp(dt_{t+1} A) g_{t+1}; dA
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    carry[p] = on[p] && dh != nullptr ? dh[state + g * per + p] : 0.f;
    sum_a[p] = 0.f;
  }
  float sum_d = 0.f;                         // dD over this lane's steps
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * K, len = min(K, s - t0);
    __syncthreads();                 // chunk c + 1's readers are done
    load(c, true);
    __syncthreads();
    // the chunk's recompute and walk back; a whole chunk (every chunk but
    // a ragged last one) without the per-step guards, so that the unrolled
    // steps schedule as one block
    auto back = [&](auto whole) {
      constexpr bool kWhole = decltype(whole)::value;
      // hs[tt]: the state before step tt of the chunk, hs[tt + 1] after it
      float hs[K + 1][kPer];
#pragma unroll
      for (int p = 0; p < kPer; ++p)
        hs[0][p] = on[p] ? checkpoint(c)[g * per + p] : 0.f;
#pragma unroll
      for (int tt = 0; tt < K; ++tt)
        if (kWhole || tt < len) advance(tt, hs[tt], hs[tt + 1]);
#pragma unroll
      for (int q = K / G - 1; q >= 0; --q) {
        float du[G], dz[G];                  // this lane's parts, G steps
#pragma unroll
        for (int k = G - 1; k >= 0; --k) {
          const int tt = q * G + k;
          du[k] = dz[k] = 0.f;
          if (!kWhole && tt >= len) continue;
          const float xt = to_f32(sx[tt][ch]);
          const float dtt = to_f32(sdt[tt][ch]);
          const float dyt = to_f32(sdy[tt][ch]);
          const float u = to_f32(from_f32<T>(dtt * xt));
          float bv[kPer], cv[kPer], red[2 * kPer];
          row_of(fb, tt, bv);
          row_of(fc, tt, cv);
#pragma unroll
          for (int p = 0; p < kPer; ++p) {
            const float gp = __fmaf_rn(cv[p], dyt, carry[p]);    // g_t
            carry[p] = ex2_approx(dtt * a[p]) * gp;
            const float z = carry[p] * hs[tt][p];
            du[k] = __fmaf_rn(bv[p], gp, du[k]);
            dz[k] = __fmaf_rn(a[p], z, dz[k]);
            sum_a[p] = __fmaf_rn(dtt, z, sum_a[p]);
            red[p] = u * gp;                                     // dB_t
            red[kPer + p] = hs[tt + 1][p] * dyt;                 // dC_t
          }
          // the warp's channels summed: this lane keeps value `sel`
          const float v = reduce_scatter<2 * kPer>(red, sel, G);
          const int p = sel % kPer, j = g * per + p;
          if (p < per && j < n)
            sred[warp][tt][(sel / kPer) * kMaxState + j] = v;
        }
        // the channel's lanes summed: lane g keeps step q * G + g
        const float dus = reduce_scatter<G>(du, g, 1);
        const float dzs = reduce_scatter<G>(dz, g, 1);
        const int tt = q * G + g;
        if ((kWhole || tt < len) && live) {
          const float xt = to_f32(sx[tt][ch]);
          const float dyt = to_f32(sdy[tt][ch]);
          sdx[tt][ch] = from_f32<T>(
              __fmaf_rn(to_f32(sdt[tt][ch]), dus, dskip * dyt));
          sddt[tt][ch] = from_f32<T>(__fmaf_rn(xt, dus, kLn2 * dzs));
          sum_d = __fmaf_rn(xt, dyt, sum_d);
        }
      }
    };
    if (len == K)
      back(std::true_type{});
    else
      back(std::false_type{});
    __syncthreads();
    for (int i = tid; i < len * kCh; i += kThreads) {
      const int tt = i / kCh, cc = i % kCh;
      if (d0 + cc < di) {
        const long long at = (row + t0 + tt) * di + d0 + cc;
        dx[at] = sdx[tt][cc];
        ddt[at] = sddt[tt][cc];
      }
    }
    // this CTA's dB_t, dC_t: its channels summed, warps in order
    const long long chunk = static_cast<long long>(b) * n_chunks + c;
    float* mine = part + (chunk * nx + blockIdx.x) * (K * kRed);
    for (int i = tid; i < len * kRed; i += kThreads) {
      const int tt = i / kRed, r = i % kRed;
      if (r % kMaxState < n) {
        float acc = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) acc += sred[w][tt][r];
        mine[i] = acc;
      }
    }
  }

  // -- dh0; this row's dA and dD ----------------------------------------
#pragma unroll
  for (int p = 0; p < kPer; ++p) {
    if (on[p]) {
      dh0[state + g * per + p] = carry[p];
      part_ad[state + g * per + p] = sum_a[p];
    }
  }
  sum_d += __shfl_xor_sync(kFull, sum_d, 1);
  sum_d += __shfl_xor_sync(kFull, sum_d, 2);
  if (live && g == 0)
    part_ad[static_cast<long long>(nb) * di * n +
            static_cast<long long>(b) * di + d] = sum_d;
}

// The sums across CTAs and rows that scan_bwd_kernel leaves as partials, in
// a fixed order: dB_t, dC_t over the di / kCh channel tiles of a row (a CTA
// for each (row, chunk)), then dA, dD over the rows (the CTAs after those).
template <typename T>
__global__ void __launch_bounds__(kThreads)
scan_bwd_sums(const float* __restrict__ part,
              const float* __restrict__ part_ad, T* __restrict__ dB,
              T* __restrict__ dC, float* __restrict__ dA,
              float* __restrict__ dD, int nb, int s, int di, int n, int nx) {
  constexpr int K = kBwdK;
  const int n_chunks = (s + K - 1) / K;
  const long long rows = static_cast<long long>(nb) * n_chunks;
  const int tid = threadIdx.x;
  if (blockIdx.x < rows) {
    const long long chunk = blockIdx.x;
    const int b = static_cast<int>(chunk / n_chunks);
    const int t0 = static_cast<int>(chunk % n_chunks) * K;
    const int len = min(K, s - t0);
    const float* all = part + chunk * nx * (K * kRed);
    for (int i = tid; i < len * kRed; i += kThreads) {
      const int tt = i / kRed, r = i % kRed, j = r % kMaxState;
      if (j >= n) continue;
      float acc = 0.f;
      for (int xb = 0; xb < nx; ++xb)
        acc += all[static_cast<long long>(xb) * (K * kRed) + i];
      T* out = r < kMaxState ? dB : dC;
      out[(static_cast<long long>(b) * s + t0 + tt) * n + j] =
          from_f32<T>(acc);
    }
    return;
  }
  const long long e = (blockIdx.x - rows) * kThreads + tid;
  const long long na = static_cast<long long>(di) * n;
  if (e < na) {
    float acc = 0.f;
    for (int bb = 0; bb < nb; ++bb) acc += part_ad[bb * na + e];
    dA[e] = acc;
  } else if (e < na + di) {
    const float* part_d = part_ad + nb * na;
    float acc = 0.f;
    for (int bb = 0; bb < nb; ++bb)
      acc += part_d[static_cast<long long>(bb) * di + (e - na)];
    dD[e - na] = acc;
  }
}

template <typename T>
int launch_bwd(const void* x, const void* dt, const float* A,
               const void* bmat, const void* cmat, const float* D,
               const float* h0, const void* dy, const float* dh, void* dx,
               void* ddt, float* dA, void* dB, void* dC, float* dD,
               float* dh0, char* work, int b, int s, int di, int n,
               cudaStream_t stream) {
  const BwdWork w = bwd_work(b, s, di, n);
  const int nx = (di + kThreads / G - 1) / (kThreads / G);
  const int nc = (s + kBwdK - 1) / kBwdK;
  float* part = reinterpret_cast<float*>(work + w.part);
  float* part_ad = reinterpret_cast<float*>(work + w.part_ad);
  scan_bwd_kernel<T><<<dim3(nx, b), kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dt), A,
      static_cast<const T*>(bmat), static_cast<const T*>(cmat), D, h0,
      static_cast<const T*>(dy), dh, static_cast<T*>(dx),
      static_cast<T*>(ddt), dh0, reinterpret_cast<float*>(work + w.ckpt),
      part, part_ad, s, di, n);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long na = static_cast<long long>(di) * (n + 1);
  const long long blocks =
      static_cast<long long>(b) * nc + (na + kThreads - 1) / kThreads;
  scan_bwd_sums<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      part, part_ad, static_cast<T*>(dB), static_cast<T*>(dC), dA, dD, b, s,
      di, n, nx);
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

// Launches the backward on `stream` for the forward's contiguous inputs (as
// mamba_scan_launch; h0 may be null), dy (B,S,di) in their dtype and dh
// (B,di,N) float32 (either null for zero), and `work` of at least
// bwd_work's total bytes (256-byte aligned); writes dx, ddt (B,S,di)
// and dB, dC (B,S,N) in that dtype, dA (di,N), dD (di,) and dh0 (B,di,N)
// float32. Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take (N > 16) or too
// small a `work`.
extern "C" int mamba_scan_bwd_launch(const void* x, const void* dt,
                                     const float* A, const void* bmat,
                                     const void* cmat, const float* D,
                                     const float* h0, const void* dy,
                                     const float* dh, void* dx, void* ddt,
                                     float* dA, void* dB, void* dC, float* dD,
                                     float* dh0, void* work,
                                     long long work_bytes, int b, int s,
                                     int di, int n, int dtype, void* stream) {
  if (di <= 0) return 0;
  if (n <= 0 || n > kMaxState || s < 0 || b < 0 || b > 65535 ||
      work_bytes < bwd_work(b, s, di, n).total ||
      reinterpret_cast<uintptr_t>(work) % 256 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (b == 0) {     // no rows: dA and dD are empty sums
    cudaError_t err = cudaMemsetAsync(dA, 0, sizeof(float) * di * n, st);
    if (err == cudaSuccess)
      err = cudaMemsetAsync(dD, 0, sizeof(float) * di, st);
    return static_cast<int>(err);
  }
  char* w = static_cast<char*>(work);
  if (dtype == 0)
    return launch_bwd<float>(x, dt, A, bmat, cmat, D, h0, dy, dh, dx, ddt, dA,
                             dB, dC, dD, dh0, w, b, s, di, n, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, dt, A, bmat, cmat, D, h0, dy, dh, dx,
                                     ddt, dA, dB, dC, dD, dh0, w, b, s, di, n,
                                     st);
  return static_cast<int>(cudaErrorInvalidValue);
}
