// flash_attention: GQA attention forward with an online softmax, one CTA per
// (query tile, batch x head) (sm_90a).
//
// Replaces the TPU kernel _flash_kernel / flash_attention_pallas
// (src/repro/kernels/flash_attention.py). For q (B,Sq,H,hd) and k, v
// (B,Skv,KV,hd), head h attends over kv head h / G (G = H / KV):
//     s[i,t] = (q_i . k_t) * hd^-1/2, masked to -inf where t > q_offset + i
//              (causal), t >= kv_len or t >= Skv;
//     o_i = sum_t softmax(s_i)[t] v_t,  lse_i = logsumexp(s_i)
// kept as the reference keeps it: a running max m, denominator l and
// numerator acc in float32 across K/V tiles, with its -inf guards (a row
// with no valid key yet keeps m = -inf and never computes (-inf) - (-inf);
// its output is 0 and its lse -inf). o is written in q's dtype, lse in
// float32 laid out (B,Sq,H) = (B,Sq,KV,G).
//
// Design. The TPU kernel carries (m, l, acc) in VMEM scratch across the
// sequential kv grid axis; on Hopper CTAs run in no order, so one CTA owns a
// tile of kBlockQ query rows of one head and loops over the K/V tiles
// itself. Q, K and V tiles are staged in shared memory as float32 (rows
// past Sq or Skv and columns past hd are zero), the score tile S = Q K^T
// and the product P V are IEEE float32 FMAs (no TF32, no tensor cores: the
// f32 bar is 2e-5), and each thread of the 16 x 16 grid owns rows
// ty + 16 i and keys tx + 16 j of S, and rows ty + 16 i and columns
// tx + 16 j of acc. A row's max and sum are reduced across the 16 lanes
// that hold it with warp shuffles. K/V tiles wholly above the causal
// diagonal or wholly at or past kv_len are not visited: in the reference
// such a tile leaves (m, l, acc) exactly as they were. Ragged Sq and Skv are
// bounds checks. For bf16 inputs p is rounded to bf16 before P V, as the
// reference casts p to v's dtype.
//
// What bounds it on an H100: operations. At the internlm2-1.8b prefill
// (B 8, S 1024, H 16, hd 128) it does 4 hd flops per valid (query, key)
// pair and moves 4 bytes per element of q, k, v and o once; its roofline is
// the bf16 tensor-core rate, which this scalar-FMA kernel does not use
// (wgmma, TMA and warp specialisation are later work).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16

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

// Reduces v over the 16 lanes that share a row (lane bits 0-3).
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int off = 8; off >= 1; off >>= 1)
    v = v + __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

constexpr size_t smem_bytes(int hdp) {
  return sizeof(float) * (static_cast<size_t>(kBlockQ) * (hdp + 1) +
                          static_cast<size_t>(kBlockK) * (hdp + 1) +
                          static_cast<size_t>(kBlockK) * hdp +
                          static_cast<size_t>(kBlockQ) * (kBlockK + 1));
}

// HDP: hd rounded up to a multiple of 16 lanes' columns (32, 64, 96, 128 or
// 256); columns hd..HDP-1 are zero and never written.
template <typename T, int HDP>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o,
             float* __restrict__ lse, int sq, int skv, int n_heads,
             int n_kv_heads, int hd, int q_offset, int kv_lim, int causal,
             float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                          // [kBlockQ][HDP + 1]
  float* ks = qs + kBlockQ * (HDP + 1);      // [kBlockK][HDP + 1]
  float* vs = ks + kBlockK * (HDP + 1);      // [kBlockK][HDP]
  float* ps = vs + kBlockK * HDP;            // [kBlockQ][kBlockK + 1]
  constexpr int kCols = HDP / 16;            // acc columns of a thread

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, head = bh % n_heads;
  const int kh = head / (n_heads / n_kv_heads);
  // the heaviest (last) causal tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBlockQ;
  const long long q_stride = static_cast<long long>(n_heads) * hd;
  const long long kv_stride = static_cast<long long>(n_kv_heads) * hd;
  const T* qb = q + static_cast<long long>(b) * sq * q_stride +
                static_cast<long long>(head) * hd;
  const T* kb = k + static_cast<long long>(b) * skv * kv_stride +
                static_cast<long long>(kh) * hd;
  const T* vb = v + static_cast<long long>(b) * skv * kv_stride +
                static_cast<long long>(kh) * hd;

  for (int i = tid; i < kBlockQ * HDP; i += kThreads) {
    const int r = i / HDP, d = i % HDP;
    float val = 0.f;
    if (q0 + r < sq && d < hd) val = to_f32(qb[(q0 + r) * q_stride + d]);
    qs[r * (HDP + 1) + d] = val;
  }

  float m[4], l[4], acc[4][kCols];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.f;
  }

  // keys past k_end are masked for every row of the tile
  const int q_last = min(q0 + kBlockQ, sq) - 1;
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);

  for (int k0 = 0; k0 < k_end; k0 += kBlockK) {
    __syncthreads();  // Q is staged; the previous tile's readers are done
    for (int i = tid; i < kBlockK * HDP; i += kThreads) {
      const int r = i / HDP, d = i % HDP;
      float kv_k = 0.f, kv_v = 0.f;
      if (k0 + r < skv && d < hd) {
        const long long at = (k0 + r) * kv_stride + d;
        kv_k = to_f32(kb[at]);
        kv_v = to_f32(vb[at]);
      }
      ks[r * (HDP + 1) + d] = kv_k;
      vs[r * HDP + d] = kv_v;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HDP; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * (HDP + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * (HDP + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_offset + q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int t = k0 + tx + 16 * j;
        const bool ok = t < kv_lim && (!causal || t <= qpos);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = isfinite(s[i][j]) ? expf(s[i][j] - safe_m) : 0.f;
        rs = rs + p;
        ps[(ty + 16 * i) * (kBlockK + 1) + tx + 16 * j] =
            to_f32(from_f32<T>(p));
      }
      const float corr = isfinite(m[i]) ? expf(m[i] - safe_m) : 0.f;
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] = acc[i][c] * corr;
    }
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBlockK; ++t) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * (kBlockK + 1) + t];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const float vv = vs[t * HDP + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    const float denom = fmaxf(l[i], 1e-37f);
    T* orow = o + (static_cast<long long>(b) * sq + row) * q_stride +
              static_cast<long long>(head) * hd;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) orow[d] = from_f32<T>(acc[i][c] / denom);
    }
    if (tx == 0)
      lse[(static_cast<long long>(b) * sq + row) * n_heads + head] =
          isfinite(m[i]) ? m[i] + logf(denom) : -INFINITY;
  }
}

template <typename T, int HDP>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int b, int sq, int skv, int h, int kvh, int hd, int q_offset,
           int kv_lim, int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes(HDP);
  auto kernel = flash_kernel<T, HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  const dim3 grid(b * h, (sq + kBlockQ - 1) / kBlockQ);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, sq, skv, h, kvh, hd,
      q_offset, kv_lim, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o,
             float* lse, int b, int sq, int skv, int h, int kvh, int hd,
             int q_offset, int kv_lim, int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<T, 32>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                         kv_lim, causal, stream);
  if (hd <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                         kv_lim, causal, stream);
  if (hd <= 96)
    return launch<T, 96>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                         kv_lim, causal, stream);
  if (hd <= 128)
    return launch<T, 128>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                          kv_lim, causal, stream);
  return launch<T, 256>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                        kv_lim, causal, stream);
}

}  // namespace

// Launches the kernel on `stream` for contiguous q (B,Sq,H,hd) and k, v
// (B,Skv,KV,hd), writing o (B,Sq,H,hd) in their dtype and lse (B,Sq,H)
// float32. dtype: 0 float32, 1 bfloat16. kv_lim = min(kv_len, Skv) (Skv
// when there is no kv_len). Returns the CUDA error code (0 on success);
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      int b, int sq, int skv, int h, int kvh,
                                      int hd, int q_offset, int kv_lim,
                                      int causal, int dtype, void* stream) {
  if (b <= 0 || sq <= 0 || h <= 0) return 0;
  if (kvh <= 0 || h % kvh != 0 || hd <= 0 || hd > 256 || skv < 0 ||
      (sq + kBlockQ - 1) / kBlockQ > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                           kv_lim, causal, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                                   q_offset, kv_lim, causal, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
