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
// float32 laid out (B,Sq,H) = (B,Sq,KV,G). The TPU kernel carries (m, l,
// acc) in VMEM scratch across the sequential kv grid axis; on Hopper CTAs
// run in no order, so one CTA owns a tile of 64 query rows of one head and
// loops over the K/V tiles itself. K/V tiles wholly above the causal
// diagonal or wholly at or past kv_len are not visited (in the reference
// such a tile leaves (m, l, acc) exactly as they were), and the CTAs of the
// last, heaviest causal query tiles are scheduled first.
//
// What bounds it on an H100: operations, 4 hd flops per valid (query, key)
// pair. At the internlm2-1.8b prefill (B 8, S 1024, H 16, hd 128, bf16) that
// is 34.4 GFLOP against 0.1 GB read and written once, so the roof is the
// bf16 tensor-core rate (989 TFLOP/s dense), which only wgmma reaches.
//
// bfloat16: tensor cores (flash_wgmma_kernel). On bf16 inputs the
// reference's f32 products of bf16 values are exact, so wgmma's
// f32.bf16.bf16 products differ from them only in summation order, and the
// reference rounds p to bf16 before P V, which is the A operand wgmma takes
// from registers. One CTA is one warpgroup of 4 warps (wgmma's M = 64):
//   * Q: thread 0 loads the 64 x hd tile once by TMA; K and V tiles of 64
//     keys go through a 2-stage ring in shared memory, TMA loads completing
//     on one mbarrier a stage, the loads of tile j+1 issued before the
//     products of tile j. Every tile is stored as 64-column boxes of 128
//     bytes a row, 128-byte swizzled (the widest swizzled box), so a head of
//     hd > 64 is two to four boxes side by side; the tensor maps are 4-D
//     over (hd, heads, S, B) with the tensors' own strides, so GQA and the
//     (B,S,H,hd) layout need no copy, and rows past Sq or Skv and columns
//     past hd load as zeros;
//   * S = Q K^T: wgmma m64n64k16 with both operands K-major in shared
//     memory, f32 accumulators in registers (a thread holds two rows, the
//     four lanes of a quad one row together);
//   * the online softmax on those registers: scale with log2(e) folded in
//     and exp2 (lse is stated in natural log), the masks applied only to
//     tiles that cross the diagonal or kv_len, the row max across the quad;
//   * O += P V: P goes from the S accumulators to bf16 A fragments in
//     registers (the accumulator layout of one k16 step is the A-fragment
//     layout), V is the B operand MN-major from the same swizzled tile
//     (wgmma's transpose bit), O stays in f32 registers and is rescaled by
//     the correction each tile;
//   * the epilogue writes o = acc / max(l, 1e-37) as bf16 pairs and lse.
// It takes every hd that is a multiple of 8 (16-byte TMA rows) up to 256,
// padded to the box width 64, 128, 192 or 256. Left for later: a producer
// warp with setmaxnreg, two ping-pong consumer warpgroups, and overlapping
// the softmax with the next tile's wgmma; until then two CTAs share an SM
// (80 KB of shared memory each at hd <= 128), so one CTA's softmax hides
// the other's products.
//
// float32: IEEE FMAs (flash_kernel). The f32 bar is 2e-5, so TF32 is ruled
// out and the f32 path stays off the tensor cores: Q, K and V tiles are
// staged in shared memory as float32 (rows past Sq or Skv and columns past
// hd are zero), S = Q K^T and P V are explicit fmaf (the library builds with
// --fmad=false), and each thread of a 16 x 16 grid owns rows ty + 16 i and
// keys tx + 16 j of S, and rows ty + 16 i and columns tx + 16 j of acc. A
// row's max and sum are reduced across the 16 lanes that hold it with warp
// shuffles. Ragged Sq and Skv are bounds checks.

#include <cuda.h>  // CUtensorMap; the encoder is reached through the runtime
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

namespace {

// -- float32: scalar IEEE FMAs ------------------------------------------------

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;  // a 16 x 16 grid: tx = tid % 16, ty = tid / 16

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

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

int dispatch_f32(const void* q, const void* k, const void* v, void* o,
                 float* lse, int b, int sq, int skv, int h, int kvh, int hd,
                 int q_offset, int kv_lim, int causal, cudaStream_t stream) {
  if (hd <= 32)
    return launch<float, 32>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                             q_offset, kv_lim, causal, stream);
  if (hd <= 64)
    return launch<float, 64>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                             q_offset, kv_lim, causal, stream);
  if (hd <= 96)
    return launch<float, 96>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                             q_offset, kv_lim, causal, stream);
  if (hd <= 128)
    return launch<float, 128>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                              q_offset, kv_lim, causal, stream);
  return launch<float, 256>(q, k, v, o, lse, b, sq, skv, h, kvh, hd,
                            q_offset, kv_lim, causal, stream);
}

// -- bfloat16: wgmma on TMA-fed tiles -----------------------------------------

constexpr int kRows = 64;                // query rows of a CTA: wgmma's M
constexpr int kKeys = 64;                // keys of a K/V tile
constexpr int kBoxCols = 64;             // bf16 columns of a 128-byte box row
constexpr int kBoxBytes = kRows * 128;   // one box of 64 rows (= kKeys rows)
constexpr int kWarpgroup = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// a wait this long (in SM clocks, ~9 s) means a TMA load never completed
constexpr long long kWaitLimit = 1LL << 34;

// Shared memory of one CTA: the Q tile, two K and two V tiles, the barriers
// (Q, then one per ring stage), and slack to align the tiles to the
// 1024 bytes of the swizzle pattern.
constexpr int tc_smem_bytes(int hdp) {
  return 5 * (hdp / kBoxCols) * kBoxBytes + 3 * 8 + 1024;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A barrier whose phase completes on one arrival and its transaction bytes.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(1)
               : "memory");
}

// Arrives on `bar` and makes its phase wait for `bytes` of TMA transfers.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes)
               : "memory");
}

// Waits until the phase of `bar` with the given parity has completed; traps
// (a launch failure, not a hang) if it never does.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  const long long t0 = clock64();
  for (;;) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > kWaitLimit) __trap();
  }
}

// One box of `map` at (column, head, row, batch) into shared memory at
// `dst`, completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int col, int head,
                                         int row, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col),
        "r"(head), "r"(row), "r"(batch)
      : "memory");
}

// Thread 0: K/V tile j of kv head kh into ring stage j % 2, completing on
// that stage's barrier.
template <int kBoxes>
__device__ __forceinline__ void load_kv(uint32_t s_k, uint32_t s_v,
                                        uint32_t bar_kv, const CUtensorMap* tk,
                                        const CUtensorMap* tv, int j, int kh,
                                        int b) {
  const uint32_t stage = j & 1;
  const uint32_t bar = bar_kv + 8 * stage;
  mbar_expect_tx(bar, 2 * kBoxes * kBoxBytes);
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    const uint32_t at = (stage * kBoxes + c) * kBoxBytes;
    tma_load(s_k + at, tk, bar, c * kBoxCols, kh, j * kKeys, b);
    tma_load(s_v + at, tv, bar, c * kBoxCols, kh, j * kKeys, b);
  }
}

// wgmma descriptor of a 128-byte-swizzled operand at `addr`: rows of 128
// bytes, 8-row groups 1024 bytes apart (stride byte offset), `lead` bytes
// between 64-column boxes (leading byte offset: read only for an MN-major
// operand wider than one box; 16 for a K-major one, as CUTLASS sets it).
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lead) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) |
         static_cast<uint64_t>((lead >> 4) & 0x3FFF) << 16 |
         static_cast<uint64_t>(1024 >> 4) << 32 | 1ull << 62;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving register reads or writes across an
// asynchronous wgmma that uses the registers.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void hold(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// d (64 x 64, f32) = or += A (64 x 16) B^T, A and B (64 x 16) K-major in
// shared memory.
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a,
                                         uint64_t desc_b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// d (64 x 64, f32) += A (64 x 16, bf16 fragments in registers) B, B
// (16 x 64) MN-major in shared memory.
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// HDP: hd rounded up to whole 64-column boxes (64, 128, 192 or 256). A
// thread holds rows r = 16 warp + lane / 4 and r + 8 of the tile; in the
// accumulator of an n8 block i, registers 4i, 4i+1 are row r at columns
// 8i + 2 (lane % 4) + {0, 1}, and 4i+2, 4i+3 row r + 8 at the same columns.
template <int HDP>
__global__ void __launch_bounds__(kWarpgroup)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                   int sq, int n_heads, int n_kv_heads, int hd, int q_offset,
                   int kv_lim, int causal, float scale_log2) {
  constexpr int kBoxes = HDP / kBoxCols;
  constexpr int kTile = kBoxes * kBoxBytes;  // bytes of a Q, K or V tile
  extern __shared__ uint8_t smem_tc[];
  const uint32_t s_q = (smem_addr(smem_tc) + 1023u) & ~1023u;
  const uint32_t s_k = s_q + kTile;          // ring stages 0, 1
  const uint32_t s_v = s_k + 2 * kTile;      // ring stages 0, 1
  const uint32_t bar_q = s_v + 2 * kTile;
  const uint32_t bar_kv = bar_q + 8;         // stage s at bar_kv + 8 s

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bh = blockIdx.x;
  const int b = bh / n_heads, head = bh % n_heads;
  const int kh = head / (n_heads / n_kv_heads);
  // the heaviest (last) causal tiles are scheduled first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  // keys at or past k_end are masked for every row of the tile
  const int q_last = min(q0 + kRows, sq) - 1;
  int k_end = kv_lim;
  if (causal) k_end = min(k_end, q_offset + q_last + 1);
  const int n_tiles = k_end > 0 ? (k_end + kKeys - 1) / kKeys : 0;

  if (tid == 0) {
    mbar_init(bar_q);
    mbar_init(bar_kv);
    mbar_init(bar_kv + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_expect_tx(bar_q, kTile);
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
      tma_load(s_q + c * kBoxBytes, &tq, bar_q, c * kBoxCols, head, q0, b);
    if (n_tiles > 0)
      load_kv<kBoxes>(s_k, s_v, bar_kv, &tk, &tv, 0, kh, b);
  }

  float acc[kBoxes][32];
#pragma unroll
  for (int c = 0; c < kBoxes; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[c][i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max, log2 units
  float l[2] = {0.f, 0.f};              // this thread's part of the row sum
  const int qpos = q_offset + q0 + warp * 16 + lane / 4;  // row r; r+8: +8
  const int col = 2 * (lane % 4);

  mbar_wait(bar_q, 0);
  for (int j = 0; j < n_tiles; ++j) {
    const uint32_t stage = j & 1;
    if (j + 1 < n_tiles) {
      // every warp is done with tile j - 1, whose stage the load refills
      __syncthreads();
      if (tid == 0)
        load_kv<kBoxes>(s_k, s_v, bar_kv, &tk, &tv, j + 1, kh, b);
    }
    mbar_wait(bar_kv + 8 * stage, (j >> 1) & 1);
    __syncwarp();

    // S = Q K^T over hd in k16 steps: +32 bytes within a box, then the
    // next box
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    hold(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t at = (kk / 4) * kBoxBytes + (kk % 4) * 32;
      wgmma_ss(s, sw128_desc(s_q + at, 16),
               sw128_desc(s_k + stage * kTile + at, 16), kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    hold(s);

    const int k0 = j * kKeys;
    if (k0 + kKeys > kv_lim || (causal && k0 + kKeys - 1 > q_offset + q0)) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            const int t = k0 + 8 * i + col + c;
            if (t >= kv_lim || (causal && t > qpos + 8 * h))
              s[4 * i + 2 * h + c] = -INFINITY;
          }
    }

    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        mx = fmaxf(mx, fmaxf(s[4 * i + 2 * h], s[4 * i + 2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[h], mx * scale_log2);
      const float safe_m = isfinite(m_new) ? m_new : 0.f;
      corr[h] = isfinite(m[h]) ? ex2(m[h] - safe_m) : 0.f;
      float rs = 0.f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float& x = s[4 * i + 2 * h + c];
          x = isfinite(x) ? ex2(fmaf(x, scale_log2, -safe_m)) : 0.f;
          rs = rs + x;
        }
      l[h] = l[h] * corr[h] + rs;
      m[h] = m_new;
    }
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        acc[c][4 * i] *= corr[0];
        acc[c][4 * i + 1] *= corr[0];
        acc[c][4 * i + 2] *= corr[1];
        acc[c][4 * i + 3] *= corr[1];
      }

    // O += P V: the accumulators of keys 16 kk .. 16 kk + 15 are the bf16
    // A fragment of k16 step kk; V's step kk is 16 rows (2048 bytes) down
    uint32_t pa[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
      hold(pa[kk]);
    }
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) hold(acc[c]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk)
#pragma unroll
      for (int c = 0; c < kBoxes; ++c)
        wgmma_rs(acc[c], pa[kk],
                 sw128_desc(s_v + stage * kTile + c * kBoxBytes + kk * 2048,
                            kBoxBytes));
    wgmma_commit();
    wgmma_wait_all();
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) hold(acc[c]);
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {  // the row sums across the quad
    l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] = l[h] + __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
  const long long q_stride = static_cast<long long>(n_heads) * hd;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + warp * 16 + lane / 4 + 8 * h;
    if (row >= sq) continue;
    const float denom = fmaxf(l[h], 1e-37f);
    __nv_bfloat16* orow = o + (static_cast<long long>(b) * sq + row) *
                                  q_stride + static_cast<long long>(head) * hd;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c)
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int d = c * kBoxCols + 8 * i + col;  // hd % 8 == 0: d + 1 < hd
        if (d < hd)
          *reinterpret_cast<uint32_t*>(orow + d) =
              pack_bf16(acc[c][4 * i + 2 * h] / denom,
                        acc[c][4 * i + 2 * h + 1] / denom);
      }
    if (lane % 4 == 0)
      lse[(static_cast<long long>(b) * sq + row) * n_heads + head] =
          isfinite(m[h]) ? m[h] * kLn2 + logf(denom) : -INFINITY;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime so the library
// needs no -lcuda; null if the installed CUDA does not offer it.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<EncodeTiled>(p);
  }();
  return fn;
}

// The tensor map of a contiguous bf16 tensor (batch, seq, heads, hd): 4-D
// over (hd, heads, seq, batch), boxes of 64 columns x 1 head x 64 rows,
// 128-byte swizzle, zeros outside the tensor.
bool encode(CUtensorMap* map, const void* ptr, int batch, int seq, int heads,
            int hd) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t row = static_cast<cuuint64_t>(hd) * 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {row, row * heads, row * heads * seq};
  const cuuint32_t box[4] = {kBoxCols, 1, kRows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HDP>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int b, int sq, int skv, int h, int kvh, int hd,
              int q_offset, int kv_lim, int causal, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  memset(&tk, 0, sizeof(tk));
  memset(&tv, 0, sizeof(tv));
  // with Skv = 0 no K/V tile is loaded, and a map of an empty tensor would
  // be refused
  if (!encode(&tq, q, b, sq, h, hd) ||
      (skv > 0 && (!encode(&tk, k, b, skv, kvh, hd) ||
                   !encode(&tv, v, b, skv, kvh, hd))))
    return static_cast<int>(cudaErrorNotSupported);
  constexpr int smem = tc_smem_bytes(HDP);
  auto kernel = flash_wgmma_kernel<HDP>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float scale_log2 = 1.0f / sqrtf(static_cast<float>(hd)) * kLog2e;
  const dim3 grid(b * h, (sq + kRows - 1) / kRows);
  kernel<<<grid, kWarpgroup, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), lse, sq, h, kvh, hd,
      q_offset, kv_lim, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

int dispatch_bf16(const void* q, const void* k, const void* v, void* o,
                  float* lse, int b, int sq, int skv, int h, int kvh, int hd,
                  int q_offset, int kv_lim, int causal, cudaStream_t stream) {
  if (hd <= 64)
    return launch_tc<64>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                         kv_lim, causal, stream);
  if (hd <= 128)
    return launch_tc<128>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                          kv_lim, causal, stream);
  if (hd <= 192)
    return launch_tc<192>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                          kv_lim, causal, stream);
  return launch_tc<256>(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                        kv_lim, causal, stream);
}

}  // namespace

// Launches the kernel on `stream` for contiguous q (B,Sq,H,hd) and k, v
// (B,Skv,KV,hd), writing o (B,Sq,H,hd) in their dtype and lse (B,Sq,H)
// float32. dtype: 0 float32 (hd <= 256), 1 bfloat16 (hd a multiple of 8 up
// to 256, q, k and v 16-byte aligned: TMA's rules). kv_lim = min(kv_len,
// Skv) (Skv when there is no kv_len). Returns the CUDA error code (0 on
// success); cudaErrorInvalidValue for a shape the kernel does not take,
// cudaErrorNotSupported if CUDA refuses a tensor map.
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
    return dispatch_f32(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                        kv_lim, causal, s);
  if (dtype == 1) {
    const uintptr_t bases = reinterpret_cast<uintptr_t>(q) |
                            reinterpret_cast<uintptr_t>(k) |
                            reinterpret_cast<uintptr_t>(v);
    if (hd % 8 != 0 || bases % 16 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    return dispatch_bf16(q, k, v, o, lse, b, sq, skv, h, kvh, hd, q_offset,
                         kv_lim, causal, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
