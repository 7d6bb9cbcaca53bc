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
// Two dp rows, ping-pong: a bundle step reads the old row at j - pb and
// writes the new row, so no column it writes is one that it or any other
// thread reads in the same step. Every column does the host's add, compare
// and select on the host's operands (the old row's), so the result is the
// in-place update's bit for bit. One barrier ends a finite bundle's step:
// it orders the step's writes before the next step's reads, and the step's
// reads before the next step overwrites the old row. A non-finite bundle
// is uniform across the CTA: it writes a zero bits row, and neither swaps
// the rows nor waits, unless it is the last bundle of a chunk (below):
// barriers = finite bundles + non-finite bundles that end a chunk.
//
// No step opens with a load from global memory. The bundles reach the
// steps through shared memory, kChunk at a time, double-buffered: at the
// first step of a chunk, thread t < kChunk loads bundle t of the next chunk
// into registers and stores it to the other buffer after the step's
// columns, so the load's latency hides under the step; the last step of a
// chunk always ends with a barrier, which makes the next chunk visible and
// frees the buffer it read. A step reads its bundle from shared memory (a
// prefetch into a register does not survive the compiler, which moves the
// uniform value into a uniform register at the load).
//
// What a step costs is issue slots: the columns of a step are independent,
// so a step is T columns of instructions spread over the CTA's warps. Up
// to T = kRegWidth a thread keeps its own columns (j = 1 + tid + k *
// Threads) in registers: dp[j] is a register, dp[j - pb] the one shared
// load, predicated, with -0.0 where j < pb (-0.0 + cb is cb, bit for bit,
// so the candidate needs no select), and the new value is stored whether
// or not it changed (cheaper than the test). The count of columns every
// thread owns is uniform across the CTA: it picks one unrolled bundle
// loop, once; only the last, partial column is guarded. Wider rows stream
// through both rows (cover_dp_stream).

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace kubepacs {

constexpr int kThreads = 384;
constexpr int kPerThread = 4;
// the widest target whose columns a CTA keeps in registers
constexpr int kRegWidth = 8192;
// bundles staged in shared memory at a time (<= every CTA width)
constexpr int kChunk = 128;

// The caller's shared memory for the staged bundles: two chunks.
struct Stage {
  long long pods[2][kChunk];
  double cost[2][kChunk];
};

// The staged bundles of one DP: `bundles` read kChunk at a time into a
// Stage, double-buffered. Every thread must call begin() once and, at
// each step b in order, load(b) before the step's work and store(b) after
// it; the step must end with a barrier when last_of_chunk(b).
template <class Bundles>
struct Staged {
  const Bundles& bundles;
  Stage& st;
  int nb;
  long long np = 0;                  // this thread's bundle of the next chunk
  double nc = 0.0;
  bool have = false;

  // Stages chunk 0 (visible after the caller's next barrier).
  __device__ void begin() {
    const int t = threadIdx.x;
    if (t < kChunk && t < nb) {
      st.pods[0][t] = bundles.pods(t);
      st.cost[0][t] = bundles.cost(t);
    }
  }
  __device__ static bool last_of_chunk(int b) {
    return b % kChunk == kChunk - 1;
  }
  // Bundle b's pods and cost; at a chunk's first step, starts the loads of
  // this thread's bundle of the next chunk.
  __device__ void load(int b, long long* p, double* c) {
    const int slot = b % kChunk, buf = (b / kChunk) & 1;
    have = false;
    if (slot == 0) {
      const int next = b + kChunk + static_cast<int>(threadIdx.x);
      if (threadIdx.x < kChunk && next < nb) {
        np = bundles.pods(next);
        nc = bundles.cost(next);
        have = true;
      }
    }
    *p = st.pods[buf][slot];
    *c = st.cost[buf][slot];
  }
  // Stores the next chunk's bundle once the step's work is issued.
  __device__ void store(int b) {
    if (have) {
      const int buf = ((b / kChunk) & 1) ^ 1;
      st.pods[buf][threadIdx.x] = np;
      st.cost[buf][threadIdx.x] = nc;
    }
  }
};

// One bundle step over a thread's columns j = j0 + k * Threads: N of them
// that every thread owns, then the one more that only the threads with
// j <= last own (`tail`). `src` is the old row shifted by pb (read where
// j >= pb), `dst` the new row, `brow` the bits row or null.
template <int N, int Threads, int kCols>
__device__ __forceinline__ void regs_step(double (&d)[kCols], int j0, int p,
                                          bool tail, double c,
                                          const double* src, double* dst,
                                          unsigned char* brow) {
  constexpr int M = N < kCols ? N + 1 : N;   // columns with the tail
  double s[M];
#pragma unroll
  for (int k = 0; k < M; ++k) {
    s[k] = -0.0;                     // -0.0 + c is c: the j < pb candidate
    if ((k < N || tail) && j0 + k * Threads >= p) s[k] = src[k * Threads];
  }
#pragma unroll
  for (int k = 0; k < M; ++k) {
    if (k == N && !tail) break;
    const double cand = s[k] + c;
    const bool take = cand < d[k];
    d[k] = take ? cand : d[k];
    dst[k * Threads] = d[k];
    if (brow) brow[k * Threads] = take;
  }
}

// The bundle loop of cover_dp_regs for N columns every thread owns;
// returns the row that holds dp.
template <int N, int Threads, int kCols, class Bundles>
__device__ __forceinline__ double* regs_loop(Staged<Bundles>& sb, int last,
                                             int j0, bool tail,
                                             double (&d)[kCols], double* cur,
                                             double* nxt,
                                             unsigned char* bits) {
  const int tid = threadIdx.x;
  const int width = last + 1;
  unsigned char* brow = bits;        // bundle b's bits row, or null
  for (int b = 0; b < sb.nb; ++b, brow = bits ? brow + width : nullptr) {
    long long pb;
    double c;
    sb.load(b, &pb, &c);
    const bool finite = isfinite(c);
    if (finite) {
      const int p = pb > last ? last + 1 : static_cast<int>(pb);
      regs_step<N, Threads>(d, j0, p, tail, c, cur + (j0 - p), nxt + j0,
                            brow ? brow + j0 : nullptr);
      if (brow && tid == 0) brow[0] = 0;
    } else if (brow) {               // uniform across the CTA: no barrier
      for (int j = tid; j <= last; j += Threads) brow[j] = 0;
    }
    sb.store(b);
    if (finite || Staged<Bundles>::last_of_chunk(b)) __syncthreads();
    if (finite) {
      double* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  return cur;
}

// regs_loop for the n_full that the CTA's row gives (uniform), chosen once.
template <int N, int Threads, int kCols, class Bundles>
__device__ __forceinline__ double* regs_dispatch(int n_full,
                                                 Staged<Bundles>& sb,
                                                 int last, int j0, bool tail,
                                                 double (&d)[kCols],
                                                 double* row, double* alt,
                                                 unsigned char* bits) {
  if constexpr (N < kCols) {
    if (n_full != N) {
      return regs_dispatch<N + 1, Threads>(n_full, sb, last, j0, tail, d,
                                           row, alt, bits);
    }
  }
  return regs_loop<N, Threads>(sb, last, j0, tail, d, row, alt, bits);
}

// The recurrence with the row's columns in registers, T <= kRegWidth.
template <int Threads, class Bundles>
__device__ __forceinline__ void cover_dp_regs(const Bundles& bundles, int nb,
                                              int last, double* row,
                                              double* alt,
                                              unsigned char* bits,
                                              Stage& st) {
  constexpr int kCols = (kRegWidth + Threads - 1) / Threads;
  const int tid = threadIdx.x;
  const int j0 = 1 + tid;
  const int n_full = last / Threads;         // columns every thread owns
  const bool tail = j0 + n_full * Threads <= last;
  double d[kCols];
#pragma unroll
  for (int k = 0; k < kCols; ++k) {
    d[k] = CUDART_INF;
    if (k < n_full || (k == n_full && tail)) {
      row[j0 + k * Threads] = CUDART_INF;
    }
  }
  if (tid == 0) {
    row[0] = 0.0;
    alt[0] = 0.0;                    // column 0 is never written again
  }
  Staged<Bundles> sb{bundles, st, nb};
  sb.begin();
  __syncthreads();

  double* cur = regs_dispatch<0, Threads>(n_full, sb, last, j0, tail, d,
                                          row, alt, bits);
  if (cur != row) {                  // uniform: the count of swaps
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      if (k < n_full || (k == n_full && tail)) row[j0 + k * Threads] = d[k];
    }
  }
  __syncthreads();   // row, and the bits rows of non-finite bundles
}

// The recurrence streamed through both rows, for any T: a thread takes up
// to kPerThread columns Threads apart per pass.
template <int Threads, class Bundles>
__device__ __forceinline__ void cover_dp_stream(const Bundles& bundles,
                                                int nb, int last,
                                                double* row, double* alt,
                                                unsigned char* bits,
                                                Stage& st) {
  constexpr int kTile = Threads * kPerThread;
  const int tid = threadIdx.x;
  const int width = last + 1;
  for (int j = tid; j <= last; j += Threads) {
    row[j] = j == 0 ? 0.0 : CUDART_INF;
  }
  if (tid == 0) alt[0] = 0.0;        // column 0 is never written again
  Staged<Bundles> sb{bundles, st, nb};
  sb.begin();
  __syncthreads();

  double* cur = row;
  double* nxt = alt;
  unsigned char* brow = bits;        // bundle b's bits row, or null
  for (int b = 0; b < nb; ++b, brow = bits ? brow + width : nullptr) {
    long long p;
    double c;
    sb.load(b, &p, &c);
    const bool finite = isfinite(c);
    if (finite) {
      for (int base = 1; base <= last; base += kTile) {
        double d[kPerThread], s[kPerThread];
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int j = base + k * Threads + tid;
          if (j <= last) {
            d[k] = cur[j];
            s[k] = j >= p ? cur[j - p] : 0.0;
          }
        }
#pragma unroll
        for (int k = 0; k < kPerThread; ++k) {
          const int j = base + k * Threads + tid;
          if (j <= last) {
            const double cand = j >= p ? s[k] + c : c;
            const bool take = cand < d[k];
            nxt[j] = take ? cand : d[k];
            if (brow) brow[j] = take;
          }
        }
      }
      if (brow && tid == 0) brow[0] = 0;
    } else if (brow) {               // uniform across the CTA: no barrier
      for (int j = tid; j <= last; j += Threads) brow[j] = 0;
    }
    sb.store(b);
    if (finite || Staged<Bundles>::last_of_chunk(b)) __syncthreads();
    if (finite) {
      double* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
  if (cur != row) {                  // uniform: the count of swaps
    for (int j = tid; j <= last; j += Threads) row[j] = cur[j];
  }
  __syncthreads();   // the copy, and the bits rows of non-finite bundles
}

// Runs the DP with the whole calling CTA (blockDim.x == Threads, 384 for
// cover_dp.cu, 768 for fused_rows.cu, each the fastest width of the one-off
// runs of tools/cta_threads.py; every thread must call it).
// `bundles.pods(b)` and `bundles.cost(b)` give bundle b (nb < 2^31); `row`
// and `alt` hold T + 1 doubles each (shared or global memory, not
// overlapping) and `row` ends as dp; `alt` is scratch, and so is `st`
// (shared memory). `bits`, when not null, receives nb rows of T + 1 bytes.
// Ends with a barrier, so every thread may read `row` and `bits` on return.
// Inlined, so that rows the caller takes from shared memory compile to
// shared loads and stores.
template <int Threads = kThreads, class Bundles>
__device__ __forceinline__ void cover_dp_block(const Bundles& bundles,
                                               long long nb, long long T,
                                               double* row, double* alt,
                                               unsigned char* bits,
                                               Stage& st) {
  static_assert(Threads >= kChunk, "a thread stages at most one bundle");
  if (T <= kRegWidth) {
    cover_dp_regs<Threads>(bundles, static_cast<int>(nb),
                           static_cast<int>(T), row, alt, bits, st);
  } else {
    cover_dp_stream<Threads>(bundles, static_cast<int>(nb),
                             static_cast<int>(T), row, alt, bits, st);
  }
}

}  // namespace kubepacs
