// One row tile of y[M, N] = A[M, K] @ x[K, N], computed by one block of
// kGemvThreads threads.  Shared by gemv.cu (one tile per block) and
// gemv_tiles.cu (tiles claimed in owner order by persistent blocks).
//
// A is float32 or bfloat16 and is read through its strides in one of two
// layouts, each with 16-byte loads along its contiguous axis:
//   row-major  A[m, k] at a[m * lda + k]  (stride_k == 1): warp w owns rows
//              w, w + 8, ... of the tile; lane l reads the 16-byte K vectors
//              l, l + 32, ... of each, and the warp sums its lanes by shuffles;
//   col-major  A[m, k] at a[m + k * lda]  (stride_m == 1, A = w.T of a
//              row-major w[K, M]): thread (g, v) reads the tile's 16-byte
//              M vector v of columns k = g, g + G, ... (G groups of threads
//              split K), and the G partial sums are added through shared
//              memory.  A warp reads whole 128-byte runs of a column.
// x[K, N] (row-major, N <= kMaxN) is staged as float32 in shared memory in
// chunks of kChunkK rows, transposed to [n][k], so K has no upper bound and
// no block asks for more than the default 48 KB.  Accumulation is float32 and
// the result is rounded once to A's dtype.  Every output element is summed by
// the same threads in the same order on every call: no atomics on values, so
// the result is the same from run to run.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kGemvThreads = 256;
constexpr int kGemvWarps = kGemvThreads / 32;
constexpr int kMaxN = 8;                                  // columns of x and y
constexpr int kMaxTileRows = 64;                          // rows of one tile
constexpr int kRowsPerWarp = kMaxTileRows / kGemvWarps;  // row-major layout
constexpr int kChunkK = 1024;                             // rows of x staged at a time
constexpr int kInFlight = 8;  // col-major: A vectors a thread loads before using them

struct GemvArgs {
  const void* a;
  const void* x;
  void* y;
  int M, K, N;
  long long lda;  // elements between rows (row-major) or columns (col-major) of A
};

// xs[n * kChunkK + k] = x[k0 + k, n] as float32, for k < kc and n < N.
template <typename T>
__device__ __forceinline__ void stage_x(const T* __restrict__ x, float* xs, int k0, int kc,
                                        int N) {
  const T* src = x + static_cast<long long>(k0) * N;
  for (int i = threadIdx.x; i < kc * N; i += kGemvThreads) {
    xs[(i % N) * kChunkK + i / N] = to_f32(src[i]);
  }
}

template <typename T>
__device__ void gemv_tile_row_major(const GemvArgs& p, int row0, int rows, float* xs) {
  constexpr int V = kVec<T>;
  const T* a = static_cast<const T*>(p.a);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float acc[kRowsPerWarp][kMaxN];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r)
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) acc[r][n] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kChunkK) {
    const int kc = min(kChunkK, p.K - k0);
    __syncthreads();  // every thread is done with the previous chunk
    stage_x(static_cast<const T*>(p.x), xs, k0, kc, p.N);
    __syncthreads();
    for (int v = lane; v < kc / V; v += 32) {
      uint4 raw[kRowsPerWarp];  // issue every row's load before using any
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int row = warp + r * kGemvWarps;
        if (row < rows) {
          raw[r] = *reinterpret_cast<const uint4*>(
              a + static_cast<long long>(row0 + row) * p.lda + k0 + v * V);
        }
      }
      float xv[kMaxN][V];
#pragma unroll
      for (int n = 0; n < kMaxN; ++n) {
        if (n < p.N) {
#pragma unroll
          for (int i = 0; i < V; i += 4) {
            const float4 f = *reinterpret_cast<const float4*>(xs + n * kChunkK + v * V + i);
            xv[n][i] = f.x, xv[n][i + 1] = f.y, xv[n][i + 2] = f.z, xv[n][i + 3] = f.w;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (warp + r * kGemvWarps < rows) {
          const T* e = reinterpret_cast<const T*>(&raw[r]);
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) {
            if (n < p.N) {
#pragma unroll
              for (int i = 0; i < V; ++i) acc[r][n] += to_f32(e[i]) * xv[n][i];
            }
          }
        }
      }
    }
  }
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    const int row = warp + r * kGemvWarps;
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) {
      float s = acc[r][n];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane == 0 && row < rows && n < p.N) {
        y[static_cast<long long>(row0 + row) * p.N + n] = from_f32<T>(s);
      }
    }
  }
}

// rows must be a multiple of the vector V, and row0 too.
template <typename T>
__device__ void gemv_tile_col_major(const GemvArgs& p, int row0, int rows, float* xs) {
  constexpr int V = kVec<T>;
  const int nvec = rows / V;                 // 16-byte vectors across the tile
  const int groups = kGemvThreads / nvec;    // threads that split K for one vector
  const int vi = threadIdx.x % nvec, g = threadIdx.x / nvec;
  const bool active = g < groups;
  const T* col = static_cast<const T*>(p.a) + row0 + vi * V;
  float acc[V][kMaxN];
#pragma unroll
  for (int i = 0; i < V; ++i)
#pragma unroll
    for (int n = 0; n < kMaxN; ++n) acc[i][n] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kChunkK) {
    const int kc = min(kChunkK, p.K - k0);
    __syncthreads();
    stage_x(static_cast<const T*>(p.x), xs, k0, kc, p.N);
    __syncthreads();
    if (!active) continue;
    for (int k = g; k < kc; k += groups * kInFlight) {
      uint4 raw[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k + u * groups;
        if (kk < kc) {
          raw[u] = *reinterpret_cast<const uint4*>(col + static_cast<long long>(k0 + kk) * p.lda);
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int kk = k + u * groups;
        if (kk < kc) {
          const T* e = reinterpret_cast<const T*>(&raw[u]);
#pragma unroll
          for (int n = 0; n < kMaxN; ++n) {
            if (n < p.N) {
              const float xn = xs[n * kChunkK + kk];
#pragma unroll
              for (int i = 0; i < V; ++i) acc[i][n] += to_f32(e[i]) * xn;
            }
          }
        }
      }
    }
  }
  // sum the groups' partials, one column n at a time, in group order
  T* y = static_cast<T*>(p.y);
#pragma unroll
  for (int n = 0; n < kMaxN; ++n) {
    if (n < p.N) {  // N is the same for every thread: the barriers are uniform
      __syncthreads();
      if (active) {
#pragma unroll
        for (int i = 0; i < V; ++i) xs[g * rows + vi * V + i] = acc[i][n];
      }
      __syncthreads();
      if (threadIdx.x < rows) {
        float s = 0.f;
        for (int gg = 0; gg < groups; ++gg) s += xs[gg * rows + threadIdx.x];
        y[static_cast<long long>(row0 + threadIdx.x) * p.N + n] = from_f32<T>(s);
      }
    }
  }
}

template <typename T, bool kColMajor>
__device__ __forceinline__ void gemv_tile(const GemvArgs& p, int row0, int rows, float* xs) {
  if constexpr (kColMajor) {
    gemv_tile_col_major<T>(p, row0, rows, xs);
  } else {
    gemv_tile_row_major<T>(p, row0, rows, xs);
  }
}

// Arguments both launch functions refuse: cudaErrorInvalidValue, else 0.
inline int gemv_check(const GemvArgs& p, int col_major, int dtype) {
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (p.M <= 0 || p.K <= 0 || p.N < 1 || p.N > kMaxN || p.K % vec != 0 || p.lda % vec != 0 ||
      (col_major && p.M % vec != 0)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace repro_torch
