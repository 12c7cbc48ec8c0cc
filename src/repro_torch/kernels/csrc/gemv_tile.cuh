// The streaming routine shared by gemv.cu and gemv_tiles.cu: one work item
// of y[M, N] = A[M, K] @ x[K, N], computed by one block of kThreads threads.
//
// Replaces the body of the TPU kernels src/repro/kernels/gemv.py::gemv_pallas
// and src/repro/kernels/gemv_tiles.py::gemv_tiles_pallas.  Both read A once
// and do 2 N FMAs per element of A (N <= 8), far below the tensor-core line,
// so they are bound by bytes: M K itemsize over 3.35 TB/s, 17.28 us at the
// path's gemma3-27b shard (A = w.T, 5376 x 5376 bf16, 57.8 MB).  A design
// of one block a whole row tile, its K loop draining every 1024 rows, was
// held back by four things; this one answers each:
//
//  1. Too few blocks (84 tiles on 132 SMs).  A work item is (row box, K
//     slice); the wrappers' gemv_plan splits K for about ITEMS_PER_SM items an
//     SM (336 items of 64 rows x 1344 at the gemma shard for gemv, 264 of
//     128 x 896 for gemv_tiles, 256 at the Table-1 shard), all resident at
//     once: a plan that spills into a second wave of blocks is slower.
//  2. A pipeline drained every 1024 rows of K.  The item's x slice is staged
//     once, as float32 padded to NP = 4 or 8 columns, while A's box streams
//     through a ring of kStages 8 KB stages (kStageVecs 16-byte vectors) by
//     16-byte cp.async.cg copies, one commit group a stage.  Inside an item
//     the ring never drains: each step waits for the oldest stage, passes the
//     one block barrier the ring needs, refills the slot used a step before
//     and computes the stage, so kStages - 1 of them (24 KB, 72 KB an SM at
//     three blocks) stay in flight.  cp.async rather than TMA: the box is a
//     plain strided 2D copy in either layout, the kernels are built against
//     cudart alone (no cuTensorMapEncodeTiled, no tensor map to cache per
//     pointer), and the copies cost no registers either way.
//  3. Short, scattered runs.  In the column-major layout (A = w.T of a
//     row-major w[K, M], read without a copy) a stage is kStageK consecutive
//     k rows of w, each a run of R itemsize bytes (128 B at R = 64 bf16,
//     512 B at R = 256); items of one K slice over neighbouring boxes are
//     launched together (gemv.cu).  In the row-major layout a stage is R rows
//     of A, each a run of kStageK elements.
//  4. A serial epilogue.  The item's sums meet through warp shuffles, one
//     barrier pair and a parallel sum over at most 8 partials (col-major), or
//     shuffles alone (row-major).
//
// Across K slices the item writes its float32 partial [rows, N] to a
// workspace [splits, M, N], makes it visible (__threadfence) and adds one to
// its box's arrival counter; the item that arrives last sums the partials in
// slice order 0..splits-1 (read with __ldcg, past L1) and writes y once,
// rounded to A's dtype.  No atomics on values, no block ever waits for
// another: the same bits on every call, and blocks that are not co-resident
// (four processes sharing the card) cannot deadlock.  With one split the item
// writes y itself.
//
// What was measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): 128-
// and 256-row boxes (runs of 256 and 512 B) are not faster than 64-row ones,
// and neither were deeper rings or L2 prefetch hints on the copies, tried
// while this design was built; the number of items against the resident
// blocks is what moves the time.  Device times are in gemv.cu, gemv_tiles.cu
// and PERF.md.
#pragma once

#include "common.cuh"

namespace repro_torch {

constexpr int kThreads = 256;
constexpr int kStages = 4;       // ring stages: kStages - 1 in flight while one is used
constexpr int kStageVecs = 512;  // 16-byte vectors of A a stage: 8 KB, two a thread
constexpr int kStageBytes = kStageVecs * 16;
constexpr int kMaxN = 8;         // columns of x and y
constexpr int kMaxRows = 256;    // rows of the largest box

// Arguments of one launch: the operands, the plan and the workspace.
struct GemvArgs {
  const void* a;
  const void* x;
  void* y;
  float* partials;   // [splits, M, N] float32, or null when splits == 1
  int* arrivals;     // one counter a box, zeroed before the launch (splits > 1)
  int M, K, N;
  long long lda;     // elements between rows (row-major) or columns (col-major) of A
  int splits, slice_k;
};

// Shapes of one ring stage (kStageVecs 16-byte vectors) for elements T and
// boxes of up to R rows.  A stage spans kStageK elements of K in both
// layouts: R x kStageK of A.
template <typename T, int R>
struct Box {
  static constexpr int V = kVec<T>;
  static constexpr int kStageElems = kStageVecs * V;
  static constexpr int kStageK = kStageElems / R;            // 64 bf16 at R = 64
  static constexpr int kVecsPerThread = kStageVecs / kThreads;
  // col-major: a line is one k row of w, R / V vectors; a thread keeps one
  // vector v of every kLineStride-th line
  static constexpr int kLineVecs = R / V;
  static constexpr int kLineStride = kThreads / kLineVecs;
  static constexpr int kParts = kLineVecs < 32 ? kThreads / 32 : kThreads / kLineVecs;
  // row-major: a line is one row of A, kRowVecs vectors along K
  static constexpr int kRowVecs = kStageK / V;
  static constexpr int kRowStride = kThreads / kRowVecs;
  static_assert(R % 64 == 0 && R <= kMaxRows, "boxes of 64, 128 or 256 rows");
  static_assert(kRowVecs >= 1 && kThreads % kLineVecs == 0, "a stage holds whole lines");
};

// Dynamic shared memory of one block: the ring (also the epilogue's scratch
// for kParts partials of the box), then x's slice [slice_k, NP] as float32.
template <typename T, int R, int NP>
constexpr int kRingBytes = kStages * kStageBytes > Box<T, R>::kParts * R * NP * 4
                               ? kStages * kStageBytes
                               : Box<T, R>::kParts * R * NP * 4;
template <typename T, int R, int NP>
constexpr long long gemv_smem_bytes(int slice_k) {
  return kRingBytes<T, R, NP> + static_cast<long long>(slice_k) * NP * 4;
}

// Copy the stage at K offset kb (within the item) of the box into ring slot `dst`.
template <typename T, bool kColMajor, int R>
__device__ __forceinline__ void load_stage(const GemvArgs& p, T* dst, int row0, int rows, int k0,
                                           int klen, int kb) {
  using B = Box<T, R>;
  const T* a = static_cast<const T*>(p.a);
#pragma unroll
  for (int j = 0; j < B::kVecsPerThread; ++j) {
    const int i = threadIdx.x + j * kThreads;
    if constexpr (kColMajor) {  // line = one k row of w, vector v along M
      const int line = i / B::kLineVecs, v = i % B::kLineVecs;
      const int k = kb + line;
      if (k < klen && v * B::V < rows) {
        cp_async16(dst + line * R + v * B::V,
                   a + row0 + v * B::V + static_cast<long long>(k0 + k) * p.lda);
      }
    } else {  // line = one row of A, vector v along K
      const int line = i / B::kRowVecs, v = i % B::kRowVecs;
      const int k = kb + v * B::V;
      if (line < rows && k < klen) {
        cp_async16(dst + line * B::kStageK + v * B::V,
                   a + static_cast<long long>(row0 + line) * p.lda + k0 + k);
      }
    }
  }
}

// Write one float32 result of the item: into y (one split) or its partial.
template <typename T>
__device__ __forceinline__ void put(const GemvArgs& p, int s, int row, int n, float v) {
  if (p.splits == 1) {
    static_cast<T*>(p.y)[static_cast<long long>(row) * p.N + n] = from_f32<T>(v);
  } else {
    p.partials[(static_cast<long long>(s) * p.M + row) * p.N + n] = v;
  }
}

template <int NP>
__device__ __forceinline__ void load_x(const float* xs, float (&xn)[NP]) {
#pragma unroll
  for (int n = 0; n < NP; n += 4) {
    const float4 f = *reinterpret_cast<const float4*>(xs + n);
    xn[n] = f.x, xn[n + 1] = f.y, xn[n + 2] = f.z, xn[n + 3] = f.w;
  }
}

// One item: rows [row0, row0 + rows) of y over K slice s, with its arrival at
// counter `box` when splits > 1.  smem holds the ring and x's slice.  Every
// thread of the block calls it; it ends with the block converged and the
// shared memory free for the next item.
template <typename T, bool kColMajor, int R, int NP>
__device__ void gemv_item(const GemvArgs& p, int row0, int rows, int s, int box,
                          unsigned char* smem) {
  using B = Box<T, R>;
  constexpr int V = B::V;
  T* ring = reinterpret_cast<T*>(smem);
  float* xs = reinterpret_cast<float*>(smem + kRingBytes<T, R, NP>);
  const int tid = threadIdx.x;
  const int k0 = s * p.slice_k;
  const int klen = min(p.slice_k, p.K - k0);
  const int n_stages = (klen + B::kStageK - 1) / B::kStageK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_stages) {
      load_stage<T, kColMajor, R>(p, ring + st * B::kStageElems, row0, rows, k0, klen,
                                  st * B::kStageK);
    }
    cp_async_commit();
  }
  // x's slice as float32 [klen, NP] while the first stages are in flight
  const T* xg = static_cast<const T*>(p.x) + static_cast<long long>(k0) * p.N;
  for (int i = tid; i < klen * NP; i += kThreads) {
    const int k = i / NP, n = i % NP;
    xs[i] = n < p.N ? to_f32(xg[k * p.N + n]) : 0.f;
  }

  // col-major: acc[e][n] for the V rows of vector v; row-major: acc[j][n]
  // for rows line0 + j kRowStride, each thread one 16-byte column of a stage
  constexpr int kAccRows = kColMajor ? V : B::kVecsPerThread;
  float acc[kAccRows][NP];
#pragma unroll
  for (int r = 0; r < kAccRows; ++r)
#pragma unroll
    for (int n = 0; n < NP; ++n) acc[r][n] = 0.f;
  const int v = kColMajor ? tid % B::kLineVecs : tid % B::kRowVecs;
  const int line0 = kColMajor ? tid / B::kLineVecs : tid / B::kRowVecs;

  for (int it = 0; it < n_stages; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // stage `it` landed for every thread; slot it - 1 is free
    const int nxt = it + kStages - 1;
    if (nxt < n_stages) {
      load_stage<T, kColMajor, R>(p, ring + (nxt % kStages) * B::kStageElems, row0, rows, k0,
                                  klen, nxt * B::kStageK);
    }
    cp_async_commit();
    const T* st = ring + (it % kStages) * B::kStageElems;
    const int kb = it * B::kStageK;
    if constexpr (kColMajor) {
      if (v * V < rows) {
#pragma unroll
        for (int j = 0; j < B::kVecsPerThread; ++j) {
          const int line = line0 + j * B::kLineStride;
          if (kb + line < klen) {
            const uint4 raw = *reinterpret_cast<const uint4*>(st + line * R + v * V);
            const T* e = reinterpret_cast<const T*>(&raw);
            float xn[NP];
            load_x<NP>(xs + (kb + line) * NP, xn);
#pragma unroll
            for (int i = 0; i < V; ++i) {
              const float ai = to_f32(e[i]);
#pragma unroll
              for (int n = 0; n < NP; ++n) acc[i][n] += ai * xn[n];
            }
          }
        }
      }
    } else {
      if (kb + v * V < klen) {
        uint4 raw[B::kVecsPerThread];
#pragma unroll
        for (int j = 0; j < B::kVecsPerThread; ++j) {
          const int line = line0 + j * B::kRowStride;
          if (line < rows) {
            raw[j] = *reinterpret_cast<const uint4*>(st + line * B::kStageK + v * V);
          }
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          float xn[NP];
          load_x<NP>(xs + (kb + v * V + i) * NP, xn);
#pragma unroll
          for (int j = 0; j < B::kVecsPerThread; ++j) {
            if (line0 + j * B::kRowStride < rows) {
              const float aj = to_f32(reinterpret_cast<const T*>(&raw[j])[i]);
#pragma unroll
              for (int n = 0; n < NP; ++n) acc[j][n] += aj * xn[n];
            }
          }
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every thread is done with the ring: it becomes scratch

  if constexpr (kColMajor) {
    // lanes of one warp that share v hold partials of the same rows
    constexpr int kLanesPerV = B::kLineVecs < 32 ? 32 / B::kLineVecs : 1;
#pragma unroll
    for (int off = B::kLineVecs; off < 32; off <<= 1)
#pragma unroll
      for (int r = 0; r < V; ++r)
#pragma unroll
        for (int n = 0; n < NP; ++n) acc[r][n] += __shfl_xor_sync(0xffffffffu, acc[r][n], off);
    const int h = kLanesPerV > 1 ? tid / 32 : tid / B::kLineVecs;
    float* part = reinterpret_cast<float*>(smem);  // [kParts][R][NP]
    if ((kLanesPerV == 1 || tid % 32 < B::kLineVecs) && v * V < rows) {
#pragma unroll
      for (int r = 0; r < V; ++r)
#pragma unroll
        for (int n = 0; n < NP; ++n) part[(h * R + v * V + r) * NP + n] = acc[r][n];
    }
    __syncthreads();
    for (int o = tid; o < rows * p.N; o += kThreads) {
      const int r = o / p.N, n = o % p.N;
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < B::kParts; ++q) sum += part[(q * R + r) * NP + n];
      put<T>(p, s, row0 + r, n, sum);
    }
  } else {
#pragma unroll
    for (int off = 1; off < B::kRowVecs; off <<= 1)
#pragma unroll
      for (int j = 0; j < B::kVecsPerThread; ++j)
#pragma unroll
        for (int n = 0; n < NP; ++n) acc[j][n] += __shfl_xor_sync(0xffffffffu, acc[j][n], off);
    if (v == 0) {
#pragma unroll
      for (int j = 0; j < B::kVecsPerThread; ++j) {
        const int line = line0 + j * B::kRowStride;
        if (line < rows) {
#pragma unroll
          for (int n = 0; n < NP; ++n) {
            if (n < p.N) put<T>(p, s, row0 + line, n, acc[j][n]);
          }
        }
      }
    }
  }

  if (p.splits > 1) {
    __shared__ int last;
    __threadfence();  // this thread's partials are visible before the arrival
    __syncthreads();
    if (tid == 0) last = atomicAdd(p.arrivals + box, 1) == p.splits - 1;
    __syncthreads();
    if (last) {  // every other slice of the box has arrived: sum in slice order
      __threadfence();
      T* y = static_cast<T*>(p.y);
      for (int o = tid; o < rows * p.N; o += kThreads) {
        const long long at = static_cast<long long>(row0) * p.N + o;
        float sum = 0.f;
        for (int q = 0; q < p.splits; ++q) {
          sum += __ldcg(p.partials + static_cast<long long>(q) * p.M * p.N + at);
        }
        y[at] = from_f32<T>(sum);
      }
    }
  }
  __syncthreads();  // the shared memory is free for the block's next item
}

// Arguments both launch functions refuse: cudaErrorInvalidValue, else 0.
inline int gemv_check(const GemvArgs& p, int col_major, int dtype) {
  if (dtype != kFloat32 && dtype != kBFloat16) return static_cast<int>(cudaErrorInvalidValue);
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (p.M <= 0 || p.K <= 0 || p.N < 1 || p.N > kMaxN || p.K % vec != 0 || p.lda % vec != 0 ||
      (col_major && p.M % vec != 0) || p.splits < 1 || p.slice_k < vec ||
      p.slice_k % vec != 0 || static_cast<long long>(p.splits - 1) * p.slice_k >= p.K ||
      static_cast<long long>(p.splits) * p.slice_k < p.K ||
      (p.splits > 1 && (p.partials == nullptr || p.arrivals == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

// The smallest box template that holds `rows`: 64, 128 or 256, else 0.
inline int box_rows(int rows) {
  return rows <= 64 ? 64 : rows <= 128 ? 128 : rows <= kMaxRows ? 256 : 0;
}

// f.template run<T, kColMajor, R, NP>() for the runtime dtype, layout, box
// rows (rounded up to 64, 128 or 256) and N (NP = 4 for N <= 4, else 8).
template <typename F, typename T, bool kColMajor, int R>
int dispatch_np(const F& f, int N) {
  return N <= 4 ? f.template run<T, kColMajor, R, 4>() : f.template run<T, kColMajor, R, 8>();
}

template <typename F, typename T, bool kColMajor>
int dispatch_rows(const F& f, int rows, int N) {
  switch (box_rows(rows)) {
    case 64: return dispatch_np<F, T, kColMajor, 64>(f, N);
    case 128: return dispatch_np<F, T, kColMajor, 128>(f, N);
    case 256: return dispatch_np<F, T, kColMajor, 256>(f, N);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename F, typename T>
int dispatch_layout(const F& f, int col_major, int rows, int N) {
  return col_major ? dispatch_rows<F, T, true>(f, rows, N)
                   : dispatch_rows<F, T, false>(f, rows, N);
}

template <typename F>
int dispatch(const F& f, int dtype, int col_major, int rows, int N) {
  return dtype == kFloat32 ? dispatch_layout<F, float>(f, col_major, rows, N)
                           : dispatch_layout<F, __nv_bfloat16>(f, col_major, rows, N);
}

}  // namespace repro_torch
