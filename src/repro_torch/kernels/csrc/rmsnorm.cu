// Fused RMSNorm for Hopper (sm_90a), one memory round trip a row.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (pallas_call at :44, body _kernel).  Per row of x[R, D]:
//     y = x * rsqrt(mean(x^2) + eps) * (1 + gamma)
// computed in float32 and stored in x's dtype (float32 or bfloat16); gamma has
// x's dtype.  The scale is (1 + gamma), as in src/repro/models/common.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the function reads x
// and gamma once and writes y once.  On the zamba2-2.7b decode path x is
// [4, 1, 2560] bf16: 4*2560*2 + 2560*2 + 4*2560*2 = 46,080 bytes, 0.014 us;
// the ~5 flops an element are less still.  So a call is bound by its launch:
// the empty kernel (csrc/empty.cu) takes about 0.87 us of device time, and
// all a norm can add to that is the latency of its dependent steps.
//
// Design: the latency is a chain of steps, and the design makes it short.
//  - One memory round trip.  Each thread issues every 16-byte load it needs,
//    of x and of gamma, at its start, into registers: NV vectors of each, a
//    compile-time 1, 2, 4 or 8 that the wrapper (kernels/rmsnorm.py) chooses
//    from D.  Nothing is read twice; gamma (on the serve path a different
//    layer's vector every launch, so cold) is in flight beside x instead of
//    after the reduction.
//  - One barrier.  Squares are summed in float32 in a fixed order (a
//    thread's vectors in turn, then a butterfly of warp shuffles, which
//    leaves every lane the same bits).  Each warp writes its partial to
//    shared memory, one __syncthreads, and every thread sums the partials in
//    the same order: no thread-0 pass, no second barrier.
//  - The result is the same bits from run to run (no atomics, fixed orders).
// A CTA a row: ceil(D / (8 NV)) threads (bf16; 4 NV float32) rounded up to a
// warp, at most kMaxThreads.  A warp a row (no barrier, where a row fits in
// 32 x 8 vectors) was measured slower at every width it takes (PERF.md).
// About the launch itself the kernel can do nothing: fusing the norm into its
// neighbours or replaying the decode step as a CUDA graph is later work.
//
// The backward (rmsnorm_bwd_kernel) replaces no Pallas kernel: the reference
// differentiates its rms_norm (src/repro/models/common.py:244) through XLA.
// Per row, in float32, with r = rsqrt(mean(x^2) + eps) and w = 1 + gamma, for
// the output's gradient g:
//     dx = r * (g * w) - x * r^3 * mean(g * w * x)      (stored in x's dtype)
//     dgamma = sum over rows of g * (x * r)             (float32, then gamma's dtype)
// Bound: it reads x and g and writes dx once (gamma and dgamma are one row):
// at [2048, 1152] bf16, 14.2 MB, 4.2 us at 3.35 TB/s; about 10 flops an
// element are far below the float32 peak.  So a call is bound by its bytes and
// by the round trips of its chains.  Design, one launch:
//  - Rows: a CTA takes the forward's thread layout (a row over its threads, nv
//    16-byte vectors a thread) and a run of consecutive rows in blocks of R:
//    every load of a block's R rows of x and g is in flight at once, into
//    registers, and the block's 2R row sums meet at one barrier (the sums by
//    warp double-buffered by block parity, so no second one).  [2048, 1152]
//    on 132 SMs: 256 CTAs of 160 threads, 2 blocks of 4 rows each.
//  - dgamma in the same launch, the same bits every run, no float atomics and
//    no memset: each thread keeps its columns' float32 sums over the CTA's
//    rows in registers and writes them to the CTA's row of a float32
//    workspace.  An integer ticket counts the CTAs done; the last `reducers`
//    (up to 64) to take one wait for the count, then each adds the
//    workspace's rows of its chunk of columns in CTA order (slices of rows
//    a thread, then a fixed tree over the slices).  A second ticket counts
//    the reducers past their wait, and the last sets both back to 0.
// Measured against this design on the card (PERF.md): one warp a row
// with the rows staged in shared memory by TMA bulk copies or cp.async, and
// the CTAs' sums combined through a cluster's distributed shared memory,
// took 2.8x as long (clusters of 8 reach 120 of the 132 SMs, and their
// barriers wait for the cluster's slowest CTA); 64-bit integer atomics into
// fixed-point sums took 3.2x.
//
// C interface (bound with ctypes): rmsnorm_launch and rmsnorm_bwd_launch
// return the launch's error (cudaGetLastError() after it), or
// cudaErrorInvalidValue for arguments they do not take.

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kMaxThreads = 256;  // threads a row at most

template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* out) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) out[i] = to_f32(e[i]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// NV vectors of a row for one thread: columns first, first + stride, ...
// Columns past the row load zeros, whose squares add exactly nothing.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               T* __restrict__ y, int d, float eps) {
  constexpr int N = kVec<T>;
  const int nvec = d / N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int64_t row = blockIdx.x;
  const int first = threadIdx.x;
  const int stride = blockDim.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  uint4 xv[NV], gv[NV];
#pragma unroll
  for (int i = 0; i < NV; ++i) {  // every load in flight before any use
    const int c = first + i * stride;
    if (c < nvec) {
      xv[i] = *reinterpret_cast<const uint4*>(xr + c * N);
      gv[i] = __ldg(reinterpret_cast<const uint4*>(gamma + c * N));
    } else {
      xv[i] = make_uint4(0u, 0u, 0u, 0u);
      gv[i] = xv[i];
    }
  }

  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float v[N];
    unpack<T>(xv[i], v);
#pragma unroll
    for (int e = 0; e < N; ++e) ss += v[e] * v[e];
  }
  ss = warp_sum(ss);

  __shared__ float partial[kMaxThreads / 32];
  if (lane == 0) partial[warp] = ss;
  __syncthreads();
  float total = 0.f;
  const int warps = blockDim.x / 32;
  for (int w = 0; w < warps; ++w) total += partial[w];  // the same order everywhere
  const float r = rsqrtf(total / static_cast<float>(d) + eps);

#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * stride;
    if (c < nvec) {
      float v[N], g[N];
      unpack<T>(xv[i], v);
      unpack<T>(gv[i], g);
#pragma unroll
      for (int e = 0; e < N; ++e) v[e] = (v[e] * r) * (1.f + g[e]);
      store_vec(yr + c * N, v);
    }
  }
}

template <typename T, int NV>
cudaError_t launch_nv(const T* x, const T* gamma, T* y, int rows, int d, float eps,
                      cudaStream_t s) {
  const int nvec = d / kVec<T>;
  const int threads = ((nvec + NV - 1) / NV + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  rmsnorm_kernel<T, NV><<<rows, threads, 0, s>>>(x, gamma, y, d, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* gamma, void* y, int rows, int d, float eps,
                   int nv, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  T* yp = static_cast<T*>(y);
  switch (nv) {
    case 1: return launch_nv<T, 1>(xp, gp, yp, rows, d, eps, s);
    case 2: return launch_nv<T, 2>(xp, gp, yp, rows, d, eps, s);
    case 4: return launch_nv<T, 4>(xp, gp, yp, rows, d, eps, s);
    case 8: return launch_nv<T, 8>(xp, gp, yp, rows, d, eps, s);
    default: return cudaErrorInvalidValue;
  }
}


// ---------------------------------------------------------------------------
// The backward (see the head of the file).

constexpr int kBwdMaxThreads = 256;  // threads a CTA (kMaxThreads: a row of the forward)
constexpr long long kSpinLimit = 1ll << 24;  // polls (~100 ns each) before a waiting CTA traps
constexpr int kReduceBatch = 8;  // workspace rows a reducer's thread loads at once

// A reducer's wait for every CTA's ticket.  Only the last `reducers` (<= 64)
// CTAs to finish wait, so the CTAs not yet done always have SMs to run on; a
// grid that cannot finish anyway traps (an error of the launch), no hang.
__device__ __forceinline__ void wait_for_tickets(const int* count, int ctas) {
  long long polls = 0;
  while (*reinterpret_cast<const volatile int*>(count) < ctas) {
    __nanosleep(64);
    if (++polls > kSpinLimit) __trap();
  }
}

// The backward of rows_per_cta consecutive rows a CTA, R rows a block.
template <typename T, int NV, int R>
__global__ void __launch_bounds__(kBwdMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const T* __restrict__ g, T* __restrict__ dx, T* __restrict__ dgamma,
                   float* __restrict__ ws, int* __restrict__ tickets, int rows, int d,
                   float eps, int rows_per_cta, int reducers) {
  constexpr int N = kVec<T>;
  __shared__ float2 red[2][R][kBwdMaxThreads / 32];  // a block's row sums by warp, by parity
  __shared__ float4 fin[kBwdMaxThreads];  // a reducer's slices of its columns
  __shared__ int reducer;

  const int nvec = d / N;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t row1 = row0 + rows_per_cta < rows ? row0 + rows_per_cta : rows;

  uint4 gv[NV];  // gamma, the same for every row
  float acc[NV][N];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    gv[i] = c < nvec ? __ldg(reinterpret_cast<const uint4*>(gamma + c * N))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;
  }

  for (int64_t rb = row0, parity = 0; rb < row1; rb += R, parity ^= 1) {
    uint4 xv[R][NV], dv[R][NV];
#pragma unroll
    for (int r = 0; r < R; ++r) {  // every load of the block in flight before any use
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = threadIdx.x + i * blockDim.x;
        if (rb + r < row1 && c < nvec) {
          xv[r][i] = *reinterpret_cast<const uint4*>(x + (rb + r) * d + c * N);
          dv[r][i] = *reinterpret_cast<const uint4*>(g + (rb + r) * d + c * N);
        } else {
          xv[r][i] = make_uint4(0u, 0u, 0u, 0u);
          dv[r][i] = xv[r][i];
        }
      }
    }
    float2 sums[R];  // sum x^2, sum g w x; columns past the row add exact zeros
#pragma unroll
    for (int r = 0; r < R; ++r) {
      sums[r] = make_float2(0.f, 0.f);
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        float v[N], gg[N], w[N];
        unpack<T>(xv[r][i], v);
        unpack<T>(dv[r][i], gg);
        unpack<T>(gv[i], w);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          sums[r].x += v[e] * v[e];
          sums[r].y += (gg[e] * (1.f + w[e])) * v[e];
        }
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {  // every lane the same bits
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sums[r].x += __shfl_xor_sync(0xffffffffu, sums[r].x, off);
        sums[r].y += __shfl_xor_sync(0xffffffffu, sums[r].y, off);
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) red[parity][r][warp] = sums[r];
    }
    __syncthreads();  // one barrier a block; red by parity, so none after it
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (rb + r >= row1) break;
      float tss = 0.f, tsgwx = 0.f;
      for (int k = 0; k < warps; ++k) {  // the same order everywhere
        tss += red[parity][r][k].x;
        tsgwx += red[parity][r][k].y;
      }
      const float rr = rsqrtf(tss / static_cast<float>(d) + eps);
      const float c3 = rr * rr * rr * (tsgwx / static_cast<float>(d));
      T* dxr = dx + (rb + r) * d;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int c = threadIdx.x + i * blockDim.x;
        if (c < nvec) {
          float v[N], gg[N], w[N], out[N];
          unpack<T>(xv[r][i], v);
          unpack<T>(dv[r][i], gg);
          unpack<T>(gv[i], w);
#pragma unroll
          for (int e = 0; e < N; ++e) {
            out[e] = rr * (gg[e] * (1.f + w[e])) - v[e] * c3;
            acc[i][e] += gg[e] * (v[e] * rr);
          }
          store_vec(dxr + c * N, out);
        }
      }
    }
  }

  // dgamma: this CTA's column sums to its workspace row, then a ticket
  float* mine = ws + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        *reinterpret_cast<float4*>(mine + c * N + e) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
      }
    }
  }
  __threadfence();
  __syncthreads();
  const int ctas = gridDim.x;
  int out = 0;
  if (threadIdx.x == 0) {
    reducer = atomicAdd(tickets, 1) - (ctas - reducers);
    if (reducer >= 0) {
      wait_for_tickets(tickets, ctas);
      __threadfence();  // every CTA's row is seen after its ticket
      out = atomicAdd(tickets + 1, 1);  // past the wait; its answer is read at the end
    }
  }
  __syncthreads();
  if (reducer < 0) return;

  // reducer k: columns [c0, c1) in quads of 4.  Thread (quad q, slice s), q
  // the faster, adds workspace rows s, s + slices, ... of its quad in order;
  // the slices then meet in a fixed tree (slice s takes slice s + h, h = 16,
  // 8, ..., 1), the same on every run.
  const int width = (d / 4 + reducers - 1) / reducers * 4;
  const int c0 = reducer * width, c1 = min(d, c0 + width);
  const int quads = (c1 - c0) / 4;
  for (int qb = 0; qb < quads; qb += blockDim.x) {
    const int nq = min(quads - qb, static_cast<int>(blockDim.x));
    int slices = 1;
    while (2 * slices * nq <= static_cast<int>(blockDim.x) && 2 * slices <= 32) slices *= 2;
    const int q = threadIdx.x % nq, s = threadIdx.x / nq;
    const float* col = ws + c0 + 4 * (qb + q);
    if (s < slices) {
      float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int base = s; base < ctas; base += kReduceBatch * slices) {
        float4 p[kReduceBatch];  // a batch of loads in flight, then added in order
#pragma unroll
        for (int u = 0; u < kReduceBatch; ++u) {
          const int cta = base + u * slices;
          p[u] = cta < ctas ? __ldcg(reinterpret_cast<const float4*>(
                                  col + static_cast<int64_t>(cta) * d))
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < kReduceBatch; ++u) {
          t.x += p[u].x;
          t.y += p[u].y;
          t.z += p[u].z;
          t.w += p[u].w;
        }
      }
      fin[s * nq + q] = t;
    }
    __syncthreads();
    for (int h = slices / 2; h > 0; h /= 2) {
      if (s < h) {
        const float4 o = fin[(s + h) * nq + q];
        float4& t = fin[s * nq + q];
        t.x += o.x;
        t.y += o.y;
        t.z += o.z;
        t.w += o.w;
      }
      __syncthreads();
    }
    if (threadIdx.x < nq) {
      const float4 t = fin[threadIdx.x];
      const int c = c0 + 4 * (qb + threadIdx.x);
      dgamma[c] = from_f32<T>(t.x);
      dgamma[c + 1] = from_f32<T>(t.y);
      dgamma[c + 2] = from_f32<T>(t.z);
      dgamma[c + 3] = from_f32<T>(t.w);
    }
    __syncthreads();  // fin is read before the next pass writes it
  }
  if (threadIdx.x == 0 && out == reducers - 1) {  // every reducer is past its wait
    tickets[0] = 0;  // ready for the next launch
    tickets[1] = 0;
  }
}

template <typename T, int NV, int R>
cudaError_t launch_bwd_nr(const T* x, const T* gamma, const T* g, T* dx, T* dgamma, float* ws,
                          int* tickets, int rows, int d, float eps, int rows_per_cta, int ctas,
                          int reducers, cudaStream_t s) {
  const int threads = ((d / kVec<T> + NV - 1) / NV + 31) / 32 * 32;
  rmsnorm_bwd_kernel<T, NV, R><<<ctas, threads, 0, s>>>(x, gamma, g, dx, dgamma, ws, tickets,
                                                         rows, d, eps, rows_per_cta, reducers);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* g, void* dx, void* dgamma,
                       float* ws, int* tickets, int rows, int d, float eps, int nv, int block,
                       int rows_per_cta, int ctas, int reducers, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* dp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  T* dgp = static_cast<T*>(dgamma);
#define REPRO_BWD(n, r)                                                                       \
  if (nv == n && block == r)                                                                  \
    return launch_bwd_nr<T, n, r>(xp, gp, dp, dxp, dgp, ws, tickets, rows, d, eps,            \
                                  rows_per_cta, ctas, reducers, s);
  REPRO_BWD(1, 1) REPRO_BWD(1, 2) REPRO_BWD(1, 4)
  REPRO_BWD(2, 1) REPRO_BWD(2, 2)
  REPRO_BWD(4, 1)
  REPRO_BWD(8, 1)
#undef REPRO_BWD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: kFloat32 (0) or kBFloat16 (1).  d must be a multiple of the 16-byte
// vector (4 float32, 8 bf16) and every pointer 16-byte aligned.  nv: vectors
// of x a thread holds (1, 2, 4 or 8).  A row wider than kMaxThreads threads
// take with nv is refused.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* y, int rows,
                              int d, float eps, int dtype, int nv, void* stream) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (rows <= 0 || d <= 0 || d % vec != 0 || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      dtype == kFloat32
          ? launch<float>(x, gamma, y, rows, d, eps, nv, s)
          : launch<__nv_bfloat16>(x, gamma, y, rows, d, eps, nv, s);
  return static_cast<int>(err);
}

// The backward, one launch: x, gamma and g (the output's gradient) in, dx
// and dgamma out, all of dtype, under the plan of kernels/rmsnorm.py::
// rmsnorm_bwd_plan: `ctas` CTAs each take rows_per_cta consecutive rows in
// blocks of `block` rows (1, 2 or 4; block * nv <= 4, or one row), nv
// vectors of a row a thread; the last `reducers` CTAs to finish (1 to min(ctas, 64, d / 4))
// sum dgamma.  ws: float32 [ctas, d]; tickets: int32 [2],
// zero before the launch and zero again after it.  The same conditions on d,
// nv and the pointers as rmsnorm_launch; a plan that does not cover the rows
// is refused.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* gamma, const void* g, void* dx,
                                  void* dgamma, void* ws, void* tickets, int rows, int d,
                                  float eps, int dtype, int nv, int block, int rows_per_cta,
                                  int ctas, int reducers, void* stream) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  const int threads = nv > 0 ? ((d / vec + nv - 1) / nv + 31) / 32 * 32 : 0;
  if (rows <= 0 || d <= 0 || d % vec != 0 || (dtype != kFloat32 && dtype != kBFloat16) ||
      nv <= 0 || rows_per_cta <= 0 || ctas <= 0 ||
      static_cast<int64_t>(ctas) * rows_per_cta < rows ||
      threads > kBwdMaxThreads || reducers <= 0 || reducers > ctas || reducers > 64 ||
      reducers > d / 4) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* wsp = static_cast<float*>(ws);
  int* tk = static_cast<int*>(tickets);
  const cudaError_t err =
      dtype == kFloat32
          ? launch_bwd<float>(x, gamma, g, dx, dgamma, wsp, tk, rows, d, eps, nv, block,
                              rows_per_cta, ctas, reducers, s)
          : launch_bwd<__nv_bfloat16>(x, gamma, g, dx, dgamma, wsp, tk, rows, d, eps, nv, block,
                                      rows_per_cta, ctas, reducers, s);
  return static_cast<int>(err);
}
