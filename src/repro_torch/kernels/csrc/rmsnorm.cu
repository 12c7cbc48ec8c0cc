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
// The backward (rmsnorm_bwd_kernel, then rmsnorm_bwd_dgamma_kernel) replaces
// no Pallas kernel: the reference differentiates its rms_norm
// (src/repro/models/common.py:244) through XLA.  Per row, in float32, with
// r = rsqrt(mean(x^2) + eps) and w = 1 + gamma, for the output's gradient g:
//     dx = r * (g * w) - x * r^3 * mean(g * w * x)      (stored in x's dtype)
//     dgamma = sum over rows of g * (x * r)             (float32, then gamma's dtype)
// Bound: it reads x and g and writes dx once (gamma and dgamma are one row):
// at [2048, 1152] bf16, 14.2 MB, 4.2 us at 3.35 TB/s; about 10 flops an
// element are far below the float32 peak.  Design: a CTA owns a run of
// consecutive rows and the thread layout of the forward (NV 16-byte vectors
// of a row a thread).  gamma is loaded once a CTA.  r is recomputed from the
// row of x the kernel loads anyway; the row's two sums (sum x^2 and
// sum g w x) meet at one barrier, on shared partials double-buffered by row
// parity.  dgamma is a sum across rows, made the same bits every run: each
// thread keeps its columns' float32 sums over its CTA's rows in registers and
// writes them to a float32 workspace row of the CTA; a second launch sums the
// workspace's rows in a fixed order (8 threads a column, each over every 8th
// row, then their 8 sums in order).  No atomics.  The next row's loads are
// issued before a row's sums, so a CTA's latency chain overlaps its loads.
//
// C interface (bound with ctypes): rmsnorm_launch and rmsnorm_bwd_launch
// return cudaGetLastError() after their launches, or cudaErrorInvalidValue for
// arguments they do not take.

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


// A thread's NV vectors of one row of x and of g, zeros past the row.
template <typename T, int NV>
__device__ __forceinline__ void load_row(const T* xr, const T* gr, int first, int stride,
                                         int nvec, uint4 (&xv)[NV], uint4 (&dv)[NV]) {
  constexpr int N = kVec<T>;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * stride;
    if (c < nvec) {
      xv[i] = *reinterpret_cast<const uint4*>(xr + c * N);
      dv[i] = *reinterpret_cast<const uint4*>(gr + c * N);
    } else {
      xv[i] = make_uint4(0u, 0u, 0u, 0u);
      dv[i] = xv[i];
    }
  }
}

// The backward of a run of rows_per_cta rows: dx of each row, and the CTA's
// float32 sums of g * (x * r) over its rows into partial[blockIdx.x, :].
// The next row's loads are issued before this row's sums, so they are in
// flight across its barrier.
template <typename T, int NV>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_bwd_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
                   const T* __restrict__ g, T* __restrict__ dx, float* __restrict__ partial,
                   int rows, int d, float eps, int rows_per_cta) {
  constexpr int N = kVec<T>;
  const int nvec = d / N;
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int first = threadIdx.x;
  const int stride = blockDim.x;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_cta;
  const int64_t row1 = row0 + rows_per_cta < rows ? row0 + rows_per_cta : rows;

  uint4 gv[NV];  // gamma, the same for every row
  float acc[NV][N];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * stride;
    gv[i] = c < nvec ? __ldg(reinterpret_cast<const uint4*>(gamma + c * N))
                     : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int e = 0; e < N; ++e) acc[i][e] = 0.f;
  }

  __shared__ float2 sums[2][kMaxThreads / 32];  // by row parity: one barrier a row
  uint4 xv[NV], dv[NV];
  load_row<T, NV>(x + row0 * d, g + row0 * d, first, stride, nvec, xv, dv);
  for (int64_t row = row0; row < row1; ++row) {
    uint4 xn[NV], dn[NV];
    if (row + 1 < row1) {
      load_row<T, NV>(x + (row + 1) * d, g + (row + 1) * d, first, stride, nvec, xn, dn);
    }
    float ss = 0.f, sgwx = 0.f;  // columns past the row add exact zeros
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float v[N], gg[N], w[N];
      unpack<T>(xv[i], v);
      unpack<T>(dv[i], gg);
      unpack<T>(gv[i], w);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        ss += v[e] * v[e];
        sgwx += (gg[e] * (1.f + w[e])) * v[e];
      }
    }
    ss = warp_sum(ss);
    sgwx = warp_sum(sgwx);
    float2* buf = sums[(row - row0) & 1];
    if (lane == 0) buf[warp] = make_float2(ss, sgwx);
    __syncthreads();
    float tss = 0.f, tsgwx = 0.f;
    for (int k = 0; k < warps; ++k) {  // the same order everywhere
      tss += buf[k].x;
      tsgwx += buf[k].y;
    }
    const float r = rsqrtf(tss / static_cast<float>(d) + eps);
    const float c3 = r * r * r * (tsgwx / static_cast<float>(d));
    T* dxr = dx + row * d;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int c = first + i * stride;
      if (c < nvec) {
        float v[N], gg[N], w[N], out[N];
        unpack<T>(xv[i], v);
        unpack<T>(dv[i], gg);
        unpack<T>(gv[i], w);
#pragma unroll
        for (int e = 0; e < N; ++e) {
          out[e] = r * (gg[e] * (1.f + w[e])) - v[e] * c3;
          acc[i][e] += gg[e] * (v[e] * r);
        }
        store_vec(dxr + c * N, out);
      }
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      xv[i] = xn[i];
      dv[i] = dn[i];
    }
  }

  float* pr = partial + static_cast<int64_t>(blockIdx.x) * d;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = first + i * stride;
    if (c < nvec) {
#pragma unroll
      for (int e = 0; e < N; e += 4) {
        *reinterpret_cast<float4*>(pr + c * N + e) =
            make_float4(acc[i][e], acc[i][e + 1], acc[i][e + 2], acc[i][e + 3]);
      }
    }
  }
}

constexpr int kSumCols = 32;  // dgamma columns a CTA of the second launch
constexpr int kSumSlices = 8;  // its threads a column, each over every 8th partial

// dgamma[col] = the sum of partial[0..ctas, col] in a fixed order: thread
// (col, s) sums partials s, s + 8, ... in turn, then thread (col, 0) adds the
// 8 slices' sums in slice order.
template <typename T>
__global__ void __launch_bounds__(kSumCols * kSumSlices)
rmsnorm_bwd_dgamma_kernel(const float* __restrict__ partial, T* __restrict__ dgamma,
                          int ctas, int d) {
  const int col = blockIdx.x * kSumCols + threadIdx.x;
  const int slice = threadIdx.y;
  float s = 0.f;
  if (col < d) {
#pragma unroll 8
    for (int c = slice; c < ctas; c += kSumSlices) {
      s += partial[static_cast<int64_t>(c) * d + col];
    }
  }
  __shared__ float slices[kSumSlices][kSumCols];
  slices[slice][threadIdx.x] = s;
  __syncthreads();
  if (slice == 0 && col < d) {
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSumSlices; ++k) t += slices[k][threadIdx.x];
    dgamma[col] = from_f32<T>(t);
  }
}

template <typename T, int NV>
cudaError_t launch_bwd_nv(const T* x, const T* gamma, const T* g, T* dx, T* dgamma,
                          float* partial, int rows, int d, float eps, int rows_per_cta,
                          cudaStream_t s) {
  const int nvec = d / kVec<T>;
  const int threads = ((nvec + NV - 1) / NV + 31) / 32 * 32;
  if (threads > kMaxThreads) return cudaErrorInvalidValue;
  const int ctas = (rows + rows_per_cta - 1) / rows_per_cta;
  rmsnorm_bwd_kernel<T, NV><<<ctas, threads, 0, s>>>(x, gamma, g, dx, partial, rows, d, eps,
                                                     rows_per_cta);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dgamma_kernel<T><<<(d + kSumCols - 1) / kSumCols, dim3(kSumCols, kSumSlices), 0,
                                 s>>>(partial, dgamma, ctas, d);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* x, const void* gamma, const void* g, void* dx,
                       void* dgamma, float* partial, int rows, int d, float eps, int nv,
                       int rows_per_cta, cudaStream_t s) {
  const T* xp = static_cast<const T*>(x);
  const T* gp = static_cast<const T*>(gamma);
  const T* dp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  T* dgp = static_cast<T*>(dgamma);
  switch (nv) {
    case 1: return launch_bwd_nv<T, 1>(xp, gp, dp, dxp, dgp, partial, rows, d, eps, rows_per_cta, s);
    case 2: return launch_bwd_nv<T, 2>(xp, gp, dp, dxp, dgp, partial, rows, d, eps, rows_per_cta, s);
    case 4: return launch_bwd_nv<T, 4>(xp, gp, dp, dxp, dgp, partial, rows, d, eps, rows_per_cta, s);
    case 8: return launch_bwd_nv<T, 8>(xp, gp, dp, dxp, dgp, partial, rows, d, eps, rows_per_cta, s);
    default: return cudaErrorInvalidValue;
  }
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

// The backward: x, gamma and g (the output's gradient) in, dx and dgamma out,
// all of dtype; partial is a float32 workspace of ceil(rows / rows_per_cta)
// rows of d.  The same conditions on d, nv and the pointers as rmsnorm_launch.
extern "C" int rmsnorm_bwd_launch(const void* x, const void* gamma, const void* g, void* dx,
                                  void* dgamma, void* partial, int rows, int d, float eps,
                                  int dtype, int nv, int rows_per_cta, void* stream) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (rows <= 0 || d <= 0 || d % vec != 0 || rows_per_cta <= 0 ||
      (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* ws = static_cast<float*>(partial);
  const cudaError_t err =
      dtype == kFloat32
          ? launch_bwd<float>(x, gamma, g, dx, dgamma, ws, rows, d, eps, nv, rows_per_cta, s)
          : launch_bwd<__nv_bfloat16>(x, gamma, g, dx, dgamma, ws, rows, d, eps, nv,
                                      rows_per_cta, s);
  return static_cast<int>(err);
}
