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
// C interface (bound with ctypes): rmsnorm_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

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
