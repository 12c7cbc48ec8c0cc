// Fused RMSNorm for Hopper (sm_90a).
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas
// (body _kernel).  Per row of x[R, D]:
//     y = x * rsqrt(mean(x^2) + eps) * (1 + gamma)
// computed in float32 and stored in x's dtype (float32 or bfloat16); gamma has
// x's dtype.  The scale is (1 + gamma), as in src/repro/models/common.py.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s float32): the function reads x
// and gamma once and writes y once.  On the gemma3-1b serve path x is
// [4, 1, 1152] bf16: 4*1152*2 + 1152*2 + 4*1152*2 = 20,736 bytes, about 6 ns;
// the ~5 flops an element are less still.  A call is bound by its launch (a
// few microseconds), not by bytes or operations.
//
// Design: one CTA of 128 threads per row, no padding (the TPU kernel pads R to
// a multiple of its row block; here the grid has exactly R blocks).  Each
// thread reads 16-byte vectors (8 bf16 or 4 float32), sums x^2 in float32, and
// the block reduces by warp shuffles and one shared-memory step.  The second
// pass re-reads its own vectors (L1 hits) and writes y with 16-byte stores.
// About the launch bound the kernel can do nothing alone: fusing the norm into
// its neighbours or replaying the decode step as a CUDA graph is later work.
//
// C interface (bound with ctypes): rmsnorm_launch returns cudaGetLastError()
// after the launch, or cudaErrorInvalidValue for arguments it does not take.

#include "common.cuh"

using namespace repro_torch;

namespace {

constexpr int kThreads = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_kernel(const T* __restrict__ x, const T* __restrict__ gamma,
               T* __restrict__ y, int d, float eps) {
  constexpr int N = kVec<T>;
  const int nvec = d / N;
  const T* xr = x + static_cast<int64_t>(blockIdx.x) * d;
  T* yr = y + static_cast<int64_t>(blockIdx.x) * d;

  float ss = 0.f;
  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    float v[N];
    load_vec(xr + c * N, v);
#pragma unroll
    for (int i = 0; i < N; ++i) ss += v[i] * v[i];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);

  __shared__ float partial[kThreads / 32];
  __shared__ float inv_rms;
  if (threadIdx.x % 32 == 0) partial[threadIdx.x / 32] = ss;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = 0.f;
#pragma unroll
    for (int w = 0; w < kThreads / 32; ++w) total += partial[w];
    inv_rms = rsqrtf(total / static_cast<float>(d) + eps);
  }
  __syncthreads();

  const float r = inv_rms;
  for (int c = threadIdx.x; c < nvec; c += kThreads) {
    float v[N], g[N];
    load_vec(xr + c * N, v);
    load_vec(gamma + c * N, g);
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = (v[i] * r) * (1.f + g[i]);
    store_vec(yr + c * N, v);
  }
}

}  // namespace

// dtype: kFloat32 (0) or kBFloat16 (1).  d must be a multiple of the 16-byte
// vector (4 float32, 8 bf16) and every pointer 16-byte aligned.
extern "C" int rmsnorm_launch(const void* x, const void* gamma, void* y, int rows,
                              int d, float eps, int dtype, void* stream) {
  const int vec = dtype == kFloat32 ? kVec<float> : kVec<__nv_bfloat16>;
  if (rows <= 0 || d <= 0 || d % vec != 0 || (dtype != kFloat32 && dtype != kBFloat16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == kFloat32) {
    rmsnorm_kernel<float><<<rows, kThreads, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(gamma),
        static_cast<float*>(y), d, eps);
  } else {
    rmsnorm_kernel<__nv_bfloat16><<<rows, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(gamma),
        static_cast<__nv_bfloat16*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}
