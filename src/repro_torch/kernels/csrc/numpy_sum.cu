// numpy sum: float64 segment sums in numpy's own order (np.add.reduce of a
// contiguous float64 vector).
//
// Replaces no TPU kernel.  The tiered lockstep solver (core/lockstep_tiered.py)
// must reproduce the reference's float(q.sum()) bit for bit, and numpy's sum
// is neither left to right nor torch's tree.  numpy 2 adds the vector's blocks
// of 8192 elements left to right into 0.0; each block is summed pairwise
// (pairwise_sum in numpy's loops_utils.h.src):
//   n < 8:      res = 0.0; res += a[i], left to right
//   n <= 128:   eight strided accumulators r[j] = a[j] + a[j + 8] + ...,
//               res = ((r0 + r1) + (r2 + r3)) + ((r4 + r5) + (r6 + r7)),
//               then the n % 8 remaining elements added left to right
//   otherwise:  n2 = n / 2 rounded down to a multiple of 8;
//               pairwise(a, n2) + pairwise(a + n2, n - n2)
// Every add is one __dadd_rn (nothing reassociated).
//
// One thread a segment: segment s is x[offs[s], offs[s + 1]).  A block of at
// most 8192 splits at most 7 times before its halves are 128 or shorter, so
// the recursion is unrolled to a fixed depth of 8 levels.
//
// Bound by one thread's reads: eight independent accumulators a leaf keep the
// loads in flight; a segment's length decides its time.
//
// C interface (bound with ctypes): numpy_sum_launch returns
// cudaGetLastError() after the launch.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int64_t kBlock = 8192;   // numpy's ufunc buffer, in elements
constexpr int64_t kLeaf = 128;     // PW_BLOCKSIZE

__device__ __forceinline__ double leaf_sum(const double* __restrict__ a, int64_t n) {
  if (n < 8) {
    double res = 0.0;
    for (int64_t i = 0; i < n; ++i) res = __dadd_rn(res, a[i]);
    return res;
  }
  double r[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) r[j] = a[j];
  const int64_t stop = n - (n % 8);
  int64_t i = 8;
  for (; i < stop; i += 8) {
#pragma unroll
    for (int j = 0; j < 8; ++j) r[j] = __dadd_rn(r[j], a[i + j]);
  }
  double res = __dadd_rn(__dadd_rn(__dadd_rn(r[0], r[1]), __dadd_rn(r[2], r[3])),
                         __dadd_rn(__dadd_rn(r[4], r[5]), __dadd_rn(r[6], r[7])));
  for (; i < n; ++i) res = __dadd_rn(res, a[i]);
  return res;
}

template <int kDepth>
__device__ __noinline__ double pairwise_sum(const double* __restrict__ a, int64_t n) {
  if (n <= kLeaf) return leaf_sum(a, n);
  int64_t n2 = n / 2;
  n2 -= n2 % 8;
  return __dadd_rn(pairwise_sum<kDepth - 1>(a, n2), pairwise_sum<kDepth - 1>(a + n2, n - n2));
}

// never entered with n > kLeaf for a block of at most kBlock elements
template <>
__device__ __noinline__ double pairwise_sum<0>(const double* __restrict__ a, int64_t n) {
  return leaf_sum(a, n);
}

template <int kBlockThreads>
__global__ void __launch_bounds__(kBlockThreads)
numpy_sum_kernel(const double* __restrict__ x, const int64_t* __restrict__ offs,
                 double* __restrict__ out, int64_t S) {
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kBlockThreads + threadIdx.x;
  if (s >= S) return;
  const int64_t lo = offs[s], n = offs[s + 1] - lo;
  double acc = 0.0;
  for (int64_t b = 0; b < n; b += kBlock) {
    const int64_t m = n - b < kBlock ? n - b : kBlock;
    acc = __dadd_rn(acc, pairwise_sum<8>(x + lo + b, m));
  }
  out[s] = acc;
}

}  // namespace

extern "C" int numpy_sum_launch(const void* x, const void* offs, void* out, int64_t S,
                                void* stream) {
  const int64_t blocks = (S + kThreads - 1) / kThreads;
  numpy_sum_kernel<kThreads><<<static_cast<unsigned>(blocks), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<const int64_t*>(offs),
      static_cast<double*>(out), S);
  return static_cast<int>(cudaGetLastError());
}
