// Ordered scan: an inclusive prefix sum of float64 along the leading dimension
// of a row-major [L, R] matrix, each column added strictly in order.
//
// Replaces no TPU kernel: the flat lockstep solver (core/lockstep.py) must add
// its per-port busy chains and queued-time sums in numpy's order (np.cumsum is
// a sequential add.accumulate), and torch.cumsum / torch.sum on the card add in
// a parallel order, one ulp apart.  One thread a column; thread c walks
// x[0, c], x[1, c], ... so the threads of a warp read consecutive doubles of
// one row (coalesced).  Each step is one IEEE round-to-nearest add
// (__dadd_rn: nothing may be contracted or reassociated).
//
// Bound by bytes: one add for every 16 bytes read and written.  Each thread's
// adds form one dependent chain, so a short, wide matrix (the solver's
// [~n/2, n] busy chains at n ranks) keeps enough threads in flight, and a
// tall, narrow one (a stage's total over [n, 1]) runs at one thread's pace.
//
// C interface (bound with ctypes): ordered_scan_launch returns
// cudaGetLastError() after the launch; L and R must be positive.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;

template <int kBlock>
__global__ void __launch_bounds__(kBlock)
ordered_scan_kernel(const double* __restrict__ x, double* __restrict__ out, int64_t L, int64_t R) {
  const int64_t c = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (c >= R) return;
  double acc = x[c];
  out[c] = acc;
  for (int64_t j = 1; j < L; ++j) {
    acc = __dadd_rn(acc, x[j * R + c]);
    out[j * R + c] = acc;
  }
}

}  // namespace

extern "C" int ordered_scan_launch(const void* x, void* out, int64_t L, int64_t R, void* stream) {
  const int64_t blocks = (R + kThreads - 1) / kThreads;
  ordered_scan_kernel<kThreads><<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const double*>(x), static_cast<double*>(out), L, R);
  return static_cast<int>(cudaGetLastError());
}
